"""The port's front-end CLIs (``make_mfcc``, ``compute_vad``,
``prepare_feats``, all with ``--device cpu``) against the JAX package's on
a small wav.scp built as ``test_frontend.py::test_prep_pipeline_cli``
builds it, plus a wav too short for a frame and one at another rate (both
skipped without advancing the dither seed).

``feats.scp``, ``utt2num_frames``, ``vad.scp`` and ``vad.ark`` are compared
byte for byte (paths mapped). The feature arks are expected byte-equal
too: the port computes in float64 as numpy does and casts to float32 once.
Where a float32 value flips in the last place, a compressed code can flip
at a quantization boundary; the comparison then says so and holds the
decoded matrices within one quantization step of the column
(``_cm_step``)."""

import os
import warnings

import numpy as np
import pytest

from tf_kaldi_speaker_tpu.cli import compute_vad as jax_vad
from tf_kaldi_speaker_tpu.cli import make_mfcc as jax_mfcc
from tf_kaldi_speaker_tpu.cli import prepare_feats as jax_prep
from tf_kaldi_speaker_tpu.kio.wav import write_wav
from tf_kaldi_speaker_tpu_torch.cli import compute_vad, make_mfcc, prepare_feats
from tf_kaldi_speaker_tpu_torch.kio import read_codes_scp, read_mat_scp


def tone(freq, dur=1.0, rate=16000, amp=8000.0):
    t = np.arange(int(dur * rate)) / rate
    return amp * np.sin(2 * np.pi * freq * t)


@pytest.fixture(scope="module")
def wav_scp(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_fe_cli")
    scp = str(root / "wav.scp")
    rng = np.random.RandomState(0)
    with open(scp, "w") as f:
        for i in range(3):
            path = str(root / ("u%d.wav" % i))
            sig = np.concatenate([tone(300 + 100 * i, 0.4), np.zeros(3200)])
            write_wav(path, sig + rng.randn(len(sig)) * 3.0, 16000)
            f.write("u%d %s\n" % (i, path))
        write_wav(str(root / "short.wav"), rng.randn(399) * 100, 16000)
        write_wav(str(root / "r8k.wav"), rng.randn(4000) * 100, 8000)
        f.write("short %s\nr8k %s\n" % (root / "short.wav", root / "r8k.wav"))
        path = str(root / "u3.wav")
        write_wav(path, np.concatenate([np.zeros(2000), tone(800, 0.3)]), 16000)
        f.write("u3 cat %s |\n" % path)
    return scp


def _cm_step(headers):
    """Per column, the widest decoding step of a compressed matrix: codes
    0-64 span p0..p25, 64-192 p25..p75, 192-255 p75..p100."""
    p0, p25, p75, p100 = headers
    return np.maximum.reduce([(p25 - p0) / 64, (p75 - p25) / 128, (p100 - p75) / 63])


def _same_text(a, b, a_dir, b_dir):
    with open(a) as fa, open(b) as fb:
        assert fa.read().replace(a_dir, "@") == fb.read().replace(b_dir, "@"), (a, b)


def _same_arks(a_dir, b_dir, compressed):
    a, b = (os.path.join(d, "feats.ark") for d in (a_dir, b_dir))
    if open(a, "rb").read() == open(b, "rb").read():
        return
    warnings.warn("feature arks differ in bytes; bounding the decoded difference")
    want = dict(read_mat_scp(os.path.join(a_dir, "feats.scp")))
    got = dict(read_mat_scp(os.path.join(b_dir, "feats.scp")))
    assert list(got) == list(want)
    heads = {k: h for k, _, h in read_codes_scp(os.path.join(a_dir, "feats.scp"))} \
        if compressed else {}
    for k in want:
        assert got[k].shape == want[k].shape, k
        step = _cm_step(heads[k]) if compressed else 2.0 ** -23 * np.abs(want[k])
        assert (np.abs(got[k] - want[k]) <= step * (1 + 1e-6)).all(), k


@pytest.mark.parametrize("dither", ["1", "0"])
def test_prep_chain_matches_jax(wav_scp, tmp_path, dither):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    cpu = ["--device", "cpu"]
    assert jax_mfcc.main(["--compress", "--dither", dither, wav_scp, jdir]) == 0
    assert make_mfcc.main(["--compress", "--dither", dither, "--batch-size", "2"] + cpu
                          + [wav_scp, pdir]) == 0
    for name in ("feats.scp", "utt2num_frames"):
        _same_text(os.path.join(jdir, name), os.path.join(pdir, name), jdir, pdir)
    with open(os.path.join(pdir, "utt2num_frames")) as f:
        assert [line.split()[0] for line in f] == ["u0", "u1", "u2", "u3"]
    _same_arks(jdir, pdir, True)

    assert jax_vad.main([os.path.join(jdir, "feats.scp"), jdir]) == 0
    assert compute_vad.main(cpu + [os.path.join(pdir, "feats.scp"), pdir]) == 0
    _same_text(os.path.join(jdir, "vad.scp"), os.path.join(pdir, "vad.scp"), jdir, pdir)
    assert open(os.path.join(jdir, "vad.ark"), "rb").read() == \
        open(os.path.join(pdir, "vad.ark"), "rb").read()

    for flags in ([], ["--keep-silence"], ["--no-cmvn", "--no-compress"],
                  ["--cmn-window", "40"]):
        je, pe = jdir + "_egs", pdir + "_egs"
        assert jax_prep.main(flags + [jdir, je]) == 0
        assert prepare_feats.main(flags + cpu + [pdir, pe]) == 0
        for name in ("feats.scp", "utt2num_frames"):
            _same_text(os.path.join(je, name), os.path.join(pe, name), je, pe)
        _same_arks(je, pe, "--no-compress" not in flags)


def test_vad_context_flags_match_jax(wav_scp, tmp_path):
    d = str(tmp_path / "mfcc")
    assert make_mfcc.main(["--device", "cpu", wav_scp, d]) == 0
    flags = ["--vad-energy-threshold", "5.3", "--vad-energy-mean-scale", "0.3",
             "--vad-frames-context", "2", "--vad-proportion-threshold", "0.6"]
    assert jax_vad.main(flags + [os.path.join(d, "feats.scp"), d + "/j"]) == 0
    assert compute_vad.main(flags + ["--device", "cpu", os.path.join(d, "feats.scp"),
                                     d + "/p"]) == 0
    assert open(d + "/j/vad.ark", "rb").read() == open(d + "/p/vad.ark", "rb").read()


def test_prepare_feats_skips_utterances_without_vad(wav_scp, tmp_path):
    d = str(tmp_path / "mfcc")
    assert make_mfcc.main(["--device", "cpu", "--dither", "0", wav_scp, d]) == 0
    assert compute_vad.main(["--device", "cpu", os.path.join(d, "feats.scp"), d]) == 0
    with open(os.path.join(d, "vad.scp")) as f:
        lines = f.readlines()
    with open(os.path.join(d, "vad.scp"), "w") as f:
        f.writelines(lines[1:])
    with open(os.path.join(d, "utt2spk"), "w") as f:
        f.write("u0 a\nu1 a\nu2 b\nu3 b\n")
    assert jax_prep.main([d, d + "/j"]) == 0
    assert prepare_feats.main(["--device", "cpu", d, d + "/p"]) == 0
    _same_text(d + "/j/feats.scp", d + "/p/feats.scp", d + "/j", d + "/p")
    assert open(d + "/p/utt2spk").read() == "u0 a\nu1 a\nu2 b\nu3 b\n"
    _same_arks(d + "/j", d + "/p", True)


@pytest.mark.parametrize("cli", [make_mfcc, compute_vad, prepare_feats])
def test_default_device_is_cuda_and_raises_without_it(cli, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(tmp_path / "in"), str(tmp_path / "out")])
    assert not os.path.exists(str(tmp_path / "out"))


def test_batches_keep_input_order():
    """Batches of up to ``size`` items, in input order, the last one
    shorter; a generator is consumed once."""
    from tf_kaldi_speaker_tpu_torch.cli._frontend import batches, pad_rows

    lengths = list(np.random.RandomState(0).randint(1, 100, 37))
    out = list(batches((x for x in lengths), 2))
    assert [len(b) for b in out] == [2] * 18 + [1]
    assert [x for b in out for x in b] == lengths
    assert list(batches([], 4)) == []
    padded, n = pad_rows([np.ones((3, 2)), np.ones((1, 2))], np.float64)
    assert padded.shape == (2, 3, 2) and n.tolist() == [3, 1] and padded[1, 1:].sum() == 0
