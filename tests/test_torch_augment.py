"""The port's augmentation (``data/augment.py``, ``cli/augment_data.py``)
against the JAX package's on seeded numpy inputs.

- ``_power``, ``reverberate``, ``add_noise`` and ``add_babble``: the numpy
  copies bit-equal to the originals (same inputs, same RandomState).
- ``reverberate_torch``: a ragged float64 batch (signals and RIRs of
  different lengths, garbage in the padding, a tied int16 peak whose first
  occurrence is not the last, an all-zero row) against ``reverberate`` row
  by row: max |difference| <= 1e-12 x max |y|, padding zero, and the int16
  truncations that ``write_wav`` makes equal.
- ``cli.augment_data --device cpu`` against the JAX CLI in all four modes
  with ``--keep-frac`` and the recipe's SNRs and babble counts: ``wav.scp``
  (paths mapped), ``utt2spk`` and every wav byte-equal.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu.cli import augment_data as jax_cli
from tf_kaldi_speaker_tpu.data import augment as jaug
from tf_kaldi_speaker_tpu_torch.cli import augment_data as cli
from tf_kaldi_speaker_tpu_torch.data import augment as aug
from tf_kaldi_speaker_tpu_torch.kio.wav import write_wav

torch.set_num_threads(1)

REVERB_RTOL = 1e-12  # of the row's peak |y|


def test_numpy_copies_bit_equal():
    rng = np.random.RandomState(0)
    x = rng.randn(3000) * 2000
    rir = np.concatenate([[0.1, 1.0], rng.randn(500) * 0.05])
    assert aug._power(x) == jaug._power(x)
    assert np.array_equal(aug.reverberate(x, rir), jaug.reverberate(x, rir))
    assert np.array_equal(aug.reverberate(x, rir, shift_output=False),
                          jaug.reverberate(x, rir, shift_output=False))
    for short in (False, True):
        noise = rng.randn(1000 if short else 5000) * 300
        a, b = np.random.RandomState(5), np.random.RandomState(5)
        assert np.array_equal(aug.add_noise(x, noise, 7.5, a), jaug.add_noise(x, noise, 7.5, b))
        srcs = [rng.randn(n) * 400 for n in (800, 4000, 3000)]
        assert np.array_equal(aug.add_babble(x, srcs, 13.0, a), jaug.add_babble(x, srcs, 13.0, b))
        assert a.randint(1 << 30) == b.randint(1 << 30)


@pytest.mark.parametrize("n", [1, 2, 7, 97, 1000, 16001, 143999])
def test_fast_fft_length(n):
    m = aug.fast_fft_length(n)
    assert m >= n
    r = m
    for p in (2, 3, 5):
        while r % p == 0:
            r //= p
    assert r == 1
    assert all(not _smooth(k) for k in range(n, m)), "a smaller 5-smooth length exists"


def _smooth(k):
    for p in (2, 3, 5):
        while k % p == 0:
            k //= p
    return k == 1


def _ragged_batch():
    rng = np.random.RandomState(3)
    sig_lens = [4000, 1234, 2500, 3001, 800]
    rir_lens = [300, 801, 57, 1, 420]
    sigs = [np.round(rng.randn(n) * 3000) for n in sig_lens]
    rirs = [np.round(rng.randn(n) * 500) for n in rir_lens]
    # tied int16 peak: the first occurrence (index 5) is the peak numpy takes
    rirs[0][:] = np.clip(rirs[0], -900, 900)
    rirs[0][5], rirs[0][40], rirs[0][200] = 1000.0, -1000.0, 1000.0
    rirs[3][:] = 0.0  # an all-zero RIR of one sample
    sigs[4][:200] = 0.0  # digital silence
    return sigs, rirs


def test_reverberate_torch_matches_numpy_rows():
    sigs, rirs = _ragged_batch()
    ts, tr = max(map(len, sigs)), max(map(len, rirs))
    S = np.full((len(sigs), ts), 7777.0)  # garbage padding must not count
    R = np.full((len(rirs), tr), 31000.0)
    for i, (s, r) in enumerate(zip(sigs, rirs)):
        S[i, :len(s)], R[i, :len(r)] = s, r
    out = aug.reverberate_torch(
        torch.from_numpy(S), torch.tensor([len(s) for s in sigs]), torch.from_numpy(R),
        torch.tensor([len(r) for r in rirs])).numpy()
    assert out.shape == (len(sigs), ts) and out.dtype == np.float64
    for i, (s, r) in enumerate(zip(sigs, rirs)):
        want = jaug.reverberate(s, r)
        got = out[i, :len(s)]
        peak = max(np.max(np.abs(want)), 1e-300)
        assert np.max(np.abs(got - want)) <= REVERB_RTOL * peak, i
        assert not np.any(out[i, len(s):])
        assert np.array_equal(got.astype("<i2"), want.astype("<i2")), i


def test_reverberate_torch_tied_peak_shift():
    """With the RIR's largest |value| at indices 3 and 9, the output is
    shifted by 3, as ``np.argmax`` takes the first."""
    sig = np.zeros(50)
    sig[10] = 100.0
    rir = np.zeros(12)
    rir[3], rir[9] = -4.0, 4.0
    out = aug.reverberate_torch(torch.from_numpy(sig[None]), torch.tensor([50]),
                                torch.from_numpy(rir[None]), torch.tensor([12])).numpy()[0]
    want = jaug.reverberate(sig, rir)
    assert np.argmax(np.abs(want)) == 10
    np.testing.assert_allclose(out, want, rtol=0, atol=REVERB_RTOL * np.abs(want).max())


def test_reverberate_torch_takes_float64_only():
    x = torch.zeros(1, 8, dtype=torch.float32)
    with pytest.raises(TypeError, match="float64"):
        aug.reverberate_torch(x, torch.tensor([8]), x, torch.tensor([8]))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 utterances of 0.2-0.6 s, 3 RIRs of 40-300 samples (one tied),
    4 noise sources (one shorter than every utterance)."""
    root = tmp_path_factory.mktemp("augment_corpus")
    rng = np.random.RandomState(11)
    scp, u2s = [], []
    for i in range(8):
        path = str(root / ("u%d.wav" % i))
        n = int(rng.randint(3200, 9600))
        t = np.arange(n) / 16000.0
        write_wav(path, 6000 * np.sin(2 * np.pi * (150 + 40 * i) * t) + rng.randn(n) * 200, 16000)
        scp.append("spk%d-u%d %s" % (i // 2, i, path))
        u2s.append("spk%d-u%d spk%d" % (i // 2, i, i // 2))
    (root / "wav.scp").write_text("\n".join(scp) + "\n")
    (root / "utt2spk").write_text("\n".join(u2s) + "\n")
    rirs = []
    for j, n in enumerate((40, 300, 120)):
        r = rng.randn(n) * 0.05 * np.exp(-np.arange(n) / (n / 4.0))
        r[2] = 1.0
        if j == 1:
            r[60] = -1.0  # a tie after quantization
        path = str(root / ("rir%d.wav" % j))
        write_wav(path, r * 16000, 16000)
        rirs.append("rir%d %s" % (j, path))
    (root / "rirs.scp").write_text("\n".join(rirs) + "\n")
    noise = []
    for j, n in enumerate((1000, 20000, 12000, 9000)):
        path = str(root / ("n%d.wav" % j))
        write_wav(path, rng.randn(n) * 800, 16000)
        noise.append("n%d %s" % (j, path))
    (root / "noise.scp").write_text("\n".join(noise) + "\n")
    return root


MODES = {
    "reverb": ["--mode", "reverb", "--seed", "1", "--aug-wav-scp", "rirs.scp"],
    "noise": ["--mode", "noise", "--seed", "2", "--snr", "15:10:5:0", "--aug-wav-scp",
              "noise.scp"],
    "music": ["--mode", "music", "--seed", "3", "--snr", "15:10:8:5", "--aug-wav-scp",
              "noise.scp"],
    "babble": ["--mode", "babble", "--seed", "4", "--snr", "20:17:15:13",
               "--num-babble-choices", "3:4:5:6:7", "--aug-wav-scp", "noise.scp"],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_matches_jax(corpus, tmp_path, mode):
    args = [a if not a.endswith(".scp") else str(corpus / a) for a in MODES[mode]]
    args += ["--keep-frac", "0.5"]
    ins = [str(corpus / "wav.scp"), str(corpus / "utt2spk")]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_cli.main(args + ins + [jdir]) == 0
    extra = ["--device", "cpu"] + (["--batch-size", "3"] if mode == "reverb" else [])
    assert cli.main(args + extra + ins + [tdir]) == 0
    with open(os.path.join(jdir, "wav.scp")) as f:
        jscp = f.read()
    with open(os.path.join(tdir, "wav.scp")) as f:
        assert f.read() == jscp.replace(jdir, tdir)
    assert filecmp.cmp(os.path.join(jdir, "utt2spk"), os.path.join(tdir, "utt2spk"),
                       shallow=False)
    names = sorted(os.listdir(os.path.join(jdir, "wav")))
    assert names == sorted(os.listdir(os.path.join(tdir, "wav")))
    assert 2 <= len(names) < 8  # keep-frac dropped some, kept some
    for name in names:
        assert filecmp.cmp(os.path.join(jdir, "wav", name), os.path.join(tdir, "wav", name),
                           shallow=False), name


def test_cli_cuda_default_raises_without_card(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--mode", "noise", "--aug-wav-scp", str(corpus / "noise.scp"),
                  str(corpus / "wav.scp"), str(corpus / "utt2spk"), str(tmp_path / "o")])
