"""The port's data-directory CLIs against the JAX package's on the inputs
that ``tests/test_tools_cli.py``, ``test_make_voxceleb.py`` and
``test_validate_data_dir.py`` build: ``fix_data_dir``, ``combine_data``,
``validate_data_dir``, ``make_voxceleb`` (VoxCeleb1 consolidated and split
layouts, VoxCeleb2 wav and aac layouts; the ``ffmpeg`` pipes are written,
not run), ``filter_egs_dir``, ``sample_validset_spk2utt`` and
``copy_feats``. Each case runs both packages on two copies of one input
tree; every file written is compared byte for byte (the tree's own path
mapped), return values and error messages are equal."""

import filecmp
import os

import numpy as np
import pytest

from tf_kaldi_speaker_tpu.cli import combine_data as j_combine
from tf_kaldi_speaker_tpu.cli import copy_feats as j_copy_feats
from tf_kaldi_speaker_tpu.cli import filter_egs_dir as j_filter
from tf_kaldi_speaker_tpu.cli import fix_data_dir as j_fix
from tf_kaldi_speaker_tpu.cli import make_voxceleb as j_vox
from tf_kaldi_speaker_tpu.cli import sample_validset_spk2utt as j_sample
from tf_kaldi_speaker_tpu.cli import validate_data_dir as j_validate
from tf_kaldi_speaker_tpu_torch.cli import combine_data as t_combine
from tf_kaldi_speaker_tpu_torch.cli import copy_feats as t_copy_feats
from tf_kaldi_speaker_tpu_torch.cli import filter_egs_dir as t_filter
from tf_kaldi_speaker_tpu_torch.cli import fix_data_dir as t_fix
from tf_kaldi_speaker_tpu_torch.cli import make_voxceleb as t_vox
from tf_kaldi_speaker_tpu_torch.cli import sample_validset_spk2utt as t_sample
from tf_kaldi_speaker_tpu_torch.cli import validate_data_dir as t_validate
from tf_kaldi_speaker_tpu_torch.kio import ArkScpWriter


def _write(d, name, text):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, name), "w") as f:
        f.write(text)


def _trees_equal(a, b):
    """Every file under a and b byte-equal, with a's path in a file read
    as b's."""
    fa = sorted(os.path.relpath(os.path.join(r, n), a) for r, _, ns in os.walk(a) for n in ns)
    fb = sorted(os.path.relpath(os.path.join(r, n), b) for r, _, ns in os.walk(b) for n in ns)
    assert fa == fb
    for rel in fa:
        with open(os.path.join(a, rel), "rb") as f:
            want = f.read().replace(a.encode(), b.encode())
        with open(os.path.join(b, rel), "rb") as f:
            assert f.read() == want, rel


def _both(tmp_path, build, run_jax, run_port):
    """Build the input tree twice, run each package on its own copy; the
    results (value or SystemExit message, the tree's path as ``<root>``)
    and the trees must agree."""
    out = []
    for name, run in (("jax", run_jax), ("port", run_port)):
        root = str(tmp_path / name)
        os.makedirs(root)
        build(root)
        try:
            out.append(("ok", run(root)))
        except SystemExit as e:
            out.append(("exit", type(e).__name__, str(e).replace(root, "<root>")))
    _trees_equal(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert out[0] == out[1]
    return out[0]


# -- fix_data_dir (test_tools_cli.py:211-277) --------------------------------

def _fix_plain(root):
    d = os.path.join(root, "data")
    _write(d, "utt2spk", "u2 spkB\nu1 spkA\nu4 spkB\nu3 spkA\n")
    _write(d, "feats.scp", "u4 a.ark:40\nu1 a.ark:10\nu2 a.ark:20\n")
    _write(d, "vad.scp", "u1 v.ark:1\nu2 v.ark:2\nu4 v.ark:4\nu9 v.ark:9\n")
    _write(d, "spk2utt", "spkA u1 u3\nspkB u2 u4\n")


def _fix_segments(root):
    d = os.path.join(root, "data")
    _write(d, "utt2spk", "u1 spkA\nu2 spkA\nu3 spkB\n")
    _write(d, "segments", "u1 reco1 0.0 1.0\nu2 reco2 0.0 1.0\nu3 reco2 1.0 2.0\n")
    _write(d, "feats.scp", "u1 a.ark:1\nu2 a.ark:2\n")
    _write(d, "wav.scp", "reco1 r1.wav\nreco2 r2.wav\nreco9 r9.wav\n")


@pytest.mark.parametrize("build", [_fix_plain, _fix_segments], ids=["plain", "segments"])
@pytest.mark.parametrize("backup", [True, False])
def test_fix_data_dir(tmp_path, build, backup):
    def run(mod):
        return lambda root: mod.fix_data_dir(os.path.join(root, "data"), backup=backup)

    result = _both(tmp_path, build, run(j_fix), run(t_fix))
    assert result[0] == "ok" and result[1]["utt2spk"] == 2 + (build is _fix_plain)


def test_fix_data_dir_cli_refuses_non_data_dir(tmp_path):
    result = _both(tmp_path, lambda root: _write(os.path.join(root, "d"), "wav.scp", "u a\n"),
                   lambda root: j_fix.main([os.path.join(root, "d")]),
                   lambda root: t_fix.main([os.path.join(root, "d")]))
    assert result[0] == "exit" and "no utt2spk" in result[2]


# -- combine_data (test_tools_cli.py:280-331) --------------------------------

def _combine_sources(root):
    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    _write(a, "utt2spk", "a2 spkA\na1 spkA\n")
    _write(a, "wav.scp", "a2 wav2\na1 wav1\n")
    _write(a, "utt2num_frames", "a1 100\na2 200\n")
    _write(b, "utt2spk", "b1 spkB\nb2 spkA\n")
    _write(b, "wav.scp", "b1 wav3\nb2 wav4\n")
    _write(b, "text", "b1 hello\n")


def _duplicate_sources(root, within):
    for name in ("a", "b"):
        _write(os.path.join(root, name), "utt2spk",
               "dup1 spkX\ndup1 spkX\n" if within and name == "a" else "dup1 spkX\n")


@pytest.mark.parametrize("case", ["merge", "dup_across", "dup_within", "no_source"])
def test_combine_data(tmp_path, case):
    build = {"merge": _combine_sources,
             "dup_across": lambda r: _duplicate_sources(r, False),
             "dup_within": lambda r: _duplicate_sources(r, True),
             "no_source": lambda r: os.makedirs(os.path.join(r, "a"))}[case]

    def run(mod):
        return lambda root: mod.main(["--extra-files", "utt2num_frames", "--",
                                      os.path.join(root, "dest"), os.path.join(root, "a")]
                                     + ([os.path.join(root, "b")] if case != "no_source" else []))

    result = _both(tmp_path, build, run(j_combine), run(t_combine))
    if case == "merge":
        assert result == ("ok", 0)
        with open(str(tmp_path / "port" / "dest" / "spk2utt")) as f:
            assert f.read() == "spkA a1 a2 b2\nspkB b1\n"
    else:
        assert result[0] == "exit"
        assert ("duplicate" if case != "no_source" else "no utt2spk") in result[2]


# -- validate_data_dir (test_validate_data_dir.py) ---------------------------

def _good(root, with_wav=True):
    _write(root, "utt2spk", "spk1-a spk1\nspk1-b spk1\nspk2-a spk2\n")
    _write(root, "spk2utt", "spk1 spk1-a spk1-b\nspk2 spk2-a\n")
    if with_wav:
        _write(root, "wav.scp", "spk1-a /x/a.wav\nspk1-b /x/b.wav\nspk2-a /x/c.wav\n")


def _with(**files):
    def build(root):
        _good(root)
        for name, text in files.items():
            _write(root, name.replace("_", ".", 1) if name == "wav_scp" else name, text)
    return build


VALIDATE = {
    "valid": (_with(utt2num_frames="spk1-a 100\nspk1-b 200\nspk2-a 300\n",
                    utt2dur="spk1-a 1.0\nspk1-b 2.0\nspk2-a 3.0\n"), {}),
    "unsorted": (lambda r: (_write(r, "utt2spk", "spk2-a spk2\nspk1-a spk1\n"),
                            _write(r, "wav.scp", "spk1-a /x\nspk2-a /x\n")), {}),
    "duplicate": (lambda r: (_write(r, "utt2spk", "spk1-a spk1\nspk1-a spk1\n"),
                             _write(r, "wav.scp", "spk1-a /x\n")), {}),
    "interleaved": (lambda r: (_write(r, "utt2spk", "utt-a spk1\nutt-b spk2\nutt-c spk1\n"),
                               _write(r, "wav.scp", "utt-a /x\nutt-b /x\nutt-c /x\n")), {}),
    "spk2utt_mismatch": (_with(spk2utt="spk1 spk1-a\nspk2 spk2-a\n"), {}),
    "wav_mismatch": (_with(wav_scp="spk1-a /x\nspk1-b /x\n"), {}),
    "feats_required": (_good, {"no_feats": False}),
    "feats_present": (_with(**{"feats.scp": "spk1-a /f:1\nspk1-b /f:2\nspk2-a /f:3\n"}),
                      {"no_feats": False}),
    "bad_num_frames": (_with(utt2num_frames="spk1-a 100\nspk1-b 0\nspk2-a 300\n"), {}),
    "segments": (lambda r: (_write(r, "utt2spk", "spk1-a spk1\nspk1-b spk1\n"),
                            _write(r, "segments", "spk1-a reco1 0.0 1.5\nspk1-b reco1 1.5 3.0\n"),
                            _write(r, "wav.scp", "reco1 /x/r.wav\n")), {}),
    "segments_missing_reco": (lambda r: (
        _write(r, "utt2spk", "spk1-a spk1\nspk1-b spk1\n"),
        _write(r, "segments", "spk1-a reco1 0.0 1.5\nspk1-b reco9 1.5 3.0\n"),
        _write(r, "wav.scp", "reco1 /x/r.wav\n")), {}),
    "segments_bad_times": (lambda r: (
        _write(r, "utt2spk", "spk1-a spk1\nspk1-b spk1\n"),
        _write(r, "segments", "spk1-a reco1 2.0 1.5\nspk1-b reco1 1.5 3.0\n"),
        _write(r, "wav.scp", "reco1 /x/r.wav\n")), {}),
    "no_wav_waived": (lambda r: _good(r, with_wav=False), {"no_wav": True}),
    "empty_line": (lambda r: _write(r, "utt2spk", "spk1-a spk1\n\n"), {}),
}


@pytest.mark.parametrize("case", sorted(VALIDATE))
def test_validate_data_dir(tmp_path, case):
    build, kw = VALIDATE[case]
    kw = dict(dict(no_text=True, no_feats=True), **kw)

    def run(mod):
        def go(root):
            counts = mod.validate_data_dir(root, **kw)
            flags = ["--no-text"] + [("--" + k.replace("_", "-")) for k in ("no_feats", "no_wav")
                                     if kw.get(k)]
            return counts, mod.main(flags + [root])
        return go

    result = _both(tmp_path, lambda r: build(r), run(j_validate), run(t_validate))
    if case in ("valid", "feats_present", "segments", "no_wav_waived"):
        assert result[0] == "ok"
    else:
        assert result[0] == "exit" and result[1] == "ValidationError"


# -- make_voxceleb (test_make_voxceleb.py) -----------------------------------

def _touch(*parts):
    path = os.path.join(*parts)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x00")


def _vox1_consolidated(root):
    for s in range(1, 5):
        for v in ("vidA", "vidB"):
            for c in ("00001", "00002"):
                _touch(root, "vox1", "wav", "id%05d" % s, v, c + ".wav")
    _write(root, "veri_test.txt",
           "1 id00003/vidA/00001.wav id00003/vidB/00002.wav\n"
           "0 id00003/vidA/00001.wav id00004/vidA/00001.wav\n"
           "1 id00004/vidB/00001.wav id00004/vidB/99999.wav\n")


def _vox1_split(root):
    _touch(root, "vox1", "dev", "wav", "id00001", "vidA", "00001.wav")
    _touch(root, "vox1", "test", "wav", "id00002", "vidA", "00001.wav")
    _write(root, "veri_test.txt", "0 id00002/vidA/00001.wav id00002/vidA/00001.wav\n")


def _vox2(layout):
    def build(root):
        ext = ".m4a" if layout == "aac" else ".wav"
        for s in (101, 102):
            _touch(root, "vox2 corpus", "dev", layout, "id%05d" % s, "clipX", "00001" + ext)
        _touch(root, "vox2 corpus", "dev", layout, "id00103", "clipY", "notes.txt")
    return build


MAKE_VOX = {
    "vox1_consolidated": (_vox1_consolidated, lambda r: [
        "voxceleb1", os.path.join(r, "vox1"), os.path.join(r, "data"), "--trials",
        os.path.join(r, "veri_test.txt")]),
    "vox1_split": (_vox1_split, lambda r: [
        "voxceleb1", os.path.join(r, "vox1"), os.path.join(r, "data"), "--trials",
        os.path.join(r, "veri_test.txt")]),
    "vox2_aac": (_vox2("aac"), lambda r: [
        "voxceleb2", os.path.join(r, "vox2 corpus"), os.path.join(r, "data"), "--part", "dev"]),
    "vox2_wav": (_vox2("wav"), lambda r: [
        "voxceleb2", os.path.join(r, "vox2 corpus"), os.path.join(r, "data"), "--part", "dev"]),
    "vox2_missing_part": (_vox2("wav"), lambda r: [
        "voxceleb2", os.path.join(r, "vox2 corpus"), os.path.join(r, "data"), "--part", "test"]),
}


@pytest.mark.parametrize("case", sorted(MAKE_VOX))
def test_make_voxceleb(tmp_path, case):
    build, argv = MAKE_VOX[case]
    result = _both(tmp_path, build, lambda r: j_vox.main(argv(r)), lambda r: t_vox.main(argv(r)))
    if case == "vox2_missing_part":
        assert result[0] == "exit" and "neither" in result[2]
        return
    assert result == ("ok", 0)
    if case == "vox2_aac":
        with open(str(tmp_path / "port" / "data" / "voxceleb2_dev" / "wav.scp")) as f:
            entries = [ln.split(" ", 1)[1] for ln in f.read().splitlines()]
        assert all(e.startswith("ffmpeg ") and e.endswith("- |") and "'" in e for e in entries)


# -- filter_egs_dir, sample_validset_spk2utt ---------------------------------

def _egs_dir(root):
    rng = np.random.RandomState(4)
    feats, u2nf, u2s, s2u = [], [], [], {}
    for s in range(12):
        for u in range(int(rng.randint(3, 9))):
            utt = "spk%02d-u%d" % (s, u)
            feats.append("%s /x/f.ark:%d" % (utt, 10 * len(feats)))
            u2nf.append("%s %d" % (utt, rng.randint(150, 500)))
            u2s.append("%s spk%02d" % (utt, s))
            s2u.setdefault("spk%02d" % s, []).append(utt)
    d = os.path.join(root, "egs")
    _write(d, "feats.scp", "\n".join(feats) + "\n")
    _write(d, "utt2num_frames", "\n".join(u2nf) + "\n")
    _write(d, "utt2spk", "\n".join(u2s) + "\n")
    _write(d, "spk2utt", "".join("%s %s\n" % (s, " ".join(us)) for s, us in s2u.items()))


@pytest.mark.parametrize("flags", [[], ["--valid-speakers", "3", "--valid-utts", "2"],
                                   ["--min-len", "300", "--min-num-utts", "3",
                                    "--valid-speakers", "50", "--valid-utts", "9",
                                    "--seed", "7"]])
def test_filter_egs_dir(tmp_path, flags):
    def run(mod):
        return lambda r: mod.main(flags + [os.path.join(r, "egs"), os.path.join(r, "split")])

    assert _both(tmp_path, _egs_dir, run(j_filter), run(t_filter)) == ("ok", 0)


@pytest.mark.parametrize("argv", [["3", "2"], ["50", "9"], ["1"]])
def test_sample_validset_spk2utt(tmp_path, capsys, argv):
    outs = []

    def run(mod):
        def go(r):
            rc = mod.main(argv + [os.path.join(r, "egs", "spk2utt")] if len(argv) == 2 else argv)
            outs.append(capsys.readouterr())
            return rc
        return go

    result = _both(tmp_path, _egs_dir, run(j_sample), run(t_sample))
    assert outs[0].out == outs[1].out
    if len(argv) == 2:
        assert result == ("ok", 0) and outs[1].out
    else:
        assert result == ("ok", 1) and "sample_validset_spk2utt" in outs[1].err


# -- copy_feats ---------------------------------------------------------------

def _feats_ark(root):
    rng = np.random.RandomState(9)
    w = ArkScpWriter("ark,scp:%s,%s" % (os.path.join(root, "in.ark"),
                                        os.path.join(root, "in.scp")), kind="mat")
    for i, n in enumerate((50, 3, 120)):
        w.write("utt%d" % i, (rng.randn(n, 30) * 4).astype(np.float32), compress=(i == 1))
    w.close()


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("source", ["scp", "ark"])
def test_copy_feats(tmp_path, compress, source):
    def run(mod):
        def go(r):
            rspec = ("scp:%s" % os.path.join(r, "in.scp") if source == "scp"
                     else "ark:%s" % os.path.join(r, "in.ark"))
            wspec = "ark,scp:%s,%s" % (os.path.join(r, "out.ark"), os.path.join(r, "out.scp"))
            return mod.main((["--compress"] if compress else []) + [rspec, wspec])
        return go

    assert _both(tmp_path, _feats_ark, run(j_copy_feats), run(t_copy_feats)) == ("ok", 0)
    assert filecmp.cmp(str(tmp_path / "jax" / "out.ark"), str(tmp_path / "port" / "out.ark"),
                       shallow=False)
