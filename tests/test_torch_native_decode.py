"""The port's native ark reader (``kio/native_decode.py`` over
``native/ark_decoder.cpp``, built here with g++) against the numpy codecs
of both packages and the JAX package's native reader, and the port's
``RandomChunkSampler`` against the JAX sampler with the native readers on
and off.

Bit for bit: the port's native reads (``read_submat_fast``,
``decode_batch_fast``, ``read_batch_codes_fast``) and the port's and the
JAX package's numpy codecs, on CM and FM arks, at start 0, at the last
frame and over whole matrices; raw codes also against the JAX native
reader. The JAX native reader is built without ``-ffp-contract=off``, so
g++ may fuse its products and sums, and it decodes CM with
``p75 + ((p100 - p75) / 63) * (v - 192)``, which rounds differently from
the numpy codecs' ``p75 + (p100 - p75) * ((v - 192) / 63)``; the port
decodes in the numpy order, so where its floats differ from the JAX native
reader's, the JAX native reader differs from the numpy codec too."""

import logging
import os

import numpy as np
import pytest

from tf_kaldi_speaker_tpu import data as jdata
from tf_kaldi_speaker_tpu.kio import ark as jark
from tf_kaldi_speaker_tpu.kio import native_decode as jnd
from tf_kaldi_speaker_tpu_torch import data as tdata
from tf_kaldi_speaker_tpu_torch.kio import FeatureReader
from tf_kaldi_speaker_tpu_torch.kio import ark, native_decode
from tf_kaldi_speaker_tpu_torch.utils import tb_events
from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

ROWS, COLS = 300, 30


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def arks(tmp_path_factory):
    """One CM and one FM ark of a [300, 30] matrix with wide columns (every
    code segment used) and a constant column; (path, offset, matrix as the
    numpy codec reads it) each."""
    root = tmp_path_factory.mktemp("native")
    rng = np.random.RandomState(7)
    m = (rng.randn(ROWS, COLS) * rng.uniform(0.1, 20, COLS)).astype(np.float32)
    m[:, 3] = 1.5
    out = {}
    for compress in (True, False):
        path = str(root / ("m%d.ark" % compress))
        with open(path, "wb") as f:
            ark.write_mat(f, m, key="u1", compress=compress)
        out["cm" if compress else "fm"] = (path, len("u1") + 1, ark.read_mat(path + ":3"))
    return out


def test_library_builds_under_build_dir():
    assert native_decode.native_available()
    path = native_decode.library_path()
    assert os.path.exists(path)
    assert os.sep + os.path.join("build", "tfks_torch_native") + os.sep in path
    assert "-ffp-contract=off" in native_decode.GXX_FLAGS
    assert "tf_kaldi_speaker_tpu" + os.sep not in os.path.relpath(native_decode.SOURCE)


def test_source_exports_the_jax_entry_points():
    import re

    def exports(path):
        with open(path) as f:
            return set(re.findall(r"^(?:int|uint32_t) (tfks_\w+)\(", f.read(), re.M))

    jax_src = os.path.join(os.path.dirname(jnd.__file__), "..", "native", "ark_decoder.cpp")
    want = {"tfks_decode_submat", "tfks_read_codes", "tfks_read_batch_codes",
            "tfks_decode_batch", "tfks_close_all", "tfks_crc32c"}
    assert exports(native_decode.SOURCE) == exports(jax_src) == want


@pytest.mark.parametrize("kind", ["cm", "fm"])
@pytest.mark.parametrize("start,length", [(0, ROWS), (0, 17), (ROWS - 1, 1), (131, 100),
                                          (ROWS - 64, 64)])
def test_submat_bit_equal_to_numpy_codecs(arks, kind, start, length):
    path, offset, full = arks[kind]
    got = native_decode.read_submat_fast(path, offset, start, length)
    assert got is not None and got.shape == (length, COLS)
    np.testing.assert_array_equal(_bits(got), _bits(full[start:start + length]))
    with open(path, "rb") as f:
        f.seek(offset)
        assert f.read(2) == b"\0B"
        want = jark._read_submat_binary(f, start, length)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    jax_native = jnd.read_submat_fast(path, offset, start, length)
    if jax_native is None:
        return  # the JAX package's own build is not available here
    differ = _bits(got) != _bits(jax_native)
    if kind == "fm":
        assert not differ.any()
    else:
        # only where the JAX native reader departs from the numpy codec
        assert np.all(_bits(jax_native)[differ] != _bits(want)[differ])


@pytest.mark.parametrize("flags", [("-DTFKS_CM_SPAN_FACTOR=0",),
                                   ("-DTFKS_CM_SPAN_FACTOR=1000000",)],
                         ids=["per_column", "span"])
def test_cm_read_builds_bit_equal(arks, flags):
    """A build that reads every CM matrix column by column (the JAX copy's
    reads) and one that reads each in one span decode and copy the codes
    bit-equal to the numpy codec, over the ranges the port's build reads
    one way or the other (a span at most 4 times the requested bytes)."""
    import ctypes

    lib = native_decode.load(native_decode.build(native_decode.GXX_FLAGS + flags))
    path, offset, full = arks["cm"]
    with open(path, "rb") as f:
        f.seek(offset + 2)
        want_c, want_h = ark._read_compressed_codes(f, f.read(3).decode())
    fp = ctypes.POINTER(ctypes.c_float)
    for start, length in [(0, ROWS), (0, 17), (ROWS - 1, 1), (131, 100), (ROWS - 64, 64)]:
        out = np.empty((length, COLS), np.float32)
        assert lib.tfks_decode_submat(path.encode(), offset, start, length,
                                      out.ctypes.data_as(fp), out.size) == COLS
        np.testing.assert_array_equal(_bits(out), _bits(full[start:start + length]))
        codes = np.empty((1, length, COLS), np.uint8)
        headers = np.empty((1, 4, COLS), np.float32)
        assert lib.tfks_read_batch_codes(
            *native_decode.batch_args([(path, offset, start, length)]), 1, length, COLS,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), headers.ctypes.data_as(fp),
            1) == COLS
        np.testing.assert_array_equal(codes[0], want_c[start:start + length])
        np.testing.assert_array_equal(_bits(headers[0]), _bits(want_h))
    lib.tfks_close_all()


@pytest.mark.parametrize("kind", ["cm", "fm"])
def test_batch_decode_and_codes_bit_equal(arks, kind):
    path, offset, full = arks[kind]
    items = [(path, offset, s, 40) for s in (0, ROWS - 40, 7, 130)]
    out = np.full((5, 40, COLS), -7.0, np.float32)
    before = dict(native_decode.counts)
    assert native_decode.decode_batch_fast(items, out)
    assert native_decode.counts["decode_batch"] == before.get("decode_batch", 0) + 1
    for k, (_, _, s, n) in enumerate(items):
        np.testing.assert_array_equal(_bits(out[k]), _bits(full[s:s + n]))
    np.testing.assert_array_equal(out[4], -7.0)  # rows past the items untouched
    codes = np.zeros((4, 40, COLS), np.uint8)
    headers = np.zeros((4, 4, COLS), np.float32)
    ok = native_decode.read_batch_codes_fast(items, codes, headers)
    if kind == "fm":
        assert not ok  # raw codes need a CM matrix: the caller reads through numpy
        return
    assert ok
    with open(path, "rb") as f:
        f.seek(offset + 2)
        want_c, want_h = ark._read_compressed_codes(f, f.read(3).decode())
    for k, (_, _, s, n) in enumerate(items):
        np.testing.assert_array_equal(codes[k], want_c[s:s + n])
        np.testing.assert_array_equal(_bits(headers[k]), _bits(want_h))
        np.testing.assert_array_equal(_bits(ark.decode_cm_codes(codes[k], headers[k])),
                                      _bits(full[s:s + n]))
    jcodes, jheaders = np.zeros_like(codes), np.zeros_like(headers)
    if jnd.read_batch_codes_fast(items, jcodes, jheaders):
        np.testing.assert_array_equal(codes, jcodes)
        # the JAX build lets g++ contract gmin + step * u16 into an FMA
        differ = _bits(headers) != _bits(jheaders)
        assert np.all(_bits(jheaders)[differ] != _bits(np.broadcast_to(want_h, headers.shape))[differ])


def test_rejected_reads_fall_back_and_are_counted(arks, tmp_path):
    path, offset, full = arks["cm"]
    native_decode.reset_counts()
    assert native_decode.read_submat_fast(path, offset, ROWS - 5, 10) is None  # range
    out = np.zeros((2, 10, COLS), np.float32)
    assert not native_decode.decode_batch_fast(
        [(path, offset, 0, 10), (path, offset, ROWS - 5, 10)], out)
    dpath = str(tmp_path / "d.ark")  # a float64 matrix: neither CM nor FM
    with open(dpath, "wb") as f:
        ark.write_mat(f, np.ones((20, COLS)), key="u1")
    assert native_decode.read_submat_fast(dpath, 3, 0, 5) is None
    assert native_decode.counts == {"fallback": 3}
    # the reader then decodes through numpy: same values, or the numpy error
    data = make_fake_data_dir(str(tmp_path / "dir"), num_speakers=1, utts_per_speaker=2,
                              dim=COLS, min_len=40, max_len=60, compress=False)
    reader = FeatureReader(data["data"])
    seg = open(data["feats_scp"]).readline().strip()
    n = reader.utt2num_frames[seg.split(" ")[0]]
    with pytest.raises(ValueError):
        reader.read_segment(seg, 10, start=n - 5)
    reader.close()


def test_disabled_reads_through_numpy(arks, monkeypatch):
    path, offset, full = arks["cm"]
    monkeypatch.setenv("TFKS_DISABLE_NATIVE", "1")
    native_decode.reset_counts()
    assert not native_decode.native_available()
    assert native_decode.read_submat_fast(path, offset, 0, 10) is None
    assert native_decode.crc32c_fast(b"abc") is None
    assert native_decode.counts == {"fallback": 1}
    monkeypatch.delenv("TFKS_DISABLE_NATIVE")
    assert native_decode.native_available()


def test_failed_build_warns_once(tmp_path, monkeypatch, caplog):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int tfks_decode_submat( {\n")
    monkeypatch.setattr(native_decode, "SOURCE", str(bad))
    monkeypatch.setattr(native_decode, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_decode, "_lib", None)
    monkeypatch.setattr(native_decode, "_load_failed", False)
    with caplog.at_level(logging.WARNING, logger="tfks_torch.native_decode"):
        assert not native_decode.native_available()
        assert not native_decode.native_available()
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "broken.cpp" in warnings[0].getMessage()
    assert "error" in warnings[0].getMessage()


@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 4099])
def test_crc32c_equals_the_python_table(size):
    data = np.random.RandomState(size).bytes(size)
    assert native_decode.crc32c_fast(data) == tb_events.crc32c(data)
    if jnd.native_available():
        assert jnd.crc32c_fast(data) == tb_events.crc32c(data)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("sampler")
    kw = dict(num_speakers=6, utts_per_speaker=3, dim=10, min_len=60, max_len=150, seed=5)
    return {c: make_fake_data_dir(str(root / ("c%d" % c)), compress=c, **kw)
            for c in (True, False)}


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("raw_codes,compress", [(False, True), (False, False), (True, True)],
                         ids=["cm_floats", "fm_floats", "codes"])
def test_random_sampler_matches_jax(corpora, monkeypatch, native, raw_codes, compress):
    """Three groups of 2 batches from one seed: bit-equal to the JAX
    sampler's with both native readers on (floats from CM arks: equal to
    the JAX sampler's on its numpy codec, and to its native reader's but
    where that departs from the numpy codec, see the module docstring) and
    with both off."""
    d = corpora[compress]
    if not native:
        monkeypatch.setenv("TFKS_DISABLE_NATIVE", "1")
    kw = dict(num_speakers=4, num_segments=2, min_len=40, max_len=56, seed=9,
              raw_codes=raw_codes, group=2)
    port = tdata.RandomChunkSampler(d["data"], d["spklist"], **kw)
    jax_native = jdata.RandomChunkSampler(d["data"], d["spklist"], **kw)
    jax_numpy = jdata.RandomChunkSampler(d["data"], d["spklist"], **kw)
    take = lambda sampler: [b for _, b in zip(range(3), sampler)]  # noqa: E731
    native_decode.reset_counts()
    got = take(port)
    with monkeypatch.context() as m:
        m.setattr(jnd, "_get_lib", lambda: None)
        numpy_want = take(jax_numpy)
        if not native:
            native_want = take(jax_native)
    if native:
        native_want = take(jax_native)
    for sampler in (port, jax_native, jax_numpy):
        sampler.close()
    fallbacks = native_decode.counts.get("fallback", 0)
    assert (fallbacks == 0) if native else (fallbacks > 0)
    for g, nw, w in zip(got, native_want, numpy_want):
        assert len(g) == len(w) == (3 if raw_codes else 2)
        for a, b, c in zip(g, nw, w):
            assert a.dtype == c.dtype and a.shape == c.shape
            np.testing.assert_array_equal(a, c)
            if a.dtype == np.float32 and native and compress:
                differ = _bits(a) != _bits(b)
                assert np.all(_bits(b)[differ] != _bits(c)[differ])
            else:
                np.testing.assert_array_equal(a, b)
