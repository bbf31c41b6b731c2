"""The port's Kaldi codec (tf_kaldi_speaker_tpu_torch.kio) against the JAX
package's (tf_kaldi_speaker_tpu.kio), bit for bit, in both directions: arks
written by one package's ArkScpWriter are read by both packages' readers,
and the two writers produce the same bytes."""

import numpy as np
import pytest

from tf_kaldi_speaker_tpu.kio import ark as jax_ark
from tf_kaldi_speaker_tpu_torch import kio as port_kio

WRITERS = {"jax": jax_ark.ArkScpWriter, "port": port_kio.ArkScpWriter}
READERS = {"jax": jax_ark, "port": port_kio}


def _corpus():
    """(key, matrix, compress) and (key, vector) items from one seed:
    compressed float32 matrices of several lengths (one constant, one of a
    single frame), uncompressed float32 and float64 matrices, float32 and
    float64 vectors."""
    rng = np.random.RandomState(0)
    mats = []
    for i, t in enumerate((1, 7, 64, 301)):
        m = (rng.randn(t, 30) * (i + 1) * 3.0 + rng.randn(30) * 5.0).astype(np.float32)
        mats.append(("cm%d" % i, m, True))
    mats.append(("cmconst", np.full((12, 5), 2.5, np.float32), True))
    mats.append(("fm", rng.randn(9, 13).astype(np.float32), False))
    mats.append(("dm", rng.randn(4, 3), False))
    vecs = [("fv%d" % i, rng.randn(d).astype(np.float32)) for i, d in enumerate((1, 512, 33))]
    vecs.append(("dv", rng.randn(7)))
    return mats, vecs


@pytest.fixture(scope="module")
def arks(tmp_path_factory):
    """For each writer, the (ark, scp) paths of a matrix ark (all items), a
    codes ark (the compressed items only) and a vector ark."""
    mats, vecs = _corpus()
    root = tmp_path_factory.mktemp("kio")
    out = {}
    for who, writer_cls in WRITERS.items():
        paths = {}
        for name, kind, items in (
                ("mat", "mat", mats),
                ("codes", "mat", [it for it in mats if it[2]]),
                ("vec", "vec", [(k, v, False) for k, v in vecs])):
            ark, scp = (str(root / ("%s_%s.%s" % (who, name, ext))) for ext in ("ark", "scp"))
            w = writer_cls("ark,scp:%s,%s" % (ark, scp), kind=kind)
            for key, value, compress in items:
                if kind == "mat":
                    w.write(key, value, compress=compress)
                else:
                    w.write(key, value)
            w.close()
            paths[name] = (ark, scp)
        out[who] = paths
    return out


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", ["mat", "codes", "vec"])
def test_writers_write_the_same_bytes(arks, name):
    jax_ark_path, jax_scp = arks["jax"][name]
    port_ark_path, port_scp = arks["port"][name]
    assert _bytes(port_ark_path) == _bytes(jax_ark_path)
    # the scps differ only in the ark's file name
    jax_lines = _bytes(jax_scp).decode().replace(jax_ark_path, "ARK")
    assert _bytes(port_scp).decode().replace(port_ark_path, "ARK") == jax_lines


def _read(reader, what, paths):
    """One reader's view of one written corpus as a list of (key, arrays)."""
    mod = READERS[reader]
    if what == "codes_scp":
        return [(k, (c, h)) for k, c, h in mod.read_codes_scp(paths["codes"][1])]
    if what == "decode_cm_codes":
        return [(k, (mod.decode_cm_codes(c, h),))
                for k, c, h in mod.read_codes_scp(paths["codes"][1])]
    if what == "mat_rspec_scp":
        return [(k, (m,)) for k, m in mod.read_mat_rspec("scp:" + paths["mat"][1])]
    if what == "mat_rspec_ark":
        return [(k, (m,)) for k, m in mod.read_mat_rspec("ark:" + paths["mat"][0])]
    if what == "vec_scp":
        return [(k, (v,)) for k, v in mod.read_vec_flt_scp(paths["vec"][1])]
    if what == "vec_ark":
        return [(k, (v,)) for k, v in mod.read_vec_flt_ark(paths["vec"][0])]
    raise ValueError(what)


@pytest.mark.parametrize("what", ["codes_scp", "decode_cm_codes", "mat_rspec_scp",
                                  "mat_rspec_ark", "vec_scp", "vec_ark"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_port_reads_bit_equal_to_jax(arks, writer, what):
    """Port readers and JAX readers on the same ark give the same keys and
    bit-equal arrays of the same dtype and shape; matrices and vectors also
    equal what was written (within the CM format's resolution when
    compressed)."""
    want = _read("jax", what, arks[writer])
    got = _read("port", what, arks[writer])
    assert [k for k, _ in got] == [k for k, _ in want] and len(want) >= 3
    for (key, g), (_, w) in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape, key
            np.testing.assert_array_equal(a, b, err_msg=key)
    mats, vecs = _corpus()
    written = {k: (v, c) for k, v, c in mats}
    written.update({k: (v, False) for k, v in vecs})
    for key, arrays in got:
        if what == "codes_scp":
            continue
        value, compressed = written[key]
        if compressed:
            span = float(value.max() - value.min()) or 1.0
            np.testing.assert_allclose(arrays[0], value, atol=span / 32, err_msg=key)
        else:
            np.testing.assert_array_equal(arrays[0], value, err_msg=key)


def test_write_mat_and_vec_single_objects(tmp_path):
    """write_mat / write_vec_flt without a key, read back by both packages."""
    rng = np.random.RandomState(1)
    m = rng.randn(20, 6).astype(np.float32)
    v = rng.randn(11).astype(np.float32)
    for compress in (False, True):
        path = str(tmp_path / ("m%d.bin" % compress))
        port_kio.write_mat(path, m, compress=compress)
        np.testing.assert_array_equal(port_kio.read_mat(path), jax_ark.read_mat(path))
    path = str(tmp_path / "v.bin")
    port_kio.write_vec_flt(path, v)
    np.testing.assert_array_equal(port_kio.read_vec_flt(path), jax_ark.read_vec_flt(path))
    assert port_kio.compress_matrix(m) == jax_ark.compress_matrix(m)


def test_codes_reader_refuses_uncompressed(arks):
    with pytest.raises(port_kio.ark.UnknownMatrixHeader):
        list(port_kio.read_codes_scp(arks["port"]["mat"][1]))
