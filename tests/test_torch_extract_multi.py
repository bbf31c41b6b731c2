"""Extraction over several devices in one process: the port's
``Extractor`` and ``DevicePipeExtractor`` with ``devices=["cpu"] * 8`` (each
bucket batch cut into 8 row blocks, one a device) against one device and
against the JAX package's extractors over the 8 CPU devices the conftest
forces (``tests/test_extract_backend.py``'s sharded-mesh check), and
``cli.extract``'s arks with 1 and with 8 devices. The model is one msgpack
checkpoint both packages read, written from the port's module with
non-trivial BatchNorm statistics."""

import json

import numpy as np
import pytest
import torch
from flax import serialization

from test_device_pipe import _make_compressed_ark
from test_extract_backend import TINY_CONFIG
from tf_kaldi_speaker_tpu_torch import convert
from tf_kaldi_speaker_tpu_torch.cli import extract as extract_cli
from tf_kaldi_speaker_tpu_torch.extract import extractor as extractor_mod
from tf_kaldi_speaker_tpu_torch.extract.device_pipe import DevicePipeExtractor
from tf_kaldi_speaker_tpu_torch.extract.extractor import Extractor, resolve_devices
from tf_kaldi_speaker_tpu_torch.kio import read_codes_scp, read_vec_flt_scp
from tf_kaldi_speaker_tpu_torch.models.layers import BatchNorm
from tf_kaldi_speaker_tpu_torch.train.trainer import XVectorModel

torch.set_num_threads(1)

D = 20
TOL = dict(rtol=1e-5, atol=1e-6)
EIGHT = ["cpu"] * 8
KW = dict(min_chunk_size=10, chunk_size=100, batch_size=8)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    g = torch.Generator().manual_seed(0)
    net = XVectorModel(TINY_CONFIG, TINY_CONFIG["loss_func"], 8, D, g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                w = m.mean.shape[0]
                m.mean.copy_(torch.randn(w, generator=g) * 0.1)
                m.var.copy_(torch.rand(w, generator=g) * 1.5 + 0.5)
    tree = _numpy(convert.variables_of(net))
    root = tmp_path_factory.mktemp("multi")
    nnet = root / "m" / "nnet"
    nnet.mkdir(parents=True)
    (nnet / "model-0.msgpack").write_bytes(serialization.msgpack_serialize(
        {"params": tree["params"], "batch_stats": tree["batch_stats"], "step": np.int32(0)}))
    (nnet / "checkpoint").write_text('model_checkpoint_path: "model-0"\n')
    (nnet / "config.json").write_text(json.dumps(TINY_CONFIG))
    (nnet / "feature_dim").write_text("%d\n" % D)
    return str(root / "m")


@pytest.fixture(scope="module")
def utts():
    """test_extract_backend's: 11 utterances that fill one 8-wide batch
    and flush partial buckets, 4 of them over chunk_size, and one long one
    through the 50%-overlap chunks."""
    rng = np.random.RandomState(9)
    out = [("u%02d" % i, rng.randn(40 + 9 * i, D).astype(np.float32)) for i in range(11)]
    return out + [("long", rng.randn(260, D).astype(np.float32))]


def _assert_same(got, want, tol=TOL):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, err_msg=k, **tol)


def test_resolve_devices():
    assert resolve_devices("cpu") == [torch.device("cpu")]
    assert resolve_devices("cuda:1") == [torch.device("cuda", 1)]
    assert resolve_devices("cuda", EIGHT) == [torch.device("cpu")] * 8
    with pytest.raises(ValueError):
        resolve_devices("cpu", [])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_devices("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_devices(torch.device("cuda"))


def test_feature_path_over_eight_devices(model, utts):
    """8 row blocks == 1 device == the JAX Extractor over 8 devices: keys,
    order and values (the batch is rounded to 8 and each batch-of-1 long
    chunk is padded to 8 rows)."""
    import jax

    from tf_kaldi_speaker_tpu.extract.extractor import Extractor as JaxExtractor
    from tf_kaldi_speaker_tpu.parallel.mesh import make_mesh

    one = Extractor(model, device="cpu", **KW)
    eight = Extractor(model, devices=EIGHT, **dict(KW, batch_size=5))
    assert eight.batch_size == 8 and len(eight._replicas) == 1
    assert eight._rows_for(1) == 8 and one._rows_for(1) == 1
    got = list(eight.embed_stream(iter(utts)))
    _assert_same(got, list(one.embed_stream(iter(utts))))
    jax_ex = JaxExtractor(model, mesh=make_mesh(jax.devices()), **KW)
    assert len(jax_ex.mesh.devices.flatten()) == 8
    _assert_same(got, list(jax_ex.embed_stream(iter(utts))))
    assert sorted(k for k, _ in got) == sorted(k for k, _ in utts)
    # a batch 8 does not divide: padded with zero rows and a zero mask
    feats = np.stack([f[:40] for _, f in utts[:3]])
    mask = np.ones((3, 40), np.float32)
    np.testing.assert_allclose(eight._embed_batch(feats, mask), one._embed_batch(feats, mask),
                               **TOL)


@pytest.fixture(scope="module")
def scp(tmp_path_factory):
    # one length bucket, so the JAX pipe compiles one program
    return _make_compressed_ark(tmp_path_factory.mktemp("multi_ark"), n_utts=11, seed=4,
                                lens=(58, 64))


def test_device_pipe_over_eight_devices(model, scp):
    import jax

    from tf_kaldi_speaker_tpu.extract.device_pipe import DevicePipeExtractor as JaxPipe
    from tf_kaldi_speaker_tpu.parallel.mesh import make_mesh

    items = list(read_codes_scp(scp))
    kw = dict(min_chunk_size=10, batch_size=8)
    got = list(DevicePipeExtractor(model, devices=EIGHT, **kw).embed_codes_stream(iter(items)))
    one = list(DevicePipeExtractor(model, device="cpu", **kw).embed_codes_stream(iter(items)))
    _assert_same(got, one)
    want = list(JaxPipe(model, mesh=make_mesh(jax.devices()), **kw)
                .embed_codes_stream(iter(items)))
    _assert_same(got, want)
    assert len(got) == 11


@pytest.mark.parametrize("pipe", [False, True])
def test_cli_extract_over_eight_devices(model, scp, tmp_path, monkeypatch, pipe):
    """``cli.extract --device cpu`` with the extractor's devices resolved to
    8 CPU devices writes the one-device arks: keys and order equal."""
    flags = (["--device-pipe"] if pipe else []) + ["--cmvn", "--vad", "--min-chunk-size", "10",
                                                   "--batch-size", "4", "--device", "cpu"]

    def run(name):
        out = str(tmp_path / name)
        assert extract_cli.main(flags + [model, "scp:" + scp,
                                         "ark,scp:%s.ark,%s.scp" % (out, out)]) == 0
        return list(read_vec_flt_scp(out + ".scp"))

    one = run("one")
    real = extractor_mod.resolve_devices
    monkeypatch.setattr(extractor_mod, "resolve_devices", lambda device, devices=None:
                        real(device, EIGHT))
    eight = run("eight")
    assert len(one) == 11
    _assert_same(eight, one)
