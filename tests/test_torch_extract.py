"""Port extraction against the JAX package on one model dir written by the
JAX Trainer (msgpack checkpoint, read by the port's own decoder): the
bucketed stream, the 50%-overlap long path, the decode-on-device pipe for
every CMVN/VAD combination, the embedding server and the extraction CLI.
Everything runs in float32 on the CPU."""

import os
import threading

import numpy as np
import pytest
import torch
from flax import serialization

from test_device_pipe import D, _make_compressed_ark, _make_model
from tf_kaldi_speaker_tpu.cli.extract import apply_cmvn_vad as jax_apply_cmvn_vad
from tf_kaldi_speaker_tpu.cli.extract import main as jax_extract_main
from tf_kaldi_speaker_tpu.extract.device_pipe import DevicePipeExtractor as JaxDevicePipe
from tf_kaldi_speaker_tpu.extract.extractor import Extractor as JaxExtractor
from tf_kaldi_speaker_tpu.kio.ark import ArkScpWriter, read_codes_scp, read_mat_scp, read_vec_flt_scp
from tf_kaldi_speaker_tpu_torch.cli.extract import apply_cmvn_vad
from tf_kaldi_speaker_tpu_torch.cli.extract import main as extract_main
from tf_kaldi_speaker_tpu_torch.extract.device_pipe import DevicePipeExtractor
from tf_kaldi_speaker_tpu_torch.extract.extractor import Extractor
from tf_kaldi_speaker_tpu_torch.extract.server import EmbeddingServer, embed_remote
from tf_kaldi_speaker_tpu_torch.train import checkpoints

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
PIPE_TOL = dict(rtol=2e-4, atol=2e-5)  # CMVN's float32 cumsums differ in order
KW = dict(min_chunk_size=10, batch_size=4)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return _make_model(tmp_path_factory.mktemp("torch_extract"))


@pytest.fixture(scope="module")
def scp(tmp_path_factory):
    # one length bucket, so each JAX pipe compiles one program
    return _make_compressed_ark(tmp_path_factory.mktemp("torch_ark"), n_utts=6,
                                seed=2, lens=(58, 64))


def _feats(seed, lens):
    rng = np.random.RandomState(seed)
    return [("u%d" % i, rng.randn(n, D).astype(np.float32)) for i, n in enumerate(lens)]


def _assert_same(got, want, tol):
    assert set(got) == set(want) and got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + "/" + k))
        return out
    return {prefix: tree}


def test_msgpack_reader_and_pt_checkpoint(model, tmp_path):
    nnet = os.path.join(model, "nnet")
    with open(os.path.join(nnet, "model-0.msgpack"), "rb") as f:
        want = _leaves(serialization.msgpack_restore(f.read()))
    got, step = checkpoints.load_checkpoint(nnet)
    assert step == 0
    flat = _leaves(got)
    assert set(flat) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert isinstance(flat[k], torch.Tensor), k
            np.testing.assert_array_equal(flat[k].numpy(), v, err_msg=k)
        else:
            assert flat[k] == v, k

    tree = {"params": {"network": got["params"]["network"]},
            "batch_stats": {"network": got["batch_stats"]["network"]}}
    out = str(tmp_path / "nnet")
    checkpoints.save_checkpoint(out, tree, 7)
    assert checkpoints.read_pointer(out) == 7 and checkpoints.list_steps(out) == [7]
    back, step = checkpoints.load_checkpoint(out)
    assert step == 7
    back, tree = _leaves(back), _leaves(tree)
    assert set(back) == set(tree)
    for k, v in tree.items():
        assert torch.equal(back[k], v), k


def test_msgpack_bfloat16_scalar_and_chunked_leaves(monkeypatch):
    import jax.numpy as jnp

    x = np.arange(6, dtype=np.float32).reshape(2, 3) / 7.0
    big = np.arange(40, dtype=np.float32).reshape(5, 8)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)  # split `big`
    blob = serialization.msgpack_serialize(
        {"w": jnp.asarray(x, jnp.bfloat16), "s": np.int32(3), "big": big})
    got = checkpoints.msgpack_restore(blob)
    assert got["w"].dtype == torch.bfloat16 and got["s"] == 3
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(got["big"].numpy(), big)


def test_embed_stream_matches_jax(model):
    feats = _feats(0, [30, 45, 100, 150, 62, 8])  # the last one is skipped
    want = dict(JaxExtractor(model, **KW).embed_stream(iter(feats)))
    got = dict(Extractor(model, device="cpu", **KW).embed_stream(iter(feats)))
    assert len(got) == 5
    _assert_same(got, want, TOL)


@pytest.mark.parametrize("normalize", [False, True])
def test_embed_long_matches_jax(model, normalize):
    feats = _feats(1, [200])
    kw = dict(KW, chunk_size=64, normalize=normalize)
    want = dict(JaxExtractor(model, **kw).embed_stream(iter(feats)))
    got = dict(Extractor(model, device="cpu", **kw).embed_stream(iter(feats)))
    _assert_same(got, want, TOL)
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(got["u0"]), 1.0, rtol=1e-5)


@pytest.mark.parametrize("cmvn,vad", [(True, True), (True, False),
                                      (False, True), (False, False)])
def test_device_pipe_matches_jax(model, scp, cmvn, vad):
    want = dict(JaxDevicePipe(model, cmvn=cmvn, vad=vad, **KW)
                .embed_codes_stream(read_codes_scp(scp)))
    dev = DevicePipeExtractor(model, cmvn=cmvn, vad=vad, device="cpu", **KW)
    got = dict(dev.embed_codes_stream(read_codes_scp(scp)))
    assert len(got) == 6
    _assert_same(got, want, PIPE_TOL)
    # and the port's own host path on the decoded features
    host = Extractor(model, device="cpu", **KW)
    feats = [(k, apply_cmvn_vad(m, cmvn, vad)) for k, m in read_mat_scp(scp)]
    _assert_same(got, dict(host.embed_stream(iter(feats))), PIPE_TOL)


def test_host_feature_pipe_matches_jax(scp):
    for _, mat in read_mat_scp(scp):
        for cmvn, vad in ((True, True), (True, False), (False, True)):
            np.testing.assert_allclose(apply_cmvn_vad(mat, cmvn, vad),
                                       jax_apply_cmvn_vad(mat, cmvn, vad),
                                       rtol=1e-4, atol=1e-4)


def test_device_pipe_skips_and_long_guard(model, scp, tmp_path):
    dev = DevicePipeExtractor(model, device="cpu", chunk_size=50, **KW)
    with pytest.raises(ValueError, match="route long utterances"):
        list(dev.embed_codes_stream(read_codes_scp(scp)))
    ark, sscp = str(tmp_path / "sil.ark"), str(tmp_path / "sil.scp")
    w = ArkScpWriter("ark,scp:%s,%s" % (ark, sscp), kind="mat")
    f = np.random.RandomState(0).randn(80, D).astype(np.float32)
    f[:, 0] = -20.0  # all silence: skipped by the length check after the pipe
    w.write("sil", f, compress=True)
    w.close()
    dev = DevicePipeExtractor(model, device="cpu", **KW)
    assert list(dev.embed_codes_stream(read_codes_scp(sscp))) == []


def test_server_batches_and_matches_direct(model):
    server = EmbeddingServer(model, batch_size=4, max_wait_ms=50.0, device="cpu")
    addr = server.start_background()
    try:
        rng = np.random.RandomState(0)
        feats = [rng.randn(60 + 10 * i, D).astype(np.float32) for i in range(6)]
        results = [None] * len(feats)

        def client(i):
            results[i] = embed_remote(addr, feats[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(feats))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        for i, f in enumerate(feats):
            assert results[i] is not None, "client %d got no reply" % i
            np.testing.assert_allclose(results[i], server.extractor.embed_utterance(f), **TOL)
    finally:
        server.shutdown()


def test_server_rejects_short_utterance_and_keeps_serving(model):
    server = EmbeddingServer(model, batch_size=2, max_wait_ms=10.0, device="cpu")
    addr = server.start_background()
    try:
        rng = np.random.RandomState(1)
        with pytest.raises(ValueError, match="could not embed"):
            embed_remote(addr, rng.randn(5, D).astype(np.float32))
        emb = embed_remote(addr, rng.randn(80, D).astype(np.float32))
        assert emb.shape == (16,) and np.isfinite(emb).all()
    finally:
        server.shutdown()


def test_cli_extract_end_to_end(model, scp, tmp_path):
    # the scp plus one utterance longer than chunk_size (host fallback)
    long_ark, long_scp = str(tmp_path / "long.ark"), str(tmp_path / "long.scp")
    w = ArkScpWriter("ark,scp:%s,%s" % (long_ark, long_scp), kind="mat")
    f_long = np.random.RandomState(11).randn(300, D).astype(np.float32)
    f_long[:, 0] = 20.0
    w.write("uttlong", f_long, compress=True)
    w.close()
    both = str(tmp_path / "all.scp")
    with open(both, "w") as f:
        f.write(open(scp).read() + open(long_scp).read())

    flags = ["--cmvn", "--vad", "--min-chunk-size", "10", "--chunk-size", "200",
             "--batch-size", "4"]

    def out(name):
        return "ark,scp:%s.ark,%s.scp" % (tmp_path / name, tmp_path / name)

    assert jax_extract_main(flags + [model, "scp:" + both, out("jax")]) == 0
    assert extract_main(flags + ["--device", "cpu", model, "scp:" + both, out("host")]) == 0
    assert extract_main(["--device-pipe"] + flags + ["--device", "cpu", model,
                        "scp:" + both, out("dev")]) == 0
    want = dict(read_vec_flt_scp(str(tmp_path / "jax.scp")))
    assert "uttlong" in want and len(want) == 7
    _assert_same(dict(read_vec_flt_scp(str(tmp_path / "host.scp"))), want, PIPE_TOL)
    _assert_same(dict(read_vec_flt_scp(str(tmp_path / "dev.scp"))), want, PIPE_TOL)
    with pytest.raises(SystemExit, match="not ported"):
        extract_main(["--exact-long", model, "scp:" + both, out("x")])
