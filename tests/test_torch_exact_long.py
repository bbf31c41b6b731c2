"""The port's exact long-utterance extraction (``Extractor.embed_long_exact``,
``cli.extract --exact-long``) against the JAX package's and against the
port's own whole-utterance forward, on a model dir written by the JAX
Trainer. Tolerances: against JAX rtol 1e-4 / atol 1e-5 (both sum float32
chunks and accumulate in float64); against the whole forward rtol 5e-3 /
atol 5e-4, the JAX test's (``tests/test_exact_long.py``)."""

import json
import os

import numpy as np
import pytest
import torch

from test_device_pipe import D, _make_model
from tf_kaldi_speaker_tpu.cli.extract import main as jax_extract_main
from tf_kaldi_speaker_tpu.extract.extractor import Extractor as JaxExtractor
from tf_kaldi_speaker_tpu_torch.cli.extract import main as extract_main
from tf_kaldi_speaker_tpu_torch.convert import variables_from_network
from tf_kaldi_speaker_tpu_torch.extract.extractor import Extractor
from tf_kaldi_speaker_tpu_torch.kio import ArkScpWriter, read_vec_flt_scp
from tf_kaldi_speaker_tpu_torch.models.tdnn import EntireNetwork
from tf_kaldi_speaker_tpu_torch.train.checkpoints import save_checkpoint

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
FULL_TOL = dict(rtol=5e-3, atol=5e-4)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return _make_model(tmp_path_factory.mktemp("exact_long"))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("frames", [700, 584])
def test_exact_long_matches_jax_and_full_forward(model, normalize, frames):
    """Chunks of 128 frames that overlap by the TDNN's 14: 700 frames end
    in a trailing piece padded to a bucket, 584 (128 + 4 x 114) in full
    chunks only."""
    feat = np.random.RandomState(frames).randn(frames, D).astype(np.float32)
    kw = dict(min_chunk_size=20, chunk_size=5000, batch_size=2, normalize=normalize)
    port = Extractor(model, device="cpu", **kw)
    full = port.embed_utterance(feat)
    port.chunk_size = 128
    exact = port.embed_long_exact(feat)
    jax_ex = JaxExtractor(model, **kw)
    jax_ex.chunk_size = 128
    np.testing.assert_allclose(exact, jax_ex.embed_long_exact(feat), **TOL)
    np.testing.assert_allclose(exact, full, **FULL_TOL)
    assert exact.dtype == np.float32 and exact.shape == full.shape


def test_exact_long_refuses_other_networks(model, tmp_path):
    port = Extractor(model, device="cpu", min_chunk_size=10, chunk_size=64)
    with pytest.raises(ValueError, match="too short"):
        port.embed_long_exact(np.zeros((14, D), np.float32))
    with open(os.path.join(model, "nnet", "config.json")) as f:
        tdnn_cfg = json.load(f)
    others = {
        "ecapa": dict(network_type="ecapa_tdnn", ecapa_channels=8, ecapa_mfa_channels=8,
                      ecapa_res2net_scale=2, ecapa_se_bottleneck=4, ecapa_att_bottleneck=4,
                      ecapa_embedding_dim=6, pooling_type="statistics_pooling",
                      embedding_node="ecapa_embedding"),
        "attention": dict(tdnn_cfg, pooling_type="self_attention", att_key_input="tdnn4_relu",
                          att_key_num_nodes=[4], att_key_network_type=0,
                          att_value_input="tdnn5_relu", att_num_heads=1),
    }
    for name, cfg in others.items():
        nnet = tmp_path / name / "nnet"
        net = EntireNetwork(cfg, D, cfg["network_type"])
        v = variables_from_network(net)
        save_checkpoint(str(nnet), {"params": {"network": v["params"]},
                                    "batch_stats": {"network": v["batch_stats"]}}, 0)
        (nnet / "config.json").write_text(json.dumps(cfg))
        (nnet / "feature_dim").write_text("%d\n" % D)
        ex = Extractor(str(tmp_path / name), device="cpu", min_chunk_size=10, chunk_size=64)
        match = "TDNN network" if name == "ecapa" else "statistics pooling"
        with pytest.raises(ValueError, match=match):
            ex.embed_long_exact(np.zeros((100, D), np.float32))
        assert ex.embed_utterance(np.zeros((50, D), np.float32)).shape == (net.output_dim,)


def test_cli_exact_long_matches_jax(model, tmp_path):
    """``--exact-long`` on the host path: utterances over --chunk-size take
    the exact path, the rest the batched one, as the JAX CLI routes them."""
    ark, scp = str(tmp_path / "f.ark"), str(tmp_path / "f.scp")
    w = ArkScpWriter("ark,scp:%s,%s" % (ark, scp), kind="mat")
    rng = np.random.RandomState(5)
    for i, n in enumerate((300, 90, 410)):
        w.write("u%d" % i, rng.randn(n, D).astype(np.float32))
    w.close()
    flags = ["--exact-long", "--chunk-size", "200", "--min-chunk-size", "10", "--batch-size", "2"]

    def out(name):
        return "ark,scp:%s.ark,%s.scp" % (tmp_path / name, tmp_path / name)

    assert jax_extract_main(flags + [model, "scp:" + scp, out("jax")]) == 0
    assert extract_main(flags + ["--device", "cpu", model, "scp:" + scp, out("port")]) == 0
    want = dict(read_vec_flt_scp(str(tmp_path / "jax.scp")))
    got = dict(read_vec_flt_scp(str(tmp_path / "port.scp")))
    assert sorted(got) == sorted(want) == ["u0", "u1", "u2"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
