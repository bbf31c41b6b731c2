"""The port's ECAPA-TDNN and ResNet34 against the JAX package on the CPU:
every endpoint in eval mode (with and without a mask) and in train mode
with the BatchNorm statistics' update; the parameters' gradients against
``jax.grad``; a padded, masked eval forward against the unpadded one; and a
JAX -> port -> JAX round trip of the variables, bit-equal (the 2-D conv
kernels included). ResNet34 runs with statistics pooling (two-pass and
``use_fused_pooling``) and with self-attention over ``resnet_frames``.

Small widths (ECAPA 16 channels, scale 4; ResNet base 4, one block a
stage); the JAX variables are numpy draws into ``jax.eval_shape``'s tree.
Tolerances: rtol 1e-4 / atol 1e-5 in eval mode and for gradients, atol 1e-4
in train mode (BatchNorms over 3 rows), 1e-5 for padded against unpadded
(the two shapes take different conv blockings)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu_torch import convert
from tf_kaldi_speaker_tpu_torch.models.tdnn import EntireNetwork
from test_torch_zoo_pooling import (TOL, TRAIN_TOL, assert_endpoints, assert_trees, inputs,
                                    jax_network)

torch.set_num_threads(1)

D = 20
ECAPA = dict(network_type="ecapa_tdnn", ecapa_channels=16, ecapa_mfa_channels=24,
             ecapa_res2net_scale=4, ecapa_se_bottleneck=8, ecapa_att_bottleneck=8,
             ecapa_embedding_dim=12, pooling_type="statistics_pooling",
             embedding_node="ecapa_embedding", batchnorm_momentum=0.9)
RESNET = dict(network_type="resnet34", resnet_base_channels=4, resnet_layers=[1, 1, 1, 1],
              resnet_embedding_dim=12, pooling_type="statistics_pooling",
              embedding_node="resnet_embedding", batchnorm_momentum=0.9)
CASES = {
    "ecapa": ECAPA,
    "resnet": RESNET,
    "resnet_fused": dict(RESNET, use_fused_pooling=True),
    "resnet_attention": dict(RESNET, resnet_layers=[2, 1], pooling_type="self_attention",
                             att_key_input="resnet_frames", att_key_num_nodes=[8],
                             att_key_network_type=3, att_value_input="resnet_frames",
                             att_num_heads=2, att_split_key=True, att_use_scale=True,
                             att_penalty_term=0.1),
}


def _net(cfg, variables):
    return convert.network_from_variables(variables, cfg, cfg["network_type"], input_dim=D)


@pytest.mark.parametrize("name", sorted(CASES))
def test_network_eval_and_train_match_jax(name):
    cfg = CASES[name]
    jnet, variables = jax_network(cfg)
    feats, mask = inputs()
    net = _net(cfg, variables)
    for m in (mask, None):
        _, want = jnet.apply(variables, jnp.asarray(feats), False,
                             mask=None if m is None else jnp.asarray(m))
        with torch.no_grad():
            _, got = net(torch.from_numpy(feats), None if m is None else torch.from_numpy(m))
        assert_endpoints(got, want)
    assert cfg["embedding_node"] in got
    (_, want), updates = jnet.apply(variables, jnp.asarray(feats), True, mask=jnp.asarray(mask),
                                    mutable=["batch_stats"])
    net.train()
    with torch.no_grad():
        _, got = net(torch.from_numpy(feats), torch.from_numpy(mask))
    assert_endpoints(got, want, TRAIN_TOL)
    assert_trees({"batch_stats": convert.variables_of(net)["batch_stats"]},
                 {"batch_stats": jax.device_get(updates["batch_stats"])})


@pytest.mark.parametrize("name", ["ecapa", "resnet"])
def test_network_gradients_match_jax(name):
    """d(sum(embedding * r))/d every parameter, masked, eval mode (train
    steps are held against the JAX Trainer in test_torch_zoo_train.py)."""
    cfg = CASES[name]
    jnet, variables = jax_network(cfg, seed=1)
    feats, mask = inputs(1)
    r = np.random.RandomState(2).randn(3, 12).astype(np.float32)

    def f(params):
        out, _ = jnet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(feats), False, mask=jnp.asarray(mask))
        return jnp.sum(out * r)

    want = jax.jit(jax.grad(f))(variables["params"])
    net = _net(cfg, variables)
    out, _ = net(torch.from_numpy(feats), torch.from_numpy(mask))
    named = dict(net.named_parameters())
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(r)), list(named.values()))
    got, want = convert.tree_from_named(zip(named, grads))["params"], jax.device_get(want)
    # the attention scores' bias shifts every frame of a channel alike, and
    # the softmax over time takes it out: its gradient is rounding noise
    if name == "ecapa":
        for tree in (got, want):
            del tree["ecapa"]["asp"]["att_scores"]["bias"]
    assert_trees(got, want, tol=TOL)


@pytest.mark.parametrize("name", ["ecapa", "resnet_fused"])
def test_padded_eval_equals_unpadded(name):
    """A padded, masked eval forward equals each utterance's unpadded one
    (the invariant the bucketed extractor relies on), at odd lengths that
    exercise the stride-2 frame centring."""
    cfg = CASES[name]
    _, variables = jax_network(cfg, seed=3)
    net = _net(cfg, variables)
    rng = np.random.RandomState(4)
    lengths = (53, 37, 30)
    feats = np.zeros((3, 72, D), np.float32)
    mask = np.zeros((3, 72), np.float32)
    with torch.no_grad():
        for i, n in enumerate(lengths):
            x = rng.randn(n, D).astype(np.float32)
            feats[i, :n], mask[i, :n] = x, 1.0
        padded, _ = net(torch.from_numpy(feats), torch.from_numpy(mask))
        for i, n in enumerate(lengths):
            alone, _ = net(torch.from_numpy(feats[i:i + 1, :n]))
            np.testing.assert_allclose(padded[i].numpy(), alone[0].numpy(), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_port_jax_round_trip_is_bit_equal(name):
    cfg = CASES[name]
    _, variables = jax_network(cfg, seed=5)
    back = convert.flatten(convert.variables_from_network(_net(cfg, variables)))
    want = convert.flatten(variables)
    assert sorted(back) == sorted(want)
    for path, v in want.items():
        assert back[path].dtype == torch.float32 and np.array_equal(back[path].numpy(), v), path
    if cfg["network_type"] == "resnet34":
        # a non-square stand-in would hide a transposed 3x3: check the axes
        k = want[("params", "resnet", "stem", "kernel")]
        net = _net(cfg, variables)
        assert k.shape == (3, 3, 1, 4)
        np.testing.assert_array_equal(net.resnet.stem.weight.detach().numpy()[:, 0],
                                      np.transpose(k[:, :, 0, :], (2, 0, 1)))


def test_generator_init_and_refusals():
    """Same generator seed, same variables; the layouts a module builds;
    unknown networks and poolings raise; ResNet34 needs the feature dim."""
    for cfg in (ECAPA, RESNET):
        a = EntireNetwork(cfg, D, cfg["network_type"], torch.Generator().manual_seed(0))
        b = EntireNetwork(cfg, D, cfg["network_type"], torch.Generator().manual_seed(0))
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
    tree = convert.variables_from_network(a)
    assert tree["params"]["resnet"]["stage2_block0"]["conv1"]["kernel"].shape == (3, 3, 4, 8)
    assert tree["params"]["resnet"]["stage2_block0"]["proj"]["kernel"].shape == (1, 1, 4, 8)
    # 20 -> 10 -> 5 -> 3 frequency bins of 32 channels, mean || std
    assert tree["params"]["resnet"]["embedding"]["kernel"].shape == (2 * 3 * 32, 12)
    assert a.resnet.stage1_block0.bn1.epsilon == 1e-5
    with pytest.raises(NotImplementedError, match="Not implement"):
        EntireNetwork(ECAPA, D, "no_such_network")
    with pytest.raises(NotImplementedError, match="Not implement"):
        EntireNetwork(dict(RESNET, pooling_type="no_such_pooling"), D, "resnet34")
    with pytest.raises(ValueError, match="input_dim"):
        convert.network_from_variables(tree, RESNET, "resnet34")


@pytest.mark.parametrize("name", ["ecapa", "resnet_fused", "resnet_attention"])
def test_zoo_model_dir_extracts_and_serves(name, tmp_path):
    """A model dir of each zoo network (the port's .pt checkpoint) through
    cli.extract and the embedding server on the CPU, against a direct
    forward of the same variables on each utterance unpadded."""
    import json
    import threading

    from tf_kaldi_speaker_tpu_torch.cli.extract import main as extract_main
    from tf_kaldi_speaker_tpu_torch.extract.server import EmbeddingServer, embed_remote
    from tf_kaldi_speaker_tpu_torch.kio import ArkScpWriter, read_vec_flt_scp
    from tf_kaldi_speaker_tpu_torch.train.checkpoints import save_checkpoint

    cfg = CASES[name]
    _, variables = jax_network(cfg, seed=6)
    net = _net(cfg, variables)
    nnet = tmp_path / "m" / "nnet"
    tree = convert.variables_from_network(net)  # tensors, as .pt files hold them
    save_checkpoint(str(nnet), {"params": {"network": tree["params"]},
                                "batch_stats": {"network": tree["batch_stats"]}}, 0)
    (nnet / "config.json").write_text(json.dumps(cfg))
    (nnet / "feature_dim").write_text("%d\n" % D)
    rng = np.random.RandomState(7)
    feats = {"u%d" % i: rng.randn(n, D).astype(np.float32) for i, n in enumerate((45, 70, 33))}
    w = ArkScpWriter("ark,scp:%s,%s" % (tmp_path / "f.ark", tmp_path / "f.scp"), kind="mat")
    for k, f in feats.items():
        w.write(k, f)
    w.close()
    with torch.no_grad():
        want = {k: net(torch.from_numpy(f)[None])[1][cfg["embedding_node"]][0].numpy()
                for k, f in feats.items()}
    out = "ark,scp:%s,%s" % (tmp_path / "x.ark", tmp_path / "x.scp")
    assert extract_main(["--device", "cpu", "--min-chunk-size", "10", "--batch-size", "2",
                         str(tmp_path / "m"), "scp:%s" % (tmp_path / "f.scp"), out]) == 0
    got = dict(read_vec_flt_scp(str(tmp_path / "x.scp")))
    assert sorted(got) == sorted(want)
    server = EmbeddingServer(str(tmp_path / "m"), batch_size=2, max_wait_ms=20.0, device="cpu")
    addr = server.start_background()
    replies = {}
    try:
        threads = [threading.Thread(target=lambda k=k: replies.__setitem__(
            k, embed_remote(addr, feats[k]))) for k in feats]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        server.shutdown()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
        np.testing.assert_allclose(replies[k], want[k], err_msg=k, **TOL)
