"""Port TDNN against the JAX EntireNetwork: the same variables (with
perturbed BatchNorm statistics and affine parameters, so no layer is the
identity) converted by ``convert.py`` must give every endpoint in eval mode,
float32, with and without a mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu.models import EntireNetwork as JaxEntireNetwork
from tf_kaldi_speaker_tpu_torch.convert import network_from_variables, variables_from_network
from tf_kaldi_speaker_tpu_torch.models.tdnn import EntireNetwork

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
D = 20
TINY = dict(
    network_type="tdnn", tdnn_layer_size=16, num_nodes_pooling_layer=32,
    num_nodes_last_layer=16, pooling_type="statistics_pooling",
    embedding_node="tdnn6_dense",
)


def _jax_variables(cfg, seed=0, b=3, l=40):
    net = JaxEntireNetwork(config=cfg)
    variables = net.init(jax.random.PRNGKey(seed), jnp.zeros((b, l, D)), False)
    rng = np.random.RandomState(seed + 1)

    def perturb(path, v):
        leaf = path[-1].key
        v = np.asarray(v)
        if leaf == "mean":
            return v + rng.randn(*v.shape).astype(np.float32) * 0.3
        if leaf == "var":
            return rng.uniform(0.3, 3.0, v.shape).astype(np.float32)
        if leaf in ("scale", "alpha"):
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32) * (
                0.1 if leaf == "alpha" else 1.0)
        if leaf == "bias":
            return rng.randn(*v.shape).astype(np.float32) * 0.2
        return v

    variables = jax.tree_util.tree_map_with_path(perturb, jax.device_get(variables))
    return net, variables


def _inputs(seed=0, b=3, l=40):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, l, D).astype(np.float32)
    lengths = np.array([l, l - 9, 20])[:b]
    mask = (np.arange(l)[None, :] < lengths[:, None]).astype(np.float32)
    return feats, mask


def _compare(cfg, masked, seed=0):
    jnet, variables = _jax_variables(cfg, seed)
    feats, mask = _inputs(seed)
    m = mask if masked else None
    _, want = jnet.apply(variables, jnp.asarray(feats), False,
                         mask=None if m is None else jnp.asarray(m))
    net = network_from_variables(variables, cfg)
    with torch.no_grad():
        _, got = net(torch.from_numpy(feats), None if m is None else torch.from_numpy(m))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   err_msg=name, **TOL)
    return got


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("relu", ["relu", "prelu", "lrelu"])
@pytest.mark.parametrize("masked", [False, True])
def test_every_endpoint_matches_jax(relu, fused, masked):
    cfg = dict(TINY, network_relu_type=relu, use_fused_pooling=fused)
    got = _compare(cfg, masked)
    assert {"tdnn1_conv", "tdnn3_relu", "pooling", "tdnn7_bn", "output"} <= set(got)


@pytest.mark.parametrize("variant", [
    dict(last_layer_linear=True),
    dict(last_layer_no_bn=True),
    dict(feature_norm=True, feature_scaling_factor=5.0),
])
def test_last_layer_variants_match_jax(variant):
    got = _compare(dict(TINY, use_fused_pooling=True, **variant), masked=True, seed=3)
    if "last_layer_linear" in variant:
        assert "tdnn7_relu" not in got
    if "last_layer_no_bn" in variant:
        assert "tdnn7_bn" not in got


def test_roundtrip_and_generator_init():
    cfg = dict(TINY, network_relu_type="prelu")
    a = EntireNetwork(cfg, D, generator=torch.Generator().manual_seed(0))
    b = EntireNetwork(cfg, D, generator=torch.Generator().manual_seed(0))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    tree = variables_from_network(a)
    assert tree["params"]["tdnn"]["tdnn1_conv"]["kernel"].shape == (5, D, 16)
    assert tree["params"]["tdnn"]["tdnn6_dense"]["kernel"].shape == (64, 16)
    assert tree["batch_stats"]["tdnn"]["tdnn1_bn"]["var"].shape == (16,)
    c = network_from_variables(tree, cfg)
    for k, v in a.state_dict().items():
        assert torch.equal(v, c.state_dict()[k]), k
    # glorot-uniform limit sqrt(6 / (fan_in + fan_out)), fans x kernel width
    w = a.tdnn.tdnn1_conv.weight
    assert float(w.detach().abs().max()) <= np.sqrt(6.0 / (5 * D + 5 * 16))
    assert float(a.tdnn.tdnn4_dense.bias.detach().abs().max()) == 0.0


def test_converter_rejects_unconsumed_and_misshapen_arrays():
    _, variables = _jax_variables(TINY)
    extra = jax.tree_util.tree_map(lambda v: v, variables)
    extra["params"]["tdnn"]["tdnn9_dense"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="not consumed.*tdnn9_dense"):
        network_from_variables(extra, TINY)
    # a prelu tree into a relu network leaves the alphas unconsumed
    _, prelu = _jax_variables(dict(TINY, network_relu_type="prelu"))
    with pytest.raises(ValueError, match="tdnn1_prelu/alpha"):
        network_from_variables(prelu, TINY)
    bad = jax.tree_util.tree_map(lambda v: v, variables)
    bad["params"]["tdnn"]["tdnn4_dense"]["kernel"] = np.zeros((16, 17), np.float32)
    with pytest.raises(ValueError, match="shape"):
        network_from_variables(bad, TINY)
    missing = jax.tree_util.tree_map(lambda v: v, variables)
    del missing["batch_stats"]["tdnn"]["tdnn2_bn"]
    with pytest.raises(KeyError, match="tdnn2_bn/mean"):
        network_from_variables(missing, TINY)


def test_unported_network_and_train_mode_raise():
    """Unknown networks and poolings raise, as the JAX package's do (the
    zoo's are ported, tests/test_torch_zoo_*.py); train mode, ported with
    the trainer, runs and moves the BatchNorm statistics (its parity with
    flax is in test_torch_train.py)."""
    with pytest.raises(NotImplementedError, match="Not implement"):
        EntireNetwork(TINY, D, network_type="no_such_network")
    with pytest.raises(NotImplementedError, match="Not implement"):
        EntireNetwork(dict(TINY, pooling_type="no_such_pooling"), D)
    net = EntireNetwork(TINY, D).train()
    out, _ = net(torch.randn(2, 30, D, generator=torch.Generator().manual_seed(0)))
    assert torch.isfinite(out).all()
    assert not torch.equal(net.tdnn.tdnn1_bn.mean, torch.zeros_like(net.tdnn.tdnn1_bn.mean))


def test_flagship_width_matches_jax():
    """The full-width flagship network (30-dim input, 512-wide convs, 1500-d
    pooling layer) in float32, as chip_smoke.py drives it on the card."""
    import __graft_entry__
    import chip_smoke

    assert chip_smoke.FLAGSHIP == dict(__graft_entry__.FLAGSHIP, use_fused_pooling=True)
    cfg = dict(chip_smoke.FLAGSHIP, compute_dtype="float32")
    jnet = JaxEntireNetwork(config=cfg)
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 40, 30).astype(np.float32)
    mask = np.ones((2, 40), np.float32)
    mask[1, 31:] = 0.0
    variables = jax.device_get(jnet.init(jax.random.PRNGKey(0), jnp.asarray(feats), False))
    _, want = jnet.apply(variables, jnp.asarray(feats), False, mask=jnp.asarray(mask))
    net = network_from_variables(variables, cfg)
    with torch.no_grad():
        _, got = net(torch.from_numpy(feats), torch.from_numpy(mask))
    assert got["tdnn6_dense"].shape == (2, 512) and got["pooling"].shape == (2, 3000)
    for name in ("tdnn3_relu", "tdnn5_relu", "pooling", "tdnn6_dense", "output"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   err_msg=name, **TOL)
