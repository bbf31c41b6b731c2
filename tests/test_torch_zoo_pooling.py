"""The port's self-attention and GhostVLAD poolings against the JAX package
on the CPU: every endpoint of a TDNN with each pooling, in eval mode (with
and without a mask) and in train mode with the BatchNorm statistics'
update, over the key network types 0-3, split and shared keys, value
stacks, the post-pooling nonlinearity, ghosts and the final L2 norm; the
parameters' gradients against ``jax.grad``; and the real-TF goldens
(``golden_att.npz``, ``golden_vlad.npz``) through the JAX package's
``import_reference_checkpoint`` and the port's converter.

The JAX variables are drawn with numpy into ``jax.eval_shape``'s tree (no
JAX init runs), so both sides start from the same arrays. Tolerances:
rtol 1e-4 / atol 1e-5 against JAX in eval mode, atol 1e-4 in train mode,
rtol/atol 1e-4 against TF (as ``tests/test_tf_golden.py:203-226``)."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu.models import EntireNetwork as JaxEntireNetwork
from tf_kaldi_speaker_tpu_torch import convert
from tf_kaldi_speaker_tpu_torch.models.tdnn import EntireNetwork

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "data", "tf_golden")
TOL = dict(rtol=1e-4, atol=1e-5)
# train mode: the utterance-level BatchNorms normalize over the batch's 3
# rows, which scales float32 rounding by up to 1 / (their stddev)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)
D = 20
BASE = dict(network_type="tdnn", tdnn_layer_size=16, num_nodes_pooling_layer=24,
            num_nodes_last_layer=12, embedding_node="tdnn6_dense", batchnorm_momentum=0.9)
ATT = dict(BASE, pooling_type="self_attention", att_key_input="tdnn4_relu",
           att_value_input="tdnn5_relu", att_value_num_nodes=[], att_value_network_type=0,
           att_use_scale=True, att_apply_nonlinear=False, att_penalty_term=0.5)
VLAD = dict(BASE, pooling_type="ghost_vlad", vlad_num_centers=5, vlad_key_input="tdnn4_relu",
            vlad_value_input="tdnn5_relu")

ATT_CASES = {
    # the att config of recipes/voxceleb/v1: a 1-wide key through type 0
    "type0_one_head": dict(att_key_num_nodes=[8, 1], att_key_network_type=0, att_num_heads=1),
    "type1_split_value_stack_post_prelu": dict(
        att_key_num_nodes=[8], att_key_network_type=1, att_num_heads=2, att_split_key=True,
        att_value_num_nodes=[20], att_value_network_type=1, att_apply_nonlinear=True,
        network_relu_type="prelu"),
    "type2_four_heads_no_scale_post_relu": dict(
        att_key_num_nodes=[12, 8], att_key_network_type=2, att_num_heads=4,
        att_value_num_nodes=[16, 24], att_value_network_type=2, att_use_scale=False,
        att_apply_nonlinear=True),
    "type3_split_tdnn5_key": dict(
        att_key_input="tdnn5_relu", att_key_num_nodes=[24, 16], att_key_network_type=3,
        att_num_heads=4, att_split_key=True),
}
VLAD_CASES = {
    "ghosts_final_l2": dict(vlad_num_ghosts=2, vlad_key_num_nodes=[16],
                            vlad_value_num_nodes=[20], vlad_final_l2_norm=True),
    "netvlad_lrelu": dict(vlad_num_ghosts=0, vlad_value_num_nodes=[12, 8],
                          network_relu_type="lrelu"),
}
CASES = [(k, dict(ATT, **v)) for k, v in ATT_CASES.items()] + [
    (k, dict(VLAD, **v)) for k, v in VLAD_CASES.items()]


def fill_variables(shapes, seed):
    """numpy draws for a JAX variable tree of ShapeDtypeStructs: kernels
    and centers glorot-uniform, every bias, BatchNorm statistic and scale,
    PReLU alpha and query perturbed, so no layer is the identity."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        leaf, shape = path[-1].key, s.shape
        if leaf in ("kernel", "vlad_centers", "output_kernel"):
            fan = shape[-2] * int(np.prod(shape[:-2])) + shape[-1] * int(np.prod(shape[:-2]))
            lim = np.sqrt(6.0 / fan)
            v = rng.uniform(-lim, lim, shape)
        elif leaf == "mean":
            v = rng.randn(*shape) * 0.3
        elif leaf == "var":
            v = rng.uniform(0.3, 3.0, shape)
        elif leaf == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "alpha":
            v = rng.uniform(0.05, 0.15, shape)
        elif leaf == "ring_r":
            v = rng.uniform(1.0, 3.0, shape)
        else:  # bias, query
            v = rng.randn(*shape) * 0.2
        return np.asarray(v, s.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_network(cfg, seed=0, b=3, l=40, dim=D):
    net = JaxEntireNetwork(config=cfg, network_type=cfg["network_type"])
    shapes = jax.eval_shape(lambda k, x: net.init(k, x, False), jax.random.PRNGKey(0),
                            jnp.zeros((b, l, dim)))
    return net, fill_variables(shapes, seed)


def inputs(seed=0, b=3, l=40, dim=D, lengths=(40, 31, 22)):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, l, dim).astype(np.float32)
    mask = (np.arange(l)[None, :] < np.array(lengths)[:b, None]).astype(np.float32)
    return feats, mask


def assert_endpoints(got, want, tol=TOL, skip=()):
    assert set(got) == set(want), set(got) ^ set(want)
    for name in want:
        if name in skip:
            continue
        g = got[name]
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(want[name]), err_msg=name, **tol)


def bn_follows(path, flat):
    """Whether ``path`` is the bias of an affine layer that a BatchNorm
    follows: its gradient is zero in exact arithmetic (the BatchNorm takes
    the batch mean out), so both frameworks hold rounding noise there."""
    if path[-1] != "bias":
        return False
    *parent, layer = path[:-1]
    if layer == "affine":  # a DenseBlock's
        return tuple(parent) + ("bn", "scale") in flat
    for kind in ("_conv", "_dense"):
        if layer.endswith(kind):
            return tuple(parent) + (layer[:-len(kind)] + "_bn", "scale") in flat
    return False


def assert_trees(got, want, tol=TOL, skip_zero_grads=False):
    got, want = convert.flatten(got), convert.flatten(want)
    assert sorted(got) == sorted(want), set(got) ^ set(want)
    for path in want:
        if skip_zero_grads and bn_follows(path, want):
            continue
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(want[path]),
                                   err_msg="/".join(path), **tol)


@pytest.mark.parametrize("name,cfg", CASES, ids=[c[0] for c in CASES])
def test_pooling_eval_and_train_match_jax(name, cfg):
    jnet, variables = jax_network(cfg)
    feats, mask = inputs()
    net = convert.network_from_variables(variables, cfg)
    for m in (mask, None):
        _, want = jnet.apply(variables, jnp.asarray(feats), False,
                             mask=None if m is None else jnp.asarray(m))
        with torch.no_grad():
            _, got = net(torch.from_numpy(feats), None if m is None else torch.from_numpy(m))
        assert_endpoints(got, want)
    assert ("attention_weights" in got) == (cfg["pooling_type"] == "self_attention")
    # train mode: batch statistics, and the running statistics' update
    (_, want), updates = jnet.apply(variables, jnp.asarray(feats), True, mask=jnp.asarray(mask),
                                    mutable=["batch_stats"])
    net.train()
    with torch.no_grad():
        _, got = net(torch.from_numpy(feats), torch.from_numpy(mask))
    assert_endpoints(got, want, TRAIN_TOL)
    assert_trees({"batch_stats": convert.variables_of(net)["batch_stats"]},
                 {"batch_stats": jax.device_get(updates["batch_stats"])})


@pytest.mark.parametrize("name,cfg", [CASES[1], CASES[4]], ids=[CASES[1][0], CASES[4][0]])
def test_pooling_gradients_match_jax(name, cfg):
    """d(sum(output * r) + penalty)/d every parameter, masked, in eval mode:
    in train mode the BatchNorms normalize over the batch's 3 rows, and a
    value that rounding puts on either side of a (P)ReLU's kink changes
    every gradient upstream of it (train-mode steps are held against the
    JAX step in tests/test_torch_zoo_train.py)."""
    jnet, variables = jax_network(cfg, seed=1)
    feats, mask = inputs(1)
    r = np.random.RandomState(2).randn(3, 12).astype(np.float32)

    def f(params):
        out, ep = jnet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             jnp.asarray(feats), False, mask=jnp.asarray(mask))
        return jnp.sum(out * r) + ep.get("attention_penalty", 0.0)

    want = jax.jit(jax.grad(f))(variables["params"])
    net = convert.network_from_variables(variables, cfg)
    out, ep = net(torch.from_numpy(feats), torch.from_numpy(mask))
    total = torch.sum(out * torch.from_numpy(r)) + ep.get("attention_penalty", 0.0)
    named = dict(net.named_parameters())
    grads = torch.autograd.grad(total, list(named.values()))
    got = convert.tree_from_named(zip(named, grads))["params"]
    assert_trees(got, jax.device_get(want), tol=dict(rtol=1e-4, atol=1e-6),
                 skip_zero_grads=True)


# ---------------------------------------------------------------- TF goldens

GOLD_BASE = dict(
    seed=0, network_type="tdnn", tdnn_layer_size=32, num_nodes_pooling_layer=64,
    num_nodes_last_layer=32, embedding_node="tdnn6_dense", last_layer_linear=True,
    loss_func="additive_margin_softmax", amsoftmax_m=0.2, amsoftmax_lambda_min=0.0,
    amsoftmax_lambda_base=1000.0, amsoftmax_lambda_gamma=1e-4, amsoftmax_lambda_power=5.0,
    batchnorm_momentum=0.95, optimizer="sgd", weight_l2_regularizer=0.0)
GOLD_CFG = {
    "att": dict(GOLD_BASE, pooling_type="self_attention", att_key_input="tdnn4_relu",
                att_key_num_nodes=[24, 16], att_key_network_type=3,
                att_value_input="tdnn5_relu", att_value_num_nodes=[], att_value_network_type=0,
                att_num_heads=4, att_split_key=False, att_use_scale=True,
                att_apply_nonlinear=False, att_penalty_term=0.5),
    "vlad": dict(GOLD_BASE, pooling_type="ghost_vlad", vlad_num_centers=6, vlad_num_ghosts=2,
                 vlad_key_input="tdnn4_relu", vlad_key_num_nodes=[16],
                 vlad_value_input="tdnn5_relu", vlad_value_num_nodes=[20],
                 vlad_final_l2_norm=True),
}
GOLD_TOL = dict(rtol=1e-4, atol=1e-4)


class _State:
    """The two fields of the JAX train state that the importer reads and
    replaces."""

    def __init__(self, params, batch_stats, opt_state=None):
        self.params, self.batch_stats = params, batch_stats

    def replace(self, **kw):
        return _State(kw["params"], kw["batch_stats"])


def import_golden(cfg, prefix, num_speakers=10, dim=20):
    """A TF checkpoint through the JAX package's importer onto the JAX
    XVectorModel's variable tree (shapes from ``jax.eval_shape``, so no
    init runs), as JAX trees of numpy arrays."""
    from tf_kaldi_speaker_tpu.train.tf_import import import_reference_checkpoint
    from tf_kaldi_speaker_tpu.train.trainer import XVectorModel as JaxXVectorModel

    jm = JaxXVectorModel(config=cfg, loss_func=cfg["loss_func"], num_outputs=num_speakers)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((2, 64, dim)), jnp.zeros((2,), jnp.int32),
                                              0, True), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    stub = types.SimpleNamespace(state=_State(tree["params"], tree["batch_stats"]),
                                 tx=types.SimpleNamespace(init=lambda p: None))
    _, skipped = import_reference_checkpoint(prefix, stub)
    assert not skipped, skipped
    return {"params": jax.device_get(stub.state.params),
            "batch_stats": jax.device_get(stub.state.batch_stats)}


@pytest.fixture(scope="module", params=["att", "vlad"])
def golden(request):
    """The TF checkpoint through the JAX importer, then the port's
    converter into an XVectorModel."""
    from tf_kaldi_speaker_tpu_torch.train.trainer import XVectorModel

    kind = request.param
    cfg = GOLD_CFG[kind]
    gold = np.load(os.path.join(GOLD, "golden_%s.npz" % kind))
    variables = import_golden(cfg, os.path.join(GOLD, "model-%s-0" % kind))
    model = XVectorModel(cfg, cfg["loss_func"], 10, 20)
    convert.load_variables(model, variables)
    return kind, model.eval(), gold


def test_pooling_matches_tf_golden(golden):
    kind, model, gold = golden
    feats, labels = torch.from_numpy(gold["features"]), torch.from_numpy(gold["labels"])
    with torch.no_grad():
        loss0, ep = model(feats, labels, 0)
        loss20k, _ = model(feats, labels, 20000)
    names = ["tdnn4_relu", "tdnn5_relu", "pooling", "tdnn6_dense", "tdnn7_bn", "logits",
             "attention_weights" if kind == "att" else "vlad_weights"]
    for name in names:
        np.testing.assert_allclose(ep[name].numpy(), gold[name], err_msg=name, **GOLD_TOL)
    if kind == "att":
        np.testing.assert_allclose(float(ep["attention_penalty"]),
                                   float(gold["attention_penalty"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(loss0), float(gold["loss_step0"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss20k), float(gold["loss_step20000"]),
                               rtol=1e-4, atol=1e-5)


def test_pooling_train_mode_matches_tf_golden(golden):
    kind, model, gold = golden
    feats, labels = torch.from_numpy(gold["features"]), torch.from_numpy(gold["labels"])
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    try:
        with torch.no_grad():
            loss, ep = model(feats, labels, 0)
        np.testing.assert_allclose(float(loss), float(gold["train_loss_step0"]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ep["pooling"].numpy(), gold["train_pooling"], **GOLD_TOL)
        pool = model.network.tdnn.pooling
        bn = (pool.att_key0 if kind == "att" else pool.vlad_value0).bn
        np.testing.assert_allclose(bn.mean.numpy(), gold["updated_pool_moving_mean"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(bn.var.numpy(), gold["updated_pool_moving_variance"],
                                   rtol=1e-4, atol=1e-5)
    finally:
        model.load_state_dict(state)
        model.eval()


def test_pooling_gradient_matches_tf_golden(golden):
    """d(loss + penalty)/d{query | vlad_centers}, eval mode, against TF."""
    kind, model, gold = golden
    feats, labels = torch.from_numpy(gold["features"]), torch.from_numpy(gold["labels"])
    loss, ep = model(feats, labels, 0)
    leaf = "query" if kind == "att" else "vlad_centers"
    param = getattr(model.network.tdnn.pooling, leaf)
    (grad,) = torch.autograd.grad(loss + ep.get("attention_penalty", 0.0), [param])
    np.testing.assert_allclose(grad.numpy(), gold["grad_" + leaf], rtol=1e-4, atol=1e-5)
