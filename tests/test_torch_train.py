"""The port's training slice against the JAX package on the CPU: train-mode
BatchNorm against flax, the pooling backward's plain version against
jax.vjp, the TF golden train steps (momentum and Adam) through the JAX
importer and the port's converter, a 3-step flagship-width float32 loss
trajectory against the JAX Trainer, the bf16 step policy, and the
checkpoints (a .pt round trip, and --cont from a JAX-written msgpack)."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu.ops import pooling_pallas as jpp
from tf_kaldi_speaker_tpu.parallel.mesh import make_mesh
from tf_kaldi_speaker_tpu.train.tf_import import import_reference_checkpoint
from tf_kaldi_speaker_tpu.train.trainer import Trainer as JaxTrainer
from tf_kaldi_speaker_tpu.utils.params import ParamsPlain as JaxParams
from tf_kaldi_speaker_tpu_torch import convert
from tf_kaldi_speaker_tpu_torch.models.layers import BatchNorm
from tf_kaldi_speaker_tpu_torch.ops.pooling import masked_stats_pooling_backward
from tf_kaldi_speaker_tpu_torch.train.trainer import Optimizer, Trainer
from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "data", "tf_golden")
TINY = dict(
    seed=0, network_type="tdnn", tdnn_layer_size=16, num_nodes_pooling_layer=24,
    num_nodes_last_layer=12, pooling_type="statistics_pooling", embedding_node="tdnn6_dense",
    last_layer_linear=True, loss_func="additive_margin_softmax", amsoftmax_m=0.2,
    amsoftmax_lambda_min=0, amsoftmax_lambda_base=1000, amsoftmax_lambda_gamma=1e-4,
    amsoftmax_lambda_power=5, optimizer="momentum", momentum=0.9,
    weight_l2_regularizer=1e-2, batchnorm_momentum=0.99, use_fused_pooling=True)
# TF golden config (test_tf_golden.py:26-44)
GOLD_CFG = dict(
    seed=0, network_type="tdnn", tdnn_layer_size=32, num_nodes_pooling_layer=64,
    num_nodes_last_layer=32, pooling_type="statistics_pooling", embedding_node="tdnn6_dense",
    last_layer_linear=True, loss_func="additive_margin_softmax", amsoftmax_m=0.2,
    amsoftmax_lambda_min=0.0, amsoftmax_lambda_base=1000.0, amsoftmax_lambda_gamma=1e-4,
    amsoftmax_lambda_power=5.0, batchnorm_momentum=0.95, optimizer="sgd",
    weight_l2_regularizer=0.0)


def _mesh1():
    return make_mesh(devices=jax.devices()[:1])


def _jax_trainer(cfg, path, dim, num_speakers):
    t = JaxTrainer(JaxParams(**cfg), str(path), dim=dim, num_speakers=num_speakers,
                   mesh=_mesh1())
    t.build("train", dim, cfg["loss_func"], num_speakers)
    return t


def _jax_variables(state):
    return {"params": jax.device_get(state.params),
            "batch_stats": jax.device_get(state.batch_stats)}


def _port_trainer(cfg, path, dim, num_speakers, variables=None):
    t = Trainer(ParamsPlain(**cfg), str(path), dim=dim, num_speakers=num_speakers,
                device="cpu")
    t.build("train", dim, cfg["loss_func"], num_speakers)
    if variables is not None:
        convert.load_variables(t.network_model, variables)
    return t


def _assert_trees_close(got, want, rtol, atol):
    got, want = convert.flatten(got), convert.flatten(want)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(want[path]),
                                   rtol=rtol, atol=atol, err_msg="/".join(path))


def _zero_grad_bias(path):
    """The bias of an affine layer that a BatchNorm follows: its gradient is
    zero in exact arithmetic (the BatchNorm subtracts the batch mean), so
    both frameworks hold rounding noise there."""
    return path[-1] == "bias" and path[-2].endswith(("_conv", "_dense"))


# ---------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 7, 5), (6, 5)])
def test_batchnorm_train_matches_flax(dtype, shape):
    """Batch statistics in float32 with the fast variance, biased running
    variance, momentum 0.9; float32 exact to rounding, bf16 output to one
    bf16 ulp."""
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3.0 + 2.0).astype(np.float32)
    scale = rng.rand(shape[-1]).astype(np.float32) + 0.5
    bias = rng.randn(shape[-1]).astype(np.float32)
    ra_mean = rng.randn(shape[-1]).astype(np.float32)
    ra_var = rng.rand(shape[-1]).astype(np.float32) + 0.5
    jdt = getattr(jnp, dtype)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-3)
    y, upd = bn.apply(
        {"params": {"scale": jnp.asarray(scale, jdt), "bias": jnp.asarray(bias, jdt)},
         "batch_stats": {"mean": jnp.asarray(ra_mean), "var": jnp.asarray(ra_var)}},
        jnp.asarray(x, jdt), mutable=["batch_stats"])
    tdt = getattr(torch, dtype)
    mod = BatchNorm(shape[-1], momentum=0.9).train()
    with torch.no_grad():
        mod.scale.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        mod.mean.copy_(torch.from_numpy(ra_mean))
        mod.var.copy_(torch.from_numpy(ra_var))
    # parameters in the compute dtype, statistics in float32 (the trainer's policy)
    params = {k: v.to(tdt) for k, v in mod.named_parameters()}
    got = torch.func.functional_call(mod, params, (torch.from_numpy(x).to(tdt),))
    assert got.dtype == tdt and mod.mean.dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-2)
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(y, np.float32), **tol)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(mod, k).float().numpy(),
                                   np.asarray(upd["batch_stats"][k]), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- pooling backward

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pooling_backward_plain_matches_jax_vjp(dtype):
    """The plain backward against jax.vjp of masked_stats_pooling (its custom
    VJP), fed JAX's own forward output; ragged and empty masks, a floored
    column. float32 to rounding; in bf16 JAX runs the whole formula in bf16
    arithmetic (about six roundings of 2^-9), the port in float32 rounded
    once: 2^-5 relative, atol 2^-5 of the largest gradient."""
    rng = np.random.RandomState(3)
    b, l, d = 4, 37, 20
    x = np.maximum(rng.randn(b, l, d) * 2.0 + 1.0, 0.0).astype(np.float32)
    x[1, :, 3] = 0.5  # constant column: floored variance
    lengths = np.array([l, 20, 0, 5])
    mask = (np.arange(l)[None, :] < lengths[:, None]).astype(np.float32)
    g = rng.randn(b, 2 * d).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = jnp.asarray(mask)
    out, vjp = jax.vjp(lambda x: jpp.masked_stats_pooling(x, jm), jnp.asarray(x, jdt))
    (want,) = vjp(jnp.asarray(g, jdt))
    want = np.asarray(want, np.float32)
    got = masked_stats_pooling_backward(
        torch.from_numpy(x).to(tdt), torch.from_numpy(mask),
        torch.from_numpy(np.array(out, np.float32)).to(tdt), torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt and got.shape == (b, l, d)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -5,
                                   atol=2.0 ** -5 * float(np.abs(want).max()))
    assert not got[2].any()  # empty row
    # floored column: the mean's share only, g_mean / n on the valid frames
    np.testing.assert_allclose(got[1, :20, 3], g[1, 3] / 20.0, rtol=2.0 ** -7)
    assert not got[1, 20:, 3].any()


# ---------------------------------------------------------------- TF golden train steps

def _float64(t, cfg):
    """The same trainer computing in float64 (parameters, statistics and
    optimizer state): the algorithm without float32 rounding."""
    t.network_model.double()
    t._params = dict(t.network_model.named_parameters())
    t.optimizer = Optimizer(cfg, list(t._params.values()))
    return t


@pytest.fixture(scope="module")
def golden_variables(tmp_path_factory):
    """A TF golden checkpoint through the JAX importer, as a JAX variable
    tree; each checkpoint imported once per module."""
    cache = {}

    def get(ckpt):
        if ckpt not in cache:
            t = _jax_trainer(GOLD_CFG, tmp_path_factory.mktemp("gold"), 20, 10)
            _, skipped = import_reference_checkpoint(os.path.join(GOLD, ckpt), t)
            assert not skipped, skipped
            cache[ckpt] = _jax_variables(t.state)
        return cache[ckpt]

    return get


@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_tf_golden_train_steps(tmp_path, golden_variables, optimizer):
    """The protocol of test_tf_golden.py:572-634: model-0 through the JAX
    importer, carried into the port by the converter; every step's loss and
    every post-training variable against real TF at the golden test's
    tolerances. The losses are checked in float32 and float64, the variables
    in float64: in float32 the momentum run's second step sits on a ReLU
    kink (a tdnn5_bn pre-activation of 6e-7 in float64 after step 1), and
    which side a float32 run lands on is its rounding's draw; the JAX
    package's lands on TF's, the port's on the other, which moves the
    step-2 gradients by up to 1e-3 (2.9e-5 in tdnn1_conv/kernel at the end)."""
    gold = np.load(os.path.join(GOLD, "golden.npz"))
    if optimizer == "momentum":
        tg = np.load(os.path.join(GOLD, "golden_train.npz"))
        cfg = dict(GOLD_CFG, optimizer="momentum", momentum=float(tg["momentum"]))
        trained = "model-trained-%d" % len(tg["losses"])
    else:
        tg = np.load(os.path.join(GOLD, "golden_train_adam.npz"))
        cfg = dict(GOLD_CFG, optimizer="adam", adam_epsilon=float(tg["adam_epsilon"]))
        trained = "model-trained-adam-%d" % len(tg["losses"])

    v0 = golden_variables("model-0")
    labels = torch.from_numpy(gold["labels"])
    for dtype in (torch.float32, torch.float64):
        t = _port_trainer(cfg, tmp_path / str(dtype), 20, 10, v0)
        if dtype == torch.float64:
            t = _float64(t, cfg)
        feats = torch.from_numpy(gold["features"]).to(dtype)
        for i, want in enumerate(tg["losses"]):
            m = t.train_step(feats, labels, float(tg["lr"]))
            np.testing.assert_allclose(float(m["loss"]), float(want), rtol=1e-4, atol=1e-5,
                                       err_msg="%s step %d" % (dtype, i))
    assert tg["losses"][0] > tg["losses"][-1]  # it actually learns
    atol = 1e-4 if optimizer == "adam" else 1e-5
    _assert_trees_close(convert.variables_of(t.network_model), golden_variables(trained),
                        rtol=1e-4, atol=atol)


# ---------------------------------------------------------------- flagship trajectory

def test_flagship_trajectory_matches_jax(tmp_path):
    """__graft_entry__._trajectory's protocol (:200-231): FLAGSHIP at full
    width in float32 with clipping on, 3 steps on identical batches, from the
    JAX Trainer's initial variables."""
    import __graft_entry__

    cfg = dict(__graft_entry__.FLAGSHIP, compute_dtype="float32", clip_gradient=True,
               clip_gradient_norm=3.0)
    dim, num_speakers = 24, 64
    jt = _jax_trainer(cfg, tmp_path / "jax", dim, num_speakers)
    t = _port_trainer(cfg, tmp_path / "port", dim, num_speakers, _jax_variables(jt.state))
    rng = np.random.RandomState(7)
    state, want, got = jt.state, [], []
    for _ in range(3):
        feats = rng.randn(16, 64, dim).astype(np.float32)
        labels = rng.randint(0, num_speakers, 16).astype(np.int32)
        f, l = jt._shard_batch(feats, labels)
        state, metrics = jt._train_step(state, f, l, jnp.float32(0.01))
        want.append(float(metrics["loss"]))
        got.append(float(t.train_step(torch.from_numpy(feats), torch.from_numpy(labels),
                                       0.01)["loss"]))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert t.step == int(state.step) == 3


# ---------------------------------------------------------------- bf16 policy

def test_bf16_step_policy(tmp_path):
    """compute_dtype bfloat16, as the JAX step has it (trainer.py:332-347):
    the forward runs on bf16 parameters and features, while the master
    parameters, the BatchNorm statistics and the update stay float32. Two
    steps from one state against the float32 step: losses within 2e-2, the
    whole update's direction at cosine > 0.95 (0.967 measured: bf16 rounds
    each product of this 16-wide net to 2^-9; the biases that a BatchNorm
    follows carry only rounding noise and are left out)."""
    rng = np.random.RandomState(1)
    batches = [(torch.from_numpy(rng.randn(8, 40, 10).astype(np.float32)),
                torch.from_numpy(rng.randint(0, 8, 8))) for _ in range(2)]
    init = convert.variables_of(_port_trainer(TINY, tmp_path / "init", 10, 8).network_model)
    runs = {}
    for dtype in ("bfloat16", "float32"):
        t = _port_trainer(dict(TINY, compute_dtype=dtype), tmp_path / dtype, 10, 8, init)
        seen = []
        hook = t.network_model.network.tdnn.tdnn5_dense.register_forward_hook(
            lambda mod, args, out: seen.append((args[0].dtype, out.dtype)))
        losses = [float(t.train_step(f, l, 0.05)["loss"]) for f, l in batches]
        hook.remove()
        assert seen == [(getattr(torch, dtype),) * 2] * 2
        assert all(v.dtype == torch.float32 for v in t.network_model.state_dict().values())
        runs[dtype] = losses, convert.flatten(convert.variables_of(t.network_model))
    np.testing.assert_allclose(runs["bfloat16"][0], runs["float32"][0], rtol=2e-2)
    flat0 = convert.flatten(init)
    upd = {dtype: np.concatenate([
        (np.asarray(v, np.float64) - np.asarray(flat0[k], np.float64)).ravel()
        for k, v in sorted(runs[dtype][1].items()) if k[0] == "params" and not _zero_grad_bias(k)])
        for dtype in runs}
    a, b = upd["bfloat16"], upd["float32"]
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos > 0.95, cos


# ---------------------------------------------------------------- checkpoints

def test_checkpoint_pt_round_trip(tmp_path):
    cfg = dict(TINY, optimizer="adam")
    t = _port_trainer(cfg, tmp_path / "a", 10, 8)
    rng = np.random.RandomState(2)
    for _ in range(2):
        t.train_step(torch.from_numpy(rng.randn(8, 40, 10).astype(np.float32)),
                     torch.from_numpy(rng.randint(0, 8, 8)), 0.01)
    t.save(t.step)
    assert os.path.exists(tmp_path / "a" / "model-2.pt")
    u = _port_trainer(cfg, tmp_path / "a", 10, 8)
    assert u.load() == 2 and u.step == 2 and u.optimizer.count == 2
    _assert_trees_close(u.state_tree(), t.state_tree(), rtol=0, atol=0)


def test_cont_from_jax_msgpack(tmp_path):
    """JAX trains one step (momentum with clipping, optax's chain of two)
    and writes model-1.msgpack; the port resumes from it (params, BatchNorm
    statistics, the trace, step) for one more step, and lands where JAX's
    second step does."""
    cfg = dict(TINY, clip_gradient=True, clip_gradient_norm=1.0)
    nnet = tmp_path / "nnet"
    jt = _jax_trainer(cfg, nnet, 10, 8)
    rng = np.random.RandomState(4)
    batches = [(rng.randn(8, 40, 10).astype(np.float32), rng.randint(0, 8, 8).astype(np.int32))
               for _ in range(2)]
    state, _ = jt._train_step(jt.state, *map(jnp.asarray, batches[0]), jnp.float32(0.05))
    jt.state = state
    jt.save(1)
    state, jm = jt._train_step(state, *map(jnp.asarray, batches[1]), jnp.float32(0.05))

    t = Trainer(ParamsPlain(**cfg), str(nnet), dim=10, num_speakers=8, device="cpu")
    t.build("train", 10, cfg["loss_func"], 8)
    assert t.load() == 1 and t.step == 1
    m = t.train_step(*map(torch.from_numpy, batches[1]), 0.05)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert t.step == int(state.step) == 2
    # the biases that a BatchNorm follows hold rounding noise on both sides
    def kept(tree):
        return {k: v for k, v in convert.flatten(tree).items() if not _zero_grad_bias(k)}

    _assert_trees_close(kept(convert.variables_of(t.network_model)),
                        kept(_jax_variables(state)), rtol=1e-4, atol=1e-6)
    trace = jax.device_get(state.opt_state)[1].trace
    _assert_trees_close(kept(t.state_tree()["opt_state"]["trace"]), kept(trace),
                        rtol=1e-4, atol=1e-6)


def test_load_jax_adam_state(tmp_path):
    """A JAX Adam train state (optax's chain of one) after an update from
    random gradients: the port loads its moments, count and step as they
    are, in the parameters' layout."""
    cfg = dict(TINY, optimizer="adam")
    nnet = tmp_path / "nnet"
    jt = _jax_trainer(cfg, nnet, 10, 8)
    rng = np.random.RandomState(5)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.randn(*p.shape), p.dtype), jt.state.params)
    _, opt_state = jt.tx.update(grads, jt.state.opt_state, jt.state.params)
    jt.state = jt.state.replace(opt_state=opt_state, step=jnp.int32(7))
    jt.save(7)
    t = _port_trainer(cfg, nnet, 10, 8)
    assert t.load() == 7 and t.step == 7
    tree = t.state_tree()
    jopt = jax.device_get(opt_state)[0]
    assert tree["opt_state"]["count"] == int(jopt.count) == 1
    for key in ("mu", "nu"):
        _assert_trees_close(tree["opt_state"][key], getattr(jopt, key), rtol=0, atol=0)
    _assert_trees_close(tree["params"], jax.device_get(jt.state.params), rtol=0, atol=0)
