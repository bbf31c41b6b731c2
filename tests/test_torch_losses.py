"""The port's margin-softmax losses and head against real TF
(golden_losses.npz) and against the JAX package's functions: loss values
and gradients with respect to the features and the kernel, with and without
row weights (sample_weight), the lambda schedule, and the head's dispatch,
margin override and refusals."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu.losses import head as jhead
from tf_kaldi_speaker_tpu.losses import margin as jm
from tf_kaldi_speaker_tpu_torch.losses import head as thead
from tf_kaldi_speaker_tpu_torch.losses import margin as tm

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "data", "tf_golden")
TOL = dict(rtol=1e-4, atol=1e-5)
ANNEAL = (0.0, 1000.0, 1e-4, 5.0)

# the cases of test_tf_golden.py:111-117
_LOSS_CASES = []
for _step in (0, 20000):
    for _m in (1, 2, 4):
        _LOSS_CASES.append(("asoftmax_m%d" % _m, _m, _step))
    for _m in (0.5, 1.0):
        _LOSS_CASES.append(("arcsoftmax_m%s" % _m, _m, _step))
    _LOSS_CASES.append(("amsoftmax_m0.2", 0.2, _step))


@pytest.fixture(scope="module")
def gold():
    return np.load(os.path.join(GOLD, "golden_losses.npz"))


def _fns(name, m):
    if name.startswith("asoftmax"):
        return tm.asoftmax_loss, jm.asoftmax_loss, int(m)
    if name.startswith("arcsoftmax"):
        return tm.arcsoftmax_loss, jm.arcsoftmax_loss, float(m)
    return tm.amsoftmax_loss, jm.amsoftmax_loss, float(m)


def _port(fn, feats, labels, kernel, m, step, weights=None):
    f = torch.tensor(feats, requires_grad=True)
    k = torch.tensor(kernel, requires_grad=True)
    w = None if weights is None else torch.from_numpy(weights)
    loss, ep = fn(f, torch.from_numpy(labels), k, m, tm.margin_annealing_lambda(step, *ANNEAL), w)
    loss.backward()
    return float(loss), f.grad.numpy(), k.grad.numpy(), ep


@pytest.mark.parametrize("name,m,step", _LOSS_CASES)
def test_margin_loss_matches_tf_golden(gold, name, m, step):
    """Adversarial embeddings (aligned, anti-aligned, tiny-norm and
    sign-boundary rows): every Chebyshev sign branch and the arc theta + m
    > pi branch."""
    fn, _, m = _fns(name, m)
    loss, dfeat, dkernel, _ = _port(fn, gold["features"], gold["labels"], gold["kernel"], m, step)
    key = name + "_step%d" % step
    np.testing.assert_allclose(loss, float(gold[key]), **TOL)
    np.testing.assert_allclose(dfeat, gold[key + "_dfeat"], **TOL)
    np.testing.assert_allclose(dkernel, gold[key + "_dkernel"], **TOL)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name,m,step", _LOSS_CASES)
def test_margin_loss_matches_jax(gold, name, m, step, weighted):
    fn, jfn, m = _fns(name, m)
    feats, labels, kernel = gold["features"], gold["labels"], gold["kernel"]
    weights = None
    if weighted:
        weights = np.ones(len(labels), np.float32)
        weights[::3] = 0.0  # padded rows
    loss, dfeat, dkernel, ep = _port(fn, feats, labels, kernel, m, step, weights)
    lam = jm.margin_annealing_lambda(step, *ANNEAL)
    jw = None if weights is None else jnp.asarray(weights)
    jl, (jf, jk) = jax.value_and_grad(
        lambda f, k: jfn(f, jnp.asarray(labels), k, m, lam, jw)[0], argnums=(0, 1))(
        jnp.asarray(feats), jnp.asarray(kernel))
    _, jep = jfn(jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(kernel), m, lam, jw)
    np.testing.assert_allclose(loss, float(jl), **TOL)
    np.testing.assert_allclose(dfeat, np.asarray(jf), **TOL)
    np.testing.assert_allclose(dkernel, np.asarray(jk), **TOL)
    np.testing.assert_allclose(ep["logits"].detach().numpy(), np.asarray(jep["logits"]), **TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_softmax_loss_matches_jax(weighted):
    rng = np.random.RandomState(0)
    feats = rng.randn(9, 6).astype(np.float32)
    kernel = rng.randn(6, 5).astype(np.float32)
    bias = rng.randn(5).astype(np.float32)
    labels = rng.randint(0, 5, 9).astype(np.int32)
    weights = (rng.rand(9) > 0.3).astype(np.float32) if weighted else None
    f, k, b = (torch.tensor(a, requires_grad=True) for a in (feats, kernel, bias))
    loss, _ = tm.softmax_loss(f, torch.from_numpy(labels), k, b,
                              None if weights is None else torch.from_numpy(weights))
    loss.backward()
    jw = None if weights is None else jnp.asarray(weights)
    jl, grads = jax.value_and_grad(
        lambda f, k, b: jm.softmax_loss(f, jnp.asarray(labels), k, b, jw)[0],
        argnums=(0, 1, 2))(*map(jnp.asarray, (feats, kernel, bias)))
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    for t, g in zip((f, k, b), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


@pytest.mark.parametrize("step", [0, 1, 5000, 20000, 10 ** 7])
def test_annealing_lambda_matches_jax(step):
    got = tm.margin_annealing_lambda(step, 5.0, 1000.0, 1e-4, 5.0)
    want = jm.margin_annealing_lambda(step, 5.0, 1000.0, 1e-4, 5.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("loss_func,margin_override", [
    ("softmax", None), ("asoftmax", None), ("asoftmax", 1),
    ("additive_margin_softmax", None), ("additive_margin_softmax", 0.0),
    ("additive_angular_margin_softmax", 0.0),
])
def test_head_matches_jax(loss_func, margin_override):
    """LossHead with the JAX head's variables, at a step of the anneal,
    with the validation margin override (trainer.py:45-50)."""
    cfg = dict(asoftmax_m=2, amsoftmax_m=0.2, arcsoftmax_m=0.3)
    for p in ("asoftmax", "amsoftmax", "arcsoftmax"):
        cfg.update({p + "_lambda_min": 0.0, p + "_lambda_base": 1000.0,
                    p + "_lambda_gamma": 1e-4, p + "_lambda_power": 5.0})
    rng = np.random.RandomState(1)
    feats = rng.randn(8, 6).astype(np.float32)
    labels = rng.randint(0, 4, 8).astype(np.int32)
    weights = np.ones(8, np.float32)
    jh = jhead.LossHead(loss_func=loss_func, num_outputs=4, config=cfg)
    v = jh.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(labels))
    want, jep = jh.apply(v, jnp.asarray(feats), jnp.asarray(labels), 3000, True,
                         margin_override=margin_override, sample_weight=jnp.asarray(weights))
    h = thead.LossHead(loss_func, 4, cfg, 6)
    with torch.no_grad():
        for k, a in v["params"].items():
            getattr(h, k).copy_(torch.from_numpy(np.asarray(a)))
    got, ep = h(torch.from_numpy(feats), torch.from_numpy(labels), 3000, margin_override,
                torch.from_numpy(weights))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(ep["logits"].detach().numpy(), np.asarray(jep["logits"]), **TOL)
    assert sorted(dict(h.named_parameters())) == sorted(v["params"])


def test_head_names_and_refusals():
    assert thead.LOSS_NAMES == jhead.LOSS_NAMES
    assert thead.STRUCTURAL_LOSSES == jhead.STRUCTURAL_LOSSES
    for name in thead.STRUCTURAL_LOSSES:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            thead.LossHead(name, 4, {}, 6)
    with pytest.raises(NotImplementedError, match="Unsupported aux loss"):
        thead.LossHead("softmax", 4, {"aux_loss_func": ["no_such_aux"]}, 6)
    with pytest.raises(NotImplementedError, match="Not implement"):
        thead.LossHead("no_such_loss", 4, {}, 6)
    h = thead.LossHead("additive_margin_softmax", 7, {}, 5,
                       generator=torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / 12)  # glorot uniform over [5, 7]
    assert h.output_kernel.shape == (5, 7) and float(h.output_kernel.abs().max()) <= limit
