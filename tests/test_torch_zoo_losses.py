"""The port's ring and MHE auxiliary losses (``aux_loss_func``) against real
TF (``golden_triplet.npz``: the total, each term, and the gradients with
respect to the features, the output kernel and the ring radius, as
``tests/test_tf_golden.py:538-567``) and against the JAX ``LossHead`` with
and without row weights, in every softmax-family loss. Tolerances: the
golden test's (loss rtol 1e-5 / atol 1e-6, terms and gradients rtol 1e-4 /
atol 1e-5); against JAX rtol 1e-4 / atol 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu.losses import head as jhead
from tf_kaldi_speaker_tpu_torch.losses import head as thead

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "tf_golden")
TOL = dict(rtol=1e-4, atol=1e-5)
ANNEAL = dict(amsoftmax_lambda_min=0.0, amsoftmax_lambda_base=1000.0,
              amsoftmax_lambda_gamma=1e-4, amsoftmax_lambda_power=5.0)


def test_ring_mhe_match_tf_golden():
    gold = np.load(os.path.join(GOLD, "golden_triplet.npz"))
    cfg = dict(ANNEAL, amsoftmax_m=0.2, aux_loss_func=["ring_loss", "mhe_loss"],
               ring_loss_init=2.5, ring_loss_lambda=0.3, mhe_lambda=0.1)
    head = thead.LossHead("additive_margin_softmax", 10, cfg, 16)
    with torch.no_grad():
        head.output_kernel.copy_(torch.from_numpy(gold["kernel"]))
    assert float(head.ring_r.detach()) == 2.5
    feats = torch.tensor(gold["features_ang"], requires_grad=True)
    loss, ep = head(feats, torch.from_numpy(gold["labels_cls"]), 5000)
    dfeat, dkernel, dr = torch.autograd.grad(loss, [feats, head.output_kernel, head.ring_r])
    np.testing.assert_allclose(float(loss), float(gold["aux_total"]), rtol=1e-5, atol=1e-6)
    for key, val in (("aux_total_dfeat", dfeat), ("aux_ring", ep["ring_loss"]),
                     ("aux_mhe", ep["mhe_loss"]), ("aux_total_dkernel", dkernel),
                     ("aux_total_dr", dr)):
        np.testing.assert_allclose(val.detach().numpy(), gold[key], err_msg=key, **TOL)


@pytest.mark.parametrize("aux", [["ring_loss"], ["mhe_loss"], ["ring_loss", "mhe_loss"]])
@pytest.mark.parametrize("loss_func", ["softmax", "additive_angular_margin_softmax"])
@pytest.mark.parametrize("weighted", [False, True])
def test_aux_losses_match_jax_head(aux, loss_func, weighted):
    """Values, terms and gradients (features, every parameter) against the
    JAX head; row weights zero out two rows of the aux means, as the main
    loss's; ``aux_enabled=False`` drops the terms."""
    cfg = dict(aux_loss_func=aux, ring_loss_init=1.5, ring_loss_lambda=0.2, mhe_lambda=0.05,
               arcsoftmax_m=0.3, arcsoftmax_lambda_min=0.0, arcsoftmax_lambda_base=1000.0,
               arcsoftmax_lambda_gamma=1e-4, arcsoftmax_lambda_power=5.0)
    rng = np.random.RandomState(3)
    feats = rng.randn(8, 6).astype(np.float32)
    labels = rng.randint(0, 5, 8).astype(np.int32)
    weights = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32) if weighted else None
    jh = jhead.LossHead(loss_func=loss_func, num_outputs=5, config=cfg)
    v = jax.device_get(jh.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(labels)))
    sw = None if weights is None else jnp.asarray(weights)

    def f(params, x):
        return jh.apply({"params": params}, x, jnp.asarray(labels), 3000, True,
                        sample_weight=sw)

    (want, jep), (dparams, dfeat) = jax.value_and_grad(
        lambda p, x: f(p, x), argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(feats))
    h = thead.LossHead(loss_func, 5, cfg, 6)
    assert sorted(dict(h.named_parameters())) == sorted(v["params"])
    with torch.no_grad():
        for k, a in v["params"].items():
            getattr(h, k).copy_(torch.tensor(np.asarray(a)))
    x = torch.tensor(feats, requires_grad=True)
    tw = None if weights is None else torch.from_numpy(weights)
    got, ep = h(x, torch.from_numpy(labels), 3000, None, tw)
    names = sorted(v["params"])
    grads = torch.autograd.grad(got, [x] + [getattr(h, k) for k in names])
    np.testing.assert_allclose(float(got), float(want), **TOL)
    for term in ("ring_loss", "mhe_loss"):
        assert (term in ep) == (term in aux)
        if term in ep:
            np.testing.assert_allclose(float(ep[term]), float(jep[term]), err_msg=term, **TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(dfeat), **TOL)
    for k, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(dparams[k]), err_msg=k, **TOL)
    off, _ = jh.apply(v, jnp.asarray(feats), jnp.asarray(labels), 3000, True, aux_enabled=False,
                      sample_weight=sw)
    with torch.no_grad():
        got_off, ep_off = h(torch.from_numpy(feats), torch.from_numpy(labels), 3000, None, tw,
                            aux_enabled=False)
    np.testing.assert_allclose(float(got_off), float(off), **TOL)
    assert "ring_loss" not in ep_off and "mhe_loss" not in ep_off
