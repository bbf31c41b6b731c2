"""The port's triplet family (``losses/triplet.py``, the generalized
angular triplet of ``losses/head.py``, the pairwise helpers of
``models/layers.py``) and ``cli.compute_gae2e_loss``, against real TF and
the JAX package.

- Against ``golden_triplet.npz`` (real TF), the cases of
  ``tests/test_tf_golden.py:438-538`` with their tolerances: loss rtol
  1e-5 / atol 1e-6, terms and gradients rtol 1e-4 / atol 1e-5.
- Against the JAX functions on seeded numpy inputs (values and gradients
  with respect to the features and the kernel): rtol 1e-5 / atol 1e-6; the
  pairwise distances and cosines the same.
- The generalized head's "average" centers: one train-mode call moves the
  buffer as JAX's ``loss_stats`` moves (repeated labels accumulate), no
  gradient flows through the move, eval mode leaves it; rtol 1e-6.
- ``cli.compute_gae2e_loss --device cpu`` prints what the JAX CLI prints.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu.cli import compute_gae2e_loss as jax_cli
from tf_kaldi_speaker_tpu.losses import head as jhead
from tf_kaldi_speaker_tpu.losses import triplet as jtriplet
from tf_kaldi_speaker_tpu.models import layers as jlayers
from tf_kaldi_speaker_tpu_torch.cli import compute_gae2e_loss as cli
from tf_kaldi_speaker_tpu_torch.kio import ArkScpWriter
from tf_kaldi_speaker_tpu_torch.losses import head as thead
from tf_kaldi_speaker_tpu_torch.losses import triplet as ttriplet
from tf_kaldi_speaker_tpu_torch.models import layers as tlayers

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "tf_golden")
GOLD_LOSS = dict(rtol=1e-5, atol=1e-6)
GOLD_TERM = dict(rtol=1e-4, atol=1e-5)
JAX_TOL = dict(rtol=1e-5, atol=1e-6)
GT_CFG = dict(margin=0.3, target_margin=1.6, triplet_center="learnable", loss_compute="raw",
              triplet_loss_weight=1.0, center_loss_weight=0.5, between_loss_weight=0.3,
              l2_loss_weight=0.0)
ANGULAR = [("asoftmax", 4), ("additive_margin_softmax", 0.25),
           ("additive_angular_margin_softmax", 0.4)]


@pytest.fixture(scope="module")
def gold():
    return np.load(os.path.join(GOLD, "golden_triplet.npz"))


def _value_and_grad(fn, *arrays):
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    loss = fn(*xs)
    grads = torch.autograd.grad(loss, xs)
    return float(loss.detach()), [g.numpy() for g in grads]


def _check(name, gold, loss, dfeat=None, extra=()):
    np.testing.assert_allclose(loss, float(gold[name]), err_msg=name, **GOLD_LOSS)
    if dfeat is not None:
        np.testing.assert_allclose(dfeat, gold[name + "_dfeat"], err_msg=name, **GOLD_TERM)
    for key, val in extra:
        np.testing.assert_allclose(val, gold[key], err_msg=key, **GOLD_TERM)


@pytest.mark.parametrize("squared", [False, True])
def test_semihard_matches_tf(gold, squared):
    labels = torch.from_numpy(gold["labels"])
    loss, (d,) = _value_and_grad(
        lambda f: ttriplet.semihard_triplet_loss(f, labels, 0.5, squared)[0],
        gold["features_semi"])
    _check("semihard_sq" if squared else "semihard", gold, loss, d)


@pytest.mark.parametrize("tt", ["all", "hard"])
@pytest.mark.parametrize("lt,m", ANGULAR)
def test_angular_matches_tf(gold, tt, lt, m):
    labels = torch.from_numpy(gold["labels"])
    loss, (d,) = _value_and_grad(
        lambda f: ttriplet.angular_triplet_loss(f, labels, float(m), tt, lt)[0],
        gold["features_ang"])
    _check("angular_%s_%s" % (tt, lt), gold, loss, d)


def test_e2e_matches_tf(gold):
    labels = torch.from_numpy(gold["labels"])
    loss, (d,) = _value_and_grad(lambda f: ttriplet.e2e_valid_loss(f, labels, 4, 3)[0],
                                 gold["features_ang"])
    _check("e2e", gold, loss, d)


@pytest.mark.parametrize("topn", [0, 1, 2])
def test_generalized_learnable_matches_tf(gold, topn):
    head = thead.LossHead("generalized_angular_triplet_loss", 10, dict(GT_CFG, triplet_topn=topn),
                          16)
    assert sorted(dict(head.named_parameters())) == ["output_kernel"]
    assert not list(head.buffers())
    labels = torch.from_numpy(gold["labels_cls"])
    feats = torch.tensor(gold["features_ang"], requires_grad=True)
    with torch.no_grad():
        head.output_kernel.copy_(torch.from_numpy(gold["kernel"]))
    loss, ep = head(feats, labels)
    dfeat, dkernel = torch.autograd.grad(loss, [feats, head.output_kernel])
    nm = "gtriplet_topn%d" % topn
    _check(nm, gold, float(loss.detach()), dfeat.numpy(), extra=[
        (nm + "_triplet", float(ep["triplet_loss"].detach())),
        (nm + "_center", float(ep["center_loss"].detach())),
        (nm + "_between", float(ep["between_loss"].detach())), (nm + "_dkernel", dkernel.numpy())])


def test_generalized_average_update_matches_tf(gold):
    head = thead.LossHead("generalized_angular_triplet_loss", 10, dict(
        GT_CFG, triplet_topn=1, triplet_center="average", triplet_center_momentum=0.95), 16)
    with torch.no_grad():
        head.output_kernel.copy_(torch.from_numpy(gold["kernel"]))
        head.triplet_centers.copy_(torch.from_numpy(gold["kernel"]))
    feats = torch.tensor(gold["features_ang"], requires_grad=True)
    loss, ep = head.train()(feats, torch.from_numpy(gold["labels_cls"]))
    _check("gtriplet_average", gold, float(loss.detach()), extra=[
        ("gtriplet_average_triplet", float(ep["triplet_loss"].detach())),
        ("gtriplet_average_centers", head.triplet_centers.numpy())])
    # the loss reaches the features through their own distances only
    (dfeat,) = torch.autograd.grad(loss, [feats])
    assert np.all(np.isfinite(dfeat.numpy()))


def _inputs(seed, b=12, d=8, speakers=4):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, d).astype(np.float32)
    labels = np.repeat(np.arange(speakers), b // speakers).astype(np.int32)
    feats[1] = feats[0]  # a duplicate row (a zero distance)
    return feats, labels


@pytest.mark.parametrize("squared", [False, True])
def test_pairwise_helpers_match_jax(squared):
    """Values and the gradient of a fixed random weighting of every pair."""
    feats, _ = _inputs(0)
    w = np.random.RandomState(1).rand(12, 12).astype(np.float32)
    jd = jax.value_and_grad(lambda f: jnp.sum(w * jlayers.pairwise_euc_distances(f, squared)))
    want, dwant = jd(jnp.asarray(feats))
    got, (dgot,) = _value_and_grad(
        lambda f: torch.sum(torch.from_numpy(w) * tlayers.pairwise_euc_distances(f, squared)),
        feats)
    np.testing.assert_allclose(got, float(want), **JAX_TOL)
    np.testing.assert_allclose(dgot, np.asarray(dwant), **JAX_TOL)
    jc = jax.value_and_grad(lambda f: jnp.sum(w * jlayers.pairwise_cos_similarity(f)))
    want, dwant = jc(jnp.asarray(feats))
    got, (dgot,) = _value_and_grad(
        lambda f: torch.sum(torch.from_numpy(w) * tlayers.pairwise_cos_similarity(f)), feats)
    np.testing.assert_allclose(got, float(want), **JAX_TOL)
    np.testing.assert_allclose(dgot, np.asarray(dwant), **JAX_TOL)


LOSSES = [("semihard", False, None), ("semihard", True, None)] + [
    ("angular", tt, lm) for tt in ("all", "hard") for lm in ANGULAR] + [("e2e", None, None)]


@pytest.mark.parametrize("kind,opt,lm", LOSSES)
@pytest.mark.parametrize("seed", [1, 2])
def test_losses_match_jax(kind, opt, lm, seed):
    feats, labels = _inputs(seed)

    def fns(mod, lab):
        if kind == "semihard":
            return lambda f: mod.semihard_triplet_loss(f, lab, 0.3, opt)[0]
        if kind == "angular":
            return lambda f: mod.angular_triplet_loss(f, lab, float(lm[1]), opt, lm[0])[0]
        return lambda f: mod.e2e_valid_loss(f, lab, 4, 3)[0]

    want, dwant = jax.value_and_grad(fns(jtriplet, jnp.asarray(labels)))(jnp.asarray(feats))
    got, (dgot,) = _value_and_grad(fns(ttriplet, torch.from_numpy(labels)), feats)
    np.testing.assert_allclose(got, float(want), **JAX_TOL)
    np.testing.assert_allclose(dgot, np.asarray(dwant), **JAX_TOL)


def _jax_head(cfg, feats, labels, kernel, centers, train):
    head = jhead.LossHead(loss_func="generalized_angular_triplet_loss", num_outputs=6, config=cfg)
    variables = {"params": {"output_kernel": jnp.asarray(kernel)}}
    if centers is not None:
        variables["loss_stats"] = {"triplet_centers": jnp.asarray(centers)}

    def fn(f, k):
        v = dict(variables, params={"output_kernel": k})
        (loss, ep), mut = head.apply(v, f, jnp.asarray(labels), 0, train,
                                     mutable=["loss_stats"])
        return loss, (ep, mut)

    (loss, (ep, mut)), grads = jax.value_and_grad(fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(feats), jnp.asarray(kernel))
    return float(loss), ep, mut, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("center", ["learnable", "average"])
@pytest.mark.parametrize("topn", [0, 1, 3])
@pytest.mark.parametrize("train", [True, False])
def test_generalized_head_matches_jax(center, topn, train):
    """Repeated labels (two rows of class 2, three of class 5) accumulate in
    the centers' move; classes 1 and 4 get no row."""
    rng = np.random.RandomState(topn + 10 * train)
    feats = rng.randn(8, 5).astype(np.float32)
    labels = np.array([2, 0, 2, 5, 3, 5, 5, 0], np.int32)
    kernel = rng.randn(5, 6).astype(np.float32) * 0.5
    centers = (kernel + rng.randn(5, 6).astype(np.float32) * 0.1) if center == "average" else None
    cfg = dict(GT_CFG, target_margin=0.4, triplet_topn=topn, triplet_center=center,
               triplet_center_momentum=0.9, l2_loss_weight=0.01)
    want, jep, mut, (dfeat, dkernel) = _jax_head(cfg, feats, labels, kernel, centers, train)
    head = thead.LossHead("generalized_angular_triplet_loss", 6, cfg, 5).train(train)
    with torch.no_grad():
        head.output_kernel.copy_(torch.from_numpy(kernel))
        if centers is not None:
            head.triplet_centers.copy_(torch.from_numpy(centers))
    x = torch.tensor(feats, requires_grad=True)
    loss, ep = head(x, torch.from_numpy(labels))
    gx, gk = torch.autograd.grad(loss, [x, head.output_kernel], allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), want, **JAX_TOL)
    for key in ("triplet_loss", "center_loss", "between_loss", "l2_loss"):
        np.testing.assert_allclose(float(ep[key].detach()), float(jep[key]), err_msg=key,
                                   **JAX_TOL)
    np.testing.assert_allclose(gx.numpy(), dfeat, **JAX_TOL)
    if center == "learnable":
        np.testing.assert_allclose(gk.numpy(), dkernel, **JAX_TOL)
    else:
        # the kernel only seeds the centers: no gradient, as in JAX
        assert gk is None and not np.any(dkernel)
        moved = np.asarray(mut["loss_stats"]["triplet_centers"]) if mut else centers
        np.testing.assert_allclose(head.triplet_centers.numpy(), moved, rtol=1e-6, atol=1e-7)
        assert np.array_equal(head.triplet_centers.numpy(), centers) == (not train)


def test_average_centers_start_from_the_kernel():
    cfg = dict(GT_CFG, triplet_topn=1, triplet_center="average", triplet_center_momentum=0.9)
    head = thead.LossHead("generalized_angular_triplet_loss", 6, cfg, 5,
                          torch.Generator().manual_seed(3))
    assert torch.equal(head.triplet_centers, head.output_kernel.detach())
    assert [n for n, _ in head.named_buffers()] == ["triplet_centers"]


@pytest.mark.parametrize("name", sorted(jhead.LOSS_NAMES))
def test_every_loss_builds_and_runs(name):
    """Every ``loss_func`` of the JAX head builds in the port, with the
    JAX head's parameter names, and gives JAX's loss on one batch."""
    cfg = dict(GT_CFG, triplet_topn=1, triplet_type="hard", loss_type="additive_margin_softmax",
               num_valid_speakers_per_batch=4, num_valid_segments_per_speaker=3,
               asoftmax_m=2, amsoftmax_m=0.2, arcsoftmax_m=0.2)
    for p in ("asoftmax", "amsoftmax", "arcsoftmax"):
        cfg.update({p + "_lambda_min": 0, p + "_lambda_base": 1000, p + "_lambda_gamma": 1e-4,
                    p + "_lambda_power": 5})
    feats, labels = _inputs(4)
    jh = jhead.LossHead(loss_func=name, num_outputs=4, config=cfg)
    v = jax.device_get(jh.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(labels)))
    want, _ = jh.apply(v, jnp.asarray(feats), jnp.asarray(labels), 100)
    head = thead.LossHead(name, 4, cfg, 8)
    assert sorted(dict(head.named_parameters())) == sorted(v.get("params", {}))
    with torch.no_grad():
        for k, a in v.get("params", {}).items():
            getattr(head, k).copy_(torch.tensor(np.asarray(a)))
    with torch.no_grad():
        got, _ = head.eval()(torch.from_numpy(feats), torch.from_numpy(labels), 100)
    np.testing.assert_allclose(float(got), float(want), **JAX_TOL)


def test_no_refusal_cites_the_triplet_item():
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tf_kaldi_speaker_tpu_torch")
    for dirpath, _, names in os.walk(root):
        for n in names:
            if n.endswith((".py", ".sh")):
                with open(os.path.join(dirpath, n)) as f:
                    assert "ROADMAP.md §1 item 3" not in f.read(), n


@pytest.fixture(scope="module")
def embeddings(tmp_path_factory):
    """Embeddings of 5 speakers: 3 with 4 or more utterances, 2 with fewer."""
    root = tmp_path_factory.mktemp("gae2e")
    rng = np.random.RandomState(6)
    w = ArkScpWriter("ark,scp:%s,%s" % (root / "xv.ark", root / "xv.scp"))
    u2s = []
    for s, n in enumerate((5, 4, 2, 6, 3)):
        center = rng.randn(16)
        for u in range(n):
            key = "s%d-u%d" % (s, u)
            w.write(key, (center + 0.5 * rng.randn(16)).astype(np.float32))
            u2s.append("%s s%d" % (key, s))
    w.close()
    (root / "utt2spk").write_text("\n".join(u2s) + "\n")
    return root


@pytest.mark.parametrize("argv", [
    [], ["--loss", "angular_triplet", "--margin", "0.3"],
    ["--loss", "angular_triplet", "--loss-type", "additive_angular_margin_softmax"],
    ["--num-segments", "3"]])
def test_cli_matches_jax(embeddings, capsys, argv):
    files = [str(embeddings / "xv.scp"), str(embeddings / "utt2spk")]
    assert jax_cli.main(argv + files) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"] + files) == 0
    assert capsys.readouterr().out == want and "speakers x" in want


def test_cli_cuda_default_raises_without_card(embeddings):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(embeddings / "xv.scp"), str(embeddings / "utt2spk")])
