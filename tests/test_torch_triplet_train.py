"""Training with the triplet family in the port against the JAX Trainer on
the CPU (float32, a tiny TDNN):

- 3-step loss trajectories from the JAX Trainer's initial variables for
  ``angular_triplet_loss`` ("hard", AM flavour), ``semihard_triplet_loss``
  and ``generalized_angular_triplet_loss`` with "learnable" and with
  "average" centers (loss rtol 2e-4, as the flagship's trajectory; the
  accuracy is 0, as JAX's when there are no logits), and the "average"
  centers after the third step (rtol 1e-4 / atol 1e-5). The learning
  rate is 0.01: at 0.05 the JAX Trainer's own step-3 angular loss moves
  0.57% when its initial weights move by 1e-6 relative (the update crosses
  a mining or hinge kink), at 0.01 at most 1.3e-4 in all four cases;
- the centers through checkpoints: the JAX Trainer's ``model-1.msgpack``
  (its ``loss_stats``) resumes in the port with ``--cont`` semantics and the
  next step lands on JAX's; the port's ``.pt`` round trip; fine-tuning
  keeps them or re-initializes them by ``noload_var_list``;
- ``batch_type: "end2end"`` validation: speaker-major batches of
  ``num_valid_speakers_per_batch x num_valid_segments_per_speaker`` from
  the port's ``KaldiDataRandomQueue``, and the GE2E swap for
  ``angular_triplet_loss``: the mean loss equals the JAX valid step's over
  the same batches (rtol 1e-5); the refusals (a softmax batch for the GE2E
  swap, an unknown batch type, a padded row for a structural loss);
- a device-pool epoch with a structural loss through ``Trainer.train``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu.parallel.mesh import make_mesh
from tf_kaldi_speaker_tpu.train.trainer import Trainer as JaxTrainer
from tf_kaldi_speaker_tpu.train.trainer import XVectorModel as JaxXVectorModel
from tf_kaldi_speaker_tpu.utils.params import ParamsPlain as JaxParams
from tf_kaldi_speaker_tpu_torch import convert
from tf_kaldi_speaker_tpu_torch.train import trainer as trainer_mod
from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain
from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

torch.set_num_threads(1)

DIM, SPEAKERS, LR = 10, 6, 0.01
BASE = dict(
    seed=3, network_type="tdnn", tdnn_layer_size=16, num_nodes_pooling_layer=24,
    num_nodes_last_layer=12, pooling_type="statistics_pooling", embedding_node="tdnn6_dense",
    last_layer_linear=True, optimizer="momentum", momentum=0.9, weight_l2_regularizer=1e-2,
    batchnorm_momentum=0.99, num_speakers_per_batch=4, num_segments_per_speaker=2,
    min_segment_len=40, max_segment_len=40, num_valid_speakers_per_batch=3,
    num_valid_segments_per_speaker=2, valid_max_iterations=3, show_training_progress=0)
GT = dict(margin=0.3, target_margin=0.2, triplet_topn=2, triplet_loss_weight=1.0,
          center_loss_weight=0.5, between_loss_weight=0.3, l2_loss_weight=0.01)
CONFIGS = {
    "angular_hard": dict(BASE, loss_func="angular_triplet_loss", triplet_type="hard",
                         loss_type="additive_margin_softmax", margin=0.2),
    "semihard": dict(BASE, loss_func="semihard_triplet_loss", margin=0.5),
    "generalized_learnable": dict(BASE, **GT, loss_func="generalized_angular_triplet_loss",
                                  triplet_center="learnable"),
    "generalized_average": dict(BASE, **GT, loss_func="generalized_angular_triplet_loss",
                                triplet_center="average", triplet_center_momentum=0.9),
}


def _batches():
    """Speaker-major batches of 4 speakers x 2 segments."""
    rng = np.random.RandomState(7)
    out = []
    for _ in range(3):
        spk = rng.choice(SPEAKERS, 4, replace=False)
        out.append((rng.randn(8, 40, DIM).astype(np.float32),
                    np.repeat(spk, 2).astype(np.int32)))
    return out


def _variables(state):
    v = {"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)}
    if state.loss_stats:
        v["loss_stats"] = jax.device_get(state.loss_stats)
    return v


class _JitInit(JaxXVectorModel):
    def init(self, rngs, *args, **kw):
        return jax.jit(lambda r: JaxXVectorModel.init(self, r, *args, **kw))(rngs)


def _jax_trainer(cfg, nnet):
    jt = JaxTrainer(JaxParams(**cfg), str(nnet), dim=DIM, num_speakers=SPEAKERS,
                    mesh=make_mesh(devices=jax.devices()[:1]))
    jt.network_model = _JitInit(config=cfg, loss_func=cfg["loss_func"], num_outputs=SPEAKERS)
    jt.build("train", DIM, cfg["loss_func"], SPEAKERS)
    return jt


def _port(cfg, path, variables=None):
    t = Trainer(ParamsPlain(**cfg), str(path), dim=DIM, num_speakers=SPEAKERS, device="cpu")
    t.build("train", DIM, cfg["loss_func"], SPEAKERS)
    if variables is not None:
        convert.load_variables(t.network_model, variables)
    return t


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_run(request, tmp_path_factory):
    """The JAX Trainer: initial variables, 3 steps (model-1.msgpack after
    the first), each step's metrics, the variables after the third."""
    name = request.param
    cfg = CONFIGS[name]
    nnet = tmp_path_factory.mktemp(name) / "nnet"
    jt = _jax_trainer(cfg, nnet)
    init = _variables(jt.state)
    state, metrics = jt.state, []
    for i, (feats, labels) in enumerate(_batches()):
        state, m = jt._train_step(state, jnp.asarray(feats), jnp.asarray(labels), jnp.float32(LR))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            jt.state = state
            jt.save(1)
    return dict(name=name, cfg=cfg, nnet=nnet, init=init, metrics=metrics,
                final=_variables(state))


def test_trajectory_matches_jax(jax_run, tmp_path):
    t = _port(jax_run["cfg"], tmp_path, jax_run["init"])
    got = [t.train_step(*map(torch.from_numpy, b), LR) for b in _batches()]
    want = jax_run["metrics"]
    np.testing.assert_allclose([float(m["loss"]) for m in got], [m["loss"] for m in want],
                               rtol=2e-4)
    assert all(float(m["accuracy"]) == 0.0 == w["accuracy"] for m, w in zip(got, want))
    if "loss_stats" in jax_run["final"]:
        centers = convert.variables_of(t.network_model)["loss_stats"]["softmax"]["triplet_centers"]
        first = jax_run["init"]["loss_stats"]["softmax"]["triplet_centers"]
        want_c = jax_run["final"]["loss_stats"]["softmax"]["triplet_centers"]
        assert not np.allclose(want_c, first)
        np.testing.assert_allclose(centers.numpy(), want_c, rtol=1e-4, atol=1e-5)


def test_cont_from_jax_msgpack(jax_run):
    cfg = jax_run["cfg"]
    t = Trainer(ParamsPlain(**cfg), str(jax_run["nnet"]), dim=DIM, num_speakers=SPEAKERS,
                device="cpu")
    t.build("train", DIM, cfg["loss_func"], SPEAKERS)
    assert t.load() == 1 and t.step == 1
    m = t.train_step(*map(torch.from_numpy, _batches()[1]), LR)
    np.testing.assert_allclose(float(m["loss"]), jax_run["metrics"][1]["loss"], rtol=1e-5)


def test_centers_through_checkpoints_and_finetune(tmp_path):
    cfg = CONFIGS["generalized_average"]
    t = _port(cfg, tmp_path / "a" / "nnet")
    for b in _batches()[:2]:
        t.train_step(*map(torch.from_numpy, b), LR)
    tree = t.state_tree()
    centers = tree["loss_stats"]["softmax"]["triplet_centers"]
    assert convert.jax_path("softmax.triplet_centers") == (
        "loss_stats", "softmax", "triplet_centers")
    assert not torch.equal(centers, tree["params"]["softmax"]["output_kernel"])
    t.save(2)
    back = _port(cfg, tmp_path / "a" / "nnet")
    assert back.load() == 2
    assert torch.equal(back.network_model.softmax.triplet_centers, centers)
    for noload, kept in (([], True), (["softmax/triplet_centers"], False)):
        ft = Trainer(ParamsPlain(**cfg), str(tmp_path / "a" / "nnet"), dim=DIM,
                     num_speakers=SPEAKERS, device="cpu")
        ft.build("train", DIM, cfg["loss_func"], SPEAKERS)
        ft.get_finetune_model(noload)
        got = ft.network_model.softmax.triplet_centers
        assert torch.equal(got, centers) == kept
        if not kept:  # fresh centers are a copy of a fresh kernel
            assert not torch.equal(got, ft.network_model.softmax.output_kernel.detach())


@pytest.fixture(scope="module")
def valid_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e_valid")
    return make_fake_data_dir(str(root / "valid"), num_speakers=5, utts_per_speaker=3, dim=DIM,
                              min_len=60, max_len=120, seed=8)


@pytest.mark.parametrize("name", ["angular_hard", "generalized_average", "semihard"])
def test_end2end_validation_matches_jax(valid_dir, tmp_path, monkeypatch, name):
    """The port's valid() over its own end2end batches equals the JAX valid
    step's mean over the same batches."""
    cfg = CONFIGS[name]
    jt = _jax_trainer(cfg, tmp_path / "jax")
    jt._build_valid()
    t = _port(cfg, tmp_path / "port", _variables(jt.state))
    seen, made = [], []
    Queue = trainer_mod.KaldiDataRandomQueue

    class Recording(Queue):
        def __init__(self, *args, **kw):
            made.append(kw)
            super().__init__(*args, **kw)

        def fetch(self):
            batch = super().fetch()
            seen.append(batch)
            return batch

    monkeypatch.setattr(trainer_mod, "KaldiDataRandomQueue", Recording)
    loss, emb, labels = t.valid(valid_dir["data"], valid_dir["spklist"], "end2end",
                                output_embeddings=True)
    assert made == [dict(num_parallel=2, num_speakers=3, num_segments=2, min_len=40,
                         max_len=40)]
    assert len(seen) == 3 and emb.shape == (15, 12) and labels.shape == (15,)
    want = []
    for feats, labs in seen:
        assert feats.shape == (6, 40, DIM)
        assert np.array_equal(labs[::2], labs[1::2])  # speaker-major
        f, l, w = jt._shard_batch_weighted(feats, labs)
        want.append(float(jt._valid_step(jt.state, f, l, w)[0]))
    np.testing.assert_allclose(loss, np.mean(want), rtol=1e-5)


def test_validation_refusals(valid_dir, tmp_path):
    t = _port(CONFIGS["angular_hard"], tmp_path)
    with pytest.raises(ValueError, match="batch_type='end2end'"):
        t.valid(valid_dir["data"], valid_dir["spklist"], "softmax")
    with pytest.raises(ValueError, match="Unknown batch_type"):
        t.valid(valid_dir["data"], valid_dir["spklist"], "pairs")
    feats = torch.zeros(6, 40, DIM)
    labels = torch.tensor([0, 0, 1, 1, 2, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot weight padded rows"):
        t.valid_loss(feats, labels, torch.tensor([1.0, 1, 1, 1, 1, 0]))
    assert torch.isfinite(t.valid_loss(feats + torch.randn(6, 40, DIM), labels, torch.ones(6)))


def test_pool_epoch_with_a_structural_loss(tmp_path):
    """One device-pool epoch (2 groups of 2 steps) trains the generalized
    average head; the checkpoint carries the moved centers."""
    data = make_fake_data_dir(str(tmp_path / "train"), num_speakers=SPEAKERS, utts_per_speaker=3,
                              dim=DIM, min_len=60, max_len=150, seed=5)
    cfg = dict(CONFIGS["generalized_average"], device_pool=True, num_steps_per_epoch=4,
               steps_per_dispatch=2, use_fused_pooling=True)
    t = _port(cfg, tmp_path / "nnet")
    start = t.network_model.softmax.triplet_centers.clone()
    t.train(data["data"], data["spklist"], LR)
    assert t.step == 4
    back = _port(cfg, tmp_path / "nnet")
    assert back.load() == 4
    moved = back.network_model.softmax.triplet_centers
    assert torch.equal(moved, t.network_model.softmax.triplet_centers)
    assert not torch.equal(moved, start)
