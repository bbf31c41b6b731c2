"""Training the zoo in the port against the JAX Trainer on the CPU: for
ECAPA-TDNN, ResNet34 (``use_fused_pooling``) and a TDNN with self-attention
pooling (its penalty in the loss) and the ring and MHE auxiliary losses,

- a 3-step float32 loss trajectory from the JAX Trainer's initial
  variables (rtol 2e-4, as the flagship's in test_torch_train.py), the
  attention penalty step for step;
- ``--cont`` from the JAX Trainer's ``model-1.msgpack`` (parameters,
  BatchNorm statistics, the momentum trace, the step): the port's next step
  lands where JAX's does (loss rtol 1e-5; variables and trace rtol 1e-4 /
  atol 1e-5, variables of scale 0.1 after clipping at norm 3);
- the validation loss leaves the aux terms out, as the JAX one does;

and the L2 term over a GhostVLAD tree (its centers included, the query
and the ring radius not) against the JAX ``l2_regularization``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu.parallel.mesh import make_mesh
from tf_kaldi_speaker_tpu.train.trainer import Trainer as JaxTrainer
from tf_kaldi_speaker_tpu.train.trainer import XVectorModel as JaxXVectorModel
from tf_kaldi_speaker_tpu.train.trainer import l2_regularization as jax_l2
from tf_kaldi_speaker_tpu.utils.params import ParamsPlain as JaxParams
from tf_kaldi_speaker_tpu_torch import convert
from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer, l2_regularization
from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain
from test_torch_zoo_networks import ECAPA, RESNET
from test_torch_zoo_pooling import bn_follows, jax_network

torch.set_num_threads(1)

DIM, SPEAKERS, LR = 20, 8, 0.05
HEAD = dict(seed=0, loss_func="additive_margin_softmax", amsoftmax_m=0.2,
            amsoftmax_lambda_min=0, amsoftmax_lambda_base=1000, amsoftmax_lambda_gamma=1e-4,
            amsoftmax_lambda_power=5, optimizer="momentum", momentum=0.9,
            weight_l2_regularizer=1e-2, clip_gradient=True, clip_gradient_norm=3.0)
CONFIGS = {
    "ecapa": dict(ECAPA, **HEAD),
    "resnet_fused": dict(RESNET, use_fused_pooling=True, **HEAD),
    "tdnn_attention_ring_mhe": dict(
        HEAD, network_type="tdnn", tdnn_layer_size=16, num_nodes_pooling_layer=24,
        num_nodes_last_layer=12, embedding_node="tdnn6_dense", last_layer_linear=True,
        pooling_type="self_attention", att_key_input="tdnn4_relu", att_key_num_nodes=[16, 8],
        att_key_network_type=3, att_value_input="tdnn5_relu", att_value_num_nodes=[],
        att_value_network_type=0, att_num_heads=2, att_split_key=True, att_use_scale=True,
        att_apply_nonlinear=True, att_penalty_term=0.5,
        aux_loss_func=["ring_loss", "mhe_loss"], ring_loss_init=3.0, ring_loss_lambda=0.01,
        mhe_lambda=0.01),
}


def _batches():
    rng = np.random.RandomState(7)
    return [(rng.randn(8, 40, DIM).astype(np.float32),
             rng.randint(0, SPEAKERS, 8).astype(np.int32)) for _ in range(3)]


def _variables(state):
    return {"params": jax.device_get(state.params),
            "batch_stats": jax.device_get(state.batch_stats)}


def _port(cfg, path):
    t = Trainer(ParamsPlain(**cfg), str(path), dim=DIM, num_speakers=SPEAKERS, device="cpu")
    t.build("train", DIM, cfg["loss_func"], SPEAKERS)
    return t


class _JitInit(JaxXVectorModel):
    """The JAX XVectorModel with its ``init`` compiled: the same variables
    as the eager init, in a fraction of its time at these sizes."""

    def init(self, rngs, *args, **kw):
        return jax.jit(lambda r: JaxXVectorModel.init(self, r, *args, **kw))(rngs)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_run(request, tmp_path_factory):
    """The JAX Trainer: its initial variables, 3 steps with model-1.msgpack
    written after the first, each step's metrics, the state after step 2."""
    name = request.param
    cfg = CONFIGS[name]
    nnet = tmp_path_factory.mktemp(name) / "nnet"
    jt = JaxTrainer(JaxParams(**cfg), str(nnet), dim=DIM, num_speakers=SPEAKERS,
                    mesh=make_mesh(devices=jax.devices()[:1]))
    jt.network_model = _JitInit(config=cfg, loss_func=cfg["loss_func"], num_outputs=SPEAKERS)
    jt.build("train", DIM, cfg["loss_func"], SPEAKERS)
    init = _variables(jt.state)
    state, metrics, states = jt.state, [], []
    for i, (feats, labels) in enumerate(_batches()):
        # the step donates its input state: copy what is kept to the host
        state, m = jt._train_step(state, jnp.asarray(feats), jnp.asarray(labels), jnp.float32(LR))
        metrics.append({k: float(v) for k, v in m.items()})
        states.append((_variables(state), jax.device_get(state.opt_state)[1].trace))
        if i == 0:
            jt.state = state
            jt.save(1)
    return dict(name=name, cfg=cfg, nnet=nnet, init=init, metrics=metrics,
                state2=states[1][0], trace2=states[1][1])


def test_trajectory_matches_jax(jax_run, tmp_path):
    cfg = jax_run["cfg"]
    t = _port(cfg, tmp_path)
    convert.load_variables(t.network_model, jax_run["init"])
    got = [t.train_step(*map(torch.from_numpy, b), LR) for b in _batches()]
    want = jax_run["metrics"]
    np.testing.assert_allclose([float(m["loss"]) for m in got], [m["loss"] for m in want],
                               rtol=2e-4)
    np.testing.assert_allclose([float(m["penalty_loss"]) for m in got],
                               [m["penalty_loss"] for m in want], rtol=2e-4, atol=1e-7)
    if "attention" in jax_run["name"]:
        assert min(m["penalty_loss"] for m in want) > 0
    assert t.step == 3


def test_cont_from_jax_msgpack(jax_run):
    cfg = jax_run["cfg"]
    t = Trainer(ParamsPlain(**cfg), str(jax_run["nnet"]), dim=DIM, num_speakers=SPEAKERS,
                device="cpu")
    t.build("train", DIM, cfg["loss_func"], SPEAKERS)
    assert t.load() == 1 and t.step == 1
    m = t.train_step(*map(torch.from_numpy, _batches()[1]), LR)
    np.testing.assert_allclose(float(m["loss"]), jax_run["metrics"][1]["loss"], rtol=1e-5)

    def kept(tree):
        flat = convert.flatten(tree)
        return {k: v for k, v in flat.items() if not bn_follows(k, flat)}

    for got, want in ((convert.variables_of(t.network_model), jax_run["state2"]),
                      (t.state_tree()["opt_state"]["trace"], jax_run["trace2"])):
        got, want = kept(got), kept(want)
        assert sorted(got) == sorted(want)
        for path in want:
            np.testing.assert_allclose(got[path].numpy(), np.asarray(want[path]), rtol=1e-4,
                                       atol=1e-5, err_msg="/".join(path))


def test_valid_loss_leaves_aux_terms_out(tmp_path):
    """The validation loss is the margin-free softmax loss alone, as the
    JAX trainer's (``aux_enabled=False``); the train step's adds ring and
    MHE."""
    cfg = CONFIGS["tdnn_attention_ring_mhe"]
    t = _port(cfg, tmp_path)
    feats, labels = map(torch.from_numpy, _batches()[0])
    weights = torch.ones(8)
    aux_off = float(t.valid_loss(feats, labels, weights))
    with torch.no_grad():
        on, ep = t.network_model.eval()(feats, labels, t.step, margin_override=0.0,
                                        sample_weight=weights)
    assert {"ring_loss", "mhe_loss"} <= set(ep)
    np.testing.assert_allclose(float(on) - float(ep["ring_loss"]) - float(ep["mhe_loss"]),
                               aux_off, rtol=1e-6)


@torch.no_grad()
def test_l2_covers_vlad_centers_not_query_or_ring():
    from tf_kaldi_speaker_tpu_torch.train.trainer import XVectorModel

    cfg = dict(CONFIGS["tdnn_attention_ring_mhe"], pooling_type="ghost_vlad",
               vlad_num_centers=4, vlad_num_ghosts=1, vlad_key_input="tdnn4_relu",
               vlad_value_input="tdnn5_relu", vlad_value_num_nodes=[6])
    named = dict(XVectorModel(cfg, cfg["loss_func"], SPEAKERS, DIM).named_parameters())
    tree = jax.tree_util.tree_map(np.asarray, convert.tree_from_named(named.items())["params"])
    got = float(l2_regularization(named, 1e-2, 3e-2))
    np.testing.assert_allclose(got, float(jax_l2(tree, 1e-2, 3e-2)), rtol=1e-6)
    without = {k: v for k, v in named.items() if not k.endswith("vlad_centers")}
    centers = named["network.tdnn.ghost_vlad.vlad_centers"]
    np.testing.assert_allclose(got - float(l2_regularization(without, 1e-2, 3e-2)),
                               0.5e-2 * float(torch.sum(centers ** 2)), rtol=1e-5)
    att = XVectorModel(CONFIGS["tdnn_attention_ring_mhe"], "additive_margin_softmax",
                       SPEAKERS, DIM)
    named = dict(att.named_parameters())
    base = float(l2_regularization(named, 1e-2, 1e-2))
    for name in ("network.tdnn.self_attention.query", "softmax.ring_r"):
        named[name].mul_(3.0)
        assert float(l2_regularization(named, 1e-2, 1e-2)) == base, name
