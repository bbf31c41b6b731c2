"""Every shipped speaker-recipe ``nnet_conf`` JSON builds in the port at its
full width and runs one CPU forward on a [2, 300, 30] batch, and its
variable tree (names, shapes, params against batch statistics) equals the
JAX package's, taken from ``jax.eval_shape`` of the JAX model's ``init``
so nothing compiles. The multitask config (recipes/fisher/v3_multitask)
is another model family, not ported yet."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu.train.trainer import XVectorModel as JaxXVectorModel
from tf_kaldi_speaker_tpu_torch import convert
from tf_kaldi_speaker_tpu_torch.train.trainer import XVectorModel

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(p for p in glob.glob(os.path.join(ROOT, "recipes", "*", "*", "nnet_conf", "*.json"))
                 if "multitask" not in p)
DIM, SPEAKERS = 30, 50


def test_every_speaker_recipe_is_covered():
    names = {os.path.basename(p) for p in CONFIGS}
    assert len(CONFIGS) == 25  # voxceleb 22, fisher v1 2, sre 1
    assert {"ecapa_amsoftmax_m0.20.json", "resnet34_amsoftmax_m0.20.json",
            "tdnn_arcsoftmax_m0.25_att.json", "tdnn_amsoftmax_m0.20_linear_bn_1e-2_tdnn4_att.json",
            "tdnn_amsoftmax_m0.20_linear_bn_1e-2_mhe0.01.json",
            "tdnn_amsoftmax_m0.20_linear_bn_1e-2_r0.01.json"} <= names


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: "/".join(p.split(os.sep)[-4:]))
def test_recipe_config_builds_and_matches_jax_tree(path):
    with open(path) as f:
        cfg = json.load(f)
    model = XVectorModel(cfg, cfg["loss_func"], SPEAKERS, DIM,
                         torch.Generator().manual_seed(0)).eval()
    jm = JaxXVectorModel(config=cfg, loss_func=cfg["loss_func"], num_outputs=SPEAKERS)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((2, 64, DIM)), jnp.zeros((2,), jnp.int32),
                                              0, True), jax.random.PRNGKey(0))
    want = {p: tuple(s.shape) for p, s in convert.flatten(jax.tree_util.tree_map(
        lambda s: s, shapes, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))).items()}
    got = {p: tuple(t.shape) for p, t in convert.flatten(convert.variables_of(model)).items()}
    assert got == want
    feats = torch.from_numpy(np.random.RandomState(0).randn(2, 300, DIM).astype(np.float32))
    with torch.no_grad():
        loss, ep = model(feats, torch.tensor([3, 7]), 0)
    node = cfg.get("embedding_node", "tdnn6_dense")
    assert torch.isfinite(loss) and ep[node].shape[0] == 2 and torch.isfinite(ep[node]).all()
