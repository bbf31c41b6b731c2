"""Import the reference's TF1 checkpoints into the port's trainers.

Counterpart of ``tf_kaldi_speaker_tpu/train/tf_import.py``. Maps
tf-kaldi-speaker's TF variable names (scopes from reference model/tdnn.py,
model/pooling.py, model/loss.py, model/multitask_v1/tdnn.py, e.g.
``tdnn/tdnn1_conv/kernel``, ``tdnn/tdnn4_bn/moving_mean``,
``tdnn/attention/query``, ``softmax/output/kernel``) onto the JAX layout's
paths (``network/tdnn/...``, ``softmax/output_kernel``), reading the
checkpoint without TensorFlow through ``kio/tf_bundle.py``. ``map_tf_name``
and ``_set_path`` are copies of the JAX package's.

:func:`import_reference_checkpoint` works on the JAX-layout tree of a
trainer's module (``convert.variables_of``), overlays the mapped arrays and
loads the result back with ``convert.load_variables``, so ``convert.py``
stays the only place where layouts change; the trainer then gets a fresh
optimizer state, as the JAX importer re-initializes ``opt_state``.
"""

from __future__ import annotations

import logging
import re
from typing import List, Tuple

import numpy as np

from .. import convert
from ..kio.tf_bundle import read_tf_checkpoint
from .trainer import Optimizer

log = logging.getLogger("tfks_torch.tf_import")

# (regex, collection, path-template, transform)
_BN = {"gamma": ("params", "scale"), "beta": ("params", "bias"),
       "moving_mean": ("batch_stats", "mean"), "moving_variance": ("batch_stats", "var")}


def _squeeze0(a):
    return a[0] if a.ndim == 4 else a


def map_tf_name(name: str):
    """tf variable name -> (collection, path tuple, transform) or None."""
    if "/Momentum" in name or "/Adam" in name or name.startswith("beta") or "global_step" in name:
        return None  # optimizer slots / counters

    m = re.fullmatch(r"tdnn/(tdnn\d+_conv)/(kernel|bias)", name)
    if m:
        tr = _squeeze0 if m.group(2) == "kernel" else (lambda a: a)
        return "params", ("network", "tdnn", m.group(1), m.group(2)), tr
    m = re.fullmatch(r"tdnn/(tdnn\d+_dense)/(kernel|bias)", name)
    if m:
        return "params", ("network", "tdnn", m.group(1), m.group(2)), lambda a: a
    m = re.fullmatch(r"tdnn/(tdnn\d+)_bn/(gamma|beta|moving_mean|moving_variance)", name)
    if m:
        coll, leaf = _BN[m.group(2)]
        return coll, ("network", "tdnn", m.group(1) + "_bn", leaf), lambda a: a
    m = re.fullmatch(r"tdnn/(tdnn\d+)_relu/alpha", name)
    if m:
        return "params", ("network", "tdnn", m.group(1) + "_prelu", "alpha"), lambda a: a

    # attention pooling
    if name == "tdnn/attention/query":
        return "params", ("network", "tdnn", "self_attention", "query"), lambda a: a
    m = re.fullmatch(r"tdnn/attention/(att_(?:key|value)\d+)/\1_dense/(kernel|bias)", name)
    if m:
        return "params", ("network", "tdnn", "self_attention", m.group(1), "affine", m.group(2)), lambda a: a
    m = re.fullmatch(r"tdnn/attention/(att_(?:key|value)\d+)/\1_bn/(gamma|beta|moving_mean|moving_variance)", name)
    if m:
        coll, leaf = _BN[m.group(2)]
        return coll, ("network", "tdnn", "self_attention", m.group(1), "bn", leaf), lambda a: a
    m = re.fullmatch(r"tdnn/attention/(att_post)_bn/(gamma|beta|moving_mean|moving_variance)", name)
    if m:
        coll, leaf = _BN[m.group(2)]
        return coll, ("network", "tdnn", "self_attention", "att_post_bn", leaf), lambda a: a
    m = re.fullmatch(r"tdnn/attention/(att_(?:key|value)\d+)/\1_relu/alpha", name)
    if m:  # prelu alpha inside a key/value dense stack (common.py prelu scope)
        return "params", ("network", "tdnn", "self_attention", m.group(1),
                          m.group(1) + "_prelu", "alpha"), lambda a: a
    if name == "tdnn/attention/att_post_relu/alpha":
        return "params", ("network", "tdnn", "self_attention", "att_post_prelu",
                          "alpha"), lambda a: a

    # (Ghost)VLAD pooling
    if name == "tdnn/vlad/vlad_centers":
        return "params", ("network", "tdnn", "ghost_vlad", "vlad_centers"), lambda a: a
    m = re.fullmatch(r"tdnn/vlad/vlad_weight_affine/(kernel|bias)", name)
    if m:
        return "params", ("network", "tdnn", "ghost_vlad", "vlad_weight_affine", m.group(1)), lambda a: a
    m = re.fullmatch(r"tdnn/vlad/(vlad_(?:key|value)\d+)/\1_dense/(kernel|bias)", name)
    if m:
        return "params", ("network", "tdnn", "ghost_vlad", m.group(1), "affine", m.group(2)), lambda a: a
    m = re.fullmatch(r"tdnn/vlad/(vlad_(?:key|value)\d+)/\1_bn/(gamma|beta|moving_mean|moving_variance)", name)
    if m:
        coll, leaf = _BN[m.group(2)]
        return coll, ("network", "tdnn", "ghost_vlad", m.group(1), "bn", leaf), lambda a: a
    m = re.fullmatch(r"tdnn/vlad/(vlad_(?:key|value)\d+)/\1_relu/alpha", name)
    if m:
        return "params", ("network", "tdnn", "ghost_vlad", m.group(1),
                          m.group(1) + "_prelu", "alpha"), lambda a: a

    # loss head
    if name == "softmax/output/kernel":
        return "params", ("softmax", "output_kernel"), lambda a: a
    if name == "softmax/output/bias":
        return "params", ("softmax", "output_bias"), lambda a: a
    if name.endswith("_ringloss/r"):
        return "params", ("softmax", "ring_r"), lambda a: a

    # Multitask encoders (model/multitask_v1/tdnn.py scopes "encoder" /
    # "encoder_phone"); MultitaskModel is the top-level module, so paths
    # have no "network" root (multitask/model.py submodule names match the
    # reference variable names 1:1).
    m = re.fullmatch(
        r"encoder(?:_phone)?/((?:phn_)?conv\d+|(?:phn_)?dense\d+|z[sp]_dense)"
        r"/(kernel|bias)", name)
    if m:
        tr = _squeeze0 if m.group(2) == "kernel" else (lambda a: a)
        return "params", (m.group(1), m.group(2)), tr
    m = re.fullmatch(
        r"encoder(?:_phone)?/((?:phn_)?bn\d+|z[sp]_bn)"
        r"/(gamma|beta|moving_mean|moving_variance)", name)
    if m:
        coll, leaf = _BN[m.group(2)]
        return coll, (m.group(1), leaf), lambda a: a
    return None


def _set_path(tree: dict, path: Tuple[str, ...], value: np.ndarray) -> bool:
    node = tree
    for p in path[:-1]:
        if p not in node:
            return False
        node = node[p]
    if path[-1] not in node:
        return False
    expect = np.shape(node[path[-1]])
    if tuple(expect) != tuple(value.shape):
        raise ValueError(
            "Shape mismatch at %s: checkpoint %s vs model %s"
            % ("/".join(path), value.shape, expect)
        )
    node[path[-1]] = value
    return True


def import_reference_checkpoint(prefix: str, trainer) -> Tuple[List[str], List[str]]:
    """Overlay a reference TF checkpoint onto a built trainer (``Trainer``
    or ``TrainerMultiTask``) and give it a fresh optimizer state.

    Returns (imported_names, skipped_names). Raises on shape mismatches, and
    for a trainer whose speaker softmax is split over a model-parallel group
    (import with ``model_parallel`` 1 and save: a checkpoint holds whole
    arrays and loads on any mesh)."""
    if trainer.mesh.model_size > 1:
        raise ValueError(
            "import_reference_checkpoint: the trainer splits the speaker softmax over "
            "model_parallel=%d ranks; import with model_parallel=1 and save, then load "
            "the checkpoint on the model-parallel mesh" % trainer.mesh.model_size)
    tensors = read_tf_checkpoint(prefix)
    tree = convert.numpy_tree(convert.variables_of(trainer.network_model))
    params, batch_stats = tree["params"], tree.get("batch_stats", {})
    imported, skipped = [], []
    for name, arr in sorted(tensors.items()):
        mapped = map_tf_name(name)
        if mapped is None:
            skipped.append(name)
            continue
        coll, path, tr = mapped
        value = np.asarray(tr(arr), np.float32)
        target = params if coll == "params" else batch_stats
        if _set_path(target, path, value):
            imported.append(name)
        else:
            skipped.append(name)
    convert.load_variables(trainer.network_model, tree)
    trainer.optimizer = Optimizer(trainer.params.dict, list(trainer._params.values()))
    log.info("Imported %d tensors; skipped %d (%s...)", len(imported),
             len(skipped), ", ".join(skipped[:5]))
    return imported, skipped
