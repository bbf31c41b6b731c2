"""Export a trained model back into the reference's TF1 checkpoint format.

Counterpart of ``tf_kaldi_speaker_tpu/train/tf_export.py``, whole. Inverse
of ``train/tf_import.py``: walks a checkpoint's ``params`` / ``batch_stats``
trees, which the port keeps in the JAX layout (``convert.py``), and emits a
TensorBundle checkpoint under the reference's TF variable names (scopes
from reference model/tdnn.py, model/pooling.py, model/loss.py,
model/multitask_v1/tdnn.py, e.g. ``tdnn/tdnn1_conv/kernel`` [1,k,in,out],
``tdnn/tdnn4_bn/moving_mean``, ``softmax/output/kernel``), plus the
``global_step`` counter and a ``checkpoint`` pointer file, so a model
trained here restores into the reference's graphs with a plain
``tf.compat.v1.train.Saver`` (reference model/trainer.py:142-166 load path)
for extraction or fine-tuning. Every emitted name is round-tripped through
``map_tf_name`` at export time, so the exporter can never drift from the
importer.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..kio.tf_bundle import write_tf_checkpoint
from .tf_import import map_tf_name

log = logging.getLogger("tfks_torch.tf_export")

# JAX-layout leaf name -> TF BN variable name, per collection
_BN_OUT = {
    "params": {"scale": "gamma", "bias": "beta"},
    "batch_stats": {"mean": "moving_mean", "var": "moving_variance"},
}


def _expand0(a: np.ndarray) -> np.ndarray:
    """1-D conv kernel [k,in,out] -> reference conv2d kernel [1,k,in,out]
    (the reference uses conv2d with a dummy height axis, tdnn.py:35-91)."""
    return a[None]


def _ident(a: np.ndarray) -> np.ndarray:
    return a


def _bn_leaf(coll: str, leaf: str) -> Optional[str]:
    return _BN_OUT.get(coll, {}).get(leaf)


def map_flax_leaf(coll: str, path: Tuple[str, ...]):
    """(collection, JAX-layout path tuple) -> (tf_name, transform) or None.

    Inverse of tf_import.map_tf_name for every reference-representable
    leaf; returns None for leaves with no reference counterpart (e.g.
    ECAPA/ResNet trees), which the exporter reports as skipped.
    """
    # ----- loss head ------------------------------------------------------
    if path == ("softmax", "output_kernel"):
        return "softmax/output/kernel", _ident
    if path == ("softmax", "output_bias"):
        return "softmax/output/bias", _ident
    if path == ("softmax", "ring_r"):
        return "softmax_ringloss/r", _ident

    # ----- single-task TDNN tree -----------------------------------------
    if len(path) >= 3 and path[0] == "network" and path[1] == "tdnn":
        rest = path[2:]
        sub, leaf = rest[0], rest[-1]
        if len(rest) == 2:
            if sub.endswith("_conv") and leaf in ("kernel", "bias"):
                return "tdnn/%s/%s" % (sub, leaf), (_expand0 if leaf == "kernel" else _ident)
            if sub.endswith("_dense") and leaf in ("kernel", "bias"):
                return "tdnn/%s/%s" % (sub, leaf), _ident
            if sub.endswith("_bn"):
                tfleaf = _bn_leaf(coll, leaf)
                if tfleaf:
                    return "tdnn/%s/%s" % (sub, tfleaf), _ident
            if sub.endswith("_prelu") and leaf == "alpha":
                return "tdnn/%s_relu/alpha" % sub[: -len("_prelu")], _ident
        if sub == "self_attention":
            return _map_pool_leaf("attention", coll, rest[1:])
        if sub == "ghost_vlad":
            return _map_pool_leaf("vlad", coll, rest[1:])
    # ----- multitask encoders (flat module names, multitask/model.py) -----
    if len(path) == 2:
        mod, leaf = path
        scope = "encoder_phone" if mod.startswith(("phn_", "zp_")) else "encoder"
        if ("conv" in mod or "dense" in mod) and leaf in ("kernel", "bias"):
            tr = _expand0 if ("conv" in mod and leaf == "kernel") else _ident
            return "%s/%s/%s" % (scope, mod, leaf), tr
        if "bn" in mod:
            tfleaf = _bn_leaf(coll, leaf)
            if tfleaf:
                return "%s/%s/%s" % (scope, mod, tfleaf), _ident
    return None


def _map_pool_leaf(tf_scope: str, coll: str, rest: Tuple[str, ...]):
    """Attention / vlad subtree -> tdnn/{attention,vlad}/... names.

    Family-specific leaves are gated on ``tf_scope`` so a leaf of one family
    appearing under the other's subtree is reported as skipped instead of
    producing a cross-scope name the importer would map elsewhere."""
    if tf_scope == "attention":
        if rest == ("query",):
            return "tdnn/attention/query", _ident
        if len(rest) == 2 and rest[0] == "att_post_bn":
            tfleaf = _bn_leaf(coll, rest[1])
            if tfleaf:
                return "tdnn/attention/att_post_bn/%s" % tfleaf, _ident
        if rest == ("att_post_prelu", "alpha"):
            return "tdnn/attention/att_post_relu/alpha", _ident
    if tf_scope == "vlad":
        if rest == ("vlad_centers",):
            return "tdnn/vlad/vlad_centers", _ident
        if len(rest) == 2 and rest[0] == "vlad_weight_affine":
            return "tdnn/vlad/vlad_weight_affine/%s" % rest[1], _ident
    if len(rest) == 3:
        grp, kind, leaf = rest
        if kind == "affine" and leaf in ("kernel", "bias"):
            return "tdnn/%s/%s/%s_dense/%s" % (tf_scope, grp, grp, leaf), _ident
        if kind == "bn":
            tfleaf = _bn_leaf(coll, leaf)
            if tfleaf:
                return "tdnn/%s/%s/%s_bn/%s" % (tf_scope, grp, grp, tfleaf), _ident
        if kind == "%s_prelu" % grp and leaf == "alpha":
            return "tdnn/%s/%s/%s_relu/alpha" % (tf_scope, grp, grp), _ident
    return None


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def write_checkpoint_pointer(directory: str, basename: str) -> None:
    """Write the TF Saver 'checkpoint' pointer file (proto-text) the
    reference reads via tf.train.get_checkpoint_state (trainer.py:142-166,
    misc/utils.py:217-270)."""
    with open(os.path.join(directory, "checkpoint"), "w") as f:
        f.write('model_checkpoint_path: "%s"\n' % basename)
        f.write('all_model_checkpoint_paths: "%s"\n' % basename)


def export_reference_checkpoint(
    params: Dict,
    batch_stats: Dict,
    prefix: str,
    step: int = 0,
    momentum_slots: bool = False,
    dry_run: bool = False,
) -> Tuple[List[str], List[str]]:
    """Write (params, batch_stats) as a reference-named TF checkpoint.

    Args:
        params/batch_stats: host trees in the JAX layout (dicts of numpy
            arrays or CPU float32 tensors), e.g. a checkpoint's.
        prefix: checkpoint prefix, e.g. ``<dir>/model-120000``; writes
            ``<prefix>.index``, ``<prefix>.data-00000-of-00001`` and the
            ``checkpoint`` pointer file next to them.
        step: value for the ``global_step`` variable.
        momentum_slots: also write zero ``<name>/Momentum`` slot tensors for
            every trainable param so the reference's MomentumOptimizer
            training graphs restore without missing-variable errors.
        dry_run: resolve and validate every name mapping but write nothing —
            lets callers reject a partial export before any file exists.

    Returns (exported_names, skipped_paths).
    """
    tensors: Dict[str, np.ndarray] = {}
    exported: List[str] = []
    skipped: List[str] = []
    for coll, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, leaf in _walk(tree):
            mapped = map_flax_leaf(coll, path)
            label = "%s:%s" % (coll, "/".join(path))
            if mapped is None:
                skipped.append(label)
                continue
            name, tr = mapped
            value = np.asarray(tr(np.asarray(leaf, np.float32)))
            # Round-trip guard: the importer must map this exact name back
            # to this exact leaf — exporter and importer cannot drift.
            back = map_tf_name(name)
            if back is None or back[0] != coll or tuple(back[1]) != tuple(path):
                raise AssertionError(
                    "exporter/importer mismatch for %s -> %r" % (label, name))
            if not np.array_equal(np.asarray(back[2](value)),
                                  np.asarray(leaf, np.float32)):
                raise AssertionError(
                    "transform round trip failed for %s -> %r" % (label, name))
            tensors[name] = value
            exported.append(name)
            if momentum_slots and coll == "params":
                tensors[name + "/Momentum"] = np.zeros_like(value)
    tensors["global_step"] = np.asarray(step, np.int64)
    if dry_run:
        return exported, skipped
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    write_tf_checkpoint(prefix, tensors)
    write_checkpoint_pointer(os.path.dirname(os.path.abspath(prefix)),
                             os.path.basename(prefix))
    log.info("Exported %d tensors to %s (%d skipped: %s...)", len(exported),
             prefix, len(skipped), ", ".join(skipped[:5]))
    return exported, skipped
