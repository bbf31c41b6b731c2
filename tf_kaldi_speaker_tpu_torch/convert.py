"""Layout conversion between the JAX variable tree and the port's modules.

The JAX package keeps variables as a nested tree of collections: a
network's ``{"params": {"tdnn": {...}}, "batch_stats": {"tdnn": {...}}}``
(``extract/extractor.py:91-94``), and the trainer's
``{"params": {"network": {"tdnn": {...}}, "softmax": {"output_kernel",
...}}, "batch_stats": {"network": {...}}}``. The port keeps them in
modules (:class:`~tf_kaldi_speaker_tpu_torch.models.tdnn.EntireNetwork`,
:class:`~tf_kaldi_speaker_tpu_torch.train.trainer.XVectorModel`) whose
submodule names are the JAX package's. This module is the only place where
layouts change:

- a module path ``a.b.leaf`` is the JAX path ``(collection, a, b, leaf)``;
  the collection is ``batch_stats`` for BatchNorm's ``mean``/``var`` and
  ``params`` for everything else (the attention ``query``, the GhostVLAD
  ``vlad_centers`` and the ring loss's ``ring_r`` included);
- 1-D conv kernel ``[k, in, out]`` <-> ``weight [out, in, k]`` and dense
  kernel ``[in, out]`` <-> ``weight [out, in]`` (both "reverse all axes");
- 2-D conv kernel ``[kh, kw, in, out]`` <-> ``weight [out, in, kh, kw]``
  (reversing all axes would swap time and frequency);
- BatchNorm ``scale``/``bias``, PReLU ``alpha``, every bias, the loss
  head's ``output_kernel`` [D, C] and the leaves above: copied as they are.

An array the converter does not consume, a missing one, or one of the wrong
shape raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .models.tdnn import EntireNetwork

_BATCH_STATS = ("mean", "var")


def jax_path(name: str) -> Tuple[str, ...]:
    """'tdnn.tdnn1_conv.weight' -> ('params', 'tdnn', 'tdnn1_conv', 'kernel')."""
    *modules, leaf = name.split(".")
    collection = "batch_stats" if leaf in _BATCH_STATS else "params"
    return (collection, *modules, "kernel" if leaf == "weight" else leaf)


def jax_name(name: str) -> str:
    """The JAX package's name of a module tensor, its path without the
    collection: 'network.tdnn.tdnn1_conv.weight' ->
    'network/tdnn/tdnn1_conv/kernel', 'network.tdnn.tdnn1_bn.mean' ->
    'network/tdnn/tdnn1_bn/mean' (what ``noupdate_var_list`` and
    ``noload_var_list`` substrings are matched against)."""
    return "/".join(jax_path(name)[1:])


def to_jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A module tensor in the JAX layout, as a contiguous CPU copy."""
    t = t.detach().cpu()
    if name.endswith(".weight"):
        t = t.permute(2, 3, 1, 0) if t.dim() == 4 else t.permute(*reversed(range(t.dim())))
    return t.contiguous().clone()


def from_jax_layout(name: str, v: Any) -> torch.Tensor:
    """A JAX array (numpy or tensor) in the module's layout, on the CPU."""
    t = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
    if name.endswith(".weight"):
        t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.permute(*reversed(range(t.dim())))
    return t


def flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _insert(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def tree_from_named(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, Any]:
    """Module-named tensors as a JAX tree with collections
    ({"params": ..., "batch_stats": ...}), contiguous CPU copies."""
    tree: Dict[str, Any] = {}
    for name, t in named:
        _insert(tree, jax_path(name), to_jax_layout(name, t))
    return tree


def named_from_tree(tree: Dict[str, Any], refs: Dict[str, torch.Tensor],
                    what: str = "variables") -> Dict[str, torch.Tensor]:
    """The tensors of ``tree`` (a JAX tree with collections) for each name
    of ``refs``, in the module layout and the reference's dtype; raises on a
    missing, a misshapen or an unconsumed array."""
    flat = flatten(tree)
    out = {}
    for name, ref in refs.items():
        path = jax_path(name)
        if path not in flat:
            raise KeyError("%s hold no %s (for %s)" % (what, "/".join(path), name))
        t = from_jax_layout(name, flat.pop(path))
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError("%s: shape %s does not fit %s %s" % (
                "/".join(path), tuple(t.shape), name, tuple(ref.shape)))
        out[name] = t.to(ref.dtype).contiguous()
    if flat:
        raise ValueError("%s not consumed: %s" % (what, sorted("/".join(p) for p in flat)))
    return out


def variables_of(module: nn.Module) -> Dict[str, Any]:
    """The JAX variable tree of ``module`` as contiguous CPU tensors."""
    return tree_from_named(module.state_dict().items())


def load_variables(module: nn.Module, variables: Dict[str, Any]) -> None:
    """Copy a JAX variable tree (numpy arrays or CPU tensors) into
    ``module``; every array must be consumed."""
    refs = module.state_dict()
    module.load_state_dict(named_from_tree(variables, refs, "variables"))


# network_type -> the first conv kernel [k, in, out], which carries the
# input width; ResNet34's stem [3, 3, 1, C] does not
_FIRST_KERNEL = {"tdnn": ("params", "tdnn", "tdnn1_conv", "kernel"),
                 "ecapa_tdnn": ("params", "ecapa", "conv1", "kernel")}


def network_from_variables(
    variables: Dict[str, Any], config: Dict[str, Any], network_type: str = "tdnn",
    input_dim: Optional[int] = None,
) -> EntireNetwork:
    """Build an eval-mode float32 :class:`EntireNetwork` on the CPU from the
    JAX variable tree (numpy arrays or CPU tensors). The input width is
    ``input_dim`` (a model dir's ``feature_dim``) where given, else the
    first conv kernel's (required for ResNet34)."""
    if input_dim is None:
        first = _FIRST_KERNEL.get(network_type)
        if first is None:
            raise ValueError("network_type %r needs input_dim (the model dir's feature_dim)"
                             % network_type)
        flat = flatten(variables)
        if first not in flat:
            raise KeyError("variables hold no %s" % "/".join(first))
        input_dim = int(np.shape(flat[first])[1])
    net = EntireNetwork(config, int(input_dim), network_type)
    load_variables(net, variables)
    return net.eval()


def variables_from_network(net: EntireNetwork) -> Dict[str, Any]:
    """The JAX variable tree of ``net`` as contiguous CPU tensors."""
    return variables_of(net)
