"""Layout conversion between the JAX variable tree and the port's modules.

The JAX package keeps a network's variables as a nested tree,
``{"params": {"tdnn": {...}}, "batch_stats": {"tdnn": {...}}}``
(``extract/extractor.py:91-94``); the port keeps them in an
:class:`~tf_kaldi_speaker_tpu_torch.models.tdnn.EntireNetwork`. This module
is the only place where layouts change:

- conv kernel ``[k, in, out]`` <-> ``weight [out, in, k]``
- dense kernel ``[in, out]`` <-> ``weight [out, in]``
- BatchNorm ``scale``/``bias`` (params) and ``mean``/``var``
  (batch_stats), PReLU ``alpha`` and every bias: copied as they are.

Both reversals are "reverse all axes". An array the converter does not
consume, or one of the wrong shape, raises.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .models.tdnn import EntireNetwork

_BATCH_STATS = ("mean", "var")


def _jax_path(module_path: str) -> Tuple[str, ...]:
    """'tdnn1_conv.weight' -> ('params', 'tdnn', 'tdnn1_conv', 'kernel')."""
    module, leaf = module_path.split(".")
    collection = "batch_stats" if leaf in _BATCH_STATS else "params"
    return (collection, "tdnn", module, "kernel" if leaf == "weight" else leaf)


def _reverse_axes(t: torch.Tensor, leaf: str) -> torch.Tensor:
    return t.permute(*reversed(range(t.dim()))) if leaf == "weight" else t


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _as_tensor(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v))


def network_from_variables(
    variables: Dict[str, Any], config: Dict[str, Any], network_type: str = "tdnn"
) -> EntireNetwork:
    """Build an eval-mode float32 :class:`EntireNetwork` on the CPU from the
    JAX variable tree (numpy arrays or CPU tensors)."""
    flat = _flatten(variables)
    first = ("params", "tdnn", "tdnn1_conv", "kernel")
    if first not in flat:
        raise KeyError("variables hold no %s" % "/".join(first))
    net = EntireNetwork(config, int(np.shape(flat[first])[1]), network_type)
    state = {}
    for name, ref in net.tdnn.state_dict().items():
        path = _jax_path(name)
        if path not in flat:
            raise KeyError("variables hold no %s (for %s)" % ("/".join(path), name))
        t = _reverse_axes(_as_tensor(flat.pop(path)), name.split(".")[1])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError("%s: shape %s does not fit %s %s" % (
                "/".join(path), tuple(t.shape), name, tuple(ref.shape)))
        state[name] = t.to(torch.float32).contiguous()
    if flat:
        raise ValueError("variables not consumed by the %s network: %s" % (
            network_type, sorted("/".join(p) for p in flat)))
    net.tdnn.load_state_dict(state)
    return net.eval()


def variables_from_network(net: EntireNetwork) -> Dict[str, Any]:
    """The JAX variable tree of ``net`` as contiguous CPU tensors."""
    tree: Dict[str, Any] = {}
    for name, t in net.tdnn.state_dict().items():
        collection, top, module, leaf = _jax_path(name)
        t = _reverse_axes(t.detach().cpu(), name.split(".")[1]).contiguous().clone()
        tree.setdefault(collection, {}).setdefault(top, {}).setdefault(module, {})[leaf] = t
    return tree
