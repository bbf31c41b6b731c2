"""Parameter sharding rules: the model-parallel speaker softmax.

Counterpart of ``tf_kaldi_speaker_tpu/parallel/sharding_rules.py``: the
trunk is replicated; the classification kernel ``softmax/output_kernel``
[D, C] is split into column blocks over the model group and
``softmax/output_bias`` [C] with it (``model_parallel`` > 1). JAX's rule
matches a substring of the variable path, so the multitask heads
(``spk_softmax``, ``phn_softmax``) are split as well. The optimizer state
follows its parameter.

JAX refuses a device placement whose sharded dimension does not divide the
mesh axis (``jax.device_put`` of a NamedSharding); so does
:func:`shard_model`: the speaker count must divide ``model_parallel``.

Checkpoints hold the whole arrays in the JAX layout whatever the mesh:
:func:`gather_named` joins the blocks before a save, :func:`split_named`
cuts them after a load.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from .mesh import Mesh, gather_replicated

# (path substring, the dimension split over the model axis) in the JAX
# layout; first match wins, the rest is replicated
DEFAULT_RULES: List[Tuple[str, int]] = [
    ("softmax/output_kernel", 1),
    ("softmax/output_bias", 0),
]


def sharded_dim(path: str, mesh: Mesh, rules=None) -> Optional[int]:
    """The dimension of the JAX-named array ``path`` split over the model
    axis, or None (replicated)."""
    if mesh.model_size > 1:
        for sub, dim in rules or DEFAULT_RULES:
            if sub in path:
                return dim
    return None


def _block(t: torch.Tensor, dim: int, mesh: Mesh, path: str) -> torch.Tensor:
    n = t.shape[dim]
    if n % mesh.model_size:
        raise ValueError("%s: dimension %d of size %d does not divide model_parallel=%d"
                         % (path, dim, n, mesh.model_size))
    step = n // mesh.model_size
    return t.narrow(dim, mesh.model_rank * step, step).contiguous()


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Place ``model`` on the mesh, in place: every BatchNorm takes its
    train-mode statistics over the data group, every loss head gathers its
    rows over the data group and knows its column block, and the tensors
    the rules name keep only this rank's block (drawn whole first, so a
    seed gives the weights of ``model_parallel`` = 1)."""
    from .. import convert
    from ..losses.head import LossHead
    from ..models.layers import BatchNorm

    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.group = mesh.data_group
        if isinstance(module, LossHead):
            module.mesh = mesh if mesh.world > 1 else None
    if mesh.model_size > 1:
        for name, tensor in list(model.state_dict(keep_vars=True).items()):
            path = convert.jax_name(name)
            dim = sharded_dim(path, mesh)
            if dim is None:
                continue
            owner, _, leaf = name.rpartition(".")
            sub = model.get_submodule(owner)
            block = _block(tensor.detach(), dim, mesh, path)
            if isinstance(tensor, nn.Parameter):
                setattr(sub, leaf, nn.Parameter(block))
            else:
                sub.register_buffer(leaf, block)
    return model


def gather_named(named: Dict[str, torch.Tensor], mesh: Mesh,
                 device="cpu") -> Dict[str, torch.Tensor]:
    """{JAX path: array in the JAX layout}: the sharded arrays joined whole
    (a collective over the model group on ``device``, where the backend
    reduces: every rank calls it, in one order) and returned where they
    were; the rest as they are."""
    out = {}
    for path in sorted(named):
        t = named[path]
        dim = sharded_dim(path, mesh)
        if dim is not None:
            with torch.no_grad():
                t = gather_replicated(t.to(device), mesh.model_group, mesh.model_rank,
                                      mesh.model_size, dim=dim).to(t.device)
        out[path] = t
    return {path: out[path] for path in named}


def split_named(named: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """{JAX path: whole array}: the sharded arrays cut to this rank's block."""
    out = {}
    for path, t in named.items():
        dim = sharded_dim(path, mesh)
        out[path] = t if dim is None else _block(t, dim, mesh, path)
    return out


def gather_tree(tree, mesh: Mesh, device="cpu"):
    """:func:`gather_named` over a nested JAX tree."""
    return _map_tree(tree, mesh, lambda named, m: gather_named(named, m, device))


def split_tree(tree, mesh: Mesh):
    """:func:`split_named` over a nested JAX tree."""
    return _map_tree(tree, mesh, split_named)


def _map_tree(tree, mesh: Mesh, fn):
    from .. import convert

    if mesh.model_size == 1:
        return tree
    mapped = fn({"/".join(p): v for p, v in convert.flatten(tree).items()
                 if isinstance(v, torch.Tensor)}, mesh)

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(v, prefix + (str(k),)) for k, v in node.items()}
        return mapped.get("/".join(prefix), node)

    return rebuild(tree, ())
