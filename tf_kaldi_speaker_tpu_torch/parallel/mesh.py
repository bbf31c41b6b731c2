"""The (data, model) mesh over the ranks, and the collectives the port needs.

Counterpart of ``tf_kaldi_speaker_tpu/parallel/mesh.py``. A JAX mesh
reshapes the device list row-major into ``(data, model)``; here the ranks
are laid out the same way: rank = data index * ``model_parallel`` + model
index. The *data group* of a rank holds the ranks of its model index (they
see disjoint rows of the global batch; the batch axis is sharded over
them), the *model group* the ``model_parallel`` consecutive ranks of its
data index (they see the same rows and hold column blocks of the speaker
softmax). Under pjit XLA inserts the cross-replica reductions; here each is
an explicit collective.

Every collective is an all-reduce: a collective that ``gloo`` also runs
on CUDA tensors, so two ranks can share one card. Each
differentiable one states its backward rule:

- :func:`all_reduce`: the sum over the group; backward, the sum of the
  incoming gradients over the group (the adjoint). Right where each rank's
  objective is its own part of a total that is summed over the group (the
  data group: each rank's objective is its share of the global loss).
- :func:`reduce_replicated`: the sum; backward, the incoming gradient as it
  is. Right where every rank of the group computes the same value from the
  sum (the model group: every model rank computes the same loss), so the
  gradient is already whole on each.
- :func:`copy_to_group`: the identity; backward, the sum over the group.
  For a replicated tensor that each rank multiplies by its own block (the
  embeddings against a column block of the kernel).
- :func:`all_gather` / :func:`gather_replicated`: built from those two over
  zero-padded slots.

``torch.distributed.nn.functional`` is not used: it is deprecated, and its
all-reduce always sums the incoming gradient, which scales gradients by
the group size where every rank computes the same loss.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .distributed import host_shard_info

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """The process-group counterpart of a ``(data[, model])`` JAX mesh over
    every rank of the process group (one rank, no groups, without one).
    ``data_group`` / ``model_group`` are None where the axis has one rank:
    the collectives below are then the identity and launch nothing."""

    def __init__(self, model_parallel: int = 1):
        rank, world = host_shard_info()
        mp = int(model_parallel)
        if mp < 1 or world % mp:
            raise ValueError("model_parallel=%d must divide the %d ranks" % (mp, world))
        self.rank, self.world = rank, world
        self.model_size, self.data_size = mp, world // mp
        self.data_rank, self.model_rank = divmod(rank, mp)
        self.shape = {DATA_AXIS: self.data_size, MODEL_AXIS: mp}
        self.data_group = self.model_group = None
        self.backend = dist.get_backend() if dist.is_initialized() else None
        if world == 1:
            return
        whole = dist.group.WORLD
        # new_group is collective: every rank creates every group, in one order.
        for m in range(mp):
            ranks = [d * mp + m for d in range(self.data_size)]
            g = (whole if mp == 1 else dist.new_group(ranks)) if self.data_size > 1 else None
            if m == self.model_rank:
                self.data_group = g
        for d in range(self.data_size):
            ranks = list(range(d * mp, (d + 1) * mp))
            g = (whole if self.data_size == 1 else dist.new_group(ranks)) if mp > 1 else None
            if d == self.data_rank:
                self.model_group = g

    def flag_device(self, device) -> torch.device:
        """Where a host value (a stop flag, a barrier token) goes for a
        collective: the CPU under gloo, the card under NCCL."""
        return torch.device("cpu") if self.backend != "nccl" else torch.device(device)

    def any(self, flag: bool, device) -> bool:
        """Whether ``flag`` is set on any rank (an all-reduce MAX)."""
        if self.world == 1:
            return bool(flag)
        t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=self.flag_device(device))
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())


def make_mesh(model_parallel: int = 1) -> Mesh:
    """The mesh over the process group's ranks (``make_mesh`` over every
    device)."""
    return Mesh(model_parallel)


def pad_batch_to_devices(batch_size: int, mesh: Mesh) -> int:
    """Smallest batch size >= batch_size divisible by the data axis."""
    n = mesh.data_size
    return ((batch_size + n - 1) // n) * n


def _reduced(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y


class _AllReduce(torch.autograd.Function):
    """Sum over the group; backward: the sum of the incoming gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduced(grad, ctx.group), None


class _ReduceReplicated(torch.autograd.Function):
    """Sum over the group; backward: the incoming gradient as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToGroup(torch.autograd.Function):
    """The identity; backward: the sum of the incoming gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduced(grad, ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduce.apply(x, group)


def reduce_replicated(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceReplicated.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the group, without gradient."""
    return x.detach() if group is None else _reduced(x, group, dist.ReduceOp.MAX)


def all_reduce_min(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise min over the group, without gradient."""
    return x.detach() if group is None else _reduced(x, group, dist.ReduceOp.MIN)


def _slots(x: torch.Tensor, index: int, size: int, dim: int) -> torch.Tensor:
    """``x`` in slot ``index`` of ``size`` along ``dim``, zeros elsewhere."""
    zeros = torch.zeros_like(x)
    return torch.cat([x if i == index else zeros for i in range(size)], dim=dim)


def all_gather(x: torch.Tensor, group, index: int, size: int, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order (every
    rank's ``x`` of one shape), as an all-reduce of zero-padded slots;
    backward: each rank's slot of the summed incoming gradient (the adjoint,
    for the data group)."""
    if group is None:
        return x
    return all_reduce(_slots(x, index, size, dim), group)


def gather_replicated(x: torch.Tensor, group, index: int, size: int,
                      dim: int = 0) -> torch.Tensor:
    """As :func:`all_gather`, for a value every rank of the group computes
    the same thing from (the model group): backward, the rank's own slot
    of its incoming gradient."""
    if group is None:
        return x
    return reduce_replicated(_slots(x, index, size, dim), group)
