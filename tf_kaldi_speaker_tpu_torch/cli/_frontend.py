"""Shared plumbing of the CLIs: the device check every CLI that runs on a
device goes through (:func:`device_or_raise`, which also turns TF32 off),
and, for the front-end CLIs (``make_mfcc``, ``compute_vad``,
``prepare_feats``), batches in input order and zero-padded host batches."""

from __future__ import annotations

import itertools
from typing import Iterable, Iterator, List, Sequence, Tuple, TypeVar

import numpy as np
import torch

T = TypeVar("T")


def no_tf32() -> None:
    """Float32 matmuls and cuDNN convolutions in float32. PyTorch lets cuDNN
    use TF32 by default, whose 10-bit mantissas put a float32 model's
    outputs outside the port's parity bounds against the CPU; the flags
    are process-wide, so a CLI sets them and library classes do not."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def device_or_raise(name) -> torch.device:
    """``torch.device(name)``, with TF32 off (:func:`no_tf32`); a CUDA
    device must exist, so a missing card raises here instead of the work
    going on on the CPU. Every CLI that runs on a device picks it here."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device %s: no CUDA device (torch.cuda.is_available() is False); "
                           "pass --device cpu to run on the host" % name)
    no_tf32()
    return device


def batches(items: Iterable[T], size: int) -> Iterator[List[T]]:
    """``items`` in input order, ``size`` at a time (the last batch may be
    shorter)."""
    it = iter(items)
    while True:
        batch = list(itertools.islice(it, size))
        if not batch:
            return
        yield batch


def pad_rows(rows: Sequence[np.ndarray], dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Stack [T_b, ...] arrays into a zero-padded [B, max T_b, ...] array of
    ``dtype``; returns it with the lengths [B] (int64)."""
    lengths = np.array([r.shape[0] for r in rows], np.int64)
    out = np.zeros((len(rows), int(lengths.max(initial=0))) + rows[0].shape[1:], dtype)
    for b, r in enumerate(rows):
        out[b, :r.shape[0]] = r
    return out, lengths
