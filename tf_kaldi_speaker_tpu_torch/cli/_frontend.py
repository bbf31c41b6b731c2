"""Shared plumbing of the front-end CLIs (``make_mfcc``, ``compute_vad``,
``prepare_feats``): the device check, batches in input order, and
zero-padded host batches."""

from __future__ import annotations

import itertools
from typing import Iterable, Iterator, List, Sequence, Tuple, TypeVar

import numpy as np
import torch

T = TypeVar("T")


def device_or_raise(name: str) -> torch.device:
    """``torch.device(name)``; a CUDA device must exist, so a missing card
    raises here instead of the work going on on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device %s: no CUDA device (torch.cuda.is_available() is False); "
                           "pass --device cpu to run on the host" % name)
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
