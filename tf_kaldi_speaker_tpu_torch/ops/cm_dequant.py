"""Kaldi compressed-matrix dequantization on the GPU.

Counterpart of ``tf_kaldi_speaker_tpu/ops/cm_dequant_pallas.py``: the host
ships raw uint8 codes plus per-column percentile headers (1 byte per element
instead of 4) and the device applies Kaldi's piecewise-linear CharToFloat
map. The CUDA kernel is ``csrc/cm_dequant.cu``.

Batch layout: codes [B, L, D] uint8, headers [B, 4, D] float32 (p0, p25,
p75, p100 per utterance column) -> [B, L, D] float32.
"""

from __future__ import annotations

import collections

import torch

from . import _build


def cm_dequantize_plain(codes: torch.Tensor, headers: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same expression order, each
    operation rounded once, so bit-equal to the kernel and the host codec).

    The divisors are tensors on the codes' device: on CUDA, PyTorch divides
    by a Python scalar as a product with its reciprocal, and 1/63 is not
    exact; near a zero crossing that ulp of the product is the whole value."""
    c = codes.to(torch.float32)
    p = headers[:, :, None, :]  # [B, 4, 1, D]
    p0, p25, p75, p100 = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    n64, n128, n63 = torch.tensor([64.0, 128.0, 63.0], device=c.device).unbind()
    lo = p0 + (p25 - p0) * (c / n64)
    mid = p25 + (p75 - p25) * ((c - 64.0) / n128)
    hi = p75 + (p100 - p75) * ((c - 192.0) / n63)
    return torch.where(c <= 64.0, lo, torch.where(c <= 192.0, mid, hi))


def cm_dequantize(codes: torch.Tensor, headers: torch.Tensor) -> torch.Tensor:
    """[B, L, D] uint8 + [B, 4, D] float32 -> [B, L, D] float32.

    CPU tensors take :func:`cm_dequantize_plain`; CUDA tensors launch the
    kernel, and anything the kernel does not take raises."""
    if codes.device.type == "cpu" and headers.device.type == "cpu":
        return cm_dequantize_plain(codes, headers)
    if codes.device.type != "cuda" or headers.device != codes.device:
        raise ValueError("cm_dequantize: codes (%s) and headers (%s) must be "
                         "on one CUDA device" % (codes.device, headers.device))
    if codes.dtype != torch.uint8 or headers.dtype != torch.float32:
        raise TypeError("cm_dequantize: needs uint8 codes and float32 headers, "
                        "got %s and %s" % (codes.dtype, headers.dtype))
    if codes.dim() != 3:
        raise ValueError("cm_dequantize: codes must be [B, L, D], got %s"
                         % tuple(codes.shape))
    b, l, d = codes.shape
    if tuple(headers.shape) != (b, 4, d):
        raise ValueError("cm_dequantize: headers must be [%d, 4, %d], got %s"
                         % (b, d, tuple(headers.shape)))
    if not (codes.is_contiguous() and headers.is_contiguous()):
        raise ValueError("cm_dequantize: inputs must be contiguous")
    if b > 65535 or l * d >= 2 ** 31 - 2 ** 12:
        raise ValueError("cm_dequantize: at most 65535 utterances of under "
                         "2^31 - 2^12 codes each, got %s" % (tuple(codes.shape),))
    out = torch.empty((b, l, d), dtype=torch.float32, device=codes.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tfks_cm_dequantize(
            codes.data_ptr(), headers.data_ptr(), out.data_ptr(), b, l, d, stream)
    _build.check(err, "cm_dequantize")
    _build.count_launch(cm_dequantize, (b, l, d), "uint8")
    return out


# Kernel launches, and launches by ((B, L, D), codes dtype name), counted
# where the kernel is launched; chip_smoke.py reads both after the main path.
cm_dequantize.launches = 0
cm_dequantize.shapes = collections.Counter()
