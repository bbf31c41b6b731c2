"""Kaldi compressed-matrix dequantization on the GPU.

Counterpart of ``tf_kaldi_speaker_tpu/ops/cm_dequant_pallas.py``: the host
ships raw uint8 codes plus per-column percentile headers (1 byte per element
instead of 4) and the device applies Kaldi's piecewise-linear CharToFloat
map. The CUDA kernel is ``csrc/cm_dequant.cu``.

Batch layout: codes [B, L, D] uint8, headers [B, 4, D] float32 (p0, p25,
p75, p100 per utterance column) -> [B, L, D] float32.
"""

from __future__ import annotations

import torch

from . import _build


def cm_dequantize_plain(codes: torch.Tensor, headers: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same expression order)."""
    c = codes.to(torch.float32)
    p = headers[:, :, None, :]  # [B, 4, 1, D]
    p0, p25, p75, p100 = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    lo = p0 + (p25 - p0) * (c / 64.0)
    mid = p25 + (p75 - p25) * ((c - 64.0) / 128.0)
    hi = p75 + (p100 - p75) * ((c - 192.0) / 63.0)
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
    out = torch.empty((b, l, d), dtype=torch.float32, device=codes.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tfks_cm_dequantize(
            codes.data_ptr(), headers.data_ptr(), out.data_ptr(), b, l, d, stream)
    _build.check(err, "cm_dequantize")
    cm_dequantize.launches += 1
    return out


cm_dequantize.launches = 0
