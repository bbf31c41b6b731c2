"""Offline audio augmentation: reverberation and additive noise.

Counterpart of ``tf_kaldi_speaker_tpu/data/augment.py``. ``_power``,
``reverberate``, ``add_noise`` and ``add_babble`` are numpy copies, bit-equal
to the originals (the recipe's MUSAN/RIRS stage; reference run.sh:82-114).

:func:`reverberate_torch` is the batched counterpart of ``reverberate``: a
padded float64 batch of signals and one of RIRs, convolved through one
real FFT per batch on whatever device the tensors are on. It computes, row
by row, what ``reverberate`` computes (RIR scaled by its own peak, output
shifted by the first argmax of ``|rir|``, power-normalized to the input);
``np.convolve`` is a direct O(N * M) product on one host core.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def _power(x: np.ndarray) -> float:
    return float(np.mean(np.square(x))) + 1e-20


def reverberate(signal: np.ndarray, rir: np.ndarray, shift_output: bool = True) -> np.ndarray:
    """Convolve with an RIR, keep the input's duration and power.

    wav-reverberate semantics: output is shifted so the direct path (RIR
    peak) aligns with the input, then power-normalized to the input level.
    """
    signal = np.asarray(signal, np.float64)
    rir = np.asarray(rir, np.float64)
    rir = rir / (np.max(np.abs(rir)) + 1e-20)
    out = np.convolve(signal, rir)
    if shift_output:
        peak = int(np.argmax(np.abs(rir)))
        out = out[peak : peak + len(signal)]
    else:
        out = out[: len(signal)]
    out = out * np.sqrt(_power(signal) / _power(out))
    return out


def add_noise(
    signal: np.ndarray,
    noise: np.ndarray,
    snr_db: float,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Mix one noise at the given SNR; noise is looped/cropped to length."""
    rng = rng or np.random
    signal = np.asarray(signal, np.float64)
    noise = np.asarray(noise, np.float64)
    if len(noise) < len(signal):
        reps = int(np.ceil(len(signal) / len(noise)))
        noise = np.tile(noise, reps)
    start = rng.randint(0, len(noise) - len(signal) + 1)
    noise = noise[start : start + len(signal)]
    scale = np.sqrt(_power(signal) / (_power(noise) * (10.0 ** (snr_db / 10.0))))
    return signal + scale * noise


def add_babble(
    signal: np.ndarray,
    speakers: List[np.ndarray],
    snr_db: float,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """MUSAN-style babble: sum of 3-7 speech signals mixed at one SNR."""
    rng = rng or np.random
    mix = np.zeros(len(signal))
    for s in speakers:
        s = np.asarray(s, np.float64)
        if len(s) < len(signal):
            s = np.tile(s, int(np.ceil(len(signal) / len(s))))
        start = rng.randint(0, len(s) - len(signal) + 1)
        mix += s[start : start + len(signal)]
    return add_noise(signal, mix, snr_db, rng)


def fast_fft_length(n: int) -> int:
    """The smallest 2^a 3^b 5^c >= n (a length every FFT library factors
    into small radices)."""
    best = 1 << max(0, int(n - 1).bit_length())
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            m = p35
            while m < n:
                m *= 2
            best = min(best, m)
            p35 *= 3
        p5 *= 5
    return best


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum of each row of ``x`` [B, T] (``np.argmax``'s
    tie rule, whatever the device's reduction order)."""
    idx = torch.arange(x.shape[1], device=x.device).expand_as(x)
    at_max = x == x.max(dim=1, keepdim=True).values
    return torch.where(at_max, idx, x.shape[1]).min(dim=1).values


def reverberate_torch(signals: torch.Tensor, sig_lens: torch.Tensor, rirs: torch.Tensor,
                      rir_lens: torch.Tensor) -> torch.Tensor:
    """``reverberate`` (``shift_output=True``) of each row, batched.

    ``signals`` [B, Ts] and ``rirs`` [B, Tr] are zero-padded float64 rows
    on one device, ``sig_lens`` and ``rir_lens`` [B] their valid lengths.
    Each RIR is scaled by its own ``max|rir| + 1e-20``; the linear
    convolution goes through ``torch.fft.rfft``/``irfft`` at one fast
    length of at least ``max(sig_lens) + max(rir_lens) - 1``; row b keeps
    ``[peak_b : peak_b + sig_lens[b]]`` at the first argmax of its scaled
    ``|rir|``, and is normalized to its input's power over its own valid
    samples. Returns [B, max(sig_lens)] float64, zero past each row's
    length. Stay in float64: a float32 FFT is about 1e-7 relative, which
    flips int16 truncations in the written wavs."""
    if signals.dtype != torch.float64 or rirs.dtype != torch.float64:
        raise TypeError("reverberate_torch takes float64 signals and RIRs")
    dev = signals.device
    sig_lens = sig_lens.to(dev, torch.int64)
    rir_lens = rir_lens.to(dev, torch.int64)
    B = signals.shape[0]
    ts = int(sig_lens.max()) if B else 0
    tr = int(rir_lens.max()) if B else 0
    t = torch.arange(ts, device=dev)
    valid = t[None, :] < sig_lens[:, None]
    signals = torch.where(valid, signals[:, :ts], 0.0)
    rir_valid = torch.arange(tr, device=dev)[None, :] < rir_lens[:, None]
    rirs = torch.where(rir_valid, rirs[:, :tr], 0.0)
    peak_abs = torch.abs(rirs).max(dim=1, keepdim=True).values
    rirs = rirs / (peak_abs + 1e-20)
    # padding is 0, which is never above a row's peak; a padded sample can
    # only tie an all-zero row, whose first argmax is 0 either way
    peak = _first_argmax(torch.where(rir_valid, torch.abs(rirs), -1.0))
    n = fast_fft_length(ts + tr - 1)
    full = torch.fft.irfft(torch.fft.rfft(signals, n) * torch.fft.rfft(rirs, n), n)
    out = torch.gather(full, 1, peak[:, None] + t[None, :])
    out = torch.where(valid, out, 0.0)
    count = sig_lens.to(torch.float64).clamp_min(1.0)
    p_sig = torch.sum(signals * signals, dim=1) / count + 1e-20
    p_out = torch.sum(out * out, dim=1) / count + 1e-20
    return out * torch.sqrt(p_sig / p_out)[:, None]
