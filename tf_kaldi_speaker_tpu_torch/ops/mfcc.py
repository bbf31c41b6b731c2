"""MFCC front end (Kaldi compute-mfcc-feats equivalent).

Counterpart of ``tf_kaldi_speaker_tpu/ops/mfcc.py``. Kaldi conventions:
25 ms povey-windowed frames every 10 ms with snipped edges, DC removal,
dither, pre-emphasis 0.97, power spectrum, mel filter bank, DCT-II (ortho),
cepstral liftering, C0 replaced by raw log-energy.

``MfccConfig`` through ``mfcc`` are the numpy code of the JAX package,
copied (``tests/test_torch_frontend.py`` holds them bit-equal to it).
``mfcc_torch`` is the counterpart of ``mfcc_jax``: the same arithmetic on a
padded batch of waveforms in plain torch (``torch.fft.rfft`` and matmuls),
on whatever device the batch lives on, in the batch's dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass
class MfccConfig:
    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_ceps: int = 30
    num_mel_bins: int = 30
    low_freq: float = 20.0
    high_freq: float = 7600.0       # VoxCeleb mfcc.conf; 3700 for 8 kHz SRE
    preemphasis: float = 0.97
    dither: float = 1.0             # in 16-bit integer units, like Kaldi
    remove_dc_offset: bool = True
    use_energy: bool = True
    raw_energy: bool = True
    cepstral_lifter: float = 22.0
    window_type: str = "povey"
    snip_edges: bool = True
    energy_floor: float = 0.0

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def fft_size(self) -> int:
        n = 1
        while n < self.frame_length:
            n *= 2
        return n


def _window(cfg: MfccConfig) -> np.ndarray:
    n = cfg.frame_length
    a = 2.0 * np.pi / (n - 1)
    i = np.arange(n)
    if cfg.window_type == "povey":
        return (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    if cfg.window_type == "hamming":
        return 0.54 - 0.46 * np.cos(a * i)
    if cfg.window_type == "hanning":
        return 0.5 - 0.5 * np.cos(a * i)
    if cfg.window_type == "rectangular":
        return np.ones(n)
    raise ValueError(cfg.window_type)


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq) / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(np.asarray(mel) / 1127.0) - 1.0)


def mel_banks(cfg: MfccConfig) -> np.ndarray:
    """[num_mel_bins, fft_size//2+1] triangular filters (Kaldi MelBanks)."""
    nfft = cfg.fft_size
    num_bins = cfg.num_mel_bins
    high = cfg.high_freq if cfg.high_freq > 0 else cfg.sample_rate / 2 + cfg.high_freq
    mel_low, mel_high = mel_scale(cfg.low_freq), mel_scale(high)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    fft_freqs = np.arange(nfft // 2 + 1) * (cfg.sample_rate / nfft)
    mel_f = mel_scale(fft_freqs)  # [F]
    banks = np.zeros((num_bins, nfft // 2 + 1))
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = left + mel_delta
        right = center + mel_delta
        up = (mel_f - left) / (center - left)
        down = (right - mel_f) / (right - center)
        banks[b] = np.maximum(0.0, np.minimum(up, down))
    return banks


def dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """Orthonormal DCT-II [num_ceps, num_bins]."""
    m = np.zeros((num_ceps, num_bins))
    m[0] = np.sqrt(1.0 / num_bins)
    for k in range(1, num_ceps):
        m[k] = np.sqrt(2.0 / num_bins) * np.cos(
            np.pi * k * (np.arange(num_bins) + 0.5) / num_bins
        )
    return m


def lifter_coeffs(cfg: MfccConfig) -> np.ndarray:
    if cfg.cepstral_lifter == 0:
        return np.ones(cfg.num_ceps)
    q = cfg.cepstral_lifter
    return 1.0 + 0.5 * q * np.sin(np.pi * np.arange(cfg.num_ceps) / q)


def frame_signal(wav: np.ndarray, cfg: MfccConfig) -> np.ndarray:
    """[T] -> [num_frames, frame_length] with snipped edges."""
    n, shift = cfg.frame_length, cfg.frame_shift
    if len(wav) < n:
        return np.zeros((0, n), np.float64)
    num = 1 + (len(wav) - n) // shift
    idx = np.arange(n)[None, :] + shift * np.arange(num)[:, None]
    return np.asarray(wav, np.float64)[idx]


def mfcc(wav: np.ndarray, cfg: MfccConfig = MfccConfig(), seed: int = 0) -> np.ndarray:
    """[T] samples (int16 range) -> [num_frames, num_ceps] float32."""
    frames = frame_signal(wav, cfg)
    if frames.shape[0] == 0:
        return np.zeros((0, cfg.num_ceps), np.float32)
    if cfg.dither > 0:
        rng = np.random.RandomState(seed)
        frames = frames + cfg.dither * rng.randn(*frames.shape)
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if cfg.use_energy and cfg.raw_energy:
        energy = np.maximum((frames**2).sum(axis=1), np.finfo(np.float64).tiny)
        log_energy = np.log(energy)
    if cfg.preemphasis > 0:
        pre = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - cfg.preemphasis * pre
    frames = frames * _window(cfg)[None, :]
    if cfg.use_energy and not cfg.raw_energy:
        energy = np.maximum((frames**2).sum(axis=1), np.finfo(np.float64).tiny)
        log_energy = np.log(energy)

    spec = np.abs(np.fft.rfft(frames, n=cfg.fft_size, axis=1)) ** 2
    mel_e = spec @ mel_banks(cfg).T
    mel_e = np.log(np.maximum(mel_e, np.finfo(np.float64).tiny))
    ceps = mel_e @ dct_matrix(cfg.num_ceps, cfg.num_mel_bins).T
    ceps = ceps * lifter_coeffs(cfg)[None, :]
    if cfg.use_energy:
        if cfg.energy_floor > 0:
            log_energy = np.maximum(log_energy, np.log(cfg.energy_floor))
        ceps[:, 0] = log_energy
    return ceps.astype(np.float32)


def num_frames(length: int, cfg: MfccConfig) -> int:
    """Frames of a ``length``-sample waveform with snipped edges."""
    if length < cfg.frame_length:
        return 0
    return 1 + (length - cfg.frame_length) // cfg.frame_shift


def mfcc_torch(
    wavs: torch.Tensor,
    lengths: torch.Tensor,
    cfg: MfccConfig = MfccConfig(),
    noise: Optional[Sequence] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched MFCC: [B, T] waveforms (int16 range, padded) with valid
    lengths [B] -> ([B, F, num_ceps], frame counts [B] int64).

    Row b has exactly ``num_frames(lengths[b])`` frames, taken from its own
    samples only; frames past that count are zero. The arithmetic is
    :func:`mfcc`'s, in ``wavs``' dtype (float64 reproduces numpy to rounding)
    and on its device. ``noise`` is the dither already drawn: one
    [F_b, frame_length] block of standard normal draws per row (numpy or
    torch), scaled by ``cfg.dither`` and added to the frames as :func:`mfcc`
    adds ``rng.randn(F_b, n)``; without it no dither is applied, as in
    ``mfcc_jax``."""
    n, shift = cfg.frame_length, cfg.frame_shift
    b = wavs.shape[0]
    dtype, device = wavs.dtype, wavs.device
    counts = [num_frames(int(x), cfg) for x in lengths.tolist()]
    f = max(counts, default=0)
    counts_t = torch.tensor(counts, dtype=torch.int64, device=device)
    if f == 0:
        return wavs.new_zeros((b, 0, cfg.num_ceps)), counts_t
    idx = (torch.arange(n, device=device)[None, :]
           + shift * torch.arange(f, device=device)[:, None])
    frames = wavs[:, idx]  # [B, F, n]
    valid = torch.arange(f, device=device)[None, :] < counts_t[:, None]
    if noise is not None and cfg.dither > 0:
        blocks = [torch.as_tensor(x) for x in noise]
        for x, c in zip(blocks, counts):
            if tuple(x.shape) != (c, n):
                raise ValueError("mfcc_torch: noise block %s for %d frames of %d samples"
                                 % (tuple(x.shape), c, n))
        drawn = torch.cat(blocks).to(device=device, dtype=dtype)
        frames[valid] = frames[valid] + cfg.dither * drawn
    tiny = torch.finfo(dtype).tiny
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=2, keepdim=True)
    if cfg.use_energy and cfg.raw_energy:
        log_energy = torch.log(torch.clamp_min((frames ** 2).sum(dim=2), tiny))
    if cfg.preemphasis > 0:
        pre = torch.cat([frames[:, :, :1], frames[:, :, :-1]], dim=2)
        frames = frames - cfg.preemphasis * pre
    frames = frames * torch.as_tensor(_window(cfg), dtype=dtype, device=device)
    if cfg.use_energy and not cfg.raw_energy:
        log_energy = torch.log(torch.clamp_min((frames ** 2).sum(dim=2), tiny))

    spec = torch.fft.rfft(frames, n=cfg.fft_size, dim=2).abs() ** 2
    banks = torch.as_tensor(mel_banks(cfg), dtype=dtype, device=device)
    mel_e = torch.log(torch.clamp_min(spec @ banks.T, tiny))
    dct = torch.as_tensor(dct_matrix(cfg.num_ceps, cfg.num_mel_bins), dtype=dtype,
                          device=device)
    ceps = (mel_e @ dct.T) * torch.as_tensor(lifter_coeffs(cfg), dtype=dtype, device=device)
    if cfg.use_energy:
        if cfg.energy_floor > 0:
            log_energy = torch.clamp_min(log_energy, float(np.log(cfg.energy_floor)))
        ceps[:, :, 0] = log_energy
    return torch.where(valid[:, :, None], ceps, 0.0), counts_t
