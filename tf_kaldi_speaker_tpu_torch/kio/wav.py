"""WAV I/O for Kaldi-style wav.scp entries (files or shell pipes).

Counterpart of ``tf_kaldi_speaker_tpu/kio/wav.py``, whole. Stdlib-only
PCM16 reader/writer; rxfilenames ending in '|' are executed as pipelines
(like Kaldi's extended filenames used throughout the recipes) through the
port's own ``rspecifier.popen``.
"""

from __future__ import annotations

import io
import wave
from typing import Iterator, Tuple

import numpy as np

from .rspecifier import popen


def read_wav(rxfilename: str) -> Tuple[np.ndarray, int]:
    """Returns (samples float64 in int16 range [T] or [T, C], sample_rate)."""
    if rxfilename.strip().endswith("|"):
        data = popen(rxfilename.strip()[:-1], "rb").read()
        fd = io.BytesIO(data)
    else:
        fd = open(rxfilename, "rb")
    try:
        with wave.open(fd, "rb") as w:
            rate = w.getframerate()
            nchan = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(w.getnframes())
        if width == 2:
            samples = np.frombuffer(raw, dtype="<i2").astype(np.float64)
        elif width == 1:
            samples = (np.frombuffer(raw, dtype=np.uint8).astype(np.float64) - 128) * 256
        elif width == 4:
            samples = np.frombuffer(raw, dtype="<i4").astype(np.float64) / 65536.0
        else:
            raise ValueError("Unsupported sample width %d" % width)
        if nchan > 1:
            samples = samples.reshape(-1, nchan)
        return samples, rate
    finally:
        fd.close()


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono PCM16 (samples in int16 range, clipped)."""
    x = np.clip(np.asarray(samples), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(x.tobytes())


def read_wav_scp(path: str) -> Iterator[Tuple[str, np.ndarray, int]]:
    """Iterate (utt, samples, rate) over a wav.scp."""
    with open(path) as f:
        for line in f:
            utt, rx = line.strip().split(" ", 1)
            samples, rate = read_wav(rx)
            yield utt, samples, rate
