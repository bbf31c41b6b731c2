"""Synthetic Kaldi data directories for tests and smoke runs.

``make_fake_data_dir`` is a copy of the function of
``tf_kaldi_speaker_tpu/utils/testdata.py`` for the port's own codec:
feats.scp/ark (compressed or not), utt2num_frames, spk2utt, utt2spk, a
spklist and, with ``with_vad_ali``, the multitask path's vad.scp/ark and
an alignment dir (pdf.scp/ark, num_pdfs, a tree marker), byte for byte
what the JAX package writes with the same arguments
(``tests/test_torch_pool.py``, ``tests/test_torch_multitask.py``).

``make_wav_data_dir`` writes a wav corpus of synthetic voices (wav.scp,
utt2spk, spk2utt) for the front end, ``write_trials`` a Kaldi trials file
of every pair of utterances, and ``write_kaldi_alignments`` a GMM
alignment dir (``final.mdl`` and gzipped transition-id alignments) for the
multitask recipe's native ``ali_to_pdf``.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..kio import ark
from ..kio.transition_model import TransitionModel, write_transition_model
from ..kio.wav import write_wav


def make_fake_data_dir(
    path: str,
    num_speakers: int = 5,
    utts_per_speaker: int = 4,
    dim: int = 24,
    min_len: int = 220,
    max_len: int = 480,
    compress: bool = True,
    seed: int = 0,
    with_vad_ali: bool = False,
    num_phones: int = 10,
    ali_dir: Optional[str] = None,
    spk_offset: int = 0,
    spk_scale: float = 2.0,
    chan_scale: float = 0.0,
    phone_signal: float = 0.0,
) -> Dict[str, str]:
    """Create a synthetic Kaldi data dir; returns important file paths.

    Features for speaker s are drawn from N(mu_s + c_u, I): a per-speaker
    mean (scaled by ``spk_scale``) plus an optional per-utterance channel
    offset (``chan_scale``); utterance lengths are uniform in
    [min_len, max_len]. ``with_vad_ali`` adds a VAD vector and a pdf-id
    alignment of uniform draws per utterance (``num_phones`` pdfs, into
    ``ali_dir``, default ``<path>/ali``); ``phone_signal`` adds a per-pdf
    mean offset ``phn_mean[pdf[t]] * phone_signal`` to each frame (drawn
    from a separate generator, so 0.0 leaves the other bytes as they
    are)."""
    rng = np.random.RandomState(seed)
    os.makedirs(path, exist_ok=True)
    ark_path = os.path.join(path, "feats.ark")
    vad_ark = os.path.join(path, "vad.ark")
    if ali_dir is None:
        ali_dir = os.path.join(path, "ali")
    if with_vad_ali:
        os.makedirs(ali_dir, exist_ok=True)
    pdf_ark = os.path.join(ali_dir, "pdf.ark")

    spk_means = rng.randn(num_speakers, dim) * spk_scale
    phn_means = (np.random.RandomState(seed + 424242).randn(num_phones, dim)
                 * phone_signal) if phone_signal else None
    scp, u2nf, spk2utt, utt2spk = [], [], [], []
    vad_scp, pdf_scp = [], []
    fv = open(vad_ark, "wb") if with_vad_ali else None
    fp = open(pdf_ark, "wb") if with_vad_ali else None
    with open(ark_path, "wb") as f:
        for s in range(num_speakers):
            spk = "spk%03d" % (s + spk_offset)
            utts = []
            for u in range(utts_per_speaker):
                utt = "%s_utt%03d" % (spk, u)
                n = int(rng.randint(min_len, max_len + 1))
                chan = rng.randn(dim) * chan_scale if chan_scale else 0.0
                feats = (spk_means[s] + chan + rng.randn(n, dim)).astype(np.float32)
                # the vad and pdf draws follow the features' draw
                vad = pdf = None
                if with_vad_ali:
                    vad = (rng.rand(n) > 0.2).astype(np.float32)
                    pdf = rng.randint(0, num_phones, size=n).astype(np.int32)
                    if phn_means is not None:
                        feats = (feats + phn_means[pdf]).astype(np.float32)
                pos = f.tell() + len(utt) + 1
                ark.write_mat(f, feats, key=utt, compress=compress)
                scp.append("%s %s:%d" % (utt, ark_path, pos))
                u2nf.append("%s %d" % (utt, n))
                utts.append(utt)
                utt2spk.append("%s %s" % (utt, spk))
                if with_vad_ali:
                    vpos = fv.tell() + len(utt) + 1
                    ark.write_vec_flt(fv, vad, key=utt)
                    vad_scp.append("%s %s:%d" % (utt, vad_ark, vpos))
                    ppos = fp.tell() + len(utt) + 1
                    ark.write_vec_int(fp, pdf, key=utt)
                    pdf_scp.append("%s %s:%d" % (utt, pdf_ark, ppos))
            spk2utt.append("%s %s" % (spk, " ".join(utts)))
    if fv is not None:
        fv.close()
    if fp is not None:
        fp.close()

    def _write(name, lines, where=path):
        p = os.path.join(where, name)
        with open(p, "w") as f:
            f.write("\n".join(lines) + "\n")
        return p

    out = {
        "data": path,
        "feats_scp": _write("feats.scp", scp),
        "utt2num_frames": _write("utt2num_frames", u2nf),
        "spk2utt": _write("spk2utt", spk2utt),
        "utt2spk": _write("utt2spk", utt2spk),
        "spklist": _write(
            "spklist",
            ["spk%03d %d" % (s + spk_offset, s) for s in range(num_speakers)],
        ),
    }
    if with_vad_ali:
        out["vad_scp"] = _write("vad.scp", vad_scp)
        out["pdf_scp"] = _write("pdf.scp", pdf_scp, where=ali_dir)
        out["ali_dir"] = ali_dir
        with open(os.path.join(ali_dir, "num_pdfs"), "w") as f:
            f.write("%d\n" % num_phones)
        # the marker of Kaldi's tree that a `tree-info <dir>/tree` reader
        # finds beside num_pdfs
        with open(os.path.join(ali_dir, "tree"), "w") as f:
            f.write("# synthetic corpus: num-pdfs %d\n" % num_phones)
    return out


def synthetic_voice(rng: np.random.RandomState, n: int, f0: float, formants: np.ndarray,
                    sample_rate: int = 16000, tilt: float = 1.0,
                    snr_db: float = 30.0) -> np.ndarray:
    """``n`` samples of one synthetic speaker, in int16 range: syllables of
    a glottal pulse train at about ``f0`` Hz (vibrato and drift) shaped by
    the speaker's formant envelope (``formants``: [K, 2] centre and
    bandwidth in Hz) and a channel's spectral ``tilt``, in white noise at
    ``snr_db``, separated by pauses that are digital silence or low
    noise."""
    t = np.arange(n) / sample_rate
    track = f0 * (1.0 + 0.04 * np.sin(2 * np.pi * rng.uniform(3, 6) * t + rng.uniform(0, 6.3))
                  + 0.02 * np.cumsum(rng.randn(n)) / np.sqrt(n))
    pulses = np.diff(np.floor(np.cumsum(track) / sample_rate), prepend=0.0)
    nfft = 1 << (n - 1).bit_length()  # a power of two: FFTs of any n are slow
    f = np.fft.rfftfreq(nfft, 1.0 / sample_rate)
    env = (sum(1.0 / (1.0 + ((f - c) / bw) ** 2) for c, bw in formants)
           / (1.0 + f / 4000.0) ** tilt)
    voiced = np.fft.irfft(np.fft.rfft(pulses, nfft) * env, nfft)[:n]
    gain = np.zeros(n)
    pos = int(rng.uniform(0.05, 0.3) * sample_rate)
    while pos < n:
        length = int(rng.uniform(0.15, 0.5) * sample_rate)
        seg = min(length, n - pos)
        gain[pos:pos + seg] = np.sin(np.pi * np.arange(seg) / length) ** 0.5
        pos += length + int(rng.uniform(0.05, 0.4) * sample_rate)
    voiced *= gain * (rng.uniform(4000, 9000) / max(np.abs(voiced).max(), 1e-9))
    rms = np.sqrt(np.mean(voiced[gain > 0] ** 2)) if (gain > 0).any() else 0.0
    voiced += np.where(gain > 0, rng.randn(n) * rms * 10.0 ** (-snr_db / 20.0), 0.0)
    if rng.rand() < 0.5:  # pauses of low noise; else digital silence
        voiced += np.where(gain > 0, 0.0, rng.randn(n) * rng.uniform(1.0, 4.0))
    return np.round(voiced)


def make_wav_data_dir(
    path: str,
    num_speakers: int = 4,
    utts_per_speaker: int = 2,
    min_seconds: float = 2.0,
    max_seconds: float = 10.0,
    sample_rate: int = 16000,
    seed: int = 0,
) -> Dict[str, object]:
    """A wav corpus of synthetic speakers, PCM16 at ``sample_rate``: each
    speaker a harmonic series with its own f0 (85-255 Hz) and three
    formants, each utterance a session that moves them (f0 by up to 15%,
    formants by up to 10%) with its own channel tilt and a 5-30 dB SNR,
    uniform in [min_seconds, max_seconds] long.
    Writes wav/*.wav, wav.scp, utt2spk and spk2utt; returns their paths,
    the utterance ids in order and the seconds of audio."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(path, "wav"), exist_ok=True)
    scp, utt2spk, spk2utt, utts = [], [], [], []
    seconds = 0.0
    for s in range(num_speakers):
        spk = "spk%03d" % s
        f0 = rng.uniform(85.0, 255.0)
        formants = np.stack([np.sort(rng.uniform([250, 800, 2000], [900, 2400, 3600])),
                             rng.uniform(60, 200, 3)], axis=1)
        mine = []
        for u in range(utts_per_speaker):
            utt = "%s_utt%03d" % (spk, u)
            n = int(rng.uniform(min_seconds, max_seconds) * sample_rate)
            wav = os.path.join(path, "wav", utt + ".wav")
            # the session: pitch, vocal tract, channel tilt and noise move
            session = formants * np.stack([rng.uniform(0.9, 1.1, 3), np.ones(3)], axis=1)
            write_wav(wav, synthetic_voice(rng, n, f0 * rng.uniform(0.85, 1.15), session,
                                           sample_rate, rng.uniform(0.5, 2.0),
                                           rng.uniform(5.0, 30.0)), sample_rate)
            scp.append("%s %s" % (utt, wav))
            utt2spk.append("%s %s" % (utt, spk))
            mine.append(utt)
            seconds += n / sample_rate
        spk2utt.append("%s %s" % (spk, " ".join(mine)))
        utts += mine

    def _write(name, lines):
        p = os.path.join(path, name)
        with open(p, "w") as f:
            f.write("\n".join(lines) + "\n")
        return p

    return {"data": path, "wav_scp": _write("wav.scp", scp),
            "utt2spk": _write("utt2spk", utt2spk), "spk2utt": _write("spk2utt", spk2utt),
            "utts": utts, "seconds": seconds}


def write_trials(path: str, utt2spk: Dict[str, str]) -> List[Tuple[str, str, bool]]:
    """A Kaldi trials file of every pair (a, b) of utterances, a before b
    in sorted order, ``target`` when both have one speaker; returns the
    trials."""
    keys = sorted(utt2spk)
    trials = [(a, b, utt2spk[a] == utt2spk[b])
              for i, a in enumerate(keys) for b in keys[i + 1:]]
    with open(path, "w") as f:
        f.writelines("%s %s %s\n" % (a, b, "target" if t else "nontarget")
                     for a, b, t in trials)
    return trials


def write_kaldi_alignments(path: str, utt2num_frames: Dict[str, int], num_phones: int,
                           seed: int = 0) -> int:
    """A Kaldi GMM alignment dir in ``path``: ``final.mdl``, the transition
    model of ``num_phones`` phones of the 3-state Bakis topology (a
    self-loop and a forward transition a state, one pdf a state), and
    ``ali.1.gz``, each utterance's frames as uniform random transition ids
    in utt2num_frames' order. Returns the model's pdf count (3 a phone)."""
    os.makedirs(path, exist_ok=True)
    entries = [[(0, 0, [(0, 0.75), (1, 0.25)]), (1, 1, [(1, 0.75), (2, 0.25)]),
                (2, 2, [(2, 0.75), (3, 0.25)]), (-1, -1, [])]]
    phones = list(range(1, num_phones + 1))
    tuples = [(p, st, 3 * i + st, 3 * i + st) for i, p in enumerate(phones) for st in range(3)]
    model = TransitionModel(phones, [-1] + [0] * num_phones, entries, tuples,
                            np.zeros(1 + 6 * num_phones, np.float32))
    write_transition_model(os.path.join(path, "final.mdl"), model)
    rng = np.random.RandomState(seed)
    with gzip.open(os.path.join(path, "ali.1.gz"), "wb") as f:
        for utt, n in utt2num_frames.items():
            tids = rng.randint(1, model.num_transition_ids + 1, size=n).astype(np.int32)
            ark.write_vec_int(f, tids, key=utt)
    return model.num_pdfs
