"""The port's front end against the JAX package on the CPU: wav I/O, the
numpy copies of the MFCC, VAD and CMVN code (bit-equal on every
``tests/golden/frontend.npz`` case), and ``mfcc_torch`` and the masked
VAD/CMVN in float64 against the numpy code.

Tolerances: the numpy copies are bit-equal (``assert_array_equal``);
``mfcc_torch`` in float64, cast to float32, against numpy ``mfcc`` at
rtol/atol 1e-9 (float32 values, so equal in practice), and before the cast
within 2^-23 relative plus 1e-6 of them (the float32 rounding of the
reference); in float32 against ``mfcc_jax`` at ``test_frontend.py``'s rtol
2e-3 / atol 0.1 (both FFTs in float32); a padded row against its unpadded
run at rtol 1e-12 / atol 1e-9 (matmul blockings differ with the batch);
masked VAD decisions equal; masked CMVN in float64, cast to float32,
against numpy ``sliding_cmvn`` at rtol/atol 1e-6."""

import importlib
import os

import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu.kio import wav as jwav
from tf_kaldi_speaker_tpu_torch.kio import read_wav, read_wav_scp, write_wav
from tf_kaldi_speaker_tpu_torch.ops import cmvn, mfcc, vad

jmfcc = importlib.import_module("tf_kaldi_speaker_tpu.ops.mfcc")
jvad = importlib.import_module("tf_kaldi_speaker_tpu.ops.vad")
jcmvn = importlib.import_module("tf_kaldi_speaker_tpu.ops.cmvn")

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "frontend.npz")
CASES = ["vox16k", "sre8k", "vox16k_dither"]


def _cfgs(mod):
    c = mod.MfccConfig
    return {
        "vox16k": c(dither=0.0),
        "sre8k": c(sample_rate=8000, high_freq=3700.0, num_mel_bins=23, num_ceps=23, dither=0.0),
        "vox16k_dither": c(dither=1.0),
    }


def tone(freq, dur=1.0, rate=16000, amp=8000.0):
    t = np.arange(int(dur * rate)) / rate
    return amp * np.sin(2 * np.pi * freq * t)


def _noise(wavs, cfg, seeds):
    return [np.random.RandomState(s).randn(mfcc.num_frames(len(w), cfg), cfg.frame_length)
            for w, s in zip(wavs, seeds)]


def _batch(wavs, dtype=torch.float64):
    t = max(len(w) for w in wavs)
    pad = np.zeros((len(wavs), t))
    for i, w in enumerate(wavs):
        pad[i, :len(w)] = w
    return torch.from_numpy(pad).to(dtype), torch.tensor([len(w) for w in wavs])


@pytest.mark.parametrize("name", CASES)
def test_numpy_copies_bit_equal(name):
    z = np.load(GOLDEN)
    wav = z[name + "_wav"]
    cfg, jcfg = _cfgs(mfcc)[name], _cfgs(jmfcc)[name]
    np.testing.assert_array_equal(mfcc.mel_banks(cfg), jmfcc.mel_banks(jcfg))
    np.testing.assert_array_equal(mfcc.dct_matrix(cfg.num_ceps, cfg.num_mel_bins),
                                  jmfcc.dct_matrix(cfg.num_ceps, cfg.num_mel_bins))
    np.testing.assert_array_equal(mfcc.lifter_coeffs(cfg), jmfcc.lifter_coeffs(jcfg))
    np.testing.assert_array_equal(mfcc.frame_signal(wav, cfg), jmfcc.frame_signal(wav, jcfg))
    feats = mfcc.mfcc(wav, cfg, seed=123)
    np.testing.assert_array_equal(feats, jmfcc.mfcc(wav, jcfg, seed=123))
    np.testing.assert_allclose(feats, z[name + "_mfcc"], rtol=1e-9, atol=1e-9)
    for kw in (dict(), dict(frames_context=2, proportion_threshold=0.6),
               dict(energy_threshold=5.3, energy_mean_scale=0.3)):
        d = vad.compute_vad_energy(feats, **kw)
        np.testing.assert_array_equal(d, jvad.compute_vad_energy(feats, **kw))
        np.testing.assert_array_equal(vad.select_voiced_frames(feats, d),
                                      jvad.select_voiced_frames(feats, d))
    np.testing.assert_array_equal(vad.compute_vad_energy(feats, 5.5, 0.5), z[name + "_vad"])
    for kw in (dict(window=300, center=True), dict(window=50, center=False),
               dict(window=120, center=True, norm_vars=True)):
        np.testing.assert_array_equal(cmvn.sliding_cmvn(feats, **kw),
                                      jcmvn.sliding_cmvn(feats, **kw))
    t = np.arange(17)
    for args in ((17, 5, True), (17, 40, False), (3, 300, True)):
        np.testing.assert_array_equal(cmvn._window_bounds(t, *args),
                                      jcmvn._window_bounds(t, *args))


@pytest.mark.parametrize("name", CASES)
def test_mfcc_torch_float64_matches_numpy(name):
    z = np.load(GOLDEN)
    wav = z[name + "_wav"]
    cfg = _cfgs(mfcc)[name]
    want = mfcc.mfcc(wav, cfg, seed=123)
    x, lengths = _batch([wav])
    noise = _noise([wav], cfg, [123]) if cfg.dither > 0 else None
    got, counts = mfcc.mfcc_torch(x, lengths, cfg, noise)
    assert got.dtype == torch.float64 and counts.tolist() == [want.shape[0]]
    got = got[0].numpy()
    np.testing.assert_allclose(got.astype(np.float32), want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=1e-6)


def test_mfcc_torch_float32_matches_mfcc_jax():
    import jax.numpy as jnp

    cfg = mfcc.MfccConfig(dither=0.0)
    x = tone(700, dur=0.3)
    want = np.asarray(jmfcc.mfcc_jax(jnp.asarray(x[None], jnp.float32), _cfgs(jmfcc)["vox16k"]))
    got, counts = mfcc.mfcc_torch(*_batch([x], torch.float32), cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=0.1)


def test_ragged_batch_rows_equal_their_own_runs():
    """Each row of a padded batch (dither from per-row seeds) equals its
    unpadded run; frames past a row's count are zero; a row shorter than
    one frame gets 0 frames."""
    cfg = mfcc.MfccConfig(dither=1.0)
    rng = np.random.RandomState(3)
    wavs = [rng.randn(n) * 1000 for n in (4000, 1600, 399, 400, 5000)]
    seeds = [7, 0, 5, 2, 9]
    x, lengths = _batch(wavs)
    got, counts = mfcc.mfcc_torch(x, lengths, cfg, _noise(wavs, cfg, seeds))
    assert counts.tolist() == [1 + (len(w) - 400) // 160 if len(w) >= 400 else 0
                               for w in wavs]
    assert counts.tolist()[2:4] == [0, 1] and got.shape == (5, max(counts), 30)
    for b, (w, s) in enumerate(zip(wavs, seeds)):
        c = int(counts[b])
        alone, n = mfcc.mfcc_torch(*_batch([w]), cfg, _noise([w], cfg, [s]))
        assert n.tolist() == [c]
        np.testing.assert_allclose(got[b, :c].numpy(), alone[0, :c].numpy(), rtol=1e-12,
                                   atol=1e-9)
        assert not got[b, c:].any()
        np.testing.assert_allclose(got[b, :c].numpy().astype(np.float32),
                                   mfcc.mfcc(w, cfg, seed=s), rtol=1e-9, atol=1e-9)


def test_rows_shorter_than_a_frame():
    cfg = mfcc.MfccConfig(dither=1.0)
    wavs = [np.ones(399), np.ones(10)]
    got, counts = mfcc.mfcc_torch(*_batch(wavs), cfg, _noise(wavs, cfg, [0, 1]))
    assert got.shape == (2, 0, 30) and counts.tolist() == [0, 0]
    assert mfcc.mfcc(np.ones(399), cfg).shape == (0, 30)
    with pytest.raises(ValueError, match="noise block"):
        mfcc.mfcc_torch(*_batch([np.ones(800)]), cfg, [np.zeros((2, 400))])


@pytest.mark.parametrize("kw", [dict(), dict(frames_context=2, proportion_threshold=0.6),
                                dict(energy_threshold=17.3, energy_mean_scale=0.0)])
def test_masked_vad_and_cmvn_float64_match_numpy(kw):
    z = np.load(GOLDEN)
    feats = [mfcc.mfcc(z[n + "_wav"], _cfgs(mfcc)[n], seed=1) for n in ("vox16k", "vox16k_dither")]
    feats.append(feats[0][:37])
    lengths = torch.tensor([f.shape[0] for f in feats])
    pad = torch.zeros((len(feats), int(lengths.max()), 30), dtype=torch.float64)
    for b, f in enumerate(feats):
        pad[b, :f.shape[0]] = torch.from_numpy(f.astype(np.float64))
    decisions = vad.compute_vad_energy_masked(pad, lengths, **kw)
    normed = cmvn.sliding_cmvn_masked(pad, lengths, window=300).to(torch.float32)
    for b, f in enumerate(feats):
        n = f.shape[0]
        want = vad.compute_vad_energy(f, **kw)
        assert 0 < want.sum() < n
        np.testing.assert_array_equal(decisions[b, :n].numpy().astype(np.float32), want)
        assert not decisions[b, n:].any()
        np.testing.assert_allclose(normed[b, :n].numpy(), cmvn.sliding_cmvn(f, window=300),
                                   rtol=1e-6, atol=1e-6)


def test_wav_io_matches_jax(tmp_path):
    x = tone(500, dur=0.2) * 3.0  # clipped at the int16 limits
    path, jpath = str(tmp_path / "a.wav"), str(tmp_path / "j.wav")
    write_wav(path, x, 16000)
    jwav.write_wav(jpath, x, 16000)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    for rx in (path, "cat %s |" % path):
        y, rate = read_wav(rx)
        jy, jrate = jwav.read_wav(rx)
        assert rate == jrate == 16000 and y.dtype == np.float64
        np.testing.assert_array_equal(y, jy)
    scp = str(tmp_path / "wav.scp")
    with open(scp, "w") as f:
        f.write("a %s\nb cat %s |\n" % (path, jpath))
    got = list(read_wav_scp(scp))
    want = list(jwav.read_wav_scp(scp))
    assert [(u, r) for u, _, r in got] == [(u, r) for u, _, r in want] == [("a", 16000),
                                                                            ("b", 16000)]
    for (_, a, _), (_, b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
