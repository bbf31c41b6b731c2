"""Port ops against the JAX package: the plain versions of the two kernels
(CM dequantization, fused statistics pooling) against the jnp paths and the
Pallas kernels in interpret mode, the pooling gradient against jax.grad
through the custom VJP, and batched CMVN / VAD against their jnp
counterparts. The kernels themselves are tested on the card by
test_torch_gpu.py."""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu import kio
from tf_kaldi_speaker_tpu.kio import ark
from tf_kaldi_speaker_tpu.models.pooling import StatisticsPooling as JaxStatisticsPooling
from tf_kaldi_speaker_tpu.ops import cm_dequant_pallas as jcd
from tf_kaldi_speaker_tpu.ops import pooling_pallas as jpp
from tf_kaldi_speaker_tpu.ops.cmvn import sliding_cmvn, sliding_cmvn_jax_masked
from tf_kaldi_speaker_tpu.ops.vad import compute_vad_energy, compute_vad_energy_jax
from tf_kaldi_speaker_tpu_torch.models.pooling import floor_sqrt, masked_moments
from tf_kaldi_speaker_tpu_torch.ops.cm_dequant import cm_dequantize, cm_dequantize_plain
from tf_kaldi_speaker_tpu_torch.ops.cmvn import sliding_cmvn_masked
from tf_kaldi_speaker_tpu_torch.ops.pooling import (
    masked_stats_pooling,
    masked_stats_pooling_plain,
)
from tf_kaldi_speaker_tpu_torch.ops.vad import compute_vad_energy_masked

torch.set_num_threads(1)

DEQ_TOL = dict(rtol=1e-6, atol=1e-6)
POOL_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _codes_headers(seed, b=2, l=16, d=128):
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 256, size=(b, l, d), dtype=np.uint8)
    headers = np.sort(rng.randn(b, 4, d).astype(np.float32) * 3.0, axis=1)
    return codes, headers


def _ragged(seed, b=3, l=40, d=24, mean=0.0, relu=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, l, d).astype(np.float32) * 2.0 + mean
    if relu:
        x = np.maximum(x, 0.0)
    lengths = rng.randint(1, l + 1, size=b)
    lengths[0] = l
    mask = (np.arange(l)[None, :] < lengths[:, None]).astype(np.float32)
    return x, mask


# ---------------------------------------------------------------- dequant

@pytest.mark.parametrize("seed", [0, 1])
def test_cm_dequantize_plain_matches_jnp(seed):
    codes, headers = _codes_headers(seed, b=3, l=20, d=30)
    want = np.asarray(jcd.cm_dequantize_jnp(jnp.asarray(codes), jnp.asarray(headers)))
    got = cm_dequantize_plain(torch.from_numpy(codes), torch.from_numpy(headers))
    assert got.dtype == torch.float32 and got.shape == (3, 20, 30)
    np.testing.assert_allclose(got.numpy(), want, **DEQ_TOL)


def test_cm_dequantize_plain_matches_pallas_interpret():
    """The Pallas kernel as test_ops_pallas.py runs it on the CPU."""
    from jax.experimental import pallas as pl

    codes, headers = _codes_headers(4)
    out = pl.pallas_call(
        jcd._kernel,
        grid=(2,),
        in_specs=[
            pl.BlockSpec((1, 16, 128), lambda i: (i, 0, 0)),
            pl.BlockSpec((1, 4, 128), lambda i: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, 16, 128), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((2, 16, 128), jnp.float32),
        interpret=True,
    )(jnp.asarray(codes), jnp.asarray(headers))
    got = cm_dequantize(torch.from_numpy(codes), torch.from_numpy(headers))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **DEQ_TOL)


def test_cm_dequantize_matches_host_codec():
    rng = np.random.RandomState(3)
    mat = (rng.randn(120, 24) * 2 + 0.5).astype(np.float32)
    buf = io.BytesIO()
    kio.write_mat(buf, mat, compress=True)
    buf.seek(0)
    host = kio.read_mat(buf)
    blob = ark.compress_matrix(mat)
    gmin, grange, rows, cols = np.frombuffer(blob[3:19], dtype=ark._GLOBAL_HEADER, count=1)[0]
    headers_u16 = np.frombuffer(blob[19 : 19 + cols * 8], dtype="<u2").reshape(cols, 4)
    p = ark._u16_to_float(headers_u16, gmin, grange)  # [D, 4]
    codes = np.frombuffer(blob[19 + cols * 8 :], dtype=np.uint8).reshape(cols, rows).T
    got = cm_dequantize(torch.from_numpy(np.ascontiguousarray(codes[None])),
                        torch.from_numpy(np.ascontiguousarray(p.T[None])))
    np.testing.assert_allclose(got.numpy()[0], host, **DEQ_TOL)


def test_cpu_path_launches_nothing():
    codes, headers = _codes_headers(5)
    x, mask = _ragged(5)
    n_deq, n_pool = cm_dequantize.launches, masked_stats_pooling.launches
    shapes = dict(cm_dequantize.shapes), dict(masked_stats_pooling.shapes)
    cm_dequantize(torch.from_numpy(codes), torch.from_numpy(headers))
    masked_stats_pooling(torch.from_numpy(x), torch.from_numpy(mask))
    assert (cm_dequantize.launches, masked_stats_pooling.launches) == (n_deq, n_pool)
    assert (dict(cm_dequantize.shapes), dict(masked_stats_pooling.shapes)) == shapes


@pytest.mark.parametrize("device", ["meta", "split"])
def test_wrappers_refuse_non_cpu_tensors_without_cuda(device):
    """A tensor that is not on the CPU never reaches a plain version: the
    wrapper launches the kernel or raises."""
    codes, headers = _codes_headers(6)
    x, mask = _ragged(6)
    codes, headers = torch.from_numpy(codes), torch.from_numpy(headers)
    x, mask = torch.from_numpy(x), torch.from_numpy(mask)
    if device == "meta":
        codes, x = codes.to("meta"), x.to("meta")
    headers, mask = headers.to("meta"), mask.to("meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cm_dequantize(codes, headers)
    with pytest.raises(ValueError, match="CUDA device"):
        masked_stats_pooling(x, mask)


# ---------------------------------------------------------------- pooling

@pytest.mark.parametrize("impl", ["plain", "function"])
@pytest.mark.parametrize("seed", [0, 1])
def test_stats_pooling_matches_jax(impl, seed):
    x, mask = _ragged(seed, mean=3.0 * seed)
    fn = masked_stats_pooling_plain if impl == "plain" else masked_stats_pooling
    got = fn(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert got.shape == (3, 48)
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    np.testing.assert_allclose(got, np.asarray(jpp._stats_jnp(jx, jm)), **POOL_TOL)
    np.testing.assert_allclose(got, np.asarray(jpp.masked_stats_pooling(jx, jm)), **POOL_TOL)
    pool = JaxStatisticsPooling()
    v = pool.init(jax.random.PRNGKey(0), jx, {})
    np.testing.assert_allclose(got, np.asarray(pool.apply(v, jx, {}, mask=jm)), **POOL_TOL)


def test_stats_pooling_matches_pallas_interpret():
    """The Pallas kernel as test_ops_pallas.py runs it on the CPU."""
    from jax.experimental import pallas as pl

    x, mask = _ragged(2, b=2, l=20, d=256)
    b, l, d, dt = 2, 20, 256, 128
    out = pl.pallas_call(
        functools.partial(jpp._kernel, mask_rows=b),
        grid=(b, d // dt),
        in_specs=[
            pl.BlockSpec((1, l, dt), lambda i, j: (i, 0, j)),
            pl.BlockSpec((b, l), lambda i, j: (0, 0)),
        ],
        out_specs=pl.BlockSpec((1, 2, dt), lambda i, j: (i, 0, j)),
        out_shape=jax.ShapeDtypeStruct((b, 2, d), jnp.float32),
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(mask))
    want = np.concatenate([np.asarray(out)[:, 0], np.asarray(out)[:, 1]], axis=1)
    got = masked_stats_pooling(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **POOL_TOL)


def test_stats_pooling_large_mean_post_relu_matches_two_pass():
    """The inputs where a one-pass variance cancels: post-ReLU, large mean."""
    x, mask = _ragged(7, l=64, mean=50.0, relu=True)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    mean, var = masked_moments(tx, tm)
    want = torch.cat([mean, floor_sqrt(var)], dim=1).numpy()
    np.testing.assert_allclose(masked_stats_pooling(tx, tm).numpy(), want, **POOL_TOL)
    jmean, jvar = np.mean(x[0], 0), np.var(x[0].astype(np.float64), 0)
    np.testing.assert_allclose(want[0], np.concatenate([jmean, np.sqrt(jvar)]), **POOL_TOL)


def test_stats_pooling_all_masked_row_and_floor():
    x = np.ones((2, 10, 4), np.float32) * 5.0
    mask = np.zeros((2, 10), np.float32)
    mask[1, :3] = 1.0
    got = masked_stats_pooling(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    want = np.asarray(jpp._stats_jnp(jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, **POOL_TOL)
    np.testing.assert_allclose(got[:, 4:], 1e-6, rtol=1e-5)  # sqrt of the floor


@pytest.mark.parametrize("masked", [False, True])
def test_stats_pooling_grad_matches_jax(masked):
    x, mask = _ragged(1, b=2, l=30, d=8)
    if not masked:
        mask[:] = 1.0
    rng = np.random.RandomState(9)
    # variance ~1e-14, under the 1e-12 floor: the std gradient is cut there
    x[1, :, 3] = rng.randn(30).astype(np.float32) * 1e-7
    w = rng.randn(2, 16).astype(np.float32)
    jm, jw = jnp.asarray(mask), jnp.asarray(w)
    want = jax.grad(lambda x: jnp.sum(jpp.masked_stats_pooling(x, jm) * jw))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = torch.sum(masked_stats_pooling(tx, torch.from_numpy(mask)) * torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), **GRAD_TOL)


# ---------------------------------------------------------------- CMVN / VAD

def _padded_batch(seed, lengths, d=6, c0_scale=10.0):
    rng = np.random.RandomState(seed)
    T = max(lengths)
    x = np.zeros((len(lengths), T, d), np.float32)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.randn(n, d)
        x[i, :n, 0] = rng.randn(n) * c0_scale
    return x, np.asarray(lengths, np.int64)


@pytest.mark.parametrize("window", [300, 25])
def test_sliding_cmvn_matches_jax(window):
    lengths = [90, 37, 0, 64]
    x, n = _padded_batch(0, lengths)
    want = np.asarray(sliding_cmvn_jax_masked(jnp.asarray(x), jnp.asarray(n), window=window))
    got = sliding_cmvn_masked(torch.from_numpy(x), torch.from_numpy(n), window=window).numpy()
    for i, k in enumerate(lengths):
        np.testing.assert_allclose(got[i, :k], want[i, :k], rtol=1e-5, atol=1e-5)
        if k:
            np.testing.assert_allclose(got[i, :k], sliding_cmvn(x[i, :k], window=window),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("context", [0, 2])
def test_vad_matches_jax(context):
    lengths = [80, 33, 0, 51]
    x, n = _padded_batch(1, lengths)
    want = np.asarray(compute_vad_energy_jax(jnp.asarray(x), jnp.asarray(n),
                                             frames_context=context))
    got = compute_vad_energy_masked(torch.from_numpy(x), torch.from_numpy(n),
                                    frames_context=context).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    for i, k in enumerate(lengths):
        if k:
            host = compute_vad_energy(x[i, :k], frames_context=context) > 0.5
            np.testing.assert_array_equal(got[i, :k], host)


def test_launch_counter_is_exact_under_threads():
    """8 threads x 10,000 counts through the wrappers' shared helper lose
    no increment, in ``launches`` and in ``shapes``. The counters' ``+``
    runs Python code here, so a thread can be switched out between reading
    a count and storing it: without the helper's lock this loses most of
    the increments."""
    import collections
    import sys
    import threading

    from tf_kaldi_speaker_tpu_torch.ops import _build

    class SlowInt(int):
        def __add__(self, other):
            return SlowInt(int(self) + other)

    class SlowCounter(collections.Counter):
        def __getitem__(self, key):
            return SlowInt(super().__getitem__(key))

    def wrapper():
        pass

    wrapper.launches, wrapper.shapes = SlowInt(0), SlowCounter()
    start = threading.Barrier(8)

    def hammer(t):
        start.wait()
        for _ in range(10_000):
            _build.count_launch(wrapper, (t % 2, 3, 4), "float32")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        threads = [threading.Thread(target=hammer, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 80_000
    assert dict(wrapper.shapes) == {((0, 3, 4), "float32"): 40_000,
                                    ((1, 3, 4), "float32"): 40_000}
