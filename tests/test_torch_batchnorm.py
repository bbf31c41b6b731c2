"""The train-mode BatchNorm's plain versions (``ops/batchnorm.py``) on the
CPU: the plain backward against autograd of the module's plain forward in
both layouts the kernels take, the routing of ``models/layers.py``'s
BatchNorm (the kernels for every train-mode x off the CPU, a group's
included), what the wrapper refuses or copies, and the kernels' plan. The
kernels themselves run in ``tests/test_torch_gpu.py`` on a card."""

import pytest
import torch

from tf_kaldi_speaker_tpu_torch.models import layers
from tf_kaldi_speaker_tpu_torch.ops import batchnorm as bn


def _x(layout, dtype, b=3, length=7, c=6, seed=0):
    """[b, length, c], contiguous (rows) or the view of a contiguous
    [b, c, length] (channels-first, as a convolution hands it over), with
    a large mean and channel 1 constant (its variance clamps to 0)."""
    g = torch.Generator().manual_seed(seed)
    base = torch.randn(b, c, length, generator=g, dtype=torch.float64) * 2.0 + 5.0
    base[:, 1] = 3.25
    x = base.transpose(1, 2)
    x = x.contiguous() if layout == bn.ROWS else x
    assert bn.layout(x) == layout
    return x.to(dtype).detach()


def _module(c, dtype, seed=1, eps=layers.TF_BN_EPSILON):
    g = torch.Generator().manual_seed(seed)
    m = layers.BatchNorm(c, momentum=0.9, epsilon=eps).train()
    with torch.no_grad():
        m.scale.copy_(torch.rand(c, generator=g) + 0.5)
        m.bias.copy_(torch.randn(c, generator=g))
        m.mean.copy_(torch.randn(c, generator=g))
        m.var.copy_(torch.rand(c, generator=g) + 0.5)
    return m.to(dtype) if dtype == torch.float64 else m


def _autograd(m, x, gy, param_dtype=None):
    """x.grad, scale.grad, bias.grad of the module's plain forward, with its
    parameters cast to ``param_dtype`` as the bf16 train step casts them."""
    x = x.clone().requires_grad_(True)
    params = {"scale": m.scale, "bias": m.bias}
    if param_dtype is not None:
        params = {k: v.to(param_dtype) for k, v in params.items()}
    y = torch.func.functional_call(m, params, (x,))
    gx, gs, gb = torch.autograd.grad(y, (x, m.scale, m.bias), gy)
    return y.detach(), gx, gs, gb


@pytest.mark.parametrize("layout", [bn.ROWS, bn.CHANNELS_FIRST])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_backward_is_autograd_of_the_plain_forward(layout, dtype):
    x = _x(layout, dtype)
    gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(2), dtype=dtype)
    m = _module(x.shape[-1], dtype)
    y, gx, gs, gb = _autograd(m, x, gy)
    mean, var = m.mean.clone(), m.var.clone()

    m2 = _module(x.shape[-1], dtype)
    y2, stat = bn.batch_norm_train_plain(x, m2.scale.detach(), m2.bias.detach(), m2.mean, m2.var,
                                         m2.momentum, m2.epsilon)
    assert torch.equal(y2, y) and torch.equal(m2.mean, mean) and torch.equal(m2.var, var)
    assert stat.dtype == dtype
    dx, ds, db = bn.batch_norm_train_backward_plain(x, gy, stat, dtype)
    tol = dict(rtol=1e-10, atol=1e-10) if dtype == torch.float64 else dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dx, gx, **tol)
    torch.testing.assert_close(ds, gs, **tol)
    torch.testing.assert_close(db, gb, **tol)
    assert torch.isfinite(dx).all()


def test_constant_channel_passes_no_gradient_through_the_clamp():
    """Where E[x²] - mean² < 0 the clamp holds the variance at 0: the
    backward drops the variance's term there, as autograd does, and keeps
    it where the difference is not negative."""
    x = torch.full((5, 4, 2), 0.7, dtype=torch.float32)
    x[..., 1] = torch.arange(20, dtype=torch.float32).view(5, 4) / 7.0
    dims = (0, 1)
    raw = torch.mean(x * x, dim=dims) - torch.mean(x, dim=dims) ** 2
    assert raw[0] < 0 <= raw[1]  # float32 rounding of a constant channel
    gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    m = _module(2, torch.float32)
    _, gx, gs, gb = _autograd(m, x, gy)
    _, stat = bn.batch_norm_train_plain(x, m.scale.detach(), m.bias.detach(), m.mean.clone(),
                                        m.var.clone(), m.momentum, m.epsilon)
    assert stat[3].tolist() == [0.0, 1.0]
    dx, ds, db = bn.batch_norm_train_backward_plain(x, gy, stat, torch.float32)
    torch.testing.assert_close(dx, gx, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close((ds, db), (gs, gb), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layout", [bn.ROWS, bn.CHANNELS_FIRST])
def test_plain_backward_with_bf16_parameters(layout):
    """The bf16 step: bf16 x, scale and bias (float32 inside); dscale and
    dbias come back in bf16, rounded once as the cast's backward rounds."""
    x = _x(layout, torch.bfloat16, b=4, length=9, c=10)
    gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(4)).to(torch.bfloat16)
    m = _module(x.shape[-1], torch.float32)
    y, gx, gs, gb = _autograd(m, x, gy, torch.bfloat16)
    _, stat = bn.batch_norm_train_plain(x, m.scale.detach().to(torch.bfloat16),
                                        m.bias.detach().to(torch.bfloat16), m.mean.clone(),
                                        m.var.clone(), m.momentum, m.epsilon)
    dx, ds, db = bn.batch_norm_train_backward_plain(x, gy, stat, torch.bfloat16)
    assert dx.dtype == ds.dtype == db.dtype == torch.bfloat16
    one_ulp = dict(rtol=2.0 ** -7, atol=1e-3)
    torch.testing.assert_close(dx.float(), gx.float(), **one_ulp)
    torch.testing.assert_close(ds.float(), gs.float(), **one_ulp)
    torch.testing.assert_close(db.float(), gb.float(), **one_ulp)


@pytest.mark.parametrize("layout", [bn.ROWS, bn.CHANNELS_FIRST])
def test_batch_norm_train_refuses_cpu_tensors(layout):
    """The wrapper is the kernels' alone: a CPU x (the module's plain code
    takes those) raises forward and backward, and moves no running
    statistic."""
    x = _x(layout, torch.float32).requires_grad_(True)
    m = _module(x.shape[-1], torch.float32)
    mean = m.mean.clone()
    with pytest.raises(ValueError, match="kernels need a CUDA x"):
        bn.batch_norm_train(x, m.scale, m.bias, m.mean, m.var, m.momentum, m.epsilon)
    assert torch.equal(m.mean, mean)
    stat = torch.zeros(4, x.shape[-1])
    with pytest.raises(ValueError, match="needs a bf16 or float32 CUDA x"):
        bn.batch_norm_train_backward(x.detach(), x.detach(), stat, torch.float32)


@pytest.mark.parametrize("group", [None, "group"])
def test_batch_norm_train_copies_other_strides_into_rows(monkeypatch, group):
    """x of strides neither layout has reaches the Function as a
    contiguous copy, with the group as given; the two layouts pass as they
    are."""
    seen = []
    monkeypatch.setattr(bn.BatchNormTrain, "apply", lambda *a: seen.append(a) or a[0])
    p = torch.ones(6)
    wide = torch.randn(3, 7, 12)[..., ::2]
    assert bn.layout(wide) is None
    out = bn.batch_norm_train(wide, p, p, p, p, 0.9, 1e-3, group)
    assert out.is_contiguous() and torch.equal(out, wide) and seen[0][-1] == group
    for layout in (bn.ROWS, bn.CHANNELS_FIRST):
        x = _x(layout, torch.float32)
        assert bn.batch_norm_train(x, p, p, p, p, 0.9, 1e-3, group) is x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_cpu_keeps_the_plain_path(dtype):
    before = (bn.batch_norm_train.launches, bn.batch_norm_train_backward.launches)
    m = _module(6, torch.float64 if dtype == torch.float64 else torch.float32)
    x = _x(bn.CHANNELS_FIRST, dtype).requires_grad_(True)
    m(x).float().sum().backward()
    m.eval()(x).float().sum().backward()
    assert (bn.batch_norm_train.launches, bn.batch_norm_train_backward.launches) == before


def test_module_routes_only_train_mode_without_a_group(monkeypatch):
    """Train mode off the CPU (a meta tensor stands in for the card's)
    calls batch_norm_train with the module's group, set or not; eval mode,
    and train mode on the CPU with or without a group, keep the plain
    code."""
    calls = []
    x = _x(bn.ROWS, torch.float32)
    want = _module(6, torch.float32)(x)
    monkeypatch.setattr(layers, "batch_norm_train", lambda *a: calls.append(a) or a[0])
    monkeypatch.setattr(layers, "all_reduce", lambda t, group: t)
    m = _module(6, torch.float32)
    off_cpu = torch.empty(x.shape, device="meta")
    assert m(off_cpu) is off_cpu and len(calls) == 1
    assert calls[0][1] is m.scale and calls[0][3] is m.mean
    assert calls[0][5:] == (0.9, 1e-3, None)
    group = object()
    m.group = group
    assert m(off_cpu) is off_cpu and calls[1][-1] is group
    torch.testing.assert_close(m(x), want)
    m.group = None
    m.eval()(x)
    assert len(calls) == 2


def test_what_the_kernels_take():
    """_fusable (the device-free part of fused_batch_norm_takes): bf16 and
    float32 x, rows or channels-first, one parameter dtype, float32 [C]
    running statistics; nothing else."""
    p = torch.ones(6)
    for layout in (bn.ROWS, bn.CHANNELS_FIRST):
        for dtype in (torch.float32, torch.bfloat16):
            x = _x(layout, dtype)
            assert bn._fusable(x, p, p, p, p)
            assert bn._fusable(x, p.bfloat16(), p.bfloat16(), p, p)
            assert not bn._fusable(x, p.bfloat16(), p, p, p)
            assert not bn._fusable(x, p, p, p.bfloat16(), p)
            assert not bn._fusable(x, p, p, p, torch.ones(7))
        assert not bn._fusable(_x(layout, torch.float64), p, p, p, p)
    wide = torch.zeros(3, 7, 12)
    assert bn.layout(wide[..., :6]) is None and not bn._fusable(wide[..., :6], p, p, p, p)
    assert not bn._fusable(torch.zeros(0, 6), p, p, p, p)
    assert bn.layout(torch.zeros(4, 6)) == bn.ROWS
    nchw = torch.zeros(2, 6, 5, 3).permute(0, 2, 3, 1)
    assert bn.layout(nchw) == bn.CHANNELS_FIRST and bn._fusable(nchw, p, p, p, p)
    assert bn.layout(torch.zeros(2, 5, 3, 6)) == bn.ROWS


def test_vector_width():
    assert bn.vector_width(2, (0, 512), 512) == 8
    assert bn.vector_width(2, (0, 512), 1500) == 4
    assert bn.vector_width(2, (0, 8), 512) == 4
    assert bn.vector_width(2, (0, 2), 512) == 1
    assert bn.vector_width(4, (16, 32), 256) == 4
    assert bn.vector_width(4, (16, 40), 256) == 2
    assert bn.vector_width(4, (16, 32), 37) == 1


@pytest.mark.parametrize("lay, outer, c, ve", [
    (bn.ROWS, 256 * 286, 512, 8), (bn.ROWS, 256 * 286, 1500, 4), (bn.ROWS, 256, 512, 8),
    (bn.ROWS, 1, 37, 1), (bn.ROWS, 64 * 25 * 10, 256, 4), (bn.ROWS, 5000, 8, 8),
    (bn.CHANNELS_FIRST, 256, 512, 8), (bn.CHANNELS_FIRST, 3, 20, 1),
    (bn.CHANNELS_FIRST, 256, 64, 8), (bn.CHANNELS_FIRST, 100000, 1, 4)])
def test_plan_covers_every_row_once(lay, outer, c, ve):
    p = bn.plan(lay, outer, c, ve, sms=132)
    assert 1 <= p.splits <= 65535 and p.per_split >= 1
    assert (p.splits - 1) * p.per_split < outer <= p.splits * p.per_split
    if lay == bn.CHANNELS_FIRST:
        assert p.units * bn.WARP_CHANNELS >= c > (p.units - 1) * bn.WARP_CHANNELS
    else:
        w = c // ve
        assert p.tile & (p.tile - 1) == 0 and 1 <= p.tile <= bn.MAX_TILE
        assert p.tile >= min(w, bn.MAX_TILE) > p.tile // 2 or p.tile == 1
        assert p.units * p.tile >= w > (p.units - 1) * p.tile
        assert p.splits <= -(-outer // (bn.MIN_PASSES * (bn.THREADS // p.tile)))
    assert p.units * p.splits <= 2 * bn.BLOCKS_PER_SM * 132 or p.splits == 1
