"""The port's CUDA kernels and its device path on the card, against the
plain PyTorch versions on the CPU. Every test is marked ``gpu`` and skips
without a CUDA device. The file imports no JAX, so it also runs where jax
is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu_torch.convert import variables_from_network
from tf_kaldi_speaker_tpu_torch.extract.device_pipe import DevicePipeExtractor
from tf_kaldi_speaker_tpu_torch.kio import ArkScpWriter, decode_cm_codes, read_codes_scp
from tf_kaldi_speaker_tpu_torch.models.tdnn import EntireNetwork
from tf_kaldi_speaker_tpu_torch.ops import _build
from tf_kaldi_speaker_tpu_torch.ops import batchnorm as ops_bn
from tf_kaldi_speaker_tpu_torch.ops.cm_dequant import cm_dequantize, cm_dequantize_plain
from tf_kaldi_speaker_tpu_torch.ops.pooling import (
    masked_stats_pooling,
    masked_stats_pooling_backward,
    masked_stats_pooling_backward_plain,
    masked_stats_pooling_plain,
)
from tf_kaldi_speaker_tpu_torch.train.checkpoints import save_checkpoint
from torch_mt_tiny import MT_CORPUS, MT_EPOCH_TOL, MT_TINY, train_epoch

pytestmark = pytest.mark.gpu

POOL_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=0.0)  # one bf16 ulp
# pooling backward against its plain version (float32 inside, rounded once):
# float32 to reassociation; bf16 one ulp, and the float32 noise where the
# mean and deviation terms cancel
BWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=2.0 ** -7, atol=1e-6)}
TINY = dict(network_type="tdnn", tdnn_layer_size=16, num_nodes_pooling_layer=32,
            num_nodes_last_layer=16, pooling_type="statistics_pooling",
            embedding_node="tdnn6_dense", use_fused_pooling=True)
D = 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ragged(seed, b, l, d, mean=50.0):
    g = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn(b, l, d, generator=g) * 4.0 + mean)
    lengths = torch.randint(0, l + 1, (b,), generator=g)
    lengths[-1] = l
    mask = (torch.arange(l)[None, :] < lengths[:, None]).float()
    return x, mask


def _misaligned(t, cuda):
    """t on the card at an address one element past an aligned one, so the
    kernels take their scalar paths; contiguous all the same."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


# L*D % 4 == 0 and aligned codes take the 4-byte loads and 16-byte stores:
# (4, 400, 30), (1, 7, 20), (2, 16, 30), (32, 400, 30); the rest, and every
# misaligned case, the scalar path.
@pytest.mark.parametrize("shape", [(4, 400, 30), (1, 7, 20), (3, 1, 257), (3, 7, 30),
                                   (1, 1, 257), (2, 16, 30), (32, 400, 30)])
@pytest.mark.parametrize("aligned", [True, False])
def test_cm_dequantize_kernel(cuda, shape, aligned):
    """Bit-equal to the host codec (numpy: each operation rounded to float32
    in the map's order, no FMA) and to the plain version run on the card."""
    b, l, d = shape
    g = torch.Generator().manual_seed(0)
    codes = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
    codes[0, 0, :3] = torch.tensor([64, 192, 255], dtype=torch.uint8)  # segment ends
    headers = torch.sort(torch.randn(b, 4, d, generator=g) * 3.0, dim=1).values
    codes_dev = codes.to(cuda) if aligned else _misaligned(codes, cuda)
    n = cm_dequantize.launches
    got = cm_dequantize(codes_dev, headers.to(cuda))
    torch.cuda.synchronize()
    assert cm_dequantize.launches == n + 1 and got.dtype == torch.float32
    got = got.cpu().numpy()
    for i in range(b):
        np.testing.assert_array_equal(
            got[i], decode_cm_codes(codes[i].numpy(), headers[i].numpy()))
    np.testing.assert_array_equal(
        got, cm_dequantize_plain(codes.to(cuda), headers.to(cuda)).cpu().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 200, 1500), (3, 50, 20), (2, 0, 33),
                                   (1, 434, 1500), (8, 434, 1500), (32, 386, 1500),
                                   (4, 90, 1501), (5, 33, 257), (2, 2500, 300)])
def test_stats_pooling_kernel(cuda, dtype, shape):
    dt = getattr(torch, dtype)
    x, mask = _ragged(1, *shape)
    x = x.to(dt)
    n = masked_stats_pooling.launches
    got = masked_stats_pooling(x.to(cuda), mask.to(cuda))
    torch.cuda.synchronize()
    assert masked_stats_pooling.launches == n + 1 and got.dtype == dt
    want = masked_stats_pooling_plain(x, mask)
    tol = POOL_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(), **tol)


def _hard_masks(seed, b, l, d):
    """Rows: no valid frame; a fractional mask; valid frames from frame 300
    on (the first valid frame is not in the first block of frames); the
    rest ragged."""
    x, mask = _ragged(seed, b, l, d)
    g = torch.Generator().manual_seed(seed + 1)
    mask[0] = 0.0
    mask[1] = torch.rand(l, generator=g)
    mask[2] = (torch.arange(l) >= 300).float()
    return x, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d, aligned", [(1500, True), (1500, False), (1501, True)])
def test_stats_pooling_kernel_hard_masks(cuda, dtype, d, aligned):
    dt = getattr(torch, dtype)
    x, mask = _hard_masks(5, 4, 434, d)
    x = x.to(dt)
    xd = x.to(cuda) if aligned else _misaligned(x, cuda)
    got = masked_stats_pooling(xd, mask.to(cuda))
    want = masked_stats_pooling_plain(x, mask)
    tol = POOL_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(), **tol)
    assert float(got[0, d:].float().min()) == pytest.approx(1e-6, rel=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stats_pooling_kernel_every_split_count(cuda, dtype):
    """Each cluster size from 1 to 8, forced through the tests' entry point
    (at 2000 frames no count is cut), gives the plain version's result; 0
    and 9 are refused."""
    dt = getattr(torch, dtype)
    b, l, d = 3, 2000, 260
    x, mask = _hard_masks(6, b, l, d)
    x = x.to(dt)
    want = masked_stats_pooling_plain(x, mask).float().numpy()
    tol = POOL_TOL if dtype == "float32" else BF16_TOL
    xd, md = x.to(cuda), mask.to(cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for splits in range(10):
        out = torch.empty(b, 2 * d, dtype=dt, device=cuda)
        err = _build.load().tfks_stats_pooling_splits(
            int(dt == torch.bfloat16), xd.data_ptr(), md.data_ptr(), out.data_ptr(),
            b, l, d, splits, stream)
        if splits in (0, 9):
            assert err != 0
            continue
        assert err == 0, splits
        np.testing.assert_allclose(out.float().cpu().numpy(), want, err_msg=str(splits), **tol)


def test_shape_counters_record_launches(cuda):
    cm_dequantize.shapes.clear()
    masked_stats_pooling.shapes.clear()
    for b, l in ((2, 16), (2, 16), (4, 24)):
        cm_dequantize(torch.zeros(b, l, 30, dtype=torch.uint8, device=cuda),
                      torch.zeros(b, 4, 30, device=cuda))
        masked_stats_pooling(torch.zeros(b, l, 40, dtype=torch.bfloat16, device=cuda),
                             torch.ones(b, l, device=cuda))
    masked_stats_pooling(torch.zeros(1, 8, 40, device=cuda), torch.ones(1, 8, device=cuda))
    assert dict(cm_dequantize.shapes) == {((2, 16, 30), "uint8"): 2,
                                          ((4, 24, 30), "uint8"): 1}
    assert dict(masked_stats_pooling.shapes) == {((2, 16, 40), "bfloat16"): 2,
                                                 ((4, 24, 40), "bfloat16"): 1,
                                                 ((1, 8, 40), "float32"): 1}
    # CPU tensors take the plain versions and are not counted
    masked_stats_pooling(torch.zeros(1, 8, 40), torch.ones(1, 8))
    assert sum(masked_stats_pooling.shapes.values()) == 4


def test_stats_pooling_grad_on_card(cuda):
    x, mask = _ragged(2, 3, 40, 24, mean=1.0)
    w = torch.randn(3, 48, generator=torch.Generator().manual_seed(3))
    grads = []
    for dev in ("cpu", cuda):
        xd = x.detach().to(dev).requires_grad_(True)
        torch.sum(masked_stats_pooling(xd, mask.to(dev)) * w.to(dev)).backward()
        grads.append(xd.grad.cpu().numpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-3, atol=1e-4)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x, mask = _ragged(4, 2, 10, 8)
    with pytest.raises(TypeError):
        masked_stats_pooling(x.double().to(cuda), mask.to(cuda))
    with pytest.raises(ValueError, match="contiguous"):
        masked_stats_pooling(x.to(cuda).transpose(1, 2).contiguous().transpose(1, 2),
                             mask.to(cuda))
    with pytest.raises(ValueError, match="CUDA device"):
        masked_stats_pooling(x.to(cuda), mask)
    codes = torch.zeros(2, 10, 8, dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        cm_dequantize(codes.float(), torch.zeros(2, 4, 8, device=cuda))
    with pytest.raises(ValueError, match="headers"):
        cm_dequantize(codes, torch.zeros(2, 3, 8, device=cuda))


def test_network_on_card_matches_cpu(cuda):
    net = EntireNetwork(TINY, D, generator=torch.Generator().manual_seed(0)).eval()
    feats = torch.randn(3, 60, D, generator=torch.Generator().manual_seed(1))
    mask = (torch.arange(60)[None, :] < torch.tensor([[60], [45], [30]])).float()
    with torch.no_grad():
        want = net(feats, mask)[1]
        n = masked_stats_pooling.launches
        got = net.to(cuda)(feats.to(cuda), mask.to(cuda))[1]
    assert masked_stats_pooling.launches == n + 1
    for k in want:
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_device_pipe_on_card_matches_cpu(cuda, tmp_path):
    net = EntireNetwork(TINY, D, generator=torch.Generator().manual_seed(0))
    v = variables_from_network(net)
    nnet = str(tmp_path / "m" / "nnet")
    save_checkpoint(nnet, {"params": {"network": v["params"]},
                           "batch_stats": {"network": v["batch_stats"]}}, 0)
    with open(os.path.join(nnet, "config.json"), "w") as f:
        json.dump(TINY, f)
    with open(os.path.join(nnet, "feature_dim"), "w") as f:
        f.write("%d\n" % D)
    rng = np.random.RandomState(0)
    ark, scp = str(tmp_path / "f.ark"), str(tmp_path / "f.scp")
    w = ArkScpWriter("ark,scp:%s,%s" % (ark, scp), kind="mat")
    for i in range(6):
        t = int(rng.randint(60, 200))
        f = rng.randn(t, D).astype(np.float32)
        f[:, 0] = np.where(rng.rand(t) > 0.3, 20.0, -20.0) + 0.1 * rng.randn(t)
        w.write("utt%d" % i, f, compress=True)
    w.close()
    kw = dict(cmvn=True, vad=True, min_chunk_size=10, batch_size=4)
    want = dict(DevicePipeExtractor(str(tmp_path / "m"), device="cpu", **kw)
                .embed_codes_stream(read_codes_scp(scp)))
    n = (cm_dequantize.launches, masked_stats_pooling.launches)
    got = dict(DevicePipeExtractor(str(tmp_path / "m"), device="cuda", **kw)
               .embed_codes_stream(read_codes_scp(scp)))
    assert cm_dequantize.launches > n[0] and masked_stats_pooling.launches > n[1]
    assert set(got) == set(want) and len(got) == 6
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5, err_msg=k)


def _bwd_inputs(x, mask, seed):
    """The forward's out (plain version, as the backward receives it) and
    an incoming gradient."""
    out = masked_stats_pooling_plain(x, mask)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed)).to(x.dtype)
    return out, g


def _check_bwd(cuda, x, mask, out, g, dtype, xd=None):
    n = masked_stats_pooling_backward.launches
    xd = x.to(cuda) if xd is None else xd
    got = masked_stats_pooling_backward(xd, mask.to(cuda), out.to(cuda), g.to(cuda))
    torch.cuda.synchronize()
    # an empty x launches nothing
    assert masked_stats_pooling_backward.launches == n + (x.numel() > 0)
    assert got.dtype == x.dtype and got.shape == x.shape
    want = masked_stats_pooling_backward_plain(x, mask, out, g)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(),
                               **BWD_TOL[dtype])
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 286, 1500), (64, 186, 1500), (3, 50, 20),
                                   (4, 90, 1501), (5, 33, 257), (2, 0, 33), (1, 300, 8)])
def test_stats_pooling_backward_kernel(cuda, dtype, shape):
    dt = getattr(torch, dtype)
    x, mask = _ragged(7, *shape)
    x = x.to(dt)
    out, g = _bwd_inputs(x, mask, 8)
    _check_bwd(cuda, x, mask, out, g, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d, aligned", [(1500, True), (1500, False), (1501, True), (257, True)])
def test_stats_pooling_backward_kernel_hard_masks(cuda, dtype, d, aligned):
    """Empty, fractional and late masks; a floored column (constant x);
    misaligned x takes the scalar path."""
    dt = getattr(torch, dtype)
    x, mask = _hard_masks(9, 4, 434, d)
    x[3, :, 5] = 2.5  # constant column: variance floored, no std gradient
    x = x.to(dt)
    out, g = _bwd_inputs(x, mask, 10)
    got = _check_bwd(cuda, x, mask, out, g, dtype,
                     xd=None if aligned else _misaligned(x, cuda)).float().cpu()
    assert not got[0].any()  # no valid frame
    n = float(mask[3].sum())
    np.testing.assert_allclose(got[3, :, 5].numpy(), (mask[3] * float(g[3, 5]) / n).numpy(),
                               rtol=2.0 ** -7, atol=1e-7)


def _check_bwd_on_card(cuda, shape, dtype, seed):
    """Inputs made on the card, the plain version run there too (the large
    shapes would take minutes on the host)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(seed)
    b, l, d = shape
    x = torch.relu(torch.randn(shape, generator=g, device=cuda) * 4.0 + 50.0).to(dt)
    lengths = torch.randint(0, l + 1, (b,), generator=g, device=cuda)
    lengths[-1] = l
    mask = (torch.arange(l, device=cuda)[None, :] < lengths[:, None]).float()
    out = masked_stats_pooling_plain(x, mask)
    gr = torch.randn(out.shape, generator=g, device=cuda).to(dt)
    got = masked_stats_pooling_backward(x, mask, out, gr)
    want = masked_stats_pooling_backward_plain(x, mask, out, gr)
    torch.cuda.synchronize()
    tol = BWD_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol["atol"] + tol["rtol"] * want.float().abs()).all()), float(diff.max())
    return x, mask, out, gr, got


@pytest.mark.parametrize("dtype, shape", [
    ("bfloat16", (256, 1200, 1500)),  # more items than blocks: whole rows
    ("float32", (64, 1, 1500)), ("bfloat16", (64, 1, 1500)), ("bfloat16", (3, 1, 20)),  # L = 1
    ("float32", (64, 25, 1024)), ("float32", (64, 46, 1024)),  # ResNet34's pooling
    ("bfloat16", (64, 286, 256)),  # the quality path's pooling width
])
def test_stats_pooling_backward_kernel_plans(cuda, dtype, shape):
    _check_bwd_on_card(cuda, shape, dtype, 15)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1500, 8])
def test_stats_pooling_backward_valid_frames_in_last_item(cuda, dtype, d):
    """B = 1, L = 2500: the row is split into ranges, and its only valid
    frames lie in the last one; n still counts the whole row."""
    from tf_kaldi_speaker_tpu_torch.ops.pooling import backward_geometry, backward_plan

    dt = getattr(torch, dtype)
    with torch.cuda.device(cuda):
        plan = backward_plan(1, 2500, d, backward_geometry(dt))
    assert plan.splits > 1
    first = (plan.splits - 1) * plan.frames_per_item
    x, _ = _ragged(17, 1, 2500, d)
    x = x.to(dt)
    mask = torch.zeros(1, 2500)
    mask[0, first:] = 1.0
    out, g = _bwd_inputs(x, mask, 18)
    got = _check_bwd(cuda, x, mask, out, g, dtype).float().cpu()
    assert not got[0, :first].any() and got[0, first:].abs().sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 286, 1500), (64, 25, 1024), (4, 90, 1501)])
def test_stats_pooling_backward_is_deterministic(cuda, dtype, shape):
    """Two launches on one input give the same bits (no atomics)."""
    x, mask, out, gr, got = _check_bwd_on_card(cuda, shape, dtype, 19)
    assert torch.equal(got, masked_stats_pooling_backward(x, mask, out, gr))


def test_stats_pooling_backward_refuses_a_bad_plan(cuda):
    """The launcher takes only a plan that covers [B, L, D] once with
    resident blocks; the wrapper's plan it takes."""
    from tf_kaldi_speaker_tpu_torch.ops.pooling import backward_geometry, backward_plan

    b, l, d = 64, 10, 1500
    x, mask = _ragged(21, b, l, d)
    out, g = _bwd_inputs(x, mask, 22)
    xd, md, od, gd = (t.to(cuda) for t in (x, mask, out, g))
    gx = torch.empty_like(xd)
    with torch.cuda.device(cuda):
        geo = backward_geometry(torch.float32)
    sms, per_sm = geo.sms, geo.blocks_per_sm
    lib = _build.load()

    def launch(blocks, items, frames):
        err = lib.tfks_stats_pooling_bwd_f32(
            xd.data_ptr(), md.data_ptr(), od.data_ptr(), gd.data_ptr(), gx.data_ptr(),
            b, l, d, blocks, items, frames, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        return err

    plan = backward_plan(b, l, d, geo)
    assert launch(plan.blocks, plan.items, plan.frames_per_item) == 0
    np.testing.assert_allclose(gx.cpu().numpy(), masked_stats_pooling_backward_plain(
        x, mask, out, g).numpy(), **BWD_TOL["float32"])
    tiles = -(-d // geo.cols)
    for blocks, items, frames in [
            (plan.blocks, plan.items + 1, plan.frames_per_item),  # items do not match
            (0, plan.items, plan.frames_per_item),                # no block
            (plan.items + 1, plan.items, plan.frames_per_item),   # more blocks than items
            (1, b * tiles, 0), (1, b * tiles, l + 1),             # no frames, too many
            (sms * per_sm + 1, b * tiles * l, 1)]:                # more than are resident
        assert launch(blocks, items, frames) != 0, (blocks, items, frames)
    assert launch(sms * per_sm, b * tiles * l, 1) == 0


def test_stats_pooling_backward_through_autograd(cuda):
    """The train step's path: the Function's backward launches the kernel,
    once per backward, in the forward's dtype."""
    x, mask = _ragged(11, 8, 120, 96)
    xd = x.to(torch.bfloat16).to(cuda).requires_grad_(True)
    w = torch.randn(8, 192, generator=torch.Generator().manual_seed(12)).to(cuda)
    n = (masked_stats_pooling.launches, masked_stats_pooling_backward.launches)
    torch.sum(masked_stats_pooling(xd, mask.to(cuda)).float() * w).backward()
    torch.cuda.synchronize()
    assert (masked_stats_pooling.launches, masked_stats_pooling_backward.launches) == (
        n[0] + 1, n[1] + 1)
    assert xd.grad.dtype == torch.bfloat16 and torch.isfinite(xd.grad.float()).all()


def test_stats_pooling_backward_raises_on_what_it_does_not_take(cuda):
    x, mask = _ragged(13, 2, 10, 8)
    out, g = _bwd_inputs(x, mask, 14)
    xd, md, od, gd = (t.to(cuda) for t in (x, mask, out, g))
    with pytest.raises(TypeError):
        masked_stats_pooling_backward(xd, md, od.to(torch.bfloat16), gd)
    with pytest.raises(ValueError, match="contiguous"):
        masked_stats_pooling_backward(xd, md, od, gd.t().contiguous().t())
    with pytest.raises(ValueError, match="CUDA device"):
        masked_stats_pooling_backward(xd, mask, od, gd)


# ---------------------------------------------------------------- streaming feed

@pytest.mark.parametrize("threaded", [True, False])
def test_device_prefetch_on_card(cuda, threaded):
    """Batches of codes, headers and labels reach the card byte for byte,
    in order, through the side stream (transfer thread or inline), and a
    consumer kernel on the current stream reads them after the copy."""
    from tf_kaldi_speaker_tpu_torch.data import device_prefetch

    rng = np.random.RandomState(0)
    batches = [(rng.randint(0, 256, (4, 64, 37, 30)).astype(np.uint8),
                np.sort(rng.randn(4, 64, 4, 30).astype(np.float32), axis=2),
                rng.randint(0, 96, (4, 64)).astype(np.int32)) for _ in range(5)]
    got = 0
    for (codes, headers, labels), want in zip(
            device_prefetch(iter(batches), cuda, threaded=threaded), batches):
        assert codes.device.type == "cuda" and codes.dtype == torch.uint8
        out = cm_dequantize(codes[1], headers[1])  # on the current stream
        np.testing.assert_array_equal(codes.cpu().numpy(), want[0])
        np.testing.assert_array_equal(headers.cpu().numpy(), want[1])
        np.testing.assert_array_equal(labels.cpu().numpy(), want[2])
        np.testing.assert_array_equal(
            out.cpu().numpy(),
            cm_dequantize_plain(torch.from_numpy(want[0][1]), torch.from_numpy(want[1][1])))
        got += 1
    assert got == 5


def test_streamed_epoch_on_card_matches_cpu(cuda, tmp_path):
    """One float32 streamed epoch (device_decode, K = 2, one loader worker)
    on the card and on the CPU from one seed: the same steps and
    checkpoints, parameters within rtol 1e-4 / atol 1e-5 (the biases that a
    BatchNorm follows, rounding noise on both sides, left out); the dequant
    kernel launched once a step."""
    from tf_kaldi_speaker_tpu_torch import convert
    from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
    from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    d = make_fake_data_dir(str(tmp_path / "cm"), num_speakers=6, utts_per_speaker=3, dim=D,
                           min_len=60, max_len=150, seed=5)
    cfg = dict(TINY, seed=3, loss_func="additive_margin_softmax", amsoftmax_m=0.2,
               amsoftmax_lambda_min=0, amsoftmax_lambda_base=1000, amsoftmax_lambda_gamma=1e-4,
               amsoftmax_lambda_power=5, optimizer="momentum", momentum=0.9, weight_l2_regularizer=1e-2,
               num_speakers_per_batch=4, num_segments_per_speaker=2, min_segment_len=40,
               max_segment_len=56, num_steps_per_epoch=4, steps_per_dispatch=2,
               num_parallel_datasets=1, show_training_progress=0, device_decode=True,
               use_fused_pooling=False)
    flat = {}
    for dev in ("cpu", "cuda"):
        t = Trainer(ParamsPlain(**cfg), str(tmp_path / dev), dim=D, num_speakers=6, device=dev)
        t.build("train")
        cm_dequantize.launches = 0
        t.train(d["data"], d["spklist"], 0.02)
        assert t.step == 4 and cm_dequantize.launches == (4 if dev == "cuda" else 0)
        flat[dev] = convert.flatten(convert.variables_of(t.network_model))
    for path, w in flat["cpu"].items():
        if path[-1] == "bias" and path[-2].endswith(("_conv", "_dense")):
            continue
        np.testing.assert_allclose(flat["cuda"][path].numpy(), w.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg="/".join(path))


# ---------------------------------------------------------------- the model zoo

def _resnet_mask(b, l, seed):
    """Prefix masks of utterances 8x longer, downsampled as ResNet34's
    stride-2 stages do (mask[:, ::2] three times)."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, 8 * l + 1, (b,), generator=g)
    lengths[-1] = 8 * l
    mask = (torch.arange(8 * l)[None, :] < lengths[:, None]).float()
    return mask[:, ::2][:, ::2][:, ::2].contiguous()


@pytest.mark.parametrize("l", [25, 38, 50])
def test_stats_pooling_kernels_at_resnet_shapes(cuda, l):
    """Forward and backward at the ResNet34 zoo shape [64, 25-50, 1024]
    float32 (200-400 frames in, 4 frequency bins x 256 channels)."""
    x, _ = _ragged(11, 64, l, 1024)
    mask = _resnet_mask(64, l, 12)
    got = masked_stats_pooling(x.to(cuda), mask.to(cuda))
    torch.cuda.synchronize()
    want = masked_stats_pooling_plain(x, mask)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **POOL_TOL)
    out, g = _bwd_inputs(x, mask, 13)
    _check_bwd(cuda, x, mask, out, g, "float32")


ZOO_NETS = {
    "ecapa": dict(network_type="ecapa_tdnn", ecapa_channels=32, ecapa_mfa_channels=48,
                  ecapa_res2net_scale=4, ecapa_se_bottleneck=8, ecapa_att_bottleneck=8,
                  ecapa_embedding_dim=16, pooling_type="statistics_pooling"),
    "resnet_fused": dict(network_type="resnet34", resnet_base_channels=8,
                         resnet_layers=[1, 1, 1, 1], resnet_embedding_dim=16,
                         pooling_type="statistics_pooling", use_fused_pooling=True),
    "tdnn_attention": dict(TINY, use_fused_pooling=False, pooling_type="self_attention",
                           att_key_input="tdnn4_relu", att_key_num_nodes=[16, 8],
                           att_key_network_type=3, att_value_input="tdnn5_relu",
                           att_num_heads=2, att_split_key=True, att_use_scale=True,
                           att_apply_nonlinear=True, att_penalty_term=0.5),
    "tdnn_ghost_vlad": dict(TINY, use_fused_pooling=False, pooling_type="ghost_vlad",
                            vlad_num_centers=4, vlad_num_ghosts=1, vlad_key_input="tdnn4_relu",
                            vlad_value_input="tdnn5_relu", vlad_value_num_nodes=[12],
                            vlad_final_l2_norm=True),
}


@pytest.mark.parametrize("name", sorted(ZOO_NETS))
def test_zoo_network_on_card_matches_cpu(cuda, name):
    """On the card against the CPU (float32, TF32 off): every endpoint of an
    eval forward (rtol 1e-4 / atol 1e-5); a train-mode forward's output
    (atol 5e-3: its BatchNorms normalize over 4 rows, and a column whose 4
    values nearly agree scales float32 rounding by up to 1 / sqrt(eps), as
    ECAPA's pooled stddevs do) and BatchNorm statistics; the parameters'
    gradients of sum(output * r) in eval mode (train-mode BatchNorms leave
    the biases before them only rounding noise). ResNet34 with the fused
    pooling launches the forward kernel on each card forward and the
    backward kernel on the card's backward."""
    cfg = ZOO_NETS[name]
    net = EntireNetwork(cfg, D, cfg["network_type"], torch.Generator().manual_seed(0))
    feats = torch.randn(4, 80, D, generator=torch.Generator().manual_seed(1))
    mask = (torch.arange(80)[None, :] < torch.tensor([[80], [61], [47], [33]])).float()
    r = torch.randn(4, net.output_dim, generator=torch.Generator().manual_seed(2))
    card = EntireNetwork(cfg, D, cfg["network_type"]).to(cuda)
    card.load_state_dict(net.state_dict())
    n_fwd, n_bwd = masked_stats_pooling.launches, masked_stats_pooling_backward.launches
    with torch.no_grad():
        want = net.eval()(feats, mask)[1]
        got = card.eval()(feats.to(cuda), mask.to(cuda))[1]
        for k in want:
            np.testing.assert_allclose(got[k].float().cpu().numpy(), want[k].float().numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
        out_cpu = net.train()(feats, mask)[0]
        out_card = card.train()(feats.to(cuda), mask.to(cuda))[0]
        np.testing.assert_allclose(out_card.cpu().numpy(), out_cpu.numpy(), rtol=1e-3,
                                   atol=5e-3)
        for (k, a), b in zip(net.state_dict().items(), card.state_dict().values()):
            np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    grads = {}
    for where, model, x, m, rr in (("cpu", net, feats, mask, r),
                                   ("card", card, feats.to(cuda), mask.to(cuda), r.to(cuda))):
        out, _ = model.eval()(x, m)
        params = dict(model.named_parameters())
        grads[where] = dict(zip(params, torch.autograd.grad(torch.sum(out * rr),
                                                            list(params.values()))))
    if cfg.get("use_fused_pooling"):
        assert masked_stats_pooling.launches == n_fwd + 3
        assert masked_stats_pooling_backward.launches == n_bwd + 1
    for k, w in grads["cpu"].items():
        if k == "ecapa.asp.att_scores.bias":  # the softmax over time takes it out
            continue
        np.testing.assert_allclose(grads["card"][k].cpu().numpy(), w.numpy(), rtol=1e-3,
                                   atol=1e-5 * (float(w.abs().max()) + 1e-6), err_msg=k)


def test_exact_long_on_card_matches_cpu(cuda, tmp_path):
    """embed_long_exact on the card against the CPU, and against the card's
    whole-utterance forward (rtol 5e-3 / atol 5e-4, the JAX test's)."""
    from tf_kaldi_speaker_tpu_torch.extract.extractor import Extractor

    cfg = dict(TINY, use_fused_pooling=False)
    net = EntireNetwork(cfg, D, generator=torch.Generator().manual_seed(0))
    v = variables_from_network(net)
    nnet = tmp_path / "m" / "nnet"
    save_checkpoint(str(nnet), {"params": {"network": v["params"]},
                                "batch_stats": {"network": v["batch_stats"]}}, 0)
    (nnet / "config.json").write_text(json.dumps(cfg))
    (nnet / "feature_dim").write_text("%d\n" % D)
    feat = np.random.RandomState(3).randn(1000, D).astype(np.float32)
    out = {}
    for device in ("cpu", "cuda"):
        ex = Extractor(str(tmp_path / "m"), min_chunk_size=20, chunk_size=5000, device=device)
        whole = ex.embed_utterance(feat)
        ex.chunk_size = 256
        out[device] = ex.embed_long_exact(feat), whole
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["cuda"][0], out["cuda"][1], rtol=5e-3, atol=5e-4)


def test_multitask_on_card_matches_cpu(cuda, tmp_path):
    """The multitask trainer on the card: one float32 epoch of 2 groups of
    2 steps against the same epoch on the CPU, in lockstep (``train_epoch``:
    each card step starts from the variables and momentum trace that the
    CPU's step started from), the variables after each step within
    MT_EPOCH_TOL; then valid() and both predicts. Free-running, the two
    epochs part: 4 float32 steps of this net amplify rounding, so that a
    nudge of the initial weights by 1e-8 relative moves the CPU's own epoch
    past that tolerance, while each step from one state stays well inside
    it and TF32 and bf16 steps do not (``chip_smoke.py --mt-epoch-spread``
    reads both). Nothing on the path launches a kernel of the port (the JAX
    multitask path pools with the two-pass moments and reads floats)."""
    from tf_kaldi_speaker_tpu_torch.multitask import TrainerMultiTask
    from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    d = make_fake_data_dir(str(tmp_path / "d"), **MT_CORPUS)
    data = (d["data"], d["ali_dir"], d["spklist"])
    trainers = {}
    for dev in ("cpu", "cuda"):
        t = TrainerMultiTask(ParamsPlain(**MT_TINY), str(tmp_path / dev / "nnet"), dim=D,
                             num_speakers=5, num_phones=7, device=dev)
        t.build("train", D, num_speakers=5, num_phones=7)
        trainers[dev] = t
    for fn in (cm_dequantize, masked_stats_pooling, masked_stats_pooling_backward):
        fn.launches = 0
    _, starts, want = train_epoch(trainers["cpu"], data)
    _, _, got = train_epoch(trainers["cuda"], data, starts)
    assert sum(fn.launches for fn in (cm_dequantize, masked_stats_pooling,
                                      masked_stats_pooling_backward)) == 0
    assert len(got) == len(want) == MT_TINY["num_steps_per_epoch"]
    for k, (g, w) in enumerate(zip(got, want)):
        for path in w:
            np.testing.assert_allclose(g[path].numpy(), w[path].numpy(),
                                       err_msg="step %d %s" % (k + 1, path), **MT_EPOCH_TOL)
    vg, vw = trainers["cuda"].valid(*data), trainers["cpu"].valid(*data)
    np.testing.assert_allclose(vg[:2], vw[:2], rtol=2e-4)
    x = np.random.RandomState(0).randn(150, D).astype(np.float32)
    for t in trainers.values():
        t.build("predict", D)
    np.testing.assert_allclose(trainers["cuda"].predict_speaker(x),
                               trainers["cpu"].predict_speaker(x), rtol=2e-4, atol=5e-5)
    np.testing.assert_allclose(trainers["cuda"].predict_phone(x),
                               trainers["cpu"].predict_phone(x), rtol=2e-4, atol=5e-5)


# ---------------------------------------------------------------- train-mode BatchNorm

def _bn_case(cuda, shape, dtype, channels_first, seed, param_dtype=None):
    """x of ``shape`` [B, ..., C] on the card (channels-first: the view of
    a contiguous [B, C, ...], as a convolution hands it over), parameters,
    running statistics and an incoming gradient. Conv-like values: mean
    0.5, deviation 2, one channel constant."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = shape[-1]
    if channels_first:
        base = torch.randn((shape[0], c) + tuple(shape[1:-1]), generator=g, device=cuda)
        base[:, c // 2] = 0.75
        x = (base * 2.0 + 0.5).to(dtype).movedim(1, -1)
    else:
        x = torch.randn(shape, generator=g, device=cuda)
        x[..., c // 2] = 0.75
        x = (x * 2.0 + 0.5).to(dtype)
    p = param_dtype or dtype
    scale = (torch.rand(c, generator=g, device=cuda) + 0.5).to(p)
    bias = torch.randn(c, generator=g, device=cuda).to(p)
    mean = torch.randn(c, generator=g, device=cuda) * 0.1
    var = torch.rand(c, generator=g, device=cuda) + 0.5
    gy = torch.randn(x.shape, generator=g, device=cuda).to(dtype)
    assert ops_bn.layout(x) == (ops_bn.CHANNELS_FIRST if channels_first else ops_bn.ROWS)
    return x, scale, bias, mean, var, gy


def _bn_run(fn, x, scale, bias, mean, var, gy, eps):
    """y, the moved running statistics and the three gradients of ``fn``
    (batch_norm_train, or the plain forward under autograd)."""
    xr, sr, br = (t.detach().clone().requires_grad_(True) for t in (x, scale, bias))
    rm, rv = mean.clone(), var.clone()
    y = fn(xr, sr, br, rm, rv, 0.99, eps)
    grads = torch.autograd.grad(y, (xr, sr, br), gy)
    return (y.detach(), rm, rv) + grads


def _bn_plain(x, scale, bias, rm, rv, momentum, eps):
    return ops_bn.batch_norm_train_plain(x, scale, bias, rm, rv, momentum, eps)[0]


# (shape, dtype, channels-first, eps): the flagship's bf16 layers at the
# pool cell's shapes (tdnn1-3 channels-first, tdnn4-5 rows, tdnn6-7),
# ResNet34's float32 channels-last maps and ECAPA's float32 channels-first
# convolutions at flax's eps, and odd widths (the 8-byte and one-element
# accesses, a tile and a run cut short)
BN_CASES = [((256, 286, 512), "bfloat16", True, 1e-3), ((256, 286, 1500), "bfloat16", False, 1e-3),
            ((256, 512), "bfloat16", False, 1e-3), ((64, 25, 10, 256), "float32", False, 1e-5),
            ((32, 198, 512), "float32", True, 1e-5), ((5, 37, 33), "bfloat16", True, 1e-3),
            ((5, 37, 33), "bfloat16", False, 1e-3), ((3, 41, 1500), "float32", True, 1e-3),
            ((7, 13, 6), "float32", False, 1e-3), ((2, 3, 5, 22), "bfloat16", True, 1e-5)]


@pytest.mark.parametrize("shape, dtype, channels_first, eps", BN_CASES)
def test_batch_norm_train_kernels_match_the_plain_path(cuda, shape, dtype, channels_first, eps):
    """y, the running statistics, dx, dscale and dbias against autograd of
    the plain forward on the card: float32 to the order of the sums; bf16
    one ulp where both round a float32 value. y and dx keep x's strides."""
    dt = getattr(torch, dtype)
    case = _bn_case(cuda, shape, dt, channels_first, 31)
    x = case[0]
    n = ops_bn.batch_norm_train.launches, ops_bn.batch_norm_train_backward.launches
    got = _bn_run(ops_bn.batch_norm_train, *case, eps)
    want = _bn_run(_bn_plain, *case, eps)
    torch.cuda.synchronize()
    assert (ops_bn.batch_norm_train.launches, ops_bn.batch_norm_train_backward.launches) == (
        n[0] + 1, n[1] + 1)
    assert got[0].stride() == x.stride() and got[3].stride() == x.stride()
    _bn_compare(got, want, dt == torch.float32)


def _bn_compare(got, want, f32):
    """_bn_run's six results against the plain path's: float32 to the order
    of the sums; bf16 one ulp where both round a float32 value."""
    for name, a, b in zip(("y", "running mean", "running var", "dx", "dscale", "dbias"),
                          got, want):
        a, b = a.float(), b.float()
        scale = float(b.abs().max())
        if name.startswith("running"):
            tol = dict(rtol=1e-5, atol=1e-6)
        elif name in ("dx", "dscale", "dbias"):
            # the analytic gradient against autograd's chain: float32 noise
            # where the mean's and the variance's terms cancel
            tol = dict(rtol=1e-4 if f32 else 2.0 ** -7, atol=(1e-5 if f32 else 2.0 ** -8) * scale)
        else:
            tol = dict(rtol=1e-5, atol=1e-5) if f32 else dict(rtol=2.0 ** -7, atol=1e-6)
        torch.testing.assert_close(a, b, msg=lambda m: "%s: %s" % (name, m), **tol)


# (shape, dtype, channels-first, eps) of the two-rank test: ECAPA-like
# float32 channels-first, and bf16 rows with float32 parameters
BN_GROUP_CASES = [((64, 50, 96), "float32", True, 1e-5), ((64, 37, 40), "bfloat16", False, 1e-3)]


def _bn_group_rank(rank, port, case):
    """One rank of the two-rank test: gloo on the one card, half the batch,
    the kernels over the group against the plain forward over the whole
    batch (dscale and dbias summed over the ranks first)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port, world_size=2,
                            rank=rank)
    try:
        shape, dtype, channels_first, eps = BN_GROUP_CASES[case]
        dt = getattr(torch, dtype)
        x, scale, bias, mean, var, gy = _bn_case(torch.device("cuda"), shape, dt,
                                                 channels_first, 34, torch.float32)
        want = _bn_run(_bn_plain, x, scale, bias, mean, var, gy, eps)
        rows = slice(rank * shape[0] // 2, (rank + 1) * shape[0] // 2)
        n = ops_bn.batch_norm_train.launches, ops_bn.batch_norm_train_backward.launches
        got = list(_bn_run(lambda *a: ops_bn.batch_norm_train(*a, group=dist.group.WORLD),
                           x[rows], scale, bias, mean, var, gy[rows], eps))
        assert (ops_bn.batch_norm_train.launches,
                ops_bn.batch_norm_train_backward.launches) == (n[0] + 1, n[1] + 1)
        assert got[0].stride() == x[rows].stride()
        for i in (4, 5):
            dist.all_reduce(got[i])
        _bn_compare(got, [want[0][rows], want[1], want[2], want[3][rows], want[4], want[5]],
                    dt == torch.float32)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", range(len(BN_GROUP_CASES)))
def test_batch_norm_train_kernels_over_a_group_of_two(cuda, case):
    """The data-parallel BatchNorm: two ranks on the card (gloo), half the
    batch each, all-reduce their sums between the kernels' passes; each
    rank's y and dx, the running statistics and the ranks' summed dscale
    and dbias match the plain forward over the whole batch."""
    _build.load()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path[:0] = %r; import test_torch_gpu as t; "
            "t._bn_group_rank(int(sys.argv[1]), %d, %d)" % ([here, os.path.dirname(here)],
                                                            port, case))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(o[-3000:] for o in outs)


@pytest.mark.parametrize("shape, channels_first", [((256, 286, 512), True),
                                                   ((256, 286, 1500), False)])
def test_batch_norm_train_kernels_are_deterministic(cuda, shape, channels_first):
    """Two runs give the same bits: each split's sums in a fixed order, the
    splits added in order by whichever block comes last."""
    case = _bn_case(cuda, shape, torch.bfloat16, channels_first, 32)
    a, b = (_bn_run(ops_bn.batch_norm_train, *case, 1e-3) for _ in range(2))
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_batch_norm_train_plain_backward_on_card(cuda):
    """The kernels' backward against batch_norm_train_backward_plain (its
    arithmetic, term for term), bf16 x with float32 parameters, and g in
    another layout than x (copied into x's first)."""
    x, scale, bias, mean, var, gy = _bn_case(cuda, (16, 100, 300), torch.bfloat16, True, 33,
                                             torch.float32)
    y, stat = ops_bn.batch_norm_train_plain(x, scale, bias, mean.clone(), var.clone(), 0.99,
                                            1e-3)
    got = ops_bn.batch_norm_train_backward(x, gy.contiguous(), stat, torch.float32)
    want = ops_bn.batch_norm_train_backward_plain(x, gy, stat, torch.float32)
    assert got[0].stride() == x.stride() and got[1].dtype == torch.float32
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=2.0 ** -7, atol=1e-3)
    torch.testing.assert_close(got[1:], want[1:], rtol=1e-4, atol=1e-4)
    y2 = ops_bn.batch_norm_train(x, scale, bias, mean.clone(), var.clone(), 0.99, 1e-3)
    torch.testing.assert_close(y2.float(), y.float(), rtol=2.0 ** -7, atol=1e-6)


def test_batch_norm_module_on_card_takes_the_kernels(cuda):
    """models/layers.py's BatchNorm: train mode on the card launches the
    kernels, counted by (B, L, C) and layout, x of other strides as a
    contiguous copy; eval mode keeps the plain code; float64, which no
    kernel takes, raises."""
    from tf_kaldi_speaker_tpu_torch.models.layers import BatchNorm

    m = BatchNorm(24).to(cuda).train()
    ops_bn.batch_norm_train.shapes.clear()
    x = torch.randn(4, 24, 10, device=cuda).transpose(1, 2)
    m(x)
    m(torch.randn(4, 10, 24, device=cuda, dtype=torch.bfloat16))
    m(torch.randn(4, 10, 48, device=cuda)[..., ::2])
    assert dict(ops_bn.batch_norm_train.shapes) == {((4, 10, 24), "float32.channels_first"): 1,
                                                    ((4, 10, 24), "bfloat16"): 1,
                                                    ((4, 10, 24), "float32"): 1}
    n = ops_bn.batch_norm_train.launches
    m.eval()(x)
    with pytest.raises(ValueError, match="kernels need"):
        m.double().train()(x.double())
    assert ops_bn.batch_norm_train.launches == n
    m.float()
    with pytest.raises(ValueError, match="kernels need"):
        ops_bn.batch_norm_train(x.double(), m.scale, m.bias, m.mean, m.var, 0.99, 1e-3)
