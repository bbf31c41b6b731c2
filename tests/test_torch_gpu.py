"""The port's CUDA kernels and its device path on the card, against the
plain PyTorch versions on the CPU. Every test is marked ``gpu`` and skips
without a CUDA device. The file imports no JAX, so it also runs where jax
is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""

import json
import os

import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu_torch.convert import variables_from_network
from tf_kaldi_speaker_tpu_torch.extract.device_pipe import DevicePipeExtractor
from tf_kaldi_speaker_tpu_torch.kio import ArkScpWriter, decode_cm_codes, read_codes_scp
from tf_kaldi_speaker_tpu_torch.models.tdnn import EntireNetwork
from tf_kaldi_speaker_tpu_torch.ops import _build
from tf_kaldi_speaker_tpu_torch.ops.cm_dequant import cm_dequantize, cm_dequantize_plain
from tf_kaldi_speaker_tpu_torch.ops.pooling import (
    masked_stats_pooling,
    masked_stats_pooling_backward,
    masked_stats_pooling_backward_plain,
    masked_stats_pooling_plain,
)
from tf_kaldi_speaker_tpu_torch.train.checkpoints import save_checkpoint

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
