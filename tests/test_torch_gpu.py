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

from tf_kaldi_speaker_tpu.kio.ark import ArkScpWriter, read_codes_scp
from tf_kaldi_speaker_tpu_torch.convert import variables_from_network
from tf_kaldi_speaker_tpu_torch.extract.device_pipe import DevicePipeExtractor
from tf_kaldi_speaker_tpu_torch.models.tdnn import EntireNetwork
from tf_kaldi_speaker_tpu_torch.ops.cm_dequant import cm_dequantize, cm_dequantize_plain
from tf_kaldi_speaker_tpu_torch.ops.pooling import (
    masked_stats_pooling,
    masked_stats_pooling_plain,
)
from tf_kaldi_speaker_tpu_torch.train.checkpoints import save_checkpoint

pytestmark = pytest.mark.gpu

# torch's CUDA division by a scalar multiplies by the reciprocal: 1 ulp
DEQ_TOL = dict(rtol=1e-6, atol=1e-6)
POOL_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=0.0)  # one bf16 ulp
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


@pytest.mark.parametrize("shape", [(4, 400, 30), (1, 7, 20), (3, 1, 257)])
def test_cm_dequantize_kernel(cuda, shape):
    b, l, d = shape
    g = torch.Generator().manual_seed(0)
    codes = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
    headers = torch.sort(torch.randn(b, 4, d, generator=g) * 3.0, dim=1).values
    n = cm_dequantize.launches
    got = cm_dequantize(codes.to(cuda), headers.to(cuda))
    torch.cuda.synchronize()
    assert cm_dequantize.launches == n + 1 and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(),
                               cm_dequantize_plain(codes, headers).numpy(), **DEQ_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 200, 1500), (3, 50, 20), (2, 0, 33)])
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
