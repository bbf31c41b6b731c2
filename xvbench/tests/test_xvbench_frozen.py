"""The benchmark's frozen arithmetic: the FLOPs of ``flops/`` against
PyTorch's own count of the port's step and forward at a tiny width, and
``costs.py`` against ``chip_smoke.py``'s kernel arithmetic."""

import importlib.util
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from tf_kaldi_speaker_tpu_torch.models.tdnn import EntireNetwork
from tf_kaldi_speaker_tpu_torch.train.trainer import XVectorModel, l2_regularization
from xvbench import costs, harness
from xvbench.tests import tiny

TRAIN_CELLS = ["tdnn_pool_train_b256"]


def _config(cell):
    spec, config, traffic, _, flops = harness.cell_files(cell)
    cfg = dict(config, **tiny.CELLS[cell]["config"])
    cfg.update(traffic["trainer"], num_speakers_per_batch=6, compute_dtype="float32")
    return cfg, flops


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("length", [40, 57])
def test_train_step_flops_match_the_counter(cell, length):
    """The port's model, loss and L2 term forward and backward, as its
    train step runs them (the counter cannot follow ``autograd.grad``
    over leaves, so the test calls ``backward``)."""
    cfg, flops = _config(cell)
    dim, classes, batch = 30, int(cfg["num_speakers"]), 6
    model = XVectorModel(cfg, cfg["loss_func"], classes, dim).train()
    feats = torch.randn(batch, length, dim)
    with FlopCounterMode(display=False) as counter:
        loss, _ = model(feats, torch.arange(batch))
        (loss + l2_regularization(dict(model.named_parameters()), 0.01, 0.01)).backward()
    assert flops.train_step(cfg, dim, classes, batch, length) == counter.get_total_flops()


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("length", [30, 111])
def test_forward_flops_match_the_counter(cell, length):
    cfg, flops = _config(cell)
    net = EntireNetwork(cfg, 30, cfg["network_type"]).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(torch.randn(1, length, 30))
    assert flops.forward(cfg, 30, length) == counter.get_total_flops()
    assert flops.forward(cfg, 30, [length, length]) == 2 * counter.get_total_flops()


def _chip_smoke():
    path = os.path.join(harness.ROOT, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_costs", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("shape", [(256, 400, 30), (32, 386, 1500), (64, 286, 1500),
                                   (64, 25, 1024), (128, 1656, 1500)])
@pytest.mark.parametrize("esize", [2, 4])
def test_costs_equal_chip_smoke(shape, esize):
    smoke = _chip_smoke()
    assert costs.HBM_BYTES_PER_S == smoke.HBM_BYTES_PER_S
    assert costs.F32_FLOP_PER_S == smoke.F32_FLOP_PER_S
    assert costs.dequant_cost(*shape) == smoke.dequant_cost(*shape)
    assert costs.pooling_cost(*shape, esize) == smoke.pooling_cost(*shape, esize)
    assert costs.pooling_bwd_cost(*shape, esize) == smoke.pooling_bwd_cost(*shape, esize)
    for cost in (smoke.dequant_cost(*shape), smoke.pooling_bwd_cost(*shape, esize)):
        assert costs.bound_s(*cost) == pytest.approx(smoke.bound_ms(*cost)[0] * 1e-3,
                                                     rel=1e-12)
