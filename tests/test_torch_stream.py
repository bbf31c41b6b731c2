"""The port's streaming training path against the JAX package on the CPU:
``KaldiDataRandomQueue`` with one worker (features and raw codes, groups of
1 and 2) batch for batch, ``device_prefetch`` on the CPU, a streamed epoch
(with and without ``device_decode``, summaries included) against the JAX
Trainer's, and a
mid-epoch ``--cont`` that completes the epoch. The JAX package's native
chunk decoder is switched off here so that both sides decode float
features with the same numpy codec and the batches compare bit for bit."""

import os

import jax
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu import data as jdata
from tf_kaldi_speaker_tpu.kio import native_decode
from tf_kaldi_speaker_tpu.parallel.mesh import make_mesh
from tf_kaldi_speaker_tpu.train.trainer import Trainer as JaxTrainer
from tf_kaldi_speaker_tpu.utils import summary as jsummary
from tf_kaldi_speaker_tpu.utils.params import ParamsPlain as JaxParams
from tf_kaldi_speaker_tpu_torch import convert
from tf_kaldi_speaker_tpu_torch import data as tdata
from tf_kaldi_speaker_tpu_torch.train import checkpoints
from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
from tf_kaldi_speaker_tpu_torch.utils import summary as tsummary
from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain
from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

torch.set_num_threads(1)

DIM = 10
TINY = dict(
    seed=3, network_type="tdnn", tdnn_layer_size=16, num_nodes_pooling_layer=24,
    num_nodes_last_layer=12, pooling_type="statistics_pooling", embedding_node="tdnn6_dense",
    last_layer_linear=True, loss_func="additive_margin_softmax", amsoftmax_m=0.2,
    amsoftmax_lambda_min=0, amsoftmax_lambda_base=1000, amsoftmax_lambda_gamma=1e-4,
    amsoftmax_lambda_power=5, optimizer="momentum", momentum=0.9, weight_l2_regularizer=1e-2,
    batchnorm_momentum=0.99, use_fused_pooling=False, num_speakers_per_batch=4,
    num_segments_per_speaker=2, min_segment_len=40, max_segment_len=56,
    num_steps_per_epoch=4, steps_per_dispatch=2, num_parallel_datasets=1, max_queue_size=4,
    show_training_progress=0)


@pytest.fixture(autouse=True)
def numpy_decode(monkeypatch):
    monkeypatch.setattr(native_decode, "_get_lib", lambda: None)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream")
    return make_fake_data_dir(str(root / "cm"), num_speakers=6, utts_per_speaker=3, dim=DIM,
                              min_len=60, max_len=150, seed=5)


@pytest.mark.parametrize("raw_codes", [False, True], ids=["features", "codes"])
@pytest.mark.parametrize("group", [1, 2])
def test_random_queue_matches_jax(corpus, raw_codes, group):
    """One worker: the first three batches (or groups) bit-equal."""
    kw = dict(num_parallel=1, max_qsize=2, num_speakers=4, num_segments=2, min_len=40,
              max_len=56, seed=9, raw_codes=raw_codes, group=group)
    tq = tdata.KaldiDataRandomQueue(corpus["data"], corpus["spklist"], **kw).start()
    jq = jdata.KaldiDataRandomQueue(corpus["data"], corpus["spklist"], **kw).start()
    try:
        assert tq.num_total_speakers == jq.num_total_speakers == 6
        for _ in range(3):
            got, want = tq.fetch(), jq.fetch()
            assert len(got) == len(want) == (3 if raw_codes else 2)
            assert got[0].shape[:1] == ((group,) if group > 1 else (8,))
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    finally:
        tq.stop()
        jq.stop()


@pytest.mark.parametrize("threaded", [True, False])
def test_device_prefetch_on_the_cpu(threaded):
    """On the CPU device the batches come through as tensors, in order; a
    worker's exception reaches the consumer."""
    batches = [(np.full((2, 3), i, np.float32), np.arange(2, dtype=np.int32) + i)
               for i in range(5)]
    got = list(tdata.device_prefetch(iter(batches), "cpu", threaded=threaded))
    assert len(got) == 5
    for (f, l), (a, b) in zip(got, batches):
        assert isinstance(f, torch.Tensor) and f.dtype == torch.float32
        np.testing.assert_array_equal(f.numpy(), a)
        np.testing.assert_array_equal(l.numpy(), b)

    def broken():
        yield batches[0]
        raise OSError("bad ark")

    it = tdata.device_prefetch(broken(), "cpu", threaded=threaded)
    next(it)
    with pytest.raises(OSError, match="bad ark"):
        next(it)
    with pytest.raises(ValueError, match="no transfer"):
        next(tdata.device_prefetch(iter(batches), "meta"))


def _losses(trainer_cls, log):
    """Record each group's mean loss at _post_group (both trainers pass
    the metrics third)."""
    orig = trainer_cls._post_group

    def post_group(self, cfg, *args, **kw):
        log.append(float(args[1]["loss"]))
        return orig(self, cfg, *args, **kw)

    return orig, post_group


@pytest.mark.parametrize("device_decode", [False, True], ids=["host_decode", "device_decode"])
def test_streamed_epoch_matches_jax(corpus, tmp_path, monkeypatch, device_decode):
    """One float32 epoch of 4 steps in groups of K = 2 from the streaming
    loader (one worker), from the JAX Trainer's initial variables: the
    group losses and the final parameters and statistics within rtol 2e-4
    (atol 1e-6; the biases that a BatchNorm follows carry only rounding
    noise and are left out), the step and the checkpoint; and the summaries
    written every 2 steps: the JAX Trainer's tags at its steps, values
    within rtol 2e-4 (atol 1e-7 for the zero penalty)."""
    cfg = dict(TINY, device_decode=device_decode, save_summary_steps=2)
    jt = JaxTrainer(JaxParams(**cfg), str(tmp_path / "jax"), dim=DIM, num_speakers=6,
                    mesh=make_mesh(devices=jax.devices()[:1]))
    jt.build("train", DIM, cfg["loss_func"], 6)
    t = Trainer(ParamsPlain(**cfg), str(tmp_path / "port"), dim=DIM, num_speakers=6,
                device="cpu")
    t.build("train", DIM, cfg["loss_func"], 6)
    convert.load_variables(t.network_model, {
        "params": jax.device_get(jt.state.params),
        "batch_stats": jax.device_get(jt.state.batch_stats)})
    want, got = [], []
    for cls, log in ((JaxTrainer, want), (Trainer, got)):
        monkeypatch.setattr(cls, "_post_group", _losses(cls, log)[1])
    jt.train(corpus["data"], corpus["spklist"], 0.02)
    t.train(corpus["data"], corpus["spklist"], 0.02)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert t.step == int(jt.state.step) == 4
    flat = convert.flatten({"params": jax.device_get(jt.state.params),
                            "batch_stats": jax.device_get(jt.state.batch_stats)})
    mine = convert.flatten(convert.variables_of(t.network_model))
    assert sorted(mine) == sorted(flat)
    for path, w in flat.items():
        if path[-1] == "bias" and path[-2].endswith(("_conv", "_dense")):
            continue
        np.testing.assert_allclose(np.asarray(mine[path]), np.asarray(w), rtol=2e-4,
                                   atol=1e-6, err_msg="/".join(path))
    assert checkpoints.read_pointer(t.model) == 4
    assert os.path.exists(os.path.join(t.model, "model-4.pt"))
    want = jsummary.load_scalars(str(tmp_path / "jax" / "events.jsonl"))
    got = tsummary.load_scalars(str(tmp_path / "port" / "events.jsonl"))
    assert sorted(got) == sorted(want) == ["accuracy", "loss", "penalty_loss",
                                           "regularization_loss", "total_loss"]
    for tag in want:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]] == [2, 4]
        np.testing.assert_allclose([v for _, v in got[tag]], [v for _, v in want[tag]],
                                   rtol=2e-4, atol=1e-7, err_msg=tag)


def test_mid_epoch_cont_completes_the_epoch(corpus, tmp_path):
    """--cont from a mid-epoch checkpoint runs only the remainder of the
    epoch (JAX: tests/test_trainer.py::test_mid_epoch_resume_completes_epoch)."""
    cfg = dict(TINY, num_steps_per_epoch=6, save_checkpoints_steps=4, device_decode=True)
    nnet = str(tmp_path / "nnet")
    t = Trainer(ParamsPlain(**cfg), nnet, dim=DIM, num_speakers=6, device="cpu")
    t.build("train", DIM, cfg["loss_func"], 6)
    t.train(corpus["data"], corpus["spklist"], 0.02)
    assert t.step == 6 and checkpoints.list_steps(nnet) == [4, 6]
    u = Trainer(ParamsPlain(**cfg), nnet, dim=DIM, num_speakers=6, device="cpu")
    u.build("train", DIM, cfg["loss_func"], 6)
    assert u.load(4) == 4
    u.train(corpus["data"], corpus["spklist"], 0.02)
    assert u.step == 6  # the remainder only, not 4 + 6
