"""The multitask loader's and trainer's batch order with one loader worker,
on the CPU: two runs of one config see the same batches and end bit-equal.

``PrefetchLoader`` runs one sampler a worker, seeded ``seed + worker_id``,
and its workers feed one queue in whatever order they finish, so over
several workers two trainings of one config see different batches. Every
comparison of two trainings (card against CPU, run against run, port
against JAX) therefore runs one worker; the card test
``tests/test_torch_gpu.py::test_multitask_on_card_matches_cpu`` shares
``MT_TINY``, ``MT_CORPUS`` and ``train_epoch`` with these tests, whose
lockstep is held here too. No test here asserts that two workers differ:
whether they do depends on thread timing."""

import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu_torch.convert import flatten, variables_of
from tf_kaldi_speaker_tpu_torch.multitask import TrainerMultiTask
from tf_kaldi_speaker_tpu_torch.multitask.data_v2 import KaldiDataRandomQueueV2
from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain
from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir
from torch_mt_tiny import MT_CORPUS, MT_TINY, train_epoch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = make_fake_data_dir(str(tmp_path_factory.mktemp("mt_order") / "d"), **MT_CORPUS)
    return d["data"], d["ali_dir"], d["spklist"]


def test_one_worker_v2_queue_repeats(corpus):
    """Two one-worker V2 queues from one seed: 3 groups of 2 batches each,
    every array bit-equal."""
    runs = []
    for _ in range(2):
        q = KaldiDataRandomQueueV2(
            *corpus, MT_TINY["phone_left_context"], MT_TINY["phone_right_context"],
            num_parallel=1, max_qsize=2, num_speakers=MT_TINY["num_speakers_per_batch"],
            min_len=MT_TINY["min_segment_len"], max_len=MT_TINY["max_segment_len"],
            seed=MT_TINY["seed"], group=2).start()
        try:
            runs.append([q.fetch() for _ in range(3)])
        finally:
            q.stop()
    for first, second in zip(*runs):
        assert len(first) == len(second) == 7
        assert first[0].shape[0] == 2
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a, b)


def test_one_worker_epoch_repeats(corpus, tmp_path):
    """Two CPU TrainerMultiTask epochs of the card test's config (one
    worker, 2 groups of 2 steps): every parameter and BatchNorm statistic
    bit-equal, and the egs counts equal."""
    assert MT_TINY["num_parallel_datasets"] == 1
    trainers = []
    for run in range(2):
        t = TrainerMultiTask(ParamsPlain(**MT_TINY), str(tmp_path / str(run) / "nnet"),
                             dim=MT_CORPUS["dim"], num_speakers=MT_CORPUS["num_speakers"],
                             num_phones=MT_CORPUS["num_phones"], device="cpu")
        t.build("train", MT_CORPUS["dim"], num_speakers=MT_CORPUS["num_speakers"],
                num_phones=MT_CORPUS["num_phones"])
        t.train(*corpus, MT_TINY["learning_rate"])
        assert t.step == MT_TINY["num_steps_per_epoch"]
        trainers.append(t)
    got, want = (flatten(variables_of(t.network_model)) for t in trainers)
    assert set(got) == set(want)
    for path, w in want.items():
        torch.testing.assert_close(got[path], w, rtol=0, atol=0, msg=str(path))
    for name in ("speaker_egs", "phone_egs"):
        np.testing.assert_array_equal(getattr(trainers[0], name), getattr(trainers[1], name))


def test_lockstep_epoch_starts_each_step_from_the_other_run(corpus, tmp_path):
    """``train_epoch`` in lockstep (the card test's comparison): a run whose
    initial weights were scaled by 1.01 loads each start state of a plain
    run before its step, and so ends every step bit-equal to the plain
    run; it starts the epoch from the plain run's weights, not its own."""
    trainers = []
    for run in range(2):
        t = TrainerMultiTask(ParamsPlain(**MT_TINY), str(tmp_path / str(run) / "nnet"),
                             dim=MT_CORPUS["dim"], num_speakers=MT_CORPUS["num_speakers"],
                             num_phones=MT_CORPUS["num_phones"], device="cpu")
        t.build("train", MT_CORPUS["dim"], num_speakers=MT_CORPUS["num_speakers"],
                num_phones=MT_CORPUS["num_phones"])
        trainers.append(t)
    with torch.no_grad():
        for p in trainers[1].network_model.parameters():
            p.mul_(1.01)
    kernel = ("params", "conv1", "kernel")
    own = flatten(variables_of(trainers[1].network_model))[kernel].clone()
    losses, starts, want = train_epoch(trainers[0], corpus)
    got_losses, got_starts, got = train_epoch(trainers[1], corpus, starts)
    assert len(got) == len(want) == len(starts) == MT_TINY["num_steps_per_epoch"]
    assert got_losses == losses
    for (gv, go), (wv, wo) in zip(got_starts, starts):
        for path, w in flatten(wv).items():
            assert torch.equal(flatten(gv)[path], w), path
        assert all(torch.equal(a, b) for a, b in zip(go["trace"], wo["trace"]))
    for g, w in zip(got, want):
        for path in w:
            assert torch.equal(g[path], w[path]), path
    assert not torch.equal(own, flatten(starts[0][0])[kernel])
