"""Preemption in the port (the cases of tests/test_preemption.py): a stop
request ends the epoch at the next group boundary with a checkpoint at the
exact step, and clearing it resumes the remainder of the epoch, from the
streaming loader and from the device pool; an unacknowledged flag does not
exit; validation polls at every batch; and cli.train --device cpu
answers SIGTERM with a checkpoint and exit 75, after which --cont finishes
the epoch."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from tf_kaldi_speaker_tpu_torch.train import checkpoints
from tf_kaldi_speaker_tpu_torch.train.preemption import EXIT_PREEMPTED, exit_code_if_preempted
from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
from tf_kaldi_speaker_tpu_torch.utils import bookkeeping as bk
from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain
from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = dict(
    seed=0, network_type="tdnn", tdnn_layer_size=16,
    num_nodes_pooling_layer=32, num_nodes_last_layer=16,
    pooling_type="statistics_pooling", embedding_node="tdnn6_dense",
    loss_func="softmax", learning_rate=0.05, optimizer="sgd",
    weight_l2_regularizer=1e-4, batchnorm_momentum=0.99,
    num_epochs=1, num_steps_per_epoch=16, steps_per_dispatch=4,
    show_training_progress=2, keep_checkpoint_max=0,
    save_checkpoints_steps=16, valid_max_iterations=2,
    num_parallel_datasets=1, max_queue_size=4,
    num_speakers_per_batch=8, num_segments_per_speaker=1,
    min_segment_len=48, max_segment_len=64, batch_type="softmax",
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("preempt")
    kw = dict(num_speakers=8, dim=20, min_len=80, max_len=120)
    return (make_fake_data_dir(str(root / "train"), utts_per_speaker=4, **kw),
            make_fake_data_dir(str(root / "valid"), utts_per_speaker=2, seed=7, **kw))


def _trainer(path, **overrides):
    t = Trainer(ParamsPlain(**dict(CFG, **overrides)), str(path), dim=20, num_speakers=8,
                device="cpu")
    t.build("train", 20, CFG["loss_func"], 8)
    return t


@pytest.mark.parametrize("device_pool", [False, True], ids=["stream", "pool"])
def test_request_stop_breaks_at_group_boundary(corpus, tmp_path, device_pool):
    train = corpus[0]
    t = _trainer(tmp_path / "m" / "nnet", device_pool=device_pool)
    t.request_stop()
    t.train(train["data"], train["spklist"], 0.05)
    # one group of K = 4 of the 16 steps, checkpoint at exactly that step
    assert t.step == 4 and checkpoints.read_pointer(t.model) == 4
    assert exit_code_if_preempted(t) == EXIT_PREEMPTED
    # clearing the flag resumes the remainder of the epoch
    t._stop_requested = False
    t.train(train["data"], train["spklist"], 0.05)
    assert t.step == 16 and checkpoints.read_pointer(t.model) == 16
    assert not t.stop_requested and exit_code_if_preempted(t) is None
    t.close()


def test_unacknowledged_local_flag_does_not_exit(tmp_path):
    """A SIGTERM after the loop's last poll sets only the flag; the exit
    waits for the next phase's first poll to acknowledge it."""
    t = _trainer(tmp_path / "m" / "nnet")
    t._stop_requested = True
    assert exit_code_if_preempted(t) is None
    assert t._should_stop()
    assert exit_code_if_preempted(t) == EXIT_PREEMPTED


def test_stop_during_valid_breaks_early(corpus, tmp_path):
    """Both validation passes break at their first batch boundary."""
    valid = corpus[1]
    t = _trainer(tmp_path / "m" / "nnet")
    t.request_stop()
    loss, emb, labels = t.valid(valid["data"], valid["spklist"], output_embeddings=True)
    assert emb.shape[0] == 0 and labels.shape[0] == 0
    assert loss != loss  # NaN: mean over no batch
    assert exit_code_if_preempted(t) == EXIT_PREEMPTED


def test_cli_sigterm_checkpoints_and_resumes(corpus, tmp_path):
    """cli.train --device cpu from the streaming loader: SIGTERM after the
    first progress line gives exit 75, a checkpoint at a multiple of K and
    no valid_loss line; --cont then finishes at num_steps_per_epoch."""
    train, valid = corpus
    cfg = dict(CFG, num_steps_per_epoch=60, steps_per_dispatch=2, save_checkpoints_steps=60)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    model = str(tmp_path / "model")
    env = dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    args = [train["data"], train["spklist"], valid["data"], valid["spklist"], model]
    cmd = [sys.executable, "-m", "tf_kaldi_speaker_tpu_torch.cli.train", "--device", "cpu"]
    proc = subprocess.Popen(cmd + ["--config", str(cfg_path)] + args, env=env, cwd=REPO,
                            text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lines, deadline = [], time.time() + 120
    for line in proc.stdout:
        lines.append(line)
        if "step " in line and ": loss" in line:
            break
        if time.time() > deadline:
            proc.kill()
            pytest.fail("no training step within 120 s:\n" + "".join(lines))
    proc.send_signal(signal.SIGTERM)
    lines.extend(proc.stdout)
    rc = proc.wait(timeout=120)
    tail = "".join(lines[-40:])
    assert rc == EXIT_PREEMPTED, (rc, tail)
    assert "preempted: checkpoint saved at step" in tail
    nnet = os.path.join(model, "nnet")
    step = checkpoints.read_pointer(nnet)
    assert step is not None and 0 < step < 60 and step % 2 == 0, (step, tail)
    assert bk.load_valid_loss(os.path.join(nnet, "valid_loss")) == []
    cont = subprocess.run(cmd + ["--cont"] + args, env=env, cwd=REPO, text=True, timeout=300,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    assert cont.returncode == 0, cont.stdout[-4000:]
    assert checkpoints.read_pointer(nnet) == 60, cont.stdout[-2000:]
    (epoch, loss, _), = bk.load_valid_loss(os.path.join(nnet, "valid_loss"))
    assert epoch == 1 and np.isfinite(loss)
