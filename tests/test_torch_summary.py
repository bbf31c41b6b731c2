"""Summaries and profiling in the port against the JAX package on the CPU:
the tfevents encoder and writer byte for byte (time fixed), the JSONL
record (all but the wall time), the readers, the activation statistics,
the trainer's profiler window and its spans, and a streamed epoch that
writes summaries every save_summary_steps (scalars and per-parameter
histograms under the JAX names) and a Chrome trace for its profile_steps
window."""

import collections
import glob
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu.utils import summary as jsummary
from tf_kaldi_speaker_tpu.utils import tb_events as jtb
from tf_kaldi_speaker_tpu_torch import convert
from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
from tf_kaldi_speaker_tpu_torch.utils import summary as tsummary
from tf_kaldi_speaker_tpu_torch.utils import tb_events as ttb
from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain
from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

torch.set_num_threads(1)

SCALARS = {"accuracy": 0.375, "loss": 2.0625, "penalty_loss": 0.0,
           "regularization_loss": 0.01171875, "total_loss": 2.07421875}


def _histograms():
    rng = np.random.RandomState(0)
    return {"network/tdnn/tdnn1_conv/kernel": rng.randn(5, 3, 4).astype(np.float32),
            "softmax/output_kernel": rng.randn(7).astype(np.float32) * 1e-3,
            "empty": np.zeros((0,), np.float32)}


@pytest.mark.parametrize("step", [0, 1, 300000])
def test_encode_event_bytes_equal(step):
    """Event protos with the file version, scalars and histograms: the
    same bytes from both encoders; the CRCs too."""
    for kw in (dict(file_version="brain.Event:2"), dict(scalars=SCALARS),
               dict(histograms=_histograms()), dict(scalars=SCALARS, histograms=_histograms())):
        got = ttb._encode_event(1760000000.25, step=step, **kw)
        assert got == jtb._encode_event(1760000000.25, step=step, **kw)
        assert ttb._masked_crc(got) == jtb._masked_crc(got)


def test_writers_bytes_equal(tmp_path, monkeypatch):
    """Both SummaryWriters, with time.time fixed: equal tfevents files
    (name and bytes), equal JSONL records but for the wall time, and the
    readers give back what was written."""
    for side, mod in (("port", tsummary), ("jax", jsummary)):
        clock = iter(np.arange(1760000000.0, 1760000100.0, 0.5))  # the same ticks each
        monkeypatch.setattr(time, "time", lambda: float(next(clock)))
        w = mod.SummaryWriter(str(tmp_path / side))
        w.scalars(8, SCALARS)
        w.histograms(8, _histograms())
        w.scalars(16, dict(SCALARS, loss=1.5))
        w.close()
    (a,), (b,) = (glob.glob(str(tmp_path / s / "events.out.tfevents.*")) for s in ("port", "jax"))
    assert os.path.basename(a) == os.path.basename(b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    recs = []
    for side in ("port", "jax"):
        with open(tmp_path / side / "events.jsonl") as f:
            recs.append([json.loads(line) for line in f])
    for r in recs:
        for rec in r:
            rec.pop("wall")
    assert recs[0] == recs[1] and [r["step"] for r in recs[0]] == [8, 16]
    assert ttb.read_tfevents(a) == jtb.read_tfevents(b)
    assert tsummary.load_scalars(str(tmp_path / "port" / "events.jsonl")) == \
        jsummary.load_scalars(str(tmp_path / "jax" / "events.jsonl"))


def test_activation_summaries_match_jax():
    rng = np.random.RandomState(1)
    eps = {"relu": np.maximum(rng.randn(4, 6, 3), 0).astype(np.float32),
           "dense": rng.randn(4, 5).astype(np.float32), "step": np.float32(3.0),
           "labels": np.arange(4, dtype=np.int32)}
    got = tsummary.activation_summaries({k: torch.from_numpy(np.asarray(v))
                                         for k, v in eps.items()})
    want = jsummary.activation_summaries({k: jnp.asarray(v) for k, v in eps.items()})
    assert sorted(got) == sorted(want) == sorted(
        "%s/%s" % (k, s) for k in ("relu", "dense") for s in ("mean", "std", "zero_frac"))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """The trainer's profile_steps window (start_trace / stop_trace) over a
    streamed epoch of 16 steps in groups of 2 leaves one Chrome trace under
    <model>/profile that holds the loop's spans: whole groups
    (``train.group``) and their steps (``train.step``)."""
    d = make_fake_data_dir(str(tmp_path / "cm"), num_speakers=6, utts_per_speaker=3, dim=10,
                           min_len=60, max_len=150, seed=5)
    cfg = dict(seed=3, network_type="tdnn", tdnn_layer_size=8, num_nodes_pooling_layer=12,
               num_nodes_last_layer=8, pooling_type="statistics_pooling",
               embedding_node="tdnn6_dense", loss_func="softmax", optimizer="sgd",
               num_speakers_per_batch=4, num_segments_per_speaker=2, min_segment_len=40,
               max_segment_len=56, num_steps_per_epoch=16, steps_per_dispatch=2,
               num_parallel_datasets=1, show_training_progress=0, profile_steps=2,
               device_decode=True)
    t = Trainer(ParamsPlain(**cfg), str(tmp_path / "port"), dim=10, num_speakers=6,
                device="cpu")
    t.build("train")
    try:
        t.train(d["data"], d["spklist"], 0.05)
    finally:
        tsummary.reset_spans()
    (path,) = glob.glob(str(tmp_path / "port" / "profile" / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = collections.Counter(e.get("name") for e in events)
    # the window opens in group 5's bookkeeping (that group is left out)
    # and closes in group 7's: groups 6 and 7, two steps each
    assert names["train.group"] == 2 and names["train.step"] == 4


def test_trainer_summaries_and_profile(tmp_path):
    """A streamed epoch of 16 steps in groups of 2 with save_summary_steps 4
    and profile_steps 2: the JSONL and tfevents scalars carry the JAX
    step's metric tags at steps 4, 8, 12 and 16 (tests/test_torch_stream.py
    holds them to the JAX Trainer's), a histogram record for every
    parameter under its JAX name follows each scalar record, and the
    profiler window (groups 5 to 7, the JAX group indices) leaves one
    Chrome trace under <model>/profile."""
    d = make_fake_data_dir(str(tmp_path / "cm"), num_speakers=6, utts_per_speaker=3, dim=10,
                           min_len=60, max_len=150, seed=5)
    cfg = dict(seed=3, network_type="tdnn", tdnn_layer_size=8, num_nodes_pooling_layer=12,
               num_nodes_last_layer=8, pooling_type="statistics_pooling",
               embedding_node="tdnn6_dense", loss_func="softmax", optimizer="sgd",
               weight_l2_regularizer=1e-2, num_speakers_per_batch=4, num_segments_per_speaker=2,
               min_segment_len=40, max_segment_len=56, num_steps_per_epoch=16,
               steps_per_dispatch=2, num_parallel_datasets=1, show_training_progress=0,
               save_summary_steps=4, profile_steps=2, device_decode=True)
    t = Trainer(ParamsPlain(**cfg), str(tmp_path / "port"), dim=10, num_speakers=6,
                device="cpu")
    t.build("train")
    t.train(d["data"], d["spklist"], 0.05)
    got = tsummary.load_scalars(str(tmp_path / "port" / "events.jsonl"))
    assert sorted(got) == sorted(SCALARS)
    for tag, values in got.items():
        assert [s for s, _ in values] == [4, 8, 12, 16] and np.isfinite([v for _, v in values]).all()
    (events,) = glob.glob(str(tmp_path / "port" / "events.out.tfevents.*"))
    scalars = ttb.read_tfevents(events)
    assert sorted(scalars) == sorted(SCALARS)
    np.testing.assert_allclose([v for _, v in scalars["loss"]], [v for _, v in got["loss"]],
                               rtol=1e-6)  # float32 in the proto
    names = [convert.jax_name(n) for n, _ in t.network_model.named_parameters()]
    assert "network/tdnn/tdnn1_conv/kernel" in names and "softmax/output_kernel" in names
    with open(events, "rb") as f:
        blob = f.read()
    for name in names:
        assert blob.count(name.encode()) == 4, name
    assert len(glob.glob(str(tmp_path / "port" / "profile" / "*.pt.trace.json"))) == 1
