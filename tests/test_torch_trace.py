"""The port's spans (``utils/summary.span``) on the CPU: nothing recorded
and no profiler range entered with the profiler off; under
``with profile()`` and ``prof.start()``/``stop()`` the spans in the
profiler's events, nested as opened, and the table's self time; a span
inside one opened before the profiler left out; and a device-pool epoch's
spans, one ``train.group`` and one ``pool.sample_group`` a group and K
``train.step``."""

import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
from tf_kaldi_speaker_tpu_torch.utils import summary
from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain
from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

torch.set_num_threads(1)

DIM = 10
# test_torch_pool.py's tiny pool trainer
TINY = dict(
    seed=3, network_type="tdnn", tdnn_layer_size=16, num_nodes_pooling_layer=24,
    num_nodes_last_layer=12, pooling_type="statistics_pooling", embedding_node="tdnn6_dense",
    last_layer_linear=True, loss_func="additive_margin_softmax", amsoftmax_m=0.2,
    amsoftmax_lambda_min=0, amsoftmax_lambda_base=1000, amsoftmax_lambda_gamma=1e-4,
    amsoftmax_lambda_power=5, optimizer="momentum", momentum=0.9, weight_l2_regularizer=1e-2,
    batchnorm_momentum=0.99, use_fused_pooling=True, device_pool=True,
    num_speakers_per_batch=4, num_segments_per_speaker=2, min_segment_len=48,
    max_segment_len=48, num_steps_per_epoch=4, steps_per_dispatch=2,
    show_training_progress=0)


@pytest.fixture(autouse=True)
def clean_table():
    summary.reset_spans()
    yield
    summary.reset_spans()


def _events(prof, names):
    """(name, start, end) of the profiler's events named in ``names``, in
    start order."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events() if e.name() in names),
                  key=lambda e: e[1])


def _nest():
    with summary.span("outer"):
        with summary.span("inner"):
            torch.ones(4).sum()
        with summary.span("inner"):
            with summary.span("leaf"):
                torch.ones(4).sum()


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    entered = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda *a, **k: entered.append(a))
    _nest()
    assert summary.span_table() == {} and entered == []
    assert summary._open.stack == []


@pytest.mark.parametrize("how", ["with", "start"])
def test_spans_in_the_profiler_nested_with_self_time(how):
    if how == "with":
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _nest()
    else:
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        _nest()
        prof.stop()
    got = _events(prof, {"outer", "inner", "leaf"})
    assert [n for n, _, _ in got] == ["outer", "inner", "inner", "leaf"]
    (_, o0, o1), (_, a0, a1), (_, b0, b1), (_, c0, c1) = got
    assert o0 <= a0 <= a1 <= b0 <= c0 <= c1 <= b1 <= o1
    table = summary.span_table()
    assert {k: v["count"] for k, v in table.items()} == {"outer": 1, "inner": 2, "leaf": 1}
    assert table["outer"]["self_ns"] == table["outer"]["total_ns"] - table["inner"]["total_ns"]
    assert table["inner"]["self_ns"] == table["inner"]["total_ns"] - table["leaf"]["total_ns"]
    assert table["leaf"]["self_ns"] == table["leaf"]["total_ns"] > 0
    # no CUDA device named: no stream polled
    assert all(v["polled"] == v["drained"] == 0 for v in table.values())


def test_span_is_a_host_op():
    """A span is a host op's range, not a user annotation (which the CUDA
    profiler mirrors onto the device's timeline)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with summary.span("group"):
            pass
    (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "group"]
    assert not e.is_user_annotation()


def test_span_opened_before_the_profiler_is_left_out():
    prof = profile(activities=[ProfilerActivity.CPU])
    with summary.span("group"):
        prof.start()
        with summary.span("inner"):
            torch.ones(4).sum()
    with summary.span("group"):
        with summary.span("inner"):
            torch.ones(4).sum()
    prof.stop()
    assert [n for n, _, _ in _events(prof, {"group", "inner"})] == ["group", "inner"]
    table = summary.span_table()
    assert table["group"]["count"] == table["inner"]["count"] == 1
    assert table["group"]["self_ns"] == table["group"]["total_ns"] - table["inner"]["total_ns"]


def test_stacks_are_per_thread():
    """A span open in another thread (not recorded: the profiler records the
    thread that started it) is no parent of this thread's spans."""
    opened, done = threading.Event(), threading.Event()

    def other():
        with summary.span("other"):
            opened.set()
            done.wait(30)

    t = threading.Thread(target=other)
    t.start()
    try:
        assert opened.wait(30)
        with profile(activities=[ProfilerActivity.CPU]):
            with summary.span("main"):
                with summary.span("leaf"):
                    pass
    finally:
        done.set()
        t.join(30)
    assert not t.is_alive()
    table = summary.span_table()
    assert {k: v["count"] for k, v in table.items()} == {"main": 1, "leaf": 1}
    assert table["main"]["self_ns"] == table["main"]["total_ns"] - table["leaf"]["total_ns"]


def test_pool_epoch_spans(tmp_path):
    """An epoch of 3 groups of K = 2 from the device pool under the
    profiler: each group one ``train.group`` holding one
    ``pool.sample_group`` and K ``train.step``, then the ask that finds the
    epoch's end, a ``train.group`` that holds nothing; the children and
    the groups' self time add up to the groups' time."""
    d = make_fake_data_dir(str(tmp_path / "cm"), num_speakers=6, utts_per_speaker=3, dim=DIM,
                           min_len=60, max_len=150, seed=5)
    cfg = dict(TINY, num_steps_per_epoch=6, show_training_progress=2)
    t = Trainer(ParamsPlain(**cfg), str(tmp_path / "port"), dim=DIM, num_speakers=6,
                device="cpu")
    t.build("train", DIM, cfg["loss_func"], 6)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.train(d["data"], d["spklist"], 0.02)
    t.close()
    assert t.step == 6
    table = summary.span_table()
    counts = {k: v["count"] for k, v in table.items()}
    # the progress line at steps 2, 4 and 6 reads the metrics: one sync a group
    assert counts == {"train.group": 4, "pool.sample_group": 3, "train.step": 6,
                      "train.sync": 3}
    group = table["train.group"]
    assert group["total_ns"] == group["self_ns"] + sum(
        table[k]["total_ns"] for k in ("pool.sample_group", "train.step", "train.sync"))
    got = _events(prof, set(counts))
    groups = [(a, b) for n, a, b in got if n == "train.group"]
    assert len(groups) == 4
    inside = [sum(g0 <= a <= b <= g1 for n, a, b in got if n != "train.group")
              for g0, g1 in groups]
    assert inside == [1 + 2 + 1] * 3 + [0]
    for n, a, b in got:
        assert sum(g0 <= a <= b <= g1 for g0, g1 in groups) == 1
