"""chip_smoke.py without a card: its bound arithmetic, its configurations,
the helpers of its streaming, fine-tuning and profiling phases, and that it
exits non-zero and prints no result where CUDA is not available, both from
the repository and alone in an empty directory."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# Bytes each kernel must move: every input read once, every output written
# once (the bf16 pooling reads x and the f32 mask and writes [B, 2D] bf16;
# its backward reads x, the mask, out and g and writes gx).
@pytest.mark.parametrize("cost, shape, nbytes", [
    ("pooling", (32, 386, 1500, 2), 37_297_408),
    ("pooling", (32, 386, 1500, 4), 74_545_408),
    ("dequant", (32, 400, 30), 1_935_360),
    ("dequant", (256, 1200, 30), 46_202_880),
    ("pooling_bwd", (64, 286, 1500, 2), 110_665_216),
    ("pooling_bwd", (64, 286, 1500, 4), 221_257_216),
    ("pooling_bwd", (1, 1, 4, 2), 1 * 1 * 4 * 2 * 2 + 4 + 4 * 4 * 2),
])
def test_kernel_bytes(cost, shape, nbytes):
    cs = _chip_smoke()
    got, flops = getattr(cs, cost + "_cost")(*shape)
    assert got == nbytes
    ms, by = cs.bound_ms(got, flops)
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / cs.HBM_BYTES_PER_S)


def test_bound_takes_the_larger_time():
    cs = _chip_smoke()
    assert cs.bound_ms(3.35e9, 0) == pytest.approx((1.0, "bytes"))
    ms, by = cs.bound_ms(0, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_exits_nonzero_without_cuda(where, tmp_path):
    if where == "repo":
        cwd, script = ROOT, SCRIPT
    else:
        cwd, script = str(tmp_path), shutil.copy(SCRIPT, tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("args, said", [(["--mt-step-spread"], None),
                                         (["--mt-epoch-spread"], None),
                                         (["--bogus"], "usage: python3 chip_smoke.py"),
                                         (["--kernels"], None),
                                         (["--kernels", "a.json", "b.json"],
                                          "usage: python3 chip_smoke.py")])
def test_arguments_without_cuda(args, said):
    """The spread and kernel forms need the card as the plain form does;
    any other argument, or --kernels with more than its one file, is
    refused with the usage line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, SCRIPT] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    assert said is None or said in proc.stderr


class _Recorder:
    """A stub of what time_ms touches: the flush buffer, the card's spin and
    CUDA events, each call appended to ``calls``."""

    def __init__(self):
        self.calls = []
        self.events = 0
        rec = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                self.name = ("start", "end")[rec.events % 2]
                rec.events += 1

            def record(self):
                rec.calls.append(self.name)

            def synchronize(self):
                rec.calls.append("wait " + self.name)

            def elapsed_time(self, other):
                assert (self.name, other.name) == ("start", "end")
                return 0.25

        self.torch = types.SimpleNamespace(cuda=types.SimpleNamespace(
            Event=Event, synchronize=lambda: rec.calls.append("synchronize"),
            _sleep=lambda cycles: rec.calls.append(("spin", cycles))))

    def fn(self):
        self.calls.append("fn")


class _Flush:
    """A flush buffer that records a read (sum) and any other use."""

    def __init__(self, calls):
        self.__dict__["calls"] = calls

    def sum(self):
        self.calls.append("read")

    def __getattr__(self, name):
        self.calls.append("write " + name)
        return lambda *a, **k: None

    def __setattr__(self, name, value):
        self.calls.append("write " + name)

    def __setitem__(self, key, value):
        self.calls.append("write []")


def test_time_ms_reads_spins_then_times():
    """Each timed call: a read of the flush buffer (never written), a spin
    of about SPIN_US, the start event, the call, the end event; the median
    of the events' times."""
    cs = _chip_smoke()
    rec = _Recorder()
    assert cs.time_ms(rec.torch, rec.fn, _Flush(rec.calls), runs=3, warmup=2) == 0.25
    cycles = int(cs.SPIN_US * cs.SM_MHZ)
    assert 40e-6 <= cycles / (cs.SM_MHZ * 1e6) <= 60e-6
    assert rec.calls == ["fn", "fn", "synchronize"] + [
        "read", ("spin", cycles), "start", "fn", "end", "wait end"] * 3
    assert not any(str(c).startswith("write") for c in rec.calls)


def test_replayed_mixes_round_trip(tmp_path, monkeypatch):
    """replay_mix keeps each mix it replays; the file main() writes from
    them gives replay_saved the same shapes and counts."""
    import collections

    cs = _chip_smoke()
    seen = []

    def measure(torch, g, shape, *args):
        seen.append(tuple(shape))
        return dict(max_abs_err=0.0, ms=2.0, bound_ms=1.0)

    for name in ("measure_dequant", "measure_pooling", "measure_pooling_bwd"):
        monkeypatch.setattr(cs, name, measure)
    torch = types.SimpleNamespace(Generator=lambda device=None: types.SimpleNamespace(
        manual_seed=lambda s: None), bfloat16="bf16", float32="f32")
    shapes = {"masked_stats_pooling_backward": collections.Counter(
        {((64, 286, 1500), "bfloat16"): 3, ((64, 186, 1500), "bfloat16"): 1}),
        "cm_dequantize": collections.Counter({((64, 296, 30), "float32"): 4})}
    rows = {name: dict(max_abs_err=0.0) for name in cs.SOURCES}
    cs.REPLAYED.clear()
    cs.replay_mix(torch, shapes, rows, None, prefix="train_mix_")
    path = cs.write_json(str(tmp_path / "shapes.json"), cs.REPLAYED)
    again = {name: dict(max_abs_err=0.0) for name in cs.SOURCES}
    cs.replay_saved(torch, path, again, None)
    assert again == rows
    assert rows["masked_stats_pooling_backward"]["train_mix_launches"] == 4
    assert rows["masked_stats_pooling_backward"]["train_mix_ms"] == 8.0
    assert seen[:3] == seen[3:]


def test_pooling_backward_operations():
    """A subtract, a multiply-add and a multiply per element of x: four
    operations, far below the bytes at any shape."""
    cs = _chip_smoke()
    nbytes, flops = cs.pooling_bwd_cost(64, 286, 1500, 2)
    assert flops == 4 * 64 * 286 * 1500
    ms, by = cs.bound_ms(nbytes, flops)
    assert by == "bytes" and ms == pytest.approx(0.033034392835820894)


def test_training_config_is_the_flagship():
    """The training phase runs __graft_entry__.FLAGSHIP (with fused pooling)
    from the device pool, cut only in epochs and steps."""
    cs = _chip_smoke()
    extra = {k: v for k, v in cs.TRAIN.items() if k not in cs.FLAGSHIP}
    assert {k: cs.TRAIN[k] for k in cs.FLAGSHIP} == cs.FLAGSHIP
    assert extra == dict(device_pool=True, num_steps_per_epoch=16, steps_per_dispatch=8,
                         num_epochs=2, learning_rate=0.01, valid_max_iterations=2,
                         show_training_progress=8, check_numerics=True)
    assert cs.FLAGSHIP["compute_dtype"] == "bfloat16" and cs.FLAGSHIP["use_fused_pooling"]


def test_stream_config_is_the_fisher_recipe():
    """The streaming phase runs the fisher v1 recipe config as it is, cut
    only in epochs, steps, summary and profile cadence and validation
    batches; the preemption phase cuts it in epochs, steps, progress,
    validation batches and loader threads only."""
    cs = _chip_smoke()
    with open(cs.FISHER_CONF) as f:
        fisher = json.load(f)
    cfg = cs.stream_config()
    assert {k: v for k, v in cfg.items() if k not in cs.STREAM_CUTS} == \
        {k: v for k, v in fisher.items() if k not in cs.STREAM_CUTS}
    assert cs.STREAM_CUTS == dict(num_epochs=2, num_steps_per_epoch=16, save_summary_steps=8,
                                  profile_steps=4, valid_max_iterations=2)
    assert set(cs.PREEMPT_CUTS) == {"num_epochs", "num_steps_per_epoch", "num_parallel_datasets",
                                    "show_training_progress", "valid_max_iterations"}
    assert cfg["device_decode"] and not cfg["use_fused_pooling"]
    assert cfg["num_parallel_datasets"] == 16 and "compute_dtype" not in cfg


def test_finetune_config():
    """Fine-tuning runs the training config for one epoch with the convs
    of tdnn1 and tdnn2 (and their BatchNorms) frozen and the output kernel
    re-initialized; the matcher reads JAX paths without the collection."""
    cs = _chip_smoke()
    assert {k: v for k, v in cs.FINETUNE.items()
            if k not in ("num_epochs", "noupdate_var_list", "noload_var_list")} == \
        {k: v for k, v in cs.TRAIN.items() if k != "num_epochs"}
    assert cs.FINETUNE["num_epochs"] == 1
    assert {"tdnn/tdnn1_conv", "tdnn/tdnn2_conv"} <= set(cs.FINETUNE["noupdate_var_list"])
    assert cs.FINETUNE["noload_var_list"] == ["softmax/output_kernel"]
    subs = cs.FINETUNE["noupdate_var_list"]
    assert cs._frozen(("batch_stats", "network", "tdnn", "tdnn1_bn", "mean"), subs)
    assert cs._frozen(("params", "network", "tdnn", "tdnn2_conv", "kernel"), subs)
    assert not cs._frozen(("params", "network", "tdnn", "tdnn3_conv", "kernel"), subs)
    assert not cs._frozen(("opt_state", "trace", "network", "tdnn", "tdnn1_conv", "kernel"),
                          subs)


def test_busy_and_group_times():
    cs = _chip_smoke()
    assert cs.busy_us([]) == 0.0
    assert cs.busy_us([(5, 7), (0, 2), (1, 3), (6, 6.5), (10, 11)]) == 3 + 2 + 1
    marks = [("start", 0, 0.0), ("group", 8, 1.0), ("posted", 8, 1.5), ("group", 16, 2.0),
             ("posted", 16, 2.1), ("start", 16, 3.0), ("group", 24, 3.5), ("posted", 24, 4.0),
             ("group", 32, 4.25), ("posted", 32, 4.5)]
    groups, epoch_s = cs.group_times(marks, 16)
    assert groups == [0.5, 0.25] and epoch_s == 1.25


def test_find_worker_group_and_summaries(tmp_path):
    """The first loader group of a worker is found among the workers and a
    changed byte is not; summaries with the JAX tags at the given steps
    pass the check and a missing step does not."""
    from tf_kaldi_speaker_tpu_torch.utils.summary import SummaryWriter
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    cs = _chip_smoke()
    d = make_fake_data_dir(str(tmp_path / "cm"), num_speakers=6, utts_per_speaker=2, dim=5,
                           min_len=60, max_len=90, seed=1)
    cfg = dict(seed=4, num_parallel_datasets=3, num_speakers_per_batch=3, min_segment_len=40,
               max_segment_len=56)
    codes, headers, labels = cs.first_loader_group(d, cfg, 2, 2)
    first = [(codes[k], headers[k], labels[k]) for k in range(2)]
    worker, alone_s = cs.find_worker_group(d, cfg, 2, first)
    assert worker == 2 and alone_s > 0
    first[1][0][0, 0, 0] ^= 1
    with pytest.raises(AssertionError, match="no loader worker"):
        cs.find_worker_group(d, cfg, 2, first)
    w = SummaryWriter(str(tmp_path / "nnet"))
    for step in (8, 16):
        w.scalars(step, {tag: 0.5 for tag in cs.SCALAR_TAGS})
    w.close()
    assert cs.check_summaries(str(tmp_path / "nnet"), [8, 16]) == 1
    with pytest.raises(AssertionError, match="at steps"):
        cs.check_summaries(str(tmp_path / "nnet"), [8, 16, 24])


def test_zoo_configs_are_the_recipes():
    """The zoo phase runs the six VoxCeleb configs that need the zoo as
    shipped, cut only in epochs, steps, group size, loader threads,
    validation batches and progress cadence, and ResNet34 with the fused
    pooling; every kernel its path must launch."""
    cs = _chip_smoke()
    assert len(cs.ZOO) == 6 and all(os.path.exists(os.path.join(cs.VOX_CONF, n)) for n in cs.ZOO)
    assert cs.ZOO_CUTS == dict(num_epochs=1, num_steps_per_epoch=16, steps_per_dispatch=8,
                               num_parallel_datasets=4, valid_max_iterations=2,
                               show_training_progress=8)
    kinds = set()
    for name in cs.ZOO:
        with open(os.path.join(cs.VOX_CONF, name)) as f:
            shipped = json.load(f)
        cfg = cs.zoo_config(name)
        over = cs.ZOO_OVERRIDES.get(name, {})
        assert {k: v for k, v in cfg.items() if k not in cs.ZOO_CUTS and k not in over} == \
            {k: v for k, v in shipped.items() if k not in cs.ZOO_CUTS and k not in over}
        assert "compute_dtype" not in cfg and cfg["num_speakers_per_batch"] == 64
        kinds.add((cfg.get("network_type"), cfg["pooling_type"],
                   tuple(cfg.get("aux_loss_func", ())), bool(cfg.get("device_pool"))))
        want = ["cm_dequantize", "batch_norm_train", "batch_norm_train_backward"]
        if name.startswith("resnet34"):
            assert cfg["use_fused_pooling"] and over == dict(use_fused_pooling=True)
            want += ["masked_stats_pooling", "masked_stats_pooling_backward"]
        assert cs.zoo_kernels(cfg) == want
    assert kinds == {("tdnn", "self_attention", (), True), ("tdnn", "self_attention", (), False),
                     ("tdnn", "statistics_pooling", ("mhe_loss",), False),
                     ("tdnn", "statistics_pooling", ("ring_loss",), True),
                     ("ecapa_tdnn", "statistics_pooling", (), False),
                     ("resnet34", "statistics_pooling", (), False)}
    assert cs.EXACT_CHUNK == 256 and cs.EXACT_TOL == dict(rtol=5e-3, atol=5e-4)


def test_group_times_of_a_single_epoch():
    """The zoo runs one epoch: its groups are read from the epoch's start
    at step 0."""
    cs = _chip_smoke()
    marks = [("start", 0, 0.0), ("group", 8, 2.0), ("posted", 8, 2.5), ("group", 16, 3.0),
             ("posted", 16, 3.25)]
    groups, epoch_s = cs.group_times(marks, 0)
    assert groups == [2.0, 0.5] and epoch_s == 3.0


def test_wav_phase_config():
    """The wav-to-score phase: 128 utterances of 2-10 s from 32 speakers,
    the recipe's MFCC options (run.sh:55-57) with dither 1, a PLDA set of
    256 x 4 utterances of 200-400 frames, LDA to 200, and the four
    scoring ways (cosine, PLDA + LDA, PLDA + adaptation, AS-norm)."""
    cs = _chip_smoke()
    assert cs.WAV_CORPUS == dict(num_speakers=32, utts_per_speaker=4, min_seconds=2.0,
                                 max_seconds=10.0, seed=6)
    flags = dict(zip(cs.MFCC_FLAGS[::2], cs.MFCC_FLAGS[1::2]))
    assert flags == {"--num-ceps": "30", "--num-mel-bins": "30", "--low-freq": "20",
                     "--high-freq": "7600", "--dither": "1"}
    with open(os.path.join(ROOT, "recipes", "voxceleb", "v1", "run.sh")) as f:
        assert "--num-ceps 30 --num-mel-bins 30 --low-freq 20 --high-freq 7600" in f.read()
    assert (cs.PLDA_SET["num_speakers"], cs.PLDA_SET["utts_per_speaker"],
            cs.PLDA_SET["min_len"], cs.PLDA_SET["max_len"]) == (256, 4, 200, 400)
    assert cs.PLDA_SET["dim"] == cs.FEAT_DIM and cs.LDA_DIM == 200
    assert cs.PLDA_SET["num_speakers"] - 1 >= cs.LDA_DIM  # full-rank between-class scatter
    assert set(cs.SCORE_WAYS) == {"cosine", "plda_lda", "plda_lda_adapt", "cosine_asnorm"}
    assert "--adapt-scp" in cs.SCORE_WAYS["plda_lda_adapt"]
    assert "--cohort-scp" in cs.SCORE_WAYS["cosine_asnorm"]


def test_dcf_bounds():
    """One target trial moves the EER by 1/targets; the minDCF bounds add
    one nontarget trial's cost at each operating point."""
    cs = _chip_smoke()
    labels = np.array([1] * 4 + [0] * 96)
    b = cs.dcf_bounds(labels)
    assert b["eer"] == pytest.approx(0.25)
    assert b["min_dcf08"] == pytest.approx(10 * 0.01 / 4 + 0.99 / 96)
    assert b["min_dcf10"] == pytest.approx(1 / 4 + 999 / 96)


def test_wav_corpus_writer_and_trials(tmp_path, monkeypatch):
    """The corpus writer of the phase (small here): PCM16 wavs of each
    length at 16 kHz, wav.scp/utt2spk/spk2utt, every utterance with both
    voiced frames and pauses for the VAD, speakers told apart by f0; the
    trials hold every pair once, the targets those of one speaker."""
    from tf_kaldi_speaker_tpu_torch.cli import compute_vad, make_mfcc
    from tf_kaldi_speaker_tpu_torch.kio import read_vec_flt_scp, read_wav

    cs = _chip_smoke()
    monkeypatch.setattr(cs, "WAV_CORPUS", dict(cs.WAV_CORPUS, num_speakers=3,
                                               utts_per_speaker=2, min_seconds=1.0,
                                               max_seconds=1.5))
    data = cs.write_wav_corpus(str(tmp_path))
    assert len(data["utts"]) == 6 and 6.0 <= data["seconds"] <= 9.0
    lines = open(data["wav_scp"]).read().split("\n")[:-1]
    assert [line.split()[0] for line in lines] == data["utts"]
    spk2utt = dict((l.split()[0], l.split()[1:]) for l in open(data["spk2utt"]))
    assert spk2utt == {"spk%03d" % s: ["spk%03d_utt%03d" % (s, u) for u in range(2)]
                       for s in range(3)}
    for line in lines:
        samples, rate = read_wav(line.split()[1])
        assert rate == 16000 and 16000 <= len(samples) <= 24000
        assert np.abs(samples).max() > 3000 and (np.abs(samples) < 20).mean() > 0.1
    trials = [l.split() for l in open(data["trials"])]
    assert len(trials) == len(data["labels"]) == 15
    assert [t[2] == "target" for t in trials] == list(data["labels"].astype(bool))
    assert sum(data["labels"]) == 3 and all(a < b for a, b, _ in trials)
    assert all((a[:6] == b[:6]) == (lab == "target") for a, b, lab in trials)
    mfcc_dir = str(tmp_path / "mfcc")
    assert make_mfcc.main(cs.MFCC_FLAGS + ["--device", "cpu", data["wav_scp"], mfcc_dir]) == 0
    assert compute_vad.main(["--device", "cpu", mfcc_dir + "/feats.scp", mfcc_dir]) == 0
    for utt, vad in read_vec_flt_scp(mfcc_dir + "/vad.scp"):
        assert 0.2 < vad.mean() < 0.95, (utt, vad.mean())


def test_make_mfcc_host_seconds_from_its_log(tmp_path, caplog):
    """make_mfcc's run times its own wav reads and dither draws and logs
    them; the phase reads both back from that log line."""
    import logging

    from tf_kaldi_speaker_tpu_torch.cli import make_mfcc
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_wav_data_dir

    cs = _chip_smoke()
    data = make_wav_data_dir(str(tmp_path / "wav"), num_speakers=2, utts_per_speaker=2,
                             min_seconds=0.5, max_seconds=1.0, seed=3)
    with caplog.at_level(logging.INFO):
        assert make_mfcc.main(cs.MFCC_FLAGS + ["--device", "cpu", "--batch-size", "3",
                                               data["wav_scp"], str(tmp_path / "mfcc")]) == 0
    run = dict(logged=[(r.name, r.getMessage()) for r in caplog.records])
    read_s, dither_s = cs.make_mfcc_host_seconds(run)
    assert read_s > 0 and dither_s > 0
    with pytest.raises(AssertionError, match="no host seconds"):
        cs.make_mfcc_host_seconds(dict(logged=[("root", "Extracted MFCC for 4 utterances.")]))


def test_new_phases_are_wired():
    """Phases 20-22 start in main after the wav phase, in that order (21's
    stages in a thread); each adds its path to the kernels line (augment,
    recipe, triplet), and the recipe's and the triplet's kernel shapes are
    replayed after the thread has ended."""
    cs = _chip_smoke()
    with open(SCRIPT) as f:
        main_src = f.read().split("def main():", 1)[1]
    calls = ["run_wav_to_score(", "run_augmentation(", "Beside(recipe_stages,", "run_triplet(",
             "recipe.join()", "report_recipe(recipe.result())", '("recipe_mix_", recipe_shapes)',
             '("triplet_mix_", triplet_shapes)', "print(json.dumps({\"kernels\""]
    at = [main_src.index(c) for c in calls]
    assert at == sorted(at)
    for path in ("augment", "recipe", "triplet"):
        assert 'paths["%s"]' % path in main_src
    for n in (20, 21, 22):
        assert "\n%d. " % n in cs.__doc__


def test_aug_phase_config_is_the_recipe():
    """The modes' seeds, SNRs and babble counts are run.sh's (:77-95)."""
    cs = _chip_smoke()
    with open(os.path.join(ROOT, "tf_kaldi_speaker_tpu_torch", "recipes", "voxceleb", "v1",
                           "run.sh")) as f:
        script = " ".join(f.read().replace("\\\n", " ").split())
    for mode, (args, _) in cs.AUG_MODES.items():
        want = "--mode %s --device \"$device\" --seed %s" % (mode, args[1])
        assert want in script, want
        for flag, value in zip(args[2::2], args[3::2]):
            assert "%s %s" % (flag, value) in script.split("--mode %s" % mode)[1].split(
                "augment_data")[0]
    assert cs.AUG_SOURCES["rir_len"] == (4000, 16000) and cs.AUG_SOURCES["rirs"] == 8
    assert cs.AUG_CHECK_UTTS == 16 and cs.REVERB_RTOL == 1e-12


def test_aug_phase_on_cpu(tmp_path, monkeypatch, caplog):
    """The augmentation phase end to end at a small size with --device cpu
    (main sets the log level to INFO; here caplog does): sources written (8
    RIRs of 4,000-16,000 samples with a direct path), the four modes, the
    reverb check and the byte-equal replays pass."""
    import logging

    import torch

    from tf_kaldi_speaker_tpu_torch.kio import read_wav
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_wav_data_dir

    cs = _chip_smoke()
    monkeypatch.setattr(cs, "AUG_SOURCES", dict(cs.AUG_SOURCES, noise=2, music=2,
                                                 speech_speakers=2))
    monkeypatch.setattr(cs, "AUG_CHECK_UTTS", 3)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    caplog.set_level(logging.INFO)
    data = make_wav_data_dir(str(tmp_path / "wav"), num_speakers=2, utts_per_speaker=2,
                             min_seconds=0.5, max_seconds=1.0, seed=3)
    srcs, launches, summary = cs.run_augmentation(torch, str(tmp_path), data, device="cpu")
    assert not any(launches.values())
    rirs = [read_wav(rx)[0] for _, rx in cs._scp_entries(srcs["rirs"])]
    assert len(rirs) == 8 and all(4000 <= len(r) <= 16000 for r in rirs)
    assert all(np.abs(r).max() == 20000 for r in rirs)
    assert summary["reverb_max_rel_err"] <= 1e-12 and summary["reverb_int16_differ"] == 0
    assert all(summary["%s_s_per_audio_hour" % mode] > 0 for mode in cs.AUG_MODES)
    for mode in cs.AUG_MODES:
        with open(os.path.join(str(tmp_path), "aug_" + mode, "utt2spk")) as f:
            assert len(f.read().splitlines()) == 4


def test_recipe_phase_pieces(tmp_path, monkeypatch):
    """The recipe phase's corpus trees (small here) go through the port's
    make_voxceleb as stage 0 runs it; the script cuts apply to the port's
    run.sh; the config cuts are the recipe test's kinds only; the launch
    runner runs a module as python -m does, keeps its exit code and logs
    its launch counts."""
    from tf_kaldi_speaker_tpu_torch.cli import make_voxceleb

    cs = _chip_smoke()
    monkeypatch.setattr(cs, "RECIPE_CORPUS", dict(cs.RECIPE_CORPUS, num_speakers=6,
                                                  min_seconds=0.3, max_seconds=0.5))
    monkeypatch.setattr(cs, "RECIPE_SPLIT", dict(vox1_dev=range(0, 2), vox1_test=range(2, 4),
                                                 vox2_dev=range(4, 5), vox2_test=range(5, 6)))
    vox1, vox2, seconds = cs.write_vox_trees(str(tmp_path))
    out = str(tmp_path / "data")
    assert make_voxceleb.main(["voxceleb1", vox1, out, "--trials",
                               os.path.join(vox1, "veri_test.txt")]) == 0
    assert make_voxceleb.main(["voxceleb2", vox2, out, "--part", "test"]) == 0
    with open(os.path.join(out, "voxceleb1_test", "trials")) as f:
        trials = [line.split() for line in f]
    assert len(trials) == 28 and sum(t[2] == "target" for t in trials) == 12
    with open(os.path.join(out, "voxceleb1_train", "utt2spk")) as f:
        assert len(f.read().splitlines()) == 8
    with open(os.path.join(out, "voxceleb2_test", "wav.scp")) as f:
        assert len(f.read().splitlines()) == 4
    with open(cs.RECIPE_SCRIPT) as f:
        script = f.read()
    for old, new in cs.RECIPE_SCRIPT_CUTS:
        assert old in script and new not in script
    assert 'py="python -m"' in script
    assert set(cs.RECIPE_CUTS) == {"num_epochs", "num_steps_per_epoch", "valid_max_iterations",
                                   "save_checkpoints_steps", "save_summary_steps",
                                   "show_training_progress"}
    paths = cs.recipe_configs(str(tmp_path))
    with open(paths["config"]) as f:
        cfg = json.load(f)
    assert cfg["device_pool"] and cfg["num_speakers_per_batch"] == 64 and cfg["num_epochs"] == 1
    runner = tmp_path / "runner.py"
    runner.write_text(cs.LAUNCH_RUNNER)
    log = tmp_path / "launches.jsonl"
    env = dict(os.environ, TFKS_LAUNCH_LOG=str(log), PYTHONPATH=ROOT)
    for argv, rc in (([str(tmp_path / "data" / "voxceleb2_test")], 0), ([str(tmp_path)], 1)):
        proc = subprocess.run([sys.executable, str(runner),
                               "tf_kaldi_speaker_tpu_torch.cli.fix_data_dir"] + argv,
                              cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
        assert proc.returncode == rc, proc.stderr
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["module"] for r in recs] == ["tf_kaldi_speaker_tpu_torch.cli.fix_data_dir"] * 2
    assert all(r["launches"] == {"cm_dequantize": 0, "masked_stats_pooling": 0,
                                 "masked_stats_pooling_backward": 0, "batch_norm_train": 0,
                                 "batch_norm_train_backward": 0} for r in recs)


def test_triplet_phase_configs(tmp_path):
    """The triplet phase: the flagship training config with the angular
    triplet loss over 16 x 4 rows (the flagship's 64) and end2end
    validation at 8 x 4; the generalized variant with average centers;
    both build in the port's trainer, and the pool gives speaker-major
    batches of that layout."""
    import torch

    from tf_kaldi_speaker_tpu_torch.losses import LossHead
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    cs = _chip_smoke()
    t = cs.TRIPLET
    assert t["num_speakers_per_batch"] * t["num_segments_per_speaker"] == \
        cs.FLAGSHIP["num_speakers_per_batch"] == 64
    assert (t["loss_func"], t["triplet_type"], t["loss_type"], t["margin"]) == (
        "angular_triplet_loss", "hard", "additive_margin_softmax", 0.2)
    assert (t["batch_type"], t["num_valid_speakers_per_batch"],
            t["num_valid_segments_per_speaker"]) == ("end2end", 8, 4)
    for key in ("compute_dtype", "use_fused_pooling", "tdnn_layer_size"
                if "tdnn_layer_size" in cs.FLAGSHIP else "network_type"):
        assert t[key] == cs.FLAGSHIP[key]
    assert t["device_pool"] and t["num_steps_per_epoch"] == 16
    g = cs.GENERALIZED
    assert g["triplet_center"] == "average" and g["num_steps_per_epoch"] == 8
    for cfg in (t, g):
        head = LossHead(cfg["loss_func"], 96, cfg, 512)
        assert hasattr(head, "triplet_centers") == (cfg is g)
    train = make_fake_data_dir(str(tmp_path / "train"), num_speakers=20, utts_per_speaker=4,
                               dim=cs.FEAT_DIM, min_len=300, max_len=400, seed=1)
    batches = cs._pool_group(torch, train, "cpu", 2, 296, 11, cs.TRIPLET)
    for codes, hdr, labels in batches:
        assert codes.shape == (64, 296, cs.FEAT_DIM)
        lab = labels.numpy().reshape(16, 4)
        assert (lab == lab[:, :1]).all() and len(set(lab[:, 0])) == 16


def test_phases_23_to_25_are_wired():
    """The multi-input phase runs in main after the triplet phase while the
    recipe's and the Fisher chain's threads run; the Fisher phase's checks
    and the native reader phase come after both threads have ended, and
    the multi-input and Fisher shapes are replayed after them; each adds
    its path to the kernels line (native_reader, mi, fisher), and the
    docstring lists them."""
    cs = _chip_smoke()
    with open(SCRIPT) as f:
        main_src = f.read().split("def main():", 1)[1]
    calls = ["Beside(recipe_stages,", "Beside(run_cli_chain,", "run_triplet(",
             "run_multi_input(", "chain.join()", "chain.result()", "report_fisher(",
             "run_native_reader(", '("mi_mix_", mi_shapes)', '("fisher_mix_", fisher_shapes)',
             "print(json.dumps({\"kernels\""]
    at = [main_src.index(c) for c in calls]
    assert at == sorted(at)
    for path in ("native_reader", "mi", "fisher"):
        assert 'paths["%s"]' % path in main_src
    for n in (23, 24, 25):
        assert "\n%d. " % n in cs.__doc__


def test_mi_and_fisher_configs():
    """The multi-input config is the flagship's (bf16, fused pooling, 64
    speakers) with the 1500-d BNF stream concatenated, cut in epochs,
    steps, validation batches, loader threads and queue; the Fisher phase
    cuts the shipped config as the VoxCeleb recipe phase does, and the
    script's filter and LDA numbers only."""
    cs = _chip_smoke()
    for key, value in cs.FLAGSHIP.items():
        assert cs.MI[key] == value, key
    assert cs.MI["aux_feature_dim"] == {"bnf": cs.BNF_DIM} and cs.MI["aux_concat_input"] == ["bnf"]
    assert cs.BNF_DIM == 1500 and cs.BNF_NODE == "tdnn5_relu"
    assert (cs.MI["num_epochs"], cs.MI["num_steps_per_epoch"], cs.MI["steps_per_dispatch"],
            cs.MI["valid_max_iterations"]) == (1, 16, 8, 2)
    assert cs.FISHER_CUTS == cs.RECIPE_CUTS
    assert set(cs.FISHER_ENV_CUTS) == {"valid_speakers", "valid_utts", "lda_dim"}
    with open(cs.FISHER_SCRIPT) as f:
        script = f.read()
    for name in cs.FISHER_ENV_CUTS:
        assert "%s=${%s:-" % (name, name) in script
    assert 'py="python -m"' in script
    with open(cs.FISHER_CONF) as f:
        shipped = json.load(f)
    assert shipped["num_parallel_datasets"] == 16 and shipped["device_decode"]


def test_phase_helpers(tmp_path):
    """The fallback check, the launch log reader, the Fisher tree writer
    (enrollment speakers x test utterances as trials) and the aux scp
    subset in the main stream's key order."""
    cs = _chip_smoke()
    cs.check_no_fallback("p", {"read_batch_codes": 3}, "read_batch_codes")
    for counts in ({"read_batch_codes": 3, "fallback": 1}, {"read_submat": 2}):
        with pytest.raises(AssertionError, match="fallback"):
            cs.check_no_fallback("p", counts, "read_batch_codes")
    log = tmp_path / "l.jsonl"
    log.write_text("\n".join(json.dumps(r) for r in (
        {"module": "m.cli.train", "launches": {"cm_dequantize": 2}, "native": {"fallback": 1},
         "shapes": {"cm_dequantize": [[[1, 2, 3], "float32", 2]]}},
        {"module": "m.cli.train", "launches": {"cm_dequantize": 1},
         "shapes": {"cm_dequantize": [[[1, 2, 3], "float32", 1]]}})) + "\n")
    launches, shapes, by_module, native = cs.read_launch_log(str(log))
    assert launches == {"cm_dequantize": 3} and by_module["train"]["cm_dequantize"] == 3
    assert shapes["cm_dequantize"] == {((1, 2, 3), "float32"): 3}
    assert native["train"] == {"fallback": 1}
    cs.FISHER_CORPUS = dict(cs.FISHER_CORPUS, background=3, background_utts=4, eval_speakers=2,
                            eval_utts=4, min_seconds=0.2, max_seconds=0.3)
    data, seconds = cs.write_fisher_tree(str(tmp_path / "fisher"))
    counts = {}
    for name in ("train_background", "enroll", "test"):
        with open(os.path.join(data, name, "utt2spk")) as f:
            counts[name] = len(f.read().splitlines())
        with open(os.path.join(data, name, "wav.scp")) as f:
            assert all(os.path.exists(line.split()[1]) for line in f)
    assert counts == {"train_background": 12, "enroll": 4, "test": 4} and seconds > 0
    with open(os.path.join(data, "test", "trials")) as f:
        trials = [line.split() for line in f]
    assert len(trials) == 8 and sum(t[2] == "target" for t in trials) == 4
    assert all(t[1].startswith(t[0] + "_") == (t[2] == "target") for t in trials)
    (tmp_path / "aux.scp").write_text("b x:2\na x:1\nc x:3\n")
    (tmp_path / "main.scp").write_text("a y:1\nc y:3\n")
    cs.aux_subset_scp(str(tmp_path / "aux.scp"), str(tmp_path / "main.scp"),
                      str(tmp_path / "out.scp"))
    assert (tmp_path / "out.scp").read_text() == "a x:1\nc x:3\n"


def test_native_and_multi_input_phases_on_cpu(tmp_path, monkeypatch, caplog):
    """Phases 23 and 24 end to end at a small width with --device cpu
    (the kernels' launch checks left out: on the CPU the wrappers run their
    plain versions): the native reads bit-equal to the numpy codec, the
    streamed epoch with and without the native reader (no fallback in the
    first), and the BNF chain through extract_bnf, prepare_feats, train_mi
    and extract_mi with the card-versus-CPU checks."""
    import logging

    import torch

    from tf_kaldi_speaker_tpu_torch.cli import train as cli_train
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    cs = _chip_smoke()
    caplog.set_level(logging.INFO)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    asked = []  # the kernels each path must launch on the card
    monkeypatch.setattr(cs, "check_launched",
                        lambda path, run, names: asked.append(sorted(names)) or run["launches"])
    tiny = dict(tdnn_layer_size=16, num_nodes_pooling_layer=24, num_nodes_last_layer=8,
                num_speakers_per_batch=6, min_segment_len=48, max_segment_len=64)
    kw = dict(dim=cs.FEAT_DIM, min_len=100, max_len=140, spk_scale=1.0, chan_scale=1.0)
    train = make_fake_data_dir(str(tmp_path / "train"), num_speakers=8, utts_per_speaker=3,
                               seed=0, **kw)
    valid = make_fake_data_dir(str(tmp_path / "valid"), num_speakers=3, utts_per_speaker=2,
                               seed=1, spk_offset=8, **kw)
    cfg = cs.write_json(str(tmp_path / "base.json"),
                        dict(cs.TRAIN, **tiny, num_epochs=1, num_steps_per_epoch=2,
                             steps_per_dispatch=2))
    trained = str(tmp_path / "trained")
    assert cli_train.main(["--config", cfg, "--device", "cpu", train["data"], train["spklist"],
                           valid["data"], valid["spklist"], trained]) == 0
    monkeypatch.setattr(cs, "MI", dict(cs.MI, **tiny, aux_feature_dim={"bnf": 24},
                                       num_parallel_datasets=2))
    monkeypatch.setattr(cs, "BNF_DIM", 24)
    monkeypatch.setattr(cs, "MI_EXTRACT_CHECK", 2)
    monkeypatch.setattr(cs, "READ_AB", dict(cs.READ_AB, batches=2, items=4, length=40))
    monkeypatch.setattr(cs, "LONG_TREE", dict(cs.LONG_TREE, utts=2, frames=600))
    launches, shapes, summary = cs.run_multi_input(torch, str(tmp_path), trained, train, valid,
                                                   device="cpu")
    assert summary["mi_cpu_loss_gap"] == 0
    assert summary["mi_extract_one_minus_cosine"] <= 1 - cs.EMB_MIN_COSINE
    controls = {"tf32", "bf16"}
    assert set(summary["mi_step_controls"]) == set(summary["mi_extract_controls"]) == controls
    # the bf16 controls differ from the CPU's float32 step and predict
    assert summary["mi_step_controls"]["bf16"]["loss_gap"] > 0
    assert summary["mi_extract_controls"]["bf16"] > 0
    assert set(summary["mi_cm_reads_ms"]) == {b for b, _ in cs.CM_READS}
    assert set(summary["mi_stage_s"]) == {"extract_bnf", "prepare_feats --no-cmvn", "train_mi",
                                          "extract_mi"}
    # the multi-stream loader ships floats: the pooling kernels, no dequant
    assert asked == [["masked_stats_pooling", "masked_stats_pooling_backward"],
                     ["masked_stats_pooling"]]
    monkeypatch.setattr(cs, "NATIVE_CHECK", dict(items=6, length=90))
    stream = cs.stream_config
    monkeypatch.setattr(cs, "stream_config",
                        lambda: dict(stream(), **tiny, num_parallel_datasets=2,
                                     num_steps_per_epoch=4, steps_per_dispatch=2))
    launches, summary = cs.run_native_reader(torch, str(tmp_path), train, valid, device="cpu")
    for mode in ("native", "numpy"):
        assert len(summary[mode + "_group_s"]) == len(summary[mode + "_consumer_wait_s"]) == 2
    assert set(summary["cm_reads_ms"]) == {"short_30d", "long_23d"}
    for reads in summary["cm_reads_ms"].values():
        assert set(reads) == {b for b, _ in cs.CM_READS}
    assert asked[2:] == [["cm_dequantize"]] * 2


def test_multitask_phase_is_wired_and_configured():
    """Phase 26's stages run in the Fisher chain's thread from its stage-1
    output and its checks in main after the thread has ended; it adds its
    path to the kernels line as "mt", and the docstring lists it; the
    config is the shipped mt_softmax.json cut in epochs, steps, validation
    batches and loader threads only, the script in its validation split
    only, with 2001 pdfs."""
    cs = _chip_smoke()
    with open(SCRIPT) as f:
        main_src = f.read().split("def main():", 1)[1]
    at = [main_src.index(c) for c in ("chain.join()", "chain.result()", "report_multitask(",
                                      "print(json.dumps({\"kernels\"")]
    assert at == sorted(at)
    assert 'paths["mt"]' in main_src and "\n26. " in cs.__doc__
    assert cs.MT_CUTS == dict(num_epochs=1, num_steps_per_epoch=16, valid_max_iterations=2,
                              num_parallel_datasets=4)
    with open(cs.MT_CONF) as f:
        shipped = json.load(f)
    assert (shipped["num_speakers_per_batch"], shipped["min_segment_len"],
            shipped["max_segment_len"], shipped["num_frames_per_utt"],
            shipped["phone_left_context"], shipped["phone_right_context"]) == (
        64, 200, 400, 10, 11, 11)
    assert "compute_dtype" not in shipped and 3 * cs.MT_PHONES >= 2000
    with open(cs.MT_SCRIPT) as f:
        script = f.read()
    for old, _ in cs.MT_SCRIPT_CUTS:
        assert old in script
    assert 'py="python -m"' in script


def test_multitask_phase_on_cpu(tmp_path, monkeypatch):
    """Phase 26 end to end at a small width with --device cpu: stages 2-5
    of the v3 run.sh through the launch runner from a stage-1-like MFCC
    dir, the outputs' checks, no kernel launch and no numpy fallback, and
    the card-versus-CPU checks (0 gaps on the CPU, the bf16 controls
    non-zero)."""
    import torch

    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    made = make_fake_data_dir(str(tmp_path / "mfcc"), num_speakers=10, utts_per_speaker=5,
                              dim=23, min_len=210, max_len=260, seed=4, with_vad_ali=True,
                              num_phones=3)
    tiny = dict(json.load(open(cs.MT_CONF)), tdnn_layer_size=16, num_nodes_pooling_layer=24,
                speaker_dim=16, phone_dim=16, phone_layer_size=[16] * 5,
                num_speakers_per_batch=4, min_segment_len=64, max_segment_len=96)
    conf = tmp_path / "tiny.json"
    conf.write_text(json.dumps(tiny))
    monkeypatch.setattr(cs, "MT_CONF", str(conf))
    monkeypatch.setattr(cs, "MT_PHONES", 5)
    monkeypatch.setattr(cs, "MT_CUTS", dict(cs.MT_CUTS, num_steps_per_epoch=2,
                                            num_parallel_datasets=2))
    monkeypatch.setattr(cs, "MT_EXTRACT_CHECK", 2)
    launches, summary = cs.run_multitask_recipe(torch, str(tmp_path), made["data"],
                                                device="cpu")
    assert not sum(launches.values())
    assert set(summary["mt_stage_s"]) == {2, 3, 4, 5}
    assert summary["mt_cpu_loss_gap"] == 0 and summary["mt_cpu_update_one_minus_cosine"] < 1e-12
    assert summary["mt_cpu_param_one_minus_cosine"][1] < 1e-12
    # the arks hold float32 log-likelihoods; the reference is float64
    assert summary["mt_extract_one_minus_cosine"] < 1e-12 and summary["mt_loglike_gap"] < 1e-7
    assert set(summary["mt_step_controls"]) == set(summary["mt_output_controls"]) == {"tf32",
                                                                                      "bf16"}
    assert summary["mt_step_controls"]["bf16"]["loss_gap"] > 0
    assert summary["mt_output_controls"]["bf16"]["xv"] > 0
    assert summary["mt_outputs"]["train_xvectors"] == 50 - 16
    assert summary["mt_train_native"]["read_submat"] > 0


def test_mt_update_cosines():
    """The median over the parameters and the worst one by name; the
    biases of the layers a BatchNorm follows are left out; an update that
    is zero on one side only reads 1."""
    import torch

    cs = _chip_smoke()
    rng = np.random.RandomState(0)
    names = [("params", "conv1", "kernel"), ("params", "conv1", "bias"),
             ("params", "bn1", "scale"), ("params", "phn_bn3", "scale"),
             ("params", "spk_softmax", "output", "kernel"), ("batch_stats", "bn1", "mean")]
    before = {p: torch.from_numpy(rng.randn(64).astype(np.float32)) for p in names}
    want = {p: v + torch.from_numpy(rng.randn(64).astype(np.float32)) for p, v in before.items()}
    median, (param, one) = cs.mt_update_cosines(before, dict(want), want)
    assert median == pytest.approx(0.0, abs=1e-15) and one == pytest.approx(0.0, abs=1e-15)
    for noise in [("params", "conv1", "bias"), ("batch_stats", "bn1", "mean")]:
        median, (param, one) = cs.mt_update_cosines(before, {**want, noise: want[noise] * 3},
                                                    want)
        assert one == pytest.approx(0.0, abs=1e-15)
    # one parameter off: the worst, and the median of four stays small
    off = names[3]
    got = {**want, off: before[off] + 0.1 * (want[off] - before[off])
           + 0.1 * torch.from_numpy(rng.randn(64).astype(np.float32))}
    median, (param, one) = cs.mt_update_cosines(before, got, want)
    assert param == "phn_bn3/scale" and one > 0.01 and median < 1e-12
    # half of them off: the median moves
    got = {**got, names[2]: got[off] - before[off] + before[names[2]]}
    assert cs.mt_update_cosines(before, got, want)[0] > 1e-3
    got = {**want, names[4]: before[names[4]]}
    assert cs.mt_update_cosines(before, got, want)[1] == ("spk_softmax/output/kernel", 1.0)


def test_mt_step_spread_on_cpu(tmp_path, monkeypatch, capsys):
    """``--mt-step-spread``'s reader at a small width with --device cpu:
    stages 2-3 per config seed, one reading a batch (the CPU against
    itself: 0; the bf16 control not), and the summary line of each
    bound."""
    import torch

    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    cs = _chip_smoke()
    made = make_fake_data_dir(str(tmp_path / "mfcc"), num_speakers=10, utts_per_speaker=5,
                              dim=23, min_len=210, max_len=260, seed=4, with_vad_ali=True,
                              num_phones=3)
    tiny = dict(json.load(open(cs.MT_CONF)), tdnn_layer_size=16, num_nodes_pooling_layer=24,
                speaker_dim=16, phone_dim=16, phone_layer_size=[16] * 5,
                num_speakers_per_batch=4, min_segment_len=64, max_segment_len=96)
    conf = tmp_path / "tiny.json"
    conf.write_text(json.dumps(tiny))
    monkeypatch.setattr(cs, "MT_CONF", str(conf))
    monkeypatch.setattr(cs, "MT_PHONES", 5)
    monkeypatch.setattr(cs, "MT_CUTS", dict(cs.MT_CUTS, num_steps_per_epoch=2,
                                            num_parallel_datasets=2))
    rows = cs.mt_step_spread(torch, str(tmp_path / "spread"), made["data"], seeds=(0, 1),
                             batches=(13,), device="cpu")
    assert len(rows) == 2
    for r in rows:
        assert set(r) == {"sound", "tf32", "bf16"}
        assert r["sound"]["loss_gap"] == 0 and r["sound"]["update_one_minus_cosine"] < 1e-12
        assert r["sound"]["forward_one_minus_cosine"] < 1e-12
        assert r["bf16"]["update_one_minus_cosine"] > 0 and r["bf16"]["worst_param"]
        assert r["bf16"]["forward_one_minus_cosine"] > 1e-6
    # the two trained states differ
    assert rows[0]["bf16"]["loss"] != rows[1]["bf16"]["loss"]
    out = capsys.readouterr().out
    assert out.count("mt step spread") == 2 + 4 and "2 readings, param_one_minus_cosine" in out


def test_mt_epoch_spread_on_cpu(tmp_path, capsys):
    """``--mt-epoch-spread``'s reader with every run on the CPU, one seed:
    the CPU against itself reads 0 free-running, in lockstep and with
    TF32 asked for; bf16 and the 1e-8 nudge do not, and lockstep keeps
    bf16's excess under its free-running one; the summary line of each
    run. ``allclose_excess`` is at most 1 exactly where assert_allclose
    passes."""
    import torch

    cs = _chip_smoke()
    runs = tuple((name, "cpu", *rest) for name, _, *rest in cs.MT_EPOCH_RUNS)
    rows = cs.mt_epoch_spread(torch, str(tmp_path / "spread"), seeds=(0,), runs=runs)
    (row,) = rows
    assert set(row) == {name for name, *_ in cs.MT_EPOCH_RUNS}
    for name in ("sound", "again", "tf32", "lockstep", "lockstep_tf32"):
        assert [e for e, _ in row[name]["excess"]] == [0.0] * 4, name
        assert max(row[name]["loss_gaps"]) == 0
    assert min(e for e, _ in row["bf16"]["excess"]) > 1
    assert row["lockstep_bf16"]["excess"][-1][0] < row["bf16"]["excess"][-1][0]
    assert 0 < row["cpu_nudged"]["excess"][0][0] < 1
    assert row["cpu_nudged"]["first_update_one_minus_cosine"] < 1e-9
    out = capsys.readouterr().out
    assert out.count("mt epoch spread") == 2 * len(runs)
    want = {("params", "w"): torch.tensor([1.0, -2.0])}
    got = {("params", "w"): torch.tensor([1.0 + 1.5e-4, -2.0])}
    excess, where = cs.allclose_excess(got, want, rtol=1e-4, atol=1e-5)
    assert where == "w" and abs(excess - 1.5e-4 / 1.1e-4) < 1e-3  # 1 + 1.5e-4 in float32
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got[("params", "w")], want[("params", "w")], rtol=1e-4,
                                   atol=1e-5)
    assert cs.allclose_excess(want, want, rtol=1e-4, atol=1e-5)[0] == 0


def test_decode_and_sre_phases_are_wired():
    """Phase 29's stages run in a thread of their own once phase 25's stage
    1 has ended, beside 25's later stages, and its checks in main after
    the threads have ended; phase 28 runs alone after the data-parallel
    phase, the threads and the replays; they add the paths "decode" and
    "sre" to the kernels line, the SRE shapes are replayed, the docstring
    lists both; the SRE phase cuts its script as
    tests/test_torch_sre_recipe.py does, and stage 6 decodes whole
    utterances, more than one, with the oracle on their first frames."""
    import inspect

    from test_torch_sre_recipe import SCRIPT_CUTS

    cs = _chip_smoke()
    with open(SCRIPT) as f:
        main_src = f.read().split("def main():", 1)[1]
    main_src = main_src.split("if dp_spread:", 1)[1]
    calls = ["Beside(recipe_stages,", "Beside(run_cli_chain,", 'paths["dp"]', "chain.join()",
             "report_sre(", '("sre_mix_", sre_shapes)', "run_decode_phase(",
             "print(json.dumps({\"kernels\""]
    at = [main_src.index(c) for c in calls]
    assert at == sorted(at)
    chain = inspect.getsource(cs.run_cli_chain)
    at = [chain.index(c) for c in ("[1], d)", "Beside(sre_stages,", "Beside(multitask_stages,",
                                   "range(2, 7)", "sre.join()", "mt.join()")]
    assert at == sorted(at)
    assert "Beside(" not in main_src.split("chain.join()", 1)[1]
    for path in ("decode", "sre"):
        assert 'paths["%s"]' % path in main_src
    for n in (28, 29):
        assert "\n%d. " % n in cs.__doc__
    assert cs.SRE_SCRIPT_CUTS == SCRIPT_CUTS
    assert cs.DECODE_ORACLE_FRAMES > 0 and cs.DECODE_UTTS > 1
    assert not hasattr(cs, "DECODE_FRAMES")
    assert cs.DECODE_CALL in open(cs.MT_SCRIPT).read()


def test_cli_chain_order_and_join(monkeypatch):
    """``run_cli_chain`` starts the SRE and multitask stages only after the
    Fisher stage 1, runs them beside the Fisher stages 2-6, and joins both
    before it returns or raises."""
    import threading
    import time

    cs = _chip_smoke()
    events, lock = [], threading.Lock()

    def note(what):
        with lock:
            events.append(what)

    def stages(script, env, stages, d, may_skip=()):
        stages = tuple(stages)
        note(("fisher", stages))
        if stages != (1,) and env.get("fail"):
            raise RuntimeError("stage failed")
        return {s: 0.0 for s in stages}, {s: "" for s in stages}

    def other(name):
        def run(*args):
            note((name, "start"))
            time.sleep(0.2)
            note((name, "end"))
            return name
        return run

    for fail in (False, True):
        events.clear()
        env = dict(data_root="data", fail=fail)
        monkeypatch.setattr(cs, "setup_fisher_recipe",
                            lambda root, device: ("d", "run.sh", env, 1.0))
        monkeypatch.setattr(cs, "run_stages", stages)
        monkeypatch.setattr(cs, "sre_stages", other("sre"))
        monkeypatch.setattr(cs, "multitask_stages", other("mt"))
        if fail:
            with pytest.raises(RuntimeError, match="stage failed"):
                cs.run_cli_chain("root")
        else:
            fisher, sre, mt = cs.run_cli_chain("root")
            assert (sre, mt) == ("sre", "mt")
            assert sorted(fisher["stage_s"]) == [1, 2, 3, 4, 5, 6]
        assert events[0] == ("fisher", (1,))
        assert {("sre", "end"), ("mt", "end")} <= set(events)
        assert events.index(("fisher", (2, 3, 4, 5, 6))) < max(
            events.index(("sre", "end")), events.index(("mt", "end")))


def test_decode_phase_on_cpu(tmp_path, monkeypatch):
    """Phases 26 and 28 end to end at a small width with --device cpu (the
    667 phones, so the 667-word loop): stage 6's outputs and checks on
    whole utterances, native decodes only, no kernel launch, the decoder's
    spans from its process, and the card-versus-CPU readings (0 on the
    CPU) over the validation split."""
    import torch

    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    made = make_fake_data_dir(str(tmp_path / "mfcc"), num_speakers=10, utts_per_speaker=5,
                              dim=23, min_len=210, max_len=260, seed=4, with_vad_ali=True,
                              num_phones=3)
    tiny = dict(json.load(open(cs.MT_CONF)), tdnn_layer_size=16, num_nodes_pooling_layer=24,
                speaker_dim=16, phone_dim=16, phone_layer_size=[16] * 5,
                num_speakers_per_batch=4, min_segment_len=64, max_segment_len=96)
    conf = tmp_path / "tiny.json"
    conf.write_text(json.dumps(tiny))
    monkeypatch.setattr(cs, "MT_CONF", str(conf))
    monkeypatch.setattr(cs, "MT_CUTS", dict(cs.MT_CUTS, num_steps_per_epoch=2,
                                            num_parallel_datasets=2))
    root = str(tmp_path)
    _, patched, env, _, _ = cs.setup_multitask_recipe(root, made["data"], cs.MT_CUTS,
                                                      device="cpu")
    cs.run_stages(patched, env, range(2, 6), os.path.join(root, "multitask"))
    launches, summary = cs.run_decode_phase(torch, root, device="cpu")
    assert not sum(launches.values())
    assert summary["decode_decoder_counts"] == {"native": cs.DECODE_UTTS}
    times = summary["decode_times"]
    assert 2 * 210 <= times["frames"] <= 2 * 260
    assert times["lattice_s"] > 0 and times["determinize_s"] > 0
    assert 0 < times["determinize_share"] < 1
    sound = summary["decode_card_vs_cpu"]
    assert len(sound["cost_gaps"]) == 16 and max(sound["cost_gaps"]) == 0
    assert sound["words_agree"] == 1


def test_interop_and_multi_phases_are_wired():
    """Phases 30 and 31 run in main after phase 29, in that order, and add
    the paths "interop" and "extract_multi" to the kernels line; the
    docstring lists both; the golden config copied into the script is
    test_tf_golden's, and the golden files it reads exist."""
    from test_tf_golden import CFG

    cs = _chip_smoke()
    with open(SCRIPT) as f:
        main_src = f.read().split("def main():", 1)[1].split("if dp_spread:", 1)[1]
    calls = ['("sre_mix_", sre_shapes)', 'paths["interop"], interop_summary = run_interop(',
             'paths["extract_multi"], multi_summary = run_extract_multi(',
             "print(json.dumps({\"kernels\""]
    at = [main_src.index(c) for c in calls]
    assert at == sorted(at)
    for n in (30, 31):
        assert "\n%d. " % n in cs.__doc__
    assert cs.GOLDEN_CFG == CFG
    assert cs.GOLDEN_TOL == dict(rtol=1e-4, atol=1e-4)
    for ckpt, (npz, names) in cs.GOLDEN_FORWARDS.items():
        gold = np.load(os.path.join(cs.GOLDEN_DIR, npz))
        assert os.path.exists(os.path.join(cs.GOLDEN_DIR, ckpt + ".index"))
        assert all(theirs in gold.files for _, theirs in names)


def test_interop_and_multi_phases_on_cpu(tmp_path, monkeypatch):
    """Phases 30 and 31 end to end at a small width with --device cpu (the
    kernels' launch checks left out: on the CPU the wrappers run their plain
    versions): export, import, both extractions byte-equal, the golden
    forwards, the three tools, and two row blocks against one device."""
    import torch

    from tf_kaldi_speaker_tpu_torch.train import checkpoints
    from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
    from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(cs, "N_UTTS", 6)
    asked = []
    monkeypatch.setattr(cs, "check_launched",
                        lambda path, run, names: asked.append(sorted(names)) or run["launches"])
    cfg = dict(cs.TRAIN, tdnn_layer_size=16, num_nodes_pooling_layer=24, num_nodes_last_layer=8,
               num_speakers_per_batch=4, min_segment_len=48, max_segment_len=64,
               num_parallel_datasets=2)
    nnet = tmp_path / "trained" / "nnet"
    t = Trainer(ParamsPlain(**cfg), str(nnet), dim=cs.FEAT_DIM, num_speakers=8, device="cpu")
    t.build("train", cs.FEAT_DIM, cfg["loss_func"], 8)
    t.save(3)
    t.save(5)
    # phase 15 points the trained dir at its best epoch's checkpoint; the
    # phase exports the one the dir serves
    checkpoints.write_pointer(str(nnet), 3)
    (nnet / "config.json").write_text(json.dumps(cfg))
    (nnet / "feature_dim").write_text("%d\n" % cs.FEAT_DIM)
    (nnet / "num_speakers").write_text("8\n")
    valid = make_fake_data_dir(str(tmp_path / "valid"), num_speakers=3, utts_per_speaker=2,
                               dim=cs.FEAT_DIM, min_len=100, max_len=140, seed=1)
    scp = cs.write_ark(str(tmp_path))
    trained = str(tmp_path / "trained")
    launches, summary = cs.run_interop(torch, str(tmp_path), trained, scp, valid, device="cpu")
    assert summary["arks_byte_equal"] and summary["interop_max_one_minus_cos"] <= 1e-12
    assert summary["golden_max_abs_err"] < 1e-4
    assert summary["train_insight_loss_gap"] == 0
    assert os.path.exists(str(tmp_path / "interop_tf" / "model-3.index"))
    assert asked == [["cm_dequantize", "masked_stats_pooling"]]
    launches, summary = cs.run_extract_multi(torch, str(tmp_path), trained, scp, device="cpu")
    assert asked[1:2] == [["cm_dequantize", "masked_stats_pooling"]]
    for model in ("bf16", "f32"):
        for path in ("feature", "pipe"):
            key = "%s_two_blocks_%s_" % (model, path)
            assert summary[key + "max_one_minus_cos"] <= cs.MULTI_COSINE_GAP[model]
            assert summary[key + "emb_per_s"] > 0
    assert asked[2:] == [["cm_dequantize", "masked_stats_pooling"]]
    assert not any(k.startswith("every_card") or "_every_card_" in k for k in summary)
    assert cs.MULTI_COSINE_GAP["f32"] == 1e-6


def test_quality_phase_is_wired():
    """Phase 32 runs in main after phase 31, replays its shapes before the
    kernels line, and is in the docstring; its band is JAX's am-softmax
    f32 band on the record and its kernel shapes the quality matrix's."""
    from tf_kaldi_speaker_tpu_torch.validation import common, convergence, quality_matrix

    cs = _chip_smoke()
    with open(SCRIPT) as f:
        main_src = f.read().split("def main():", 1)[1].split("if dp_spread:", 1)[1]
    calls = ['paths["extract_multi"], multi_summary = run_extract_multi(',
             'paths["quality"], quality_shapes, quality_summary = run_quality(',
             'prefix="quality_mix_"', "del flush", "print(json.dumps({\"kernels\""]
    at = [main_src.index(c) for c in calls]
    assert at == sorted(at)
    assert "\n32. " in cs.__doc__
    j = common.judge([0.18], convergence.jax_eers("amsoftmax"))
    assert round(j["jax_mean"], 4) == 0.1815 and round(j["band"], 4) == 0.015
    j = common.judge([2.6], convergence.jax_final_valid_losses("amsoftmax"))
    assert round(j["jax_mean"], 3) == 2.645 and round(j["band"], 3) == 0.226
    assert cs.QUALITY_KERNEL_SHAPES["cm_dequantize"][2] == 12
    width = quality_matrix.CFG["tdnn_layer_size"]
    assert cs.QUALITY_KERNEL_SHAPES["pooling"][2] == 2 * width
    assert cs.QUALITY_KERNEL_SHAPES["pooling"][0] == quality_matrix.CFG[
        "num_speakers_per_batch"]


@pytest.mark.parametrize("eer, loss, control, ok", [
    (0.181, 2.6, dict(eer=0.185, valid_loss=5.3), True),    # control fails on its loss
    (0.181, 2.6, dict(eer=0.21, valid_loss=2.6), True),     # control fails on its EER
    (0.20, 2.6, dict(eer=0.21, valid_loss=5.3), False),     # trained EER outside
    (0.181, 3.0, dict(eer=0.21, valid_loss=5.3), False),    # trained loss outside
    (0.181, 2.6, dict(eer=0.185, valid_loss=2.7), False)])  # control inside both
def test_check_quality_bounds(eer, loss, control, ok):
    cs = _chip_smoke()
    summary = dict(valid_loss=[6.8, 3.0, loss], eer=eer, eer_band=(0.1815, 0.015),
                   loss_band=(2.645, 0.226), controls={"untrained": dict(eer=0.3,
                                                                         valid_loss=5.4),
                                                       "shuffled_labels": control})
    if ok:
        cs.check_quality_bounds(summary)
    else:
        with pytest.raises(AssertionError):
            cs.check_quality_bounds(summary)
    with pytest.raises(AssertionError):
        cs.check_quality_bounds(dict(summary, valid_loss=[float("nan"), 3.0, loss]))


def test_quality_phase_on_cpu(tmp_path, monkeypatch):
    """Phase 32 end to end at a small width and corpus with --device cpu:
    the flagship arm driven as a path of all five kernels, its result read
    back, both controls run, the bounds checked on the summary."""
    import torch

    from tf_kaldi_speaker_tpu_torch.validation import convergence, corpora

    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    asked, checked = [], []
    monkeypatch.setattr(cs, "check_launched",
                        lambda path, run, names: asked.append(sorted(names)) or run["launches"])
    monkeypatch.setattr(cs, "check_quality_bounds", checked.append)
    for k, v in dict(NSPK=8, UTTS=4, TEST_NSPK=2).items():
        monkeypatch.setattr(corpora, k, v)
    monkeypatch.setattr(convergence, "BASE_CFG", dict(
        convergence.BASE_CFG, tdnn_layer_size=16, num_nodes_pooling_layer=24,
        num_nodes_last_layer=16, num_speakers_per_batch=4, min_segment_len=48,
        max_segment_len=48, num_buckets=1, num_steps_per_epoch=2))
    launches, shapes, summary = cs.run_quality(torch, str(tmp_path), device="cpu",
                                               steps_per_epoch=2)
    assert asked == [sorted(["cm_dequantize", "masked_stats_pooling",
                             "masked_stats_pooling_backward", "batch_norm_train",
                             "batch_norm_train_backward"])]
    assert checked == [summary]
    assert len(summary["valid_loss"]) == 3 and np.all(np.isfinite(summary["valid_loss"]))
    assert 0.0 <= summary["eer"] <= 1.0
    assert sorted(summary["controls"]) == ["shuffled_labels", "untrained"]
    for c in summary["controls"].values():
        assert 0.0 <= c["eer"] <= 1.0 and np.isfinite(c["valid_loss"])
    assert os.path.exists(str(tmp_path / "quality" / "train_shuffled" / "utt2spk"))
    assert "dequant_d12" not in summary
    with open(str(tmp_path / "quality" / "results" / "torch_amsoftmax_s1_flagship.json")) as f:
        result = json.load(f)
    assert result["program"] == "flagship" and result["dtype"] == "bfloat16"
    assert result["valid_loss"] == summary["valid_loss"] and result["eer"] == summary["eer"]
