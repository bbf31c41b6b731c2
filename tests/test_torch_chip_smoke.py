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
        want = ["cm_dequantize"]
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
