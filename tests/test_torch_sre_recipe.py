"""The port's copy of the SRE recipe
(``tf_kaldi_speaker_tpu_torch/recipes/sre/v1/run.sh``) held as
``tests/test_recipe_e2e.py`` holds the JAX script, with ``device=cpu``:

- ``test_sre_recipe``: 8 kHz synthetic wavs -> MFCC/VAD -> (augmentation
  skipped: no MUSAN/RIRS) -> egs -> train -> extract -> SRE10 PLDA, SRE16
  PLDA with unsupervised adaptation (``--adapt-scp``) and the per-language
  (tgl/yue) splits -> calibration, with the JAX test's cuts and assertions;
- ``test_sre_recipe_stage0_corpus_assembly``: stage 0 combines, validates
  and fixes the SRE04-08 and SWBD corpus dirs into the training pool.

The script calls the port's CLIs only and keeps the JAX script's stages,
variables and shipped defaults, plus ``device``.
"""

import json
import math
import os
import re
import subprocess

import numpy as np

from tf_kaldi_speaker_tpu_torch.cli.validate_data_dir import validate_data_dir
from tf_kaldi_speaker_tpu_torch.kio.wav import write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tf_kaldi_speaker_tpu_torch", "recipes", "sre", "v1", "run.sh")

# tests/test_recipe_e2e.py's tiny config
TINY_RECIPE_CFG = dict(
    seed=0, network_type="tdnn", pooling_type="statistics_pooling",
    embedding_node="tdnn6_dense", last_layer_linear=True,
    loss_func="additive_margin_softmax", amsoftmax_m=0.2,
    amsoftmax_lambda_min=0, amsoftmax_lambda_base=1000,
    amsoftmax_lambda_gamma=0.0001, amsoftmax_lambda_power=5,
    optimizer="sgd", weight_l2_regularizer=1e-3, batchnorm_momentum=0.99,
    tdnn_layer_size=16, num_nodes_pooling_layer=32, num_nodes_last_layer=16,
    num_epochs=1, num_steps_per_epoch=2, learning_rate=0.02,
    reduce_lr_epochs=2, early_stop_epochs=4, min_learning_rate=1e-5,
    keep_checkpoint_max=0, save_checkpoints_steps=2, save_summary_steps=0,
    show_training_progress=1, valid_max_iterations=2,
    num_parallel_datasets=1, max_queue_size=4,
    num_speakers_per_batch=4, num_segments_per_speaker=1,
    min_segment_len=30, max_segment_len=60, batch_type="softmax",
)
# tests/test_recipe_e2e.py's cuts of the filter and LDA numbers
SCRIPT_CUTS = (("--min-len 200 --min-num-utts 8", "--min-len 30 --min-num-utts 2"),
               ("--valid-speakers 200 --valid-utts 5", "--valid-speakers 2 --valid-utts 2"),
               ("--lda-dim 150", "--lda-dim 8"))


def _tone(freq, dur, rate=16000, amp=6000.0, seed=0):
    t = np.arange(int(dur * rate)) / rate
    rng = np.random.RandomState(seed)
    return (amp * np.sin(2 * np.pi * freq * t) + rng.randn(len(t)) * 300.0)


def _make_wav_dir(root, name, speakers, utts_per_spk, dur=1.2, seed=0,
                  rate=16000, spk_base=0):
    d = os.path.join(root, name)
    os.makedirs(os.path.join(d, "wavs"), exist_ok=True)
    scp, u2s = [], []
    k = 0
    for s in range(spk_base, spk_base + speakers):
        for u in range(utts_per_spk):
            utt = "spk%02d-utt%02d" % (s, u)
            path = os.path.join(d, "wavs", utt + ".wav")
            write_wav(path, _tone(200 + 80 * s + 7 * u, dur, rate=rate, seed=seed + k), rate)
            scp.append("%s %s" % (utt, path))
            u2s.append("%s spk%02d" % (utt, s))
            k += 1
    with open(os.path.join(d, "wav.scp"), "w") as f:
        f.write("\n".join(scp) + "\n")
    with open(os.path.join(d, "utt2spk"), "w") as f:
        f.write("\n".join(u2s) + "\n")
    return d


def _env(**kw):
    return dict(os.environ, device="cpu", OMP_NUM_THREADS="1",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), **kw)


def test_script_calls_the_port_only():
    with open(SCRIPT) as f:
        text = f.read()
    with open(os.path.join(REPO, "recipes", "sre", "v1", "run.sh")) as f:
        jax_text = f.read()
    assert not re.search(r"tf_kaldi_speaker_tpu\.", text)
    clis = re.findall(r"tf_kaldi_speaker_tpu_torch\.cli\.(\w+)", text)
    assert clis == re.findall(r"tf_kaldi_speaker_tpu\.cli\.(\w+)", jax_text)
    assert len(set(clis)) == 13
    for name in clis:
        assert os.path.exists(os.path.join(REPO, "tf_kaldi_speaker_tpu_torch", "cli",
                                           name + ".py"))
    for line in text.splitlines():
        m = re.search(r"tf_kaldi_speaker_tpu_torch\.cli\.(\w+)", line)
        if m and m.group(1) in ("make_mfcc", "compute_vad", "augment_data", "prepare_feats",
                                "train", "extract"):
            assert '--device "$device"' in line, line
    stages = re.compile(r"=== stage (\d)")
    assert stages.findall(text) == stages.findall(jax_text) == [str(i) for i in range(9)]
    variables = re.compile(r"^(\w+)=\$\{", re.M)
    assert variables.findall(text) == variables.findall(jax_text) + ["device"]
    for old, _ in SCRIPT_CUTS:
        assert old in text and old in jax_text


def test_sre_recipe(tmp_path):
    """sre/v1: 8 kHz MFCC -> train -> extract -> SRE10 PLDA, SRE16 PLDA with
    unsupervised adaptation + per-language (tgl/yue) splits -> calibration.
    Augmentation is skipped (no musan/rirs), exercising the recipe's own
    skip path."""
    data = str(tmp_path / "data")
    exp = str(tmp_path / "exp")
    _make_wav_dir(data, "swbd_sre", 10, 6, seed=0, rate=8000)
    _make_wav_dir(data, "sre16_major", 3, 2, seed=50, rate=8000)
    _make_wav_dir(data, "sre10_enroll", 3, 2, seed=100, rate=8000)
    sre10_test = _make_wav_dir(data, "sre10_test", 3, 2, seed=200, rate=8000)
    _make_wav_dir(data, "sre16_enroll", 4, 2, seed=300, rate=8000)
    sre16_test = _make_wav_dir(data, "sre16_test", 4, 2, seed=400, rate=8000)

    def write_trials(d, n_spk, langs=None):
        utts = [l.split()[0] for l in open(os.path.join(d, "wav.scp"))]
        with open(os.path.join(d, "trials"), "w") as f:
            for s in range(n_spk):
                for u in utts:
                    t = "target" if u.startswith("spk%02d" % s) else "nontarget"
                    f.write("spk%02d %s %s\n" % (s, u, t))
        if langs:
            for lang in set(langs.values()):
                with open(os.path.join(d, "trials_%s" % lang), "w") as f:
                    for line in open(os.path.join(d, "trials")):
                        u = line.split()[1]
                        if langs[int(u.split("-")[0][3:])] == lang:
                            f.write(line)

    write_trials(sre10_test, 3)
    write_trials(sre16_test, 4, langs={0: "tgl", 1: "tgl", 2: "yue", 3: "yue"})

    cfg_dir = tmp_path / "conf"
    cfg_dir.mkdir()
    with open(cfg_dir / "tiny.json", "w") as f:
        json.dump(TINY_RECIPE_CFG, f)

    script = open(SCRIPT).read()
    for old, new in SCRIPT_CUTS:
        script = script.replace(old, new)
    run_sh = tmp_path / "run.sh"
    run_sh.write_text(script)

    proc = subprocess.run(
        ["bash", str(run_sh)], cwd=REPO,
        env=_env(stage="1", data_root=data, exp=exp, config=str(cfg_dir / "tiny.json"),
                 model=os.path.join(exp, "m")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stdout[-6000:]
    tail = proc.stdout[-4000:]
    assert "SKIPPING augmentation" in proc.stdout, tail
    assert os.path.getsize(os.path.join(exp, "scores_sre10.txt")) > 0, tail
    assert os.path.getsize(os.path.join(exp, "scores_sre16.txt")) > 0, tail
    assert "[tgl]" in proc.stdout and "[yue]" in proc.stdout, tail
    for lang, n_spk_lang in (("tgl", 2), ("yue", 2)):
        split = os.path.join(exp, "scores_sre16.txt.%s" % lang)
        lines = open(split).read().splitlines()
        assert len(lines) == 4 * n_spk_lang * 2, (lang, len(lines), tail)
    assert "calibration: llr =" in proc.stdout, tail
    cal = open(os.path.join(exp, "scores_sre16_cal.txt")).read().splitlines()
    assert len(cal) == 4 * 8, tail
    m = re.search(
        r"eval Cllr raw-as-llr: ([\d.]+)\s+minCllr: ([\d.]+)\s+"
        r"Cllr calibrated: ([\d.]+)", proc.stdout)
    assert m, tail
    cllr_raw, min_cllr, cllr_cal = map(float, m.groups())
    assert all(math.isfinite(v) for v in (cllr_raw, min_cllr, cllr_cal)), tail
    assert cllr_raw >= min_cllr - 1e-6 and cllr_cal >= min_cllr - 1e-6, (
        cllr_raw, min_cllr, cllr_cal)
    dcfs = re.findall(
        r"p_target=\S+ c_miss=\S+ c_fa=\S+: minDCF ([\d.]+)\s+"
        r"actDCF ([\d.]+)", proc.stdout)
    assert len(dcfs) == 2, tail  # --operating-point 0.01 and 0.001
    for min_dcf, act_dcf in dcfs:
        min_dcf, act_dcf = float(min_dcf), float(act_dcf)
        assert math.isfinite(act_dcf) and act_dcf >= min_dcf - 1e-6, (
            min_dcf, act_dcf)


def _tiny_corpus_dir(root, name, spk, n_utts=3):
    d = os.path.join(root, name)
    os.makedirs(d)
    utts = ["%s-u%d" % (spk, j) for j in range(n_utts)]
    with open(os.path.join(d, "wav.scp"), "w") as f:
        f.write("".join("%s /x/%s.wav\n" % (u, u) for u in utts))
    with open(os.path.join(d, "utt2spk"), "w") as f:
        f.write("".join("%s %s\n" % (u, spk) for u in utts))
    with open(os.path.join(d, "spk2utt"), "w") as f:
        f.write("%s %s\n" % (spk, " ".join(utts)))


def test_sre_recipe_stage0_corpus_assembly(tmp_path):
    """sre/v1 stage 0 mirrors the reference's executed corpus assembly
    (run.sh:68-100 + the swbd_sre combine at :120): combine SRE04-08 ->
    sre, SWBD2+cellular -> swbd, validate+fix each, combine the training
    pool."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    corpora = [
        "sre2004", "sre2005_train", "sre2005_test", "sre2006_train",
        "sre2006_test", "sre08", "swbd2_phase1_train", "swbd2_phase2_train",
        "swbd2_phase3_train", "swbd_cellular1_train", "swbd_cellular2_train",
    ]
    for i, name in enumerate(corpora):
        _tiny_corpus_dir(data, name, "c%02dspk" % i)

    proc = subprocess.run(
        ["bash", SCRIPT], env=_env(stage="0", stop_stage="0", data_root=data),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-6000:]

    assert validate_data_dir(os.path.join(data, "sre"), no_text=True, no_feats=True)["utt2spk"] == 18
    assert validate_data_dir(os.path.join(data, "swbd"), no_text=True, no_feats=True)["utt2spk"] == 15
    counts = validate_data_dir(os.path.join(data, "swbd_sre"), no_text=True, no_feats=True)
    assert counts["utt2spk"] == 33 and counts["spk2utt"] == 11
