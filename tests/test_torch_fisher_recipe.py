"""The port's copy of the Fisher v1 recipe
(``tf_kaldi_speaker_tpu_torch/recipes/fisher/v1/run.sh``): it calls the
port's CLIs only, keeps the JAX recipe's stages, variables and shipped
defaults (8 kHz MFCC options, ``filter_egs_dir --min-len 150 --min-num-utts
5 --valid-speakers 200 --valid-utts 5``, ``lda_dim`` 150, the AM-softmax
config), and its stages 1-2 (8 kHz MFCC + VAD, egs prep, filter and split)
run on the CPU with ``device=cpu`` on a tiny synthetic 8 kHz tree, with
smaller filter numbers. The later stages (train, extract, score) run on the
card in ``chip_smoke.py``; each stage's interpreter start-ups would take
this test past its budget here."""

import os
import re
import subprocess

from tf_kaldi_speaker_tpu_torch.utils.testdata import make_wav_data_dir, write_trials

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tf_kaldi_speaker_tpu_torch", "recipes", "fisher", "v1", "run.sh")
DEFAULTS = {"min_len": "150", "min_num_utts": "5", "valid_speakers": "200", "valid_utts": "5",
            "lda_dim": "150", "device": "cuda",
            "config": "recipes/fisher/v1/nnet_conf/tdnn_amsoftmax_m0.20_linear_bn_1e-2.json"}


def test_script_calls_the_port_only():
    with open(SCRIPT) as f:
        text = f.read()
    assert not re.search(r"tf_kaldi_speaker_tpu\.", text)
    clis = set(re.findall(r"tf_kaldi_speaker_tpu_torch\.cli\.(\w+)", text))
    assert clis == {"make_mfcc", "compute_vad", "fix_data_dir", "prepare_feats",
                    "filter_egs_dir", "train", "make_checkpoint", "extract", "score"}
    for name in clis:
        assert os.path.exists(os.path.join(REPO, "tf_kaldi_speaker_tpu_torch", "cli",
                                           name + ".py"))
    for line in text.splitlines():
        m = re.search(r"tf_kaldi_speaker_tpu_torch\.cli\.(\w+)", line)
        if m and m.group(1) in ("make_mfcc", "compute_vad", "prepare_feats", "train",
                                "extract"):
            assert '--device "$device"' in line, line
    for name, value in DEFAULTS.items():
        assert "%s=${%s:-%s}" % (name, name, value) in text, name
    with open(os.path.join(REPO, "recipes", "fisher", "v1", "run.sh")) as f:
        jax_text = f.read()
    stages = re.compile(r"=== stage (\d)")
    assert stages.findall(text) == stages.findall(jax_text) == [str(i) for i in range(1, 8)]
    variables = re.compile(r"^(\w+)=\$\{", re.M)
    assert variables.findall(text) == variables.findall(jax_text) + [
        "min_len", "min_num_utts", "valid_speakers", "valid_utts", "device"]
    mfcc = ("--sample-rate 8000 --num-ceps 23 --num-mel-bins 23 --low-freq 20 "
            "--high-freq 3700")
    for t in (text, jax_text):
        assert mfcc in " ".join(w for w in t.split() if w != "\\")


def test_stages_1_and_2_on_cpu(tmp_path):
    data = str(tmp_path / "data")
    sets = {"train_background": (6, 4, 0), "enroll": (2, 2, 1), "test": (2, 2, 2)}
    for name, (spk, utts, seed) in sets.items():
        d = make_wav_data_dir(os.path.join(data, name), num_speakers=spk, utts_per_speaker=utts,
                              min_seconds=1.5, max_seconds=2.5, sample_rate=8000, seed=seed)
        if name == "test":
            with open(d["utt2spk"]) as f:
                utt2spk = dict(line.split() for line in f)
            write_trials(os.path.join(data, name, "trials"), utt2spk)
    env = dict(os.environ, stage="1", stop_stage="2", device="cpu", data_root=data,
               exp=str(tmp_path / "exp"), min_len="50", min_num_utts="2", valid_speakers="2",
               valid_utts="2", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(["bash", SCRIPT], env=env, cwd=REPO, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=300)
    tail = proc.stdout[-6000:]
    assert proc.returncode == 0, tail
    for name in sets:
        for f in ("feats.scp", "vad.scp", "utt2num_frames"):
            assert os.path.getsize(os.path.join(data, name, "mfcc", f)) > 0, (name, f, tail)
    with open(os.path.join(data, "train_background", "mfcc", "feats.scp")) as f:
        assert len(f.read().splitlines()) == 24
    split = os.path.join(data, "split")
    with open(os.path.join(split, "train", "spklist")) as f:
        spks = f.read().splitlines()
    with open(os.path.join(split, "valid", "feats.scp")) as f:
        valid = f.read().splitlines()
    with open(os.path.join(split, "train", "feats.scp")) as f:
        train = f.read().splitlines()
    assert len(spks) == 6 and len(valid) == 4 and len(train) == 20, tail


# --------------------------------------------------------------------------
# The multitask recipe (tf_kaldi_speaker_tpu_torch/recipes/fisher/v3_multitask)
# --------------------------------------------------------------------------
V3_SCRIPT = os.path.join(REPO, "tf_kaldi_speaker_tpu_torch", "recipes", "fisher",
                         "v3_multitask", "run.sh")
# stage 2's filter and split numbers, cut on a patched copy for a corpus of
# 6 speakers x 5 utterances of 2.5-3.5 s
V3_SCRIPT_CUTS = (("--min-len 200 --min-num-utts 4", "--min-len 100 --min-num-utts 4"),
                  ("--valid-speakers 100 --valid-utts 4", "--valid-speakers 2 --valid-utts 2"))


def test_v3_script_calls_the_port_only():
    with open(V3_SCRIPT) as f:
        text = f.read()
    with open(os.path.join(REPO, "recipes", "fisher", "v3_multitask", "run.sh")) as f:
        jax_text = f.read()
    assert not re.search(r"tf_kaldi_speaker_tpu\.", text)
    clis = re.findall(r"tf_kaldi_speaker_tpu_torch\.cli\.(\w+)", text)
    assert clis == [c for c in re.findall(r"tf_kaldi_speaker_tpu\.cli\.(\w+)", jax_text)]
    for line in text.splitlines():
        m = re.search(r"tf_kaldi_speaker_tpu_torch\.cli\.(\w+)", line)
        if m and m.group(1) not in ("ali_to_pdf", "filter_egs_dir", "make_checkpoint"):
            assert '--device "$device"' in line, line
    assert "from tf_kaldi_speaker_tpu_torch.kio import read_vec_int_ark" in text
    assert "from tf_kaldi_speaker_tpu_torch.multitask import get_num_phones" in text
    stages = re.compile(r"=== stage (\d)")
    assert stages.findall(text) == stages.findall(jax_text) == [str(i) for i in range(1, 7)]
    variables = re.compile(r"^(\w+)=\$\{", re.M)
    assert variables.findall(text) == variables.findall(jax_text) + ["device"]
    assert "config=${config:-recipes/fisher/v3_multitask/nnet_conf/mt_softmax.json}" in text
    stage6 = text.split("=== stage 6")[1]
    assert ('bash tf_kaldi_speaker_tpu_torch/recipes/fisher/v3_multitask/run_decode.sh'
            in stage6 and '"$model" "$ali_dir" "${graph_dir:--}" "$data_root/split/valid"'
            in stage6 and "exit 1" not in stage6)
    for old, _ in V3_SCRIPT_CUTS:
        assert old in text and old in jax_text


def test_v3_stages_1_to_5_on_cpu_and_stage_6_refuses(tmp_path):
    """Stages 1-5 with ``device=cpu`` on a tiny 8 kHz tree: stage 1, then a
    synthetic Kaldi alignment dir frame-aligned with its MFCC (2001 pdfs;
    stage 2 converts it with the native ali_to_pdf), then stages 2-5 with
    a tiny config; x-vectors, phone posteriors and log-likelihoods of the
    pdf count's width come out. Stage 6, the port's decode recipe with no
    graph dir, pins the checkpoint and dumps the log-likelihoods again."""
    import json

    import numpy as np

    from tf_kaldi_speaker_tpu_torch.kio import read_mat_ark, read_vec_flt_scp
    from tf_kaldi_speaker_tpu_torch.utils.testdata import write_kaldi_alignments
    from test_multitask import MT_CFG

    data = tmp_path / "data"
    made = make_wav_data_dir(str(data / "voices"), num_speakers=6, utts_per_speaker=5,
                             min_seconds=2.5, max_seconds=3.5, sample_rate=8000, seed=3)
    (data / "fisher").mkdir()
    for name in ("wav_scp", "utt2spk"):
        with open(made[name]) as f:
            (data / "fisher" / os.path.basename(made[name])).write_text(f.read())
    with open(V3_SCRIPT) as f:
        script = f.read()
    for old, new in V3_SCRIPT_CUTS:
        script = script.replace(old, new)
    patched = tmp_path / "run.sh"
    patched.write_text(script)
    cfg = tmp_path / "mt.json"
    cfg.write_text(json.dumps(dict(MT_CFG, num_epochs=1, num_steps_per_epoch=2,
                                   steps_per_dispatch=2, valid_max_iterations=2,
                                   min_segment_len=64, max_segment_len=96)))
    exp = tmp_path / "exp"
    env = dict(os.environ, device="cpu", data_root=str(data), exp=str(exp), config=str(cfg),
               kaldi_ali_src=str(tmp_path / "tri5a_ali"), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))

    def run(first, last):
        return subprocess.run(["bash", str(patched)], env=dict(env, stage=str(first),
                                                               stop_stage=str(last)),
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=300)

    proc = run(1, 1)
    assert proc.returncode == 0, proc.stdout[-6000:]
    with open(data / "fisher" / "mfcc" / "utt2num_frames") as f:
        frames = {u: int(n) for u, n in (line.split() for line in f)}
    assert len(frames) == 30
    num_pdfs = write_kaldi_alignments(env["kaldi_ali_src"], frames, 667)
    assert num_pdfs == 2001
    proc = run(2, 5)
    tail = proc.stdout[-6000:]
    assert proc.returncode == 0, tail
    assert (data / "fisher_ali" / "num_pdfs").read_text() == "2001\n"
    with open(data / "split" / "valid" / "feats.scp") as f:
        valid = [line.split()[0] for line in f]
    assert len(valid) == 4, tail
    xv = dict(read_vec_flt_scp(str(exp / "xvectors_train.scp")))
    assert len(xv) == 26 and all(v.shape == (32,) and np.isfinite(v).all()
                                 for v in xv.values())
    for name in ("phone_post.ark", "loglike.ark"):
        mats = dict(read_mat_ark(str(exp / name)))
        assert sorted(mats) == sorted(valid)
        for key, m in mats.items():
            assert m.shape == (frames[key], num_pdfs) and np.isfinite(m).all(), (name, key)
    prior = np.array((exp / "prior.vec").read_text().strip("[] \n").split(), float)
    assert prior.shape == (num_pdfs,) and abs(prior.sum() - 1) < 1e-3
    for name in ("speaker_egs", "phone_egs"):
        assert (exp / "mt_xvector" / name).exists()
    proc = run(6, 6)
    assert proc.returncode == 0, proc.stdout[-6000:]
    assert "stopping after the loglike dump" in proc.stdout
    dumped = dict(read_mat_ark(str(exp / "mt_xvector" / "decode_valid" / "loglike.ark")))
    assert sorted(dumped) == sorted(valid)
    assert all(m.shape == (frames[k], num_pdfs) for k, m in dumped.items())
