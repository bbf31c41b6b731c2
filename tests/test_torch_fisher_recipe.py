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
