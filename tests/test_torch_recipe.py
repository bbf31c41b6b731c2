"""The port's copy of the VoxCeleb recipe
(``tf_kaldi_speaker_tpu_torch/recipes/voxceleb/v1/run.sh``) end to end on
the CPU (``device=cpu``): stage 0 builds the data dirs from synthetic
VoxCeleb1 (consolidated) and VoxCeleb2 (dev and test, wav layout) corpus
trees of real wavs and a verification list, then MFCC/VAD, the four
MUSAN/RIRS augmentations, egs prep, the filter and split, training,
fine-tuning, extraction and cosine/PLDA scoring to an EER, at the tiny
widths of ``tests/test_recipe_e2e.py``; the same cuts of a patched copy of
the script as that test makes of the JAX recipe. The script calls
``tf_kaldi_speaker_tpu_torch.cli`` only, and takes ``device`` as its one
extra variable."""

import json
import os
import re
import subprocess

import numpy as np

from tf_kaldi_speaker_tpu_torch.kio.wav import write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tf_kaldi_speaker_tpu_torch", "recipes", "voxceleb", "v1", "run.sh")

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


def _tone(freq, dur, seed, rate=16000):
    t = np.arange(int(dur * rate)) / rate
    return 6000.0 * np.sin(2 * np.pi * freq * t) + np.random.RandomState(seed).randn(len(t)) * 300


def _corpus_tree(root, spk_ids, seed):
    """root/<idXXXXX>/<video>/<clip>.wav: 2 videos x 2 clips a speaker,
    each speaker at its own base frequency."""
    k = 0
    for s in spk_ids:
        for v in ("vidA", "vidB"):
            for c in ("00001", "00002"):
                d = os.path.join(root, "id%05d" % s, v)
                os.makedirs(d, exist_ok=True)
                write_wav(os.path.join(d, c + ".wav"), _tone(150 + 45 * (s % 50) + 5 * k, 1.2,
                                                             seed + k), 16000)
                k += 1


def _sources(root, name, n, seed):
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        path = os.path.join(d, "src%02d.wav" % i)
        write_wav(path, rng.randn(32000) * 500.0, 16000)
        lines.append("src%02d %s" % (i, path))
    with open(os.path.join(d, "wav.scp"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return d


def test_script_calls_the_port_only():
    with open(SCRIPT) as f:
        text = f.read()
    assert "tf_kaldi_speaker_tpu.cli" not in text
    assert "device=${device:-cuda}" in text
    clis = set(re.findall(r"tf_kaldi_speaker_tpu_torch\.cli\.(\w+)", text))
    assert clis == {"make_voxceleb", "combine_data", "make_mfcc", "compute_vad", "augment_data",
                    "prepare_feats", "filter_egs_dir", "train", "finetune", "make_checkpoint",
                    "extract", "score"}
    for name in clis:
        assert os.path.exists(os.path.join(REPO, "tf_kaldi_speaker_tpu_torch", "cli",
                                           name + ".py"))
    # every port CLI with a --device option gets it
    for line in text.splitlines():
        m = re.search(r"tf_kaldi_speaker_tpu_torch\.cli\.(\w+)", line)
        if m and m.group(1) in ("make_mfcc", "compute_vad", "augment_data", "prepare_feats",
                                "train", "finetune", "extract"):
            assert '--device "$device"' in line, line
    with open(os.path.join(REPO, "recipes", "voxceleb", "v1", "run.sh")) as f:
        jax_text = f.read()
    # the same stages and variables as the JAX recipe, plus device
    stages = re.compile(r"=== stage (\d)")
    assert stages.findall(text) == stages.findall(jax_text) == [str(i) for i in range(9)]
    variables = re.compile(r"^(\w+)=\$\{", re.M)
    assert variables.findall(text) == variables.findall(jax_text) + ["device"]


def test_recipe_stages_0_to_8_on_cpu(tmp_path):
    root = str(tmp_path)
    vox1, vox2 = os.path.join(root, "vox1"), os.path.join(root, "vox2")
    _corpus_tree(os.path.join(vox1, "wav"), range(1, 7), seed=0)  # 4 train + 2 test speakers
    _corpus_tree(os.path.join(vox2, "dev", "wav"), range(101, 104), seed=100)
    _corpus_tree(os.path.join(vox2, "test", "wav"), [201], seed=200)
    with open(os.path.join(vox1, "veri_test.txt"), "w") as f:
        for a, b, lab in (("5/vidA/00001", "5/vidB/00002", 1),
                          ("5/vidA/00001", "6/vidA/00001", 0),
                          ("6/vidA/00002", "6/vidB/00001", 1),
                          ("5/vidB/00001", "6/vidB/00002", 0),
                          ("5/vidA/00002", "6/vidA/00002", 0),
                          ("6/vidA/00001", "6/vidA/00002", 1)):
            f.write("%d id0000%s.wav id0000%s.wav\n" % (lab, a, b))
    data, exp = os.path.join(root, "data"), os.path.join(root, "exp")
    musan = os.path.join(data, "musan")
    for seed, sub in enumerate(("noise", "music", "speech")):
        _sources(musan, sub, 3, seed=300 + seed)
    rirs = os.path.join(data, "rirs")
    os.makedirs(rirs)
    rng = np.random.RandomState(7)
    lines = []
    for i in range(2):
        rir = rng.randn(800) * 0.01
        rir[0], rir[100 + 50 * i] = 1.0, 0.4
        path = os.path.join(rirs, "rir%d.wav" % i)
        write_wav(path, rir * 8000.0, 16000)
        lines.append("rir%d %s" % (i, path))
    with open(os.path.join(rirs, "wav.scp"), "w") as f:
        f.write("\n".join(lines) + "\n")
    conf = os.path.join(root, "conf")
    os.makedirs(conf)
    with open(os.path.join(conf, "tiny.json"), "w") as f:
        json.dump(TINY_RECIPE_CFG, f)
    with open(os.path.join(conf, "tiny_ft.json"), "w") as f:
        json.dump(dict(TINY_RECIPE_CFG, aux_loss_func=["mhe_loss"], mhe_lambda=0.01,
                       noload_var_list=[], noupdate_var_list=[]), f)

    with open(SCRIPT) as f:
        script = f.read()
    for old, new in (("--min-len 200 --min-num-utts 8", "--min-len 30 --min-num-utts 2"),
                     ("--valid-speakers 200 --valid-utts 5", "--valid-speakers 2 --valid-utts 2"),
                     ("--lda-dim 200", "--lda-dim 8")):
        assert old in script
        script = script.replace(old, new)
    run_sh = os.path.join(root, "run.sh")
    with open(run_sh, "w") as f:
        f.write(script)
    env = dict(os.environ, stage="0", stop_stage="8", device="cpu", data_root=data, exp=exp,
               voxceleb1_root=vox1, voxceleb2_root=vox2, musan_root=musan, rirs_root=rirs,
               aug_frac="0.5", config=os.path.join(conf, "tiny.json"),
               finetune_config=os.path.join(conf, "tiny_ft.json"), model=os.path.join(exp, "m"),
               finetune_model=os.path.join(exp, "m_ft"), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(["bash", run_sh], env=env, cwd=REPO, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=600)
    tail = proc.stdout[-6000:]
    assert proc.returncode == 0, tail
    assert "SKIPPING" not in proc.stdout
    # stage 0: the trials of the two test speakers, 16 + 12 train utterances
    with open(os.path.join(data, "voxceleb1_test", "trials")) as f:
        assert len(f.read().splitlines()) == 6
    for name, n in (("voxceleb1_dev", 16), ("voxceleb2", 16), ("voxceleb1_test", 8)):
        with open(os.path.join(data, name, "utt2spk")) as f:
            assert len(f.read().splitlines()) == n, name
    # the augmented copies of all four kinds entered training
    with open(os.path.join(data, "train_aug", "mfcc", "feats.scp")) as f:
        n_aug = len(f.read().splitlines())
    with open(os.path.join(data, "train_combined", "feats.scp")) as f:
        combined = f.read().splitlines()
    assert n_aug > 0 and len(combined) == 32 + n_aug, tail
    suffixes = {u.split()[0].rsplit("-", 1)[-1] for u in combined}
    assert {"reverb", "noise", "music", "babble"} <= suffixes, tail
    for model in ("m", "m_ft"):
        assert os.path.exists(os.path.join(exp, model, "nnet", "checkpoint")), tail
    for way in ("cosine", "plda"):
        assert os.path.getsize(os.path.join(exp, "scores_%s.txt" % way)) > 0, tail
    assert re.search(r"eer", proc.stdout, re.I), tail
