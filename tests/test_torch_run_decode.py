"""The port's decode recipe end to end on the CPU, with no Kaldi binary:
``tf_kaldi_speaker_tpu_torch/recipes/fisher/v3_multitask/run_decode.sh``
with ``device=cpu``, as ``tests/test_run_decode.py`` drives the JAX copy:
checkpoint pin -> senone prior from pdf.ark -> compute_loglike -> native
WFST decode_faster with lattices -> WER against $data/text -> the
lattice_best_path sweep; the same artifacts are asserted. Then the port's
v3 ``run.sh`` stage 6 over the graph dir runs the same recipe and exits 0.

The cut: each run decodes the first utterances of the valid set (2, and 1
for stage 6), where the JAX test decodes all 8. The model, one epoch of 5
steps on random alignments, gives nearly flat log-likelihoods, so every
utterance's lattice holds exponentially many word sequences and the
Python determinization (in JAX as in the port) runs until it stops at its
200,000-state guard, and the raw lattice is written instead.
For the same reason ``lmrescore``, which must determinize, is not in this
chain: ``tests/test_torch_lattice.py`` holds it against the JAX CLI, and
``chip_smoke.py`` runs stage 6 with ``newarpa`` over a graph whose
lattices determinize."""

import json
import os
import shutil
import subprocess

import numpy as np
import pytest

from test_multitask import MT_CFG, NUM_PHONES
from tf_kaldi_speaker_tpu_torch.backend.lattice import read_lattice_ark
from tf_kaldi_speaker_tpu_torch.kio import read_mat_ark, read_vec_int_ark
from tf_kaldi_speaker_tpu_torch.kio.fst import build_fst, write_fst
from tf_kaldi_speaker_tpu_torch.kio.transition_model import (
    TransitionModel,
    write_transition_model,
)
from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_RECIPE = os.path.join(REPO, "tf_kaldi_speaker_tpu_torch", "recipes", "fisher",
                           "v3_multitask")


def _one_state_model(num_pdfs):
    """1 emitting state per phone, pdf p-1 for phone p: num_pdfs senones,
    2 tids per phone (self-loop, forward)."""
    entries = [[(0, 0, [(0, 0.5), (1, 0.5)]), (-1, -1, [])]]
    phones = list(range(1, num_pdfs + 1))
    phone2idx = [-1] + [0] * num_pdfs
    tuples = [(p, 0, p - 1, p - 1) for p in phones]
    return TransitionModel(
        phones, phone2idx, entries, tuples,
        np.zeros(1 + 2 * num_pdfs, np.float32),
    )


def _phone_loop_graph(tm, num_words):
    arcs, state = [], 1
    for w in range(1, num_words + 1):
        self_tid = tm.state2id[w]       # transitions[0] is the self-loop
        fwd_tid = self_tid + 1
        s = state
        state += 1
        arcs.append((0, fwd_tid, w, 0.3, s))
        arcs.append((s, self_tid, 0, 0.05, s))
        arcs.append((s, 0, 0, 0.0, 0))
    return build_fst(0, state, arcs, {0: 0.0})


@pytest.fixture(scope="module")
def decode_setup(tmp_path_factory):
    """A multitask model trained by the port's ``train_mt --device cpu``,
    its valid data with reference transcripts, and a graph dir."""
    from tf_kaldi_speaker_tpu_torch.cli import train_mt

    tmp_path = tmp_path_factory.mktemp("decode")
    train_d = make_fake_data_dir(
        str(tmp_path / "train"), num_speakers=4, utts_per_speaker=3, dim=20,
        min_len=120, max_len=160, with_vad_ali=True, num_phones=NUM_PHONES,
        seed=0,
    )
    valid_d = make_fake_data_dir(
        str(tmp_path / "valid"), num_speakers=4, utts_per_speaker=2, dim=20,
        min_len=120, max_len=160, with_vad_ali=True, num_phones=NUM_PHONES,
        seed=1,
    )
    cfg = dict(MT_CFG, num_epochs=1)
    cfg_path = str(tmp_path / "mt.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    model_dir = str(tmp_path / "exp")
    assert train_mt.main([
        "--config", cfg_path, "--device", "cpu",
        train_d["data"], train_d["ali_dir"], train_d["spklist"],
        valid_d["data"], valid_d["ali_dir"], valid_d["spklist"],
        model_dir,
    ]) == 0

    # graph dir (HCLG + words.txt) over a transition model whose pdf count
    # matches the phone head; final.mdl one level above, Kaldi-style.
    tm = _one_state_model(NUM_PHONES)
    graph_dir = tmp_path / "lang" / "graph"
    os.makedirs(graph_dir)
    write_fst(str(graph_dir / "HCLG.fst"), _phone_loop_graph(tm, NUM_PHONES),
              "const")
    with open(graph_dir / "words.txt", "w") as f:
        f.write("<eps> 0\n")
        for w in range(1, NUM_PHONES + 1):
            f.write("p%d %d\n" % (w, w))
    write_transition_model(str(tmp_path / "lang" / "final.mdl"), tm)

    return dict(root=tmp_path, model=model_dir, ali=train_d["ali_dir"], valid=valid_d["data"],
                graph=str(graph_dir))


def _decode_data(valid, dest, n):
    """``dest``: the first ``n`` utterances of ``valid`` (feats.scp) with
    reference transcripts for the WER stage (arbitrary words)."""
    os.makedirs(dest)
    with open(os.path.join(valid, "feats.scp")) as f:
        lines = f.readlines()[:n]
    with open(os.path.join(dest, "feats.scp"), "w") as f:
        f.writelines(lines)
    utts = [line.split()[0] for line in lines]
    with open(os.path.join(dest, "text"), "w") as f:
        for u in utts:
            f.write("%s p1 p2\n" % u)
    return utts


def _assert_decode_outputs(out, utts):
    """What tests/test_run_decode.py asserts of the JAX recipe's outputs."""
    assert os.path.exists(os.path.join(out, "loglike.ark"))
    lls = dict(read_mat_ark(os.path.join(out, "loglike.ark")))
    assert all(m.shape[1] == NUM_PHONES for m in lls.values())

    words = dict(read_vec_int_ark(os.path.join(out, "words.ark")))
    assert set(words) == set(utts)
    for v in words.values():
        assert np.all(v >= 1) and np.all(v <= NUM_PHONES)
    ali = dict(read_vec_int_ark(os.path.join(out, "ali.ark")))
    for u in utts:
        assert len(ali[u]) == lls[u].shape[0]  # one tid per frame

    with open(os.path.join(out, "text")) as f:
        hyp = {line.split()[0] for line in f if line.strip()}
    assert hyp == set(utts)
    with open(os.path.join(out, "wer")) as f:
        wer_line = f.readline()
    assert wer_line.startswith("%WER")

    lats = dict(read_lattice_ark(os.path.join(out, "lat.txt")))
    assert set(lats) == set(utts)
    for u in utts:
        w, a, c = lats[u].best_path(acoustic_scale=0.1)
        assert len(a) == lls[u].shape[0]
    with open(os.path.join(out, "wer.best")) as f:
        assert "best lmwt" in f.read()


def _env(**kw):
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                device="cpu", **kw)


def test_run_decode_sh_native(decode_setup):
    s = decode_setup
    data = str(s["root"] / "dev")
    utts = _decode_data(s["valid"], data, 2)
    proc = subprocess.run(
        ["bash", os.path.join(PORT_RECIPE, "run_decode.sh"),
         s["model"], s["ali"], s["graph"], data],
        env=_env(checkpoint="last"), capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "native decode_faster" in proc.stdout
    _assert_decode_outputs(os.path.join(s["model"], "decode_dev"), utts)


def test_v3_run_sh_stage_6_decodes(decode_setup):
    """Stage 6 of the port's v3 ``run.sh`` with ``graph_dir`` set: the
    recipe's outputs."""
    s = decode_setup
    root = s["root"] / "stage6"
    model = str(root / "mt_xvector")
    shutil.copytree(s["model"], model)
    utts = _decode_data(s["valid"], str(root / "data" / "split" / "valid"), 1)
    proc = subprocess.run(
        ["bash", os.path.join(PORT_RECIPE, "run.sh")],
        env=_env(stage="6", stop_stage="6", data_root=str(root / "data"), exp=str(root),
                 model=model, ali_dir=s["ali"], graph_dir=s["graph"], checkpoint="last"),
        cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "=== stage 6" in proc.stdout and "native decode_faster" in proc.stdout
    _assert_decode_outputs(os.path.join(model, "decode_valid"), utts)
