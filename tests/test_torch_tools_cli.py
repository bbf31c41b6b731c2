"""The port's diagnostic CLIs against the JAX package's, on one model dir
written by the JAX Trainer (msgpack, read by the port's own decoder):
``extract_softmax_weights`` (arks byte-equal), ``target_logit_curve``
(the CSV text equal) and ``train_insight`` (the valid loss within 1e-5,
the EER equal), the port's on the CPU."""

import json
import os
import re

import numpy as np
import pytest
import torch

from test_extract_backend import TINY_CONFIG
from tf_kaldi_speaker_tpu.cli import extract_softmax_weights as jax_weights
from tf_kaldi_speaker_tpu.cli import target_logit_curve as jax_curve
from tf_kaldi_speaker_tpu.cli import train_insight as jax_insight
from tf_kaldi_speaker_tpu_torch.cli import extract_softmax_weights, target_logit_curve, train_insight
from tf_kaldi_speaker_tpu_torch.kio import read_vec_flt_ark

torch.set_num_threads(1)

NUM_SPEAKERS = 6
# every validation batch read: the loss pass's two loader threads deliver
# their batches in the order they finish them, so a cut at fewer batches
# than there are (TINY_CONFIG's 3 of 4) averages a different subset from
# run to run, in either package
CONFIG = dict(TINY_CONFIG, valid_max_iterations=100)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A JAX-trained-format model dir and a validation data dir
    (test_tools_cli.test_debug_clis's)."""
    from tf_kaldi_speaker_tpu.train.trainer import Trainer
    from tf_kaldi_speaker_tpu.utils.params import ParamsPlain
    from tf_kaldi_speaker_tpu.utils.testdata import make_fake_data_dir

    root = tmp_path_factory.mktemp("tools")
    d = make_fake_data_dir(str(root / "data"), num_speakers=NUM_SPEAKERS, utts_per_speaker=3,
                           dim=20, min_len=80, max_len=120)
    nnet = str(root / "m" / "nnet")
    t = Trainer(ParamsPlain(**CONFIG), nnet, dim=20, num_speakers=NUM_SPEAKERS)
    t.build("train", 20, CONFIG["loss_func"], NUM_SPEAKERS)
    t.save(0)
    with open(os.path.join(nnet, "config.json"), "w") as f:
        json.dump(CONFIG, f)
    for name, value in (("feature_dim", 20), ("num_speakers", NUM_SPEAKERS)):
        with open(os.path.join(nnet, name), "w") as f:
            f.write("%d\n" % value)
    return dict(d, model=str(root / "m"))


def test_extract_softmax_weights_matches_jax(model, tmp_path, capsys):
    port, jax = str(tmp_path / "port.ark"), str(tmp_path / "jax.ark")
    assert extract_softmax_weights.main([model["model"], port]) == 0
    assert jax_weights.main([model["model"], jax]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == "Wrote %d class weight vectors (step 0)" % NUM_SPEAKERS
    with open(port, "rb") as f, open(jax, "rb") as g:
        assert f.read() == g.read()
    vecs = dict(read_vec_flt_ark(port))
    assert len(vecs) == NUM_SPEAKERS
    assert all(v.shape == (TINY_CONFIG["num_nodes_last_layer"],) for v in vecs.values())


@pytest.mark.parametrize("args", [[], ["--amsoftmax-m", "0.35", "--arcsoftmax-m", "0.5"]])
def test_target_logit_curve_matches_jax(tmp_path, args):
    """Every %g cell equal, the float32 A-softmax columns included (the
    port's asoftmax_phi on float32 tensors, JAX's in float32 jax.numpy),
    and the λ schedule's CSV."""
    port, jax = tmp_path / "port", tmp_path / "jax"
    for d in (port, jax):
        d.mkdir()
    lam = ["--lambda-base", "1000", "--lambda-gamma", "1e-4", "--num-steps", "50000"]
    assert target_logit_curve.main(args + lam + ["--device", "cpu", "--lambda-curve",
                                                 str(port / "lam.csv"), str(port / "c.csv")]) == 0
    assert jax_curve.main(args + lam + ["--lambda-curve", str(jax / "lam.csv"),
                                        str(jax / "c.csv")]) == 0
    for name in ("c.csv", "lam.csv"):
        assert (port / name).read_text() == (jax / name).read_text(), name
    rows = (port / "c.csv").read_text().strip().split("\n")
    assert "asoftmax_m4" in rows[0].split(",") and len(rows) == 402


def _insight(text):
    m = re.search(r"valid_loss (\S+) eer (\S+) \((\d+) embeddings\)", text)
    return float(m.group(1)), float(m.group(2)), int(m.group(3))


def test_train_insight_matches_jax(model, capsys):
    assert train_insight.main(["--device", "cpu", model["data"], model["spklist"],
                               model["model"]]) == 0
    port = _insight(capsys.readouterr().out)
    assert jax_insight.main([model["data"], model["spklist"], model["model"]]) == 0
    want = _insight(capsys.readouterr().out)
    assert port[2] == want[2] == NUM_SPEAKERS * 3
    assert abs(port[0] - want[0]) <= 1e-5 and np.isfinite(port[0])
    assert port[1] == want[1]


def test_tools_refuse_a_missing_card(model, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        target_logit_curve.main([str(tmp_path / "c.csv")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_insight.main([model["data"], model["spklist"], model["model"]])
