"""The port's multitask CLIs with ``--device cpu`` against the JAX package's
(tests/test_multitask_cli.py's chain, at its MT_CFG widths):

- on a model dir that the JAX package wrote (its trainer's ``.msgpack``
  checkpoint of numpy-drawn variables, at step 2): ``extract_mt`` (plain,
  ``--normalize``, and chunked with ``--chunk-size``), ``extract_mt_phone``
  and ``compute_loglike`` against the JAX CLIs, the same keys in the same
  order and every value within rtol/atol 1e-5 (float32; the two frameworks
  sum convolutions in different orders, so the bytes differ);
- ``train_mt --cont`` resumes that JAX checkpoint (epoch 2 of 2: a
  checkpoint at step 4, one validation line);
- ``train_mt`` from scratch, then ``extract_mt`` -> ``extract_mt_phone`` ->
  ``compute_loglike`` on its model: the egs counts, the shapes, and
  log-likelihoods that are log-posteriors minus the log-prior;
- the LR sweep of ``train_mt_lr_learning``: the port's trainer against the
  JAX trainer's from the same variables (the rates exactly, the first 25
  mean losses within rtol 1e-5), and the port's CLI's sweep lines;
- every new CLI defaults to ``--device cuda`` and raises without a card.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu.kio import native_decode as jnd
from tf_kaldi_speaker_tpu.multitask.trainer import TrainerMultiTask as JaxTrainerMT
from tf_kaldi_speaker_tpu.parallel.mesh import make_mesh
from tf_kaldi_speaker_tpu.utils.params import ParamsPlain as JaxParams
from tf_kaldi_speaker_tpu_torch.cli import (compute_loglike, extract_mt, extract_mt_phone,
                                            train_mt, train_mt_lr_learning)
from tf_kaldi_speaker_tpu_torch.kio import read_mat_ark, read_vec_flt_ark
from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir
from test_multitask import MT_CFG, NUM_PHONES
from test_torch_multitask import DIM, SPEAKERS, _DrawnInit

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(MT_CFG, num_epochs=2, num_steps_per_epoch=2, steps_per_dispatch=2,
           reduce_lr_epochs=2, early_stop_epochs=4, min_learning_rate=1e-6)


@pytest.fixture(autouse=True)
def jax_numpy_decode(monkeypatch):
    monkeypatch.setattr(jnd, "_get_lib", lambda: None)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mt_cli")
    kw = dict(num_speakers=SPEAKERS, dim=DIM, min_len=120, max_len=200, with_vad_ali=True,
              num_phones=NUM_PHONES)
    train = make_fake_data_dir(str(root / "train"), utts_per_speaker=4, seed=0, **kw)
    valid = make_fake_data_dir(str(root / "valid"), utts_per_speaker=2, seed=1, **kw)
    # the JAX CLIs compile a program for each utterance length: 4 of them
    with open(train["feats_scp"]) as f:
        (root / "few.scp").write_text("".join(f.readlines()[:4]))
    train["few_scp"] = str(root / "few.scp")
    cfg_path = str(root / "mt.json")
    with open(cfg_path, "w") as f:
        json.dump(CFG, f)
    return root, train, valid, cfg_path


@pytest.fixture(scope="module")
def jax_model(dirs):
    """A model dir in the JAX package's layout: its trainer's checkpoint
    (``model-2.msgpack``, numpy-drawn variables, a zero momentum trace)
    beside the config and the dims."""
    root, _, _, _ = dirs
    model = root / "jax_model"
    nnet = model / "nnet"
    jt = JaxTrainerMT(JaxParams(**CFG), str(nnet), dim=DIM, num_speakers=SPEAKERS,
                      num_phones=NUM_PHONES, mesh=make_mesh(devices=jax.devices()[:1]))
    jt.network_model = _DrawnInit(config=CFG, num_speakers=SPEAKERS, num_phones=NUM_PHONES)
    jt.build("train", DIM, num_speakers=SPEAKERS, num_phones=NUM_PHONES)
    jt.state = jt.state.replace(step=jax.numpy.asarray(2, jax.numpy.int32))
    jt.save(2)
    with open(nnet / "config.json", "w") as f:
        json.dump(CFG, f)
    for name, value in (("feature_dim", DIM), ("num_speakers", SPEAKERS),
                        ("num_phones", NUM_PHONES)):
        (nnet / name).write_text("%d\n" % value)
    return str(model)


def _both(jax_main, port_main, argv, out_dir, out_name):
    """Run the JAX CLI and the port's (``--device cpu``) with ``argv`` + an
    output wspecifier each; returns the two output paths."""
    outs = []
    for name, main, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        path = str(out_dir / ("%s_%s" % (name, out_name)))
        assert main(extra + argv + ["ark:" + path]) == 0
        outs.append(path)
    return outs


def _assert_arks_close(reader, got_path, want_path):
    got, want = list(reader(got_path)), list(reader(want_path))
    assert [k for k, _ in got] == [k for k, _ in want] and len(want) > 0
    for (key, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, err_msg=key, **TOL)


@pytest.mark.parametrize("flags", [[], ["--normalize"], ["--chunk-size", "150"]],
                         ids=["plain", "normalize", "chunked"])
def test_extract_mt_matches_jax(dirs, jax_model, flags, tmp_path):
    from tf_kaldi_speaker_tpu.cli import extract_mt as jax_extract_mt

    _, train, _, _ = dirs
    with open(train["utt2num_frames"]) as f:
        lengths = [int(line.split()[1]) for line in f.readlines()[:4]]
    shortest = sorted(lengths)[1]  # the shortest utterance is skipped
    got, want = _both(jax_extract_mt.main, extract_mt.main,
                      flags + ["--min-chunk-size", str(shortest), jax_model,
                               "scp:" + train["few_scp"]], tmp_path, "xv.ark")
    _assert_arks_close(read_vec_flt_ark, got, want)
    kept = sum(n >= shortest for n in lengths)
    assert len(dict(read_vec_flt_ark(got))) == kept and 0 < kept < 4


def test_extract_mt_phone_and_loglike_match_jax(dirs, jax_model, tmp_path):
    from tf_kaldi_speaker_tpu.cli import compute_loglike as jax_loglike
    from tf_kaldi_speaker_tpu.cli import extract_mt_phone as jax_phone

    _, train, _, _ = dirs
    scp = "scp:" + train["few_scp"]
    got, want = _both(jax_phone.main, extract_mt_phone.main, [jax_model, scp], tmp_path,
                      "phn.ark")
    _assert_arks_close(read_mat_ark, got, want)
    prior = np.random.RandomState(0).rand(NUM_PHONES) + 0.5
    prior_path = str(tmp_path / "prior.vec")
    with open(prior_path, "w") as f:
        f.write("[ " + " ".join("%.17g" % p for p in prior / prior.sum()) + " ]\n")
    got_ll, want_ll = _both(jax_loglike.main, compute_loglike.main,
                            ["--prior", prior_path, jax_model, scp], tmp_path, "ll.ark")
    _assert_arks_close(read_mat_ark, got_ll, want_ll)


def test_train_mt_cont_from_a_jax_checkpoint(dirs, jax_model, tmp_path):
    _, train, valid, _ = dirs
    model = str(tmp_path / "cont")
    shutil.copytree(jax_model, model)
    assert train_mt.main(["--cont", "--device", "cpu", train["data"], train["ali_dir"],
                          train["spklist"], valid["data"], valid["ali_dir"], train["spklist"],
                          model]) == 0
    nnet = os.path.join(model, "nnet")
    assert os.path.exists(os.path.join(nnet, "model-4.pt"))
    with open(os.path.join(nnet, "valid_loss")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 1 and lines[0].split()[0] == "2"
    assert np.isfinite(float(lines[0].split()[1]))


def test_train_extract_loglike_chain(dirs, tmp_path):
    _, train, valid, cfg_path = dirs
    model = str(tmp_path / "exp")
    assert train_mt.main(["--config", cfg_path, "--device", "cpu", train["data"],
                          train["ali_dir"], train["spklist"], valid["data"], valid["ali_dir"],
                          valid["spklist"], model]) == 0
    nnet = os.path.join(model, "nnet")
    with open(os.path.join(nnet, "num_phones")) as f:
        assert int(f.read()) == NUM_PHONES
    with open(os.path.join(nnet, "valid_loss")) as f:
        assert len(f.read().splitlines()) == 2
    for name, n in (("speaker_egs", SPEAKERS), ("phone_egs", NUM_PHONES)):
        with open(os.path.join(model, name)) as f:
            counts = [int(line.split()[1]) for line in f]
        assert len(counts) == n and sum(counts) > 0
    xv = str(tmp_path / "xv")
    assert extract_mt.main(["--device", "cpu", "--min-chunk-size", "10", model,
                            "ark:" + os.path.join(train["data"], "feats.ark"),
                            "ark,scp:%s.ark,%s.scp" % (xv, xv)]) == 0
    embs = dict(read_vec_flt_ark(xv + ".ark"))
    assert len(embs) == 20 and all(v.shape == (32,) and np.isfinite(v).all()
                                   for v in embs.values())
    phn = str(tmp_path / "phn.ark")
    ark_in = "ark:" + os.path.join(valid["data"], "feats.ark")
    assert extract_mt_phone.main(["--device", "cpu", model, ark_in, "ark:" + phn]) == 0
    mats = dict(read_mat_ark(phn))
    assert len(mats) == 10 and all(m.shape[1] == NUM_PHONES for m in mats.values())
    prior_path = str(tmp_path / "prior.vec")
    with open(prior_path, "w") as f:
        f.write("[ " + " ".join(["%f" % (1.0 / NUM_PHONES)] * NUM_PHONES) + " ]\n")
    ll = str(tmp_path / "ll.ark")
    assert compute_loglike.main(["--device", "cpu", "--prior", prior_path, model, ark_in,
                                 "ark:" + ll]) == 0
    lls = dict(read_mat_ark(ll))
    for key, m in lls.items():
        lp = m + np.log(1.0 / NUM_PHONES)
        np.testing.assert_allclose(np.log(np.sum(np.exp(lp), axis=-1)), 0.0, atol=1e-4)
        np.testing.assert_allclose(lp, mats[key], rtol=1e-5, atol=1e-5)


def test_train_mt_lr_learning_matches_jax(dirs, tmp_path):
    """The sweep of the port's trainer against the JAX trainer's from the
    same variables, one bucket length (so the JAX step compiles once) and
    one step a rate: the same rates line for line, and the mean losses of
    the first 25 rates (up to 2.5e-4) within rtol 1e-5 (past them the
    rates grow and the two float32 runs drift apart step by step); then
    the port's CLI writes its sweep in the same format."""
    from test_torch_multitask import _pair

    _, train, _, _ = dirs
    cfg = dict(CFG, min_segment_len=64, max_segment_len=64)
    jt, t = _pair(cfg, tmp_path)
    data = (train["data"], train["ali_dir"], train["spklist"])
    lines = {}
    for name, trainer in (("jax", jt), ("port", t)):
        trainer.train_tune_lr(*data, tune_period=1)
        with open(os.path.join(os.path.dirname(trainer.model), "learning_rate_tuning")) as f:
            lines[name] = [line.split() for line in f]
    n = min(len(lines["jax"]), len(lines["port"]))
    assert n > 25
    for k, (got, want) in enumerate(zip(lines["port"][:n], lines["jax"][:n])):
        assert got[:2] == want[:2]
        if k < 25:
            np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    cfg_path = str(tmp_path / "lr.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    model = str(tmp_path / "cli")
    assert train_mt_lr_learning.main(["--device", "cpu", "--config", cfg_path, "--tune_period",
                                      "1", *data, model]) == 0
    with open(os.path.join(model, "learning_rate_tuning")) as f:
        cli = [line.split() for line in f]
    assert [c[:2] for c in cli[:n]] == [w[:2] for w in lines["jax"][:len(cli[:n])]]
    assert all(len(c) == 3 and len(c[2].split(".")[1]) == 6 for c in cli)


@pytest.mark.parametrize("main, args", [
    (train_mt.main, ["--config", "c.json", "t", "ta", "ts", "v", "va", "vs", "m"]),
    (extract_mt.main, ["m", "scp:f", "ark:o"]),
    (extract_mt_phone.main, ["m", "scp:f", "ark:o"]),
    (compute_loglike.main, ["--prior", "p", "m", "scp:f", "ark:o"]),
    (train_mt_lr_learning.main, ["--config", "c.json", "t", "ta", "ts", "m"]),
], ids=["train_mt", "extract_mt", "extract_mt_phone", "compute_loglike",
        "train_mt_lr_learning"])
def test_clis_default_to_the_card(main, args, monkeypatch, tmp_path):
    """Without a card each CLI raises at its default ``--device cuda``
    before any work (a missing input would raise otherwise)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "c.json").write_text(json.dumps(CFG))
    (tmp_path / "p").write_text("[ 0.5 0.5 ]\n")
    for name in ("config.json",):
        (tmp_path / "m" / "nnet").mkdir(parents=True, exist_ok=True)
        (tmp_path / "m" / "nnet" / name).write_text(json.dumps(CFG))
    for name in ("feature_dim", "num_speakers", "num_phones"):
        (tmp_path / "m" / "nnet" / name).write_text("2\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
