"""Fine-tuning, checkpoint selection and the LR sweep in the port against
the JAX package on the CPU: frozen variables (``noupdate_var_list``) from
one JAX checkpoint with momentum (clipped) and Adam, ``get_finetune_model``,
``cli.finetune`` from a port and from a JAX-written pretrain dir,
``select_checkpoint`` / ``cli.make_checkpoint``, and ``train_tune_lr`` with
``cli.train_lr_learning`` and ``cli.tune_lr``."""

import json
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_kaldi_speaker_tpu.cli import tune_lr as jax_tune_lr
from tf_kaldi_speaker_tpu.kio import native_decode
from tf_kaldi_speaker_tpu.parallel.mesh import make_mesh
from tf_kaldi_speaker_tpu.train import checkpoints as jckpt
from tf_kaldi_speaker_tpu.train.trainer import Trainer as JaxTrainer
from tf_kaldi_speaker_tpu.utils.params import ParamsPlain as JaxParams
from tf_kaldi_speaker_tpu_torch import convert
from tf_kaldi_speaker_tpu_torch.cli import finetune as cli_finetune
from tf_kaldi_speaker_tpu_torch.cli import make_checkpoint as cli_make_checkpoint
from tf_kaldi_speaker_tpu_torch.cli import train as cli_train
from tf_kaldi_speaker_tpu_torch.cli import train_lr_learning as cli_lr
from tf_kaldi_speaker_tpu_torch.cli import tune_lr as cli_tune_lr
from tf_kaldi_speaker_tpu_torch.train import checkpoints
from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
from tf_kaldi_speaker_tpu_torch.utils import bookkeeping as bk
from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain
from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

torch.set_num_threads(1)

DIM = 10
TINY = dict(
    seed=1, network_type="tdnn", tdnn_layer_size=16, num_nodes_pooling_layer=24,
    num_nodes_last_layer=12, pooling_type="statistics_pooling", embedding_node="tdnn6_dense",
    last_layer_linear=True, loss_func="additive_margin_softmax", amsoftmax_m=0.2,
    amsoftmax_lambda_min=0, amsoftmax_lambda_base=1000, amsoftmax_lambda_gamma=1e-4,
    amsoftmax_lambda_power=5, optimizer="momentum", momentum=0.9, weight_l2_regularizer=1e-2,
    batchnorm_momentum=0.99, use_fused_pooling=True, num_speakers_per_batch=4,
    num_segments_per_speaker=2, min_segment_len=40, max_segment_len=56, num_epochs=1,
    num_steps_per_epoch=4, steps_per_dispatch=2, num_parallel_datasets=1, max_queue_size=4,
    show_training_progress=2, valid_max_iterations=2, learning_rate=0.02)
NOUPDATE = ["tdnn/tdnn1", "tdnn/tdnn2_conv"]  # tdnn1's conv and BatchNorm, tdnn2's conv
NOLOAD = ["softmax/output_kernel", "tdnn/tdnn7"]


def _frozen(path, subs):
    return any(s in "/".join(path[1:]) for s in subs)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("ft")
    kw = dict(dim=DIM, min_len=60, max_len=150)
    return (make_fake_data_dir(str(root / "train"), num_speakers=6, utts_per_speaker=3,
                               seed=5, **kw),
            make_fake_data_dir(str(root / "valid"), num_speakers=6, utts_per_speaker=2,
                               seed=6, **kw))


# ---------------------------------------------------------------- freezing

@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_frozen_variables_match_jax(tmp_path, optimizer):
    """From one JAX checkpoint, three steps on identical batches on both
    sides with NOUPDATE frozen: frozen parameters and BatchNorm statistics
    bit-equal to the checkpoint on both sides, the frozen Adam moments zero,
    the rest within rtol 2e-4 (biases that a BatchNorm follows left out;
    atol 1e-6 with momentum, 1e-5 with Adam, which scales every
    coordinate's update to about lr, so a coordinate whose gradient is near
    zero carries its rounding noise at that scale: 8.8e-6 measured at lr
    0.05, hence lr 0.01 here; for the same reason the biases before each
    BatchNorm, whose gradient is zero in exact arithmetic, move by about lr
    on noise alone under Adam and shift the running means after them, which
    are left out under Adam). Momentum runs with global-norm clipping that
    triggers, so the norm must leave the frozen gradients out to agree."""
    if optimizer == "momentum":
        extra, lr, atol = dict(clip_gradient=True, clip_gradient_norm=0.5), 0.05, 1e-6
    else:
        extra, lr, atol = dict(optimizer="adam"), 0.01, 1e-5
    cfg = dict(TINY, **extra)
    nnet = str(tmp_path / "nnet")
    jt = JaxTrainer(JaxParams(**cfg), nnet, dim=DIM, num_speakers=6,
                    mesh=make_mesh(devices=jax.devices()[:1]))
    jt.build("train", DIM, cfg["loss_func"], 6, noupdate_var_list=NOUPDATE)
    jt.save(0)
    t = Trainer(ParamsPlain(**cfg), nnet, dim=DIM, num_speakers=6, device="cpu")
    t.build("train", DIM, cfg["loss_func"], 6, noupdate_var_list=NOUPDATE)
    t.build("valid")  # does not reset the frozen set
    assert t.load() == 0
    start = convert.flatten(convert.variables_of(t.network_model))
    rng = np.random.RandomState(2)
    state = jt.state
    for _ in range(3):
        feats = rng.randn(8, 48, DIM).astype(np.float32)
        labels = rng.randint(0, 6, 8).astype(np.int32)
        state, jm = jt._train_step(state, *jt._shard_batch(feats, labels), jnp.float32(lr))
        m = t.train_step(torch.from_numpy(feats), torch.from_numpy(labels), lr)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-4)
    want = convert.flatten({"params": jax.device_get(state.params),
                            "batch_stats": jax.device_get(state.batch_stats)})
    got = convert.flatten(convert.variables_of(t.network_model))
    n_frozen = 0
    for path, w in want.items():
        if _frozen(path, NOUPDATE):
            n_frozen += 1
            np.testing.assert_array_equal(np.asarray(w), start[path].numpy())
            np.testing.assert_array_equal(got[path].numpy(), start[path].numpy())
        elif not (path[-1] == "bias" and path[-2].endswith(("_conv", "_dense"))
                  or optimizer == "adam" and path[-1] == "mean"):
            assert not np.array_equal(got[path].numpy(), start[path].numpy()), path
            np.testing.assert_allclose(got[path].numpy(), np.asarray(w), rtol=2e-4, atol=atol,
                                       err_msg="/".join(path))
    assert n_frozen == 8  # tdnn1_conv (2), tdnn1_bn (4), tdnn2_conv (2)
    if optimizer == "adam":
        adam = [s for s in jax.tree_util.tree_leaves(
            state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]
        opt = t.state_tree()["opt_state"]
        for key in ("mu", "nu"):
            for path, v in convert.flatten(opt[key]).items():
                jv = np.asarray(convert.flatten(jax.device_get(getattr(adam, key)))[path])
                if _frozen(("params",) + path, NOUPDATE):
                    assert not v.any() and not jv.any(), path
                else:
                    assert v.any(), path


# ---------------------------------------------------------------- get_finetune_model

def test_get_finetune_model(tmp_path):
    """Kept variables bit-equal to the pretrain checkpoint, NOLOAD ones
    re-initialized (so changed), the step back at 0, a fresh optimizer
    state, and model-0 written."""
    pre = str(tmp_path / "pre" / "nnet")
    t = Trainer(ParamsPlain(**TINY), pre, dim=DIM, num_speakers=6, device="cpu")
    t.build("train")
    rng = np.random.RandomState(3)
    for _ in range(2):
        t.train_step(torch.from_numpy(rng.randn(8, 48, DIM).astype(np.float32)),
                     torch.from_numpy(rng.randint(0, 6, 8)), 0.05)
    t.save(2)
    ft = str(tmp_path / "ft" / "nnet")
    bk.get_pretrain_model(pre, ft)
    assert os.path.exists(os.path.join(ft, "model-0.pt"))
    u = Trainer(ParamsPlain(**TINY), ft, dim=DIM, num_speakers=6, device="cpu")
    u.build("train")
    u.get_finetune_model(NOLOAD)
    assert u.step == 0 and checkpoints.read_pointer(ft) == 0
    raw, step = checkpoints.load_checkpoint(ft)
    assert step == 0 and raw["step"] == 0
    before = convert.flatten(checkpoints.load_checkpoint(pre)[0])
    after = convert.flatten(convert.variables_of(u.network_model))
    reinit = [p for p in after if _frozen(p, NOLOAD)]
    assert len(reinit) == 7  # output_kernel, tdnn7_dense (2), tdnn7_bn (4)
    for path, v in after.items():
        if path in reinit:
            assert not torch.equal(v, before[path]), path
        else:
            assert torch.equal(v, before[path]), path
    assert not any(t.any() for t in u.optimizer.trace)


# ---------------------------------------------------------------- cli.finetune

def _write(path, cfg):
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cli_finetune(corpus, tmp_path, caplog, writer):
    """cli.finetune --device cpu from a pretrain dir trained by the port's
    cli.train (model-<step>.pt) or written by the JAX Trainer
    (model-<step>.msgpack): the evaluation before training is logged, one
    epoch runs, frozen variables are bit-equal to the pretrain checkpoint's
    and the re-initialized output kernel differs from it."""
    train, valid = corpus
    args = [train["data"], train["spklist"], valid["data"], valid["spklist"]]
    pre = str(tmp_path / "pre")
    if writer == "port":
        assert cli_train.main(["--config", _write(tmp_path / "pre.json", TINY),
                               "--device", "cpu"] + args + [pre]) == 0
    else:
        jt = JaxTrainer(JaxParams(**TINY), os.path.join(pre, "nnet"), dim=DIM,
                        num_speakers=6, mesh=make_mesh(devices=jax.devices()[:1]))
        jt.build("train", DIM, TINY["loss_func"], 6)
        jt.save(4)
    cfg = dict(TINY, learning_rate=0.01, noload_var_list=["softmax/output_kernel"],
               noupdate_var_list="tdnn/tdnn1_conv,tdnn/tdnn2_conv")
    ft = str(tmp_path / "ft")
    with caplog.at_level(logging.INFO):
        assert cli_finetune.main(["--config", _write(tmp_path / "ft.json", cfg), "--device",
                                  "cpu", "--pretrain_model", pre] + args + [ft]) == 0
    assert any("BEFORE training: valid loss" in r.getMessage() for r in caplog.records)
    nnet = os.path.join(ft, "nnet")
    assert checkpoints.read_pointer(nnet) == 4
    assert len(bk.load_valid_loss(os.path.join(nnet, "valid_loss"))) == 1
    pre_raw = convert.flatten(checkpoints.load_checkpoint(os.path.join(pre, "nnet"))[0])
    ft_raw = convert.flatten(checkpoints.load_checkpoint(nnet)[0])
    for layer in ("tdnn1_conv", "tdnn2_conv"):
        for leaf in ("kernel", "bias"):
            path = ("params", "network", "tdnn", layer, leaf)
            np.testing.assert_array_equal(np.asarray(ft_raw[path]), np.asarray(pre_raw[path]))
    out = ("params", "softmax", "output_kernel")
    assert not np.allclose(np.asarray(ft_raw[out]), np.asarray(pre_raw[out]))
    moved = ("params", "network", "tdnn", "tdnn6_dense", "kernel")
    assert not np.allclose(np.asarray(ft_raw[moved]), np.asarray(pre_raw[moved]))


# ---------------------------------------------------------------- select_checkpoint

@pytest.mark.parametrize("which", ["last", "-1", "8"])
def test_select_checkpoint_matches_jax(tmp_path, which):
    """The same step and the same pointer file as the JAX function on one
    model dir (best by valid_loss: epoch 2 of 4 steps = step 8)."""
    dirs = []
    for side in ("jax", "port"):
        nnet = tmp_path / side / "nnet"
        nnet.mkdir(parents=True)
        for step in (4, 8, 12):
            (nnet / ("model-%d.msgpack" % step)).write_bytes(b"")
        _write(nnet / "config.json", {"num_steps_per_epoch": 4})
        (tmp_path / side / "valid_loss").write_text("1 2.5 0.3\n2 2.25 0.2\n3 2.4 0.25\n")
        dirs.append(str(nnet))
    want = jckpt.select_checkpoint(dirs[0], which)
    if which == "8":
        assert cli_make_checkpoint.main(["--checkpoint", which, os.path.dirname(dirs[1])]) == 0
        got = checkpoints.read_pointer(dirs[1])
    else:
        got = checkpoints.select_checkpoint(dirs[1], which)
    assert got == want == {"last": 12, "-1": 8, "8": 8}[which]
    with open(os.path.join(dirs[0], "checkpoint")) as a, \
            open(os.path.join(dirs[1], "checkpoint")) as b:
        assert a.read() == b.read()
    assert checkpoints.select_checkpoint(dirs[1], "4", write=False) == 4
    assert checkpoints.read_pointer(dirs[1]) == want


# ---------------------------------------------------------------- LR sweep

def test_train_tune_lr_matches_jax(corpus, tmp_path, monkeypatch, capsys):
    """train_tune_lr with one loader worker and tune_period 1, from the JAX
    Trainer's initial variables: the k and lr columns equal to JAX's, the
    first 10 losses within rtol 2e-4; then cli.tune_lr reads the file. One
    chunk length, so that the JAX step compiles once for the 100 sweeps."""
    monkeypatch.setattr(native_decode, "_get_lib", lambda: None)
    train = corpus[0]
    cfg = dict(TINY, use_fused_pooling=False, min_segment_len=48, max_segment_len=48)
    jt = JaxTrainer(JaxParams(**cfg), str(tmp_path / "jax" / "nnet"), dim=DIM, num_speakers=6,
                    mesh=make_mesh(devices=jax.devices()[:1]))
    jt.build("train", DIM, cfg["loss_func"], 6)
    t = Trainer(ParamsPlain(**cfg), str(tmp_path / "port" / "nnet"), dim=DIM, num_speakers=6,
                device="cpu")
    t.build("train")
    convert.load_variables(t.network_model, {
        "params": jax.device_get(jt.state.params),
        "batch_stats": jax.device_get(jt.state.batch_stats)})
    jt.train_tune_lr(train["data"], train["spklist"], tune_period=1)
    t.train_tune_lr(train["data"], train["spklist"], tune_period=1)
    want = np.loadtxt(str(tmp_path / "jax" / "learning_rate_tuning"), ndmin=2)
    got = np.loadtxt(str(tmp_path / "port" / "learning_rate_tuning"), ndmin=2)
    assert got.shape == want.shape and got.shape[0] >= 10
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:10, 2], want[:10, 2], rtol=2e-4)
    assert cli_tune_lr.main([str(tmp_path / "port")]) == 0
    assert "steepest-descent lr" in capsys.readouterr().out


def test_cli_train_lr_learning(corpus, tmp_path):
    """cli.train_lr_learning --device cpu from a pretrain dir: finite sweep
    lines "k lr loss" from k = 0, lr = 1e-5 * 1.15^k (as written, to 8
    decimals)."""
    train = corpus[0]
    pre = str(tmp_path / "pre" / "nnet")
    t = Trainer(ParamsPlain(**TINY), pre, dim=DIM, num_speakers=6, device="cpu")
    t.build("train")
    t.save(3)
    model = str(tmp_path / "sweep")
    assert cli_lr.main(["--config", _write(tmp_path / "c.json", TINY), "--tune_period", "1",
                        "--device", "cpu", "--pretrain_model", str(tmp_path / "pre"),
                        train["data"], train["spklist"], model]) == 0
    rows = np.loadtxt(os.path.join(model, "learning_rate_tuning"), ndmin=2)
    assert rows.shape[1] == 3 and rows.shape[0] >= 3
    np.testing.assert_array_equal(rows[:, 0], np.arange(len(rows)))
    np.testing.assert_allclose(rows[:, 1], 1e-5 * 1.15 ** rows[:, 0], rtol=0, atol=5e-9)
    assert np.isfinite(rows[:-1, 2]).all()
    shutil.rmtree(model)


def _sweep(losses):
    k = np.arange(len(losses))
    return np.stack([k, 1e-5 * 1.15 ** k, losses], axis=1)


TUNE_LR_FILES = {
    # falls, flattens, then passes 1.5x the running minimum
    "swept": _sweep([5.2, 5.1, 4.9, 4.4, 3.6, 3.1, 2.9, 2.95, 3.3, 4.6, 9.8, 40.0]),
    "nonfinite_tail": _sweep([4.0, 3.8, 3.1, 2.7, 2.6, 3.5, np.inf, np.nan]),
    "never_diverges": _sweep([6.0, 5.5, 5.4, 4.1, 3.9, 3.85, 3.84]),
    "too_few_finite": _sweep([4.0, 3.0, np.nan, np.inf]),
}


@pytest.mark.parametrize("case", sorted(TUNE_LR_FILES))
def test_cli_tune_lr_matches_jax(tmp_path, capsys, case):
    """cli.tune_lr prints what the JAX package's prints, on the same
    learning_rate_tuning file, and returns the same code: the steepest slope,
    the divergence point at 1.5x the running minimum, the fallback to the
    last point when nothing diverges, and the refusal of fewer than 3 finite
    points. The swept case is passed as the model dir, the others as files."""
    np.savetxt(str(tmp_path / "learning_rate_tuning"), TUNE_LR_FILES[case], fmt="%.8g")
    arg = str(tmp_path if case == "swept" else tmp_path / "learning_rate_tuning")
    outs = []
    for main in (jax_tune_lr.main, cli_tune_lr.main):
        rc = main([arg])
        outs.append((rc,) + tuple(capsys.readouterr()))
    assert outs[0] == outs[1]
    assert outs[0][0] == (1 if case == "too_few_finite" else 0)
