"""The 512-wide head-to-head convergence matrix, the framework arm,
through the port.

A copy of the framework arm of ``scripts/reference_convergence.py``: the
reference's fixed 512-wide TDNN trained on the convergence corpus
(:func:`.corpora.make_data`: 200 speakers, dim 12, channel offsets) with
the same JSON config, 3 epochs x LR [0.04, 0.02, 0.01] of 400 steps at
batch 24 x 100-200 frames, over seven loss and pooling families (softmax,
am-softmax, a-softmax m=4 and m=1, arc-softmax, attention pooling +
am-softmax, and the multitask speaker + phone trainer); the valid loss
after each epoch and the final cosine EER on 40 held-out speakers.

The TF1 reference arm (``--arm ref``: the unmodified reference trainer
under ``scripts/tf1_ref_shim.py``) is not ported: it needs TensorFlow and
the reference's sources, which the card's machine does not have. The port
is judged instead against the JAX package's rows on the record
(:data:`JAX_ROWS`, ``docs/VALIDATION.md:316-381``): each family's port mean
must lie inside the JAX f32 arm's mean ± 3 max(sd, 0.5%). Printed beside,
not gated: each port seed against that band and the exact rank test of
the port's seeds against JAX's.

``--program flagship`` is am-softmax with bf16 activations, the device
pool and the fused pooling kernels (the dequant, the pooling forward and
its backward all launch); it and ``--compute-dtype bfloat16`` are judged,
as JAX's bf16 rows were, against JAX's am-softmax f32 band.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.validation.convergence make-data --root DIR
    python -m tf_kaldi_speaker_tpu_torch.validation.convergence make-data-mt --root DIR
    python -m tf_kaldi_speaker_tpu_torch.validation.convergence run --arm torch \\
        --loss amsoftmax --seed 1 [--compute-dtype bfloat16 | --program flagship] \\
        [--device cuda] [--deterministic] --root DIR
    python -m tf_kaldi_speaker_tpu_torch.validation.convergence report --root DIR [--write-doc]

``run`` writes ``DIR/results/torch_<loss>_s<seed>[_<dtype>|_flagship][_det].json``;
``report`` reads them and exits 1 when a family is outside
its band.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import convert
from ..cli._frontend import device_or_raise
from ..extract.extractor import Extractor
from ..multitask import TrainerMultiTask
from ..train import checkpoints
from ..train.trainer import Trainer
from ..utils.params import ParamsPlain
from . import corpora
from .common import _exact_rank_p, _test_eer, append_doc, card_name, judge, \
    write_nnet_files

EPOCH_LRS = [0.04, 0.02, 0.01]   # recipe-style halving, one value per epoch

# scripts/reference_convergence.py:57-94
BASE_CFG = dict(
    seed=0,
    network_type="tdnn",
    pooling_type="statistics_pooling",
    embedding_node="tdnn6_dense",
    last_layer_linear=False,
    batch_type="softmax",
    learning_rate=EPOCH_LRS[0],
    optimizer="momentum",
    momentum=0.9,
    use_nesterov=False,
    clip_gradient=True,
    clip_gradient_norm=3.0,
    weight_l2_regularizer=1e-4,
    batchnorm_momentum=0.99,
    num_epochs=len(EPOCH_LRS),
    num_steps_per_epoch=400,
    reduce_lr_epochs=100,
    show_training_progress=100,
    keep_checkpoint_max=2,
    save_summary_steps=100000,
    save_checkpoints_steps=100000,
    valid_max_iterations=20,
    num_parallel_datasets=1,
    max_queue_size=6,
    num_speakers_per_batch=24,
    num_segments_per_speaker=1,
    min_segment_len=100,
    max_segment_len=200,
    num_valid_speakers_per_batch=24,
    num_valid_segments_per_speaker=1,
    early_stop_epochs=100,
    min_learning_rate=1e-6,
)

# scripts/reference_convergence.py:96-168
LOSSES = {
    "softmax": dict(loss_func="softmax", last_layer_linear=False),
    "amsoftmax": dict(
        loss_func="additive_margin_softmax",
        last_layer_linear=True,
        amsoftmax_m=0.2,
        amsoftmax_lambda_min=0,
        amsoftmax_lambda_base=1000,
        amsoftmax_lambda_gamma=0.01,
        amsoftmax_lambda_power=4,
    ),
    "asoftmax_m4": dict(
        loss_func="asoftmax",
        last_layer_linear=True,
        asoftmax_m=4,
        asoftmax_lambda_min=10,
        asoftmax_lambda_base=1000,
        asoftmax_lambda_gamma=0.01,
        asoftmax_lambda_power=4,
    ),
    "asoftmax_m1": dict(
        loss_func="asoftmax",
        last_layer_linear=True,
        asoftmax_m=1,
        asoftmax_lambda_min=10,
        asoftmax_lambda_base=1000,
        asoftmax_lambda_gamma=0.01,
        asoftmax_lambda_power=4,
    ),
    "arcsoftmax_m0.25": dict(
        loss_func="additive_angular_margin_softmax",
        last_layer_linear=True,
        arcsoftmax_m=0.25,
        arcsoftmax_lambda_min=0,
        arcsoftmax_lambda_base=1000,
        arcsoftmax_lambda_gamma=0.01,
        arcsoftmax_lambda_power=4,
    ),
    "att_amsoftmax": dict(
        loss_func="additive_margin_softmax",
        last_layer_linear=True,
        amsoftmax_m=0.2,
        amsoftmax_lambda_min=0,
        amsoftmax_lambda_base=1000,
        amsoftmax_lambda_gamma=0.01,
        amsoftmax_lambda_power=4,
        pooling_type="self_attention",
        att_key_input="tdnn4_relu",
        att_key_num_nodes=[1500, 1500],
        att_key_network_type=3,
        att_value_input="tdnn5_relu",
        att_value_num_nodes=[],
        att_value_network_type=0,
        att_apply_nonlinear=False,
        att_use_scale=True,
        att_num_heads=1,
        att_split_key=False,
        att_penalty_term=0,
    ),
}

# scripts/reference_convergence.py:178-224
MT_CFG = dict(
    seed=0,
    spk_loss_type="softmax",
    phn_loss_type="softmax",
    spk_loss_weight=1.0,
    phn_loss_weight=0.3,
    embedding_node="zs_mu_dense",
    pooling_type="statistics_pooling",
    num_nodes_pooling_layer=512,
    num_shared_layers=2,
    phone_kernel_size=[5, 5, 7, 1, 3],
    phone_layer_size=[512, 512, 128, 128, 128],
    phone_dilation_size=[1, 1, 1, 1, 4],
    phone_left_context=11,
    phone_right_context=11,
    speaker_left_context=7,
    speaker_right_context=7,
    speaker_dim=512,
    phone_dim=128,
    num_frames_per_utt=8,
    learning_rate=EPOCH_LRS[0],
    optimizer="momentum",
    momentum=0.9,
    use_nesterov=False,
    clip_gradient=True,
    clip_gradient_norm=3.0,
    weight_l2_regularizer=1e-4,
    batchnorm_momentum=0.99,
    num_epochs=len(EPOCH_LRS),
    num_steps_per_epoch=400,
    show_training_progress=100,
    keep_checkpoint_max=2,
    save_summary_steps=100000,
    save_checkpoints_steps=100000,
    valid_max_iterations=20,
    num_parallel_datasets=1,
    max_queue_size=6,
    num_speakers_per_batch=24,
    num_segments_per_speaker=1,
    min_segment_len=100,
    max_segment_len=200,
)

MT_LOSS = "mt_softmax"
FAMILIES = list(LOSSES) + [MT_LOSS]
# the flagship program: what bench and the chip smoke run
FLAGSHIP = dict(compute_dtype="bfloat16", device_pool=True, use_fused_pooling=True)

# The JAX package's rows on the record, docs/VALIDATION.md:316-381:
# (arm, loss, seed or None, valid loss by epoch, final EER). "tpu" is the
# JAX framework arm in float32, "tpu-bf16" in bfloat16, "ref" the TF1
# reference trainer (os.urandom loader seeds).
JAX_ROWS = [
    ("ref", "softmax", None, (5.055, 2.832, 2.610), 0.1741),
    ("tpu", "softmax", 1, (5.275, 2.829, 2.601), 0.1742),
    ("tpu", "softmax", 2, (4.330, 2.747, 2.583), 0.1750),
    ("tpu", "softmax", 3, (5.050, 2.813, 2.725), 0.1829),
    ("ref", "amsoftmax", None, (5.736, 2.794, 2.696), 0.1839),
    ("tpu", "amsoftmax", 1, (6.819, 3.042, 2.693), 0.1789),
    ("tpu-bf16", "amsoftmax", 1, (6.586, 3.056, 2.651), 0.1787),
    ("tpu", "amsoftmax", 2, (7.037, 2.779, 2.558), 0.1808),
    ("tpu-bf16", "amsoftmax", 2, (7.193, 2.775, 2.494), 0.1805),
    ("tpu", "amsoftmax", 3, (6.847, 2.698, 2.684), 0.1849),
    ("tpu-bf16", "amsoftmax", 3, (7.230, 2.746, 2.677), 0.1800),
    ("ref", "asoftmax_m4", None, (8.650, 2.625, 2.435), 0.1847),
    ("ref", "asoftmax_m4", None, (7.167, 2.537, 2.448), 0.1794),
    ("ref", "asoftmax_m4", None, (9.115, 2.544, 2.359), 0.1822),
    ("tpu", "asoftmax_m4", 1, (7.431, 2.761, 2.503), 0.1893),
    ("tpu", "asoftmax_m4", 2, (7.921, 2.509, 2.402), 0.1889),
    ("tpu", "asoftmax_m4", 3, (7.651, 2.489, 2.498), 0.1929),
    ("tpu", "asoftmax_m4", 4, (6.446, 2.480, 2.415), 0.1861),
    ("tpu", "asoftmax_m4", 5, (7.593, 2.709, 2.422), 0.1961),
    ("ref", "asoftmax_m1", None, (5.197, 2.953, 2.674), 0.1740),
    ("ref", "asoftmax_m1", None, (6.492, 2.840, 2.725), 0.1811),
    ("tpu", "asoftmax_m1", 1, (5.851, 3.021, 2.818), 0.1739),
    ("tpu", "asoftmax_m1", 2, (5.564, 2.825, 2.604), 0.1768),
    ("tpu", "asoftmax_m1", 3, (5.746, 2.745, 2.770), 0.1814),
    ("ref", "arcsoftmax_m0.25", None, (6.118, 2.838, 2.654), 0.1810),
    ("ref", "arcsoftmax_m0.25", None, (6.272, 2.862, 2.662), 0.1806),
    ("ref", "arcsoftmax_m0.25", None, (6.339, 2.909, 2.490), 0.1861),
    ("tpu", "arcsoftmax_m0.25", 1, (7.648, 2.961, 2.614), 0.1828),
    ("tpu", "arcsoftmax_m0.25", 2, (6.830, 2.772, 2.535), 0.1822),
    ("tpu", "arcsoftmax_m0.25", 3, (7.014, 2.735, 2.589), 0.1872),
    ("ref", "att_amsoftmax", None, (6.149, 2.866, 2.654), 0.1904),
    ("ref", "att_amsoftmax", None, (5.750, 2.805, 2.685), 0.1867),
    ("ref", "att_amsoftmax", None, (6.399, 2.693, 2.591), 0.1897),
    ("tpu", "att_amsoftmax", 1, (6.659, 3.050, 2.682), 0.1844),
    ("tpu", "att_amsoftmax", 2, (6.741, 2.818, 2.542), 0.1806),
    ("tpu", "att_amsoftmax", 3, (6.552, 2.851, 2.727), 0.1790),
    ("ref", "mt_softmax", None, (5.584, 3.703, 3.354), 0.1703),
    ("ref", "mt_softmax", None, (6.320, 3.724, 3.512), 0.1827),
    ("ref", "mt_softmax", None, (6.153, 3.717, 3.434), 0.1866),
    ("tpu", "mt_softmax", 1, (5.390, 3.668, 3.557), 0.1789),
    ("tpu", "mt_softmax", 2, (5.883, 3.698, 3.454), 0.1738),
    ("tpu", "mt_softmax", 3, (5.567, 3.601, 3.499), 0.1786),
]


def jax_eers(loss: str, arm: str = "tpu") -> List[float]:
    return [r[4] for r in JAX_ROWS if r[0] == arm and r[1] == loss]


def jax_final_valid_losses(loss: str, arm: str = "tpu") -> List[float]:
    return [r[3][-1] for r in JAX_ROWS if r[0] == arm and r[1] == loss]


def _paths(root: str):
    return (os.path.join(root, "train"), os.path.join(root, "valid"),
            os.path.join(root, "test"), os.path.join(root, "train", "spklist"))


def _mt_paths(root: str):
    train = os.path.join(root, "mt_train")
    return (train, os.path.join(root, "mt_valid"), os.path.join(root, "mt_test"),
            os.path.join(train, "spklist"), os.path.join(train, "ali"))


def arm_config(loss: str, seed: int, steps_per_epoch: int, compute_dtype: str = "",
               program: str = "") -> Dict:
    """One run's config: BASE_CFG (or MT_CFG) with the family's keys, the
    seed, the steps, and the dtype or program."""
    if loss == MT_LOSS:
        cfg = dict(MT_CFG, num_steps_per_epoch=steps_per_epoch, seed=seed)
    else:
        cfg = dict(BASE_CFG, num_steps_per_epoch=steps_per_epoch, seed=seed, **LOSSES[loss])
    if program == "flagship":
        cfg.update(FLAGSHIP)
    elif compute_dtype:
        cfg["compute_dtype"] = compute_dtype
    return cfg


def arm_tag(compute_dtype: str = "", program: str = "", deterministic: bool = False) -> str:
    """The suffix of a run's exp dir and result file."""
    tag = "_" + program if program else ("_" + compute_dtype if compute_dtype else "")
    return tag + ("_det" if deterministic else "")


def run_torch(root: str, loss: str, seed: int, steps_per_epoch: int, out: str,
              compute_dtype: str = "", program: str = "", device="cuda",
              init_variables: Optional[Dict] = None, deterministic: bool = False) -> Dict:
    """The framework arm (``run_tpu``, ``reference_convergence.py:491-535``):
    train, validate after each epoch, extract the held-out speakers one
    utterance at a time and score them. ``init_variables`` (JAX layout)
    replaces the seed's initial weights (the CPU tests start the port
    from the JAX trainer's). Writes and returns the result."""
    if loss == MT_LOSS:
        return run_torch_mt(root, seed, steps_per_epoch, out, compute_dtype, device,
                            init_variables, deterministic)
    train_dir, valid_dir, test_dir, spklist = _paths(root)
    cfg = arm_config(loss, seed, steps_per_epoch, compute_dtype, program)
    tag = arm_tag(compute_dtype, program, deterministic)
    exp = os.path.join(root, "exp_torch_%s_s%d%s" % (loss, seed, tag))
    nnet = os.path.join(exp, "nnet")
    write_nnet_files(nnet, cfg, corpora.DIM)

    torch.use_deterministic_algorithms(deterministic)
    trainer = Trainer(ParamsPlain(**cfg), nnet, dim=corpora.DIM,
                      num_speakers=corpora.NSPK, device=device)
    trainer.build("train", corpora.DIM, cfg["loss_func"], corpora.NSPK)
    trainer.build("valid", corpora.DIM, cfg["loss_func"], corpora.NSPK)
    if init_variables is not None:
        convert.load_variables(trainer.network_model, init_variables)

    valid_losses, t0 = [], time.time()
    try:
        for epoch, lr in enumerate(EPOCH_LRS):
            trainer.train(train_dir, spklist, lr)
            loss_v, _, _ = trainer.valid(valid_dir, spklist)
            valid_losses.append(float(loss_v))
            print("[torch %s s%d%s] epoch %d lr %g valid loss %.4f (%.0fs)"
                  % (loss, seed, tag, epoch, lr, loss_v, time.time() - t0), flush=True)
    finally:
        trainer.close()
    wall = time.time() - t0

    ex = Extractor(exp, min_chunk_size=25, batch_size=32, device=device)
    eer = _test_eer(lambda feats: ex.embed_utterance(feats), test_dir)
    return _write_result(out, dict(
        arm="torch", loss=loss, seed=seed, dtype=cfg.get("compute_dtype", "float32"),
        program=program, deterministic=deterministic, steps_per_epoch=steps_per_epoch,
        valid_loss=valid_losses, eer=float(eer), wall_s=round(wall, 1),
        card=card_name(torch.device(device))))


def run_torch_mt(root: str, seed: int, steps_per_epoch: int, out: str,
                 compute_dtype: str = "", device="cuda",
                 init_variables: Optional[Dict] = None, deterministic: bool = False) -> Dict:
    """The multitask framework arm (``run_tpu_mt``,
    ``reference_convergence.py:370-418``); the valid loss is
    ``spk_loss_weight`` x speaker + ``phn_loss_weight`` x phone."""
    train_dir, valid_dir, test_dir, spklist, ali_dir = _mt_paths(root)
    cfg = arm_config(MT_LOSS, seed, steps_per_epoch, compute_dtype)
    tag = arm_tag(compute_dtype, deterministic=deterministic)
    exp = os.path.join(root, "exp_torch_mt_softmax_s%d%s" % (seed, tag))
    nnet = os.path.join(exp, "nnet")
    write_nnet_files(nnet, cfg, corpora.DIM)

    torch.use_deterministic_algorithms(deterministic)
    trainer = TrainerMultiTask(ParamsPlain(**cfg), nnet, dim=corpora.DIM,
                               num_speakers=corpora.NSPK, num_phones=corpora.MT_NUM_PHONES,
                               device=device)
    trainer.build("train", corpora.DIM, num_speakers=corpora.NSPK,
                  num_phones=corpora.MT_NUM_PHONES)
    trainer.build("valid", corpora.DIM)
    if init_variables is not None:
        convert.load_variables(trainer.network_model, init_variables)

    valid_losses, t0 = [], time.time()
    for epoch, lr in enumerate(EPOCH_LRS):
        trainer.train(train_dir, ali_dir, spklist, lr)
        spk_v, phn_v, _, _ = trainer.valid(valid_dir, ali_dir, spklist)
        loss_v = cfg["spk_loss_weight"] * spk_v + cfg["phn_loss_weight"] * phn_v
        valid_losses.append(float(loss_v))
        print("[torch mt s%d] epoch %d lr %g valid loss %.4f (spk %.4f phn %.4f) (%.0fs)"
              % (seed, epoch, lr, loss_v, spk_v, phn_v, time.time() - t0), flush=True)
    wall = time.time() - t0

    trainer.build("predict", corpora.DIM)
    eer = _test_eer(lambda feats: trainer.predict_speaker(feats), test_dir)
    return _write_result(out, dict(
        arm="torch", loss=MT_LOSS, seed=seed, dtype=compute_dtype or "float32", program="",
        deterministic=deterministic, steps_per_epoch=steps_per_epoch,
        valid_loss=valid_losses, eer=float(eer), wall_s=round(wall, 1),
        card=card_name(torch.device(device))))


def _write_result(out: str, result: Dict) -> Dict:
    print("[torch %s s%d %s%s] final EER %.2f%%" % (
        result["loss"], result["seed"], result["dtype"],
        " " + result["program"] if result["program"] else "", result["eer"] * 100), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return result


def run_control(root: str, loss: str, seed: int, program: str = "", device="cuda",
                epochs: int = 0) -> Dict[str, float]:
    """A control that a trained run's bounds must exclude: the network of
    the arm as initialized (``epochs=0``), or after ``epochs`` epochs on
    the training corpus with its speaker labels shuffled over the
    utterances (:func:`.corpora.shuffle_labels`). Returns its valid loss
    (on the true labels) and held-out EER."""
    train_dir, valid_dir, test_dir, spklist = _paths(root)
    cfg = arm_config(loss, seed, BASE_CFG["num_steps_per_epoch"], program=program)
    exp = os.path.join(root, "exp_torch_control%d_%s_s%d%s" % (epochs, loss, seed, arm_tag(
        program=program)))
    nnet = os.path.join(exp, "nnet")
    write_nnet_files(nnet, cfg, corpora.DIM)
    trainer = Trainer(ParamsPlain(**cfg), nnet, dim=corpora.DIM, num_speakers=corpora.NSPK,
                      device=device)
    trainer.build("train", corpora.DIM, cfg["loss_func"], corpora.NSPK)
    try:
        if epochs:
            shuffled = corpora.shuffle_labels(train_dir, os.path.join(root, "train_shuffled"))
            for lr in EPOCH_LRS[:epochs]:
                trainer.train(shuffled["data"], shuffled["spklist"], lr)
        else:
            checkpoints.save_checkpoint(nnet, trainer.state_tree(), 0)
        trainer.build("valid", corpora.DIM, cfg["loss_func"], corpora.NSPK)
        valid_loss = float(trainer.valid(valid_dir, spklist)[0])
    finally:
        trainer.close()
    ex = Extractor(exp, min_chunk_size=25, batch_size=32, device=device)
    return dict(valid_loss=valid_loss,
                eer=_test_eer(lambda feats: ex.embed_utterance(feats), test_dir))


def _group_rows(results: List[Dict], loss: str):
    """The port's f32, bf16 and flagship rows of one family."""
    rows = [r for r in results if r["loss"] == loss and not r.get("deterministic")]
    f32 = [r for r in rows if r["dtype"] == "float32" and not r.get("program")]
    bf16 = [r for r in rows if r["dtype"] == "bfloat16" and not r.get("program")]
    flagship = [r for r in rows if r.get("program") == "flagship"]
    return f32, bf16, flagship


def report(root: str, write_doc: bool) -> int:
    """The port's rows beside the JAX record; 0 when every family and
    program with port results has at least 3 seeds and its mean inside the
    JAX f32 band of its family (bf16 and flagship: am-softmax's)."""
    results = [json.load(open(p)) for p in sorted(glob.glob(
        os.path.join(root, "results", "torch_*.json")))]
    cards = sorted({r.get("card", "") for r in results})
    lines = [
        "",
        "## Head-to-head convergence through the port (512-wide TDNN)",
        "",
        "`python -m tf_kaldi_speaker_tpu_torch.validation.convergence` — the port trains",
        "the fixed 512-wide TDNN on the synthetic corpus (%d spks, dim %d, chan %.1f) with"
        % (corpora.NSPK, corpora.DIM, corpora.CHAN),
        "the JAX harness's JSON config, %d epochs x LR %s, batch %d x %d-%d frames." % (
            len(EPOCH_LRS), EPOCH_LRS, BASE_CFG["num_speakers_per_batch"],
            BASE_CFG["min_segment_len"], BASE_CFG["max_segment_len"]),
        "Valid loss per epoch; final cosine EER on 40 held-out speakers. Each family's",
        "port mean is judged against the JAX f32 arm on the record (`docs/VALIDATION.md`",
        "316-381), band 3·max(sd, 0.5%); bf16 and the flagship program against",
        "am-softmax's. Card: %s." % "; ".join(cards),
        "",
        "| Arm | Loss | Seed | Valid loss by epoch | Final EER | Wall s |",
        "|---|---|---|---|---|---|",
    ]
    ok = True
    for loss in FAMILIES:
        f32, bf16, flagship = _group_rows(results, loss)
        if not (f32 or bf16 or flagship):
            continue
        for r in sorted(f32 + bf16 + flagship, key=lambda r: (r["seed"], r["dtype"],
                                                             r.get("program", ""))):
            arm = "torch-" + r["program"] if r.get("program") else (
                "torch-bf16" if r["dtype"] == "bfloat16" else "torch")
            lines.append("| %s | %s | %s | %s | %.2f%% | %.1f |" % (
                arm, loss, r["seed"], " ".join("%.3f" % v for v in r["valid_loss"]),
                r["eer"] * 100, r["wall_s"]))
        for label, group, against in (("f32", f32, loss), ("bf16", bf16, "amsoftmax"),
                                      ("flagship", flagship, "amsoftmax")):
            if not group:
                continue
            ref = jax_eers(against)
            eers = [r["eer"] for r in group]
            if len(group) < 3:
                ok = False
                lines.append("| check | %s | %s | only %d seeds (<3): no mean judged | | "
                             "FAIL |" % (loss, label, len(group)))
                continue
            j = judge(eers, ref)
            ok &= j["inside"]
            lines.append(
                "| check | %s | %s mean | torch %.2f%% vs JAX %s f32 %.2f%%±%.2f%% "
                "(3σ band ±%.2f%%) | %s | |" % (
                    loss, label, j["mean"] * 100, against, j["jax_mean"] * 100,
                    j["jax_sd"] * 100, j["band"] * 100, "PASS" if j["inside"] else "FAIL"))
            seeds_in = ["s%d %s" % (r["seed"], "in" if abs(r["eer"] - j["jax_mean"])
                                    <= j["band"] else "OUT") for r in group]
            lines.append("| seeds | %s | %s | %s (printed, not a gate) | | |"
                         % (loss, label, ", ".join(seeds_in)))
            jax_arm = "tpu" if label == "f32" else "tpu-bf16"
            jax_group = jax_eers(loss if label == "f32" else "amsoftmax", jax_arm)
            if jax_group:
                p = _exact_rank_p(jax_group, eers)
                lines.append(
                    "| rank | %s | %s %dv%d | JAX %s mean %.2f%% vs torch mean %.2f%%, exact "
                    "two-sided p=%.3f (printed, not a gate) | %s | |" % (
                        loss, label, len(jax_group), len(eers), jax_arm,
                        np.mean(jax_group) * 100, j["mean"] * 100, p,
                        "offset flagged" if p < 0.05 else "no offset"))
    lines += ["", "Every judged family inside its JAX band: **%s**" % ("PASS" if ok else "FAIL"),
              ""]
    text = "\n".join(lines)
    print(text, flush=True)
    if write_doc:
        append_doc(text)
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=["make-data", "make-data-mt", "run", "report"])
    p.add_argument("--root", required=True)
    p.add_argument("--arm", choices=["torch"], default="torch",
                   help="the framework arm (the TF1 reference arm is not ported)")
    p.add_argument("--loss", choices=FAMILIES)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--compute-dtype", default="", choices=["", "float32", "bfloat16"],
                   help="activation dtype override (e.g. bfloat16)")
    p.add_argument("--program", default="", choices=["", "flagship"],
                   help="flagship: am-softmax, bf16, device pool, fused pooling kernels")
    p.add_argument("--steps-per-epoch", type=int, default=BASE_CFG["num_steps_per_epoch"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--deterministic", action="store_true",
                   help="torch.use_deterministic_algorithms(True): a nondeterministic op "
                        "raises")
    p.add_argument("--write-doc", action="store_true")
    args = p.parse_args(argv)

    if args.mode == "make-data":
        corpora.make_data(args.root)
        return 0
    if args.mode == "make-data-mt":
        corpora.make_data_mt(args.root)
        return 0
    if args.mode == "report":
        return report(args.root, args.write_doc)

    if not args.loss:
        p.error("run mode needs --loss")
    if args.program and args.loss != "amsoftmax":
        p.error("--program flagship is the am-softmax family")
    device = device_or_raise(args.device)
    out = os.path.join(args.root, "results", "torch_%s_s%d%s.json" % (
        args.loss, args.seed, arm_tag(args.compute_dtype, args.program, args.deterministic)))
    run_torch(args.root, args.loss, args.seed, args.steps_per_epoch, out,
              compute_dtype=args.compute_dtype, program=args.program, device=device,
              deterministic=args.deterministic)
    return 0


if __name__ == "__main__":
    sys.exit(main())
