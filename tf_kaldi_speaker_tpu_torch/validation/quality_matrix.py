"""Quality matrix on the hard synthetic corpus, through the port.

A copy of ``scripts/quality_matrix.py`` over the port's trainer and
extractor: the hard corpus (600 crowded speakers, dim 12, channel offsets;
:func:`.corpora.make_hard_corpora`), the 6 x 500-step halving schedule and
the same extraction and scoring. Each port arm's mean over its seeds is
judged against the JAX arm on the record (``docs/VALIDATION.md:438-444, :480-482``):
it must lie within the JAX mean ± 3 max(sd, 0.5%) (:func:`.common.judge`).

Modes:
  --paths   input paths (stream, pool, the rotating pools, pool_bf16, and
            ``pool_bf16_fused``: pool_bf16 with the fused pooling kernels,
            the program the chip smoke runs; judged against JAX's
            pool_bf16), 3 seeds by default
  --losses  loss ordering with spread (3 losses x 5 seeds, pool path)
  --gap     oracle-gap probes at seed 0 (longer schedule, wider model);
            printed, one seed, no band

Run: ``python -m tf_kaldi_speaker_tpu_torch.validation.quality_matrix
--paths --only pool,pool_bf16_fused [--device cuda] [--root DIR]
[--write-doc]``. Writes ``results.json`` under the root; ``--write-doc``
appends the tables to ``docs/VALIDATION_TORCH.md``. Exits 1 when an arm
with a JAX record falls outside its band.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from .. import convert
from ..backend import compute_cos_pairwise_eer
from ..cli._frontend import device_or_raise
from ..extract.extractor import Extractor
from ..kio import read_mat_scp
from ..train.trainer import Trainer
from ..utils.params import ParamsPlain
from . import corpora
from .common import append_doc, card_name, fmt_mean_sd, judge, oracle_eer, \
    write_nnet_files

# scripts/synthetic_validation.py:41-78
CFG = dict(
    seed=0,
    network_type="tdnn",
    tdnn_layer_size=128,
    num_nodes_pooling_layer=256,
    num_nodes_last_layer=128,
    pooling_type="statistics_pooling",
    embedding_node="tdnn6_dense",
    last_layer_linear=True,
    loss_func="additive_margin_softmax",
    amsoftmax_m=0.2,
    amsoftmax_lambda_min=0,
    amsoftmax_lambda_base=1000,
    amsoftmax_lambda_gamma=0.001,
    amsoftmax_lambda_power=4,
    learning_rate=0.02,
    optimizer="momentum",
    momentum=0.9,
    use_nesterov=False,
    clip_gradient=True,
    clip_gradient_norm=3.0,
    weight_l2_regularizer=1e-4,
    batchnorm_momentum=0.99,
    num_steps_per_epoch=600,
    show_training_progress=100,
    keep_checkpoint_max=2,
    save_checkpoints_steps=600,
    save_summary_steps=100,
    valid_max_iterations=5,
    num_parallel_datasets=2,
    max_queue_size=8,
    num_speakers_per_batch=64,
    num_segments_per_speaker=1,
    min_segment_len=150,
    max_segment_len=300,
    batch_type="softmax",
    device_decode=True,
)

EPOCH_LRS = [0.04, 0.04, 0.02, 0.02, 0.01, 0.01]  # 6x500 == 3x1000 halving

# scripts/quality_matrix.py:48-74, and the port's pool_bf16_fused
PATHS = {
    "stream": dict(device_decode=True),
    "pool": dict(device_decode=False, device_pool=True),
    "pool_rot_utts": dict(device_decode=False, device_pool=True,
                          pool_budget_mb=8),
    "pool_rot": dict(device_decode=False, device_pool=True,
                     pool_budget_mb=8, pool_rotation_unit="speakers"),
    "pool_rot_c3": dict(device_decode=False, device_pool=True,
                        pool_budget_mb=8, pool_rotation_unit="speakers",
                        pool_rotation_cycles=3),
    "pool_bf16": dict(device_decode=False, device_pool=True,
                      compute_dtype="bfloat16"),
    # the chip smoke's program: bf16 on the pool path with the fused
    # pooling forward and backward kernels (and the dequant)
    "pool_bf16_fused": dict(device_decode=False, device_pool=True,
                            compute_dtype="bfloat16", use_fused_pooling=True),
}

# scripts/quality_matrix.py:76-81
LOSSES = {
    "softmax": dict(loss_func="softmax"),
    "amsoftmax_m0.2": dict(loss_func="additive_margin_softmax"),
    "amsoftmax_m0.2_mhe0.01": dict(
        loss_func="additive_margin_softmax",
        aux_loss_func=["mhe_loss"], mhe_lambda=0.01),
}

# The JAX arms' seeds on the record, as fractions.
# docs/VALIDATION.md:438-444 (input paths, 3 seeds each)
JAX_PATHS = {
    "stream": [0.1881, 0.1878, 0.1947],
    "pool": [0.1917, 0.1853, 0.1872],
    "pool_bf16": [0.1917, 0.1961, 0.1873],
    "pool_rot_utts": [0.1867, 0.1900, 0.1889],
    "pool_rot": [0.1963, 0.2006, 0.1956],
    "pool_rot_c3": [0.1922, 0.1919, 0.1948],
}
# docs/VALIDATION.md:480-482 (6x500, 5 seeds each)
JAX_LOSSES = {
    "softmax": [0.1869, 0.1872, 0.1806, 0.1872, 0.1911],
    "amsoftmax_m0.2": [0.1917, 0.1853, 0.1872, 0.1939, 0.1844],
    "amsoftmax_m0.2_mhe0.01": [0.1878, 0.1906, 0.1872, 0.1807, 0.1918],
}
# a port arm without a JAX arm of its own is judged against this one's
JUDGED_BY = {"pool_bf16_fused": "pool_bf16"}


def arm_config(seed: int, over: Dict, steps_per_epoch: int = 500,
               width: Optional[int] = None) -> Dict:
    """The training config of one run (``train_and_eer``'s)."""
    cfg = dict(CFG, num_steps_per_epoch=steps_per_epoch, seed=seed,
               num_parallel_datasets=1, **over)
    if width:
        cfg.update(tdnn_layer_size=width, num_nodes_pooling_layer=2 * width)
    return cfg


def train_and_eer(root, train_d, test_d, name, seed, over,
                  epoch_lrs=EPOCH_LRS, steps_per_epoch=500, width=None,
                  device="cuda", init_variables=None) -> float:
    """Train one arm (one epoch a learning rate, one loader worker: a
    deterministic batch order), extract the held-out speakers and return
    their cosine EER. ``init_variables`` (a JAX-layout ``params`` /
    ``batch_stats`` tree) replaces the seed's initial weights: the CPU
    tests start the port from the JAX trainer's."""
    cfg = arm_config(seed, over, steps_per_epoch, width)
    params = ParamsPlain(**cfg)
    exp = os.path.join(root, "exp_%s_s%d" % (name, seed))
    nnet = os.path.join(exp, "nnet")
    trainer = Trainer(params, nnet, dim=corpora.HARD_DIM, num_speakers=corpora.HARD_NSPK,
                      device=device)
    trainer.build("train", corpora.HARD_DIM, cfg["loss_func"], corpora.HARD_NSPK)
    if init_variables is not None:
        convert.load_variables(trainer.network_model, init_variables)
    t0 = time.time()
    try:
        for lr in epoch_lrs:
            trainer.train(train_d["data"], train_d["spklist"], lr)
    finally:
        trainer.close()
    dt = time.time() - t0
    write_nnet_files(nnet, cfg, corpora.HARD_DIM)
    ex = Extractor(exp, min_chunk_size=25, batch_size=32, device=device)
    keys, embs = [], []
    stream = read_mat_scp(os.path.join(test_d["data"], "feats.scp"))
    for key, emb in ex.embed_stream(stream):
        keys.append(key)
        embs.append(emb)
    labels = np.array([int(k[3:7]) for k in keys])
    E = np.stack(embs)
    eer = float(compute_cos_pairwise_eer(E - E.mean(0), labels))
    print("  %s seed %d: EER %.2f%% (train %.0fs)"
          % (name, seed, eer * 100, dt), flush=True)
    return eer


def run_paths(root, train_d, test_d, seeds, results, only=None, device="cuda"):
    for name, over in PATHS.items():
        if only and name not in only:
            continue
        results.setdefault("paths", {})[name] = [
            train_and_eer(root, train_d, test_d, "path_" + name, s, over, device=device)
            for s in seeds
        ]


def run_losses(root, train_d, test_d, seeds, results, only=None, device="cuda"):
    for name, over in LOSSES.items():
        if only and name not in only:
            continue
        o = dict(over, device_decode=False, device_pool=True)
        results.setdefault("losses", {})[name] = [
            train_and_eer(root, train_d, test_d, "loss_" + name, s, o, device=device)
            for s in seeds
        ]


def run_gap(root, train_d, test_d, results, device="cuda"):
    """Oracle-gap probes (seed 0, pool path, am-softmax)."""
    base = dict(device_decode=False, device_pool=True)
    longer = [0.04] * 4 + [0.02] * 4 + [0.01] * 4
    probes = {
        "baseline_6x500": dict(kw={}, over=base),
        "longer_12x500": dict(kw=dict(epoch_lrs=longer), over=base),
        "wider_256": dict(kw=dict(width=256), over=base),
        "longer_and_wider": dict(kw=dict(epoch_lrs=longer, width=256), over=base),
    }
    for name, spec in probes.items():
        results.setdefault("gap", {})[name] = [
            train_and_eer(root, train_d, test_d, "gap_" + name, 0,
                          spec["over"], device=device, **spec["kw"])
        ]


def _judged_rows(eers_by_arm: Dict[str, List[float]], record: Dict[str, List[float]]):
    """Table rows of the port's arms beside the JAX arm each is judged
    against; returns (lines, every judged arm inside its band)."""
    lines, ok = [], True
    for name, eers in eers_by_arm.items():
        jax_name = JUDGED_BY.get(name, name)
        seeds = " ".join("%.2f" % (e * 100) for e in eers)
        spread = fmt_mean_sd(eers) if len(eers) > 1 else "%.2f%%" % (eers[0] * 100)
        if jax_name not in record:
            lines.append("| %s | %s | %s | no JAX arm | - |" % (name, spread, seeds))
            continue
        j = judge(eers, record[jax_name])
        ok &= j["inside"]
        lines.append("| %s | %s | %s | %s %.2f%% ± %.2f%% (band ±%.2f%%) | %s |" % (
            name, spread, seeds, jax_name, j["jax_mean"] * 100, j["jax_sd"] * 100,
            j["band"] * 100, "PASS" if j["inside"] else "FAIL"))
    return lines, ok


def report(results, oracle, seeds, write_doc, card="", wall_s=None) -> int:
    """Print (and with ``write_doc`` append) the tables; 0 when every arm
    with a JAX record lies inside its band, else 1."""
    lines = ["", "## Quality matrix through the port (hard corpus, multi-seed)", "",
             "`python -m tf_kaldi_speaker_tpu_torch.validation.quality_matrix` — "
             "%d seeds, 6x500-step" % len(seeds),
             "halving schedule, oracle frame-mean EER %.2f%%. Card: %s%s." % (
                 oracle * 100, card,
                 "; %.0f s of wall time" % wall_s if wall_s is not None else ""),
             "Each arm's mean is judged against the JAX arm on the record",
             "(`docs/VALIDATION.md`), band = 3·max(sd, 0.5%).", ""]
    ok = True
    if "paths" in results:
        lines += ["### Input paths (am-softmax m=0.2)", "",
                  "| Input path | held-out EER (mean ± sd) | seeds | JAX arm | check |",
                  "|---|---|---|---|---|"]
        rows, good = _judged_rows(results["paths"], JAX_PATHS)
        lines += rows + [""]
        ok &= good
    if "losses" in results:
        lines += ["### Loss ordering with spread (pool path)", "",
                  "| Loss | held-out EER (mean ± sd) | seeds | JAX arm | check |",
                  "|---|---|---|---|---|"]
        rows, good = _judged_rows(results["losses"], JAX_LOSSES)
        lines += rows
        ok &= good
        if {"softmax", "amsoftmax_m0.2"} <= set(results["losses"]):
            sm = np.array(results["losses"]["softmax"])
            am = np.array(results["losses"]["amsoftmax_m0.2"])
            lines += ["", "Margin-beats-softmax (printed, not a gate: a wash in JAX too): "
                      "**%s** (softmax %.2f%% vs am-softmax %.2f%%)" % (
                          "yes" if am.mean() < sm.mean() else "no", sm.mean() * 100,
                          am.mean() * 100)]
        lines.append("")
    if "gap" in results:
        lines += ["### Oracle-gap probes (seed 0, am-softmax; printed, no band)", "",
                  "| Variant | held-out EER |", "|---|---|"]
        for name, eers in results["gap"].items():
            lines.append("| %s | %.2f%% |" % (name, eers[0] * 100))
        lines.append("")
    lines.append("All judged arms inside their JAX bands: **%s**" % ("PASS" if ok else "FAIL"))
    lines.append("")
    text = "\n".join(lines)
    print(text, flush=True)
    if write_doc:
        append_doc(text)
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--paths", action="store_true")
    p.add_argument("--losses", action="store_true")
    p.add_argument("--gap", action="store_true")
    p.add_argument("--seeds", type=int, default=3,
                   help="seeds for --paths (the loss table uses --seeds-losses)")
    p.add_argument("--seeds-losses", type=int, default=5)
    p.add_argument("--root", default=None)
    p.add_argument("--only", default=None,
                   help="comma-separated subset of the PATHS (--paths) and LOSSES "
                        "(--losses) arms (e.g. pool,pool_bf16_fused)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--write-doc", action="store_true")
    args = p.parse_args(argv)
    if not (args.paths or args.losses or args.gap):
        args.paths = args.losses = args.gap = True
    only = set(args.only.split(",")) if args.only else None
    if only and only - set(PATHS) - set(LOSSES):
        p.error("unknown arms: %s" % sorted(only - set(PATHS) - set(LOSSES)))
    device = device_or_raise(args.device)
    card = card_name(device)
    print("card:", card, flush=True)

    root = args.root or tempfile.mkdtemp(prefix="tfks_torch_qmatrix_")
    print("root:", root, flush=True)
    t0 = time.time()
    train_d, test_d = corpora.make_hard_corpora(root)
    print("data gen: %.0fs" % (time.time() - t0), flush=True)
    oracle = oracle_eer(test_d)
    print("oracle EER %.2f%%" % (oracle * 100), flush=True)

    results = {}
    t0 = time.time()
    if args.paths:
        run_paths(root, train_d, test_d, list(range(args.seeds)), results, only, device)
    if args.losses:
        run_losses(root, train_d, test_d, list(range(args.seeds_losses)), results, only, device)
    if args.gap:
        run_gap(root, train_d, test_d, results, device)
    wall = time.time() - t0
    with open(os.path.join(root, "results.json"), "w") as f:
        json.dump(dict(results, card=card, oracle=oracle, wall_s=wall), f, indent=1)
    return report(results, oracle, list(range(args.seeds)), args.write_doc, card, wall)


if __name__ == "__main__":
    sys.exit(main())
