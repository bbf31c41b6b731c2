"""What the validation harnesses share: the held-out EER protocol, the
oracle EER, the mean ± sd format, the exact rank test and the band rule,
over the port's back end and Kaldi codec; the card and document plumbing
of their entry points; and the ECAPA and ResNet34 validations' shared
body (:func:`zoo_validation`).

Copies of ``_test_eer`` and ``_exact_rank_p``
(``scripts/reference_convergence.py:428-440, :538-557``), the band rule
(``:605``) and ``oracle_eer`` / ``fmt_mean_sd``
(``scripts/quality_matrix.py``)."""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import tempfile
import time
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from ..backend import compute_cos_pairwise_eer
from ..cli._frontend import device_or_raise
from ..extract.extractor import Extractor
from ..kio import read_mat_scp
from ..train.trainer import Trainer
from ..utils.params import ParamsPlain
from ..utils.testdata import make_fake_data_dir

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# The port's quality record; docs/VALIDATION.md is the JAX package's.
DOC = os.path.join(REPO, "docs", "VALIDATION_TORCH.md")
# EER quantization on 400 held-out utterances: the band's floor of sd
BAND_SD_FLOOR = 0.005


def _test_eer(embed_fn: Callable[[np.ndarray], np.ndarray], test_dir: str) -> float:
    """Cosine pairwise EER over mean-subtracted full-utterance embeddings
    (the synthetic-validation protocol)."""
    keys, embs = [], []
    for key, feats in read_mat_scp(os.path.join(test_dir, "feats.scp")):
        keys.append(key)
        embs.append(embed_fn(feats))
    E = np.stack(embs)
    labels = np.array([int(k[3:7]) for k in keys])
    return float(compute_cos_pairwise_eer(E - E.mean(0), labels))


def oracle_eer(test_d: Dict[str, str]) -> float:
    """The cosine EER of the raw frame means of the held-out utterances:
    how well any embedding could do."""
    keys, means = [], []
    for k, m in read_mat_scp(os.path.join(test_d["data"], "feats.scp")):
        keys.append(k)
        means.append(m.mean(0))
    return float(compute_cos_pairwise_eer(
        np.stack(means), np.array([int(k[3:7]) for k in keys])))


def fmt_mean_sd(vals: Sequence[float]) -> str:
    a = np.asarray(vals)
    return "%.2f%% ± %.2f%%" % (a.mean() * 100, a.std(ddof=1) * 100)


def _exact_rank_p(ref_vals: Sequence[float], tpu_vals: Sequence[float]) -> float:
    """Two-sided exact Mann-Whitney p for tiny samples (enumerate all
    C(n+m, n) group assignments of the pooled values)."""
    pooled = list(ref_vals) + list(tpu_vals)
    n = len(ref_vals)
    idx = range(len(pooled))
    rank = {i: r for r, i in enumerate(
        sorted(idx, key=lambda i: pooled[i]))}

    def stat(group):
        return sum(rank[i] for i in group)

    observed = stat(range(n))
    stats = [stat(c) for c in itertools.combinations(idx, n)]
    mean = sum(stats) / len(stats)
    extreme = sum(1 for s in stats
                  if abs(s - mean) >= abs(observed - mean) - 1e-12)
    return extreme / len(stats)


def band(sd: float) -> float:
    """The acceptance band's half-width: 3 sigma, sigma floored at 0.5%."""
    return 3 * max(sd, BAND_SD_FLOOR)


def judge(port: Sequence[float], jax: Sequence[float]) -> Dict[str, float]:
    """The port arm's mean against the recorded JAX arm's band (mean ±
    :func:`band` of its sample sd)."""
    ref = np.asarray(jax, np.float64)
    mu, sd = float(ref.mean()), float(ref.std(ddof=1))
    mean = float(np.mean(port))
    return dict(mean=mean, jax_mean=mu, jax_sd=sd, band=band(sd),
                inside=bool(abs(mean - mu) <= band(sd)))


def card_name(device: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, the line every number
    from a card is recorded beside; a CPU run says so."""
    if device.type != "cuda":
        return "cpu (not a card)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    return out[device.index or 0] if out else torch.cuda.get_device_name(device)


def write_nnet_files(nnet: str, cfg: Dict, dim: int) -> None:
    """The model dir's ``config.json`` and ``feature_dim`` (what the
    extractor reads beside the checkpoint)."""
    os.makedirs(nnet, exist_ok=True)
    with open(os.path.join(nnet, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    with open(os.path.join(nnet, "feature_dim"), "w") as f:
        f.write("%d\n" % dim)


def append_doc(text: str, doc: str = DOC) -> None:
    """Append a section to the port's quality record."""
    with open(doc, "a") as f:
        f.write(text + "\n")
    print("appended to", doc, flush=True)


def zoo_validation(cfg: Dict, title: str, record: str, argv=None) -> int:
    """The ECAPA and ResNet34 validations (``scripts/ecapa_validation.py``,
    ``scripts/resnet_validation.py``): train ``cfg`` one epoch at LR 0.05 on
    the separable corpus (60 speakers x 10, dim 30), extract 20 held-out
    speakers and score them; 0 when the cosine EER is under 5%, the
    scripts' gate. ``record`` is the JAX result on the record."""
    p = argparse.ArgumentParser(description=title)
    p.add_argument("--root", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--write-doc", action="store_true")
    args = p.parse_args(argv)
    device = device_or_raise(args.device)
    card = card_name(device)
    tmp = args.root or tempfile.mkdtemp(prefix="tfks_torch_zoo_val_")
    train = make_fake_data_dir(os.path.join(tmp, "train"), num_speakers=60,
                               utts_per_speaker=10, dim=30, min_len=260,
                               max_len=400, seed=0)
    held = make_fake_data_dir(os.path.join(tmp, "held"), num_speakers=20,
                              utts_per_speaker=6, dim=30, min_len=260,
                              max_len=400, seed=777, spk_offset=100)
    nnet = os.path.join(tmp, "m", "nnet")
    t = Trainer(ParamsPlain(**cfg), nnet, dim=30, num_speakers=60, device=device)
    t.build("train", 30, cfg["loss_func"], 60)
    t0 = time.time()
    t.train(train["data"], train["spklist"], 0.05)
    t.close()
    dt = time.time() - t0
    print("trained %d steps in %.1fs (%.1f steps/s)" % (t.step, dt, t.step / dt), flush=True)
    write_nnet_files(nnet, cfg, 30)
    ex = Extractor(os.path.join(tmp, "m"), min_chunk_size=25, device=device)
    feats = dict(read_mat_scp(held["feats_scp"]))
    embs = dict(ex.embed_stream(iter(feats.items())))
    keys = sorted(embs)
    X = np.stack([embs[k] for k in keys])
    labels = np.array([int(k[3:6]) for k in keys])
    eer = compute_cos_pairwise_eer(X, labels)
    ok = eer < 0.05
    text = ("\n## %s through the port\n\n%d steps in %.1f s (%.1f steps/s): held-out cosine "
            "EER %.2f%% over %d utterances / %d speakers (JAX record %s; gate 5%%: %s). "
            "Card: %s.\n" % (title, t.step, dt, t.step / dt, eer * 100, len(keys),
                             len(set(labels.tolist())), record, "PASS" if ok else "FAIL",
                             card))
    print(text, flush=True)
    if args.write_doc:
        append_doc(text)
    return 0 if ok else 1
