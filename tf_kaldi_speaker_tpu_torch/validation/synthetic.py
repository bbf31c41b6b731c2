"""End-to-end synthetic validation through the port (a copy of
``scripts/synthetic_validation.py:100-298``).

Default: the separable corpus (100 train speakers x 15 utterances, dim 30,
Gaussian speaker means; 40 held-out speakers), the 128-wide TDNN with
AM-softmax from the streaming loader with ``device_decode``, 600 steps at
batch 64; extraction, cosine and PLDA EER on the held-out speakers.

``--hard``: the hard corpus (:func:`.corpora.make_hard_corpora`), softmax,
AM-softmax m=0.2 and AM-softmax + MHE(0.01), 3 epochs x 1000 steps with the
halving LR schedule, one seed; every loss must train to within 4% absolute
of the frame-mean oracle (exit 1 otherwise).

Run: ``python -m tf_kaldi_speaker_tpu_torch.validation.synthetic [--hard]
[--device cuda] [--root DIR] [--write-doc]``; ``--write-doc`` appends the
result to ``docs/VALIDATION_TORCH.md``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from ..backend import (compute_cos_pairwise_eer, compute_eer, length_norm,
                       subtract_global_mean, train_plda)
from ..cli._frontend import device_or_raise
from ..extract.extractor import Extractor
from ..kio import read_mat_scp
from ..train.trainer import Trainer
from ..utils.params import ParamsPlain
from ..utils.testdata import make_fake_data_dir
from . import corpora
from .common import append_doc, card_name, oracle_eer, write_nnet_files
from .quality_matrix import CFG, LOSSES


def embed_data_dir(ex, data_dir):
    """The extractor's embeddings of a data dir's utterances: (keys, [N, E])."""
    keys, embs = [], []
    for key, emb in ex.embed_stream(read_mat_scp(os.path.join(data_dir, "feats.scp"))):
        keys.append(key)
        embs.append(emb)
    return keys, np.stack(embs)


def plda_eer(train_embs, train_labels, test_embs, test_labels) -> float:
    """PLDA on the train speakers, 20,000 random trials among the held-out
    utterances (the scripts' protocol)."""
    x, mean = subtract_global_mean(train_embs)
    plda = train_plda(length_norm(x), train_labels, num_em_iters=8)
    t_proc = length_norm(test_embs - mean)
    rng = np.random.RandomState(0)
    e_idx = rng.randint(0, len(test_labels), 20000)
    t_idx = rng.randint(0, len(test_labels), 20000)
    enroll = {str(i): t_proc[i] for i in np.unique(e_idx)}
    test_set = {str(i): t_proc[i] for i in np.unique(t_idx)}
    scores = plda.score_trials(enroll, {k: 1 for k in enroll}, test_set,
                               [(str(a), str(b)) for a, b in zip(e_idx, t_idx)])
    eer, _ = compute_eer(scores, (test_labels[e_idx] == test_labels[t_idx]).astype(int))
    return float(eer)


def run_hard(root, device, card, write_doc) -> int:
    t0 = time.time()
    train_d, test_d = corpora.make_hard_corpora(root)
    print("data gen: %.1fs" % (time.time() - t0), flush=True)
    oracle = oracle_eer(test_d)
    print("oracle (frame-mean) EER: %.2f%%" % (oracle * 100), flush=True)
    results = {}
    for name, over in LOSSES.items():
        # 3 epochs x 1000 steps, halving LR; one worker: deterministic order
        cfg = dict(CFG, num_steps_per_epoch=1000, seed=0, num_parallel_datasets=1, **over)
        exp = os.path.join(root, "exp_" + name)
        nnet = os.path.join(exp, "nnet")
        trainer = Trainer(ParamsPlain(**cfg), nnet, dim=corpora.HARD_DIM,
                          num_speakers=corpora.HARD_NSPK, device=device)
        trainer.build("train", corpora.HARD_DIM, cfg["loss_func"], corpora.HARD_NSPK)
        t1 = time.time()
        for lr in (0.04, 0.02, 0.01):
            trainer.train(train_d["data"], train_d["spklist"], lr)
        trainer.close()
        dt = time.time() - t1
        write_nnet_files(nnet, cfg, corpora.HARD_DIM)
        ex = Extractor(exp, min_chunk_size=25, batch_size=32, device=device)
        keys, E = embed_data_dir(ex, test_d["data"])
        eer = compute_cos_pairwise_eer(E - E.mean(0), np.array([int(k[3:7]) for k in keys]))
        results[name] = eer
        print("%s: EER %.2f%% (train %.0fs)" % (name, eer * 100, dt), flush=True)
    # per-loss sanity, as in JAX: within 4% absolute of the oracle
    ok = all(results[name] < oracle + 0.04 for name in LOSSES)
    lines = ["", "## Hard-corpus loss run through the port (one seed)", "",
             "`python -m tf_kaldi_speaker_tpu_torch.validation.synthetic --hard` — "
             "%d train / 40 held-out speakers, dim %d, chan %.1f; oracle frame-mean EER"
             % (corpora.HARD_NSPK, corpora.HARD_DIM, corpora.HARD_CHAN),
             "%.2f%%. 3 epochs x 1000 steps, halving LR. Card: %s." % (oracle * 100, card), "",
             "| Loss | held-out cosine EER (seed 0) |", "|---|---|"]
    lines += ["| %s | %.2f%% |" % (name, results[name] * 100) for name in LOSSES]
    lines += ["", "All losses within 4%% of oracle: **%s**" % ("PASS" if ok else "FAIL"), ""]
    text = "\n".join(lines)
    print(text, flush=True)
    if write_doc:
        append_doc(text)
    return 0 if ok else 1


def run_separable(root, device, card, write_doc) -> int:
    t0 = time.time()
    train_d = make_fake_data_dir(
        os.path.join(root, "train"), num_speakers=100, utts_per_speaker=15,
        dim=30, min_len=320, max_len=600, seed=0)
    test_d = make_fake_data_dir(
        os.path.join(root, "test"), num_speakers=40, utts_per_speaker=10,
        dim=30, min_len=320, max_len=600, seed=777, spk_offset=500)
    print("data gen: %.1fs" % (time.time() - t0), flush=True)
    nnet = os.path.join(root, "exp", "nnet")
    trainer = Trainer(ParamsPlain(**CFG), nnet, dim=30, num_speakers=100, device=device)
    trainer.build("train", 30, CFG["loss_func"], 100)
    t1 = time.time()
    trainer.train(train_d["data"], train_d["spklist"], CFG["learning_rate"])
    trainer.close()
    train_time = time.time() - t1
    steps = trainer.step
    print("train: %d steps in %.1fs (%.1f steps/s)" % (steps, train_time, steps / train_time),
          flush=True)
    write_nnet_files(nnet, CFG, 30)
    ex = Extractor(os.path.join(root, "exp"), min_chunk_size=25, batch_size=32, device=device)
    train_keys, train_embs = embed_data_dir(ex, train_d["data"])
    t2 = time.time()
    test_keys, test_embs = embed_data_dir(ex, test_d["data"])
    test_dt = time.time() - t2
    test_labels = np.array([int(k[3:6]) for k in test_keys])
    eer_cos = compute_cos_pairwise_eer(test_embs, test_labels)
    eer_plda = plda_eer(train_embs, np.array([int(k[3:6]) for k in train_keys]),
                        test_embs, test_labels)
    print("cosine EER: %.2f%%  PLDA EER: %.2f%%" % (eer_cos * 100, eer_plda * 100), flush=True)
    text = "\n".join([
        "", "## Separable synthetic run through the port", "",
        "`python -m tf_kaldi_speaker_tpu_torch.validation.synthetic` — 100 train x 15 "
        "utterances, 40 held-out speakers, dim 30; AM-softmax, streaming `device_decode`, "
        "%d steps at batch 64. Card: %s." % (steps, card), "",
        "| Stage | Result |", "|---|---|",
        "| Training | %d steps in %.1f s (%.1f steps/s) |" % (steps, train_time,
                                                        steps / train_time),
        "| Extraction | %.0f embeddings/s |" % (len(test_keys) / test_dt),
        "| Cosine EER (held-out speakers) | %.2f%% |" % (eer_cos * 100),
        "| PLDA EER (held-out speakers) | %.2f%% |" % (eer_plda * 100), ""])
    if write_doc:
        append_doc(text)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hard", action="store_true")
    p.add_argument("--root", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--write-doc", action="store_true")
    args = p.parse_args(argv)
    device = device_or_raise(args.device)
    card = card_name(device)
    root = args.root or tempfile.mkdtemp(prefix="tfks_torch_val_")
    print("data root:", root, "card:", card, flush=True)
    run = run_hard if args.hard else run_separable
    return run(root, device, card, args.write_doc)


if __name__ == "__main__":
    raise SystemExit(main())
