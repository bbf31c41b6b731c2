"""Trial scoring CLI: cosine or PLDA backend + EER/minDCF report.

Replaces the reference's scoring glue (egs/voxceleb/v1/run.sh:344-427,
eval_cos.sh / eval_plda.sh): ivector post-processing (speaker means, mean
subtraction, length norm, optional LDA), trial scoring, and metrics
(compute-eer, minDCF08/10 from DETware).

Usage (cosine):
    python -m tf_kaldi_speaker_tpu_torch.cli.score --backend cosine \
        --enroll-scp enroll.scp --test-scp test.scp --trials trials \
        --scores scores.txt
Usage (PLDA, trained on a labeled train set):
    python -m tf_kaldi_speaker_tpu_torch.cli.score --backend plda \
        --train-scp train.scp --train-utt2spk utt2spk --lda-dim 150 ...

Counterpart of ``tf_kaldi_speaker_tpu/cli/score.py``, whole: the same flags,
scores file and report, scored on the host in float64.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Dict

import numpy as np

from ..backend import (
    LDA,
    compute_eer,
    length_norm,
    min_dcf08,
    min_dcf10,
    read_trials,
    speaker_means,
    subtract_global_mean,
    train_plda,
)
from ..kio import read_vec_flt_scp


def _load_scp(path: str) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v, np.float64) for k, v in read_vec_flt_scp(path)}


def _load_utt2spk(path: str) -> Dict[str, str]:
    out = {}
    with open(path) as f:
        for line in f:
            u, s = line.split()[:2]
            out[u] = s
    return out


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--backend", choices=["cosine", "plda"], default="cosine")
    parser.add_argument("--enroll-scp", required=True, help="enrollment x-vectors (scp)")
    parser.add_argument("--enroll-utt2spk", default=None,
                        help="average enrollment utts per speaker first (ivector-mean)")
    parser.add_argument("--test-scp", required=True)
    parser.add_argument("--trials", required=True, help="'enroll test target|nontarget'")
    parser.add_argument("--scores", default=None, help="write scores here")
    parser.add_argument("--train-scp", default=None, help="PLDA/LDA training vectors")
    parser.add_argument("--train-utt2spk", default=None)
    parser.add_argument("--lda-dim", type=int, default=0, help="apply LDA before PLDA")
    parser.add_argument("--plda-smoothing", type=float, default=0.0)
    parser.add_argument("--plda-in", default=None,
                        help="load a trained PLDA backend instead of "
                             "training one (npz / Kaldi binary / Kaldi text "
                             "<Plda> file, auto-sniffed — reuse an existing "
                             "Kaldi backend directly)")
    parser.add_argument("--plda-out", default=None,
                        help="save the PLDA backend used for scoring "
                             "(after smoothing/adaptation)")
    parser.add_argument("--plda-format", choices=["kaldi", "kaldi_text",
                                                  "npz"], default="kaldi",
                        help="--plda-out format")
    parser.add_argument("--mean-vec", default=None,
                        help="with --plda-in: global-mean vector file "
                             "(Kaldi mean.vec via ivector-mean, or npy) "
                             "applied before LDA/length-norm")
    parser.add_argument("--lda-mat", default=None,
                        help="with --plda-in: Kaldi LDA transform.mat "
                             "([dim,D] linear or [dim,D+1] affine), applied "
                             "after --mean-vec subtraction")
    parser.add_argument("--adapt-scp", default=None, help="unsupervised PLDA adaptation vectors")
    parser.add_argument("--adapt-within-scale", type=float, default=0.3,
                        help="ivector-adapt-plda --within-covar-scale "
                             "(reference SRE16 uses 0.75, sre run.sh:471)")
    parser.add_argument("--adapt-between-scale", type=float, default=0.7,
                        help="ivector-adapt-plda --between-covar-scale "
                             "(reference SRE16 uses 0.25)")
    parser.add_argument("--adapt-mean-diff-scale", type=float, default=1.0,
                        help="ivector-adapt-plda --mean-diff-scale")
    parser.add_argument("--simple-length-norm", action="store_true")
    parser.add_argument("--cohort-scp", default=None,
                        help="apply AS-Norm with this cohort (x-vector scp)")
    parser.add_argument("--snorm-topk", type=int, default=300,
                        help="adaptive top-K cohort size (0 = plain S-norm)")
    parser.add_argument("--subset-trials", action="append", default=[],
                        metavar="NAME=TRIALS",
                        help="also report metrics on a trial subset (e.g. "
                             "tgl=.../trials_tgl), repeatable — the SRE16 "
                             "per-language protocol (reference "
                             "eval_plda_sre16.sh: pooled/tgl/yue)")
    args = parser.parse_args(argv)

    enroll = _load_scp(args.enroll_scp)
    test = _load_scp(args.test_scp)
    trials, targets = read_trials(args.trials)

    enroll_counts = {k: 1 for k in enroll}
    if args.enroll_utt2spk:
        utt2spk = _load_utt2spk(args.enroll_utt2spk)
        keys = list(enroll)
        spks, means, counts = speaker_means(keys, np.stack([enroll[k] for k in keys]), utt2spk)
        enroll = dict(zip(spks, means))
        enroll_counts = counts

    if args.backend == "cosine":
        from ..backend import cosine_score_trials
        from ..backend.scoring import (
            adaptive_snorm,
            cosine_matrix,
            snorm_stats,
        )

        if args.lda_dim > 0:
            # LDA + cosine (reference fisher run.sh:265-273 test_lda_cos):
            # subtract the TRAIN global mean, LDA-transform, length-norm,
            # then cosine — speaker means are taken BEFORE processing, like
            # the ivector-mean | subtract-mean | transform-vec pipe.
            assert args.train_scp and args.train_utt2spk, \
                "--lda-dim with cosine needs --train-scp/--train-utt2spk"
            train = _load_scp(args.train_scp)
            t_u2s = _load_utt2spk(args.train_utt2spk)
            keys = sorted(train)
            x = np.stack([train[k] for k in keys])
            labels = np.asarray([t_u2s[k] for k in keys])
            # LDA centers with its own fitted mean (= the train global
            # mean, the ivector-subtract-global-mean step).
            lda = LDA(args.lda_dim).fit(x, labels)

            def lda_proc(d):
                ks = list(d)
                v = length_norm(lda.transform_vecs(
                    np.stack([d[k] for k in ks])))
                return dict(zip(ks, v))

            enroll = lda_proc(enroll)
            test = lda_proc(test)
        else:
            lda_proc = None
        scores = cosine_score_trials(enroll, test, trials)
        if args.cohort_scp:
            cohort_d = _load_scp(args.cohort_scp)
            if lda_proc is not None:
                # The cohort must live in the same (LDA + length-norm)
                # space as the scored vectors or cosine_matrix dims clash.
                cohort_d = lda_proc(cohort_d)
            cohort = np.stack(list(cohort_d.values()))
            e_keys, t_keys = list(enroll), list(test)
            e_mu, e_sd = snorm_stats(
                cosine_matrix(np.stack([enroll[k] for k in e_keys]), cohort),
                args.snorm_topk)
            t_mu, t_sd = snorm_stats(
                cosine_matrix(np.stack([test[k] for k in t_keys]), cohort),
                args.snorm_topk)
            scores = adaptive_snorm(
                scores, trials,
                dict(zip(e_keys, zip(e_mu, e_sd))),
                dict(zip(t_keys, zip(t_mu, t_sd))),
            )
    elif args.plda_in:
        # Pre-trained backend (ours or an existing Kaldi one): rebuild the
        # Kaldi scoring pipeline ivector-subtract-global-mean [mean.vec] |
        # transform-vec [transform.mat] | ivector-normalize-length
        # (reference egs/voxceleb/v1/run.sh:399-401) from the recipe's own
        # artifact files, then score with the loaded <Plda>.
        from ..backend.plda import Plda
        from ..kio import read_mat, read_vec_flt

        plda = Plda.load(args.plda_in)
        if args.plda_smoothing > 0:
            plda = plda.smooth_within_class_covariance(args.plda_smoothing)
        mean = None
        if args.mean_vec:
            mean = (np.load(args.mean_vec)
                    if args.mean_vec.endswith((".npy", ".npz"))
                    else np.asarray(read_vec_flt(args.mean_vec), np.float64))
        lda_mat = None
        if args.lda_mat:
            lda_mat = np.asarray(read_mat(args.lda_mat), np.float64)

        def prep(d):
            out = {}
            for k, v in d.items():
                if mean is not None:
                    v = v - mean
                if lda_mat is not None:
                    if lda_mat.shape[1] == v.shape[0] + 1:  # affine column
                        v = lda_mat[:, :-1] @ v + lda_mat[:, -1]
                    else:
                        v = lda_mat @ v
                out[k] = length_norm(v[None])[0]
            return out
    else:
        assert args.train_scp and args.train_utt2spk, \
            "PLDA needs --train-scp/--train-utt2spk or --plda-in"
        train = _load_scp(args.train_scp)
        utt2spk = _load_utt2spk(args.train_utt2spk)
        keys = sorted(train)
        x = np.stack([train[k] for k in keys])
        labels = np.asarray([utt2spk[k] for k in keys])

        # Kaldi-style preprocessing: global mean + length norm (+ LDA).
        x, mean = subtract_global_mean(x)
        lda = None
        if args.lda_dim > 0:
            lda = LDA(args.lda_dim).fit(x, labels)
            x = lda.transform_vecs(x + mean)  # LDA holds its own mean
        x = length_norm(x)
        plda = train_plda(x, labels)
        if args.plda_smoothing > 0:
            plda = plda.smooth_within_class_covariance(args.plda_smoothing)

        def prep(d):
            out = {}
            for k, v in d.items():
                v = v - mean if lda is None else v
                if lda is not None:
                    v = lda.transform_vecs(v[None])[0]
                out[k] = length_norm(v[None])[0]
            return out

    if args.backend == "plda":
        enroll_p, test_p = prep(enroll), prep(test)
        if args.adapt_scp:
            adapt = prep(_load_scp(args.adapt_scp))
            plda = plda.adapt(
                np.stack(list(adapt.values())),
                mean_diff_scale=args.adapt_mean_diff_scale,
                within_covar_scale=args.adapt_within_scale,
                between_covar_scale=args.adapt_between_scale,
            )
        if args.plda_out:
            # The backend actually used for scoring (post-smoothing,
            # post-adaptation) — feed it back to Kaldi tooling or reload
            # with --plda-in.
            plda.save(args.plda_out, format=args.plda_format)
        scores = plda.score_trials(
            enroll_p, enroll_counts, test_p, trials,
            simple_length_norm=args.simple_length_norm,
        )
        if args.cohort_scp:
            from ..backend.scoring import adaptive_snorm, snorm_stats

            cohort_p = prep(_load_scp(args.cohort_scp))

            def side_stats(models, counts):
                keys, _, m = plda.score_matrix(
                    models, counts, cohort_p,
                    simple_length_norm=args.simple_length_norm,
                )
                mu, sd = snorm_stats(m, args.snorm_topk)
                return dict(zip(keys, zip(mu, sd)))

            scores = adaptive_snorm(
                scores, trials,
                side_stats(enroll_p, enroll_counts),
                side_stats(test_p, {k: 1 for k in test_p}),
            )

    if args.scores:
        with open(args.scores, "w") as f:
            for (e, t), s in zip(trials, scores):
                f.write("%s %s %f\n" % (e, t, s))

    def report(name, sc, tg):
        tag = "" if not name else "[%s] " % name
        eer, _ = compute_eer(sc, tg)
        print("%sEER: %.4f%%" % (tag, eer * 100.0))
        print("%sminDCF08: %.4f" % (tag, min_dcf08(sc, tg)))
        print("%sminDCF10: %.4f" % (tag, min_dcf10(sc, tg)))

    report("", np.asarray(scores), np.asarray(targets))
    # Per-subset splits (reference eval_plda_sre16.sh filters the pooled
    # score file by each language's trial list and re-scores).
    for spec in args.subset_trials:
        name, _, path = spec.partition("=")
        if not path:
            raise SystemExit("--subset-trials expects NAME=TRIALS, got %r" % spec)
        sub_pairs = set(map(tuple, read_trials(path)[0]))
        mask = np.array([tuple(p) in sub_pairs for p in trials], bool)
        if not mask.any():
            print("[%s] no trials matched %s" % (name, path))
            continue
        report(name, np.asarray(scores)[mask], np.asarray(targets)[mask])
        if args.scores:
            with open("%s.%s" % (args.scores, name), "w") as f:
                for (e, t), s, m in zip(trials, scores, mask):
                    if m:
                        f.write("%s %s %f\n" % (e, t, s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
