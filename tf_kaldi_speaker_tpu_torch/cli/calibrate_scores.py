"""Score calibration CLI: train an affine LLR map on dev, apply to eval.

Beyond-reference (the reference stack stops at minDCF — see
backend/calibration.py). Reads the 3-column score files written by
``cli.score --scores`` ("enroll test score") plus Kaldi trials files, trains
BOSARIS-style linear logistic regression on the dev split, reports
Cllr / minCllr / actDCF vs minDCF on eval before and after calibration, and
optionally writes the calibrated eval scores.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.calibrate_scores \
        --dev-scores dev_scores.txt --dev-trials dev_trials \
        --eval-scores eval_scores.txt --eval-trials eval_trials \
        --prior 0.5 --operating-point 0.01,1,1 --operating-point 0.001,1,1 \
        --calibrated-out eval_scores_cal.txt

Counterpart of ``tf_kaldi_speaker_tpu/cli/calibrate_scores.py``, whole.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Tuple

import numpy as np

from ..backend.calibration import (
    actual_dcf,
    apply_calibration,
    cllr,
    logistic_calibration,
    min_cllr,
)
from ..backend.metrics import compute_eer, compute_min_dcf
from ..backend.scoring import read_trials


def _read_scores(path: str) -> Dict[Tuple[str, str], float]:
    out: Dict[Tuple[str, str], float] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            out[(parts[0], parts[1])] = float(parts[2])
    if not out:
        raise SystemExit("no scores parsed from %s" % path)
    return out


def _align(scores_path: str, trials_path: str) -> Tuple[np.ndarray, np.ndarray, List[Tuple[str, str]]]:
    """Match score lines to trial labels by (enroll, test) pair."""
    smap = _read_scores(scores_path)
    pairs, labels = read_trials(trials_path)
    sc, lb, kept = [], [], []
    missing = 0
    for p, l in zip(pairs, labels):
        if p in smap:
            sc.append(smap[p])
            lb.append(l)
            kept.append(p)
        else:
            missing += 1
    if missing:
        print("warning: %d/%d trials have no score in %s"
              % (missing, len(pairs), scores_path), file=sys.stderr)
    if not sc:
        raise SystemExit("no trial matched a score line (%s vs %s)"
                         % (trials_path, scores_path))
    return np.asarray(sc, np.float64), np.asarray(lb, np.int32), kept


def _op_point(spec: str) -> Tuple[float, float, float]:
    parts = spec.split(",")
    if len(parts) == 1:
        return float(parts[0]), 1.0, 1.0
    if len(parts) != 3:
        raise SystemExit("--operating-point expects P_TARGET[,C_MISS,C_FA], got %r" % spec)
    return float(parts[0]), float(parts[1]), float(parts[2])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dev-scores", required=True,
                        help="held-out score file to train calibration on")
    parser.add_argument("--dev-trials", required=True)
    parser.add_argument("--eval-scores", required=True)
    parser.add_argument("--eval-trials", required=True)
    parser.add_argument("--prior", type=float, default=0.5,
                        help="effective target prior for the training objective")
    parser.add_argument("--operating-point", action="append", default=[],
                        help="P_TARGET[,C_MISS,C_FA] for actDCF/minDCF report "
                             "(repeatable; defaults: 0.01 and 0.001 — the "
                             "NIST SRE10 and DCF10 points)")
    parser.add_argument("--calibrated-out", default=None,
                        help="write calibrated eval scores (LLRs) here")
    args = parser.parse_args(argv)

    dev_s, dev_l, _ = _align(args.dev_scores, args.dev_trials)
    ev_s, ev_l, ev_pairs = _align(args.eval_scores, args.eval_trials)

    a, b = logistic_calibration(dev_s, dev_l, prior=args.prior)
    print("calibration: llr = %.6f * score + %.6f (trained at prior %g on %d dev trials)"
          % (a, b, args.prior, dev_s.size))
    if a <= 0:
        print("warning: non-positive slope — dev scores are anti-discriminative",
              file=sys.stderr)

    ev_cal = apply_calibration(ev_s, a, b)
    eer, _ = compute_eer(ev_s, ev_l)
    print("eval EER: %.4f%% (calibration-invariant)" % (eer * 100.0))
    print("eval Cllr raw-as-llr: %.4f   minCllr: %.4f   Cllr calibrated: %.4f"
          % (cllr(ev_s, ev_l), min_cllr(ev_s, ev_l), cllr(ev_cal, ev_l)))

    ops = [_op_point(s) for s in args.operating_point] or [(0.01, 1.0, 1.0),
                                                           (0.001, 1.0, 1.0)]
    for p_t, c_m, c_f in ops:
        mind, _ = compute_min_dcf(ev_s, ev_l, p_target=p_t, c_miss=c_m, c_fa=c_f)
        actd = actual_dcf(ev_cal, ev_l, p_target=p_t, c_miss=c_m, c_fa=c_f)
        print("p_target=%g c_miss=%g c_fa=%g: minDCF %.4f  actDCF %.4f  "
              "(calibration loss %+.4f)" % (p_t, c_m, c_f, mind, actd, actd - mind))

    if args.calibrated_out:
        with open(args.calibrated_out, "w") as f:
            for (e, t), s in zip(ev_pairs, ev_cal):
                f.write("%s %s %f\n" % (e, t, s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
