"""DET curve + operating points from a scores file.

Replaces the MATLAB DETware package (reference misc/DETware_v2.1:
Compute_DET/Plot_DET/Get_DCF/Min_DCF) and misc/tools/score_distribution.m:
writes the DET curve as (p_miss, p_fa) text points (plot with anything),
prints EER and minDCF08/10/12, and with --hist dumps normalized
target/nontarget score histograms ("center p_target p_nontarget" rows).

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.plot_det [--hist hist.txt] \
        scores.txt trials [det_out.txt]
scores.txt lines: "enroll test score"; trials: "enroll test target|nontarget".

Counterpart of ``tf_kaldi_speaker_tpu/cli/plot_det.py``, whole.
"""

from __future__ import annotations

import sys

import numpy as np

from ..backend import compute_eer, det_curve, min_dcf08, min_dcf10, min_dcf12


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    hist_out = None
    if "--hist" in argv:
        i = argv.index("--hist")
        hist_out = argv[i + 1]
        del argv[i : i + 2]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    scores_path, trials_path = argv[0], argv[1]
    det_out = argv[2] if len(argv) > 2 else None

    labels_map = {}
    with open(trials_path) as f:
        for line in f:
            p = line.split()
            if len(p) >= 3:
                labels_map[(p[0], p[1])] = 1 if p[2] == "target" else 0
    scores, labels = [], []
    with open(scores_path) as f:
        for line in f:
            p = line.split()
            key = (p[0], p[1])
            if key in labels_map:
                scores.append(float(p[2]))
                labels.append(labels_map[key])
    scores = np.asarray(scores)
    labels = np.asarray(labels)

    if det_out:
        p_miss, p_fa = det_curve(scores, labels)
        with open(det_out, "w") as f:
            for m, a in zip(p_miss, p_fa):
                f.write("%g %g\n" % (m, a))
    if hist_out:
        # score_distribution.m parity: 30-bin normalized histograms over a
        # shared grid so target/nontarget overlap is visible.
        edges = np.linspace(scores.min(), scores.max(), 31)
        centers = 0.5 * (edges[:-1] + edges[1:])
        h_t, _ = np.histogram(scores[labels == 1], bins=edges)
        h_n, _ = np.histogram(scores[labels == 0], bins=edges)
        h_t = h_t / max(h_t.sum(), 1)
        h_n = h_n / max(h_n.sum(), 1)
        with open(hist_out, "w") as f:
            for c, a, b in zip(centers, h_t, h_n):
                f.write("%g %g %g\n" % (c, a, b))
    eer, _ = compute_eer(scores, labels)
    print("EER: %.4f%%" % (eer * 100))
    print("minDCF08: %.4f" % min_dcf08(scores, labels))
    print("minDCF10: %.4f" % min_dcf10(scores, labels))
    print("minDCF12: %.4f" % min_dcf12(scores, labels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
