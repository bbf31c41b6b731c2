"""Margin target-logit curves: psi(cos θ) per loss for tuning margins.

Counterpart of ``tf_kaldi_speaker_tpu/cli/target_logit_curve.py`` with the
same arguments, plus ``--device``. It replaces reference
misc/tuning/target_logit_curve.py (matplotlib plots) with a CSV dump:
columns cos_theta, asoftmax_m{1,2,4}, amsoftmax_m, arcsoftmax_m. The
A-softmax columns are the port's ``losses.asoftmax_phi`` on float32 tensors
on the device, as the JAX CLI computes them in float32 ``jax.numpy``; the
rest is numpy. With --lambda-curve it also dumps the λ-annealing schedule
and blend factor fa = 1/(1+λ) over training steps
(misc/tuning/asoftmax_lambda_tuning.m).

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.target_logit_curve \\
        [--amsoftmax-m 0.2] [--arcsoftmax-m 0.25] [--device cuda] \\
        [--lambda-curve lambda.csv --lambda-base 1000 --lambda-gamma 1e-5 \\
         --lambda-power 5 --lambda-min 10 --num-steps 1000000] out.csv
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..losses import asoftmax_phi
from ._frontend import device_or_raise


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--amsoftmax-m", type=float, default=0.2)
    parser.add_argument("--arcsoftmax-m", type=float, default=0.25)
    parser.add_argument("--lambda-curve", default="",
                        help="also dump the λ schedule to this CSV")
    parser.add_argument("--lambda-min", type=float, default=10.0)
    parser.add_argument("--lambda-base", type=float, default=1000.0)
    parser.add_argument("--lambda-gamma", type=float, default=1e-5)
    parser.add_argument("--lambda-power", type=float, default=5.0)
    parser.add_argument("--num-steps", type=int, default=1000000)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("out")
    args = parser.parse_args(argv)
    device = device_or_raise(args.device)

    cos = np.linspace(-1.0 + 1e-6, 1.0 - 1e-6, 401)
    cos32 = torch.tensor(cos, dtype=torch.float32, device=device)
    cols = {"cos_theta": cos}
    for m in (1, 2, 4):
        cols["asoftmax_m%d" % m] = asoftmax_phi(cos32, m).cpu().numpy()
    cols["amsoftmax_m%.2f" % args.amsoftmax_m] = cos - args.amsoftmax_m
    m = args.arcsoftmax_m
    sin = np.sqrt(np.maximum(1 - cos**2, 0))
    cosm = cos * np.cos(m) - sin * np.sin(m)
    cols["arcsoftmax_m%.2f" % m] = np.where(cos > np.cos(np.pi - m), cosm, -cosm - 2)

    names = list(cols)
    with open(args.out, "w") as f:
        f.write(",".join(names) + "\n")
        for i in range(len(cos)):
            f.write(",".join("%g" % cols[n][i] for n in names) + "\n")
    print("Wrote %s (%d rows)" % (args.out, len(cos)))

    if args.lambda_curve:
        # asoftmax_lambda_tuning.m: λ(step) and fa = 1/(1+λ), subsampled.
        steps = np.unique(
            np.linspace(0, args.num_steps, 2001).astype(np.int64)
        )
        lam = np.maximum(
            args.lambda_min,
            args.lambda_base * (1.0 + args.lambda_gamma * steps) ** (-args.lambda_power),
        )
        fa = 1.0 / (1.0 + lam)
        with open(args.lambda_curve, "w") as f:
            f.write("step,lambda,fa\n")
            for s, l, a in zip(steps, lam, fa):
                f.write("%d,%g,%g\n" % (s, l, a))
        print("Wrote %s (%d rows)" % (args.lambda_curve, len(steps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
