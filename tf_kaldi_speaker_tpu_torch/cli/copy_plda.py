"""Copy / convert / smooth a PLDA model (ivector-copy-plda equivalent).

Replaces Kaldi's ``ivector-copy-plda`` as the reference recipes use it
(egs/voxceleb/v1/run.sh:398 applies ``--smoothing=0.0`` before scoring;
``--binary=false`` converts to text for inspection).  Reads any of the
three formats ``backend.Plda`` understands (npz / Kaldi binary / Kaldi
text, auto-sniffed) and writes the requested one — the interop bridge
that lets an existing Kaldi-trained ``plda`` file score here, and a
backend trained here feed Kaldi tooling.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.copy_plda \
        [--smoothing 0.0] [--format kaldi|kaldi_text|npz] in_plda out_plda

Counterpart of ``tf_kaldi_speaker_tpu/cli/copy_plda.py``, whole.
"""

from __future__ import annotations

import argparse

from ..backend.plda import Plda


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--smoothing", type=float, default=0.0,
                        help="SmoothWithinClassCovariance factor "
                             "(ivector-copy-plda --smoothing)")
    parser.add_argument("--format", choices=["kaldi", "kaldi_text", "npz"],
                        default="kaldi",
                        help="output format (kaldi = binary object file, "
                             "what ivector-copy-plda --binary=true writes)")
    parser.add_argument("in_plda")
    parser.add_argument("out_plda")
    args = parser.parse_args(argv)

    plda = Plda.load(args.in_plda)
    if args.smoothing != 0.0:
        plda = plda.smooth_within_class_covariance(args.smoothing)
    plda.save(args.out_plda, format=args.format)
    print("copied %s -> %s (dim %d, format %s%s)" % (
        args.in_plda, args.out_plda, plda.dim, args.format,
        ", smoothing %g" % args.smoothing if args.smoothing else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
