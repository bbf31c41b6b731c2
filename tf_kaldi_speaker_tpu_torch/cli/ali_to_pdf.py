"""ali-to-pdf: map transition-id alignments to pdf-ids, without Kaldi.

A copy of ``tf_kaldi_speaker_tpu/cli/ali_to_pdf.py`` on the port's ``kio``
(host work only; no ``--device``). It replaces the external ``ali-to-pdf``
binary the reference shells out to
(scripts/prepare_pdf_for_multitask_egs.sh:20) using the native transition
model parser (kio/transition_model.py). With ``--num-pdfs-out`` it also writes the
model's pdf count (the multitask loaders read ``<dir>/num_pdfs``), replacing
the ``tree-info`` shell-out
(dataset/multitask/data_loader_v2.py:228).

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.ali_to_pdf final.mdl \
        "ark:gunzip -c exp/tri5a/ali.*.gz |" ark,scp:pdf.ark,pdf.scp
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from ..kio.ark import open_or_fd, read_vec_int_ark, write_vec_int
from ..kio.transition_model import read_transition_model


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--num-pdfs-out", default="",
        help="also write the model's pdf count to this file (replaces the "
             "tree-info shell-out; multitask loaders read '<dir>/num_pdfs')",
    )
    parser.add_argument("model", help="Kaldi .mdl (binary or text)")
    parser.add_argument("ali_rspecifier", help="transition-id alignments (int vectors)")
    parser.add_argument("pdf_wspecifier", help="ark[,scp]:<path>[,<scp>]")
    args = parser.parse_args(argv)

    tm = read_transition_model(args.model)
    logging.info(
        "Transition model: %d phones, %d transition-ids, %d pdfs",
        len(tm.phones), tm.num_transition_ids, tm.num_pdfs,
    )

    wspec = args.pdf_wspecifier
    head, _, rest = wspec.partition(":")
    kinds = head.split(",")
    ark_path, scp_path = rest, None
    if "scp" in kinds:
        ark_path, scp_path = rest.split(",", 1)

    n = 0
    scp_lines = []
    with open(ark_path, "wb") as fo:
        for key, ali in read_vec_int_ark(args.ali_rspecifier):
            pdf = tm.ali_to_pdf(ali).astype(np.int32)
            pos = fo.tell() + len(key) + 1
            write_vec_int(fo, pdf, key=key)
            scp_lines.append("%s %s:%d" % (key, ark_path, pos))
            n += 1
    if scp_path:
        with open(scp_path, "w") as f:
            f.write("\n".join(scp_lines) + "\n")
    if args.num_pdfs_out:
        with open(args.num_pdfs_out, "w") as f:
            f.write("%d\n" % tm.num_pdfs)
    logging.info("Converted %d alignments.", n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
