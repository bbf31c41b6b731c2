"""ARPA LM rescoring of lattice archives.

Native replacement for the reference's scripts/lmrescore_const_arpa.sh
(lattice-lmrescore --lm-scale=-1 oldlm + lattice-lmrescore-const-arpa
newlm): subtract the decoding LM's scores from the lattice graph costs and
add a (usually bigger) rescoring LM's, without re-decoding.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.lmrescore \
        --word-symbol-table graph/words.txt \
        --old-arpa lm_small.arpa --new-arpa lm_big.arpa[.gz] \
        in_lat.txt out_lat.txt

Input lattices may be raw (state-level) or compact; they are determinized
on word labels first (composition needs word determinism), and the output
is a CompactLattice text archive. Omit --old-arpa to only ADD the new LM
(lattice-lmrescore-const-arpa alone); --old-scale/--new-scale override the
default -1/+1 replacement.

Counterpart of ``tf_kaldi_speaker_tpu/cli/lmrescore.py``, whole (numpy
only); ``tests/test_torch_lattice.py`` holds it equal to the original.
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..backend.arpa import ArpaLm
from ..backend.lattice import (
    determinize_lattice,
    read_lattice_ark,
    write_compact_lattice,
)
from ..backend.lmrescore import lmrescore_compact
from ..kio import read_words_txt


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--word-symbol-table", required=True)
    parser.add_argument("--new-arpa", required=True, help="rescoring LM")
    parser.add_argument("--old-arpa", default=None,
                        help="decoding LM to subtract (omit to only add)")
    parser.add_argument("--new-scale", type=float, default=1.0)
    parser.add_argument("--old-scale", type=float, default=-1.0)
    parser.add_argument("--acoustic-scale", type=float, default=0.1,
                        help="scale for determinization comparisons only")
    parser.add_argument("lattice_in", help="text lattice archive")
    parser.add_argument("lattice_out", help="CompactLattice text archive")
    args = parser.parse_args(argv)

    id2word = read_words_txt(args.word_symbol_table)
    new_lm = ArpaLm.load(args.new_arpa)
    old_lm = ArpaLm.load(args.old_arpa) if args.old_arpa else None

    n = 0
    with open(args.lattice_out, "w") as fo:
        for key, lat in read_lattice_ark(args.lattice_in):
            clat = determinize_lattice(
                lat, acoustic_scale=args.acoustic_scale)
            res = lmrescore_compact(
                clat, id2word, new_lm, old_lm,
                new_scale=args.new_scale, old_scale=args.old_scale,
            )
            write_compact_lattice(fo, res, key)
            n += 1
    logging.info("Rescored %d lattices -> %s", n, args.lattice_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
