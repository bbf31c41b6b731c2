"""Best paths through decoded lattices at chosen scales, plus WER sweeps.

The reason Kaldi recipes keep lattices: re-scoring at different
acoustic/LM scales without re-decoding (``lattice-scale`` +
``lattice-best-path`` inside the egs ``local/score.sh`` sweep). This does
both natively over the text-Lattice archives ``cli.decode_faster
--lattice-out`` writes:

    # single scale -> words/alignments/transcripts
    python -m tf_kaldi_speaker_tpu_torch.cli.lattice_best_path \
        --acoustic-scale 0.1 --word-symbol-table words.txt \
        --text-out text lat.txt ark:words.ark
    # sweep 1/lmwt for lmwt in 7..17 against a reference text -> best WER
    ... --sweep-lmwt 7:17 --ref-text data/text ...

Counterpart of ``tf_kaldi_speaker_tpu/cli/lattice_best_path.py``, whole
(numpy only); ``tests/test_torch_decode.py`` holds it equal to the
original.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from ..backend.lattice import read_lattice_ark
from ..backend.wer import compute_wer, filter_transcripts, read_text_file
from ..kio import open_or_fd, read_words_txt, write_vec_int


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--acoustic-scale", type=float, default=0.1)
    parser.add_argument("--lm-scale", type=float, default=1.0)
    parser.add_argument("--word-symbol-table", default=None)
    parser.add_argument("--text-out", default=None,
                        help="transcripts at the chosen (or best-sweep) "
                        "scales (requires --word-symbol-table)")
    parser.add_argument("--align-out", default=None,
                        help="wspecifier for transition-id alignments")
    parser.add_argument("--confidence-out", default=None,
                        help="write 'utt word:posterior ...' per-word "
                        "confidences (lattice forward-backward; requires "
                        "--word-symbol-table)")
    parser.add_argument("--sweep-lmwt", default=None, metavar="LO:HI",
                        help="score acoustic-scale=1/lmwt for each integer "
                        "lmwt in [LO, HI] against --ref-text and keep the "
                        "best (the local/score.sh sweep)")
    parser.add_argument("--word-ins-penalty", default="0.0",
                        help="comma list of word insertion penalties added "
                        "to word-emitting arcs after scaling "
                        "(lattice-add-penalty; score.sh sweeps 0.0,0.5,1.0)."
                        " Swept jointly with --sweep-lmwt; otherwise the "
                        "first value is applied")
    parser.add_argument("--filter-words", default=None,
                        help="comma list of tokens stripped from ref AND "
                        "hyp before WER (the wer_output_filter hook, e.g. "
                        "'<NOISE>,<SPOKEN_NOISE>,<UNK>')")
    parser.add_argument("--ref-text", default=None,
                        help="reference transcripts for --sweep-lmwt")
    parser.add_argument("lattice_ark", help="text-Lattice archive")
    parser.add_argument("wspecifier", help="word-id int vectors")
    args = parser.parse_args(argv)

    words_tab = (
        read_words_txt(args.word_symbol_table)
        if args.word_symbol_table else None
    )
    if args.text_out and words_tab is None:
        parser.error("--text-out requires --word-symbol-table")
    if args.sweep_lmwt and not (args.ref_text and words_tab):
        parser.error("--sweep-lmwt requires --ref-text and "
                     "--word-symbol-table")

    lats = list(read_lattice_ark(args.lattice_ark))
    if lats:
        # analyze_lats.sh headline diagnostic
        from ..backend.lattice import depth_stats

        means = [depth_stats(lat)[0] for _, lat in lats]
        logging.info("Read %d lattices (mean depth %.2f arcs/frame).",
                     len(lats), float(np.mean(means)))
    else:
        logging.info("Read 0 lattices.")

    try:
        penalties = [float(x) for x in args.word_ins_penalty.split(",")]
    except ValueError:
        parser.error("--word-ins-penalty expects comma-separated floats")
    filter_words = (args.filter_words.split(",")
                    if args.filter_words else [])

    def transcripts(acoustic_scale, lm_scale, wip):
        out = {}
        for key, lat in lats:
            w, a, c = lat.best_path(acoustic_scale=acoustic_scale,
                                    lm_scale=lm_scale,
                                    word_ins_penalty=wip)
            out[key] = (w, a, c)
        return out

    if args.sweep_lmwt:
        try:
            lo, hi = (int(x) for x in args.sweep_lmwt.split(":"))
        except ValueError:
            parser.error("--sweep-lmwt expects LO:HI integers")
        if lo < 1 or hi < lo:
            parser.error("--sweep-lmwt needs 1 <= LO <= HI (got %s)"
                         % args.sweep_lmwt)
        refs = read_text_file(args.ref_text)
        if filter_words:
            refs = filter_transcripts(refs, filter_words)
        best = None
        for wip in penalties:
            for lmwt in range(lo, hi + 1):
                res = transcripts(1.0 / lmwt, args.lm_scale, wip)
                hyp = {k: [words_tab.get(int(w), "<unk#%d>" % w)
                           for w in v[0]] for k, v in res.items()}
                if filter_words:
                    hyp = filter_transcripts(hyp, filter_words)
                stats = compute_wer(refs, hyp)
                logging.info("lmwt %d wip %g: %%WER %.2f",
                             lmwt, wip, stats.wer)
                if best is None or stats.wer < best[2]:
                    best = (lmwt, wip, stats.wer, res)
        lmwt, wip, wer, res = best
        print("best lmwt %d wip %g: %%WER %.2f" % (lmwt, wip, wer))
    else:
        res = transcripts(args.acoustic_scale, args.lm_scale, penalties[0])

    fp_words = open_or_fd(args.wspecifier, "wb")
    fp_align = open_or_fd(args.align_out, "wb") if args.align_out else None
    fp_text = open(args.text_out, "w") if args.text_out else None
    for key, (w, a, c) in res.items():
        write_vec_int(fp_words, np.asarray(w, np.int32), key=key)
        if fp_align is not None:
            write_vec_int(fp_align, np.asarray(a, np.int32), key=key)
        if fp_text is not None:
            fp_text.write("%s %s\n" % (
                key, " ".join(words_tab.get(int(x), "<unk#%d>" % x)
                              for x in w)))
    fp_words.close()
    if fp_align is not None:
        fp_align.close()
    if fp_text is not None:
        fp_text.close()

    if args.confidence_out:
        if words_tab is None:
            parser.error("--confidence-out requires --word-symbol-table")
        from ..backend.lattice import best_path_confidences

        scale = (1.0 / best[0]) if args.sweep_lmwt else args.acoustic_scale
        wip = best[1] if args.sweep_lmwt else penalties[0]
        with open(args.confidence_out, "w") as fd:
            for key, lat in lats:
                conf = best_path_confidences(
                    lat, acoustic_scale=scale, lm_scale=args.lm_scale,
                    word_ins_penalty=wip)
                fd.write("%s %s\n" % (key, " ".join(
                    "%s:%.4f" % (words_tab.get(int(w), "<unk#%d>" % w), c)
                    for w, c in conf)))
    return 0 if res else 1


if __name__ == "__main__":
    sys.exit(main())
