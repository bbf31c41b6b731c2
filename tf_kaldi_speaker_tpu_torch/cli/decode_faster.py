"""Native WFST decoding of phone-head log-likelihoods.

Replaces the external ``latgen-faster-mapped`` + ``lattice-best-path`` +
``int2sym.pl`` chain in the reference decode flow (reference
nnet/run_decode.sh:77-91, egs/fisher/v3/run_v1.sh:244-250): HCLG graph +
transition model + loglike matrices -> word-id vectors, optional
frame-level transition-id alignments, and text transcripts. Default mode
is Viterbi-best-path (decode-faster-mapped semantics); ``--lattice-out``
switches to lattice generation (latgen semantics), writing pruned
text-Lattice archives for scale sweeps / confidences via
cli.lattice_best_path.

Utterances decode in parallel: the native core releases the GIL, so a
thread pool scales across cores.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.decode_faster \
        --word-symbol-table graph/words.txt --text-out decode/text \
        final.mdl graph/HCLG.fst ark:loglike.ark ark:words.ark

Word/alignment wspecifiers are written in Kaldi binary form; human-readable
transcripts come from --text-out.

Counterpart of ``tf_kaldi_speaker_tpu/cli/decode_faster.py``, whole (numpy
only); ``tests/test_torch_decode.py`` holds it equal to the original.
"""

from __future__ import annotations

import argparse
import logging
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..kio import open_or_fd, read_mat_rspec, read_words_txt, write_vec_int
from ..kio.transition_model import read_transition_model
from ..backend.decoder import DecodeResult, WfstDecoder, native_available
from ..backend.lattice import (
    determinize_lattice,
    write_compact_lattice,
    write_lattice,
)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--acoustic-scale", type=float, default=0.1)
    parser.add_argument("--beam", type=float, default=13.0)
    parser.add_argument("--max-active", type=int, default=7000)
    parser.add_argument("--word-symbol-table", default=None,
                        help="words.txt for text output")
    parser.add_argument("--text-out", default=None,
                        help="write 'utt word...' transcripts here "
                        "(requires --word-symbol-table)")
    parser.add_argument("--align-out", default=None,
                        help="wspecifier for frame-level transition-id "
                        "alignments")
    parser.add_argument("--lattice-out", default=None,
                        help="also generate pruned lattices (latgen mode) "
                        "and write them here as a Kaldi text-Lattice "
                        "archive; words/alignments then come from the "
                        "lattice best path")
    parser.add_argument("--lattice-beam", type=float, default=8.0)
    parser.add_argument("--determinize-lattice", default="true",
                        choices=["true", "false"],
                        help="determinize on word labels and write "
                        "CompactLattices (latgen-faster-mapped default); "
                        "false writes raw state-level lattices")
    parser.add_argument("--num-threads", type=int, default=4)
    parser.add_argument("mdl", help="Kaldi final.mdl (transition model)")
    parser.add_argument("graph", help="HCLG.fst")
    parser.add_argument("rspecifier", help="loglike matrices")
    parser.add_argument("wspecifier", help="word-id int vectors")
    args = parser.parse_args(argv)

    tmodel = read_transition_model(args.mdl)
    # tid2pdf indexed from tid=1 (the decoder's convention); the model's
    # derived table carries an unused slot 0.
    tid2pdf = tmodel.tid2pdf[1:].astype(np.int32)
    decoder = WfstDecoder(
        args.graph, tid2pdf,
        acoustic_scale=args.acoustic_scale,
        beam=args.beam, max_active=args.max_active,
    )
    logging.info(
        "Loaded %s (%s core); %d transition-ids / %d pdfs.",
        args.graph, "native" if native_available() else "python",
        len(tid2pdf), tmodel.num_pdfs,
    )

    words_tab = (
        read_words_txt(args.word_symbol_table)
        if args.word_symbol_table else None
    )
    if args.text_out and words_tab is None:
        parser.error("--text-out requires --word-symbol-table")

    fp_words = open_or_fd(args.wspecifier, "wb")
    fp_align = open_or_fd(args.align_out, "wb") if args.align_out else None
    fp_text = open(args.text_out, "w") if args.text_out else None
    fp_lat = open(args.lattice_out, "w") if args.lattice_out else None
    determinize = args.determinize_lattice == "true"

    def decode_one(loglikes):
        if fp_lat is None:
            return decoder.decode(loglikes), None
        # Lattice mode: one decode yields the lattice AND (via its best
        # path at the decode scales) the words/alignment outputs.
        lat, partial = decoder.decode_lattice(
            loglikes, lattice_beam=args.lattice_beam)
        words, align, cost = lat.best_path(
            acoustic_scale=args.acoustic_scale, lm_scale=1.0)
        return DecodeResult(
            words=np.asarray(words, np.int32),
            alignment=np.asarray(align, np.int32),
            cost=cost, partial=partial,
        ), lat

    n_ok = n_partial = n_fail = 0
    total_frames = 0
    total_cost = 0.0
    with ThreadPoolExecutor(max_workers=max(1, args.num_threads)) as pool:
        # Bounded pipeline: decode up to 2*threads utterances ahead of the
        # (ordered) writer so output stays deterministic.
        pending = []
        def flush(limit):
            nonlocal n_ok, n_partial, n_fail, total_frames, total_cost
            while len(pending) > limit:
                key, frames, fut = pending.pop(0)
                try:
                    res, lat = fut.result()
                except Exception as e:
                    # Kaldi's decoders warn and continue on a failed
                    # utterance (beam collapse etc.); one bad utterance
                    # must not lose the rest of the split.
                    logging.warning("%s: decode failed (%s); skipped", key, e)
                    n_fail += 1
                    continue
                write_vec_int(fp_words, res.words, key=key)
                if fp_lat is not None:
                    if determinize:
                        try:
                            write_compact_lattice(
                                fp_lat,
                                determinize_lattice(
                                    lat,
                                    acoustic_scale=args.acoustic_scale,
                                    lm_scale=1.0,
                                ),
                                key,
                            )
                        except ValueError as e:
                            # Kaldi falls back to the raw lattice when
                            # determinization blows up.
                            logging.warning(
                                "%s: determinization failed (%s); "
                                "writing raw lattice", key, e)
                            write_lattice(fp_lat, lat, key)
                    else:
                        write_lattice(fp_lat, lat, key)
                if fp_align is not None:
                    write_vec_int(fp_align, res.alignment, key=key)
                if fp_text is not None:
                    fp_text.write(
                        "%s %s\n"
                        % (key, " ".join(
                            words_tab.get(int(w), "<unk#%d>" % w)
                            for w in res.words))
                    )
                if res.partial:
                    n_partial += 1
                    logging.warning("%s: partial path (no final state)", key)
                else:
                    n_ok += 1
                total_frames += frames
                total_cost += res.cost

        for key, loglikes in read_mat_rspec(args.rspecifier):
            pending.append(
                (key, loglikes.shape[0],
                 pool.submit(decode_one, loglikes.astype(np.float32)))
            )
            flush(2 * args.num_threads)
        flush(0)

    fp_words.close()
    if fp_align is not None:
        fp_align.close()
    if fp_text is not None:
        fp_text.close()
    if fp_lat is not None:
        fp_lat.close()
    n = n_ok + n_partial
    logging.info(
        "Decoded %d utterances (%d partial, %d failed), %d frames, "
        "avg cost/frame %.4f.",
        n, n_partial, n_fail, total_frames,
        total_cost / max(1, total_frames),
    )
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())
