"""WER scoring CLI (Kaldi ``compute-wer`` equivalent).

Closes the decode-and-score loop natively: reference text + decoded text
(from cli.decode_faster --text-out) -> %WER/%SER report, same output shape
as the Kaldi binary the reference's scoring scripts parse.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.compute_wer ref_text hyp_text

Counterpart of ``tf_kaldi_speaker_tpu/cli/compute_wer.py``, whole (numpy
only); ``tests/test_torch_decode.py`` holds it equal to the original.
"""

from __future__ import annotations

import argparse
import sys

from ..backend.wer import compute_wer, filter_transcripts, read_text_file


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--filter-words", default=None,
                        help="comma list of tokens stripped from ref AND "
                        "hyp before scoring (the wer_output_filter hook, "
                        "e.g. '<NOISE>,<SPOKEN_NOISE>,<UNK>')")
    parser.add_argument("ref", help="reference transcripts (utt word ...)")
    parser.add_argument("hyp", help="hypothesis transcripts")
    args = parser.parse_args(argv)
    refs, hyps = read_text_file(args.ref), read_text_file(args.hyp)
    if args.filter_words:
        drop = args.filter_words.split(",")
        refs = filter_transcripts(refs, drop)
        hyps = filter_transcripts(hyps, drop)
    stats = compute_wer(refs, hyps)
    print(stats.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
