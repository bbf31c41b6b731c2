"""Transcode feature arks (Kaldi copy-feats equivalent).

Counterpart of ``tf_kaldi_speaker_tpu/cli/copy_feats.py``, on the port's own ``kio`` codec.

Typical uses: pre-transcode uncompressed arks to the compressed format the
fast partial-read training path wants, or decompress for inspection.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.copy_feats [--compress] \
        rspecifier wspecifier
    (wspecifier supports "ark:out.ark" and "ark,scp:out.ark,out.scp")
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..kio import read_mat_ark, read_mat_scp
from ..kio.ark import ArkScpWriter


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--compress", action="store_true")
    parser.add_argument("rspecifier")
    parser.add_argument("wspecifier")
    args = parser.parse_args(argv)

    reader = (
        read_mat_scp(args.rspecifier)
        if args.rspecifier.startswith("scp:")
        else read_mat_ark(args.rspecifier)
    )
    writer = ArkScpWriter(args.wspecifier, kind="mat")
    count = 0
    for key, mat in reader:
        writer.write(key, mat.astype("float32"), compress=args.compress)
        count += 1
    writer.close()
    logging.info("Copied %d matrices.", count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
