"""Embedding extraction CLI: ark/pipe in -> ark of x-vectors out.

Counterpart of ``tf_kaldi_speaker_tpu/cli/extract.py`` with the same flags,
plus ``--device``. ``--cmvn`` and ``--vad`` replace Kaldi's feature pipe
``apply-cmvn-sliding ... | select-voiced-frames ... |``; ``--device-pipe``
ships raw compressed-ark codes and runs dequantize + CMVN + VAD +
voiced-frame compaction + forward on the device.

``--exact-long`` embeds utterances longer than ``--chunk-size`` exactly
(``Extractor.embed_long_exact``: streamed sums of the TDNN's frame layers)
instead of averaging 50%-overlap chunk embeddings.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.extract [--device-pipe] \
        [--cmvn] [--vad] [--normalize] [--exact-long] [--device cuda] \
        model_dir scp:feats.scp ark,scp:xvector.ark,xvector.scp
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import torch

from ..extract.device_pipe import DevicePipeExtractor
from ..extract.extractor import Extractor
from ..kio import ArkScpWriter, decode_cm_codes, read_codes_scp, read_mat_rspec
from ..ops.cmvn import sliding_cmvn_masked
from ..ops.vad import compute_vad_energy_masked
from ._frontend import device_or_raise


def apply_cmvn_vad(feature: np.ndarray, cmvn: bool, vad: bool,
                   cmn_window: int = 300) -> np.ndarray:
    """Host feature pipe in the reference's order
    (run_extract_embeddings.sh:47): sliding CMVN over all frames, then
    select-voiced-frames with decisions from the RAW features. Runs the
    batch ops of ops/cmvn.py and ops/vad.py on a CPU batch of one.

    Returns the processed features ([0, D] if VAD removes everything)."""
    raw = torch.from_numpy(np.ascontiguousarray(feature, np.float32))[None]
    lengths = torch.tensor([raw.shape[1]])
    out = raw
    if cmvn:
        out = sliding_cmvn_masked(raw, lengths, window=cmn_window)
    if vad:
        voiced = compute_vad_energy_masked(raw, lengths)
        out = out[voiced]
    return out.reshape(-1, raw.shape[2]).numpy()


def _main_device_pipe(args) -> int:
    """--device-pipe: raw CM codes in, the pipe on the device. Utterances
    longer than chunk_size go through the host pipe and the 50%-overlap
    (or, with --exact-long, the exact) long path."""
    kind, _, path = args.rspecifier.partition(":")
    if kind != "scp" or not path:
        raise SystemExit(
            "--device-pipe requires an 'scp:...' rspecifier of compressed "
            "arks (feature pipes must use the host path)")
    extractor = DevicePipeExtractor(
        args.model_dir,
        cmvn=args.cmvn,
        vad=args.vad,
        cmn_window=args.cmn_window,
        node=args.node or None,
        batch_size=args.batch_size,
        chunk_size=args.chunk_size,
        min_chunk_size=args.min_chunk_size,
        normalize=args.normalize,
        device=args.device,
    )
    longs = []

    def short_stream():
        for key, codes, headers in read_codes_scp(path):
            if codes.shape[0] > args.chunk_size:
                longs.append((key, codes, headers))  # host path below
            else:
                yield key, codes, headers

    writer = ArkScpWriter(args.wspecifier, kind="vec")
    count = 0
    for key, embedding in extractor.embed_codes_stream(short_stream()):
        writer.write(key, embedding.astype("float32"))
        count += 1
    for key, codes, headers in longs:
        feature = apply_cmvn_vad(
            decode_cm_codes(codes, headers), args.cmvn, args.vad,
            cmn_window=args.cmn_window,
        )
        if feature.shape[0] < args.min_chunk_size:
            logging.info("Key %s length too short after pipe, skip.", key)
            continue
        if args.exact_long and feature.shape[0] > args.chunk_size:
            embedding = extractor.embed_long_exact(feature)
        else:
            embedding = extractor.embed_utterance(feature)
        writer.write(key, embedding.astype("float32"))
        count += 1
    writer.close()
    logging.info("Extracted %d embeddings.", count)
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--node", default="", help="embedding node override")
    parser.add_argument("--normalize", action="store_true", help="L2-normalize output")
    parser.add_argument("--chunk-size", type=int, default=10000)
    parser.add_argument("--min-chunk-size", type=int, default=25)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--cmvn", action="store_true", help="sliding CMVN (window 300)")
    parser.add_argument("--cmn-window", type=int, default=300)
    parser.add_argument("--vad", action="store_true", help="energy VAD frame selection")
    parser.add_argument(
        "--exact-long", action="store_true",
        help="EXACT embeddings for utterances > chunk-size via streamed "
             "pooled-stats accumulation (default: reference-parity "
             "50%%-overlap chunk averaging)",
    )
    parser.add_argument(
        "--device-pipe", action="store_true",
        help="decode-on-device input path: ship raw CM codes (1 B/element) "
             "and run dequantize + CMVN + VAD + voiced-frame compaction on "
             "the device (requires 'scp:' of compressed arks, no pipes)",
    )
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("model_dir")
    parser.add_argument("rspecifier")
    parser.add_argument("wspecifier")
    args = parser.parse_args(argv)
    args.device = device_or_raise(args.device)

    if args.device_pipe:
        return _main_device_pipe(args)

    extractor = Extractor(
        args.model_dir,
        node=args.node or None,
        batch_size=args.batch_size,
        chunk_size=args.chunk_size,
        min_chunk_size=args.min_chunk_size,
        normalize=args.normalize,
        device=args.device,
    )

    def stream():
        for key, feature in read_mat_rspec(args.rspecifier):
            feature = apply_cmvn_vad(
                feature, args.cmvn, args.vad, cmn_window=args.cmn_window
            )
            if feature.shape[0] == 0:
                logging.info("Key %s: no voiced frames, skip.", key)
                continue
            yield key, feature

    def embedding_stream():
        if not args.exact_long:
            yield from extractor.embed_stream(stream())
            return
        # long utterances through the exact path as they come, the rest batched
        shorts = []
        for key, feature in stream():
            if feature.shape[0] > args.chunk_size:
                yield key, extractor.embed_long_exact(feature)
            else:
                shorts.append((key, feature))
        yield from extractor.embed_stream(iter(shorts))

    writer = ArkScpWriter(args.wspecifier, kind="vec")
    count = 0
    for key, embedding in embedding_stream():
        # --normalize is applied inside the Extractor (per chunk + final L2)
        writer.write(key, embedding.astype("float32"))
        count += 1
    writer.close()
    logging.info("Extracted %d embeddings.", count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
