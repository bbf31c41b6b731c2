"""Serve x-vector embeddings over TCP with dynamic micro-batching.

Counterpart of ``tf_kaldi_speaker_tpu/cli/serve.py`` with the same flags,
plus ``--device``.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.serve --port 8021 \
        [--batch-size 32] [--max-wait-ms 5] [--device cuda] model_dir
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..extract.server import EmbeddingServer
from ._frontend import device_or_raise


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8021)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--max-wait-ms", type=float, default=5.0)
    parser.add_argument("--node", default="")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("model_dir")
    args = parser.parse_args(argv)
    server = EmbeddingServer(
        args.model_dir, host=args.host, port=args.port,
        batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
        node=args.node or None, device=device_or_raise(args.device),
    )
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
