"""Per-frame bottleneck-feature extraction from a trained network.

Counterpart of ``tf_kaldi_speaker_tpu/cli/extract_bnf.py`` (the reference's
scripts/extract_bnf.sh) with the same arguments and outputs, plus
``--device`` (default ``cuda``): dump a FRAME-LEVEL endpoint of a trained
x-vector network as [T, D] matrices, one per input utterance, in float32 —
the auxiliary stream the multi-input trainer consumes (prepare it with
``cli.prepare_feats --no-cmvn``).

The input is edge-tiled by ``TDNN_TOTAL_CONTEXT // 2`` frames on both sides
before the forward, so frames [0:T] of the output align 1:1 with the input.
The JAX CLI zero-pads the tiled input to a length bucket so that jit
compiles few shapes; in eval mode frames [0:T] of the VALID-conv trunk do
not depend on that padding, so each utterance goes through at its own
length here.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.extract_bnf [--node tdnn5_relu] \\
        [--compress] [--device cuda] model_dir rspecifier wspecifier
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
import torch

from ..convert import network_from_variables
from ..kio import read_mat_rspec
from ..kio.ark import write_mat
from ..models import TDNN_TOTAL_CONTEXT
from ..train import checkpoints
from ..utils.params import Params
from ._frontend import device_or_raise


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--node", default="tdnn5_relu",
                        help="frame-level endpoint to dump (pre-pooling)")
    parser.add_argument("--compress", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("model_dir")
    parser.add_argument("rspecifier")
    parser.add_argument("wspecifier")
    args = parser.parse_args(argv)

    device = device_or_raise(args.device)
    nnet_dir = os.path.join(args.model_dir, "nnet")
    if not os.path.isdir(nnet_dir):
        nnet_dir = args.model_dir
    params = Params(os.path.join(nnet_dir, "config.json"))
    raw, step = checkpoints.load_checkpoint(nnet_dir)
    variables = {
        "params": raw["params"]["network"],
        "batch_stats": raw.get("batch_stats", {}).get("network", {}),
    }
    dim_path = os.path.join(nnet_dir, "feature_dim")
    dim = None
    if os.path.exists(dim_path):
        with open(dim_path) as f:
            dim = int(f.read().strip())
    net = network_from_variables(variables, params.dict,
                                 params.dict.get("network_type", "tdnn"), input_dim=dim)
    net = net.to(device)
    logging.info("BNF node %s from step %d", args.node, step)
    half = TDNN_TOTAL_CONTEXT // 2

    wspec = args.wspecifier
    head, _, rest = wspec.partition(":")
    ark_path, scp_path = rest, None
    if "scp" in head.split(","):
        ark_path, scp_path = rest.split(",", 1)

    count = 0
    scp_lines = []
    with open(ark_path, "wb") as fo, torch.inference_mode():
        for key, feature in read_mat_rspec(args.rspecifier):
            T = feature.shape[0]
            tiled = np.concatenate(
                [np.tile(feature[:1], (half, 1)), feature,
                 np.tile(feature[-1:], (half, 1))], axis=0).astype(np.float32)
            _, endpoints = net(torch.from_numpy(tiled[None]).to(device))
            if args.node not in endpoints:
                raise KeyError(args.node)
            # VALID convs drop TDNN_TOTAL_CONTEXT frames; the tiling put
            # them back, so frames [0:T] align 1:1 with the input.
            bnf = endpoints[args.node][0, :T].to(torch.float32).cpu().numpy()
            pos = fo.tell() + len(key) + 1
            write_mat(fo, bnf, key=key, compress=args.compress)
            scp_lines.append("%s %s:%d" % (key, ark_path, pos))
            count += 1
    if scp_path:
        with open(scp_path, "w") as f:
            f.write("\n".join(scp_lines) + "\n")
    logging.info("Extracted %d BNF matrices.", count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
