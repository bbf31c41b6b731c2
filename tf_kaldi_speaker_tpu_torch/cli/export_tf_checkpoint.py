"""Export a trained model dir as a reference-format TF1 checkpoint.

Counterpart of ``tf_kaldi_speaker_tpu/cli/export_tf_checkpoint.py`` with
the same arguments; it runs on the host (no device). Inverse of
``cli/import_tf_checkpoint.py``: a model trained in the port (``.pt``) or
in the JAX package (``.msgpack``, read by ``train/checkpoints.py``) becomes
restorable by the original tf-kaldi-speaker code (reference
model/trainer.py:142-166 Saver load; extraction via
egs/voxceleb/v1/nnet/lib/extract.py). Writes <out_dir>/{model-<step>.index,
model-<step>.data-*, checkpoint} plus the reference model-dir contract files
(config.json, feature_dim, num_speakers, num_phones) when available. Every
name is validated before anything is written: a refused export leaves
nothing in out_dir.

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.export_tf_checkpoint \\
        [--checkpoint last|best|<step>] [--momentum-slots] [--allow-partial] \\
        model_dir out_dir
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys

from ..convert import numpy_tree
from ..train import checkpoints
from ..train.tf_export import export_reference_checkpoint


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", default="last",
                        help="last | best | explicit step number")
    parser.add_argument("--momentum-slots", action="store_true",
                        help="also write zero Momentum slots so the "
                             "reference's training graph restores")
    parser.add_argument("--allow-partial", action="store_true",
                        help="exit 0 even when some variables have no "
                             "reference name (e.g. non-TDNN networks)")
    parser.add_argument("model_dir")
    parser.add_argument("out_dir")
    args = parser.parse_args(argv)

    nnet_dir = os.path.join(args.model_dir, "nnet")
    if not os.path.isdir(nnet_dir):
        nnet_dir = args.model_dir
    ckpt = args.checkpoint
    # Resolve read-only: exporting must not repoint the source model dir.
    step = checkpoints.select_checkpoint(
        nnet_dir, int(ckpt) if ckpt.lstrip("-").isdigit() else ckpt,
        write=False)
    raw, step = checkpoints.load_checkpoint(nnet_dir, step=step)
    params = numpy_tree(raw["params"])
    batch_stats = numpy_tree(raw.get("batch_stats", {}))

    prefix = os.path.join(args.out_dir, "model-%d" % step)
    # Validate the name mapping BEFORE writing anything: a failed export
    # must not leave a complete-looking checkpoint in out_dir.
    exported, skipped = export_reference_checkpoint(
        params, batch_stats, prefix, step=step,
        momentum_slots=args.momentum_slots, dry_run=True)
    print("Exported %d tensors -> %s (%d without reference names%s)"
          % (len(exported), prefix, len(skipped),
             ": " + ", ".join(skipped[:5]) + ", ..." if skipped else ""))
    if not exported:
        print("ERROR: nothing exported — unsupported network_type?",
              file=sys.stderr)
        return 1
    if skipped and not args.allow_partial:
        print("ERROR: %d variables have no reference TF name (rerun with "
              "--allow-partial to export anyway)" % len(skipped),
              file=sys.stderr)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)
    export_reference_checkpoint(
        params, batch_stats, prefix, step=step,
        momentum_slots=args.momentum_slots)
    for aux in ("config.json", "feature_dim", "num_speakers", "num_phones"):
        src = os.path.join(nnet_dir, aux)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(args.out_dir, aux))
    return 0


if __name__ == "__main__":
    sys.exit(main())
