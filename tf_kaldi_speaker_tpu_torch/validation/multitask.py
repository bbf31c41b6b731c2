"""The multitask speaker + phone trainer through the port (a copy of
``scripts/multitask_validation.py``).

Trains the shared-trunk multitask model (128 wide, 64 pdfs) one epoch of
300 steps on 50 synthetic speakers with VAD and alignments, validates it,
and runs both predict heads. The record (``docs/VALIDATION.md:100-102``):
finite losses, and per-frame phone log-posteriors whose rows sum to 1
within 1e-4 (exit 1 otherwise).

Run: ``python -m tf_kaldi_speaker_tpu_torch.validation.multitask [--device
cuda] [--root DIR] [--write-doc]``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from ..cli._frontend import device_or_raise
from ..multitask import TrainerMultiTask
from ..utils.params import ParamsPlain
from ..utils.testdata import make_fake_data_dir
from .common import append_doc, card_name

NUM_PHONES = 64
SUM_TOL = 1e-4

# scripts/multitask_validation.py:17-62
CFG = dict(
    seed=0,
    tdnn_layer_size=128,
    num_nodes_pooling_layer=256,
    speaker_dim=128,
    phone_dim=128,
    pooling_type="statistics_pooling",
    embedding_node="zs_mu_dense",
    spk_loss_type="softmax",
    phn_loss_type="softmax",
    spk_loss_weight=1.0,
    phn_loss_weight=0.3,
    num_shared_layers=2,
    phone_kernel_size=[5, 5, 7, 1, 3],
    phone_layer_size=[128, 128, 128, 128, 128],
    phone_dilation_size=[1, 1, 1, 1, 4],
    phone_left_context=11,
    phone_right_context=11,
    speaker_left_context=7,
    speaker_right_context=7,
    num_frames_per_utt=8,
    learning_rate=0.02,
    optimizer="momentum",
    momentum=0.9,
    weight_l2_regularizer=1e-4,
    batchnorm_momentum=0.99,
    num_steps_per_epoch=300,
    show_training_progress=100,
    keep_checkpoint_max=2,
    save_checkpoints_steps=300,
    valid_max_iterations=3,
    num_parallel_datasets=2,
    max_queue_size=8,
    num_speakers_per_batch=32,
    num_segments_per_speaker=1,
    min_segment_len=150,
    max_segment_len=250,
    num_buckets=2,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--write-doc", action="store_true")
    args = p.parse_args(argv)
    device = device_or_raise(args.device)
    card = card_name(device)
    root = args.root or tempfile.mkdtemp(prefix="tfks_torch_mt_")
    d = make_fake_data_dir(
        os.path.join(root, "train"), num_speakers=50, utts_per_speaker=10,
        dim=30, min_len=300, max_len=500, with_vad_ali=True,
        num_phones=NUM_PHONES, seed=0,
    )
    t = TrainerMultiTask(ParamsPlain(**CFG), os.path.join(root, "exp", "nnet"), dim=30,
                         num_speakers=50, num_phones=NUM_PHONES, device=device)
    t.build("train", 30, num_speakers=50, num_phones=NUM_PHONES)
    t0 = time.time()
    t.train(d["data"], d["ali_dir"], d["spklist"], CFG["learning_rate"])
    dt = time.time() - t0
    steps = t.step
    print("mt train: %d steps in %.1fs" % (steps, dt), flush=True)

    t.build("valid", 30)
    spk_loss, phn_loss, emb, labels = t.valid(
        d["data"], d["ali_dir"], d["spklist"], output_embeddings=True)
    print("valid: spk %.4f phn %.4f (%d embeddings)" % (spk_loss, phn_loss, len(labels)),
          flush=True)
    t.build("predict", 30)
    x = np.random.RandomState(0).randn(200, 30).astype(np.float32)
    emb1 = t.predict_speaker(x)
    lp = t.predict_phone(x)
    sum_err = float(np.abs(np.exp(lp.astype(np.float64)).sum(-1) - 1).max())
    print("predict: spk emb %s, phone logpost %s (sum-to-one max err %.2e)"
          % (emb1.shape, lp.shape, sum_err), flush=True)
    ok = bool(np.isfinite(spk_loss) and np.isfinite(phn_loss) and sum_err <= SUM_TOL)
    text = ("\n## Multitask (speaker + phone) through the port\n\n"
            "Shared-trunk multitask model, %d steps in %.0f s: valid spk loss %.3f, phn loss "
            "%.3f; a %d-d speaker embedding and per-frame log-posteriors over %d pdfs (rows "
            "sum to 1 within %.1e; finite losses and %.0e required: %s). Card: %s.\n"
            % (steps, dt, spk_loss, phn_loss, emb1.shape[0], NUM_PHONES, sum_err, SUM_TOL,
               "PASS" if ok else "FAIL", card))
    print(text, flush=True)
    if args.write_doc:
        append_doc(text)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
