"""Attention pooling + AAM-softmax + PLDA through the port (a copy of
``scripts/attention_validation.py``).

Trains a 4-head attention-pooled x-vector with ArcFace m=0.25 in bf16 from
the streaming loader with ``device_decode`` (500 steps at batch 64) on the
separable corpus (100 speakers, dim 30), extracts 40 held-out speakers and
scores them with cosine and PLDA. The record (``docs/VALIDATION.md:96-98``)
is 0.00% on both; this run fails at 5% (the gate of the ECAPA and ResNet34
scripts).

Run: ``python -m tf_kaldi_speaker_tpu_torch.validation.attention [--device
cuda] [--root DIR] [--write-doc]``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from ..backend import compute_cos_pairwise_eer
from ..cli._frontend import device_or_raise
from ..extract.extractor import Extractor
from ..train.trainer import Trainer
from ..utils.params import ParamsPlain
from ..utils.testdata import make_fake_data_dir
from .common import append_doc, card_name, write_nnet_files
from .synthetic import embed_data_dir, plda_eer

# scripts/attention_validation.py:29-79
CFG = dict(
    seed=0,
    network_type="tdnn",
    tdnn_layer_size=128,
    num_nodes_pooling_layer=256,
    num_nodes_last_layer=128,
    pooling_type="self_attention",
    att_key_input="tdnn5_relu",
    att_key_num_nodes=[64, 32],
    att_key_network_type=2,
    att_value_input="tdnn5_relu",
    att_value_num_nodes=[],
    att_value_network_type=0,
    att_num_heads=4,
    att_split_key=False,
    att_use_scale=True,
    att_apply_nonlinear=False,
    att_penalty_term=0.1,
    embedding_node="tdnn6_dense",
    last_layer_linear=True,
    loss_func="additive_angular_margin_softmax",
    arcsoftmax_m=0.25,
    arcsoftmax_lambda_min=0,
    arcsoftmax_lambda_base=1000,
    arcsoftmax_lambda_gamma=0.001,
    arcsoftmax_lambda_power=4,
    compute_dtype="bfloat16",
    learning_rate=0.02,
    optimizer="momentum",
    momentum=0.9,
    clip_gradient=True,
    clip_gradient_norm=3.0,
    weight_l2_regularizer=1e-4,
    batchnorm_momentum=0.99,
    num_steps_per_epoch=500,
    show_training_progress=100,
    keep_checkpoint_max=2,
    save_checkpoints_steps=500,
    save_summary_steps=100,
    valid_max_iterations=3,
    num_parallel_datasets=2,
    max_queue_size=8,
    num_speakers_per_batch=64,
    num_segments_per_speaker=1,
    min_segment_len=150,
    max_segment_len=300,
    num_buckets=2,
    device_decode=True,
)
GATE = 0.05


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--write-doc", action="store_true")
    args = p.parse_args(argv)
    device = device_or_raise(args.device)
    card = card_name(device)
    root = args.root or tempfile.mkdtemp(prefix="tfks_torch_att_")
    train_d = make_fake_data_dir(os.path.join(root, "train"), num_speakers=100,
                                 utts_per_speaker=12, dim=30, min_len=320,
                                 max_len=600, seed=0)
    test_d = make_fake_data_dir(os.path.join(root, "test"), num_speakers=40,
                                utts_per_speaker=8, dim=30, min_len=320,
                                max_len=600, seed=777, spk_offset=500)
    nnet = os.path.join(root, "exp", "nnet")
    trainer = Trainer(ParamsPlain(**CFG), nnet, dim=30, num_speakers=100, device=device)
    trainer.build("train", 30, CFG["loss_func"], 100)
    t1 = time.time()
    trainer.train(train_d["data"], train_d["spklist"], CFG["learning_rate"])
    trainer.close()
    train_time = time.time() - t1
    steps = trainer.step
    print("train: %d steps in %.1fs" % (steps, train_time), flush=True)
    write_nnet_files(nnet, CFG, 30)

    ex = Extractor(os.path.join(root, "exp"), min_chunk_size=25, batch_size=32, device=device)
    train_keys, train_embs = embed_data_dir(ex, train_d["data"])
    test_keys, test_embs = embed_data_dir(ex, test_d["data"])
    test_labels = np.array([int(k[3:6]) for k in test_keys])
    eer_cos = compute_cos_pairwise_eer(test_embs, test_labels)
    eer_plda = plda_eer(train_embs, np.array([int(k[3:6]) for k in train_keys]),
                        test_embs, test_labels)
    ok = eer_cos < GATE and eer_plda < GATE
    text = ("\n## Attention + AAM-softmax through the port (bf16, device-decode)\n\n"
            "4-head attentive pooling + ArcFace m=0.25, %d steps in %.1f s: cosine EER "
            "%.2f%%, PLDA EER %.2f%% on 40 held-out synthetic speakers (JAX record 0.00%% "
            "and 0.00%%; gate %.0f%%: %s). Card: %s.\n"
            % (steps, train_time, eer_cos * 100, eer_plda * 100, GATE * 100,
               "PASS" if ok else "FAIL", card))
    print(text, flush=True)
    if args.write_doc:
        append_doc(text)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
