"""ECAPA-TDNN through the port (a copy of ``scripts/ecapa_validation.py``):
ECAPA-128 with AM-softmax in bf16, 300 steps of 32 speakers x 2 segments on
the separable corpus (60 speakers, dim 30), bucketed extraction and cosine
EER on 20 held-out speakers; fails at 5% (JAX record 0.00%,
``docs/VALIDATION.md:131-133``).

Run: ``python -m tf_kaldi_speaker_tpu_torch.validation.ecapa [--device cuda]
[--root DIR] [--write-doc]``.
"""

from __future__ import annotations

from .common import zoo_validation

# scripts/ecapa_validation.py:26-55
CFG = dict(
    seed=0,
    network_type="ecapa_tdnn",
    ecapa_channels=128,
    ecapa_mfa_channels=384,
    ecapa_res2net_scale=8,
    ecapa_se_bottleneck=32,
    ecapa_att_bottleneck=32,
    ecapa_embedding_dim=128,
    embedding_node="ecapa_embedding",
    loss_func="additive_margin_softmax",
    amsoftmax_m=0.2,
    amsoftmax_lambda_min=0,
    amsoftmax_lambda_base=1000,
    amsoftmax_lambda_gamma=0.001,
    amsoftmax_lambda_power=4,
    optimizer="momentum",
    momentum=0.9,
    compute_dtype="bfloat16",
    weight_l2_regularizer=1e-4,
    batchnorm_momentum=0.99,
    num_steps_per_epoch=300,
    save_checkpoints_steps=300,
    show_training_progress=50,
    num_parallel_datasets=4,
    max_queue_size=8,
    num_speakers_per_batch=32,
    num_segments_per_speaker=2,
    min_segment_len=150,
    max_segment_len=250,
    batch_type="softmax",
)


def main(argv=None) -> int:
    return zoo_validation(CFG, "ECAPA-TDNN (ECAPA-128, AM-softmax, bf16)", "0.00%", argv)


if __name__ == "__main__":
    raise SystemExit(main())
