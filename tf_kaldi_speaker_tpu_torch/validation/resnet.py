"""ResNet34 (r-vector) through the port (a copy of
``scripts/resnet_validation.py``): ResNet34 base 16 with AM-softmax in
bf16, 300 steps of 32 speakers x 2 segments on the separable corpus (60
speakers, dim 30), bucketed extraction and cosine EER on 20 held-out
speakers; fails at 5% (JAX record 0.00%, ``docs/VALIDATION.md:154-158``).

Run: ``python -m tf_kaldi_speaker_tpu_torch.validation.resnet [--device
cuda] [--root DIR] [--write-doc]``.
"""

from __future__ import annotations

from .common import zoo_validation

# scripts/resnet_validation.py:26-54
CFG = dict(
    seed=0,
    network_type="resnet34",
    resnet_base_channels=16,
    resnet_layers=[3, 4, 6, 3],
    resnet_embedding_dim=128,
    pooling_type="statistics_pooling",
    embedding_node="resnet_embedding",
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
    return zoo_validation(CFG, "ResNet34 r-vector (base 16, AM-softmax, bf16)", "0.00%", argv)


if __name__ == "__main__":
    raise SystemExit(main())
