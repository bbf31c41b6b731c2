"""Command-line entry points (counterparts of tf_kaldi_speaker_tpu/cli)."""
