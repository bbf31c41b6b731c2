"""Checkpoint store (counterpart of tf_kaldi_speaker_tpu/train)."""
