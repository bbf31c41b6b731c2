"""Embedding extraction and serving (counterparts of tf_kaldi_speaker_tpu/extract)."""
