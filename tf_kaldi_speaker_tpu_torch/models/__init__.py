"""Network modules (counterparts of tf_kaldi_speaker_tpu/models)."""
