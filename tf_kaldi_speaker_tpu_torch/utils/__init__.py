"""Config system (counterpart of tf_kaldi_speaker_tpu/utils)."""
