"""GPU kernels and on-device DSP (counterparts of tf_kaldi_speaker_tpu/ops)."""
