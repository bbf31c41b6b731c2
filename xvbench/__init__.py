"""The benchmark of the PyTorch port (``tf_kaldi_speaker_tpu_torch``) on
one H100; ``run.py`` is its command and ``harness.py`` says how a run
goes."""
