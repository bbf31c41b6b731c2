"""tf_kaldi_speaker_tpu_torch — the PyTorch/CUDA port of tf_kaldi_speaker_tpu.

The JAX package ``tf_kaldi_speaker_tpu`` stays the reference; this package
mirrors its module layout so each counterpart is found at the same path. It
imports ``torch`` and numpy, never the JAX libraries and nothing of the JAX
package: what it needs of the numpy-only modules there (the Kaldi codec,
the config reader, the numpy front end, the scoring back end) it carries
itself.

- ``kio``      Kaldi ark/scp codec (float matrices and vectors, CM codes),
               wav files and the data-directory reader
- ``models``   TDNN x-vector network and statistics pooling
- ``losses``   the margin-softmax family and its head
- ``ops``      the CUDA kernels (CM dequantization, fused statistics
               pooling forward and backward; sources in ``csrc/``), and
               batched MFCC, CMVN and VAD
- ``data``     speaker index, samplers, prefetch loader, the device pool
- ``convert``  JAX variable tree <-> the port's modules
- ``train``    the trainer (train step, optimizers, device-pool epochs,
               validation) and checkpoints (reads the JAX package's msgpack
               files)
- ``extract``  bucketed extraction, the decode-on-device pipe, the server
- ``backend``  cosine/LDA/PLDA scoring, AS-norm, calibration, EER/minDCF
- ``utils``    config, bookkeeping, synthetic data dirs
- ``cli``      training, extraction and serving; the front end
               (``make_mfcc``, ``compute_vad``, ``prepare_feats``) and
               scoring (``score``, ``calibrate_scores``, ``copy_plda``,
               ``plot_det``)
"""

__version__ = "0.1.0"
