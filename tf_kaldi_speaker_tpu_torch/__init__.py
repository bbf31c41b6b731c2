"""tf_kaldi_speaker_tpu_torch — the PyTorch/CUDA port of tf_kaldi_speaker_tpu.

The JAX package ``tf_kaldi_speaker_tpu`` stays the reference; this package
mirrors its module layout so each counterpart is found at the same path. It
imports ``torch`` and never the JAX libraries; of the JAX package it imports only
the numpy Kaldi codec ``tf_kaldi_speaker_tpu.kio``.

- ``models``   TDNN x-vector network and statistics pooling (eval mode)
- ``ops``      the CUDA kernels (CM dequantization, fused statistics
               pooling; sources in ``csrc/``) and batched CMVN / VAD
- ``convert``  JAX variable tree <-> the port's modules
- ``train``    checkpoints (reads the JAX package's msgpack files)
- ``extract``  bucketed extraction, the decode-on-device pipe, the server
- ``cli``      ``extract`` and ``serve``
"""

__version__ = "0.1.0"
