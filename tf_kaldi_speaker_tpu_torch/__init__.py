"""tf_kaldi_speaker_tpu_torch — the PyTorch/CUDA port of tf_kaldi_speaker_tpu.

The JAX package ``tf_kaldi_speaker_tpu`` stays the reference; this package
mirrors its module layout so each counterpart is found at the same path. It
imports ``torch`` and numpy, never the JAX libraries and nothing of the JAX
package: what it needs of the numpy-only modules there (the Kaldi codec,
the config reader, the numpy front end and augmentation, the scoring back
end, the data-directory tools) it carries itself.

- ``kio``      Kaldi ark/scp codec (float matrices and vectors, CM codes),
               wav files, the data-directory reader and the native ark
               batch reader (``native/ark_decoder.cpp``, built with g++)
- ``models``   TDNN x-vector network and statistics pooling
- ``losses``   the margin-softmax family, the triplet family (semi-hard,
               angular, GE2E, generalized angular triplet) and their head
- ``ops``      the CUDA kernels (CM dequantization, fused statistics
               pooling forward and backward; sources in ``csrc/``), and
               batched MFCC, CMVN and VAD
- ``data``     speaker index, samplers (one stream or a main and aux
               streams), prefetch loaders, the device pool,
               augmentation (reverberation batched on the card)
- ``convert``  JAX variable tree <-> the port's modules
- ``train``    the trainer (train step, optimizers, device-pool epochs,
               validation), the multi-input trainer and checkpoints (reads
               the JAX package's msgpack files)
- ``extract``  bucketed extraction, the decode-on-device pipe, the server
- ``backend``  cosine/LDA/PLDA scoring, AS-norm, calibration, EER/minDCF
- ``utils``    config, bookkeeping, synthetic data dirs
- ``cli``      training, extraction and serving; the front end
               (``make_mfcc``, ``compute_vad``, ``prepare_feats``),
               augmentation and the data-directory tools
               (``augment_data``, ``make_voxceleb``, ``combine_data``,
               ``fix_data_dir``, ``validate_data_dir``, ``filter_egs_dir``,
               ``sample_validset_spk2utt``, ``copy_feats``), scoring
               (``score``, ``calibrate_scores``, ``copy_plda``,
               ``plot_det``), ``compute_gae2e_loss``, and the multi-input
               chain (``extract_bnf``, ``train_mi``, ``extract_mi``)
- ``recipes``  ``voxceleb/v1/run.sh`` and ``fisher/v1/run.sh``, the VoxCeleb
               and Fisher recipes through the port
"""

__version__ = "0.1.0"
