#!/usr/bin/env python3
"""Drive the PyTorch port (tf_kaldi_speaker_tpu_torch) on one CUDA card.

Usage, from the root of the repository:

    python3 chip_smoke.py
    python3 chip_smoke.py --mt-step-spread
    python3 chip_smoke.py --mt-epoch-spread
    python3 chip_smoke.py --dp-spread
    python3 chip_smoke.py --kernels [SHAPES_JSON]

The second form runs only what the multitask step check's bounds are set
from (``mt_step_spread``) and checks nothing. The third, likewise, runs
only the multitask card test's epoch (``tests/torch_mt_tiny.py``) over 8
config seeds on the CPU and, free-running and in lockstep, on the card
and under TF32 and bf16 controls (``mt_epoch_spread``): what the test's
comparison can tell apart at its tolerance. The fourth runs
the kernels' build, phase 9's training and then phase 27 with its step
readings from 4 states (the trained one and 3 fresh seeds) x 4 batches,
with its checks: the spread that phase 27's bounds sit in. The fifth runs
phases 1-3 and,
given the file a whole run writes (``build/chip_smoke/kernel_shapes.json``:
every mix it replayed), replays those mixes, as 7 does: a copy of this
script in another tree (say the parent commit's, unpacked with ``git
archive``) times that tree's kernels with this script's timer on the same
shapes. Phase 27 starts this script
again as the processes of its ranks (``--dp-rank DIR`` and
``--dp-cli-rank CLI-ARGS``, with the launcher's environment); they are not
for use by hand.

Phases, each of which raises on failure:

1. print the card's name and power limit; stop unless CUDA is available;
2. build the CUDA kernels from tf_kaldi_speaker_tpu_torch/csrc;
3. hold each kernel against its plain PyTorch version on the card at fixed
   shapes (dequant also bit for bit against the host codec, the pooling
   backward and the train-mode BatchNorm's backward also against a second
   launch, bit for bit; the BatchNorm's four passes at the pool cell's
   shapes, each also timed alone), and time both
   (CUDA events, median, L2 evicted by a read, the host's enqueue behind a
   spin: ``time_ms``) beside the kernel's bound;
4. write a flagship-width x-vector model dir (random weights from a seed,
   non-trivial BatchNorm statistics, bf16 compute, fused pooling);
5. write a compressed ark of 64 synthetic 30-dim utterances;
6. extract through ``cli.extract`` with ``--device-pipe --cmvn --vad``
   (the main path: both kernels must launch) and through the host path,
   and hold the embeddings against each other and against a float32 CPU
   forward of the same checkpoint;
7. replay every (shape, dtype) each kernel was launched at on the main
   path through kernel and plain version, and time the mix against its
   bound;
8. serve 16 requests from 8 client threads through ``EmbeddingServer``
   and hold each reply against ``embed_utterance``;
9. train: ``cli.train`` at flagship width from the device pool (bf16, 2
   epochs of 16 steps in groups of 8, validation after each) on a
   synthetic compressed corpus of 96 speakers (the second main path: the
   dequant kernel, the pooling forward and the pooling backward and the
   train-mode BatchNorm's forward and backward must each launch), with
   every logged loss finite; one ``torch.profiler`` pass over
   a group of 8 pool steps (device busy and idle share, top kernels);
10. replay every (shape, dtype) each kernel was launched at on the
   training path, as in 7;
11. hold one card bf16 train step against the port's float32 CPU step from
   the trained state on one fixed pool batch;
12. extract with ``cli.extract --device-pipe`` from the trained model dir;
13. train: ``cli.train`` from the streaming loader with the fisher v1
   recipe config as it is (float32, ``device_decode``, two-pass pooling,
   16 loader threads), cut to 2 epochs of 16 steps, summaries every 8 steps
   and a 4-step profile window (the dequant kernel must launch); the first
   group that reached the card equal byte for byte to one loader worker's
   first group on the host; the tfevents tags and steps and the Chrome
   trace; one profiler pass over 8 streamed steps (device idle share, the
   consumer's wait for the loader); a card float32 step against the CPU's
   on one streamed batch;
14. preemption: ``cli.train`` (streaming) in a child process, SIGTERM after
   its first progress line: exit 75, a checkpoint at a multiple of K, no
   validation line; ``--cont`` finishes the epoch;
15. ``cli.make_checkpoint --checkpoint -1`` on the trained pool dir, then
   ``cli.finetune`` from it (flagship, device pool; two convs and their
   BatchNorms frozen, the output kernel re-initialized): frozen variables
   bit-equal to the pretrain checkpoint, re-initialized ones changed, the
   step restarted, the evaluation before training logged;
16. ``cli.train_lr_learning --tune_period 2`` at flagship width, then
   ``cli.tune_lr``: finite sweep lines until the break;
17. replay the shapes of the streaming, fine-tuning and LR-sweep paths, as
   in 7;
18. the model zoo: ``cli.train`` with each of the six VoxCeleb recipe
   configs that need it (self-attention pooling twice, the MHE and ring
   aux losses, ECAPA-TDNN, ResNet34 with ``use_fused_pooling``) as shipped,
   each on its own input branch, cut to 1 epoch of 16 steps in groups of 8,
   4 loader threads and 2 validation batches (each kernel of the path must
   launch: the dequant and the BatchNorm's everywhere, both pooling kernels
   for ResNet34); one
   ``torch.profiler`` pass over 8 steps for ECAPA and ResNet34; a card
   float32 step against the CPU's for both; ``cli.extract --device-pipe``
   from each trained dir against a float32 CPU forward of its checkpoint
   (cosine >= 0.9999 per utterance); ``cli.extract --exact-long --chunk-size
   256`` on the streamed fisher dir against its whole-utterance embeddings;
   the zoo paths' shapes replayed, as in 7;
19. wav to trial scores, the recipe's evaluation path
   (``recipes/voxceleb/v1/run.sh`` stages 1, 3 and 8): a corpus of 128
   synthetic 16 kHz utterances of 2-10 s from 32 speakers (harmonic series
   with each speaker's f0 and formants, pauses of digital silence or low
   noise) through ``cli.make_mfcc --compress`` (``run.sh:55-57`` options,
   dither 1), ``cli.compute_vad``, ``cli.prepare_feats`` and
   ``cli.extract --device-pipe`` (``--cmvn --vad`` on the raw MFCC, no flags
   on the prepared features, and a PLDA set of 256 x 4 synthetic feature
   utterances) on the card, from the trained flagship's checkpoint in
   float32 (the third main path: the dequant and the pooling forward must
   launch); ``cli.score`` cosine, PLDA with ``--lda-dim 200``, PLDA with
   ``--adapt-scp`` and cosine with AS-norm on every utterance pair;
   ``python -m tf_kaldi_speaker_tpu_torch.cli.extract`` in a process of its
   own (float32, nothing in its environment about TF32) held to the same
   x-vector and score bounds against the CPU chain (after the chain below); the
   card's uncompressed MFCC against numpy ``mfcc`` (float32 rounding), its
   VAD decisions against numpy's (equal); the same chain with ``--device
   cpu``, and the card against it: features within one quantization step,
   x-vectors by cosine, scores by their largest difference over their
   spread, EER within one target trial, minDCF within one target and one
   nontarget trial; each stage's time; the path's shapes replayed, as in 7;
20. augmentation, the recipe's stage 2: 8 synthetic RIRs of 4,000-16,000
   samples and MUSAN-like noise, music and speech sources;
   ``cli.augment_data`` on the card in the four modes with the recipe's
   seeds, SNRs and babble counts over the 128 utterances of 19; the card's
   float64 reverb (``reverberate_torch``) against numpy's ``reverberate`` on
   16 of them within 1e-12 of each row's peak, and the int16 samples the CLI
   wrote against numpy's (the count that differ); the noise, music and
   babble wavs byte-equal to the numpy copies'; seconds per hour of audio of
   each mode, and of np.convolve on the same host;
21. the recipe: ``tf_kaldi_speaker_tpu_torch/recipes/voxceleb/v1/run.sh``
   stages 0-8, one bash run a stage, on synthetic VoxCeleb1 and VoxCeleb2
   corpus trees of real wavs (80 speakers x 4 clips) with the sources of
   20, training with the shipped ``tdnn_amsoftmax_m0.20_linear_bn_1e-2.json``
   at full width and fine-tuning with ``_mhe0.01.json``, cut as
   ``tests/test_recipe_e2e.py`` cuts the JAX recipe (epochs, steps,
   validation batches, checkpoint and summary cadence; stage 4's counts and
   stage 8's LDA width on a patched copy of the script); every CLI's
   process reports its kernel launches at its exit (``cm_dequantize`` must
   launch in stages 5 and 6); the augmented copies of all four kinds in
   ``train_combined``, both models, both score files and their EERs; each
   stage's time; the path's shapes replayed, as in 7;
22. the triplet family: ``cli.train`` at the flagship's widths (bf16, fused
   pooling, device pool) with ``angular_triplet_loss`` ("hard", AM flavour,
   margin 0.2) over 16 speakers x 4 segments and ``batch_type: end2end``
   validation at 8 x 4, 16 steps and a checkpoint (all five kernels must
   launch); a profiler pass over 8 steps; a float32 step on the card
   against the CPU's; ``generalized_angular_triplet_loss`` with "average"
   centers for an epoch of 8 steps and a ``--cont`` epoch that restores the
   centers bit for bit; ``cli.compute_gae2e_loss`` on the triplet model's
   x-vectors on the card against the CPU; the path's shapes replayed, as in
   7;
23. the native ark reader: built with g++ (its time and path printed);
   ``decode_batch_fast`` and ``read_batch_codes_fast`` over 16 chunks of
   the training corpus (one ending on its utterance's last frame) bit-equal
   to the numpy codec; then the streaming phase's first epoch (the fisher
   config as it is, 16 loader threads, ``device_decode``) twice in this
   process, with the native reader and with ``TFKS_DISABLE_NATIVE=1``: each
   run's first-group latency, group times and the consumer's wait for each
   group, the native run with 0 numpy fallbacks (so are the streaming
   phase of 13 and the recipe of 25); the CM reads of three builds of the
   reader (column by column, the port's, one span a matrix) timed over
   the training corpus and 16 long (60,000-frame, 23-d) utterances, their
   floats bit-equal;
24. the multi-input trainer's BNF chain at the flagship's width:
   ``cli.extract_bnf --node tdnn5_relu`` from the trained pool model over
   the training and validation utterances (1500-d, float arks),
   ``cli.prepare_feats --no-cmvn``, the three builds' CM reads over the
   prepared BNFs, ``cli.train_mi`` (bf16, fused pooling, the BNF stream
   concatenated onto the input; 1 epoch of 16 steps in groups of 8, 2
   validation batches; the pooling forward and backward must launch: the
   multi-stream loader ships floats, as the JAX one does) and
   ``cli.extract_mi`` on the validation set against a CPU predict; a
   profiler pass over 8 steps; a float32 step on the card against the
   CPU's (the loss and the updates); each check with a TF32-on and a bf16
   control read against its bound; the path's shapes replayed, as in 7;
25. the Fisher recipe: ``tf_kaldi_speaker_tpu_torch/recipes/fisher/v1/run.sh``
   stages 1-6 on a synthetic 8 kHz tree (80 background speakers x 8
   utterances, 10 speakers' enrollment and test utterances and their
   trials) with the shipped AM-softmax config at full width cut to 1 epoch
   of 16 steps, a smaller validation split and LDA width; each stage's
   time; every CLI's kernel launches and native reader counts at its exit
   (``cm_dequantize`` must launch in ``cli.train``, no CLI may fall back to
   numpy); both score files and their EERs; the path's shapes replayed, as
   in 7;
26. the multitask recipe: ``tf_kaldi_speaker_tpu_torch/recipes/fisher/
   v3_multitask/run.sh`` stages 2-5 from 25's stage-1 output (the same
   MFCC and VAD options), with a synthetic Kaldi alignment dir (a 2001-pdf
   transition model written by the port, gzipped transition-id alignments
   frame-aligned with the MFCC) for the native ``ali_to_pdf``; the shipped
   ``mt_softmax.json`` at full width (64 speakers of 200-400 frames + 11 + 11
   of context, 10 phone frames a row) cut to 1 epoch of 16 steps in groups
   of 8, 2 validation batches and 4 loader threads, the validation split
   cut on a patched copy; every CLI's kernel launches and native reader
   counts at its exit (no dequant or pooling kernel may launch: the JAX
   multitask path pools with the two-pass moments and reads floats; its
   BatchNorms train on their kernels; ``cli.train_mt`` reads
   natively with no numpy fallback); finite losses, both egs counts, the
   x-vectors, phone posteriors and log-likelihoods of one column a pdf;
   each stage's time; a profiler pass over 8 float32 steps; a float32 step,
   ``extract_mt`` and ``compute_loglike`` on the card against the CPU, each
   with a TF32-on and a bf16 control read against its bound (the step's
   loss, embeddings and updates), and stage 5's log-likelihoods (its
   ``compute_loglike`` process) against the same bound;
27. multi-card training (``parallel/``) as 2 ranks on the one card, joined
   over gloo (NCCL refuses two ranks on one card; gloo runs the port's
   all-reduces on CUDA tensors): the flagship at full width (bf16, fused
   pooling) from the sharded device pool, one shard a rank, a global batch
   of 64 chunks (32 a rank), one epoch of 16 steps in groups of 8 through
   ``Trainer.train`` (the main path: every rank must launch all five
   kernels, the BatchNorm's all-reducing their sums over the data group;
   their shapes replayed, as in 7), the ranks' states bit-equal
   after it, each rank's second epoch's second group under torch.profiler
   (step time, device idle share, the all-reduces' share of the wall); 2
   ranks against 1 on the same global rows and ``model_parallel=2``
   against 1, float32 steps from two states x 3 pool batches, read against
   bounds that a TF32-on and a bf16 one-rank control fail; ``sp_embed``
   over the 2 ranks against the whole forward on the card at 3000 and 1111
   frames; ``cli.train`` under ``torchrun --nproc_per_node 1`` (a world of
   one, NCCL, the one-card path) for 8 steps; SIGTERM to rank 1 of a 2-rank
   ``cli.train``: both exit 75 with one checkpoint at a multiple of 8;
28. the ASR decode recipe: the port's v3 ``run.sh`` stage 6 (its
   ``run_decode.sh``) from 26's model with ``newarpa`` set, over a
   word-loop HCLG of 667 words (each one phone's 3-state chain of 26's
   transition model) and a bigram ARPA over them, on the first 2
   validation utterances, whole: ``compute_loglike`` on the card, native
   ``decode_faster`` with determinized lattices, ``lmrescore``,
   ``compute_wer`` and the ``lattice_best_path`` sweep; what
   ``tests/test_run_decode.py`` asserts of the outputs; every utterance
   decoded by the native core (no Python fallback); no kernel launched
   (path ``decode``); the native best path against the port's Python
   oracle on the first utterance's first 40 frames; over the whole validation
   split at full length, the CPU's log-likelihoods and a TF32-on
   control's decoded by the same decoder against the card's (the words'
   agreement, the best-path cost's relative gap against its bound, which
   the control must exceed); the stage's seconds, and in
   ``decode_faster``'s process the lattice decode's frames per second and
   the determinization's share, and the sweep's seconds;
29. the SRE recipe: ``tf_kaldi_speaker_tpu_torch/recipes/sre/v1/run.sh``
   stages 2-8 from 25's stage-1 output (the same MFCC and VAD options) as
   the SRE data dirs (swbd_sre the 80 background speakers' first 3
   utterances, the unlabelled set 20 of their next ones, SRE10 and SRE16
   the 10 evaluation speakers, the SRE16 trials split into two
   languages), the shipped config at full width cut as 25's, the script
   cut as ``tests/test_torch_sre_recipe.py`` cuts it (augmentation
   skipped: no MUSAN or RIRs); every CLI's kernel launches
   (``cm_dequantize`` must launch in ``cli.train``); what that test
   asserts: both score files, the per-language splits, the calibrated
   scores, Cllr and minDCF/actDCF; each stage's time; the path's shapes
   replayed, as in 7.
30. TF1 checkpoint interop at the flagship's width:
   ``cli.export_tf_checkpoint`` of the checkpoint that 9's trained
   flagship dir serves (bf16, fused pooling; 15 points it at the best
   epoch's), ``cli.import_tf_checkpoint --device cuda`` of it into a new
   model dir (params and batch statistics bit-equal to the trained
   checkpoint), ``cli.extract --device-pipe --cmvn --vad`` over 5's ark from
   the imported dir and from the original (the path ``interop``: the dequant
   and the pooling forward must launch; the arks byte-equal, else each
   embedding within 1 - cosine 1e-6); ``tests/data/tf_golden``'s
   ``model-0`` and ``export/model-3`` imported on the card with the golden
   tests' config, their float32 forward against real TF's endpoints and
   losses at rtol/atol 1e-4; the tools on the trained flagship:
   ``extract_softmax_weights`` (one finite 512-d vector a speaker),
   ``train_insight --device cuda`` on the validation dir against the same
   call with ``--device cpu`` (the valid loss within the CPU-versus-card
   bound; its launches join the path), ``target_logit_curve`` on the card
   equal to the CPU's CSV; each step's seconds;
31. extraction over several row blocks: the ``Extractor`` (5's utterances
   through the host CMVN and VAD, those over 600 frames after it through the
   50%-overlap chunks) and the ``DevicePipeExtractor`` (those of up to 600
   frames before it, as raw codes) from the trained flagship (bf16) and
   its float32 copy with ``devices=["cuda:0", "cuda:0"]``, each bucket
   batch cut into two row blocks on the one card (the path
   ``extract_multi``: the dequant and the pooling forward must launch),
   and over every visible card where there are several, against one
   device, each way warmed up once: the keys in the same order, byte-equal
   or within 1 - cosine 1e-6 in float32 (the split, pad and merge code)
   and 1e-3 in bf16 (8's bound: products of another row count round
   differently), and the embeddings a second of each, one card's rates and
   not a scaling number;
32. training quality: the convergence corpus of
   ``tf_kaldi_speaker_tpu_torch.validation.convergence`` (200 speakers x
   10, dim 12), then its ``run --program flagship`` arm for seed 1 at the
   full 3 x 400-step schedule (am-softmax, bf16, the device pool, the
   fused pooling kernels; 512 wide, batch 24 x 100-200 frames), driven as
   the path ``quality`` (the dequant, the pooling forward and the pooling
   backward must each launch): the valid loss after each epoch, the final
   held-out EER inside JAX's am-softmax f32 band (18.15% ± 1.50%,
   ``docs/VALIDATION.md:321-330``) and the final valid loss inside JAX's
   (2.645 ± 0.226, the same rule), and two controls that must each fall
   outside one of the bands: the untrained network and one epoch on the
   training corpus with its speaker labels shuffled over the utterances
   (on this corpus their EERs can land inside the EER band: it alone does
   not tell them from a trained network; each reading is printed); the
   quality matrix's kernel shapes checked against the plain versions (the
   dequant at [64, 151, 12] bit for bit against the host codec, the
   pooling forward and backward in bf16 at [64, 286, 256]); the path's
   shapes replayed, as in 7.

The order differs from the numbers in one place. After 20, the CLI work
of 21, 25, 29 and 26 (their trees and their run.sh stages, every CLI a
process of its own) runs in threads while this process runs 22, 24 and
27: 21 in one thread; 25's stage 1 in another, then its stages 2-6 there
beside 29's stages and 26's in a thread each. When all have ended come
their checks and lines, 23, 26's checks in this process, the replays of
the shapes of 21, 22, 24, 25, 27 and 29, then 28 and 30-32 in order. So
the CLIs' start-ups overlap, and the stage times of 21, 25, 26 and 29 and
the readings of 22, 24 and 27 (step times, profiles, waits, read timings)
are taken with the others running; the kernels' times (3, and every
replay) and the readings of 23, 26's checks and 28-32 are taken alone.

Every measurement line names the card and its power limit as nvidia-smi
gives them. The line before the last is a JSON object with each kernel's
route, source, launch count on the main paths (and by path), error against
its plain version, times and bounds at the fixed shapes and over each
path's mix; the last line is ``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import glob
import io
import json
import os
import random
import re
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

# The model of __graft_entry__.FLAGSHIP (__graft_entry__.py:21-42), which
# imports jax and so cannot be imported here, with the fused pooling kernel.
FLAGSHIP = dict(
    seed=0,
    network_type="tdnn",
    pooling_type="statistics_pooling",
    embedding_node="tdnn6_dense",
    last_layer_linear=True,
    loss_func="additive_margin_softmax",
    amsoftmax_m=0.20,
    amsoftmax_lambda_min=0,
    amsoftmax_lambda_base=1000,
    amsoftmax_lambda_gamma=0.0001,
    amsoftmax_lambda_power=5,
    optimizer="momentum",
    momentum=0.9,
    weight_l2_regularizer=1e-2,
    batchnorm_momentum=0.99,
    compute_dtype="bfloat16",
    num_speakers_per_batch=64,
    num_segments_per_speaker=1,
    min_segment_len=200,
    max_segment_len=400,
    use_fused_pooling=True,
)
FEAT_DIM = 30
N_UTTS = 64
ROOT = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(ROOT, "build", "chip_smoke")
# cli.train's config: the flagship from the device pool, the voxceleb
# recipe's learning rate (recipes/voxceleb/v1/nnet_conf), cut to 2 epochs of
# 16 steps (2 groups of 8 sampled at one bucket length each).
TRAIN = dict(
    FLAGSHIP,
    device_pool=True,
    num_steps_per_epoch=16,
    steps_per_dispatch=8,
    num_epochs=2,
    learning_rate=0.01,
    valid_max_iterations=2,
    show_training_progress=8,
    check_numerics=True,
)

# cli.train from the streaming loader: the fisher v1 recipe config as it is
# (float32, device_decode, two-pass pooling, 16 loader threads), cut in
# epochs, steps, summary and profile cadence, and validation batches only.
FISHER_CONF = os.path.join(ROOT, "recipes", "fisher", "v1", "nnet_conf",
                           "tdnn_amsoftmax_m0.20_linear_bn_1e-2.json")
STREAM_CUTS = dict(num_epochs=2, num_steps_per_epoch=16, save_summary_steps=8,
                   profile_steps=4, valid_max_iterations=2)
# the preemption round trip: one epoch long enough that SIGTERM lands
# inside it, with a progress line after every group of 8 steps, and 4
# loader threads (16 take seconds to yield a first group, PERF.md §6)
PREEMPT_CUTS = dict(num_epochs=1, num_steps_per_epoch=64, show_training_progress=8,
                    valid_max_iterations=2, num_parallel_datasets=4)
# cli.finetune from the trained pool dir: the training config for one
# epoch; tdnn1/tdnn2's convs frozen with their BatchNorms (substrings match
# the JAX names, so a conv's name alone leaves its BatchNorm training), the
# loss head's output kernel re-initialized
FINETUNE = dict(TRAIN, num_epochs=1,
                noupdate_var_list=["tdnn/tdnn1_conv", "tdnn/tdnn2_conv",
                                   "tdnn/tdnn1_bn", "tdnn/tdnn2_bn"],
                noload_var_list=["softmax/output_kernel"])
SCALAR_TAGS = ["accuracy", "loss", "penalty_loss", "regularization_loss", "total_loss"]
# the model zoo: the VoxCeleb recipe configs that need a module beyond the
# TDNN with statistics pooling and the softmax family, run as shipped, cut
# in epochs, steps, group size, loader threads and validation batches; a
# progress line after each group of 8; ResNet34 with the fused pooling
# kernels, which its shared pooling registry honours
VOX_CONF = os.path.join(ROOT, "recipes", "voxceleb", "v1", "nnet_conf")
ZOO = ("tdnn_amsoftmax_m0.20_linear_bn_1e-2_tdnn4_att.json", "tdnn_arcsoftmax_m0.25_att.json",
       "tdnn_amsoftmax_m0.20_linear_bn_1e-2_mhe0.01.json",
       "tdnn_amsoftmax_m0.20_linear_bn_1e-2_r0.01.json", "ecapa_amsoftmax_m0.20.json",
       "resnet34_amsoftmax_m0.20.json")
ZOO_CUTS = dict(num_epochs=1, num_steps_per_epoch=16, steps_per_dispatch=8,
                num_parallel_datasets=4, valid_max_iterations=2, show_training_progress=8)
ZOO_OVERRIDES = {"resnet34_amsoftmax_m0.20.json": dict(use_fused_pooling=True)}
# exact long-utterance extraction: chunks of 256 frames against the whole
# forward, at the JAX package's test tolerance (tests/test_exact_long.py)
EXACT_CHUNK = 256
EXACT_TOL = dict(rtol=5e-3, atol=5e-4)
CARD = "card not read yet"  # nvidia-smi's name and power limit, set by main()
# time_ms's spin before each timed call: SPIN_US at the card's highest SM
# clock (MHz; the H100 SXM's 1,980 until main() reads the card's)
SPIN_US = 50
SM_MHZ = 1980


# Peaks of one H100 SXM for the bounds (from NVIDIA's data sheet): HBM3
# bytes/s, and float32 FLOP/s outside the tensor
# cores, which is where both kernels' arithmetic runs.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SOURCES = {
    "cm_dequantize": ("tf_kaldi_speaker_tpu_torch/csrc/cm_dequant.cu",
                      "tf_kaldi_speaker_tpu/ops/cm_dequant_pallas.py:28"),
    "masked_stats_pooling": ("tf_kaldi_speaker_tpu_torch/csrc/stats_pooling.cu",
                             "tf_kaldi_speaker_tpu/ops/pooling_pallas.py:35"),
    "masked_stats_pooling_backward": ("tf_kaldi_speaker_tpu_torch/csrc/stats_pooling_bwd.cu",
                                      "tf_kaldi_speaker_tpu/ops/pooling_pallas.py:100"),
    # no TPU kernel: flax's nn.BatchNorm, which XLA fuses on the TPU
    "batch_norm_train": ("tf_kaldi_speaker_tpu_torch/csrc/batchnorm.cu", None),
    "batch_norm_train_backward": ("tf_kaldi_speaker_tpu_torch/csrc/batchnorm.cu", None),
}
# kernel vs plain: dequant within 1e-6 (both round each operation once, so
# they agree bit for bit; check_dequant also holds the kernel bit for bit
# against the host codec); pooling f32 one-pass shifted sums against
# two passes; bf16 one ulp (both round an f32 result)
DEQ_TOL = dict(atol=1e-6, rtol=1e-6)
POOL_TOL = {"float32": dict(atol=1e-4, rtol=1e-5), "bfloat16": dict(atol=0.0, rtol=2.0 ** -7)}
# backward vs plain (both float32 inside, rounded once): float32 to
# reassociation; bf16 one ulp, and the float32 noise where the mean and
# deviation terms cancel
BWD_TOL = {"float32": dict(atol=1e-6, rtol=1e-5), "bfloat16": dict(atol=1e-6, rtol=2.0 ** -7)}
# train-mode BatchNorm kernels vs plain (float32 inside; the sums in
# another order): float32 to reassociation, relative to the largest value
# where the analytic gradient's terms cancel; bf16 one ulp
BN_TOL = {"float32": dict(atol=1e-5, rtol=1e-4), "bfloat16": dict(atol=2.0 ** -8, rtol=2.0 ** -7)}
# a float32 train step on the card (TF32 off) against the CPU's: the loss's
# relative gap (6 runs of the fisher step read 0 to 1.78e-6)
CPU_GAP = 1e-5


def bound_ms(nbytes, flops):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dequant_cost(b, l, d):
    """Bytes (codes read, headers read, f32 out written) and operations (a
    multiply and an add per element) of cm_dequantize at [b, l, d]."""
    return b * l * d * (1 + 4) + b * 4 * d * 4, 2 * b * l * d


def pooling_cost(b, l, d, esize):
    """Bytes (x and the f32 mask read, [b, 2d] written) and operations (a
    subtract, a multiply and two multiply-adds per element) of the pooling."""
    return b * l * d * esize + b * l * 4 + 2 * b * d * esize, 6 * b * l * d


def pooling_bwd_cost(b, l, d, esize):
    """Bytes (x, the f32 mask, out and g read, gx written) and operations (a
    subtract, a multiply-add and a multiply per element) of the pooling
    backward."""
    return 2 * b * l * d * esize + b * l * 4 + 2 * 2 * b * d * esize, 4 * b * l * d


def bn_cost(n, esize):
    """Bytes and operations of the train-mode BatchNorm over n elements, by
    kernel: the statistics pass reads x (an add and a multiply-add an
    element), the normalize pass reads x and writes y (a subtract, a
    multiply and an add); the backward's sums read x and g (an add, a
    subtract and a multiply-add), its dx pass reads both and writes dx (a
    subtract, two multiplies and two adds). Per-channel bytes are left
    out: under a thousandth at the path's shapes."""
    return {"stats": (n * esize, 2 * n), "normalize": (2 * n * esize, 3 * n),
            "grad_stats": (2 * n * esize, 3 * n), "grad": (3 * n * esize, 5 * n)}


def time_ms(torch, fn, flush, runs=50, warmup=5):
    """Median device time of one call in ms, CUDA events around each call.

    Before each call the 50 MB L2 is evicted by a read of the 256 MB
    ``flush`` buffer (a sum over it, which leaves clean lines: the call's
    own traffic writes none of them back; the extraction path finds its
    inputs cold), and then the card spins for about SPIN_US, so that the
    host's enqueue of fn (the wrapper's checks, its allocation, the ctypes
    call) is done before the start event is reached on the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        flush.sum()
        torch.cuda._sleep(int(SPIN_US * SM_MHZ))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_close(name, got, want, atol, rtol, quiet=False):
    """max |got - want| and raise unless |got - want| <= atol + rtol |want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if not bool((diff <= atol + rtol * want.abs()).all()):
        raise AssertionError("%s: max abs err %.3g exceeds atol %g + rtol %g"
                             % (name, err, atol, rtol))
    if not quiet:
        print("%s: max abs err %.3g (atol %g, rtol %g) ok" % (name, err, atol, rtol))
    return err


def dequant_inputs(torch, g, shape):
    b, l, d = shape
    codes = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8).cuda()
    headers = torch.sort(torch.randn(b, 4, d, generator=g) * 8.0, dim=1).values.cuda()
    return codes, headers


def check_dequant(torch, name, codes, headers, quiet=False):
    """Kernel against the plain version (1e-6) and, bit for bit, against the
    host codec, which runs the map's operations in the kernel's order."""
    from tf_kaldi_speaker_tpu_torch.kio import decode_cm_codes
    from tf_kaldi_speaker_tpu_torch.ops.cm_dequant import cm_dequantize, cm_dequantize_plain

    got = cm_dequantize(codes, headers)
    err = check_close(name + " vs plain", got, cm_dequantize_plain(codes, headers),
                      quiet=quiet, **DEQ_TOL)
    got, c, h = got.cpu().numpy(), codes.cpu().numpy(), headers.cpu().numpy()
    for i in range(got.shape[0]):
        if not np.array_equal(got[i], decode_cm_codes(c[i], h[i])):
            raise AssertionError("%s: row %d differs from the host codec" % (name, i))
    if not quiet:
        print("%s: bit-equal to the host codec ok" % name)
    return err


def pooling_inputs(torch, g, shape, dtype, device):
    """Post-ReLU activations with a large mean and ragged masks (one row
    empty, one full), non-zero values on the masked frames."""
    b, l, d = shape
    x = torch.relu(torch.randn(b, l, d, generator=g, device=device) * 4.0 + 50.0)
    lengths = torch.randint(1, l + 1, (b,), generator=g, device=device)
    lengths[-1] = l
    if b > 1:
        lengths[0] = 0
    mask = (torch.arange(l, device=device)[None, :] < lengths[:, None]).float()
    return x.to(dtype).cuda(), mask.cuda()


def check_pooling(torch, name, xt, mask, quiet=False):
    from tf_kaldi_speaker_tpu_torch.models.pooling import floor_sqrt, masked_moments
    from tf_kaldi_speaker_tpu_torch.ops.pooling import (
        masked_stats_pooling, masked_stats_pooling_plain)

    tol = POOL_TOL[str(xt.dtype)[6:]]
    got = masked_stats_pooling(xt, mask)
    err = check_close(name + " vs plain", got, masked_stats_pooling_plain(xt, mask),
                      quiet=quiet, **tol)
    mean, var = masked_moments(xt.float(), mask)
    check_close(name + " vs masked_moments", got,
                torch.cat([mean, floor_sqrt(var)], 1).to(xt.dtype), quiet=quiet, **tol)
    return err


def copy_ms(torch, nbytes, flush):
    """Time of a device copy that reads and writes nbytes in all: the
    practical floor of a kernel that moves nbytes."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    return time_ms(torch, lambda: dst.copy_(src), flush)


def measure_dequant(torch, g, shape, flush, full):
    """Check cm_dequantize at shape and time it beside its bound and a copy
    of its bytes; full: also the plain version."""
    from tf_kaldi_speaker_tpu_torch.ops.cm_dequant import cm_dequantize, cm_dequantize_plain

    codes, headers = dequant_inputs(torch, g, shape)
    label = "cm_dequantize %s" % list(shape)
    r = dict(max_abs_err=check_dequant(torch, label, codes, headers, quiet=not full))
    r["ms"] = time_ms(torch, lambda: cm_dequantize(codes, headers), flush)
    nbytes, flops = dequant_cost(*shape)
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, flops)
    r["copy_ms"] = copy_ms(torch, nbytes, flush)
    if full:
        r["plain_ms"] = time_ms(torch, lambda: cm_dequantize_plain(codes, headers), flush)
    print("%s: kernel %.4f ms, bound %.4f ms (%s): %.1f%% of bound; copy of its %d bytes "
          "%.4f ms%s" % (label, r["ms"], r["bound_ms"], r["bound_by"],
                         100 * r["bound_ms"] / r["ms"], nbytes, r["copy_ms"],
                         "; plain %.4f ms" % r["plain_ms"] if full else ""))
    return r


def measure_pooling(torch, g, shape, dtype, flush, full):
    """Check masked_stats_pooling at shape and time it beside its bound;
    full: also the plain version."""
    from tf_kaldi_speaker_tpu_torch.ops.pooling import (
        masked_stats_pooling, masked_stats_pooling_plain)

    xt, mask = pooling_inputs(torch, g, shape, dtype, g.device)
    label = "masked_stats_pooling %s %s" % (str(dtype)[6:], list(shape))
    r = dict(max_abs_err=check_pooling(torch, label, xt, mask, quiet=not full))
    r["ms"] = time_ms(torch, lambda: masked_stats_pooling(xt, mask), flush)
    r["bound_ms"], r["bound_by"] = bound_ms(*pooling_cost(*shape, xt.element_size()))
    if full:
        r["plain_ms"] = time_ms(torch, lambda: masked_stats_pooling_plain(xt, mask), flush)
    print("%s: kernel %.4f ms, bound %.4f ms (%s): %.1f%% of bound%s"
          % (label, r["ms"], r["bound_ms"], r["bound_by"], 100 * r["bound_ms"] / r["ms"],
             "; plain %.4f ms" % r["plain_ms"] if full else ""))
    return r


def measure_pooling_bwd(torch, g, shape, dtype, flush, full):
    """Check the pooling backward at shape (x as in measure_pooling, out
    from the plain forward, g normal), and a second launch bit-equal to the
    first, and time it beside its bound; full: also the plain version."""
    from tf_kaldi_speaker_tpu_torch.ops.pooling import (
        masked_stats_pooling_backward, masked_stats_pooling_backward_plain,
        masked_stats_pooling_plain)

    xt, mask = pooling_inputs(torch, g, shape, dtype, g.device)
    out = masked_stats_pooling_plain(xt, mask)
    gr = torch.randn(out.shape, generator=g, device=g.device).to(dtype).cuda()
    label = "masked_stats_pooling_backward %s %s" % (str(dtype)[6:], list(shape))
    got = masked_stats_pooling_backward(xt, mask, out, gr)
    if not torch.equal(got, masked_stats_pooling_backward(xt, mask, out, gr)):
        raise AssertionError("%s: two launches on one input differ" % label)
    r = dict(max_abs_err=check_close(
        label + " vs plain", got, masked_stats_pooling_backward_plain(xt, mask, out, gr),
        quiet=not full, **BWD_TOL[str(dtype)[6:]]))
    r["ms"] = time_ms(torch, lambda: masked_stats_pooling_backward(xt, mask, out, gr), flush)
    r["bound_ms"], r["bound_by"] = bound_ms(*pooling_bwd_cost(*shape, xt.element_size()))
    if full:
        r["plain_ms"] = time_ms(
            torch, lambda: masked_stats_pooling_backward_plain(xt, mask, out, gr), flush)
    print("%s: kernel %.4f ms, bound %.4f ms (%s): %.1f%% of bound%s"
          % (label, r["ms"], r["bound_ms"], r["bound_by"], 100 * r["bound_ms"] / r["ms"],
             "; plain %.4f ms" % r["plain_ms"] if full else ""))
    return r


def bn_inputs(torch, g, shape, dtype, channels_first):
    """x [B, L, C] on the card (channels-first: the view of a contiguous
    [B, C, L], as a convolution hands it over), conv-like (mean 0.5,
    deviation 2, one channel constant), bf16 or float32 scale and bias of
    x's dtype, running statistics and an incoming gradient in x's layout
    (as the step's ReLU hands it back)."""
    b, l, c = shape
    base = torch.randn((b, c, l) if channels_first else (b, l, c), generator=g, device="cuda")
    if channels_first:
        base[:, c // 2] = 0.75
    else:
        base[..., c // 2] = 0.75
    x = (base * 2.0 + 0.5).to(dtype)
    x = x.transpose(1, 2) if channels_first else x
    scale = (torch.rand(c, generator=g, device="cuda") + 0.5).to(dtype)
    bias = torch.randn(c, generator=g, device="cuda").to(dtype)
    stats = (torch.randn(c, generator=g, device="cuda") * 0.1,
             torch.rand(c, generator=g, device="cuda") + 0.5)
    gy = torch.randn(base.shape, generator=g, device="cuda").to(dtype)
    return x, scale, bias, stats, gy.transpose(1, 2) if channels_first else gy


def measure_bn(torch, g, shape, dtype_name, flush, full):
    """Check the train-mode BatchNorm kernels at shape ((B, L, C), the
    dtype name with ".channels_first" for that layout) against the plain
    versions on the card: y, the running statistics and ``stat`` forward,
    dx, dscale and dbias backward; time the forward (statistics with their
    finish, normalize) and the backward (sums with their finish, dx)
    beside their bounds. Returns the forward's row and the backward's;
    full: also each pass alone and the plain versions."""
    from tf_kaldi_speaker_tpu_torch.ops import batchnorm as bn

    dtype_s, _, lay = dtype_name.partition(".")
    dtype = getattr(torch, dtype_s)
    x, scale, bias, (mean, var), gy = bn_inputs(torch, g, shape, dtype, bool(lay))
    tol = BN_TOL[dtype_s]
    label = "batch_norm_train %s %s %s" % (dtype_s, lay or "rows", list(shape))
    rm, rv = mean.clone(), var.clone()
    y, stat, _ = bn._forward_cuda(x, scale, bias, rm, rv, 0.99, 1e-3)
    pm, pv = mean.clone(), var.clone()
    y0, stat0 = bn.batch_norm_train_plain(x, scale, bias, pm, pv, 0.99, 1e-3)
    if y.stride() != x.stride():
        raise AssertionError("%s: y strides %s, x's %s" % (label, y.stride(), x.stride()))
    fwd = dict(max_abs_err=check_close(label + " y vs plain", y, y0, quiet=not full, **tol))
    for name, a, b in (("running mean", rm, pm), ("running var", rv, pv), ("stat", stat, stat0)):
        check_close("%s %s vs plain" % (label, name), a, b, atol=1e-5, rtol=1e-5, quiet=not full)
    got = bn.batch_norm_train_backward(x, gy, stat, dtype)
    if not all(torch.equal(a, b) for a, b in zip(got, bn.batch_norm_train_backward(
            x, gy, stat, dtype))):
        raise AssertionError("%s: two backward launches on one input differ" % label)
    want = bn.batch_norm_train_backward_plain(x, gy, stat, dtype)
    errs = [check_close("%s %s vs plain" % (label, name), a, b, quiet=not full, **dict(
        tol, atol=tol["atol"] * max(float(b.float().abs().max()), 1.0)))
        for name, a, b in zip(("dx", "dscale", "dbias"), got, want)]
    bwd = dict(max_abs_err=max(errs))
    costs = bn_cost(x.numel(), x.element_size())
    if full:  # each pass alone, on the wrapper's geometry and workspace
        launch = bn._Launch(x, (x.data_ptr(), y.data_ptr(), gy.data_ptr(), got[0].data_ptr()))
        coef = torch.empty((2, shape[-1]), dtype=torch.float32, device="cuda")
        dx, ds, db = (torch.empty_like(t) for t in got)
        calls = {"stats": lambda: bn._stats(x, scale, rm, rv, stat, 0.99, 1e-3, launch),
                 "normalize": lambda: bn._normalize(x, y, stat, bias, launch),
                 "grad_stats": lambda: bn._grad_stats(x, gy, stat, coef, ds, db, launch),
                 "grad": lambda: bn._grad(x, gy, dx, stat, coef, launch)}
    for row, kernels, fn in (
            (fwd, ("stats", "normalize"), lambda: bn._forward_cuda(x, scale, bias, rm, rv, 0.99,
                                                                   1e-3)),
            (bwd, ("grad_stats", "grad"), lambda: bn.batch_norm_train_backward(x, gy, stat,
                                                                               dtype))):
        row["ms"] = time_ms(torch, fn, flush)
        row["bound_ms"], row["bound_by"] = bound_ms(*map(sum, zip(*(costs[k] for k in kernels))))
        for k in kernels if full else ():
            row[k + "_ms"] = time_ms(torch, calls[k], flush)
            row[k + "_bound_ms"] = bound_ms(*costs[k])[0]
        if full:
            row["plain_ms"] = time_ms(
                torch, (lambda: bn.batch_norm_train_plain(x, scale, bias, pm, pv, 0.99, 1e-3))
                if row is fwd else (lambda: bn.batch_norm_train_backward_plain(x, gy, stat,
                                                                               dtype)), flush)
        print("%s%s: kernels %.4f ms, bound %.4f ms (%s): %.1f%% of bound%s" % (
            label, "" if row is fwd else " backward", row["ms"], row["bound_ms"],
            row["bound_by"], 100 * row["bound_ms"] / row["ms"], "; %s; plain %.4f ms" % (
                ", ".join("%s %.4f ms (%.1f%%)" % (
                    k, row[k + "_ms"], 100 * row[k + "_bound_ms"] / row[k + "_ms"])
                    for k in kernels), row["plain_ms"]) if full else ""))
    return fwd, bwd


# phase 3's fixed shapes: the dequant at a device-pipe batch and at a
# bandwidth-bound one; the pooling at the pooling layer of a 400-frame
# bucket; its backward at the train step's middle bucket (L = 300 frames
# in); both at phase 32's pooling width and ResNet34's two short frame
# axes, with the key that prefixes each one's fields in the kernel's row
FIXED_DEQUANT = ((32, 400, FEAT_DIM), (256, 1200, FEAT_DIM))
FIXED_POOLING = (((32, 386, 1500), "bfloat16", ""), ((32, 386, 1500), "float32", "f32_"),
                 ((64, 286, 256), "bfloat16", "d256_"),
                 ((64, 25, 1024), "float32", "f32_l25_"),
                 ((64, 46, 1024), "float32", "f32_l46_"))
FIXED_POOLING_BWD = (((64, 286, 1500), "bfloat16", ""), ((64, 286, 1500), "float32", "f32_"),
                     ((64, 286, 256), "bfloat16", "d256_"),
                     ((64, 25, 1024), "float32", "f32_l25_"),
                     ((64, 46, 1024), "float32", "f32_l46_"))
# the train-mode BatchNorm at the pool cell's middle bucket (L = 300
# frames in): tdnn1-3 (channels-first), tdnn5 (rows) and tdnn6-7
FIXED_BN = (((256, 286, 512), "bfloat16.channels_first", ""),
            ((256, 286, 1500), "bfloat16", "d1500_"), ((256, 1, 512), "bfloat16", "utt_"))


def check_kernels(torch, flush):
    """Each kernel against its plain version at fixed shapes: dequant at a
    device-pipe batch [32, 400, 30] and at a bandwidth-bound [256, 1200, 30];
    pooling at the pooling layer of a 400-frame bucket [32, 386, 1500], in
    bf16 (the flagship's compute dtype, the row's own numbers) and f32; its
    backward at [64, 286, 1500] in both; both at [64, 286, 256] bf16 and
    [64, 25 | 46, 1024] f32; the train-mode BatchNorm's forward and backward
    at the pool cell's shapes (FIXED_BN). Returns each kernel's JSON row."""
    g = torch.Generator().manual_seed(0)
    rows = {}
    deq, wide = (measure_dequant(torch, g, shape, flush, True) for shape in FIXED_DEQUANT)
    rows["cm_dequantize"] = dict(shape=list(FIXED_DEQUANT[0]), **deq)
    rows["cm_dequantize"].update(
        {"wide_" + k: v for k, v in dict(shape=list(FIXED_DEQUANT[1]), **wide).items()})
    for shape, dtype, key in FIXED_POOLING:
        r = measure_pooling(torch, torch.Generator().manual_seed(0), shape,
                            getattr(torch, dtype), flush, True)
        row = rows.setdefault("masked_stats_pooling", {})
        row.update({key + k: v for k, v in dict(shape=list(shape), dtype=dtype, **r).items()})
    for shape, dtype, key in FIXED_POOLING_BWD:
        gdev = torch.Generator(device="cuda").manual_seed(0)
        r = measure_pooling_bwd(torch, gdev, shape, getattr(torch, dtype), flush, True)
        row = rows.setdefault("masked_stats_pooling_backward", {})
        row.update({key + k: v for k, v in dict(shape=list(shape), dtype=dtype, **r).items()})
    for shape, dtype, key in FIXED_BN:
        gdev = torch.Generator(device="cuda").manual_seed(0)
        for name, r in zip(("batch_norm_train", "batch_norm_train_backward"),
                           measure_bn(torch, gdev, shape, dtype, flush, True)):
            row = rows.setdefault(name, {})
            row.update({key + k: v for k, v in dict(shape=list(shape), dtype=dtype, **r).items()})
    for name in SOURCES:
        row = rows[name]
        row["max_abs_err"] = max(v for k, v in row.items() if k.endswith("max_abs_err"))
    return rows


def replay_mix(torch, shapes, rows, flush, prefix="mix_"):
    """Every (shape, dtype) a main path launched, through kernel and plain
    version on fresh inputs, and the mix's time: sum of count x median
    kernel time, against sum of count x bound (and, for dequant, of count x
    a copy of the same bytes); written to each row under ``prefix``."""
    REPLAYED[prefix] = {name: [[list(shape), dtype, count]
                               for (shape, dtype), count in sorted(counter.items())]
                        for name, counter in shapes.items()}
    g = torch.Generator().manual_seed(1)
    gdev = torch.Generator(device="cuda").manual_seed(1)
    for name, counter in shapes.items():
        mix = {prefix + "ms": 0.0, prefix + "bound_ms": 0.0}
        for (shape, dtype), count in sorted(counter.items()):
            if name == "cm_dequantize":
                r = measure_dequant(torch, g, shape, flush, False)
            elif name.startswith("batch_norm_train"):
                r = measure_bn(torch, gdev, shape, dtype, flush, False)[
                    name == "batch_norm_train_backward"]
            elif name == "masked_stats_pooling":
                r = measure_pooling(torch, gdev, shape, getattr(torch, dtype), flush, False)
            else:
                r = measure_pooling_bwd(torch, gdev, shape, getattr(torch, dtype), flush, False)
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], r["max_abs_err"])
            for key in ("ms", "bound_ms", "copy_ms"):
                if r.get(key) is not None:
                    mix[prefix + key] = mix.get(prefix + key, 0.0) + count * r[key]
            print("  x%d launches on the path; matches plain, max abs err %.3g"
                  % (count, r["max_abs_err"]))
        rows[name].update(mix, **{prefix + "shapes": len(counter),
                                  prefix + "launches": sum(counter.values())})
        print("%s%s: %d launches over %d shapes, %.4f ms against a bound of %.4f ms "
              "(%.1f%%)%s" % (
                  prefix, name, sum(counter.values()), len(counter), mix[prefix + "ms"],
                  mix[prefix + "bound_ms"], 100 * mix[prefix + "bound_ms"] / mix[prefix + "ms"],
                  "; copies of the same bytes %.4f ms" % mix[prefix + "copy_ms"]
                  if prefix + "copy_ms" in mix else ""))


# the mixes replay_mix replayed in this run, by prefix: {kernel: [[shape,
# dtype, count], ...]}; main() writes them to SHAPES_JSON, which
# ``--kernels`` reads back
REPLAYED = {}
SHAPES_JSON = os.path.join(WORK_DIR, "kernel_shapes.json")


def replay_saved(torch, path, rows, flush):
    """replay_mix over every mix a full run wrote to ``path``."""
    with open(path) as f:
        saved = json.load(f)
    for prefix, by_name in saved.items():
        replay_mix(torch, {name: collections.Counter({(tuple(shape), dtype): count
                                                      for shape, dtype, count in entries})
                           for name, entries in by_name.items()}, rows, flush, prefix=prefix)


def write_model_dir(torch, root):
    from tf_kaldi_speaker_tpu_torch.convert import variables_from_network
    from tf_kaldi_speaker_tpu_torch.models.layers import BatchNorm
    from tf_kaldi_speaker_tpu_torch.models.tdnn import EntireNetwork
    from tf_kaldi_speaker_tpu_torch.train.checkpoints import save_checkpoint

    g = torch.Generator().manual_seed(0)
    net = EntireNetwork(FLAGSHIP, FEAT_DIM, generator=g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                w = m.mean.shape[0]
                m.mean.copy_(torch.randn(w, generator=g) * 0.1)
                m.var.copy_(torch.rand(w, generator=g) * 1.5 + 0.5)
                m.scale.copy_(torch.rand(w, generator=g) * 0.4 + 0.8)
                m.bias.copy_(torch.randn(w, generator=g) * 0.1)
    v = variables_from_network(net)
    nnet = os.path.join(root, "nnet")
    save_checkpoint(nnet, {"params": {"network": v["params"]},
                           "batch_stats": {"network": v["batch_stats"]}}, 0)
    with open(os.path.join(nnet, "config.json"), "w") as f:
        json.dump(FLAGSHIP, f)
    with open(os.path.join(nnet, "feature_dim"), "w") as f:
        f.write("%d\n" % FEAT_DIM)
    return root


def write_ark(root):
    """64 utterances of 200-1200 frames whose C0 column is VAD-stable:
    voiced frames near +20 log-energy, silence near -20."""
    from tf_kaldi_speaker_tpu_torch.kio import ArkScpWriter

    rng = np.random.RandomState(0)
    ark, scp = os.path.join(root, "feats.ark"), os.path.join(root, "feats.scp")
    w = ArkScpWriter("ark,scp:%s,%s" % (ark, scp), kind="mat")
    for i in range(N_UTTS):
        t = int(rng.randint(200, 1201))
        f = rng.randn(t, FEAT_DIM).astype(np.float32)
        voiced = rng.rand(t) > 0.3
        f[:, 0] = np.where(voiced, 20.0, -20.0) + 0.1 * rng.randn(t)
        w.write("utt%02d" % i, f, compress=True)
    w.close()
    return scp


def cosine(a, b):
    """Cosine of two vectors, taken in float64 (a float32 dot product
    alone would blur 1 - cosine below about 1e-7)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def run_extraction(torch, model, scp, root):
    from tf_kaldi_speaker_tpu_torch.kio import read_vec_flt_scp
    from tf_kaldi_speaker_tpu_torch.cli import extract as cli_extract
    from tf_kaldi_speaker_tpu_torch.ops.cm_dequant import cm_dequantize
    from tf_kaldi_speaker_tpu_torch.ops.pooling import masked_stats_pooling

    flags = ["--cmvn", "--vad", "--batch-size", "32", "--device", "cuda"]

    def extract(name, extra):
        out = os.path.join(root, name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli_extract.main(extra + flags + [
            model, "scp:" + scp, "ark,scp:%s.ark,%s.scp" % (out, out)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError("cli.extract %s exited %d" % (name, rc))
        return dict(read_vec_flt_scp(out + ".scp")), dt

    extract("warmup", ["--device-pipe"])  # CUDA context, cuBLAS/cuDNN set-up

    wrappers = {"cm_dequantize": cm_dequantize, "masked_stats_pooling": masked_stats_pooling}
    for fn in wrappers.values():
        fn.launches = 0
        fn.shapes.clear()
    dev, dt_dev = extract("device_pipe", ["--device-pipe"])
    launches = {name: fn.launches for name, fn in wrappers.items()}
    shapes = {name: collections.Counter(fn.shapes) for name, fn in wrappers.items()}
    print("main path (cli.extract --device-pipe --cmvn --vad) launches: %s"
          % json.dumps(launches))
    for name, n in launches.items():
        if n <= 0 or sum(shapes[name].values()) != n:
            raise AssertionError("the main path launched %s %d times at shapes %s"
                                 % (name, n, dict(shapes[name])))

    host, dt_host = extract("host", [])
    if set(dev) != set(host) or len(dev) != N_UTTS:
        raise AssertionError("key sets differ: %d device-pipe, %d host"
                             % (len(dev), len(host)))
    cos = min(cosine(dev[k], host[k]) for k in host)
    for k, e in dev.items():
        if e.shape != (512,) or not np.isfinite(e).all():
            raise AssertionError("%s: embedding shape %s or not finite" % (k, e.shape))
    if cos <= 0.999:
        raise AssertionError("device pipe vs host path: min cosine %.6f <= 0.999" % cos)
    print("device pipe vs host path (bf16): %d embeddings, min cosine %.6f (> 0.999) ok"
          % (len(dev), cos))
    print("extraction, %d utterances of 200-1200 frames, whole cli.extract run: "
          "device pipe %.3f s = %.1f emb/s; host path %.3f s = %.1f emb/s"
          % (N_UTTS, dt_dev, N_UTTS / dt_dev, dt_host, N_UTTS / dt_host))
    return launches, shapes, host


def check_reference(torch, model, scp, host):
    """The card's bf16 embeddings against a float32 CPU forward of the same
    checkpoint (plain pooling) on four utterances."""
    from tf_kaldi_speaker_tpu_torch.kio import read_mat_scp
    from tf_kaldi_speaker_tpu_torch.cli.extract import apply_cmvn_vad
    from tf_kaldi_speaker_tpu_torch.convert import network_from_variables
    from tf_kaldi_speaker_tpu_torch.train.checkpoints import load_checkpoint

    raw, _ = load_checkpoint(os.path.join(model, "nnet"))
    net = network_from_variables({"params": raw["params"]["network"],
                                  "batch_stats": raw["batch_stats"]["network"]}, FLAGSHIP)
    cos = 1.0
    for i, (key, mat) in enumerate(read_mat_scp(scp)):
        if i == 4:
            break
        feat = torch.from_numpy(apply_cmvn_vad(mat, True, True))[None]
        with torch.no_grad():
            want = net(feat)[1][FLAGSHIP["embedding_node"]][0].numpy()
        cos = min(cos, cosine(want, host[key]))
    if cos <= 0.99:
        raise AssertionError("card bf16 vs CPU float32 forward: min cosine %.6f <= 0.99" % cos)
    print("card bf16 vs CPU float32 forward, 4 utterances unpadded: "
          "min cosine %.6f (> 0.99) ok" % cos)


def run_server(model, scp):
    from tf_kaldi_speaker_tpu_torch.kio import read_mat_scp
    from tf_kaldi_speaker_tpu_torch.cli.extract import apply_cmvn_vad
    from tf_kaldi_speaker_tpu_torch.extract.server import EmbeddingServer, embed_remote

    feats = []
    for i, (_, mat) in enumerate(read_mat_scp(scp)):
        if i == 16:
            break
        feats.append(apply_cmvn_vad(mat, True, True))
    server = EmbeddingServer(model, batch_size=8, max_wait_ms=20.0, device="cuda")
    addr = server.start_background()
    results = [None] * len(feats)
    latency = [None] * len(feats)
    try:
        def client(t):
            for i in (t, t + 8):  # 2 requests from each of 8 threads
                t0 = time.perf_counter()
                results[i] = embed_remote(addr, feats[i])
                latency[i] = time.perf_counter() - t0

        threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        wall = time.perf_counter() - t0
        worst = 0.0
        for i, f in enumerate(feats):
            if results[i] is None:
                raise AssertionError("request %d got no reply" % i)
            direct = server.extractor.embed_utterance(f)
            # bf16 forwards at other batch shapes round differently
            err = float(np.abs(results[i] - direct).max())
            scale = float(np.abs(direct).max())
            if cosine(results[i], direct) <= 0.999 or err > 0.02 * scale:
                raise AssertionError("request %d: reply differs from embed_utterance "
                                     "(max abs err %.3g, max |emb| %.3g)" % (i, err, scale))
            worst = max(worst, err / scale)
    finally:
        server.shutdown()
    print("server: 16 requests from 8 threads in %.3f s, median latency %.1f ms; "
          "replies == embed_utterance within max abs err %.3g x max|emb| "
          "(limit 0.02, cosine > 0.999) ok"
          % (wall, 1e3 * float(np.median(latency)), worst))


def write_corpus(root):
    """Compressed synthetic train and valid dirs, 30-dim: 96 speakers x 4
    utterances of 450-900 frames, and 16 other speakers x 2. Speaker means
    and per-utterance channel offsets of equal scale keep the speakers
    overlapping, so the loss does not collapse within the run."""
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    kw = dict(dim=FEAT_DIM, min_len=450, max_len=900, spk_scale=1.0, chan_scale=1.0)
    train = make_fake_data_dir(os.path.join(root, "train"), num_speakers=96,
                               utts_per_speaker=4, seed=0, **kw)
    valid = make_fake_data_dir(os.path.join(root, "valid"), num_speakers=16,
                               utts_per_speaker=2, seed=1, spk_offset=96, **kw)
    return train, valid


def kernel_wrappers():
    """The five kernel wrappers by name; each counts its launches."""
    from tf_kaldi_speaker_tpu_torch.ops.batchnorm import (
        batch_norm_train, batch_norm_train_backward)
    from tf_kaldi_speaker_tpu_torch.ops.cm_dequant import cm_dequantize
    from tf_kaldi_speaker_tpu_torch.ops.pooling import (
        masked_stats_pooling, masked_stats_pooling_backward)

    return {"cm_dequantize": cm_dequantize, "masked_stats_pooling": masked_stats_pooling,
            "masked_stats_pooling_backward": masked_stats_pooling_backward,
            "batch_norm_train": batch_norm_train,
            "batch_norm_train_backward": batch_norm_train_backward}


def write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def drive(torch, main_fn, argv, capture=None, waits=None):
    """Run a CLI's ``main(argv)`` in this process as one main path: every
    kernel's launch and shape counters set to 0 just before and read just
    after; log records collected as (logger, message); each epoch's start
    (``Trainer.train`` or ``TrainerMultiInput.train``) and each group's end
    marked after a synchronize, at the entry and the exit of
    ``_post_group`` (the trainer does not synchronize itself).
    ``capture`` = (list, n): the first n ``train_step_raw`` inputs are
    copied to the host into the list. ``waits``: a list that gets the
    consumer's wait for each group from ``device_prefetch``, in seconds."""
    import logging

    from tf_kaldi_speaker_tpu_torch.train import trainer as trainer_mod
    from tf_kaldi_speaker_tpu_torch.train import trainer_mi as trainer_mi_mod

    logged, marks = [], []  # marks: (kind, step, time)
    handler = logging.Handler()
    handler.emit = lambda record: logged.append((record.name, record.getMessage()))
    Trainer, TrainerMI = trainer_mod.Trainer, trainer_mi_mod.TrainerMultiInput
    train_fn, post_group, step_raw = Trainer.train, Trainer._post_group, Trainer.train_step_raw
    train_mi_fn, prefetch = TrainerMI.train, trainer_mod.device_prefetch

    def mark(self, kind):
        torch.cuda.synchronize()
        marks.append((kind, self.step, time.perf_counter()))

    def timed_train(self, *args, **kw):
        mark(self, "start")
        return train_fn(self, *args, **kw)

    def timed_train_mi(self, *args, **kw):
        mark(self, "start")
        return train_mi_fn(self, *args, **kw)

    def timed_prefetch(*args, **kw):
        inner = prefetch(*args, **kw)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(inner)
                except StopIteration:
                    return
                waits.append(time.perf_counter() - t0)
                yield item
        finally:
            inner.close()

    def timed_post_group(self, *args, **kw):
        mark(self, "group")
        try:
            return post_group(self, *args, **kw)
        finally:
            mark(self, "posted")

    def captured_step_raw(self, codes, headers, labels, lr):
        if len(capture[0]) < capture[1]:
            capture[0].append(tuple(t.cpu().numpy() for t in (codes, headers, labels)))
        return step_raw(self, codes, headers, labels, lr)

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
        fn.shapes.clear()
    Trainer.train, Trainer._post_group = timed_train, timed_post_group
    TrainerMI.train = timed_train_mi
    if capture is not None:
        Trainer.train_step_raw = captured_step_raw
    if waits is not None:
        trainer_mod.device_prefetch = trainer_mi_mod.device_prefetch = timed_prefetch
    logging.getLogger().addHandler(handler)
    try:
        t0 = time.perf_counter()
        rc = main_fn(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Trainer.train, Trainer._post_group = train_fn, post_group
        Trainer.train_step_raw, TrainerMI.train = step_raw, train_mi_fn
        trainer_mod.device_prefetch = trainer_mi_mod.device_prefetch = prefetch
        logging.getLogger().removeHandler(handler)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    shapes = {name: collections.Counter(fn.shapes) for name, fn in wrappers.items()}
    return dict(rc=rc, launches=launches, shapes=shapes, logged=logged, marks=marks, wall=wall)


def check_launched(path, run, names):
    """Each kernel of ``names`` launched on the path, every launch counted
    once by shape; returns the path's launches of every kernel."""
    launches, shapes = run["launches"], run["shapes"]
    print("%s launches: %s" % (path, json.dumps(launches)))
    for name in names:
        n = launches[name]
        if n <= 0 or sum(shapes[name].values()) != n:
            raise AssertionError("the %s path launched %s %d times at shapes %s"
                                 % (path, name, n, dict(shapes[name])))
    return launches


def group_times(marks, n):
    """The second epoch (steps n..2n) from the marks: each group's time
    from the end of the previous one's bookkeeping (the epoch's start for
    the first) to its own end, and the time from the epoch's start to its
    last group's end (the bookkeeping between groups is in it, the last
    group's and the epoch's end are not)."""
    epoch2 = [(kind, t) for kind, step, t in marks
              if (kind, step) == ("start", n) or (kind != "start" and step > n)]
    groups, prev = [], None
    for kind, t in epoch2:
        if kind == "group":
            groups.append(t - prev)
            last = t
        prev = t
    return groups, last - epoch2[0][1]


def run_training(torch, root, train, valid):
    """cli.train from the device pool (the training path). Returns the
    launches and shapes of the five kernels on this path, the model dir
    and the second epoch's step time."""
    from tf_kaldi_speaker_tpu_torch.cli import train as cli_train

    model = os.path.join(root, "trained")
    cfg_path = write_json(os.path.join(root, "train.json"), TRAIN)
    run = drive(torch, cli_train.main, ["--config", cfg_path, "--device", "cuda", train["data"],
                                        train["spklist"], valid["data"], valid["spklist"], model])
    if run["rc"] != 0:
        raise RuntimeError("cli.train exited %d" % run["rc"])
    launches = check_launched("training path (cli.train, device pool, bf16)", run,
                              kernel_wrappers())
    losses = [float(m.split("loss ")[1].split()[0]) for name, m in run["logged"]
              if name == "tfks_torch.trainer" and " loss " in m]
    steps = TRAIN["num_epochs"] * TRAIN["num_steps_per_epoch"]
    if len(losses) != steps // TRAIN["steps_per_dispatch"] or not np.all(np.isfinite(losses)):
        raise AssertionError("logged losses %s (expected %d finite)" % (
            losses, steps // TRAIN["steps_per_dispatch"]))
    with open(os.path.join(model, "nnet", "valid_loss")) as f:
        valid_lines = f.read().split()
    print("logged group losses %s; valid_loss file %s" % (losses, valid_lines))
    k, n = TRAIN["steps_per_dispatch"], TRAIN["num_steps_per_epoch"]
    groups, epoch_s = group_times(run["marks"], n)
    step_ms = 1e3 * float(np.median(groups)) / k
    rate = n * TRAIN["num_speakers_per_batch"] / epoch_s
    print("train step (%s), second epoch (%d groups of %d steps, bf16, batch %d x 200-400 "
          "frames): median %.3f ms per step (group times %s s), %.1f chunks/s; whole cli.train "
          "run %.2f s" % (CARD, len(groups), k, TRAIN["num_speakers_per_batch"], step_ms,
                          ["%.4f" % g for g in groups], rate, run["wall"]))
    return launches, run["shapes"], model, dict(step_ms=step_ms, chunks_per_s=rate)


def stream_config():
    """The fisher v1 recipe config with STREAM_CUTS."""
    with open(FISHER_CONF) as f:
        return dict(json.load(f), **STREAM_CUTS)


def first_loader_group(train, cfg, K, worker):
    """The first group that one loader worker yields: the trainer's loader
    (seed + epoch-start step 0) with that worker's seed and one thread."""
    from tf_kaldi_speaker_tpu_torch.data import KaldiDataRandomQueue

    q = KaldiDataRandomQueue(
        train["data"], train["spklist"], num_parallel=1, max_qsize=1,
        num_speakers=int(cfg.get("num_speakers_per_batch", 64)),
        num_segments=int(cfg.get("num_segments_per_speaker", 1)),
        min_len=int(cfg.get("min_segment_len", 200)), max_len=int(cfg.get("max_segment_len", 400)),
        seed=int(cfg.get("seed", 0)) + worker, num_buckets=int(cfg.get("num_buckets", 8)),
        raw_codes=True, group=K).start()
    try:
        return q.fetch()
    finally:
        q.stop()


def find_worker_group(train, cfg, K, first):
    """The worker whose first group equals, byte for byte, the K batches
    ``first`` (codes, headers, labels as they reached the card), and the
    mean time one worker alone took to yield its first group."""
    got = tuple(np.stack([b[i] for b in first]) for i in range(3))
    times = []
    for worker in range(int(cfg.get("num_parallel_datasets", 4))):
        t0 = time.perf_counter()
        want = first_loader_group(train, cfg, K, worker)
        times.append(time.perf_counter() - t0)
        if all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want)):
            return worker, float(np.mean(times))
    raise AssertionError("the first group on the card is no loader worker's first group")


def check_summaries(nnet, steps):
    """The summaries of a run: every tfevents file read back with the port's
    reader and the JSONL log hold the JAX step's scalar tags at ``steps``."""
    from tf_kaldi_speaker_tpu_torch.utils.summary import load_scalars
    from tf_kaldi_speaker_tpu_torch.utils.tb_events import read_tfevents

    files = sorted(glob.glob(os.path.join(nnet, "events.out.tfevents.*")))
    scalars = {}
    for path in files:
        for tag, values in read_tfevents(path).items():
            scalars.setdefault(tag, []).extend(values)
    jsonl = load_scalars(os.path.join(nnet, "events.jsonl"))
    for name, got in (("tfevents", scalars), ("events.jsonl", jsonl)):
        if sorted(got) != SCALAR_TAGS:
            raise AssertionError("%s tags %s, not %s" % (name, sorted(got), SCALAR_TAGS))
        for tag, values in got.items():
            if sorted(s for s, _ in values) != steps or not np.all(np.isfinite(
                    [v for _, v in values])):
                raise AssertionError("%s %s: %s, not finite values at steps %s"
                                     % (name, tag, values, steps))
    return len(files)


def run_stream_training(torch, root, train, valid):
    """cli.train from the streaming loader with the fisher v1 config (the
    third main path). Returns the run, the model dir and the second epoch's
    step time."""
    from tf_kaldi_speaker_tpu_torch.cli import train as cli_train

    cfg = stream_config()
    K = int(cfg.get("steps_per_dispatch", 8))  # the trainer's default
    n = cfg["num_steps_per_epoch"]
    model = os.path.join(root, "stream")
    cfg_path = write_json(os.path.join(root, "stream.json"), cfg)
    first = []
    native_counts_reset()
    run = drive(torch, cli_train.main,
                ["--config", cfg_path, "--device", "cuda", train["data"], train["spklist"],
                 valid["data"], valid["spklist"], model], capture=(first, K))
    if run["rc"] != 0:
        raise RuntimeError("cli.train (streaming) exited %d" % run["rc"])
    check_no_fallback("streaming path (cli.train)", native_counts(), "read_batch_codes")
    check_launched("streaming path (cli.train, fisher v1 config: float32, device_decode, "
                   "two-pass pooling)", run, ["cm_dequantize"])
    print("  dequant shapes on the path: %s" % sorted(
        ("x".join(map(str, shape)), count)
        for (shape, _), count in run["shapes"]["cm_dequantize"].items()))
    nnet = os.path.join(model, "nnet")
    with open(os.path.join(nnet, "valid_loss")) as f:
        valid_lines = f.read().split("\n")[:-1]
    if len(valid_lines) != cfg["num_epochs"]:
        raise AssertionError("valid_loss %s" % valid_lines)
    groups, epoch_s = group_times(run["marks"], n)
    step_ms = 1e3 * float(np.median(groups)) / K
    rate = n * cfg["num_speakers_per_batch"] / epoch_s
    print("streamed train step (%s), second epoch (%d groups of %d steps, float32, %d loader "
          "threads, batch %d x 200-400 frames of codes): median %.3f ms per step (group times "
          "%s s), %.1f chunks/s from the epoch's start, loader start-up included; whole "
          "cli.train run %.2f s"
          % (CARD, len(groups), K, cfg["num_parallel_datasets"], cfg["num_speakers_per_batch"],
             step_ms, ["%.4f" % g for g in groups], rate, run["wall"]))
    firsts = [t_group - t_start for (k0, _, t_start), (k1, _, t_group)
              in zip(run["marks"], run["marks"][1:]) if (k0, k1) == ("start", "group")]
    worker, alone_s = find_worker_group(train, cfg, K, first)
    print("first group on the card (%d batches of codes, headers, labels) == loader worker %d's "
          "first group on the host with one thread, byte for byte ok" % (K, worker))
    print("loader start-up (%s): each epoch's first group reached the end of its steps %s s "
          "after the epoch's start with %d threads; one worker alone yields its first group in "
          "%.3f s" % (CARD, ["%.3f" % t for t in firsts], cfg["num_parallel_datasets"], alone_s))
    nfiles = check_summaries(nnet, [8, 16, 24, 32])
    traces = glob.glob(os.path.join(nnet, "profile", "*.pt.trace.json"))
    if not traces:
        raise AssertionError("no Chrome trace under %s/profile" % nnet)
    print("summaries: %d tfevents file(s) read back with the port's reader, tags %s at steps "
          "8, 16, 24, 32 ok; %d Chrome trace(s) under nnet/profile ok"
          % (nfiles, SCALAR_TAGS, len(traces)))
    return run, model, dict(stream_step_ms=step_ms, stream_chunks_per_s=rate,
                            stream_group_s=groups, stream_first_group_s=firsts,
                            loader_one_worker_group_s=alone_s)


def device_busy(torch, prof):
    """The device's busy seconds (the union of its kernels' spans) under a
    torch.profiler run, its event count, and device time by kernel name."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.end - e.time_range.start
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    return 1e-6 * busy_us(spans), len(kernels), by_name


def busy_us(spans):
    """Length of the union of (start, end) spans."""
    busy, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def print_top(by_name, busy_s, top=12):
    for name, us in by_name.most_common(top):
        print("  %5.1f%%  %8.3f ms  %s" % (1e-4 * us / busy_s, us * 1e-3, name[:110]))


def profile_stream_group(torch, model, train):
    """One torch.profiler pass over a group of 8 float32 steps fed by the
    streaming loader (16 threads, raw codes, device_prefetch), after one
    group of warm-up: the device's busy and idle share. Then 3 groups
    timed without the profiler, each after a synchronize: the consumer's
    wait for the loader against the group's time, and the same 8 steps
    on a group already on the card (no loader)."""
    from torch.profiler import ProfilerActivity, profile

    from tf_kaldi_speaker_tpu_torch.data import KaldiDataRandomQueue, device_prefetch

    t = _trainer_at(torch, model, "cuda", "float32")
    cfg = t.params.dict
    K, lr = 8, float(cfg["learning_rate"])
    loader = KaldiDataRandomQueue(
        train["data"], train["spklist"], num_parallel=int(cfg["num_parallel_datasets"]),
        max_qsize=int(cfg["max_queue_size"]), num_speakers=int(cfg["num_speakers_per_batch"]),
        min_len=int(cfg["min_segment_len"]), max_len=int(cfg["max_segment_len"]), seed=11,
        raw_codes=True, group=K).start()
    stream = device_prefetch(iter(loader), "cuda")

    def steps(batch):
        for k in range(K):
            t.train_step_raw(batch[0][k], batch[1][k], batch[2][k], lr)

    try:
        steps(next(stream))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            batch = next(stream)
            steps(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        waits, totals = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            batch = next(stream)
            t1 = time.perf_counter()
            steps(batch)
            torch.cuda.synchronize()
            waits.append(t1 - t0)
            totals.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        steps(batch)
        torch.cuda.synchronize()
        fixed = time.perf_counter() - t0
    finally:
        stream.close()
        loader.stop()
    busy_s, n_events, by_name = device_busy(torch, prof)
    if not n_events:
        print("profile: no device events in the trace; device idle share not measured")
        return None
    print("profile (%s), 8 float32 streamed steps [64, L, 30] codes under torch.profiler: wall "
          "%.4f s, device busy %.4f s, device idle %.1f%%, %d device events"
          % (CARD, wall, busy_s, 100 * (1 - busy_s / wall), n_events))
    print_top(by_name, busy_s)
    print("streamed groups of 8 steps (%s), each after a synchronize: wait for the loader %s s "
          "of group times %s s; the same 8 steps on a group already on the card %.4f s"
          % (CARD, ["%.4f" % w for w in waits], ["%.4f" % w for w in totals], fixed))
    return dict(stream_profile_wall_s=wall, stream_profile_busy_s=busy_s,
                stream_device_idle=1 - busy_s / wall, stream_loader_wait_s=waits,
                stream_synced_group_s=totals, stream_group_on_card_s=fixed)


def check_stream_step_against_cpu(torch, model, train):
    """One float32 train step on the card (TF32 off) against the port's
    float32 CPU step, both from a trained dir's final state, on one
    streamed batch of raw codes: loss within CPU_GAP relative."""
    from tf_kaldi_speaker_tpu_torch.data import KaldiDataRandomQueue

    gpu = _trainer_at(torch, model, "cuda", "float32")
    cpu = _trainer_at(torch, model, "cpu", "float32")
    cfg = gpu.params.dict
    q = KaldiDataRandomQueue(train["data"], train["spklist"], num_parallel=1, max_qsize=1,
                             num_speakers=int(cfg["num_speakers_per_batch"]), seed=13,
                             raw_codes=True).start()
    try:
        codes, headers, labels = (torch.from_numpy(a) for a in q.fetch())
    finally:
        q.stop()
    lr = float(cfg["learning_rate"])
    loss_gpu = float(gpu.train_step_raw(codes.cuda(), headers.cuda(), labels.cuda(), lr)["loss"])
    loss_cpu = float(cpu.train_step_raw(codes, headers, labels, lr)["loss"])
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    if not (np.isfinite(loss_gpu) and rel < CPU_GAP):
        raise AssertionError("card float32 loss %.6f vs CPU float32 %.6f (rel %.3g >= %g)"
                             % (loss_gpu, loss_cpu, rel, CPU_GAP))
    print("one streamed train step %s, card float32 (TF32 off) vs CPU float32 from the state of "
          "%s: loss %.6f vs %.6f, gap %.3g relative (< %g) ok"
          % (list(codes.shape), os.path.basename(model), loss_gpu, loss_cpu, rel, CPU_GAP))
    return rel


def run_preemption(root, train, valid):
    """cli.train (streaming, fisher v1 config with PREEMPT_CUTS) in a child
    process: SIGTERM after its first progress line must give exit 75, a
    checkpoint at a multiple of K = 8 and no valid_loss line; ``--cont``
    must then finish the epoch (exit 0, checkpoint at num_steps_per_epoch,
    one validation line)."""
    from tf_kaldi_speaker_tpu_torch.train.checkpoints import read_pointer
    from tf_kaldi_speaker_tpu_torch.utils.bookkeeping import load_valid_loss

    with open(FISHER_CONF) as f:
        cfg = dict(json.load(f), **PREEMPT_CUTS)
    n = cfg["num_steps_per_epoch"]
    model = os.path.join(root, "preempt")
    nnet = os.path.join(model, "nnet")
    cfg_path = write_json(os.path.join(root, "preempt.json"), cfg)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "tf_kaldi_speaker_tpu_torch.cli.train", "--device", "cuda"]
    args = [train["data"], train["spklist"], valid["data"], valid["spklist"], model]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd + ["--config", cfg_path] + args, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if "step " in line and ": loss" in line:
                break
        else:
            raise RuntimeError("cli.train exited before a progress line:\n" + "".join(lines))
        seen = int(line.split("step ")[1].split(":")[0])
        proc.send_signal(signal.SIGTERM)
        t_sig = time.perf_counter()
        lines.extend(proc.stdout)
        rc = proc.wait(timeout=300)
        t_exit = time.perf_counter()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    tail = "".join(lines[-30:])
    step = read_pointer(nnet)
    if rc != 75 or "preempted: checkpoint saved at step" not in tail:
        raise AssertionError("SIGTERM: exit %d, not 75:\n%s" % (rc, tail))
    if step is None or not 0 < step < n or step % 8:
        raise AssertionError("SIGTERM: checkpoint at step %s, not a multiple of 8 in (0, %d)"
                             % (step, n))
    if load_valid_loss(os.path.join(nnet, "valid_loss")):
        raise AssertionError("the cut epoch recorded a validation")
    cont = subprocess.run(cmd + ["--cont"] + args, cwd=ROOT, env=env, text=True, timeout=600,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    wall = time.perf_counter() - t0
    valid = load_valid_loss(os.path.join(nnet, "valid_loss"))
    if cont.returncode != 0 or read_pointer(nnet) != n or len(valid) != 1:
        raise AssertionError("--cont: exit %d, checkpoint %s, valid_loss %s, not 0, %d and one "
                             "line:\n%s" % (cont.returncode, read_pointer(nnet), valid, n,
                                            cont.stdout[-3000:]))
    print("preemption (%s): SIGTERM to cli.train after its progress line at step %d -> exit 75 "
          "%.2f s later with model-%d (a multiple of K = 8) and no valid_loss line; --cont -> "
          "exit 0 at step %d with one valid_loss line; round trip %.1f s in two processes ok"
          % (CARD, seen, t_exit - t_sig, step, n, wall))
    return dict(preempt_seen_step=seen, preempt_step=step, preempt_exit_s=t_exit - t_sig)


def _frozen(path, subs):
    return path[0] in ("params", "batch_stats") and any(s in "/".join(path[1:]) for s in subs)


def run_finetune(torch, root, trained, train, valid):
    """cli.make_checkpoint --checkpoint -1 on the trained pool dir, then
    cli.finetune from it (the fourth main path). Returns the run."""
    from tf_kaldi_speaker_tpu_torch.cli import finetune as cli_finetune
    from tf_kaldi_speaker_tpu_torch.cli import make_checkpoint as cli_make_checkpoint
    from tf_kaldi_speaker_tpu_torch.convert import flatten
    from tf_kaldi_speaker_tpu_torch.train.checkpoints import load_checkpoint, read_pointer

    pre_nnet = os.path.join(trained, "nnet")
    if cli_make_checkpoint.main(["--checkpoint", "-1", trained]) != 0:
        raise RuntimeError("cli.make_checkpoint failed")
    best = read_pointer(pre_nnet)
    ft = os.path.join(root, "finetune")
    cfg_path = write_json(os.path.join(root, "finetune.json"), FINETUNE)
    run = drive(torch, cli_finetune.main,
                ["--config", cfg_path, "--device", "cuda", "--pretrain_model", trained,
                 train["data"], train["spklist"], valid["data"], valid["spklist"], ft])
    if run["rc"] != 0:
        raise RuntimeError("cli.finetune exited %d" % run["rc"])
    check_launched("fine-tuning path (cli.finetune, device pool, bf16)", run, kernel_wrappers())
    before = [m for _, m in run["logged"] if m.startswith("BEFORE training: valid loss")]
    if not before:
        raise AssertionError("no 'BEFORE training' validation was logged")
    nnet = os.path.join(ft, "nnet")
    pre = flatten(load_checkpoint(pre_nnet, best)[0])
    start, _ = load_checkpoint(nnet, 0)
    final, final_step = load_checkpoint(nnet)
    if int(start["step"]) != 0 or final_step != FINETUNE["num_steps_per_epoch"]:
        raise AssertionError("fine-tuning started at step %s and ended at %d, not 0 and %d"
                             % (start["step"], final_step, FINETUNE["num_steps_per_epoch"]))
    final = flatten(final)
    frozen = [p for p in final if _frozen(p, FINETUNE["noupdate_var_list"])]
    for path in frozen:
        if not torch.equal(final[path], pre[path]):
            raise AssertionError("frozen %s changed" % "/".join(path))
    reinit = [p for p in final if _frozen(p, FINETUNE["noload_var_list"])]
    moved = ("params", "network", "tdnn", "tdnn3_conv", "kernel")
    for path in reinit + [moved]:
        if torch.equal(final[path], pre[path]):
            raise AssertionError("%s did not change" % "/".join(path))
    print("fine-tuning (%s): cli.make_checkpoint -1 -> model-%d; %s; %d frozen variables (two "
          "convs, two BatchNorms with their statistics) bit-equal to the pretrain checkpoint, "
          "re-initialized %s changed, tdnn3_conv moved; steps 0 -> %d; whole cli.finetune run "
          "%.2f s ok" % (CARD, best, before[0], len(frozen), ["/".join(p[1:]) for p in reinit],
                         final_step, run["wall"]))
    return run


def run_tune_lr(torch, root, train):
    """cli.train_lr_learning --tune_period 2 at flagship width from the
    streaming loader (the fifth main path), then cli.tune_lr. Returns the
    run."""
    from tf_kaldi_speaker_tpu_torch.cli import train_lr_learning as cli_lr
    from tf_kaldi_speaker_tpu_torch.cli import tune_lr as cli_tune_lr

    model = os.path.join(root, "tune_lr")
    cfg_path = write_json(os.path.join(root, "tune_lr.json"), FLAGSHIP)
    run = drive(torch, cli_lr.main, ["--config", cfg_path, "--tune_period", "2", "--device",
                                     "cuda", train["data"], train["spklist"], model])
    if run["rc"] != 0:
        raise RuntimeError("cli.train_lr_learning exited %d" % run["rc"])
    check_launched("LR-sweep path (cli.train_lr_learning, streaming loader, bf16)", run,
                   ["masked_stats_pooling", "masked_stats_pooling_backward"])
    rows = np.loadtxt(os.path.join(model, "learning_rate_tuning"), ndmin=2)
    ks, lrs, losses = rows[:, 0], rows[:, 1], rows[:, 2]
    broke = not np.isfinite(losses[-1]) or losses[-1] > 1e4
    if (not np.array_equal(ks, np.arange(len(rows))) or not np.isfinite(losses[:-1]).all()
            or (len(rows) < 100 and not broke)):
        raise AssertionError("learning_rate_tuning rows %s" % rows.tolist())
    if cli_tune_lr.main([model]) != 0:
        raise RuntimeError("cli.tune_lr failed")
    print("LR sweep (%s): %d sweeps of 2 steps, lr %.2e .. %.2e, loss finite%s; lowest loss "
          "%.4f at lr %.2e; whole cli.train_lr_learning run %.2f s ok"
          % (CARD, len(rows), lrs[0], lrs[-1],
             " until the break at k = %d (loss %s)" % (ks[-1], losses[-1]) if broke else "",
             np.nanmin(losses), lrs[int(np.nanargmin(losses))], run["wall"]))
    return run


def _trainer_at(torch, model, device, compute_dtype):
    """A Trainer in ``model``'s state (its last checkpoint)."""
    from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
    from tf_kaldi_speaker_tpu_torch.utils.params import Params

    nnet = os.path.join(model, "nnet")
    params = Params(os.path.join(nnet, "config.json"))
    params.dict["compute_dtype"] = compute_dtype
    with open(os.path.join(nnet, "feature_dim")) as f:
        dim = int(f.read())
    with open(os.path.join(nnet, "num_speakers")) as f:
        num_speakers = int(f.read())
    t = Trainer(params, nnet, dim=dim, num_speakers=num_speakers, device=device)
    t.build("train")
    t.load()
    return t


def _pool_group(torch, train, device, group, length, seed, cfg=None):
    """``group`` pool batches of ``cfg``'s speakers x segments (TRAIN's by
    default) at ``length`` frames."""
    from tf_kaldi_speaker_tpu_torch.data.device_pool import DevicePool, gather_chunks

    cfg = cfg or TRAIN
    pool = DevicePool(train["data"], train["spklist"], device=device, seed=seed)
    pool.stage()
    starts, utts, labels = (torch.from_numpy(a).to(device) for a in pool.sample_group(
        random.Random(seed), group, cfg["num_speakers_per_batch"],
        cfg.get("num_segments_per_speaker", 1), length))
    batches = [gather_chunks(pool.frames, pool.headers, starts[i], utts[i], length)
               + (labels[i],) for i in range(group)]
    pool.close()
    return batches


def profile_pool_steps(torch, model, train, cfg, seed):
    """One torch.profiler pass over a group of 8 bf16 steps of ``cfg``'s
    pool batches from ``model``'s state, after the same 8 as warm-up: the
    host's wall, the device's busy seconds, its event count and its time by
    kernel name."""
    t = _trainer_at(torch, model, "cuda", "bfloat16")
    batches = _pool_group(torch, train, "cuda", 8, 296, seed, cfg)
    for codes, hdr, lab in batches:
        t.train_step_raw(codes, hdr, lab, cfg["learning_rate"])
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for codes, hdr, lab in batches:
            t.train_step_raw(codes, hdr, lab, cfg["learning_rate"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return (wall,) + device_busy(torch, prof)


def profile_train_group(torch, model, train):
    """One torch.profiler pass over a group of 8 bf16 pool steps (after one
    group of warm-up): the device's busy and idle share of the host's wall
    time, and the kernels that take most of the device time."""
    wall, busy_s, n_events, by_name = profile_pool_steps(torch, model, train, TRAIN, 3)
    if not n_events:
        print("profile: no device events in the trace; device idle share not measured")
        return None
    print("profile (%s), 8 bf16 train steps [64, 296, 30] from the pool under torch.profiler: "
          "wall %.4f s, device busy %.4f s, device idle %.1f%%, %d device events"
          % (CARD, wall, busy_s, 100 * (1 - busy_s / wall), n_events))
    print_top(by_name, busy_s)
    return dict(profile_wall_s=wall, profile_busy_s=busy_s, device_idle=1 - busy_s / wall)


def check_step_against_cpu(torch, model, train):
    """One bf16 train step on the card against the port's float32 step on
    the CPU, both from the trained state, on one fixed pool batch: loss
    within 2e-2, and every updated parameter at cosine > 0.999 of the CPU's,
    except the biases that a BatchNorm follows (their gradient is zero in
    exact arithmetic; both sides hold rounding noise there)."""
    from tf_kaldi_speaker_tpu_torch.convert import flatten, variables_of

    (codes, hdr, lab), = _pool_group(torch, train, "cpu", 1, 296, 5)
    gpu = _trainer_at(torch, model, "cuda", "bfloat16")
    cpu = _trainer_at(torch, model, "cpu", "float32")
    before = flatten(variables_of(cpu.network_model))
    lr = TRAIN["learning_rate"]
    loss_gpu = float(gpu.train_step_raw(codes.cuda(), hdr.cuda(), lab.cuda(), lr)["loss"])
    loss_cpu = float(cpu.train_step_raw(codes, hdr, lab, lr)["loss"])
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    if not (np.isfinite(loss_gpu) and rel < 2e-2):
        raise AssertionError("card bf16 loss %.6f vs CPU float32 %.6f (rel %.3g >= 2e-2)"
                             % (loss_gpu, loss_cpu, rel))
    got = flatten(variables_of(gpu.network_model))
    want = flatten(variables_of(cpu.network_model))
    worst, worst_upd = 1.0, 1.0
    for path, w in want.items():
        if path[0] != "params" or (path[-1] == "bias" and path[-2].endswith(("_conv", "_dense"))):
            continue
        g, w, b = (t.double().ravel() for t in (got[path], w, before[path]))
        cos = float(g @ w / (g.norm() * w.norm()))
        if not cos > 0.999:
            raise AssertionError("%s: card vs CPU cosine %.6f <= 0.999" % ("/".join(path), cos))
        worst = min(worst, cos)
        du, dw = g - b, w - b
        worst_upd = min(worst_upd, float(du @ dw / (du.norm() * dw.norm())))
    print("one train step, card bf16 vs CPU float32 from the trained state: loss %.6f vs "
          "%.6f (rel %.2e < 2e-2); updated parameters min cosine %.6f (> 0.999); the "
          "updates themselves min cosine %.4f" % (loss_gpu, loss_cpu, rel, worst, worst_upd))


def extract_trained(model, scp, root):
    from tf_kaldi_speaker_tpu_torch.cli import extract as cli_extract
    from tf_kaldi_speaker_tpu_torch.kio import read_vec_flt_scp

    out = os.path.join(root, "trained_xvector")
    rc = cli_extract.main(["--device-pipe", "--batch-size", "32", "--device", "cuda", model,
                           "scp:" + scp, "ark,scp:%s.ark,%s.scp" % (out, out)])
    if rc != 0:
        raise RuntimeError("cli.extract from the trained model exited %d" % rc)
    emb = dict(read_vec_flt_scp(out + ".scp"))
    if len(emb) != N_UTTS or any(e.shape != (512,) or not np.isfinite(e).all()
                                 for e in emb.values()):
        raise AssertionError("trained model: %d embeddings, not %d finite 512-d ones"
                             % (len(emb), N_UTTS))
    print("cli.extract --device-pipe from the trained model dir: %d finite 512-d embeddings ok"
          % len(emb))


def zoo_config(name):
    """A zoo recipe config as shipped, with ZOO_CUTS and its override."""
    with open(os.path.join(VOX_CONF, name)) as f:
        return dict(json.load(f), **ZOO_CUTS, **ZOO_OVERRIDES.get(name, {}))


def zoo_kernels(cfg):
    """The kernels a zoo config's training path must launch: the dequant on
    either input branch (the pool's gather or ``device_decode``), the
    train-mode BatchNorm's, and the pooling forward and backward where the
    statistics pooling is fused."""
    fused = cfg.get("use_fused_pooling", False) and cfg["pooling_type"] == "statistics_pooling"
    return ["cm_dequantize", "batch_norm_train", "batch_norm_train_backward"] + (
        ["masked_stats_pooling", "masked_stats_pooling_backward"] if fused else [])


def run_zoo_training(torch, root, train, valid, name):
    """cli.train with one zoo config; returns the run, the model dir and
    the epoch's step times (the first group carries the loader's or the
    pool's start-up and the first launches of every kernel)."""
    from tf_kaldi_speaker_tpu_torch.cli import train as cli_train

    cfg = zoo_config(name)
    short = name[:-len(".json")]
    model = os.path.join(root, "zoo_" + short)
    cfg_path = write_json(os.path.join(root, "zoo_%s.json" % short), cfg)
    run = drive(torch, cli_train.main, ["--config", cfg_path, "--device", "cuda", train["data"],
                                        train["spklist"], valid["data"], valid["spklist"], model])
    if run["rc"] != 0:
        raise RuntimeError("cli.train %s exited %d" % (name, run["rc"]))
    branch = "device pool" if cfg.get("device_pool") else "streaming, device_decode"
    check_launched("zoo path %s (cli.train, %s, float32)" % (short, branch), run,
                   zoo_kernels(cfg))
    losses = [float(m.split("loss ")[1].split()[0]) for lname, m in run["logged"]
              if lname == "tfks_torch.trainer" and " loss " in m]
    K, n = cfg["steps_per_dispatch"], cfg["num_steps_per_epoch"]
    if len(losses) != n // K or not np.all(np.isfinite(losses)):
        raise AssertionError("%s: logged losses %s (expected %d finite)" % (name, losses, n // K))
    with open(os.path.join(model, "nnet", "valid_loss")) as f:
        valid_lines = f.read().split("\n")[:-1]
    if len(valid_lines) != 1 or not np.isfinite(float(valid_lines[0].split()[1])):
        raise AssertionError("%s: valid_loss %s" % (name, valid_lines))
    groups, epoch_s = group_times(run["marks"], 0)
    step_ms = 1e3 * float(np.median(groups)) / K
    steady_ms = 1e3 * groups[-1] / K
    rate = n * cfg["num_speakers_per_batch"] / epoch_s
    print("zoo train step %s (%s): %d groups of %d steps, float32, batch %d x %d-%d frames: "
          "median %.3f ms per step, %.3f ms in the last group (group times %s s, the first with "
          "start-up), %.1f chunks/s over the epoch; group losses %s, valid line %s; whole "
          "cli.train run %.2f s"
          % (short, CARD, len(groups), K, cfg["num_speakers_per_batch"], cfg["min_segment_len"],
             cfg["max_segment_len"], step_ms, steady_ms, ["%.4f" % g for g in groups], rate,
             losses, valid_lines[0], run["wall"]))
    return run, model, dict(step_ms=step_ms, last_group_step_ms=steady_ms, chunks_per_s=rate,
                            group_s=groups, wall_s=run["wall"])


def profile_zoo_group(torch, model, train, label):
    """One torch.profiler pass over a group of 8 float32 steps from the
    trained dir's state, on one loader group of raw codes already on the
    card, after the same group once as warm-up: the device's busy and idle
    share, and the kernels that take most of the device time."""
    from torch.profiler import ProfilerActivity, profile

    from tf_kaldi_speaker_tpu_torch.data import KaldiDataRandomQueue

    t = _trainer_at(torch, model, "cuda", "float32")
    cfg = t.params.dict
    q = KaldiDataRandomQueue(train["data"], train["spklist"], num_parallel=1, max_qsize=1,
                             num_speakers=int(cfg["num_speakers_per_batch"]), seed=17,
                             raw_codes=True, group=8).start()
    try:
        codes, headers, labels = (torch.from_numpy(a).cuda() for a in q.fetch())
    finally:
        q.stop()
    lr = float(cfg["learning_rate"])

    def steps():
        for k in range(8):
            t.train_step_raw(codes[k], headers[k], labels[k], lr)

    steps()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_s, n_events, by_name = device_busy(torch, prof)
    if not n_events:
        print("profile %s: no device events in the trace; device idle share not measured" % label)
        return {}
    print("profile %s (%s), 8 float32 steps %s codes under torch.profiler: wall %.4f s, device "
          "busy %.4f s, device idle %.1f%%, %d device events"
          % (label, CARD, list(codes.shape[1:]), wall, busy_s, 100 * (1 - busy_s / wall),
             n_events))
    print_top(by_name, busy_s)
    return {label + "_profile_wall_s": wall, label + "_profile_busy_s": busy_s,
            label + "_device_idle": 1 - busy_s / wall}


def extract_zoo(torch, name, model, scp, root):
    """cli.extract --device-pipe (no CMVN, no VAD) from a zoo dir on the card
    against a float32 CPU forward of the same checkpoint on each utterance
    unpadded: cosine >= 0.9999 for every one. Returns the run."""
    from tf_kaldi_speaker_tpu_torch.cli import extract as cli_extract
    from tf_kaldi_speaker_tpu_torch.convert import network_from_variables
    from tf_kaldi_speaker_tpu_torch.kio import read_mat_scp, read_vec_flt_scp
    from tf_kaldi_speaker_tpu_torch.train.checkpoints import load_checkpoint

    cfg = zoo_config(name)
    out = os.path.join(root, "zoo_xvector_" + name[:-len(".json")])
    run = drive(torch, cli_extract.main, ["--device-pipe", "--batch-size", "32", "--device", "cuda",
                                          model, "scp:" + scp, "ark,scp:%s.ark,%s.scp" % (out, out)])
    if run["rc"] != 0:
        raise RuntimeError("cli.extract from %s exited %d" % (model, run["rc"]))
    # the backward and the train-mode BatchNorm run in training only
    kernels = [k for k in zoo_kernels(cfg) if k in ("cm_dequantize", "masked_stats_pooling")]
    check_launched("zoo extraction %s (cli.extract --device-pipe, float32)"
                   % name[:-len(".json")], run, kernels)
    got = dict(read_vec_flt_scp(out + ".scp"))
    raw, _ = load_checkpoint(os.path.join(model, "nnet"))
    net = network_from_variables({"params": raw["params"]["network"],
                                  "batch_stats": raw["batch_stats"]["network"]}, cfg,
                                 cfg.get("network_type", "tdnn"), input_dim=FEAT_DIM)
    node = cfg.get("embedding_node", "tdnn6_dense")
    worst = 1.0
    with torch.no_grad():
        for key, mat in read_mat_scp(scp):
            want = net(torch.from_numpy(mat)[None])[1][node][0].numpy()
            if key not in got or got[key].shape != want.shape or not np.isfinite(got[key]).all():
                raise AssertionError("%s: %s missing, misshapen or not finite" % (name, key))
            worst = min(worst, cosine(got[key], want))
    if len(got) != N_UTTS or not worst >= 0.9999:
        raise AssertionError("%s: %d embeddings, card vs CPU float32 min cosine %.6f (< 0.9999)"
                             % (name, len(got), worst))
    print("cli.extract --device-pipe from %s: %d finite %d-d %s embeddings; card vs CPU float32 "
          "forward of the checkpoint, unpadded: min cosine %.7f (>= 0.9999) ok"
          % (os.path.basename(model), len(got), len(want), node, worst))
    return run, worst


def check_exact_long(torch, model, scp, root):
    """cli.extract --exact-long --chunk-size 256 (the utterances over 256
    frames through the chunked, float64-accumulated path) against the
    whole-utterance embeddings of cli.extract, both on the card, host path,
    float32: within EXACT_TOL for every utterance."""
    from tf_kaldi_speaker_tpu_torch.cli import extract as cli_extract
    from tf_kaldi_speaker_tpu_torch.kio import read_mat_scp, read_vec_flt_scp

    outs = {}
    for name, flags in (("whole", []), ("exact", ["--exact-long", "--chunk-size",
                                                  str(EXACT_CHUNK)])):
        out = os.path.join(root, "exact_long_" + name)
        t0 = time.perf_counter()
        rc = cli_extract.main(flags + ["--device", "cuda", model, "scp:" + scp,
                                       "ark,scp:%s.ark,%s.scp" % (out, out)])
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError("cli.extract %s exited %d" % (" ".join(flags), rc))
        outs[name] = (dict(read_vec_flt_scp(out + ".scp")), time.perf_counter() - t0)
    whole, exact = outs["whole"][0], outs["exact"][0]
    longs = [k for k, m in read_mat_scp(scp) if m.shape[0] > EXACT_CHUNK]
    worst = 0.0
    for k in whole:
        a, b = exact[k], whole[k]
        if not np.allclose(a, b, **EXACT_TOL):
            raise AssertionError("exact-long %s: max abs err %.3g beyond rtol %g atol %g"
                                 % (k, float(np.abs(a - b).max()), EXACT_TOL["rtol"],
                                    EXACT_TOL["atol"]))
        worst = max(worst, float(np.abs(a - b).max()))
    if sorted(exact) != sorted(whole) or len(whole) != N_UTTS or not longs:
        raise AssertionError("exact-long: keys %d vs %d, %d long" % (len(exact), len(whole),
                                                                     len(longs)))
    print("cli.extract --exact-long --chunk-size %d from %s (%s): %d of %d utterances over %d "
          "frames through the exact path; every embedding within rtol %g / atol %g of the "
          "whole-utterance forward (max abs err %.3g) ok; cli.extract %.2f s whole, %.2f s exact"
          % (EXACT_CHUNK, os.path.basename(model), CARD, len(longs), len(whole), EXACT_CHUNK,
             EXACT_TOL["rtol"], EXACT_TOL["atol"], worst, outs["whole"][1], outs["exact"][1]))
    return worst


def run_zoo(torch, root, train, valid, scp, streamed):
    """The zoo phase (18): train, profile, hold the card against the CPU,
    extract; then exact-long extraction from the streamed fisher dir.
    Returns each path's run (training and extraction) and a summary."""
    runs, summary = {}, {}
    for name in ZOO:
        short = name[:-len(".json")]
        run, model, times = run_zoo_training(torch, root, train, valid, name)
        runs["zoo:" + short] = run
        summary[short] = times
        if name.startswith(("ecapa", "resnet")):
            label = short.split("_")[0]
            summary[short].update(profile_zoo_group(torch, model, train, label))
            summary[short]["cpu_loss_gap"] = check_stream_step_against_cpu(torch, model, train)
        erun, worst = extract_zoo(torch, name, model, scp, root)
        runs["zoo_extract:" + short] = erun
        summary[short]["extract_min_cosine"] = worst
    summary["exact_long_max_abs_err"] = check_exact_long(torch, streamed, scp, root)
    return runs, summary


# The wav-to-score phase (19): the recipe's evaluation path, wav -> MFCC ->
# VAD -> CMVN/silence removal -> x-vectors -> scores, on a synthetic corpus.
# Lengths are uniform over 2-10 s, a smoke-test range and not VoxCeleb1-O's
# length distribution (its test utterances run from about 4 s to over two
# minutes); at 128 utterances set-up dominates the stage rates printed.
WAV_CORPUS = dict(num_speakers=32, utts_per_speaker=4, min_seconds=2.0, max_seconds=10.0,
                  seed=6)
# recipes/voxceleb/v1/run.sh:55-57 (30 ceps, 30 mel bins, 20-7600 Hz), dither 1
MFCC_FLAGS = ["--num-ceps", "30", "--num-mel-bins", "30", "--low-freq", "20",
              "--high-freq", "7600", "--dither", "1"]
# the PLDA/LDA training set: 256 speakers keep LDA-200's between-class
# scatter at full rank
PLDA_SET = dict(num_speakers=256, utts_per_speaker=4, dim=FEAT_DIM, min_len=200, max_len=400,
                seed=7, spk_offset=1000, spk_scale=1.0, chan_scale=1.0)
LDA_DIM = 200  # recipes/voxceleb/v1/run.sh:188-196
SCORE_WAYS = {
    "cosine": ["--backend", "cosine"],
    "plda_lda": ["--backend", "plda", "--lda-dim", str(LDA_DIM)],
    "plda_lda_adapt": ["--backend", "plda", "--lda-dim", str(LDA_DIM), "--adapt-scp", "{test}"],
    "cosine_asnorm": ["--backend", "cosine", "--cohort-scp", "{train}"],
}
# card chain against the CPU chain (both float32 forwards of one checkpoint):
# every MFCC value within one float32 rounding of numpy's float64 result
# (rtol 2^-22, atol 1e-5 near zero); embeddings min cosine; the largest
# score difference over the CPU scores' spread; the EER within one target
# trial; each minDCF within the cost of one target and one nontarget trial.
# EMB_MIN_COSINE and SCORE_GAP sit between what the sound card chain reads
# on an H100 (1 - cosine 2.8e-12, score gaps up to 3.68e-6 of the spread)
# and what the lower-precision controls (CONTROLS) read there (TF32 1.05e-7
# and 2.25e-4, bf16 2.54e-5 and 3.67e-3); PERF.md section 6 records them.
MFCC_TOL = dict(rtol=2.0 ** -22, atol=1e-5)
EMB_MIN_COSINE = 1.0 - 1e-9
SCORE_GAP = 3e-5
# the bounds' controls: the raw-MFCC x-vectors on the card with TF32 on
# (cuDNN convs and matmuls), and from the bf16 checkpoint
CONTROLS = ("tf32", "bf16")


def write_wav_corpus(root):
    """WAV_CORPUS as a wav data dir and the trials of every utterance pair."""
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_wav_data_dir, write_trials

    data = make_wav_data_dir(os.path.join(root, "wav_data"), **WAV_CORPUS)
    with open(data["utt2spk"]) as f:
        utt2spk = dict(line.split() for line in f)
    data["trials"] = os.path.join(root, "wav_data", "trials")
    data["labels"] = np.array([t for _, _, t in write_trials(data["trials"], utt2spk)], int)
    return data


def dcf_bounds(labels):
    """The EER, minDCF08 and minDCF10 moves of one target trial (EER) and
    of one target plus one nontarget trial (minDCF08 unnormalized, c_miss
    10, p 0.01; minDCF10 normalized, p 0.001)."""
    n_t, n_n = int(labels.sum()), int((1 - labels).sum())
    return dict(eer=1.0 / n_t, min_dcf08=10 * 0.01 / n_t + 0.99 / n_n,
                min_dcf10=1.0 / n_t + 0.999 / 0.001 / n_n)


def float32_model(trained, root, name="wav_model"):
    """The trained flagship's checkpoint with compute_dtype float32, so the
    card and the CPU run the same float32 forward."""
    model = os.path.join(root, name)
    shutil.copytree(os.path.join(trained, "nnet"), os.path.join(model, "nnet"))
    cfg_path = os.path.join(model, "nnet", "config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    write_json(cfg_path, dict(cfg, compute_dtype="float32"))
    return model


def run_wav_chain(torch, data, plda_set, model, root, device):
    """make_mfcc --compress -> compute_vad -> prepare_feats, then
    cli.extract --device-pipe: --cmvn --vad on the raw MFCC, without flags
    on the prepared features, and the PLDA set; every CLI on ``device``.
    Returns the runs (drive's) by stage and the output paths."""
    from tf_kaldi_speaker_tpu_torch.cli import compute_vad, extract, make_mfcc, prepare_feats

    d = os.path.join(root, "wav_" + device)
    dev = ["--device", device]
    out = dict(mfcc=os.path.join(d, "mfcc"), egs=os.path.join(d, "egs"))
    runs = {}

    def stage(name, main_fn, argv):
        runs[name] = drive(torch, main_fn, argv)
        if runs[name]["rc"] != 0:
            raise RuntimeError("%s on %s exited %d" % (name, device, runs[name]["rc"]))

    stage("make_mfcc", make_mfcc.main, ["--compress"] + MFCC_FLAGS + dev
          + [data["wav_scp"], out["mfcc"]])
    shutil.copyfile(data["utt2spk"], os.path.join(out["mfcc"], "utt2spk"))
    stage("compute_vad", compute_vad.main, dev + [os.path.join(out["mfcc"], "feats.scp"),
                                                  out["mfcc"]])
    stage("prepare_feats", prepare_feats.main, dev + [out["mfcc"], out["egs"]])
    for name, flags, scp in (("xvector_raw", ["--cmvn", "--vad"], out["mfcc"]),
                             ("xvector_egs", [], out["egs"]),
                             ("xvector_plda", [], plda_set["data"])):
        out[name] = os.path.join(d, name)
        stage("extract_" + name[8:], extract.main, ["--device-pipe", "--batch-size", "32"]
              + flags + dev + [model, "scp:" + os.path.join(scp, "feats.scp"),
                               "ark,scp:%s.ark,%s.scp" % (out[name], out[name])])
    return runs, out


def score_ways(data, plda_set, outs):
    """cli.score each of SCORE_WAYS on each chain's raw-MFCC x-vectors
    (``outs``: chain -> run_wav_chain's paths), trials from every utterance
    pair, the PLDA/LDA set (and the AS-norm cohort) from the chain's PLDA
    set x-vectors. The calls run side by side in child processes with one
    BLAS thread each (the PLDA EM is numpy on one core; threaded BLAS
    gains nothing at 200 x 200), each timing its own call. Returns
    {(chain, way): (scores, report, seconds)}."""
    code = ("import sys, time; t = time.perf_counter(); "
            "from tf_kaldi_speaker_tpu_torch.cli import score; rc = score.main(sys.argv[1:]); "
            "print('SECONDS %.6f' % (time.perf_counter() - t)); sys.exit(rc)")
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = {}
    try:
        for chain, out in outs.items():
            test, train = out["xvector_raw"] + ".scp", out["xvector_plda"] + ".scp"
            for way, flags in SCORE_WAYS.items():
                path = "%s.%s.scores" % (out["xvector_raw"], way)
                argv = [a.format(test=test, train=train) for a in flags] + [
                    "--enroll-scp", test, "--test-scp", test, "--trials", data["trials"],
                    "--scores", path]
                if "plda" in way:
                    argv += ["--train-scp", train, "--train-utt2spk", plda_set["utt2spk"]]
                procs[chain, way] = path, subprocess.Popen(
                    [sys.executable, "-c", code] + argv, cwd=ROOT, env=env, text=True,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        result = {}
        for key, (path, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError("cli.score %s on the %s x-vectors exited %d:\n%s"
                                   % (key[1], key[0], proc.returncode, stderr[-2000:]))
            report, _, seconds = stdout.rpartition("SECONDS ")
            result[key] = (np.loadtxt(path, usecols=2), report, float(seconds))
        return result
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def check_mfcc_against_numpy(data, root):
    """cli.make_mfcc on the card without --compress: every utterance's
    float32 MFCC against the port's numpy ``mfcc`` with the seed it drew
    (its index in wav.scp), within MFCC_TOL. Returns the max abs error and
    the share of values not bit-equal."""
    from tf_kaldi_speaker_tpu_torch.cli import make_mfcc
    from tf_kaldi_speaker_tpu_torch.kio import read_mat_scp, read_wav_scp
    from tf_kaldi_speaker_tpu_torch.ops.mfcc import MfccConfig, mfcc

    d = os.path.join(root, "wav_mfcc_plain")
    if make_mfcc.main(MFCC_FLAGS + ["--device", "cuda", data["wav_scp"], d]) != 0:
        raise RuntimeError("cli.make_mfcc (uncompressed) exited non-zero")
    got = dict(read_mat_scp(os.path.join(d, "feats.scp")))
    cfg = MfccConfig(num_ceps=30, num_mel_bins=30, low_freq=20, high_freq=7600, dither=1.0)
    worst, differ, total = 0.0, 0, 0
    for seed, (utt, samples, _) in enumerate(read_wav_scp(data["wav_scp"])):
        want = mfcc(samples, cfg, seed=seed)
        if got[utt].shape != want.shape:
            raise AssertionError("make_mfcc %s: shape %s, numpy %s" % (utt, got[utt].shape,
                                                                      want.shape))
        diff = np.abs(got[utt].astype(np.float64) - want)
        if not (diff <= MFCC_TOL["atol"] + MFCC_TOL["rtol"] * np.abs(want)).all():
            raise AssertionError("make_mfcc %s: max abs err %.3g beyond rtol %g / atol %g"
                                 % (utt, float(diff.max()), MFCC_TOL["rtol"], MFCC_TOL["atol"]))
        worst = max(worst, float(diff.max()))
        differ += int((diff > 0).sum())
        total += diff.size
    if len(got) != len(data["utts"]):
        raise AssertionError("make_mfcc wrote %d of %d utterances" % (len(got), len(data["utts"])))
    print("cli.make_mfcc on the card (float64, dither 1) vs numpy mfcc, %d utterances, %d values: "
          "max abs err %.3g (rtol %g, atol %g), %d values not bit-equal ok"
          % (len(got), total, worst, MFCC_TOL["rtol"], MFCC_TOL["atol"], differ))
    return worst, differ / total


def check_vad_against_numpy(out):
    """The card's vad.ark against the numpy VAD on the same (decoded)
    features: every decision equal."""
    from tf_kaldi_speaker_tpu_torch.kio import read_mat_scp, read_vec_flt_scp
    from tf_kaldi_speaker_tpu_torch.ops.vad import compute_vad_energy

    vad = dict(read_vec_flt_scp(os.path.join(out["mfcc"], "vad.scp")))
    voiced = frames = 0
    for utt, feats in read_mat_scp(os.path.join(out["mfcc"], "feats.scp")):
        want = compute_vad_energy(feats)
        if not np.array_equal(vad[utt], want):
            raise AssertionError("compute_vad %s: %d decisions differ from numpy"
                                 % (utt, int((vad[utt] != want).sum())))
        voiced += int(want.sum())
        frames += want.size
    if not 0.2 < voiced / frames < 0.9:
        raise AssertionError("VAD kept %d of %d frames: the corpus should hold both classes"
                             % (voiced, frames))
    print("cli.compute_vad on the card (float64) vs numpy compute_vad_energy: %d utterances, "
          "%d frames, all decisions equal, %.1f%% voiced ok" % (len(vad), frames,
                                                                100.0 * voiced / frames))


def compare_arks(name, card_dir, cpu_dir):
    """Two compressed feature dirs: the same utterances and frame counts,
    and decoded matrices within one quantization step of each column.
    Returns the max abs difference and the number of utterances whose
    bytes differ."""
    from tf_kaldi_speaker_tpu_torch.kio import read_codes_scp, read_mat_scp

    with open(os.path.join(card_dir, "utt2num_frames")) as a, \
            open(os.path.join(cpu_dir, "utt2num_frames")) as b:
        if a.read() != b.read():
            raise AssertionError("%s: utt2num_frames differ between card and CPU" % name)
    cpu = {k: (c, h) for k, c, h in read_codes_scp(os.path.join(cpu_dir, "feats.scp"))}
    cpu_mats = dict(read_mat_scp(os.path.join(cpu_dir, "feats.scp")))
    worst, differ = 0.0, 0
    for (k, codes, heads), (_, mat) in zip(read_codes_scp(os.path.join(card_dir, "feats.scp")),
                                           read_mat_scp(os.path.join(card_dir, "feats.scp"))):
        c, h = cpu[k]
        if np.array_equal(codes, c) and np.array_equal(heads, h):
            continue
        differ += 1
        p0, p25, p75, p100 = h
        step = np.maximum.reduce([(p25 - p0) / 64, (p75 - p25) / 128, (p100 - p75) / 63])
        diff = np.abs(mat - cpu_mats[k])
        if not (diff <= step * (1 + 1e-6) + np.abs(heads - h).max()).all():
            raise AssertionError("%s %s: card vs CPU beyond one quantization step (%.3g)"
                                 % (name, k, float(diff.max())))
        worst = max(worst, float(diff.max()))
    print("%s: card vs CPU (--device cpu), %d utterances: %d differ in bytes, max abs diff of "
          "the decoded features %.3g (<= one quantization step) ok"
          % (name, len(cpu), differ, worst))
    return worst, differ


def make_mfcc_host_seconds(run):
    """The seconds make_mfcc's run spent reading the wavs and drawing the
    dither on the host, from its last log line."""
    for _, msg in run["logged"]:
        m = re.match(r"host seconds: reading the wavs ([0-9.]+), drawing the dither ([0-9.]+)$",
                     msg)
        if m:
            return float(m.group(1)), float(m.group(2))
    raise AssertionError("make_mfcc logged no host seconds")


@contextlib.contextmanager
def tf32_on(torch):
    """TF32 on in this process, also through a CLI's device set-up (which
    turns it off: ``cli._frontend.no_tf32`` is a no-op meanwhile); off
    again after."""
    from tf_kaldi_speaker_tpu_torch.cli import _frontend

    backends, no_tf32 = torch.backends, _frontend.no_tf32
    backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = True
    _frontend.no_tf32 = lambda: None
    try:
        yield
    finally:
        _frontend.no_tf32 = no_tf32
        backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False


def run_controls(torch, data, out, cpu_out, cpu_cosine, model, trained, root):
    """CONTROLS, each read as the card-vs-CPU check reads the sound chain:
    the raw-MFCC x-vectors (``cli.extract --cmvn --vad --device-pipe`` on
    the card) against the CPU chain's (min cosine), and their cosine scores
    (``cli.score``) against the CPU's (largest difference over the
    spread). "tf32": the float32 checkpoint with TF32 on; "bf16": the
    trained checkpoint, whose forward is bf16. Nothing is asserted: the
    readings show what the bounds would catch. Returns {control:
    {one_minus_cosine, score_gap}}."""
    from tf_kaldi_speaker_tpu_torch.cli import extract, score
    from tf_kaldi_speaker_tpu_torch.kio import read_vec_flt_scp

    want = dict(read_vec_flt_scp(cpu_out["xvector_raw"] + ".scp"))
    readings = {}
    for control in CONTROLS:
        path = os.path.join(root, "wav_control", control)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tf32 = control == "tf32"
        with tf32_on(torch) if tf32 else contextlib.nullcontext():
            rc = extract.main(["--device-pipe", "--batch-size", "32", "--cmvn", "--vad",
                               "--device", "cuda", model if tf32 else trained,
                               "scp:" + os.path.join(out["mfcc"], "feats.scp"),
                               "ark,scp:%s.ark,%s.scp" % (path, path)])
        if rc != 0:
            raise RuntimeError("cli.extract (%s control) exited %d" % (control, rc))
        worst = min(cosine(e, want[k]) for k, e in read_vec_flt_scp(path + ".scp"))
        with contextlib.redirect_stdout(io.StringIO()):
            rc = score.main(["--backend", "cosine", "--enroll-scp", path + ".scp",
                             "--test-scp", path + ".scp", "--trials", data["trials"],
                             "--scores", path + ".scores"])
        if rc != 0:
            raise RuntimeError("cli.score (%s control) exited %d" % (control, rc))
        gap = float(np.abs(np.loadtxt(path + ".scores", usecols=2) - cpu_cosine).max()
                    / np.ptp(cpu_cosine))
        readings[control] = dict(one_minus_cosine=1.0 - worst, score_gap=gap)
        print("control %s vs the CPU chain: x-vectors 1 - min cosine %.3g (bound <= %.3g: %s), "
              "cosine scores max |diff| / spread %.3g (bound <= %g: %s)"
              % (control, 1.0 - worst, 1.0 - EMB_MIN_COSINE,
                 "caught" if worst < EMB_MIN_COSINE else "NOT caught", gap, SCORE_GAP,
                 "caught" if gap > SCORE_GAP else "NOT caught"))
    return readings


def check_extract_subprocess(data, out, cpu_out, cpu_cosine, model, root):
    """``python -m tf_kaldi_speaker_tpu_torch.cli.extract`` in a process of
    its own on the float32 checkpoint (the raw MFCC, ``--cmvn --vad
    --device-pipe``), nothing set in its environment that touches TF32 (so
    PyTorch's defaults, which let cuDNN use TF32, hold until the CLI's
    device set-up turns it off), held to the in-process check's bounds:
    its x-vectors against the CPU chain's (1 - min cosine <= 1 -
    EMB_MIN_COSINE) and their cosine scores against the CPU's (largest
    difference over the spread <= SCORE_GAP). Returns the readings."""
    from tf_kaldi_speaker_tpu_torch.cli import score
    from tf_kaldi_speaker_tpu_torch.kio import read_vec_flt_scp

    path = os.path.join(root, "wav_subprocess", "xvector_raw")
    os.makedirs(os.path.dirname(path))
    env = {k: v for k, v in os.environ.items()
           if k not in ("NVIDIA_TF32_OVERRIDE", "TORCH_ALLOW_TF32_CUBLAS_OVERRIDE")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tf_kaldi_speaker_tpu_torch.cli.extract",
                           "--device-pipe", "--batch-size", "32", "--cmvn", "--vad", model,
                           "scp:" + os.path.join(out["mfcc"], "feats.scp"),
                           "ark,scp:%s.ark,%s.scp" % (path, path)],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError("cli.extract (subprocess) exited %d:\n%s"
                           % (proc.returncode, proc.stderr[-4000:]))
    want = dict(read_vec_flt_scp(cpu_out["xvector_raw"] + ".scp"))
    got = dict(read_vec_flt_scp(path + ".scp"))
    if sorted(got) != sorted(want):
        raise AssertionError("cli.extract (subprocess): %d x-vectors of %d" % (len(got),
                                                                               len(want)))
    worst = min(cosine(e, want[k]) for k, e in got.items())
    with contextlib.redirect_stdout(io.StringIO()):
        rc = score.main(["--backend", "cosine", "--enroll-scp", path + ".scp",
                         "--test-scp", path + ".scp", "--trials", data["trials"],
                         "--scores", path + ".scores"])
    if rc != 0:
        raise RuntimeError("cli.score (subprocess x-vectors) exited %d" % rc)
    gap = float(np.abs(np.loadtxt(path + ".scores", usecols=2) - cpu_cosine).max()
                / np.ptp(cpu_cosine))
    if not (worst >= EMB_MIN_COSINE and gap <= SCORE_GAP):
        raise AssertionError("cli.extract in its own process (TF32 as PyTorch leaves it until "
                             "the CLI's set-up) vs the CPU chain: x-vectors 1 - min cosine %.3g "
                             "(bound %.3g), scores max |diff| / spread %.3g (bound %g)"
                             % (1.0 - worst, 1.0 - EMB_MIN_COSINE, gap, SCORE_GAP))
    print("cli.extract in its own process (python -m, float32 checkpoint, no TF32 setting in "
          "its environment; %.2f s) vs the CPU chain: x-vectors 1 - min cosine %.3g (<= %.3g), "
          "cosine scores max |diff| / spread %.3g (<= %g) ok: the CLI runs float32 without TF32"
          % (wall, 1.0 - worst, 1.0 - EMB_MIN_COSINE, gap, SCORE_GAP))
    return dict(one_minus_cosine=1.0 - worst, score_gap=gap, wall_s=wall)


def batching_ab(torch, data, root):
    """cli.make_mfcc --compress on the card over wav.scp as written (its
    input-order batches) against a copy of wav.scp sorted by length (the
    batches that bucketing by length would give the card: each padded to
    about its shortest row), in turns written, sorted, sorted, written.
    Returns the walls by kind."""
    from tf_kaldi_speaker_tpu_torch.cli import make_mfcc

    with open(data["wav_scp"]) as f:
        lines = f.readlines()
    sorted_scp = os.path.join(root, "wav_ab", "wav.scp")
    os.makedirs(os.path.dirname(sorted_scp), exist_ok=True)
    with open(sorted_scp, "w") as f:
        f.writelines(sorted(lines, key=lambda line: os.path.getsize(line.split()[1])))
    walls = {"written": [], "sorted": []}
    for i, kind in enumerate(("written", "sorted", "sorted", "written")):
        scp = data["wav_scp"] if kind == "written" else sorted_scp
        run = drive(torch, make_mfcc.main, ["--compress"] + MFCC_FLAGS + [
            "--device", "cuda", scp, os.path.join(root, "wav_ab", str(i))])
        if run["rc"] != 0:
            raise RuntimeError("cli.make_mfcc (%s wav.scp) exited %d" % (kind, run["rc"]))
        walls[kind].append(run["wall"])
    print("cli.make_mfcc --compress on the card (%s), turns written, sorted, sorted, written: "
          "wav.scp as written (input-order batches) %s s, sorted by length %s s"
          % (CARD, [round(w, 4) for w in walls["written"]],
             [round(w, 4) for w in walls["sorted"]]))
    return walls


def run_wav_to_score(torch, root, trained):
    """The wav-to-score phase (19). Returns the path's launches and shapes,
    a summary and the wav corpus."""
    from tf_kaldi_speaker_tpu_torch.backend import compute_eer, min_dcf08, min_dcf10
    from tf_kaldi_speaker_tpu_torch.kio import read_vec_flt_scp
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    t_phase = t0 = time.perf_counter()
    data = write_wav_corpus(root)
    plda_set = make_fake_data_dir(os.path.join(root, "plda_set"), **PLDA_SET)
    model = float32_model(trained, root)
    print("wav corpus: %d utterances of %d speakers, %.1f s of 16 kHz PCM16 audio, %d trials "
          "(%d target); PLDA set %d x %d utterances of %d-%d frames; written in %.2f s"
          % (len(data["utts"]), WAV_CORPUS["num_speakers"], data["seconds"],
             len(data["labels"]), int(data["labels"].sum()), PLDA_SET["num_speakers"],
             PLDA_SET["utts_per_speaker"], PLDA_SET["min_len"], PLDA_SET["max_len"],
             time.perf_counter() - t0))

    runs, out = run_wav_chain(torch, data, plda_set, model, root, "cuda")
    launches, shapes = {}, {}
    for run in runs.values():
        for name, n in run["launches"].items():
            launches[name] = launches.get(name, 0) + n
            shapes.setdefault(name, collections.Counter()).update(run["shapes"][name])
    check_launched("wav-to-score path (make_mfcc, compute_vad, prepare_feats, "
                   "extract --device-pipe, float32)",
                   dict(launches=launches, shapes=shapes),
                   ["cm_dequantize", "masked_stats_pooling"])
    # where make_mfcc's host time goes, as its own run timed it
    read_s, dither_s = make_mfcc_host_seconds(runs["make_mfcc"])

    mfcc_err, mfcc_differ = check_mfcc_against_numpy(data, root)
    batching = batching_ab(torch, data, root)
    check_vad_against_numpy(out)

    t0 = time.perf_counter()
    cpu_runs, cpu_out = run_wav_chain(torch, data, plda_set, model, root, "cpu")
    cpu_s = time.perf_counter() - t0
    scores = score_ways(data, plda_set, {"cuda": out, "cpu": cpu_out})
    card_scores = {way: scores["cuda", way] for way in SCORE_WAYS}
    cpu_scores = {way: scores["cpu", way] for way in SCORE_WAYS}
    for way, (_, report, _) in card_scores.items():
        print("cli.score %s on the card's x-vectors:\n  %s" % (way, report.strip().replace(
            "\n", "\n  ")))
    feat_gap = compare_arks("make_mfcc --compress", out["mfcc"], cpu_out["mfcc"])
    with open(os.path.join(out["mfcc"], "vad.ark"), "rb") as a, \
            open(os.path.join(cpu_out["mfcc"], "vad.ark"), "rb") as b:
        vad_equal = a.read() == b.read()
    print("compute_vad: card vad.ark %s the CPU's" % ("byte-equal to" if vad_equal else
                                                     "DIFFERS from"))
    prep_gap = compare_arks("prepare_feats", out["egs"], cpu_out["egs"])

    worst_cos = 1.0
    for name in ("xvector_raw", "xvector_egs", "xvector_plda"):
        card = dict(read_vec_flt_scp(out[name] + ".scp"))
        cpu = dict(read_vec_flt_scp(cpu_out[name] + ".scp"))
        want_n = len(data["utts"]) if name != "xvector_plda" else (
            PLDA_SET["num_speakers"] * PLDA_SET["utts_per_speaker"])
        if sorted(card) != sorted(cpu) or len(card) != want_n:
            raise AssertionError("%s: %d card and %d CPU embeddings, expected %d"
                                 % (name, len(card), len(cpu), want_n))
        for k, e in card.items():
            if e.shape != (512,) or not np.isfinite(e).all():
                raise AssertionError("%s %s: embedding shape %s or not finite"
                                     % (name, k, e.shape))
            worst_cos = min(worst_cos, cosine(e, cpu[k]))
    if not worst_cos >= EMB_MIN_COSINE:
        raise AssertionError("x-vectors card vs CPU: 1 - min cosine %.3g > %.3g"
                             % (1.0 - worst_cos, 1.0 - EMB_MIN_COSINE))
    print("x-vectors card vs CPU (float32 forwards of one checkpoint), raw --cmvn --vad, "
          "prepared, PLDA set: 1 - min cosine %.3g (<= %.3g) ok"
          % (1.0 - worst_cos, 1.0 - EMB_MIN_COSINE))

    labels = data["labels"]
    bounds = dcf_bounds(labels)
    gaps = {}
    for way in SCORE_WAYS:
        s_card, s_cpu = card_scores[way][0], cpu_scores[way][0]
        if s_card.shape != labels.shape or not np.isfinite(s_card).all():
            raise AssertionError("scores %s: shape %s or not finite" % (way, s_card.shape))
        rel = float(np.abs(s_card - s_cpu).max() / np.ptp(s_cpu))
        g = dict(score_gap=rel,
                 eer=abs(compute_eer(s_card, labels)[0] - compute_eer(s_cpu, labels)[0]),
                 min_dcf08=abs(min_dcf08(s_card, labels) - min_dcf08(s_cpu, labels)),
                 min_dcf10=abs(min_dcf10(s_card, labels) - min_dcf10(s_cpu, labels)))
        if rel > SCORE_GAP or any(g[k] > bounds[k] + 1e-12 for k in bounds):
            raise AssertionError("scores %s card vs CPU: %s beyond score gap %g and %s"
                                 % (way, g, SCORE_GAP, bounds))
        gaps[way] = dict(g, eer_card=compute_eer(s_card, labels)[0],
                         min_dcf10_card=min_dcf10(s_card, labels))
        print("scores %s, card vs CPU: max |diff| / spread %.3g (<= %g), EER %.4f%% vs %.4f%% "
              "(gap %.4f%% <= %.4f%%), minDCF08 gap %.4g (<= %.4g), minDCF10 gap %.4g (<= %.4g) ok"
              % (way, rel, SCORE_GAP, 100 * compute_eer(s_card, labels)[0],
                 100 * compute_eer(s_cpu, labels)[0], 100 * g["eer"], 100 * bounds["eer"],
                 g["min_dcf08"], bounds["min_dcf08"], g["min_dcf10"], bounds["min_dcf10"]))
    controls = run_controls(torch, data, out, cpu_out, cpu_scores["cosine"][0], model, trained,
                            root)
    subprocess_check = check_extract_subprocess(data, out, cpu_out, cpu_scores["cosine"][0],
                                                model, root)

    hours = data["seconds"] / 3600.0
    mfcc_s = runs["make_mfcc"]["wall"]
    n_emb = len(data["utts"])
    n_plda = PLDA_SET["num_speakers"] * PLDA_SET["utts_per_speaker"]
    times = dict(
        audio_s=data["seconds"], mfcc_s=mfcc_s, mfcc_s_per_audio_hour=mfcc_s / hours,
        wav_read_s=read_s, wav_read_share=read_s / mfcc_s, dither_s=dither_s,
        dither_share=dither_s / mfcc_s, vad_s=runs["compute_vad"]["wall"],
        prepare_feats_s=runs["prepare_feats"]["wall"],
        extract_raw_emb_per_s=n_emb / runs["extract_raw"]["wall"],
        extract_egs_emb_per_s=n_emb / runs["extract_egs"]["wall"],
        extract_plda_emb_per_s=n_plda / runs["extract_plda"]["wall"],
        **{"score_%s_s" % w: v[2] for w, v in card_scores.items()},
        cpu_chain_s=cpu_s, cpu_mfcc_s=cpu_runs["make_mfcc"]["wall"],
        cpu_mfcc_s_per_audio_hour=cpu_runs["make_mfcc"]["wall"] / hours)
    print("wav-to-score stage times on the card (%s; smoke readings, set-up dominates at this "
          "corpus size): make_mfcc --compress %.3f s for %.1f s of audio = %.2f s per hour of "
          "audio (timed inside its run: reading the wavs %.3f s = %.1f%% of it, drawing the "
          "dither %.3f s = %.1f%%); compute_vad %.3f s; prepare_feats %.3f s; cli.extract "
          "--device-pipe %.1f emb/s raw --cmvn --vad, %.1f emb/s prepared, %.1f emb/s PLDA set; "
          "cli.score %s s (8 calls side by side, one core each); the CPU chain (--device cpu, "
          "through extraction) %.2f s, its make_mfcc "
          "%.2f s per hour of audio; the phase %.2f s"
          % (CARD, mfcc_s, data["seconds"], times["mfcc_s_per_audio_hour"], read_s,
             100 * times["wav_read_share"], dither_s, 100 * times["dither_share"],
             times["vad_s"], times["prepare_feats_s"], times["extract_raw_emb_per_s"],
             times["extract_egs_emb_per_s"], times["extract_plda_emb_per_s"],
             {w: round(v[2], 3) for w, v in card_scores.items()}, cpu_s,
             times["cpu_mfcc_s_per_audio_hour"], time.perf_counter() - t_phase))
    summary = dict(times, mfcc_max_abs_err=mfcc_err, mfcc_not_bit_equal=mfcc_differ,
                   mfcc_card_vs_cpu=feat_gap, prepare_feats_card_vs_cpu=prep_gap,
                   vad_card_equals_cpu=vad_equal, emb_min_cosine=worst_cos, score_gaps=gaps,
                   controls=controls, extract_subprocess=subprocess_check,
                   make_mfcc_batching_walls=batching)
    return launches, shapes, summary, data


# ---------------------------------------------------------------------------
# Phase 20: augmentation (recipes/voxceleb/v1/run.sh stage 2)
# ---------------------------------------------------------------------------
# 8 synthetic RIRs of 4,000-16,000 samples (a direct path and a decaying
# noisy tail): a smoke choice, sourced from nothing (RIRS_NOISES' simulated
# rooms are 1 s at 16 kHz); MUSAN-like noise, music and speech sources
AUG_SOURCES = dict(rirs=8, rir_len=(4000, 16000), noise=6, music=6, speech_speakers=4,
                   seed=21)
# recipes/voxceleb/v1/run.sh:77-95: each mode's seed, SNRs and babble counts
AUG_MODES = {
    "reverb": (["--seed", "1"], "rirs"),
    "noise": (["--seed", "2", "--snr", "15:10:5:0"], "noise"),
    "music": (["--seed", "3", "--snr", "15:10:8:5"], "music"),
    "babble": (["--seed", "4", "--snr", "20:17:15:13", "--num-babble-choices", "3:4:5:6:7"],
               "speech"),
}
# the card's float64 reverb against the numpy copy on the first utterances
# (np.convolve is a direct product: slow), within 1e-12 of each row's peak
AUG_CHECK_UTTS = 16
REVERB_RTOL = 1e-12


def _shaped_noise(rng, n, slope):
    """``n`` samples of Gaussian noise with a 1/f^slope spectrum, in int16
    range."""
    nfft = 1 << (n - 1).bit_length()
    f = np.fft.rfftfreq(nfft, 1.0 / 16000)
    x = np.fft.irfft(np.fft.rfft(rng.randn(nfft)) / np.maximum(f, 20.0) ** slope, nfft)[:n]
    return np.round(x / np.abs(x).max() * rng.uniform(3000, 12000))


def _music(rng, n):
    """``n`` samples of chords: three notes with four harmonics each,
    changing every 0.3-1 s, in int16 range."""
    t = np.arange(n) / 16000.0
    out, pos = np.zeros(n), 0
    while pos < n:
        seg = min(int(rng.uniform(0.3, 1.0) * 16000), n - pos)
        env = np.exp(-np.arange(seg) / (seg * 0.6))
        for f0 in 110.0 * 2.0 ** (rng.randint(0, 36, 3) / 12.0):
            for h in range(1, 5):
                out[pos:pos + seg] += env * np.sin(2 * np.pi * f0 * h * t[pos:pos + seg]) / h
        pos += seg
    return np.round(out / np.abs(out).max() * 10000)


def write_aug_sources(root):
    """The RIRs and the noise, music and speech sources, each as a wav.scp
    under ``root``; returns {kind: wav.scp path}."""
    from tf_kaldi_speaker_tpu_torch.kio import write_wav
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_wav_data_dir

    cfg = AUG_SOURCES
    rng = np.random.RandomState(cfg["seed"])
    scps = {}

    def write(kind, items):
        d = os.path.join(root, kind)
        os.makedirs(d, exist_ok=True)
        lines = []
        for name, x in items:
            path = os.path.join(d, name + ".wav")
            write_wav(path, x, 16000)
            lines.append("%s %s" % (name, path))
        scps[kind] = os.path.join(d, "wav.scp")
        with open(scps[kind], "w") as f:
            f.write("\n".join(lines) + "\n")

    rirs = []
    for i in range(cfg["rirs"]):
        n = int(rng.randint(cfg["rir_len"][0], cfg["rir_len"][1] + 1))
        delay = int(rng.randint(0, 240))
        rir = 0.4 * rng.randn(n) * np.exp(-np.arange(n) / (n * rng.uniform(0.08, 0.25)))
        rir[:delay] = 0.0
        rir[delay] = 1.0  # the direct path
        rirs.append(("rir%d" % i, np.round(rir / np.abs(rir).max() * 20000)))
    write("rirs", rirs)
    write("noise", [("noise%d" % i, _shaped_noise(rng, int(rng.uniform(8, 15) * 16000),
                                                  rng.uniform(0.0, 1.5)))
                    for i in range(cfg["noise"])])
    write("music", [("music%d" % i, _music(rng, int(rng.uniform(10, 20) * 16000)))
                    for i in range(cfg["music"])])
    speech = make_wav_data_dir(os.path.join(root, "speech"), num_speakers=cfg["speech_speakers"],
                               utts_per_speaker=2, min_seconds=10.0, max_seconds=20.0,
                               seed=cfg["seed"] + 1)
    scps["speech"] = speech["wav_scp"]
    return scps


def _scp_entries(path):
    with open(path) as f:
        return [line.strip().split(" ", 1) for line in f if line.strip()]


def _mono(x):
    return x[:, 0] if x.ndim > 1 else x


def replay_host_mode(mode, data, src_scp, out):
    """The noise, music or babble mode with the numpy copies, drawing as
    cli.augment_data draws (keep-frac 1: no keep draw); each wav it writes
    byte-equal to the one the CLI wrote under ``out``. Returns the count."""
    from tf_kaldi_speaker_tpu_torch.data.augment import add_babble, add_noise
    from tf_kaldi_speaker_tpu_torch.kio import read_wav, write_wav

    args = AUG_MODES[mode][0]
    rng = np.random.RandomState(int(args[1]))
    snrs = [float(s) for s in args[3].split(":")]
    counts = [int(c) for c in args[5].split(":")] if mode == "babble" else None
    srcs = [rx for _, rx in _scp_entries(src_scp)]
    scratch = os.path.join(out, "replay.wav")
    for utt, rx in _scp_entries(data["wav_scp"]):
        sig = _mono(read_wav(rx)[0])
        if mode == "babble":
            n_bab = int(rng.choice(counts))
            picked = [_mono(read_wav(srcs[rng.randint(len(srcs))])[0]) for _ in range(n_bab)]
            y = add_babble(sig, picked, snr_db=float(rng.choice(snrs)), rng=rng)
        else:
            y = add_noise(sig, _mono(read_wav(srcs[rng.randint(len(srcs))])[0]),
                          snr_db=float(rng.choice(snrs)), rng=rng)
        write_wav(scratch, y, 16000)
        with open(scratch, "rb") as a, open(os.path.join(out, "wav", "%s-%s.wav" % (utt, mode)),
                                            "rb") as b:
            if a.read() != b.read():
                raise AssertionError("%s %s: the CLI's wav differs from the numpy copy's"
                                     % (mode, utt))
    os.remove(scratch)
    return len(_scp_entries(data["wav_scp"]))


def check_reverb(torch, data, rir_scp, out, device="cuda"):
    """The first AUG_CHECK_UTTS utterances with the RIRs that the reverb
    mode drew: ``reverberate_torch`` on the card in float64 against numpy's
    ``reverberate`` (max |diff| <= REVERB_RTOL x max |y| per row), and the
    int16 samples the CLI wrote against numpy's truncation of its result
    (the count that differ); the seconds each took."""
    from tf_kaldi_speaker_tpu_torch.cli._frontend import pad_rows
    from tf_kaldi_speaker_tpu_torch.data.augment import reverberate, reverberate_torch
    from tf_kaldi_speaker_tpu_torch.kio import read_wav

    rng = np.random.RandomState(int(AUG_MODES["reverb"][0][1]))
    rirs = [rx for _, rx in _scp_entries(rir_scp)]
    items = []
    for utt, rx in _scp_entries(data["wav_scp"])[:AUG_CHECK_UTTS]:
        rir = read_wav(rirs[rng.randint(len(rirs))])[0]
        items.append((utt, _mono(read_wav(rx)[0]), _mono(rir)))
    t0 = time.perf_counter()
    want = [reverberate(sig, rir) for _, sig, rir in items]
    numpy_s = time.perf_counter() - t0
    sigs, sig_lens = pad_rows([it[1] for it in items], np.float64)
    rir_pad, rir_lens = pad_rows([it[2] for it in items], np.float64)

    def card():
        return reverberate_torch(torch.from_numpy(sigs).to(device), torch.from_numpy(sig_lens),
                                 torch.from_numpy(rir_pad).to(device),
                                 torch.from_numpy(rir_lens)).cpu().numpy()

    card()
    t0 = time.perf_counter()
    got = card()
    card_s = time.perf_counter() - t0
    worst, differ, samples = 0.0, 0, 0
    for i, ((utt, sig, _), w) in enumerate(zip(items, want)):
        rel = float(np.abs(got[i, :len(sig)] - w).max() / np.abs(w).max())
        worst = max(worst, rel)
        if not rel <= REVERB_RTOL:
            raise AssertionError("reverb %s: card float64 %.3g of the peak from numpy (> %g)"
                                 % (utt, rel, REVERB_RTOL))
        written = read_wav(os.path.join(out, "wav", utt + "-reverb.wav"))[0]
        differ += int(np.sum(written != np.clip(w, -32768, 32767).astype("<i2")))
        samples += len(sig)
    audio_s = samples / 16000.0
    print("reverb, %d utterances (%.1f s of audio, RIRs of %s samples): card float64 "
          "reverberate_torch vs numpy reverberate max |diff| %.3g of the peak (<= %g) ok; int16 "
          "samples the CLI wrote that differ from numpy's truncation: %d of %d; numpy "
          "(np.convolve, one host core) %.3f s = %.1f s per hour of audio, the card's batch "
          "(copies in and out included) %.4f s = %.3f s per hour of audio (%s)"
          % (len(items), audio_s, sorted(int(n) for n in rir_lens), worst, REVERB_RTOL, differ,
             samples, numpy_s, numpy_s * 3600 / audio_s, card_s, card_s * 3600 / audio_s, CARD))
    return dict(reverb_max_rel_err=worst, reverb_int16_differ=differ, reverb_check_samples=samples,
                numpy_reverb_s_per_audio_hour=numpy_s * 3600 / audio_s,
                card_reverb_batch_s_per_audio_hour=card_s * 3600 / audio_s)


def reverb_log_seconds(run):
    """The audio and convolution seconds that cli.augment_data --mode reverb
    logged."""
    for _, msg in run["logged"]:
        m = re.match(r"reverb: ([0-9.]+) s of audio, ([0-9.]+) s in the convolutions", msg)
        if m:
            return float(m.group(1)), float(m.group(2))
    raise AssertionError("augment_data --mode reverb logged no convolution seconds")


def run_augmentation(torch, root, data, device="cuda"):
    """Phase 20: cli.augment_data on the card (``device``) in the four
    recipe modes over the wav corpus; the checks against the numpy copies.
    Returns the sources' wav.scp paths, the launches and a summary."""
    from tf_kaldi_speaker_tpu_torch.cli import augment_data

    t_phase = time.perf_counter()
    srcs = write_aug_sources(os.path.join(root, "aug_sources"))
    hours = data["seconds"] / 3600.0
    summary, launches = {}, collections.Counter()
    for mode, (args, kind) in AUG_MODES.items():
        out = os.path.join(root, "aug_" + mode)
        run = drive(torch, augment_data.main, ["--mode", mode] + args + [
            "--aug-wav-scp", srcs[kind], "--device", device, data["wav_scp"], data["utt2spk"],
            out])
        if run["rc"] != 0:
            raise RuntimeError("cli.augment_data --mode %s exited %d" % (mode, run["rc"]))
        launches.update(run["launches"])
        written = len(_scp_entries(os.path.join(out, "wav.scp")))
        if written != len(data["utts"]):
            raise AssertionError("%s: %d of %d utterances written" % (mode, written,
                                                                     len(data["utts"])))
        summary["%s_s_per_audio_hour" % mode] = run["wall"] / hours
        if mode == "reverb":
            audio_s, conv_s = reverb_log_seconds(run)
            summary.update(reverb_conv_s=conv_s, reverb_wall_s=run["wall"])
            summary.update(check_reverb(torch, data, srcs["rirs"], out, device))
            print("cli.augment_data --mode reverb on the card (%s): %.1f s of audio in %.3f s = "
                  "%.2f s per hour of audio; the convolutions (batches of 64, copies in and out "
                  "included) %.3f s of it, the rest the host's wav reads and writes"
                  % (CARD, audio_s, run["wall"], run["wall"] / hours, conv_s))
        else:
            replay_host_mode(mode, data, srcs[kind], out)
            print("cli.augment_data --mode %s (%s, host numpy): %.3f s = %.2f s per hour of "
                  "audio; every wav byte-equal to the numpy copy's ok"
                  % (mode, CARD, run["wall"], run["wall"] / hours))
    print("augmentation phase: %.2f s" % (time.perf_counter() - t_phase))
    return srcs, dict(launches), summary


# ---------------------------------------------------------------------------
# Phase 21: the recipe (tf_kaldi_speaker_tpu_torch/recipes/voxceleb/v1/run.sh)
# ---------------------------------------------------------------------------
RECIPE_SCRIPT = os.path.join(ROOT, "tf_kaldi_speaker_tpu_torch", "recipes", "voxceleb", "v1",
                             "run.sh")
# synthetic voices as a VoxCeleb1 tree (speakers 0-39 dev, 40-47 named in the
# verification list) and a VoxCeleb2 tree (48-75 dev, 76-79 test), 2 videos
# x 2 clips each, 4.5-8 s; the sizes are a smoke choice (VoxCeleb1 has 1,251
# speakers, VoxCeleb2 6,112)
RECIPE_CORPUS = dict(num_speakers=80, utts_per_speaker=4, min_seconds=4.5, max_seconds=8.0,
                     seed=8)
RECIPE_SPLIT = dict(vox1_dev=range(0, 40), vox1_test=range(40, 48), vox2_dev=range(48, 76),
                    vox2_test=range(76, 80))
# what tests/test_recipe_e2e.py cuts of the recipe: the configs' epochs,
# steps, validation batches, checkpoint and summary cadence ...
RECIPE_CUTS = dict(num_epochs=1, num_steps_per_epoch=16, valid_max_iterations=2,
                   save_checkpoints_steps=16, save_summary_steps=16, show_training_progress=8)
# ... and, on a patched copy of the script, stage 4's utterance and
# validation counts and stage 8's LDA width (72 training speakers)
RECIPE_SCRIPT_CUTS = (("--min-num-utts 8", "--min-num-utts 2"),
                      ("--valid-speakers 200 --valid-utts 5", "--valid-speakers 8 --valid-utts 2"),
                      ("--lda-dim 200", "--lda-dim 32"))
# run.sh's `$py` becomes this runner: python -m <module> in a fresh process,
# which at its exit appends the process's kernel launch counts to a log
LAUNCH_RUNNER = '''"""python -m MODULE ARGS..., then append this process's kernel launch
and shape counts (zero where a wrapper was never imported), its native
reader's and WFST decoder's counts, its wall seconds and, for
cli.decode_faster, the seconds spent in the functions TIMED names to the
JSON-lines file named by TFKS_LAUNCH_LOG."""
import atexit
import importlib
import json
import os
import runpy
import sys
import time

T0 = time.perf_counter()

WRAPPERS = {"cm_dequantize": ("tf_kaldi_speaker_tpu_torch.ops.cm_dequant", "cm_dequantize"),
            "masked_stats_pooling": ("tf_kaldi_speaker_tpu_torch.ops.pooling",
                                     "masked_stats_pooling"),
            "masked_stats_pooling_backward": ("tf_kaldi_speaker_tpu_torch.ops.pooling",
                                              "masked_stats_pooling_backward"),
            "batch_norm_train": ("tf_kaldi_speaker_tpu_torch.ops.batchnorm", "batch_norm_train"),
            "batch_norm_train_backward": ("tf_kaldi_speaker_tpu_torch.ops.batchnorm",
                                          "batch_norm_train_backward")}
# (module, class or None, function): each call's seconds summed under the
# function's name, in whatever thread it runs
TIMED = (("tf_kaldi_speaker_tpu_torch.backend.decoder", "WfstDecoder", "decode_lattice"),
         ("tf_kaldi_speaker_tpu_torch.backend.lattice", None, "determinize_lattice"))
MODULE = sys.argv[1]
SECONDS = {}


def timed(name, fn):
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            SECONDS[name] = SECONDS.get(name, 0.0) + time.perf_counter() - t0
    return call


def dump():
    native = sys.modules.get("tf_kaldi_speaker_tpu_torch.kio.native_decode")
    decoder = sys.modules.get("tf_kaldi_speaker_tpu_torch.backend.decoder")
    rec = {"module": MODULE, "launches": {}, "shapes": {},
           "native": dict(native.counts) if native is not None else {},
           "decoder": dict(decoder.counts) if decoder is not None else {},
           "wall": time.perf_counter() - T0, "seconds": SECONDS}
    for name, (mod, attr) in WRAPPERS.items():
        fn = getattr(sys.modules.get(mod), attr, None)
        rec["launches"][name] = fn.launches if fn is not None else 0
        rec["shapes"][name] = ([[list(s), d, n] for (s, d), n in fn.shapes.items()]
                               if fn is not None else [])
    with open(os.environ["TFKS_LAUNCH_LOG"], "a") as f:
        f.write(json.dumps(rec) + "\\n")


atexit.register(dump)
for mod, cls, attr in TIMED if MODULE == "tf_kaldi_speaker_tpu_torch.cli.decode_faster" else ():
    owner = importlib.import_module(mod)
    owner = getattr(owner, cls) if cls else owner
    setattr(owner, attr, timed(attr, getattr(owner, attr)))
sys.argv = sys.argv[1:]
runpy.run_module(MODULE, run_name="__main__", alter_sys=True)
'''


def write_vox_trees(root):
    """RECIPE_CORPUS as VoxCeleb1 (consolidated wav layout) and VoxCeleb2
    (dev and test, wav layout) corpus trees with a verification list of
    every pair of the test speakers' clips; returns the two roots and the
    seconds of audio."""
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_wav_data_dir

    made = make_wav_data_dir(os.path.join(root, "voices"), **RECIPE_CORPUS)
    vox1, vox2 = os.path.join(root, "vox1"), os.path.join(root, "vox2")
    parts = dict(vox1_dev=os.path.join(vox1, "wav"), vox1_test=os.path.join(vox1, "wav"),
                 vox2_dev=os.path.join(vox2, "dev", "wav"),
                 vox2_test=os.path.join(vox2, "test", "wav"))
    test_clips = []
    for part, speakers in RECIPE_SPLIT.items():
        for s in speakers:
            spk = "id%05d" % ((10000 if part.startswith("vox1") else 20000) + s)
            for u in range(RECIPE_CORPUS["utts_per_speaker"]):
                rel = "%s/vid%s/%05d.wav" % (spk, "AB"[u // 2], u % 2 + 1)
                dst = os.path.join(parts[part], rel)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                os.rename(os.path.join(made["data"], "wav", "spk%03d_utt%03d.wav" % (s, u)), dst)
                if part == "vox1_test":
                    test_clips.append(rel)
    with open(os.path.join(vox1, "veri_test.txt"), "w") as f:
        for i, a in enumerate(test_clips):
            for b in test_clips[i + 1:]:
                f.write("%d %s %s\n" % (a.split("/")[0] == b.split("/")[0], a, b))
    return vox1, vox2, made["seconds"]


def recipe_configs(root):
    """The shipped training and fine-tuning configs with RECIPE_CUTS."""
    paths = {}
    for key, name in (("config", "tdnn_amsoftmax_m0.20_linear_bn_1e-2.json"),
                      ("finetune_config", "tdnn_amsoftmax_m0.20_linear_bn_1e-2_mhe0.01.json")):
        with open(os.path.join(VOX_CONF, name)) as f:
            paths[key] = write_json(os.path.join(root, "recipe_" + name),
                                    dict(json.load(f), **RECIPE_CUTS))
    return paths


class Beside(threading.Thread):
    """``fn(*args)`` in a thread, beside the phases that follow: for a
    phase whose work is its own processes (a recipe's stages), so that its
    interpreters' start-up overlaps another such phase's. ``result()``
    joins it and returns what ``fn`` returned, or raises what it raised."""

    def __init__(self, fn, *args):
        super().__init__(daemon=True)
        self._fn, self._args, self._out, self._err = fn, args, None, None
        self.start()

    def run(self):
        try:
            self._out = self._fn(*self._args)
        except BaseException as e:  # noqa: BLE001 - raised again by result()
            self._err = e

    def result(self):
        self.join()
        if self._err is not None:
            raise self._err
        return self._out


def run_stages(script, env, stages, d, may_skip=()):
    """``script`` one stage at a time (``stage=stop_stage=N``), each stage's
    output kept in ``d/stageN.log``; raises on a failed stage (with the end
    of its output), or a skipped one not in ``may_skip``. Returns the
    stages' seconds and outputs."""
    stage_s, logs = {}, {}
    for stage in stages:
        t0 = time.perf_counter()
        proc = subprocess.run(["bash", script], env=dict(env, stage=str(stage),
                                                         stop_stage=str(stage)),
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=600)
        stage_s[stage] = time.perf_counter() - t0
        logs[stage] = proc.stdout
        with open(os.path.join(d, "stage%d.log" % stage), "w") as f:
            f.write(proc.stdout)
        if proc.returncode != 0:
            raise RuntimeError("%s stage %d exited %d:\n%s"
                               % (script, stage, proc.returncode, proc.stdout[-4000:]))
        if "SKIPPING" in proc.stdout and stage not in may_skip:
            raise AssertionError("%s stage %d skipped its work" % (script, stage))
    return stage_s, logs


def read_launch_log(path):
    """The runner's records: launches and shapes summed, launches and
    native reader counts by CLI."""
    launches, shapes = collections.Counter(), {}
    by_module = collections.defaultdict(collections.Counter)
    native = collections.defaultdict(collections.Counter)
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            module = rec["module"].rsplit(".", 1)[-1]
            launches.update(rec["launches"])
            by_module[module].update(rec["launches"])
            native[module].update(rec.get("native", {}))
            for name, rows in rec["shapes"].items():
                counter = shapes.setdefault(name, collections.Counter())
                for shape, dtype, n in rows:
                    counter[(tuple(shape), dtype)] += n
    return launches, shapes, by_module, native


def recipe_stages(root, srcs, device="cuda"):
    """Phase 21's CLI work: the corpus trees and the port's run.sh, stages
    0-8 one at a time, on the card (``device``). It runs in a thread
    (:class:`Beside`), so it prints nothing; :func:`report_recipe` checks
    and prints what it returns."""
    t_phase = time.perf_counter()
    d = os.path.join(root, "recipe")
    os.makedirs(d)
    vox1, vox2, seconds = write_vox_trees(d)
    write_s = time.perf_counter() - t_phase
    with open(RECIPE_SCRIPT) as f:
        script = f.read()
    for old, new in RECIPE_SCRIPT_CUTS:
        if old not in script:
            raise AssertionError("run.sh no longer holds %r" % old)
        script = script.replace(old, new)
    runner = os.path.join(d, "launch_runner.py")
    with open(runner, "w") as f:
        f.write(LAUNCH_RUNNER)
    script = script.replace('py="python -m"', 'py="%s %s"' % (sys.executable, runner))
    patched = os.path.join(d, "run.sh")
    with open(patched, "w") as f:
        f.write(script)
    data, exp = os.path.join(d, "data"), os.path.join(d, "exp")
    launch_log = os.path.join(d, "launches.jsonl")
    env = dict(os.environ, data_root=data, exp=exp, device=device, voxceleb1_root=vox1,
               voxceleb2_root=vox2, musan_root=os.path.dirname(os.path.dirname(srcs["noise"])),
               rirs_root=os.path.dirname(srcs["rirs"]), model=os.path.join(exp, "m"),
               finetune_model=os.path.join(exp, "m_ft"), TFKS_LAUNCH_LOG=launch_log,
               **recipe_configs(d))
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    stage_s, logs = run_stages(patched, env, range(9), d)
    return dict(data=data, exp=exp, launch_log=launch_log, seconds=seconds, write_s=write_s,
                stage_s=stage_s, logs=logs, work_s=time.perf_counter() - t_phase)


def report_recipe(run):
    """Phase 21's checks on what :func:`recipe_stages` returned, and its
    lines. Returns the path's launches and shapes (summed over its
    processes) and a summary."""
    t0 = time.perf_counter()
    data, exp, stage_s, logs = run["data"], run["exp"], run["stage_s"], run["logs"]
    print("recipe (%s): the port's run.sh, cut as tests/test_recipe_e2e.py cuts the JAX one: "
          "configs %s; script %s; corpus %d speakers x %d clips, %.1f s of audio, written in "
          "%.2f s" % (CARD, RECIPE_CUTS, ["%s -> %s" % c for c in RECIPE_SCRIPT_CUTS],
                      RECIPE_CORPUS["num_speakers"], RECIPE_CORPUS["utts_per_speaker"],
                      run["seconds"], run["write_s"]))
    # what came out: augmented copies of all four kinds in train_combined,
    # both models, both score files and their EERs
    with open(os.path.join(data, "train_combined", "feats.scp")) as f:
        utts = [line.split()[0] for line in f]
    suffixes = collections.Counter(u.rsplit("-", 1)[-1] for u in utts
                                   if u.rsplit("-", 1)[-1] in AUG_MODES)
    if set(suffixes) != set(AUG_MODES):
        raise AssertionError("train_combined holds augmented copies %s" % dict(suffixes))
    for model in ("m", "m_ft"):
        if not os.path.exists(os.path.join(exp, model, "nnet", "checkpoint")):
            raise AssertionError("run.sh trained no %s" % model)
    for way in ("cosine", "plda"):
        path = os.path.join(exp, "scores_%s.txt" % way)
        with open(path) as f:
            n = len(f.read().splitlines())
        if not n:
            raise AssertionError("%s is empty" % path)
    eers = re.findall(r"EER[^0-9]*([0-9.]+)", logs[8])
    if len(eers) < 2:
        raise AssertionError("stage 8 reported EERs %s:\n%s" % (eers, logs[8][-2000:]))
    # the kernels of each stage's processes
    launches, shapes, by_module, _ = read_launch_log(run["launch_log"])
    for module in ("train", "finetune"):
        if by_module[module]["cm_dequantize"] <= 0:
            raise AssertionError("stage %s launched cm_dequantize %s times"
                                 % (module, by_module[module]["cm_dequantize"]))
    check_launched("recipe path (run.sh stages 0-8, every process)",
                   dict(launches=dict(launches), shapes=shapes), ["cm_dequantize"])
    print("recipe kernel launches by CLI: %s" % json.dumps(
        {m: dict(c) for m, c in sorted(by_module.items()) if sum(c.values())}))
    print("recipe stage times on the card (%s; each stage one bash run of the patched script, "
          "every CLI its own interpreter): %s s; train_combined %d utterances (augmented %s); "
          "stage 8 EERs %s; the phase %.2f s"
          % (CARD, {s: round(t, 2) for s, t in stage_s.items()}, len(utts), dict(suffixes),
             eers, run["work_s"] + time.perf_counter() - t0))
    summary = dict(stage_s=stage_s, train_combined_utts=len(utts), augmented=dict(suffixes),
                   eers=eers, audio_s=run["seconds"])
    return dict(launches), shapes, summary


# ---------------------------------------------------------------------------
# Phase 22: the triplet family
# ---------------------------------------------------------------------------
# the flagship (bf16, fused pooling, device pool) with the angular triplet
# loss; its 64 rows as 16 speakers x 4 segments, end2end validation at 8 x 4
# (the layouts are a smoke choice: no shipped config uses the triplet family)
TRIPLET = dict(TRAIN, loss_func="angular_triplet_loss", triplet_type="hard",
               loss_type="additive_margin_softmax", margin=0.2, num_speakers_per_batch=16,
               num_segments_per_speaker=4, batch_type="end2end", num_valid_speakers_per_batch=8,
               num_valid_segments_per_speaker=4, num_epochs=1)
# the generalized angular triplet with "average" centers (the TF golden
# test's weights, tests/test_tf_golden.py:478-482), one epoch of 8 steps,
# then --cont for a second
GENERALIZED = dict(TRIPLET, loss_func="generalized_angular_triplet_loss", margin=0.3,
                   target_margin=1.6, triplet_center="average", triplet_center_momentum=0.95,
                   triplet_topn=1, triplet_loss_weight=1.0, center_loss_weight=0.5,
                   between_loss_weight=0.3, l2_loss_weight=0.0, num_steps_per_epoch=8)
GAE2E_SPEAKERS = 32  # the x-vectors of 32 speakers x 4 utterances for compute_gae2e_loss


def profile_triplet_group(torch, model, train):
    """One torch.profiler pass over 8 bf16 triplet steps (after 8 of
    warm-up): the device's busy and idle share and the top kernels."""
    wall, busy_s, n_events, by_name = profile_pool_steps(torch, model, train, TRIPLET, 11)
    if not n_events:
        print("profile: no device events in the trace; device idle share not measured")
        return {}
    print("profile (%s), 8 bf16 angular-triplet steps [64 = 16 x 4, 296, 30] from the pool "
          "under torch.profiler: wall %.4f s (%.3f ms a step), device busy %.4f s, device idle "
          "%.1f%%, %d device events" % (CARD, wall, 1e3 * wall / 8, busy_s,
                                        100 * (1 - busy_s / wall), n_events))
    print_top(by_name, busy_s)
    return dict(triplet_profile_step_ms=1e3 * wall / 8, triplet_device_idle=1 - busy_s / wall)


def check_triplet_step_against_cpu(torch, model, train):
    """One float32 angular-triplet step on the card (TF32 off) against the
    CPU's from the trained state on one pool batch: the loss within CPU_GAP,
    and each updated parameter's update (after - before) at cosine > 0.9999
    of the CPU's (the biases a BatchNorm follows left out: their gradient
    is rounding noise). Returns the loss gap and the updates' least
    cosine."""
    from tf_kaldi_speaker_tpu_torch.convert import flatten, variables_of

    (codes, hdr, lab), = _pool_group(torch, train, "cpu", 1, 296, 13, TRIPLET)
    gpu = _trainer_at(torch, model, "cuda", "float32")
    cpu = _trainer_at(torch, model, "cpu", "float32")
    before = flatten(variables_of(cpu.network_model))
    lr = TRIPLET["learning_rate"]
    loss_gpu = float(gpu.train_step_raw(codes.cuda(), hdr.cuda(), lab.cuda(), lr)["loss"])
    loss_cpu = float(cpu.train_step_raw(codes, hdr, lab, lr)["loss"])
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    if not (np.isfinite(loss_gpu) and rel <= CPU_GAP):
        raise AssertionError("triplet step: card float32 loss %r vs CPU %r (rel %.3g > %g)"
                             % (loss_gpu, loss_cpu, rel, CPU_GAP))
    got, want = flatten(variables_of(gpu.network_model)), flatten(variables_of(cpu.network_model))
    worst, largest = 1.0, 0.0
    for path, w in want.items():
        if path[0] != "params" or (path[-1] == "bias" and path[-2].endswith(("_conv", "_dense"))):
            continue
        b = before[path].double().ravel()
        du, dw = got[path].double().ravel() - b, w.double().ravel() - b
        worst = min(worst, float(du @ dw / (du.norm() * dw.norm())))
        largest = max(largest, float((du - dw).abs().max() / dw.abs().max()))
    if not worst > 0.9999:
        raise AssertionError("triplet step: the updates' min cosine card vs CPU %.8f" % worst)
    print("one float32 angular-triplet step, card vs CPU from the trained state: loss %r vs %r "
          "(rel %.3g <= %g); the updates min cosine %.9f (> 0.9999), largest difference %.3g "
          "of a parameter's largest update ok" % (loss_gpu, loss_cpu, rel, CPU_GAP, worst,
                                                  largest))
    return dict(triplet_cpu_loss_gap=rel, triplet_cpu_update_min_cosine=worst)


@contextlib.contextmanager
def watch_centers(torch, seen):
    """Record the "average" centers at each cli.train's first epoch start
    (``seen["start"]``) and after each checkpoint restore
    (``seen["restored"]``)."""
    from tf_kaldi_speaker_tpu_torch.train import trainer as trainer_mod

    Trainer = trainer_mod.Trainer
    load, train_fn = Trainer.load, Trainer.train

    def centers(self):
        return self.network_model.softmax.triplet_centers.detach().cpu().clone()

    def loaded(self, *args, **kw):
        step = load(self, *args, **kw)
        seen.setdefault("restored", []).append((step, centers(self)))
        return step

    def training(self, *args, **kw):
        seen.setdefault("start", centers(self))
        return train_fn(self, *args, **kw)

    Trainer.load, Trainer.train = loaded, training
    try:
        yield
    finally:
        Trainer.load, Trainer.train = load, train_fn


def run_generalized(torch, root, train, valid):
    """cli.train with GENERALIZED for one epoch, then --cont for a second:
    the restored centers bit-equal to the checkpoint's, and moving in
    both epochs. Returns the two runs."""
    from tf_kaldi_speaker_tpu_torch.cli import train as cli_train

    model = os.path.join(root, "triplet_generalized")
    cfg_path = write_json(os.path.join(root, "triplet_generalized.json"), GENERALIZED)
    argv = [train["data"], train["spklist"], valid["data"], valid["spklist"], model]
    seen = {}
    with watch_centers(torch, seen):
        first = drive(torch, cli_train.main, ["--config", cfg_path, "--device", "cuda"] + argv)
        if first["rc"] != 0:
            raise RuntimeError("cli.train generalized exited %d" % first["rc"])
        nnet = os.path.join(model, "nnet")
        write_json(os.path.join(nnet, "config.json"), dict(GENERALIZED, num_epochs=2))
        second = drive(torch, cli_train.main, ["--cont", "--device", "cuda"] + argv)
        if second["rc"] != 0:
            raise RuntimeError("cli.train --cont generalized exited %d" % second["rc"])
    n = GENERALIZED["num_steps_per_epoch"]
    saved = {s: torch.load(os.path.join(nnet, "model-%d.pt" % s), weights_only=True)[
        "loss_stats"]["softmax"]["triplet_centers"] for s in (n, 2 * n)}
    restored = [(s, c) for s, c in seen.get("restored", []) if s == n]
    if not restored or not torch.equal(restored[0][1], saved[n]):
        raise AssertionError("--cont did not restore the centers of model-%d" % n)
    if torch.equal(seen["start"], saved[n]) or torch.equal(saved[n], saved[2 * n]):
        raise AssertionError("the centers did not move in both epochs")
    for run in (first, second):
        check_launched("generalized triplet path (cli.train, device pool, bf16)", run,
                       kernel_wrappers())
    print("generalized angular triplet, average centers: epoch 1 (%d steps), then --cont "
          "restored model-%d's centers bit for bit (max |moved| %.4g in epoch 1, %.4g in "
          "epoch 2) ok; walls %.2f s, %.2f s"
          % (n, n, float((saved[n] - seen["start"]).abs().max()),
             float((saved[2 * n] - saved[n]).abs().max()), first["wall"], second["wall"]))
    return first, second


def run_gae2e(torch, model, train, root):
    """cli.extract --device-pipe from the triplet model over the training
    utterances, then cli.compute_gae2e_loss (GE2E and angular triplet) on
    the embeddings of the first GAE2E_SPEAKERS speakers, on the card and on
    the CPU: the losses within 1e-5 relative."""
    from tf_kaldi_speaker_tpu_torch.cli import compute_gae2e_loss
    from tf_kaldi_speaker_tpu_torch.cli import extract as cli_extract

    out = os.path.join(root, "triplet_xvector")
    rc = cli_extract.main(["--device-pipe", "--batch-size", "32", "--device", "cuda", model,
                           "scp:" + os.path.join(train["data"], "feats.scp"),
                           "ark,scp:%s.ark,%s.scp" % (out, out)])
    if rc != 0:
        raise RuntimeError("cli.extract from the triplet model exited %d" % rc)
    with open(os.path.join(train["data"], "utt2spk")) as f:
        utt2spk = dict(line.split() for line in f)
    speakers = sorted(set(utt2spk.values()))[:GAE2E_SPEAKERS]
    with open(out + ".scp") as f:
        lines = [line for line in f if utt2spk[line.split()[0]] in speakers]
    with open(out + "_subset.scp", "w") as f:
        f.write("".join(lines))
    losses = {}
    for loss in ("e2e", "angular_triplet"):
        for device in ("cuda", "cpu"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = compute_gae2e_loss.main(["--loss", loss, "--device", device,
                                              out + "_subset.scp",
                                              os.path.join(train["data"], "utt2spk")])
            m = re.match(r"\S+ loss over (\d+) speakers x (\d+) segments: (\S+)", buf.getvalue())
            if rc != 0 or not m or not np.isfinite(float(m.group(3))):
                raise AssertionError("compute_gae2e_loss %s on %s: rc %d, %r"
                                     % (loss, device, rc, buf.getvalue()))
            losses[loss, device] = float(m.group(3))
        rel = abs(losses[loss, "cuda"] - losses[loss, "cpu"]) / abs(losses[loss, "cpu"])
        if rel > 1e-5:
            raise AssertionError("compute_gae2e_loss %s: card %.6f vs CPU %.6f"
                                 % (loss, losses[loss, "cuda"], losses[loss, "cpu"]))
        print("cli.compute_gae2e_loss --loss %s over %s speakers x %s segments of the triplet "
              "model's x-vectors: card %.6f, CPU %.6f (rel %.2g <= 1e-5) ok"
              % (loss, m.group(1), m.group(2), losses[loss, "cuda"], losses[loss, "cpu"], rel))
    return {"%s_%s" % k: v for k, v in losses.items()}


def run_triplet(torch, root, train, valid):
    """Phase 22. Returns the path's launches and shapes and a summary."""
    from tf_kaldi_speaker_tpu_torch.cli import train as cli_train

    t_phase = time.perf_counter()
    model = os.path.join(root, "triplet")
    cfg_path = write_json(os.path.join(root, "triplet.json"), TRIPLET)
    run = drive(torch, cli_train.main, ["--config", cfg_path, "--device", "cuda", train["data"],
                                        train["spklist"], valid["data"], valid["spklist"], model])
    if run["rc"] != 0:
        raise RuntimeError("cli.train angular triplet exited %d" % run["rc"])
    launches = check_launched("triplet path (cli.train, angular triplet, device pool, bf16)",
                              run, kernel_wrappers())
    losses = [float(m.split("loss ")[1].split()[0]) for name, m in run["logged"]
              if name == "tfks_torch.trainer" and " loss " in m]
    K, n = TRIPLET["steps_per_dispatch"], TRIPLET["num_steps_per_epoch"]
    if len(losses) != n // K or not np.all(np.isfinite(losses)):
        raise AssertionError("triplet: logged losses %s (expected %d finite)" % (losses, n // K))
    with open(os.path.join(model, "nnet", "valid_loss")) as f:
        valid_lines = f.read().split("\n")[:-1]
    if len(valid_lines) != 1 or not np.isfinite(float(valid_lines[0].split()[1])):
        raise AssertionError("triplet: end2end valid_loss %s" % valid_lines)
    if not os.path.exists(os.path.join(model, "nnet", "model-%d.pt" % n)):
        raise AssertionError("triplet: no checkpoint at step %d" % n)
    groups, _ = group_times(run["marks"], 0)
    print("triplet train step (%s): %d groups of %d bf16 steps [64 = 16 x 4, 200-400 frames]: "
          "%.3f ms a step in the last group (group times %s s, the first with start-up); group "
          "losses %s; end2end valid line %s (GE2E over 8 x 4); whole cli.train run %.2f s"
          % (CARD, len(groups), K, 1e3 * groups[-1] / K, ["%.4f" % g for g in groups], losses,
             valid_lines[0], run["wall"]))
    profile = profile_triplet_group(torch, model, train)
    gaps = check_triplet_step_against_cpu(torch, model, train)
    first, second = run_generalized(torch, root, train, valid)
    gae2e = run_gae2e(torch, model, train, root)
    shapes = {}
    for r in (run, first, second):
        for name, counter in r["shapes"].items():
            shapes.setdefault(name, collections.Counter()).update(counter)
        for name, count in r["launches"].items():
            if r is not run:
                launches[name] += count
    print("triplet phase: %.2f s" % (time.perf_counter() - t_phase))
    summary = dict(profile, triplet_last_group_step_ms=1e3 * groups[-1] / K, **gaps,
                   generalized_walls_s=[first["wall"], second["wall"]], **gae2e)
    return launches, shapes, summary


# ---------------------------------------------------------------------------
# Phase 23: the native ark reader under the streaming loader
# ---------------------------------------------------------------------------
NATIVE_CHECK = dict(items=16, length=300)  # the bit-equality check's batch
# The CM read's builds compared on the card's host: every matrix read column
# by column (the JAX copy's reads), the port's build (one read of the span
# that holds the requested rows where it is at most 4 times the requested
# bytes), and every matrix in one span read. Batches of 64 chunks of 300
# rows at random starts, as the sampler asks, read with the sampler's 4
# threads (decode_batch) and row by row (decode_submat, the multi-stream
# sampler's read), the builds interleaved batch by batch.
CM_READS = (("per_column", ("-DTFKS_CM_SPAN_FACTOR=0",)), ("port", ()),
            ("span", ("-DTFKS_CM_SPAN_FACTOR=1000000",)))
READ_AB = dict(batches=12, items=64, length=300, threads=4, seed=29)
# long utterances for the reads: 16 Fisher-length sides (10 minutes at 100
# frames a second) of the Fisher recipe's 23 cepstra
LONG_TREE = dict(utts=16, frames=60000, dim=23, seed=31)


def native_counts_reset():
    from tf_kaldi_speaker_tpu_torch.kio import native_decode

    native_decode.reset_counts()


def native_counts():
    from tf_kaldi_speaker_tpu_torch.kio import native_decode

    return dict(native_decode.counts)


def check_no_fallback(path, counts, kind):
    """A native path: reads of ``kind`` served natively, none handed back
    to numpy."""
    if counts.get("fallback", 0) or not counts.get(kind, 0):
        raise AssertionError("%s: native reader counts %s (want %s > 0, no fallback)"
                             % (path, counts, kind))
    print("%s: native reader %s, 0 numpy fallbacks ok" % (path, json.dumps(counts)))


def build_native():
    """Build (or find) the native reader's library; prints the build time
    and the library's path."""
    from tf_kaldi_speaker_tpu_torch.kio import native_decode

    t0 = time.perf_counter()
    path = native_decode.build()
    if not native_decode.native_available():
        raise AssertionError("the native reader did not load from %s" % path)
    print("native ark reader built with g++ %s from %s in %.2f s -> %s"
          % (" ".join(native_decode.GXX_FLAGS), os.path.relpath(native_decode.SOURCE, ROOT),
             time.perf_counter() - t0, path))
    return path


def check_native_reads(data):
    """``decode_batch_fast`` and ``read_batch_codes_fast`` over NATIVE_CHECK
    items of a compressed data dir (the first item ends on its utterance's
    last frame) bit-equal to the port's numpy codec."""
    from tf_kaldi_speaker_tpu_torch.kio import FeatureReader, native_decode, read_mat

    reader = FeatureReader(data["data"])
    L, rng = NATIVE_CHECK["length"], random.Random(5)
    with open(data["feats_scp"]) as f:
        segs = [line.strip() for _, line in zip(range(NATIVE_CHECK["items"]), f)]
    items = []
    for k, seg in enumerate(segs):
        utt, rx = seg.split(" ")
        n = reader.utt2num_frames[utt]
        filename, offset = rx.rsplit(":", 1)
        items.append((filename, int(offset), n - L if k == 0 else rng.randint(0, n - L), L))
    floats = np.empty((len(items), L, reader.dim), np.float32)
    codes = np.empty((len(items), L, reader.dim), np.uint8)
    headers = np.empty((len(items), 4, reader.dim), np.float32)
    if not (native_decode.decode_batch_fast(items, floats)
            and native_decode.read_batch_codes_fast(items, codes, headers)):
        raise AssertionError("the native batch reads refused the smoke corpus")
    for k, (seg, (_, _, start, _)) in enumerate(zip(segs, items)):
        want = read_mat(seg.split(" ")[1])[start:start + L]
        want_c, want_h, _ = reader.read_segment_codes(seg, L, start=start)
        if not (np.array_equal(floats[k].view(np.uint32), want.view(np.uint32))
                and np.array_equal(codes[k], want_c)
                and np.array_equal(headers[k].view(np.uint32), want_h.view(np.uint32))):
            raise AssertionError("native read of %s [%d, %d) differs from the numpy codec"
                                 % (seg.split(" ")[0], start, start + L))
    reader.close()
    print("native decode_batch_fast and read_batch_codes_fast, %d items x %d frames x %d (the "
          "first ending on its last frame): floats, codes and headers bit-equal to the numpy "
          "codec ok" % (len(items), L, codes.shape[2]))


def write_long_tree(root):
    """A compressed data dir of LONG_TREE utterances."""
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    return make_fake_data_dir(os.path.join(root, "long"), num_speakers=LONG_TREE["utts"],
                              utts_per_speaker=1, dim=LONG_TREE["dim"],
                              min_len=LONG_TREE["frames"], max_len=LONG_TREE["frames"],
                              seed=LONG_TREE["seed"])["data"]


def cm_read_ab(name, data_dir):
    """READ_AB's batches over ``data_dir``'s CM matrices with each of
    CM_READS' builds: the median ms a batch through ``tfks_decode_batch``
    and row by row through ``tfks_decode_submat``, the floats bit-equal
    across builds. Returns {build: {batch_ms, rows_ms}}."""
    import ctypes

    from tf_kaldi_speaker_tpu_torch.kio import FeatureReader, native_decode

    reader = FeatureReader(data_dir)
    dim, L = reader.dim, READ_AB["length"]
    reader.close()
    rng = random.Random(READ_AB["seed"])
    with open(os.path.join(data_dir, "feats.scp")) as f:
        mats = [(line.split()[0], *line.split()[1].rsplit(":", 1)) for line in f]
    mats = [(utt, fn, int(off)) for utt, fn, off in mats if reader.utt2num_frames[utt] >= L]
    libs = {b: native_decode.load(native_decode.build(native_decode.GXX_FLAGS + flags))
            for b, flags in CM_READS}
    times = {b: dict(batch_ms=[], rows_ms=[]) for b in libs}
    fp = ctypes.POINTER(ctypes.c_float)
    for _ in range(READ_AB["batches"] + 1):  # the first batch warms up
        items = []
        for _ in range(READ_AB["items"]):
            utt, fn, off = rng.choice(mats)
            items.append((fn, off, rng.randint(0, reader.utt2num_frames[utt] - L), L))
        args = native_decode.batch_args(items)
        ref = None
        for b, lib in libs.items():
            out = np.empty((len(items), L, dim), np.float32)
            t0 = time.perf_counter()
            r = lib.tfks_decode_batch(*args, len(items), L, dim, out.ctypes.data_as(fp),
                                      READ_AB["threads"])
            t1 = time.perf_counter()
            rows = np.empty_like(out)
            for k, (fn, off, start, n) in enumerate(items):
                if lib.tfks_decode_submat(fn.encode(), off, start, n, rows[k].ctypes.data_as(fp),
                                          rows[k].size) != dim:
                    raise AssertionError("%s build: decode_submat refused %s:%d" % (b, fn, off))
            t2 = time.perf_counter()
            if r != dim or not np.array_equal(out.view(np.uint32), rows.view(np.uint32)):
                raise AssertionError("%s build: decode_batch returned %d or differs from "
                                     "decode_submat" % (b, r))
            if ref is None:
                ref = out
            elif not np.array_equal(out.view(np.uint32), ref.view(np.uint32)):
                raise AssertionError("%s build's floats differ from the %s build's"
                                     % (b, CM_READS[0][0]))
            times[b]["batch_ms"].append(1e3 * (t1 - t0))
            times[b]["rows_ms"].append(1e3 * (t2 - t1))
    for lib in libs.values():
        lib.tfks_close_all()
    rows_of = sorted(reader.utt2num_frames.values())
    out = {b: {k: float(np.median(v[1:])) for k, v in t.items()} for b, t in times.items()}
    print("CM reads, %s (%d matrices of %d-%d rows x %d; %s; batches of %d x %d rows, "
          "median of %d): %s; floats bit-equal across the builds ok"
          % (name, len(rows_of), rows_of[0], rows_of[-1], dim, CARD, READ_AB["items"], L,
             READ_AB["batches"], "; ".join(
                 "%s %.3f ms a batch (%d threads), %.3f ms row by row"
                 % (b, v["batch_ms"], READ_AB["threads"], v["rows_ms"]) for b, v in out.items())))
    return out


def run_native_vs_numpy(torch, root, train, valid, device="cuda"):
    """The streaming phase's first epoch (fisher config as it is: 16 loader
    threads, device_decode; 1 epoch of 16 steps, no summaries) twice in
    this process: with the native reader, then with TFKS_DISABLE_NATIVE=1.
    Each run's first-group latency, group times and the consumer's wait
    for each group; the native run without fallbacks, the numpy one
    without native reads."""
    from tf_kaldi_speaker_tpu_torch.cli import train as cli_train

    cfg = dict(stream_config(), num_epochs=1, save_summary_steps=0, profile_steps=0)
    out = {}
    for mode in ("native", "numpy"):
        model = os.path.join(root, "stream_" + mode)
        cfg_path = write_json(os.path.join(root, "stream_%s.json" % mode), cfg)
        waits = []
        native_counts_reset()
        if mode == "numpy":
            os.environ["TFKS_DISABLE_NATIVE"] = "1"
        try:
            run = drive(torch, cli_train.main, [
                "--config", cfg_path, "--device", device, train["data"], train["spklist"],
                valid["data"], valid["spklist"], model], waits=waits)
        finally:
            os.environ.pop("TFKS_DISABLE_NATIVE", None)
        counts = native_counts()
        if run["rc"] != 0:
            raise RuntimeError("cli.train (streaming, %s reader) exited %d" % (mode, run["rc"]))
        check_launched("streaming path, %s reader" % mode, run, ["cm_dequantize"])
        if mode == "native":
            check_no_fallback("streaming path, native reader", counts, "read_batch_codes")
        elif counts.get("read_batch_codes", 0) or not counts.get("fallback", 0):
            raise AssertionError("TFKS_DISABLE_NATIVE=1 run: native reader counts %s" % counts)
        groups, epoch_s = group_times(run["marks"], 0)
        t0 = time.perf_counter()
        if mode == "numpy":
            os.environ["TFKS_DISABLE_NATIVE"] = "1"
        try:
            first_loader_group(train, cfg, int(cfg.get("steps_per_dispatch", 8)), 0)
        finally:
            os.environ.pop("TFKS_DISABLE_NATIVE", None)
        alone_s = time.perf_counter() - t0
        out[mode] = dict(first_group_s=groups[0], group_s=groups, consumer_wait_s=waits,
                         epoch_s=epoch_s, wall_s=run["wall"], one_worker_group_s=alone_s,
                         counts=counts, launches=run["launches"])
        print("streamed epoch, %s reader (%s; fisher config, %d loader threads, device_decode, "
              "%d groups of 8 float32 steps): first group %.3f s after the epoch's start; "
              "group times %s s; the consumer's wait for each group %s s; epoch %.3f s; "
              "whole cli.train %.2f s; one loader worker alone yields its first group in "
              "%.3f s" % (
                  mode, CARD, cfg["num_parallel_datasets"], len(groups), groups[0],
                  ["%.4f" % g for g in groups], ["%.4f" % w for w in waits], epoch_s,
                  run["wall"], alone_s))
    print("first-group latency (%s): native %.3f s, numpy %.3f s (%.2fx)"
          % (CARD, out["native"]["first_group_s"], out["numpy"]["first_group_s"],
             out["numpy"]["first_group_s"] / out["native"]["first_group_s"]))
    return out


def run_native_reader(torch, root, train, valid, device="cuda"):
    """Phase 23 on ``device``. Returns the native run's launches and a
    summary."""
    t_phase = time.perf_counter()
    build_native()
    check_native_reads(train)
    runs = run_native_vs_numpy(torch, root, train, valid, device)
    reads = {"short_30d": cm_read_ab("the training corpus", train["data"]),
             "long_23d": cm_read_ab("long utterances", write_long_tree(root))}
    print("native reader phase: %.2f s" % (time.perf_counter() - t_phase))
    summary = {"%s_%s" % (mode, k): v for mode, r in runs.items() for k, v in r.items()
               if k not in ("counts", "launches")}
    summary["cm_reads_ms"] = reads
    return runs["native"]["launches"], summary


# ---------------------------------------------------------------------------
# Phase 24: the multi-input trainer's BNF chain
# ---------------------------------------------------------------------------
BNF_NODE = "tdnn5_relu"  # cli.extract_bnf's default: 1500-d at the flagship's width
BNF_DIM = 1500
# the flagship (bf16, fused pooling) with the BNF stream concatenated onto
# its input, streamed (the multi-input trainer has no device pool): 1 epoch
# of 16 steps in groups of 8, 2 validation batches; the default 4 loader
# threads and a queue of 2 groups (10 by default; a group of 8 batches of
# 64 x 400 x 1530 float32 is 1.25 GB on the host)
MI = dict(FLAGSHIP, num_epochs=1, num_steps_per_epoch=16, steps_per_dispatch=8,
          learning_rate=0.01, valid_max_iterations=2, show_training_progress=8,
          check_numerics=True, max_queue_size=2,
          aux_feature_dim={"bnf": BNF_DIM}, aux_concat_input=["bnf"])
MI_EXTRACT_CHECK = 4  # extract_mi's embeddings held against a CPU predict
# the float32 multi-input step on the card (TF32 off) against the CPU's:
# the loss's relative gap and 1 - the least cosine of the parameters'
# updates. Each bound sits between what the sound step reads on an H100
# (loss 2.0e-7 and 3.78e-7, updates 3.73e-8 and 6.1e-8 in two runs) and
# what its controls (MI_CONTROLS: the step with TF32 on, and the bf16 step)
# read there in one run (TF32 1.2e-5 and 4.86e-6, bf16 5.83e-4 and
# 6.62e-5); PERF.md section 6 records them. extract_mi is held to
# EMB_MIN_COSINE (sound 7.41e-14, TF32 9.31e-8, bf16 2.84e-5).
MI_LOSS_GAP = 2e-6
MI_UPDATE_COSINE = 5e-7
MI_CONTROLS = (("tf32", "float32", True), ("bf16", "bfloat16", False))


def write_bnf_inputs(train, valid, root):
    """One scp of the training and validation utterances (the aux stream
    must cover both), and a data dir of its speaker maps with an all-voiced
    vad.scp, so that ``prepare_feats --no-cmvn`` keeps every frame aligned
    with the main stream."""
    from tf_kaldi_speaker_tpu_torch.kio import ArkScpWriter

    d = os.path.join(root, "bnf_raw")
    os.makedirs(d)
    scp = os.path.join(root, "train_valid_feats.scp")
    with open(scp, "w") as out:
        for data in (train, valid):
            with open(data["feats_scp"]) as f:
                out.write(f.read())
    for name in ("utt2spk", "spk2utt"):
        with open(os.path.join(d, name), "w") as out:
            for data in (train, valid):
                with open(os.path.join(data["data"], name)) as f:
                    out.write(f.read())
    vad = ArkScpWriter("ark,scp:%s,%s" % (os.path.join(d, "vad.ark"),
                                          os.path.join(d, "vad.scp")), kind="vec")
    for data in (train, valid):
        with open(data["utt2num_frames"]) as f:
            for line in f:
                utt, n = line.split()
                vad.write(utt, np.ones(int(n), np.float32))
    vad.close()
    return scp, d


def aux_subset_scp(aux_scp, main_scp, out):
    """``aux_scp``'s lines in ``main_scp``'s key order (extract_mi reads the
    streams key-aligned)."""
    with open(aux_scp) as f:
        aux = dict(line.split(" ", 1) for line in f)
    with open(main_scp) as f, open(out, "w") as o:
        for line in f:
            key = line.split(" ", 1)[0]
            o.write("%s %s" % (key, aux[key]))
    return out


def _mi_trainer_at(torch, model, device, compute_dtype):
    """A TrainerMultiInput in ``model``'s state (its last checkpoint)."""
    from tf_kaldi_speaker_tpu_torch.train.trainer_mi import TrainerMultiInput
    from tf_kaldi_speaker_tpu_torch.utils.params import Params

    nnet = os.path.join(model, "nnet")
    params = Params(os.path.join(nnet, "config.json"))
    params.dict["compute_dtype"] = compute_dtype
    with open(os.path.join(nnet, "feature_dim")) as f:
        dim = int(f.read())
    with open(os.path.join(nnet, "num_speakers")) as f:
        num_speakers = int(f.read())
    t = TrainerMultiInput(params, nnet, dim=dim, num_speakers=num_speakers, device=device)
    t.build("train")
    t.load()
    return t


def _mi_batch(train, aux, seed, group=1):
    """One loader draw of MI's layout: (main, {"bnf": ...}, labels) as host
    arrays, ``group`` batches stacked when group > 1."""
    from tf_kaldi_speaker_tpu_torch.data import KaldiMultiDataRandomQueue

    q = KaldiMultiDataRandomQueue(train["data"], aux, train["spklist"], num_parallel=1,
                                  max_qsize=1, num_speakers=MI["num_speakers_per_batch"],
                                  min_len=MI["min_segment_len"], max_len=MI["max_segment_len"],
                                  seed=seed, group=group).start()
    try:
        features, labels = q.fetch()
    finally:
        q.stop()
    return features["features"], {"bnf": features["bnf"]}, labels


def _mi_step(torch, model, device, dtype, batch, tf32=False):
    """One ``dtype`` multi-input step on ``device`` from the trained state
    (TF32 on for cuDNN convolutions and matmuls when ``tf32``): the loss
    and the parameters after it."""
    from tf_kaldi_speaker_tpu_torch.convert import flatten, variables_of

    main, aux_b, labels = batch
    t = _mi_trainer_at(torch, model, device, dtype)
    backends = torch.backends
    backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = tf32
    try:
        loss = float(t.train_step(torch.from_numpy(main).to(device),
                                  torch.from_numpy(labels).to(device), MI["learning_rate"],
                                  {k: torch.from_numpy(v).to(device) for k, v in aux_b.items()}
                                  )["loss"])
    finally:
        backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
    return loss, flatten(variables_of(t.network_model))


def update_min_cosine(before, got, want):
    """The least cosine, over the parameters, of one step's update on the
    card (``got`` - ``before``) and the CPU's (``want`` - ``before``), in
    float64; the biases a BatchNorm follows are left out (their gradient
    is float32 noise around zero)."""
    worst = 1.0
    for path, w in want.items():
        if path[0] != "params" or (path[-1] == "bias" and path[-2].endswith(("_conv", "_dense"))):
            continue
        b = before[path].double().ravel()
        du, dw = got[path].double().ravel() - b, w.double().ravel() - b
        worst = min(worst, float(du @ dw / (du.norm() * dw.norm())))
    return worst


def check_mi_step_against_cpu(torch, model, train, aux, device="cuda"):
    """One float32 multi-input step on the card (TF32 off) against the
    CPU's from the trained state on one loader batch: the loss within
    MI_LOSS_GAP and the least cosine of each parameter's update (after -
    before) within MI_UPDATE_COSINE of 1. MI_CONTROLS are read against the
    same CPU step and bounds: the float32 step with TF32 on, and the bf16
    step (the config's compute dtype)."""
    from tf_kaldi_speaker_tpu_torch.convert import flatten, variables_of

    batch = _mi_batch(train, aux, 13)
    before = flatten(variables_of(_mi_trainer_at(torch, model, "cpu", "float32").network_model))
    loss_cpu, want = _mi_step(torch, model, "cpu", "float32", batch)
    readings = {}
    for name, dtype, tf32 in (("sound", "float32", False),) + MI_CONTROLS:
        loss, got = _mi_step(torch, model, device, dtype, batch, tf32)
        rel = abs(loss - loss_cpu) / abs(loss_cpu)
        one_minus = 1.0 - update_min_cosine(before, got, want)
        readings[name] = dict(loss=loss, loss_gap=rel, update_one_minus_cosine=one_minus)
        if name == "sound":
            if not (np.isfinite(loss) and rel <= MI_LOSS_GAP):
                raise AssertionError("multi-input step: card float32 loss %r vs CPU %r (rel %.3g "
                                     "> %g)" % (loss, loss_cpu, rel, MI_LOSS_GAP))
            if not one_minus <= MI_UPDATE_COSINE:
                raise AssertionError("multi-input step: the updates' 1 - min cosine card vs CPU "
                                     "%.3g > %g" % (one_minus, MI_UPDATE_COSINE))
            print("one float32 multi-input step %s + bnf %s, card (TF32 off) vs CPU from the "
                  "trained state: loss %r vs %r (rel %.3g <= %g); the updates 1 - min cosine "
                  "%.3g (<= %g) ok" % (list(batch[0].shape), list(batch[1]["bnf"].shape), loss,
                                       loss_cpu, rel, MI_LOSS_GAP, one_minus, MI_UPDATE_COSINE))
        else:
            print("control %s multi-input step vs the CPU's: loss rel gap %.3g (bound <= %g: %s), "
                  "the updates 1 - min cosine %.3g (bound <= %g: %s)"
                  % (name, rel, MI_LOSS_GAP, "caught" if rel > MI_LOSS_GAP else "NOT caught",
                     one_minus, MI_UPDATE_COSINE,
                     "caught" if one_minus > MI_UPDATE_COSINE else "NOT caught"))
    return dict(mi_cpu_loss_gap=readings["sound"]["loss_gap"],
                mi_cpu_update_one_minus_cosine=readings["sound"]["update_one_minus_cosine"],
                mi_step_controls={k: v for k, v in readings.items() if k != "sound"})


def profile_mi_group(torch, model, train, aux, device="cuda"):
    """One torch.profiler pass over a group of 8 bf16 multi-input steps on
    a loader group already on the card (after the same 8 as warm-up): the
    step time, the device's busy and idle share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    t = _mi_trainer_at(torch, model, device, "bfloat16")
    main, aux_b, labels = _mi_batch(train, aux, 17, group=8)
    main, labels = torch.from_numpy(main).to(device), torch.from_numpy(labels).to(device)
    bnf = torch.from_numpy(aux_b["bnf"]).to(device)
    lr = MI["learning_rate"]

    def steps():
        for k in range(8):
            t.train_step(main[k], labels[k], lr, {"bnf": bnf[k]})

    steps()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_s, n_events, by_name = device_busy(torch, prof)
    if not n_events:
        print("profile: no device events in the trace; device idle share not measured")
        return {}
    print("profile (%s), 8 bf16 multi-input steps [64, %d, 30 + %d] on the card under "
          "torch.profiler: wall %.4f s (%.3f ms a step), device busy %.4f s, device idle "
          "%.1f%%, %d device events" % (CARD, main.shape[2], BNF_DIM, wall, 1e3 * wall / 8,
                                        busy_s, 100 * (1 - busy_s / wall), n_events))
    print_top(by_name, busy_s)
    return dict(mi_profile_step_ms=1e3 * wall / 8, mi_device_idle=1 - busy_s / wall)


def _bf16_predict(torch, trainer, feats, aux):
    """The checkpoint's embedding in bf16 on its trainer's device: every
    parameter and buffer cast, as ``cli.extract`` runs a bf16 model."""
    import copy

    net = copy.deepcopy(trainer.network_model.network).to(torch.bfloat16).eval()
    dev = trainer.device
    with torch.inference_mode():
        _, endpoints = net(torch.from_numpy(feats[None]).to(dev, torch.bfloat16), None,
                           {k: torch.from_numpy(v[None]).to(dev, torch.bfloat16)
                            for k, v in aux.items()})
    node = trainer.params.dict.get("embedding_node", "tdnn6_dense")
    return endpoints[node].float().cpu().numpy()[0]


def check_extract_mi(torch, model, main_scp, aux_scp, xv_scp, device="cuda"):
    """extract_mi's first MI_EXTRACT_CHECK embeddings against a float32 CPU
    predict of the same checkpoint: 1 - cosine <= 1 - EMB_MIN_COSINE each.
    The controls are read against the same CPU embeddings and bound: a
    predict on ``device`` with TF32 on, and the checkpoint in bf16.
    Returns (1 - the least cosine, {control: 1 - its least cosine})."""
    from tf_kaldi_speaker_tpu_torch.kio import read_mat_scp, read_vec_flt_scp

    cpu = _mi_trainer_at(torch, model, "cpu", "float32")
    card = _mi_trainer_at(torch, model, device, "float32")
    got = dict(read_vec_flt_scp(xv_scp))
    aux = dict(read_mat_scp(aux_scp))
    worst = {"sound": 1.0, "tf32": 1.0, "bf16": 1.0}
    backends = torch.backends
    for _, (key, feats) in zip(range(MI_EXTRACT_CHECK), read_mat_scp(main_scp)):
        a = {"bnf": aux[key][:feats.shape[0]]}
        want = cpu.predict(feats, a)
        backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = card.predict(feats, a)
        finally:
            backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
        for name, e in (("sound", got[key]), ("tf32", tf32),
                        ("bf16", _bf16_predict(torch, card, feats, a))):
            worst[name] = min(worst[name], cosine(e, want))
    if not worst["sound"] >= EMB_MIN_COSINE:
        raise AssertionError("extract_mi vs a CPU predict: 1 - min cosine %.3g > %.3g"
                             % (1.0 - worst["sound"], 1.0 - EMB_MIN_COSINE))
    for name in ("tf32", "bf16"):
        print("control %s extract_mi vs the CPU predict: 1 - min cosine %.3g (bound <= %.3g: %s)"
              % (name, 1.0 - worst[name], 1.0 - EMB_MIN_COSINE,
                 "caught" if worst[name] < EMB_MIN_COSINE else "NOT caught"))
    return 1.0 - worst["sound"], {k: 1.0 - v for k, v in worst.items() if k != "sound"}


def run_multi_input(torch, root, trained, train, valid, device="cuda"):
    """Phase 24 on ``device``. Returns the path's launches and shapes and a
    summary."""
    from tf_kaldi_speaker_tpu_torch.cli import extract_bnf, extract_mi, prepare_feats, train_mi

    t_phase = time.perf_counter()
    d = os.path.join(root, "mi")
    os.makedirs(d)
    scp, bnf_raw = write_bnf_inputs(train, valid, d)
    stage_s = {}

    def stage(name, fn, argv):
        t0 = time.perf_counter()
        rc = fn(argv)
        stage_s[name] = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError("%s exited %d" % (name, rc))

    stage("extract_bnf", extract_bnf.main, [
        "--node", BNF_NODE, "--device", device, trained, "scp:" + scp,
        "ark,scp:%s,%s" % (os.path.join(bnf_raw, "bnf.ark"), os.path.join(bnf_raw, "feats.scp"))])
    bnf_egs = os.path.join(d, "bnf_egs")
    stage("prepare_feats --no-cmvn", prepare_feats.main,
          ["--no-cmvn", "--device", device, bnf_raw, bnf_egs])
    from tf_kaldi_speaker_tpu_torch.kio import read_mat_scp

    _, first = next(iter(read_mat_scp(os.path.join(bnf_egs, "feats.scp"))))
    if first.shape[1] != BNF_DIM:
        raise AssertionError("BNFs of width %d, not %d" % (first.shape[1], BNF_DIM))
    bnf_reads = cm_read_ab("the prepared BNFs", bnf_egs)
    model = os.path.join(d, "mi_model")
    cfg_path = write_json(os.path.join(d, "mi.json"), MI)
    native_counts_reset()
    waits = []
    run = drive(torch, train_mi.main, [
        "--config", cfg_path, "--aux_data", "bnf:" + bnf_egs, "--device", device,
        train["data"], train["spklist"], valid["data"], valid["spklist"], model], waits=waits)
    stage_s["train_mi"] = run["wall"]
    if run["rc"] != 0:
        raise RuntimeError("cli.train_mi exited %d" % run["rc"])
    check_no_fallback("multi-input path (train_mi)", native_counts(), "read_submat")
    K, n = MI["steps_per_dispatch"], MI["num_steps_per_epoch"]
    losses = [float(m.split("loss ")[1].split()[0]) for name, m in run["logged"]
              if name == "tfks_torch.trainer" and " loss " in m]
    if len(losses) != n // K or not np.all(np.isfinite(losses)):
        raise AssertionError("train_mi: logged losses %s (expected %d finite)" % (losses, n // K))
    with open(os.path.join(model, "nnet", "valid_loss")) as f:
        valid_lines = f.read().split("\n")[:-1]
    if len(valid_lines) != 1 or not np.isfinite(float(valid_lines[0].split()[1])):
        raise AssertionError("train_mi: valid_loss %s" % valid_lines)
    groups, _ = group_times(run["marks"], 0)
    xv = os.path.join(d, "xvector_mi")
    aux_scp = aux_subset_scp(os.path.join(bnf_egs, "feats.scp"), valid["feats_scp"],
                             os.path.join(d, "bnf_valid.scp"))
    ex = drive(torch, extract_mi.main, [
        "--device", device, "--aux_rspecifier", "bnf:scp:" + aux_scp, model,
        "scp:" + valid["feats_scp"], "ark,scp:%s.ark,%s.scp" % (xv, xv)])
    stage_s["extract_mi"] = ex["wall"]
    if ex["rc"] != 0:
        raise RuntimeError("cli.extract_mi exited %d" % ex["rc"])
    with open(valid["feats_scp"]) as f:
        n_valid = len(f.read().splitlines())
    with open(xv + ".scp") as f:
        if len(f.read().splitlines()) != n_valid:
            raise AssertionError("extract_mi wrote fewer than %d embeddings" % n_valid)
    worst, extract_controls = check_extract_mi(torch, model, valid["feats_scp"], aux_scp,
                                               xv + ".scp", device)
    launches = check_launched("multi-input path (train_mi, bf16, fused pooling)", run,
                              ["masked_stats_pooling", "masked_stats_pooling_backward"])
    check_launched("multi-input path (extract_mi, float32)", ex, ["masked_stats_pooling"])
    shapes = {}
    for r in (run, ex):
        for name, counter in r["shapes"].items():
            shapes.setdefault(name, collections.Counter()).update(counter)
    for name, count in ex["launches"].items():
        launches[name] += count
    t0 = time.perf_counter()
    _mi_batch(train, {"bnf": bnf_egs}, MI.get("seed", 0), group=K)
    alone_s = time.perf_counter() - t0
    print("multi-input train step (%s): %d groups of %d bf16 steps [%d, %d-%d, 30 + %d]: %.3f "
          "ms a step in the last group (group times %s s, the first with start-up); the "
          "consumer's wait for each group %s s (%d loader threads; one worker alone yields its "
          "first group in %.3f s); group losses %s; valid line %s; extract_mi %d embeddings, "
          "the first %d at 1 - cosine %.3g of a CPU predict (<= %.3g); stage times %s s"
          % (CARD, len(groups), K, MI["num_speakers_per_batch"], MI["min_segment_len"],
             MI["max_segment_len"], BNF_DIM, 1e3 * groups[-1] / K, ["%.4f" % g for g in groups],
             ["%.4f" % w for w in waits], MI.get("num_parallel_datasets", 4), alone_s, losses,
             valid_lines[0], n_valid, MI_EXTRACT_CHECK, worst, 1.0 - EMB_MIN_COSINE,
             {k: round(v, 2) for k, v in stage_s.items()}))
    profile = profile_mi_group(torch, model, train, {"bnf": bnf_egs}, device)
    gaps = check_mi_step_against_cpu(torch, model, train, {"bnf": bnf_egs}, device)
    print("multi-input phase: %.2f s" % (time.perf_counter() - t_phase))
    summary = dict(profile, mi_last_group_step_ms=1e3 * groups[-1] / K, mi_group_s=groups,
                   mi_consumer_wait_s=waits, mi_one_worker_group_s=alone_s,
                   mi_stage_s=stage_s, mi_cm_reads_ms=bnf_reads,
                   mi_extract_one_minus_cosine=worst,
                   mi_extract_controls=extract_controls, **gaps)
    return launches, shapes, summary


# ---------------------------------------------------------------------------
# Phase 25: the Fisher recipe through the port
# ---------------------------------------------------------------------------
FISHER_SCRIPT = os.path.join(ROOT, "tf_kaldi_speaker_tpu_torch", "recipes", "fisher", "v1",
                             "run.sh")
# synthetic 8 kHz voices: 80 background speakers x 8 utterances (the
# shipped config draws 64 speakers a batch of chunks up to 400 frames, and
# filter_egs_dir keeps speakers with 5 utterances of 150 frames), and 10
# more speakers with 3 enrollment and 3 test utterances each; 7-9 s, about
# 440-570 voiced frames (a smoke choice: Fisher has about 12,000 speakers
# of 10-minute sides)
FISHER_CORPUS = dict(background=80, background_utts=8, eval_speakers=10, eval_utts=6,
                     min_seconds=7.0, max_seconds=9.0, seed=21)
# the recipe's cuts: the shipped config's epochs, steps, validation
# batches and cadences, as the VoxCeleb recipe phase; stage 2's validation
# split and stage 5's LDA width (80 background speakers)
FISHER_CUTS = dict(num_epochs=1, num_steps_per_epoch=16, valid_max_iterations=2,
                   save_checkpoints_steps=16, save_summary_steps=16, show_training_progress=8)
FISHER_ENV_CUTS = dict(valid_speakers="8", valid_utts="2", lda_dim="32")


def write_fisher_tree(root):
    """FISHER_CORPUS as $data_root/{train_background,enroll,test} (wav.scp,
    utt2spk) and test/trials ("enrollspk testutt target|nontarget");
    returns the data root and the seconds of audio."""
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_wav_data_dir

    c = FISHER_CORPUS
    made = make_wav_data_dir(os.path.join(root, "voices"), num_speakers=c["background"]
                             + c["eval_speakers"], utts_per_speaker=c["background_utts"],
                             min_seconds=c["min_seconds"], max_seconds=c["max_seconds"],
                             sample_rate=8000, seed=c["seed"])
    data = os.path.join(root, "data")
    with open(made["wav_scp"]) as f:
        wavs = dict(line.split(" ", 1) for line in f)
    sets = {"train_background": [], "enroll": [], "test": []}
    for s in range(c["background"] + c["eval_speakers"]):
        for u in range(c["background_utts"]):
            utt = "spk%03d_utt%03d" % (s, u)
            if s < c["background"]:
                sets["train_background"].append(utt)
            elif u < c["eval_utts"]:
                sets["enroll" if u < c["eval_utts"] // 2 else "test"].append(utt)
    for name, utts in sets.items():
        os.makedirs(os.path.join(data, name))
        with open(os.path.join(data, name, "wav.scp"), "w") as f:
            f.writelines("%s %s" % (u, wavs[u]) for u in utts)
        with open(os.path.join(data, name, "utt2spk"), "w") as f:
            f.writelines("%s %s\n" % (u, u.split("_")[0]) for u in utts)
    enroll_spks = sorted({u.split("_")[0] for u in sets["enroll"]})
    with open(os.path.join(data, "test", "trials"), "w") as f:
        for spk in enroll_spks:
            for utt in sets["test"]:
                f.write("%s %s %s\n" % (spk, utt, "target" if utt.startswith(spk + "_")
                                        else "nontarget"))
    return data, made["seconds"]


def run_cli_chain(root, device="cuda"):
    """The CLI work of phases 25, 29 and 26, in a thread beside phase 21
    (:class:`Beside`): the Fisher run.sh's stage 1, then from its output
    the Fisher stages 2-6 in this thread, and the SRE stages 2-8 and the
    multitask stages 2-5 in a thread each (stages 2+ of the Fisher script
    write nothing the other two read). Nothing here prints or runs the
    port in this process. Returns the three phases' records, for
    :func:`report_fisher`, :func:`report_sre` and :func:`report_multitask`."""
    t_phase = time.perf_counter()
    d, patched, env, seconds = setup_fisher_recipe(root, device)
    write_s = time.perf_counter() - t_phase
    stage_s, logs = run_stages(patched, env, [1], d)
    sre = Beside(sre_stages, root, device)
    mt = Beside(multitask_stages, root,
                os.path.join(env["data_root"], "train_background", "mfcc"), MT_CUTS, device)
    try:
        more_s, more_logs = run_stages(patched, env, range(2, 7), d)
    finally:
        sre.join()
        mt.join()
    stage_s.update(more_s)
    logs.update(more_logs)
    fisher = dict(env=env, seconds=seconds, write_s=write_s, stage_s=stage_s, logs=logs,
                  work_s=time.perf_counter() - t_phase)
    return fisher, sre.result(), mt.result()


def report_fisher(run):
    """Phase 25: the port's Fisher run.sh, stages 1-6 one at a time on the
    card (:func:`run_cli_chain`); its checks and lines. Returns the path's
    launches and shapes and a summary."""
    t0 = time.perf_counter()
    env, seconds, stage_s, logs = run["env"], run["seconds"], run["stage_s"], run["logs"]
    print("fisher recipe (%s): the port's run.sh, config cuts %s, variables %s; corpus %d + %d "
          "speakers, %.1f s of 8 kHz audio, written in %.2f s"
          % (CARD, FISHER_CUTS, FISHER_ENV_CUTS, FISHER_CORPUS["background"],
             FISHER_CORPUS["eval_speakers"], seconds, run["write_s"]))
    exp, launch_log = env["exp"], env["TFKS_LAUNCH_LOG"]
    for way in ("plda", "cosine"):
        path = os.path.join(exp, "scores_%s.txt" % way)
        with open(path) as f:
            if not f.read().splitlines():
                raise AssertionError("%s is empty" % path)
    eers = re.findall(r"EER[^0-9]*([0-9.]+)", logs[5] + logs[6])
    if len(eers) < 2:
        raise AssertionError("stages 5-6 reported EERs %s" % eers)
    launches, shapes, by_module, native = read_launch_log(launch_log)
    if by_module["train"]["cm_dequantize"] <= 0:
        raise AssertionError("fisher cli.train launched cm_dequantize %s times"
                             % by_module["train"]["cm_dequantize"])
    check_no_fallback("fisher recipe, cli.train", dict(native["train"]), "read_batch_codes")
    fallbacks = {m: c["fallback"] for m, c in native.items() if c.get("fallback")}
    if fallbacks:
        raise AssertionError("fisher recipe: numpy fallbacks by CLI %s" % fallbacks)
    check_launched("fisher recipe path (run.sh stages 1-6, every process)",
                   dict(launches=dict(launches), shapes=shapes), ["cm_dequantize"])
    print("fisher recipe kernel launches by CLI: %s" % json.dumps(
        {m: dict(c) for m, c in sorted(by_module.items()) if sum(c.values())}))
    print("fisher recipe stage times on the card (%s; each stage one bash run, every CLI its "
          "own interpreter): %s s; EERs %s; the phase %.2f s"
          % (CARD, {s: round(t, 2) for s, t in stage_s.items()}, eers,
             run["work_s"] + time.perf_counter() - t0))
    summary = dict(fisher_stage_s=stage_s, fisher_eers=eers, fisher_audio_s=seconds,
                   fisher_train_native=dict(native["train"]))
    return dict(launches), shapes, summary


def setup_fisher_recipe(root, device="cuda"):
    """The Fisher phase's corpus, its patched run.sh and the stages'
    environment under ``root``/fisher: (dir, script, env, seconds of
    audio)."""
    d = os.path.join(root, "fisher")
    os.makedirs(d)
    data, seconds = write_fisher_tree(d)
    runner = os.path.join(d, "launch_runner.py")
    with open(runner, "w") as f:
        f.write(LAUNCH_RUNNER)
    with open(FISHER_SCRIPT) as f:
        script = f.read()
    if 'py="python -m"' not in script:
        raise AssertionError("the Fisher run.sh no longer sets py")
    patched = os.path.join(d, "run.sh")
    with open(patched, "w") as f:
        f.write(script.replace('py="python -m"', 'py="%s %s"' % (sys.executable, runner)))
    with open(FISHER_CONF) as f:
        cfg_path = write_json(os.path.join(d, "fisher.json"), dict(json.load(f), **FISHER_CUTS))
    exp = os.path.join(d, "exp")
    launch_log = os.path.join(d, "launches.jsonl")
    env = dict(os.environ, data_root=data, exp=exp, device=device, config=cfg_path,
               model=os.path.join(exp, "xvector_fisher"), TFKS_LAUNCH_LOG=launch_log,
               **FISHER_ENV_CUTS)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TFKS_DISABLE_NATIVE", None)
    return d, patched, env, seconds


# ---------------------------------------------------------------------------
# Phase 26: the multitask recipe (recipes/fisher/v3_multitask through the port)
# ---------------------------------------------------------------------------
MT_SCRIPT = os.path.join(ROOT, "tf_kaldi_speaker_tpu_torch", "recipes", "fisher",
                         "v3_multitask", "run.sh")
MT_CONF = os.path.join(ROOT, "recipes", "fisher", "v3_multitask", "nnet_conf",
                       "mt_softmax.json")
# the shipped config at full width, cut in epochs, steps, validation
# batches and loader threads (8 in the config; 4 here, as the zoo phase)
MT_CUTS = dict(num_epochs=1, num_steps_per_epoch=16, valid_max_iterations=2,
               num_parallel_datasets=4)
# stage 2's validation split, cut on a patched copy (80 speakers)
MT_SCRIPT_CUTS = (("--valid-speakers 100 --valid-utts 4", "--valid-speakers 8 --valid-utts 2"),)
# the synthetic tri5a model: 667 phones of 3 states, 2001 pdfs (an
# assumption: the repo holds no Fisher tree; Kaldi's Fisher tri5a trees
# have some thousands of pdfs)
MT_PHONES = 667
MT_EXTRACT_CHECK = 4  # utterances held against a CPU predict
# card against CPU, float32 (TF32 off) from the trained state, each with a
# TF32-on and a bf16 control read against the same bound: the step's loss
# gap (MT_LOSS_GAP), the 1 - cosine of the step's speaker and phone
# embedding rows (MT_FORWARD_COSINE), its updates' 1 - cosine as the median
# over the parameters (MT_UPDATE_COSINE) and the largest of one parameter
# (MT_PARAM_COSINE); the x-vectors' 1 - cosine (EMB_MIN_COSINE) and the
# log-likelihoods' max |gap| over their spread (MT_LOGLIKE_GAP). Each
# bound sits between the sound check's largest reading on an H100 and the
# least reading of the controls it is to catch; ``--mt-step-spread`` reads
# the step's four over 8 trained states x 3 batches, and PERF.md section 6
# records them. The forward readings are continuous in the inputs and
# catch TF32; the gradient's are not: a ReLU input that lands on the
# other side of zero on the card moves the gradient by a jump, so one
# parameter's update reads 1 - cosine from 1e-8 to 2.4e-5 across trained
# states of a sound card (mostly the phone branch's BatchNorm scales and
# offsets, whose updates are sums that cancel), and the update bounds sit
# below bf16 only.
MT_LOSS_GAP = 5e-6
MT_FORWARD_COSINE = 1e-9
MT_UPDATE_COSINE = 1e-5
MT_PARAM_COSINE = 5e-4
MT_LOGLIKE_GAP = 1e-5
MT_CONTROLS = (("tf32", "float32", True), ("bf16", "bfloat16", False))
# (reading of read_mt_step, what it is, bound)
MT_STEP_BOUNDS = (
    ("loss_gap", "the weighted loss's relative gap", MT_LOSS_GAP),
    ("forward_one_minus_cosine", "the embeddings' 1 - min row cosine", MT_FORWARD_COSINE),
    ("update_one_minus_cosine", "the updates' median 1 - cosine", MT_UPDATE_COSINE),
    ("param_one_minus_cosine", "the largest 1 - cosine of one parameter's update",
     MT_PARAM_COSINE),
)


def write_mt_tree(root, mfcc_dir):
    """$data_root/fisher/mfcc from the Fisher phase's stage-1 output of the
    same options (its text files, its arks in place), and a synthetic Kaldi
    alignment dir frame-aligned with it; returns (data root, alignment dir,
    utt2num_frames)."""
    from tf_kaldi_speaker_tpu_torch.utils.testdata import write_kaldi_alignments

    data = os.path.join(root, "data")
    mfcc = os.path.join(data, "fisher", "mfcc")
    os.makedirs(mfcc)
    for name in ("feats.scp", "vad.scp", "utt2num_frames", "utt2spk", "spk2utt"):
        shutil.copyfile(os.path.join(mfcc_dir, name), os.path.join(mfcc, name))
    with open(os.path.join(mfcc, "utt2num_frames")) as f:
        frames = {u: int(n) for u, n in (line.split() for line in f)}
    ali_src = os.path.join(root, "tri5a_ali")
    if write_kaldi_alignments(ali_src, frames, MT_PHONES) != 3 * MT_PHONES:
        raise AssertionError("the synthetic transition model's pdf count")
    return data, ali_src, frames


def _mt_trainer_at(torch, model, device, compute_dtype):
    """A TrainerMultiTask in ``model``'s state (its last checkpoint)."""
    from tf_kaldi_speaker_tpu_torch.multitask import TrainerMultiTask
    from tf_kaldi_speaker_tpu_torch.utils.params import Params

    nnet = os.path.join(model, "nnet")
    params = Params(os.path.join(nnet, "config.json"))
    params.dict["compute_dtype"] = compute_dtype
    dims = {}
    for name in ("feature_dim", "num_speakers", "num_phones"):
        with open(os.path.join(nnet, name)) as f:
            dims[name] = int(f.read())
    t = TrainerMultiTask(params, nnet, dim=dims["feature_dim"], num_speakers=dims["num_speakers"],
                         num_phones=dims["num_phones"], device=device)
    t.build("train")
    t.load()
    return t


def mt_update_cosines(before, got, want):
    """1 - cosine of one parameter's update on the card (``got`` -
    ``before``) and the CPU's (``want`` - ``before``), in float64: the
    median over the parameters, and (name, reading) of the parameter where
    it is largest. The biases of the layers that a BatchNorm follows
    (``conv1``..``dense5``, ``dense6``, ``zs_dense``, the phone branch's
    and ``zp_dense``) are left out: their gradient is float32 noise around
    zero."""
    followed = re.compile(r"^(phn_)?(conv|dense)\d+$|^z[sp]_dense$")
    readings = {}
    for path, w in want.items():
        if path[0] != "params" or (path[-1] == "bias" and followed.match(path[-2])):
            continue
        b = before[path].double().ravel()
        du, dw = got[path].double().ravel() - b, w.double().ravel() - b
        uw, uu, ww = float(du @ dw), float(du @ du), float(dw @ dw)
        readings["/".join(path[1:])] = (1.0 - uw / np.sqrt(uu * ww) if uu * ww
                                        else float(uu != ww))
    worst = max(readings.items(), key=lambda kv: kv[1])
    return float(np.median(list(readings.values()))), worst


def _mt_batch(train_dir, ali_dir, cfg, seed, group=1):
    """One loader draw of the config's layout with its phone masks:
    (features, labels, ali, lengths, masks) host arrays, ``group``
    batches stacked when group > 1."""
    from tf_kaldi_speaker_tpu_torch.multitask import KaldiDataRandomQueueV2, make_phone_masks

    q = KaldiDataRandomQueueV2(
        train_dir, ali_dir, os.path.join(train_dir, "spklist"), cfg["phone_left_context"],
        cfg["phone_right_context"], num_parallel=1, max_qsize=1,
        num_speakers=cfg["num_speakers_per_batch"], min_len=cfg["min_segment_len"],
        max_len=cfg["max_segment_len"], seed=seed, group=group).start()
    try:
        feats, _vad, ali, length, labels, resample, _ = q.fetch()
    finally:
        q.stop()
    rng = np.random.RandomState(seed)
    k = cfg["num_frames_per_utt"]
    if group == 1:
        idx = make_phone_masks(length, resample, k, rng)
    else:
        idx = np.stack([make_phone_masks(length[g], resample[g], k, rng) for g in range(group)])
    return feats, labels, ali, length, idx


def _mt_step(torch, model, device, dtype, batch, lr, tf32=False):
    """One ``dtype`` multitask step on ``device`` from the trained state
    (TF32 on for cuDNN convolutions and matmuls when ``tf32``): the
    weighted loss, the parameters after it, and the rows of the step's
    speaker and phone embeddings (``mu_zs`` [B, d] over ``mu_zp_subset``
    [B*K, d], float64 on the host) that its forward computed."""
    from tf_kaldi_speaker_tpu_torch.convert import flatten, variables_of

    t = _mt_trainer_at(torch, model, device, dtype)
    cfg = t.params.dict
    rows = []
    hook = t.network_model.register_forward_hook(lambda module, args, out: rows.extend(
        out[1][k].detach().double().cpu() for k in ("mu_zs", "mu_zp_subset")))
    backends = torch.backends
    backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = tf32
    try:
        m = t.train_step(*(torch.from_numpy(a).to(device) for a in batch), lr)
        loss = (float(cfg.get("spk_loss_weight", 1.0)) * float(m["spk_loss"])
                + float(cfg.get("phn_loss_weight", 1.0)) * float(m["phn_loss"]))
    finally:
        backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
        hook.remove()
    return loss, flatten(variables_of(t.network_model)), torch.cat(rows)


def rows_one_minus_cosine(got, want):
    """The largest 1 - cosine of a row of ``got`` and the same row of
    ``want`` (float64 [N, d] tensors)."""
    cos = (got * want).sum(1) / (got.norm(dim=1) * want.norm(dim=1))
    return float(1.0 - cos.min())


def read_mt_step(torch, model, train_dir, ali_dir, device="cuda", seed=13):
    """One float32 multitask step on the card (TF32 off) and the
    MT_CONTROLS steps, each against the CPU's float32 step, from
    ``model``'s state on the loader batch drawn with ``seed``: the weighted
    loss's relative gap, the embedding rows' largest 1 - cosine and the
    updates' ``mt_update_cosines``. Returns (readings by name, the batch,
    the CPU's loss)."""
    from tf_kaldi_speaker_tpu_torch.convert import flatten, variables_of

    cpu = _mt_trainer_at(torch, model, "cpu", "float32")
    cfg, lr = cpu.params.dict, float(cpu.params.dict["learning_rate"])
    batch = _mt_batch(train_dir, ali_dir, cfg, seed)
    before = flatten(variables_of(cpu.network_model))
    loss_cpu, want, rows_cpu = _mt_step(torch, model, "cpu", "float32", batch, lr)
    readings = {}
    for name, dtype, tf32 in (("sound", "float32", False),) + MT_CONTROLS:
        loss, got, rows = _mt_step(torch, model, device, dtype, batch, lr, tf32)
        one_minus, (param, param_one_minus) = mt_update_cosines(before, got, want)
        readings[name] = dict(loss=loss, loss_gap=abs(loss - loss_cpu) / abs(loss_cpu),
                              forward_one_minus_cosine=rows_one_minus_cosine(rows, rows_cpu),
                              update_one_minus_cosine=one_minus, worst_param=param,
                              param_one_minus_cosine=param_one_minus)
    return readings, batch, loss_cpu


def check_mt_step_against_cpu(torch, model, train_dir, ali_dir, device="cuda"):
    """One float32 multitask step on the card (TF32 off) against the CPU's
    from the trained state on one loader batch, each reading of
    ``read_mt_step`` within its MT_STEP_BOUNDS bound; MT_CONTROLS read
    against the same CPU step and bounds (a control is caught when any
    reading passes its bound)."""
    readings, batch, loss_cpu = read_mt_step(torch, model, train_dir, ali_dir, device)
    r = readings["sound"]
    if not np.isfinite(r["loss"]):
        raise AssertionError("multitask step: card float32 loss %r" % r["loss"])
    for key, what, bound in MT_STEP_BOUNDS:
        if not r[key] <= bound:
            raise AssertionError("multitask step, card float32 vs CPU: %s %.3g > %g%s" % (
                what, r[key], bound,
                " (%s)" % r["worst_param"] if key == "param_one_minus_cosine" else ""))

    def show(reading, control):
        return "; ".join("%s %.3g (%s<= %g%s)" % (
            what, reading[key], "bound " if control else "", bound,
            (": caught" if reading[key] > bound else ": NOT caught") if control else "")
            for key, what, bound in MT_STEP_BOUNDS)

    print("one float32 multitask step %s (pdf labels %s, %d phone frames a row), card (TF32 "
          "off) vs CPU from the trained state: loss %r vs %r; %s; the largest of one parameter "
          "at %s ok" % (list(batch[0].shape), list(batch[2].shape), batch[4].shape[1], r["loss"],
                        loss_cpu, show(r, False), r["worst_param"]))
    for name in ("tf32", "bf16"):
        c = readings[name]
        caught = any(c[key] > bound for key, _, bound in MT_STEP_BOUNDS)
        print("control %s multitask step vs the CPU's: %s; the step %s" % (
            name, show(c, True), "caught" if caught else "NOT caught"))
    return dict(mt_cpu_loss_gap=r["loss_gap"],
                mt_cpu_forward_one_minus_cosine=r["forward_one_minus_cosine"],
                mt_cpu_update_one_minus_cosine=r["update_one_minus_cosine"],
                mt_cpu_param_one_minus_cosine=[r["worst_param"], r["param_one_minus_cosine"]],
                mt_step_controls={k: v for k, v in readings.items() if k != "sound"})


def profile_mt_group(torch, model, train_dir, ali_dir, device="cuda"):
    """One torch.profiler pass over a group of 8 float32 multitask steps
    (TF32 off) on a loader group already on the card, after the same 8 as
    warm-up: the step time, the device's busy and idle share and the top
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    t = _mt_trainer_at(torch, model, device, "float32")
    cfg, lr = t.params.dict, float(t.params.dict["learning_rate"])
    group = [torch.from_numpy(a).to(device) for a in _mt_batch(train_dir, ali_dir, cfg, 17, 8)]

    def steps():
        for k in range(8):
            t.train_step(*(a[k] for a in group), lr)

    steps()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_s, n_events, by_name = device_busy(torch, prof)
    if not n_events:
        print("profile: no device events in the trace; device idle share not measured")
        return {}
    print("profile (%s), 8 float32 multitask steps %s on the card (TF32 off) under "
          "torch.profiler: wall %.4f s (%.3f ms a step), device busy %.4f s, device idle "
          "%.1f%%, %d device events" % (CARD, list(group[0].shape[1:]), wall, 1e3 * wall / 8,
                                        busy_s, 100 * (1 - busy_s / wall), n_events))
    print_top(by_name, busy_s)
    return dict(mt_profile_step_ms=1e3 * wall / 8, mt_device_idle=1 - busy_s / wall)


def check_mt_outputs_against_cpu(torch, model, scp, prior_path, device="cuda"):
    """extract_mt and compute_loglike in this process on the card (TF32
    off) over ``scp``, held against a float32 CPU predict of the same
    checkpoint on the first MT_EXTRACT_CHECK utterances: 1 - cosine of the
    x-vectors <= 1 - EMB_MIN_COSINE, and the log-likelihoods' max |gap| over
    the CPU matrix's spread <= MT_LOGLIKE_GAP; so are stage 5's
    (``compute_loglike`` as run.sh runs it, a process of its own with
    TF32 as PyTorch leaves it until the CLI's set-up). The controls (a card
    predict with TF32 on, the checkpoint in bf16) are read against the same
    CPU outputs and bounds. Returns the readings and the two runs'
    launches.""" 
    from tf_kaldi_speaker_tpu_torch.cli import compute_loglike, extract_mt
    from tf_kaldi_speaker_tpu_torch.kio import read_mat_ark, read_mat_scp, read_vec_flt_ark

    out = os.path.dirname(prior_path)
    xv_ark, ll_ark = os.path.join(out, "check_xv.ark"), os.path.join(out, "check_ll.ark")
    runs = [drive(torch, extract_mt.main, ["--device", device, model, "scp:" + scp,
                                            "ark:" + xv_ark]),
            drive(torch, compute_loglike.main, ["--device", device, "--prior", prior_path, model,
                                                "scp:" + scp, "ark:" + ll_ark])]
    for r, name in zip(runs, ("extract_mt", "compute_loglike")):
        if r["rc"] != 0:
            raise RuntimeError("%s exited %d" % (name, r["rc"]))
    xv, ll = dict(read_vec_flt_ark(xv_ark)), dict(read_mat_ark(ll_ark))
    stage5 = dict(read_mat_ark(os.path.join(out, "loglike.ark")))
    with open(prior_path) as f:
        log_prior = np.log(np.array(f.read().strip("[] \n").split(), np.float64))[None, :]
    cpu = _mt_trainer_at(torch, model, "cpu", "float32")
    card = _mt_trainer_at(torch, model, device, "float32")
    # the checkpoint with every parameter and buffer in bf16
    bf16 = _mt_trainer_at(torch, model, device, "float32").network_model.to(
        torch.bfloat16).eval()
    worst = {k: dict(xv=0.0, ll=0.0) for k in ("sound", "tf32", "bf16")}
    stage5_gap = 0.0
    backends = torch.backends
    for _, (key, feats) in zip(range(MT_EXTRACT_CHECK), read_mat_scp(scp)):
        want_xv = cpu.predict_speaker(feats)
        want_ll = cpu.predict_phone(feats) - log_prior
        spread = float(want_ll.max() - want_ll.min())
        backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = (card.predict_speaker(feats), card.predict_phone(feats) - log_prior)
        finally:
            backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
        x = card._expand(feats[None]).to(torch.bfloat16)
        with torch.inference_mode():
            lengths = torch.full((1,), feats.shape[0], dtype=torch.int32, device=card.device)
            b_xv = bf16.predict_speaker(x, lengths).float().cpu().numpy()[0]
            b_ll = bf16.predict_phone(x).float().cpu().numpy()[0] - log_prior
        stage5_gap = max(stage5_gap, float(np.max(np.abs(stage5[key] - want_ll))) / spread)
        for name, (e, m) in (("sound", (xv[key], ll[key])), ("tf32", tf32), ("bf16", (b_xv, b_ll))):
            worst[name]["xv"] = max(worst[name]["xv"], 1.0 - cosine(e, want_xv))
            worst[name]["ll"] = max(worst[name]["ll"],
                                    float(np.max(np.abs(m - want_ll))) / spread)
    if not worst["sound"]["xv"] <= 1.0 - EMB_MIN_COSINE:
        raise AssertionError("extract_mt vs a CPU predict: 1 - min cosine %.3g > %.3g"
                             % (worst["sound"]["xv"], 1.0 - EMB_MIN_COSINE))
    if not worst["sound"]["ll"] <= MT_LOGLIKE_GAP:
        raise AssertionError("compute_loglike vs a CPU predict: max |gap| / spread %.3g > %g"
                             % (worst["sound"]["ll"], MT_LOGLIKE_GAP))
    if not stage5_gap <= MT_LOGLIKE_GAP:
        raise AssertionError("stage 5's compute_loglike (its own process) vs a CPU predict: "
                             "max |gap| / spread %.3g > %g" % (stage5_gap, MT_LOGLIKE_GAP))
    worst["stage5"] = dict(ll=stage5_gap)
    print("stage 5's compute_loglike (a process of its own, as run.sh runs it) vs the CPU "
          "predict of the first %d: log-likelihoods max |gap| over their spread %.3g (<= %g) ok"
          % (MT_EXTRACT_CHECK, stage5_gap, MT_LOGLIKE_GAP))
    print("extract_mt and compute_loglike on the card (TF32 off, %d utterances, %.3f and %.3f "
          "s in this process) vs a CPU predict of the first %d: x-vectors 1 - min cosine %.3g "
          "(<= %.3g), log-likelihoods max |gap| over their spread %.3g (<= %g) ok"
          % (len(xv), runs[0]["wall"], runs[1]["wall"], MT_EXTRACT_CHECK, worst["sound"]["xv"],
             1.0 - EMB_MIN_COSINE, worst["sound"]["ll"], MT_LOGLIKE_GAP))
    for name in ("tf32", "bf16"):
        w = worst[name]
        print("control %s vs the CPU predict: x-vectors 1 - min cosine %.3g (bound <= %.3g: %s); "
              "log-likelihoods max |gap| / spread %.3g (bound <= %g: %s)"
              % (name, w["xv"], 1.0 - EMB_MIN_COSINE,
                 "caught" if w["xv"] > 1.0 - EMB_MIN_COSINE else "NOT caught",
                 w["ll"], MT_LOGLIKE_GAP, "caught" if w["ll"] > MT_LOGLIKE_GAP else "NOT caught"))
    return worst, runs


def check_mt_recipe_outputs(exp, data, frames, logs, cfg):
    """What stages 3-5 wrote: a finite progress line and validation line,
    both egs counts, the x-vectors of every kept training utterance, and
    phone posteriors and log-likelihoods of every validation utterance with
    one column a pdf."""
    from tf_kaldi_speaker_tpu_torch.kio import read_mat_ark, read_vec_flt_scp

    num_pdfs = 3 * MT_PHONES
    model = os.path.join(exp, "mt_xvector")
    losses = [(float(a), float(b)) for a, b in re.findall(r"step \d+: spk ([-0-9.naninf]+) "
                                                          r"phn ([-0-9.naninf]+)", logs[3])]
    epoch = re.findall(r"epoch 1: spk ([-0-9.naninf]+) phn ([-0-9.naninf]+)", logs[3])
    if not losses or not epoch or not np.all(np.isfinite(losses + [tuple(map(float, epoch[0]))])):
        raise AssertionError("train_mt: progress losses %s, validation %s" % (losses, epoch))
    for name, n in (("speaker_egs", None), ("phone_egs", num_pdfs)):
        with open(os.path.join(model, name)) as f:
            counts = [int(line.split()[1]) for line in f]
        if (n is not None and len(counts) != n) or not sum(counts):
            raise AssertionError("%s: %d classes, %d egs" % (name, len(counts), sum(counts)))
    with open(os.path.join(data, "split", "train", "feats.scp")) as f:
        train_utts = [line.split()[0] for line in f]
    with open(os.path.join(data, "split", "valid", "feats.scp")) as f:
        valid_utts = [line.split()[0] for line in f]
    xv = dict(read_vec_flt_scp(os.path.join(exp, "xvectors_train.scp")))
    if sorted(xv) != sorted(train_utts) or not all(
            v.shape == (cfg["speaker_dim"],) and np.isfinite(v).all() for v in xv.values()):
        raise AssertionError("xvectors_train.scp: %d of %d utterances" % (len(xv),
                                                                          len(train_utts)))
    for name in ("phone_post.ark", "loglike.ark"):
        mats = dict(read_mat_ark(os.path.join(exp, name)))
        if sorted(mats) != sorted(valid_utts) or not all(
                m.shape == (frames[k], num_pdfs) and np.isfinite(m).all()
                for k, m in mats.items()):
            raise AssertionError("%s: %d matrices of %s" % (name, len(mats), sorted(
                {m.shape for m in mats.values()})))
    return dict(progress_losses=losses, valid_losses=[float(x) for x in epoch[0]],
                train_xvectors=len(xv), valid_matrices=len(valid_utts))


def run_multitask_recipe(torch, root, mfcc_dir, device="cuda"):
    """Phase 26 whole, in this thread: :func:`multitask_stages` then
    :func:`report_multitask`."""
    return report_multitask(torch, multitask_stages(root, mfcc_dir, MT_CUTS, device), device)


def multitask_stages(root, mfcc_dir, cuts, device="cuda"):
    """Phase 26's CLI work: its tree from the Fisher phase's stage-1 output
    ``mfcc_dir`` and the port's v3 multitask run.sh, stages 2-5 one at a
    time, on the card. Prints nothing (it runs in a thread in
    :func:`run_cli_chain`); returns what :func:`report_multitask` reads."""
    t_phase = time.perf_counter()
    d, patched, env, frames, cfg = setup_multitask_recipe(root, mfcc_dir, cuts, device)
    write_s = time.perf_counter() - t_phase
    stage_s, logs = run_stages(patched, env, range(2, 6), d)
    return dict(env=env, frames=frames, cfg=cfg, cuts=cuts, write_s=write_s, stage_s=stage_s,
                logs=logs, work_s=time.perf_counter() - t_phase)


def report_multitask(torch, run, device="cuda"):
    """Phase 26: the checks of what :func:`multitask_stages` wrote, then a
    profiled group, a card-vs-CPU step and the outputs against the CPU in
    this process. Returns the path's launches and a summary."""
    t0 = time.perf_counter()
    env, frames, cfg, stage_s, logs = (run[k] for k in ("env", "frames", "cfg", "stage_s",
                                                         "logs"))
    print("multitask recipe (%s): the port's v3 run.sh stages 2-5 on the Fisher phase's "
          "stage-1 output (%d utterances, %d-%d frames), config cuts %s, script %s; a synthetic "
          "tri5a model of %d pdfs, written in %.2f s"
          % (CARD, len(frames), min(frames.values()), max(frames.values()), run["cuts"],
             ["%s -> %s" % c for c in MT_SCRIPT_CUTS], 3 * MT_PHONES, run["write_s"]))
    data, exp, launch_log = env["data_root"], env["exp"], env["TFKS_LAUNCH_LOG"]
    outputs = check_mt_recipe_outputs(exp, data, frames, logs, cfg)
    launches, _, by_module, native = read_launch_log(launch_log)
    check_no_fallback("multitask recipe, cli.train_mt", dict(native["train_mt"]), "read_submat")
    fallbacks = {m: c["fallback"] for m, c in native.items() if c.get("fallback")}
    if fallbacks:
        raise AssertionError("multitask recipe: numpy fallbacks by CLI %s" % fallbacks)
    # the JAX multitask path pools with the two-pass moments and reads
    # floats: no dequant or pooling kernel; its BatchNorms train on theirs
    if any(c for n, c in launches.items() if not n.startswith("batch_norm_train")):
        raise AssertionError("the multitask path launched %s" % dict(launches))
    print("multitask recipe kernel launches (every process): %s; native reader counts by CLI: "
          "%s" % (json.dumps(dict(launches)), json.dumps({m: dict(c) for m, c in native.items()
                                                          if sum(c.values())})))
    model = os.path.join(exp, "mt_xvector")
    split = os.path.join(data, "split")
    ali_dir = os.path.join(data, "fisher_ali")
    profile = profile_mt_group(torch, model, os.path.join(split, "train"), ali_dir, device)
    gaps = check_mt_step_against_cpu(torch, model, os.path.join(split, "train"), ali_dir, device)
    worst, runs = check_mt_outputs_against_cpu(
        torch, model, os.path.join(split, "valid", "feats.scp"), os.path.join(exp, "prior.vec"),
        device)
    for r in runs:
        for name, count in r["launches"].items():
            launches[name] += count
    print("multitask recipe stage times on the card (%s; each stage one bash run, every CLI its "
          "own interpreter): %s s; progress losses %s, validation spk/phn %s; the phase %.2f s"
          % (CARD, {s: round(t, 2) for s, t in stage_s.items()}, outputs["progress_losses"],
             outputs["valid_losses"], run["work_s"] + time.perf_counter() - t0))
    summary = dict(profile, mt_stage_s=stage_s, mt_outputs=outputs,
                   mt_train_native=dict(native["train_mt"]),
                   mt_extract_one_minus_cosine=worst["sound"]["xv"],
                   mt_loglike_gap=worst["sound"]["ll"],
                   mt_stage5_loglike_gap=worst["stage5"]["ll"],
                   mt_output_controls={k: v for k, v in worst.items()
                                       if k not in ("sound", "stage5")}, **gaps)
    return dict(launches), summary


def setup_multitask_recipe(root, mfcc_dir, cuts, device="cuda"):
    """Phase 26's tree from ``mfcc_dir``, its patched run.sh, the config
    with ``cuts`` and the stages' environment under ``root``/multitask:
    (dir, script, env, utt2num_frames, config)."""
    d = os.path.join(root, "multitask")
    os.makedirs(d)
    data, ali_src, frames = write_mt_tree(d, mfcc_dir)
    runner = os.path.join(d, "launch_runner.py")
    with open(runner, "w") as f:
        f.write(LAUNCH_RUNNER)
    with open(MT_SCRIPT) as f:
        script = f.read()
    for old, new in MT_SCRIPT_CUTS + (('py="python -m"', 'py="%s %s"' % (sys.executable,
                                                                          runner)),):
        if old not in script:
            raise AssertionError("the multitask run.sh no longer holds %r" % old)
        script = script.replace(old, new)
    patched = os.path.join(d, "run.sh")
    with open(patched, "w") as f:
        f.write(script)
    with open(MT_CONF) as f:
        cfg = dict(json.load(f), **cuts)
    cfg_path = write_json(os.path.join(d, "mt.json"), cfg)
    exp = os.path.join(d, "exp")
    launch_log = os.path.join(d, "launches.jsonl")
    env = dict(os.environ, data_root=data, exp=exp, device=device, config=cfg_path,
               kaldi_ali_src=ali_src, TFKS_LAUNCH_LOG=launch_log)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TFKS_DISABLE_NATIVE", None)
    return d, patched, env, frames, cfg


def mt_step_spread(torch, root, mfcc_dir, seeds=tuple(range(8)), batches=(13, 14, 15),
                   device="cuda"):
    """``python3 chip_smoke.py --mt-step-spread``: the readings that
    check_mt_step_against_cpu's bounds sit between. For each config seed
    in ``seeds``, phase 26's stages 2-3 from ``mfcc_dir`` (the same cuts),
    then ``read_mt_step`` on the loader batches of ``batches``: one line a
    reading, then the largest sound reading and the least of each control
    for each bound. Checks nothing; returns the readings."""
    rows = []
    for seed in seeds:
        d, patched, env, _, _ = setup_multitask_recipe(
            os.path.join(root, "seed%d" % seed), mfcc_dir, dict(MT_CUTS, seed=seed), device)
        run_stages(patched, env, range(2, 4), d)
        model = os.path.join(env["exp"], "mt_xvector")
        train_dir = os.path.join(env["data_root"], "split", "train")
        ali_dir = os.path.join(env["data_root"], "fisher_ali")
        for batch in batches:
            readings, _, _ = read_mt_step(torch, model, train_dir, ali_dir, device, batch)
            rows.append(readings)
            print("mt step spread (%s), config seed %d, batch %d: %s" % (
                CARD, seed, batch, "; ".join(
                    "%s loss %.3g embeddings %.3g updates %.3g, %s %.3g" % (
                        name, r["loss_gap"], r["forward_one_minus_cosine"],
                        r["update_one_minus_cosine"], r["worst_param"],
                        r["param_one_minus_cosine"]) for name, r in readings.items())))
    for key, _, bound in MT_STEP_BOUNDS:
        print("mt step spread (%s), %d readings, %s: sound at most %.3g, TF32 at least %.3g, "
              "bf16 at least %.3g; bound %g" % (
                  CARD, len(rows), key, max(r["sound"][key] for r in rows),
                  min(r["tf32"][key] for r in rows), min(r["bf16"][key] for r in rows), bound))
    return rows


def mt_tiny_epoch(torch, data, nnet, cfg, device, dtype=None, tf32=False, starts_from=None,
                  nudge=0.0):
    """The multitask card test's epoch (``tests/torch_mt_tiny.py``: MT_TINY
    on MT_CORPUS, one loader worker) with ``cfg`` on ``device`` from
    ``data`` (data dir, alignment dir, spklist) into ``nnet``, through the
    test's ``train_epoch`` (in lockstep with ``starts_from``), in
    ``dtype`` where given, TF32 on for cuDNN and matmuls when ``tf32``,
    the initial parameters scaled by 1 + ``nudge`` x N(0, 1) where given:
    ``train_epoch``'s (losses, start states, variables after each step)."""
    from torch_mt_tiny import MT_CORPUS, train_epoch
    from tf_kaldi_speaker_tpu_torch.multitask import TrainerMultiTask
    from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain

    cfg = dict(cfg, compute_dtype=dtype) if dtype else cfg
    dims = dict(num_speakers=MT_CORPUS["num_speakers"], num_phones=MT_CORPUS["num_phones"])
    t = TrainerMultiTask(ParamsPlain(**cfg), nnet, dim=MT_CORPUS["dim"], device=device, **dims)
    t.build("train", MT_CORPUS["dim"], **dims)
    if nudge:
        g = torch.Generator().manual_seed(99)
        with torch.no_grad():
            for p in t.network_model.parameters():
                p.mul_(1 + nudge * torch.randn(p.shape, generator=g).to(p.device))
    backends = torch.backends
    backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = tf32
    try:
        return train_epoch(t, data, starts_from)
    finally:
        backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False


def allclose_excess(got, want, rtol, atol):
    """The largest |got - want| / (atol + rtol |want|) over every element of
    every variable (float64), and the variable where it is: the reading
    that ``np.testing.assert_allclose(got, want, rtol, atol)`` passes
    exactly when it is at most 1."""
    worst = (0.0, None)
    for path, w in want.items():
        w64 = w.double()
        r = float(((got[path].double() - w64).abs() / (atol + rtol * w64.abs())).max())
        worst = max(worst, (r, "/".join(path[1:])), key=lambda x: x[0])
    return worst


# --mt-epoch-spread's runs, each read against the CPU's epoch: (name, device,
# dtype, TF32, lockstep, nudge). Free-running: the card twice, its TF32 and
# bf16 controls, and a CPU run from initial weights nudged by 1e-8 relative
# (rounding's size). Lockstep (the card test's comparison): each step from
# the CPU step's start state.
MT_EPOCH_RUNS = (("sound", "cuda", None, False, False, 0.0),
                 ("again", "cuda", None, False, False, 0.0),
                 ("tf32", "cuda", None, True, False, 0.0),
                 ("bf16", "cuda", "bfloat16", False, False, 0.0),
                 ("cpu_nudged", "cpu", None, False, False, 1e-8),
                 ("lockstep", "cuda", None, False, True, 0.0),
                 ("lockstep_tf32", "cuda", None, True, True, 0.0),
                 ("lockstep_bf16", "cuda", "bfloat16", False, True, 0.0))


def mt_epoch_spread(torch, root, seeds=tuple(range(8)), runs=MT_EPOCH_RUNS):
    """``python3 chip_smoke.py --mt-epoch-spread``: what the multitask card
    test's comparison can tell apart. For each config seed, the test's
    epoch on the CPU and each of ``runs``, read against the CPU's: each
    step's loss gap, the first step's updates as ``mt_update_cosines``
    reads them (phase 26's one-step readings), and ``allclose_excess`` at
    the test's tolerance after each step; then, for each run, the largest
    excess over the epoch's steps, by seed. Checks nothing; returns the
    readings."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_mt_tiny import MT_CORPUS, MT_EPOCH_TOL, MT_TINY
    from tf_kaldi_speaker_tpu_torch.convert import flatten
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    rows = []
    for seed in seeds:
        seed_root = os.path.join(root, "seed%d" % seed)
        c = make_fake_data_dir(os.path.join(seed_root, "corpus"), **MT_CORPUS)
        data = (c["data"], c["ali_dir"], c["spklist"])
        cfg = dict(MT_TINY, seed=seed)
        cpu_losses, starts, cpu_after = mt_tiny_epoch(
            torch, data, os.path.join(seed_root, "cpu", "nnet"), cfg, "cpu")
        before = flatten(starts[0][0])
        row = {}
        for name, device, dtype, tf32, lockstep, nudge in runs:
            losses, _, after = mt_tiny_epoch(
                torch, data, os.path.join(seed_root, name, "nnet"), cfg, device, dtype, tf32,
                starts if lockstep else None, nudge)
            median, (param, worst) = mt_update_cosines(before, after[0], cpu_after[0])
            row[name] = dict(
                loss_gaps=[abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)],
                first_update_one_minus_cosine=median, first_param=[param, worst],
                excess=[allclose_excess(a, b, **MT_EPOCH_TOL) for a, b in zip(after, cpu_after)])
            print("mt epoch spread (%s), seed %d, %s vs CPU: loss gaps %s; first step's "
                  "updates median 1 - cos %.3g, largest %.3g (%s); excess over the test's "
                  "tolerance after each step %s" % (
                      CARD, seed, name, ["%.3g" % g for g in row[name]["loss_gaps"]], median,
                      worst, param, ["%.3g (%s)" % e for e in row[name]["excess"]]))
        rows.append(row)
    for name, *_ in runs:
        worst = [max(e for e, _ in r[name]["excess"]) for r in rows]
        print("mt epoch spread (%s), %d seeds, %s vs CPU: largest excess over the epoch's steps "
              "%s: min %.3g, max %.3g; first step's updates median 1 - cos at most %.3g, largest "
              "%.3g; loss gap at most %.3g" % (
                  CARD, len(rows), name, ["%.3g" % e for e in worst], min(worst), max(worst),
                  max(r[name]["first_update_one_minus_cosine"] for r in rows),
                  max(r[name]["first_param"][1] for r in rows),
                  max(max(r[name]["loss_gaps"]) for r in rows)))
    return rows


# ---------------------------------------------------------------------------
# Phase 27: multi-card training (parallel/) as two ranks on the one card
# ---------------------------------------------------------------------------
# NCCL refuses two ranks on one card, so the two ranks join over gloo, which
# runs its all-reduces on CUDA tensors through the host; the port builds
# every collective from all-reduces for that reason. The main path: the
# flagship at full width from the sharded device pool (one shard a rank),
# a 64-chunk global batch (32 a rank), one epoch of 16 steps in groups of 8.
DP_TRAIN = dict(TRAIN, num_epochs=1, valid_max_iterations=1, show_training_progress=8,
                stop_poll_groups=1)
DP_TIMEOUT = 300  # seconds for a collective, and for a rank process
DP_LENGTH = 296
# 2 ranks against 1 on the same global rows, float32 with TF32 off, from two
# states (the trained flagship and a fresh one of its config) x 3 pool
# batches; and model_parallel=2 on the 2 ranks against the same one-rank
# step. Readings: the loss's relative gap, the updates' median 1 - cosine
# over the parameters and the largest 1 - cosine of one parameter's update.
# Each bound sits between the sound readings on an H100 and a TF32-on and a
# bf16 one-rank control read against the same reference: ``--dp-spread``
# (4 states x 4 batches) read at most 1.69e-6, 5.7e-8 and 3.0e-7 sound,
# and at most 1.5e-4, 4.6e-4 and 9.1e-4 with TF32, 6.0e-3, 3.7e-3 and
# 6.4e-3 in bf16. The bounds keep 10x above the sound readings, and a
# parameter's update, which can jump where a ReLU input crosses zero
# (phase 26), 300x; a control is caught by any reading over its bound.
# PERF.md section 6 records the spread.
DP_LOSS_GAP = 2e-5
DP_UPDATE_COSINE = 5e-6
DP_PARAM_COSINE = 1e-4
DP_BOUNDS = (("loss_gap", "the loss's relative gap", DP_LOSS_GAP),
             ("update_one_minus_cosine", "the updates' median 1 - cosine", DP_UPDATE_COSINE),
             ("param_one_minus_cosine", "the largest 1 - cosine of one parameter's update",
              DP_PARAM_COSINE))
DP_CONTROLS = (("tf32", "float32", True), ("bf16", "bfloat16", False))
# sp_embed's frame axis split over the 2 ranks against the whole forward on
# the card, at the JAX package's tolerance (tests/test_sequence_parallel.py)
SP_FRAMES = (3000, 1111)
SP_TOL = dict(rtol=5e-3, atol=5e-4)


def _dp_trainer(torch, model, device, dtype, **overrides):
    """A Trainer in ``model``'s state, ``compute_dtype`` ``dtype``, the
    config's keys overridden."""
    from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
    from tf_kaldi_speaker_tpu_torch.utils.params import Params

    nnet = os.path.join(model, "nnet")
    params = Params(os.path.join(nnet, "config.json"))
    params.dict.update(overrides, compute_dtype=dtype)
    with open(os.path.join(nnet, "num_speakers")) as f:
        num_speakers = int(f.read())
    t = Trainer(params, nnet, dim=FEAT_DIM, num_speakers=num_speakers, device=device)
    t.build("train")
    t.load()
    return t


def _flat_state(t, params_only=True):
    """The train state (split arrays joined) as {path: CPU tensor}: the
    parameters only, or everything."""
    import torch

    from tf_kaldi_speaker_tpu_torch.convert import flatten

    return {"/".join(map(str, k)): v for k, v in flatten(t.state_tree()).items()
            if isinstance(v, torch.Tensor) and (k[0] == "params" or not params_only)}


def dp_readings(before, after, loss, want):
    """The three readings of one step against the one-rank reference
    ``want`` (its state after the step and its loss)."""
    cosines = []
    for path, w in want["after"].items():
        if not path.startswith("params/") or (
                path.endswith("/bias") and path.split("/")[-2].endswith(("_conv", "_dense"))):
            continue  # the biases a BatchNorm follows: float32 noise around zero
        b = before[path].double().ravel()
        du, dw = after[path].double().ravel() - b, w.double().ravel() - b
        cosines.append(1.0 - float(du @ dw / (du.norm() * dw.norm())))
    return dict(loss_gap=abs(loss - want["loss"]) / abs(want["loss"]),
                update_one_minus_cosine=float(np.median(cosines)),
                param_one_minus_cosine=float(max(cosines)))


def dp_step(torch, t, batch, rows):
    """One float32 step of ``t`` on ``rows`` of the raw pool batch; its
    loss."""
    codes, hdr, lab = (a.to(t.device) for a in batch)
    return float(t.train_step_raw(codes[rows], hdr[rows], lab[rows],
                                  DP_TRAIN["learning_rate"])["loss"])


def dp_rank_main(work):
    """One rank of phase 27 (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT from
    the parent): the main path, a profiled second epoch, the step readings
    against the one-rank references, model_parallel=2, sp_embed."""
    import hashlib
    import logging

    import torch
    import torch.distributed as dist

    from tf_kaldi_speaker_tpu_torch import parallel
    from tf_kaldi_speaker_tpu_torch.extract.extractor import Extractor
    from tf_kaldi_speaker_tpu_torch.ops import _build
    from tf_kaldi_speaker_tpu_torch.parallel.sequence_parallel import sp_embed
    from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer

    logging.basicConfig(level=logging.WARNING)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(work, "dp_spec.json")) as f:
        spec = json.load(f)
    on_card = spec["device"] == "cuda"
    dev = parallel.initialize("cuda:0" if on_card else "cpu", backend="gloo",
                              timeout_s=DP_TIMEOUT)
    rank, world = parallel.host_shard_info()
    assert world == 2 and dist.get_backend() == "gloo", (world, dist.get_backend())
    if on_card:
        _build.load()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {"rank": rank}

    # the main path: cli.train's epoch loop, one epoch of 16 steps
    wrappers = kernel_wrappers()
    t = _dp_trainer(torch, spec["main"], dev, "bfloat16", **{
        k: v for k, v in DP_TRAIN.items() if k in ("num_steps_per_epoch", "steps_per_dispatch",
                                                    "show_training_progress", "stop_poll_groups",
                                                    "device_pool")})
    assert t.mesh.data_size == 2
    marks, prof = [], {}
    post = Trainer._post_group

    def post_group(self, cfg, writer, metrics, K, local_group, t0, step0):
        sync()
        marks.append((step0, local_group, time.perf_counter(), float(metrics["loss"])))
        if prof.get("on") is not None and local_group == 0:
            prof["run"] = prof.pop("on")
            prof["run"].__enter__()
            prof["t0"] = time.perf_counter()
        elif prof.get("run") is not None and local_group == 1:
            prof["wall"] = time.perf_counter() - prof["t0"]
            prof["run"].__exit__(None, None, None)
            prof["done"] = prof.pop("run")
        post(self, cfg, writer, metrics, K, local_group, t0, step0)

    Trainer._post_group = post_group
    for fn in wrappers.values():
        fn.launches = 0
        fn.shapes.clear()
    t0 = time.perf_counter()
    t.train(spec["train"], spec["spklist"], DP_TRAIN["learning_rate"])
    sync()
    out["epoch_s"] = time.perf_counter() - t0
    out["launches"] = {n: fn.launches for n, fn in wrappers.items()}
    out["shapes"] = {n: [[list(s), d, c] for (s, d), c in fn.shapes.items()]
                     for n, fn in wrappers.items()}
    pool = t._device_pool
    out["pool"] = [pool.shard, pool.num_shards, len(pool.spk2utts), pool.cap_f]
    # a second epoch, its second group under torch.profiler
    from torch.profiler import ProfilerActivity, profile

    prof["on"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t.train(spec["train"], spec["spklist"], DP_TRAIN["learning_rate"])
    Trainer._post_group = post
    out["marks"] = marks
    busy_s, n_events, by_name = device_busy(torch, prof["done"])
    comm = [e for e in prof["done"].events() if e.device_type == torch.autograd.DeviceType.CPU
            and ("allreduce" in e.name or "all_reduce" in e.name)]
    out["profile"] = dict(wall_s=prof["wall"], busy_s=busy_s, n_events=n_events,
                          collective_host_s=1e-6 * busy_us(
                              [(e.time_range.start, e.time_range.end) for e in comm]),
                          collective_calls=len([e for e in comm if "c10d" in e.name]),
                          memcpy_s=1e-6 * sum(us for name, us in by_name.items()
                                              if "Memcpy" in name or "memcpy" in name),
                          top=by_name.most_common(8))
    digest = hashlib.sha256()
    for path, v in sorted(_flat_state(t, params_only=False).items()):
        digest.update(path.encode())
        digest.update(v.numpy().tobytes())
    out["digest"] = digest.hexdigest()
    out["final_loss"] = marks[-1][3]
    t.close()

    # 2 ranks (and model_parallel=2) against the one-rank float32 references
    out["readings"] = {"dp": [], "mp": []}
    for i, (model, batch_file, ref_file) in enumerate(spec["readings"]):
        batch = torch.load(batch_file)
        want = torch.load(ref_file)
        for kind, overrides, rows in (("dp", {}, slice(32 * rank, 32 * rank + 32)),
                                      ("mp", {"model_parallel": 2}, slice(None))):
            s = _dp_trainer(torch, model, dev, "float32", **overrides)
            before = _flat_state(s)
            loss = dp_step(torch, s, batch, rows)
            out["readings"][kind].append(dp_readings(before, _flat_state(s), loss, want))
            s.close()

    # sp_embed: one utterance's frames split over the ranks
    ex = Extractor(spec["sp_model"], device=dev)
    out["sp"] = [sp_embed(ex.net.tdnn, ex.params.dict, np.load(p), t.mesh, node=ex.node).tolist()
                 for p in spec["sp_feats"]]
    write_json(os.path.join(work, "dp_rank%d.json" % rank), out)
    parallel.shutdown()


def dp_cli_rank_main(argv):
    """One rank of ``cli.train`` on the one card over gloo (NCCL refuses
    two ranks on one card): the CLI as a launcher runs it, its join
    pointed at cuda:0 and gloo."""
    from tf_kaldi_speaker_tpu_torch import parallel
    from tf_kaldi_speaker_tpu_torch.cli import train as cli_train

    real = parallel.initialize
    parallel.initialize = lambda device: real("cpu" if device == "cpu" else "cuda:0",
                                              backend="gloo", timeout_s=DP_TIMEOUT)
    sys.exit(cli_train.main(argv))


def spawn_ranks(args, world=2):
    """``world`` processes of this script with the launcher's environment."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
               PYTHONUNBUFFERED="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__)] + args, cwd=ROOT,
                             env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]


def wait_ranks(procs, timeout=DP_TIMEOUT):
    """Each rank's (exit code, output); a rank still running at the
    deadline is killed and the phase fails."""
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
    except subprocess.TimeoutExpired:
        raise AssertionError("ranks still running after %d s" % timeout) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def dp_references(torch, root, trained, train, device="cuda", fresh_seeds=(0,), n_batches=3):
    """The one-rank float32 references (and controls) on the card: for each
    state (the trained one, and a fresh one of its config for each of
    ``fresh_seeds``) x ``n_batches`` pool batches, the state after one step
    and its loss; each control's readings against it. Returns the first
    fresh state's model dir too."""
    from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
    from tf_kaldi_speaker_tpu_torch.utils.params import Params

    states = [trained]
    for seed in fresh_seeds:
        fresh = os.path.join(root, "fresh%d" % seed)
        shutil.copytree(os.path.join(trained, "nnet"), os.path.join(fresh, "nnet"),
                        ignore=shutil.ignore_patterns("model-*", "checkpoint"))
        with open(os.path.join(fresh, "nnet", "num_speakers")) as f:
            num_speakers = int(f.read())
        cfg_path = os.path.join(fresh, "nnet", "config.json")
        with open(cfg_path) as f:
            write_json(cfg_path, dict(json.load(f), seed=seed))
        params = Params(cfg_path)
        t = Trainer(params, os.path.join(fresh, "nnet"), dim=FEAT_DIM,
                    num_speakers=num_speakers, device=device)
        t.build("train", FEAT_DIM, params.loss_func, num_speakers)
        t.save(0)
        states.append(fresh)
    readings, controls = [], {name: [] for name, _, _ in DP_CONTROLS}
    batches = _pool_group(torch, train, "cpu", n_batches, DP_LENGTH, 11)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for si, model in enumerate(states):
        for bi, batch in enumerate(batches):
            batch_file = os.path.join(root, "batch%d.pt" % bi)
            torch.save(batch, batch_file)
            s = _dp_trainer(torch, model, device, "float32")
            before = _flat_state(s)
            loss = dp_step(torch, s, batch, slice(None))
            ref = {"after": _flat_state(s), "loss": loss}
            ref_file = os.path.join(root, "ref%d_%d.pt" % (si, bi))
            torch.save(ref, ref_file)
            readings.append([model, batch_file, ref_file])
            for name, dtype, tf32 in DP_CONTROLS:
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
                c = _dp_trainer(torch, model, device, dtype)
                c_loss = dp_step(torch, c, batch, slice(None))
                controls[name].append(dp_readings(before, _flat_state(c), c_loss, ref))
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return states[1], readings, controls


def check_dp_bounds(what, readings, controls=None, on_card=True):
    """Each reading within its bound; each control over it, in one reading
    at least (the bound catches it; on the card, where the controls'
    precision differs)."""
    for key, text, bound in DP_BOUNDS:
        values = [r[key] for r in readings]
        print("  %s, %s: %s (bound %g)" % (what, text, ", ".join("%.3g" % v for v in values),
                                          bound))
        if not max(values) <= bound:
            raise AssertionError("%s: %s %.3g over its bound %g" % (what, text, max(values),
                                                                    bound))
    for name, runs in (controls or {}).items():
        caught = [key for key, _, bound in DP_BOUNDS if max(r[key] for r in runs) > bound]
        print("  the %s control: %s; caught by %s" % (name, "; ".join(
            "%s %s" % (key, ", ".join("%.3g" % r[key] for r in runs)) for key, _, _ in DP_BOUNDS),
            caught or "nothing"))
        if not caught and on_card:
            raise AssertionError("the %s control passes every bound of %s" % (name, what))


def run_torchrun_world_of_one(root, train, valid, device="cuda"):
    """cli.train under ``torchrun --nproc_per_node 1`` on the card: the
    process group joins with NCCL (its log line is asserted; gloo with
    ``--device cpu``), the trainer runs the one-card path, 8 steps and a
    validation."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    cfg = write_json(os.path.join(root, "torchrun.json"),
                     dict(TRAIN, num_epochs=1, num_steps_per_epoch=8, valid_max_iterations=1))
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node", "1",
         "--master_addr", "127.0.0.1", "--master_port", str(p), "-m",
         "tf_kaldi_speaker_tpu_torch.cli.train", "--config", cfg, "--device", device,
         train["data"], train["spklist"], valid["data"], valid["spklist"],
         os.path.join(root, "torchrun_exp")],
        cwd=ROOT, env=env, text=True, timeout=DP_TIMEOUT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    wall = time.perf_counter() - t0
    joined = ("process group up (nccl): rank 0/1 on cuda:0" if device == "cuda" else
              "process group up (gloo): rank 0/1 on cpu") in run.stdout
    if run.returncode != 0 or not joined or "epoch 1: valid loss" not in run.stdout:
        raise AssertionError("torchrun cli.train: exit %d, the join logged %s:\n%s"
                             % (run.returncode, joined, run.stdout[-4000:]))
    print("torchrun --nproc_per_node 1 cli.train (%s): joined over %s, 8 steps and a "
          "validation, exit 0 in %.1f s"
          % (CARD, "NCCL" if device == "cuda" else "gloo", wall))
    return wall


def run_dp_preemption(root, train, valid, device="cuda"):
    """cli.train as 2 ranks on the card (gloo): SIGTERM to rank 1 after rank
    0's first progress line; both must exit 75 within the same poll, with
    one checkpoint at a multiple of K = 8 and no validation line."""
    from tf_kaldi_speaker_tpu_torch.train.checkpoints import list_steps, read_pointer
    from tf_kaldi_speaker_tpu_torch.utils.bookkeeping import load_valid_loss

    n = 64
    cfg = write_json(os.path.join(root, "dp_preempt.json"),
                     dict(DP_TRAIN, num_steps_per_epoch=n))
    model = os.path.join(root, "dp_preempt")
    procs = spawn_ranks(["--dp-cli-rank", "--config", cfg, "--device", device, train["data"],
                         train["spklist"], valid["data"], valid["spklist"], model])
    lines = []
    try:
        for line in procs[0].stdout:
            lines.append(line)
            if "step " in line and ": loss" in line:
                break
        else:
            raise AssertionError("rank 0 exited before a progress line:\n" + "".join(lines))
        procs[1].send_signal(signal.SIGTERM)
        t_sig = time.perf_counter()
        results = wait_ranks(procs)
        t_exit = time.perf_counter()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    nnet = os.path.join(model, "nnet")
    step = read_pointer(nnet)
    codes = [rc for rc, _ in results]
    if codes != [75, 75]:
        raise AssertionError("SIGTERM to rank 1: exit codes %s, not [75, 75]:\n%s\n%s" % (
            codes, "".join(lines[-20:]) + results[0][1][-3000:], results[1][1][-3000:]))
    if list_steps(nnet) != [step] or not 0 < step < n or step % 8:
        raise AssertionError("checkpoints %s, not one at a multiple of 8 in (0, %d)"
                             % (list_steps(nnet), n))
    if load_valid_loss(os.path.join(nnet, "valid_loss")):
        raise AssertionError("the cut epoch recorded a validation")
    print("preemption on 2 ranks (%s): SIGTERM to rank 1 after rank 0's progress line -> both "
          "exit 75 %.2f s later, one checkpoint model-%d (a multiple of K = 8), no validation"
          % (CARD, t_exit - t_sig, step))
    return dict(dp_preempt_step=step, dp_preempt_exit_s=t_exit - t_sig)


def run_data_parallel(torch, root, trained, train, valid, device="cuda", fresh_seeds=(0,),
                      n_batches=3):
    """Phase 27 (the step readings from the trained state and
    ``fresh_seeds``' fresh ones x ``n_batches`` pool batches). Returns the
    launches by kernel (both ranks), their shapes and the phase's
    summary."""
    from tf_kaldi_speaker_tpu_torch.extract.extractor import Extractor

    t_phase = time.perf_counter()
    root = os.path.join(root, "dp")
    os.makedirs(root)
    fresh, readings, controls = dp_references(torch, root, trained, train, device,
                                              fresh_seeds, n_batches)
    sp_model = float32_model(trained, root)
    sp_feats = []
    for n in SP_FRAMES:
        path = os.path.join(root, "sp%d.npy" % n)
        np.save(path, np.random.RandomState(n).randn(n, FEAT_DIM).astype(np.float32))
        sp_feats.append(path)
    # the main path trains (and checkpoints) in a copy of the fresh state
    main = os.path.join(root, "main")
    shutil.copytree(fresh, main)
    write_json(os.path.join(root, "dp_spec.json"), dict(
        device=device, main=main, train=train["data"], spklist=train["spklist"],
        readings=readings, sp_model=sp_model, sp_feats=sp_feats))
    t_ranks = time.perf_counter()
    results = wait_ranks(spawn_ranks(["--dp-rank", root]))
    ranks_s = time.perf_counter() - t_ranks
    for r, (rc, text) in enumerate(results):
        if rc != 0:
            raise AssertionError("rank %d exited %d:\n%s" % (r, rc, text[-6000:]))
    outs = []
    for r in range(2):
        with open(os.path.join(root, "dp_rank%d.json" % r)) as f:
            outs.append(json.load(f))
    # (c) every rank launched every kernel on the main path
    launches, shapes = collections.Counter(), {}
    for o in outs:
        missing = [n for n, c in o["launches"].items() if not c]
        if missing and device == "cuda":
            raise AssertionError("rank %d launched no %s on the main path" % (o["rank"], missing))
        launches.update(o["launches"])
        for name, rows_ in o["shapes"].items():
            counter = shapes.setdefault(name, collections.Counter())
            for shape, dtype, count in rows_:
                counter[tuple(shape), dtype] += count
        print("rank %d: sharded pool shard %d of %d, %d speakers, %d frames; launches %s"
              % (o["rank"], *o["pool"][:3], o["pool"][3], o["launches"]))
    # (a) both ranks end bit-equal
    if outs[0]["digest"] != outs[1]["digest"]:
        raise AssertionError("the ranks' train states differ after the epoch")
    losses = [m[3] for m in outs[0]["marks"]]
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite group losses %s" % losses)
    # the unprofiled epoch's group times after its first (which holds the
    # pool's staging), per rank
    groups = [[b[2] - a[2] for a, b in zip(o["marks"], o["marks"][1:]) if a[0] == b[0] == 0]
              for o in outs]
    step_ms = 1e3 * float(np.median(groups[0])) / DP_TRAIN["steps_per_dispatch"]
    print("2 ranks on one card over gloo (%s): flagship bf16 from the sharded pool, global "
          "batch 64 (32 a rank) x %s frames; the ranks' states bit-equal (sha256 %s...); group "
          "losses %s; step %.3f ms (median of the later groups, %s s)"
          % (CARD, "200-400", outs[0]["digest"][:16], ["%.4f" % v for v in losses], step_ms,
             [["%.4f" % g for g in r] for r in groups]))
    prof = {}
    for o in outs:
        p = o["profile"]
        if not p["n_events"]:
            print("rank %d: no device events in the trace; idle share not measured" % o["rank"])
            continue
        idle = 1 - p["busy_s"] / p["wall_s"]
        share = p["collective_host_s"] / p["wall_s"]
        prof["rank%d" % o["rank"]] = dict(wall_s=p["wall_s"], device_idle=idle,
                                          collective_share=share, memcpy_s=p["memcpy_s"])
        print("rank %d profile (%s), 8 steps: wall %.4f s, device busy %.4f s (idle %.1f%%); "
              "all-reduce calls %d, their host spans %.4f s (%.1f%% of the wall: gloo runs them "
              "on the host, D2H and H2D copies around each), memcpy device time %.4f s"
              % (o["rank"], CARD, p["wall_s"], p["busy_s"], 100 * idle, p["collective_calls"],
                 p["collective_host_s"], 100 * share, p["memcpy_s"]))
        for name, us in p["top"]:
            print("  %8.3f ms  %s" % (us * 1e-3, name[:100]))
    # (b), (d): against the one-rank references, with the controls
    check_dp_bounds("2 ranks vs 1 rank", outs[0]["readings"]["dp"], controls, device == "cuda")
    check_dp_bounds("model_parallel=2 vs 1", outs[0]["readings"]["mp"])
    # (e) sp_embed against the whole forward on the card
    ex = Extractor(sp_model, device=device)
    sp_err = 0.0
    for i, path in enumerate(sp_feats):
        want = torch.from_numpy(ex.embed_utterance(np.load(path)))
        for o in outs:
            sp_err = max(sp_err, check_close("sp_embed rank %d [%d frames] vs the whole forward"
                                             % (o["rank"], SP_FRAMES[i]),
                                             torch.tensor(o["sp"][i]), want, **SP_TOL))
    # (f), (g)
    torchrun_s = run_torchrun_world_of_one(root, train, valid, device)
    preempt = run_dp_preemption(root, train, valid, device)
    summary = dict(step_ms=step_ms, ranks_s=ranks_s, epoch_s=[o["epoch_s"] for o in outs],
                   **prof, sp_max_abs_err=sp_err, torchrun_s=torchrun_s, **preempt,
                   dp_readings=outs[0]["readings"], controls=controls,
                   phase_s=time.perf_counter() - t_phase)
    print("data-parallel phase: %.1f s (the ranks' process %.1f s)"
          % (summary["phase_s"], ranks_s))
    return dict(launches), shapes, summary


# ---------------------------------------------------------------------------
# Phase 28: the ASR decode recipe (v3 run.sh stage 6 -> run_decode.sh)
# ---------------------------------------------------------------------------
DECODE_SCRIPT = os.path.join(ROOT, "tf_kaldi_speaker_tpu_torch", "recipes", "fisher",
                             "v3_multitask", "run_decode.sh")
DECODE_CALL = "bash tf_kaldi_speaker_tpu_torch/recipes/fisher/v3_multitask/run_decode.sh"
# The cut: stage 6 decodes the first DECODE_UTTS utterances of phase 26's
# validation split (16 utterances of 699-897 frames), whole
DECODE_UTTS = 2
# the Python oracle's cut: the first decoded utterance's first frames
DECODE_ORACLE_FRAMES = 40
# the decode's best-path cost from the card's log-likelihoods against the
# CPU's, relative (both decoded by the same native core, every utterance
# of the validation split at full length): set from 32 readings in two
# runs, sound 0 to 1.74e-7, the TF32-on control 2.06e-6 to 1.17e-4 (at most
# 5.62e-5 to 1.17e-4 a run); the control must exceed it in every run
DECODE_COST_GAP = 2e-6


def write_decode_graph(d, mdl):
    """A word-loop HCLG over the transition model ``mdl``: word w is phone
    w's 3-state chain (the shape tests/test_decoder.py builds: the arc into
    each state carries its forward transition-id, a self-loop its own),
    with the topology's transition costs (-ln 0.75 a self-loop, -ln 0.25 a
    forward) and a uniform unigram's ln 667 on each word's entry. Writes
    ``d/lang/graph/{HCLG.fst,words.txt}``, ``d/lang/final.mdl`` (where
    run_decode.sh looks) and a bigram ARPA over the words; returns (graph
    dir, ARPA path, tid2pdf)."""
    from tf_kaldi_speaker_tpu_torch.kio.fst import build_fst, write_fst
    from tf_kaldi_speaker_tpu_torch.kio.transition_model import read_transition_model

    tm = read_transition_model(mdl)
    lang = os.path.join(d, "lang")
    graph = os.path.join(lang, "graph")
    os.makedirs(graph)
    shutil.copyfile(mdl, os.path.join(lang, "final.mdl"))
    self_cost, fwd_cost, word_cost = -np.log(0.75), -np.log(0.25), np.log(MT_PHONES)
    arcs, state = [], 1
    for w in range(1, MT_PHONES + 1):
        prev = 0
        for st in range(3):
            self_tid = tm.state2id[(w - 1) * 3 + st + 1]
            arcs.append((prev, self_tid + 1, w if st == 0 else 0,
                         fwd_cost + (word_cost if st == 0 else 0.0), state))
            arcs.append((state, self_tid, 0, self_cost, state))
            prev, state = state, state + 1
        arcs.append((prev, 0, 0, 0.0, 0))
    write_fst(os.path.join(graph, "HCLG.fst"), build_fst(0, state, arcs, {0: 0.0}), "const")
    words = ["w%d" % w for w in range(1, MT_PHONES + 1)]
    with open(os.path.join(graph, "words.txt"), "w") as f:
        f.write("<eps> 0\n" + "".join("%s %d\n" % (w, i + 1) for i, w in enumerate(words)))
    # a small bigram: uniform unigrams with a backoff, each word's successor
    # favoured
    arpa = os.path.join(d, "lm_bigram.arpa")
    uni = np.log10(1.0 / (len(words) + 1))
    with open(arpa, "w") as f:
        f.write("\\data\\\nngram 1=%d\nngram 2=%d\n\n\\1-grams:\n" % (len(words) + 2, len(words)))
        f.write("-99\t<s>\t-0.30103\n%.5f\t</s>\n" % uni)
        f.writelines("%.5f\t%s\t-0.30103\n" % (uni, w) for w in words)
        f.write("\n\\2-grams:\n")
        f.writelines("-0.30103\t%s %s\n" % (w, words[(i + 1) % len(words)])
                     for i, w in enumerate(words))
        f.write("\n\\end\\\n")
    return graph, arpa, tm.tid2pdf[1:].astype(np.int32)


def write_decode_data(d, valid_dir):
    """``d/data/split/valid``: the first DECODE_UTTS utterances of
    ``valid_dir`` (float ark + scp) and reference transcripts; returns
    (data root, utt -> frames)."""
    from tf_kaldi_speaker_tpu_torch.kio import ArkScpWriter, read_mat_scp

    data = os.path.join(d, "data")
    dev = os.path.join(data, "split", "valid")
    os.makedirs(dev)
    frames = {}
    writer = ArkScpWriter("ark,scp:%s,%s" % (os.path.join(dev, "feats.ark"),
                                             os.path.join(dev, "feats.scp")), kind="mat")
    for _, (key, m) in zip(range(DECODE_UTTS), read_mat_scp(os.path.join(valid_dir,
                                                                         "feats.scp"))):
        writer.write(key, m)
        frames[key] = m.shape[0]
    writer.close()
    with open(os.path.join(dev, "text"), "w") as f:
        f.writelines("%s w1 w2\n" % k for k in frames)
    return data, frames


def check_decode_outputs(out, frames):
    """What tests/test_run_decode.py asserts of the recipe's outputs, and
    the rescored lattices."""
    from tf_kaldi_speaker_tpu_torch.backend.lattice import read_lattice_ark
    from tf_kaldi_speaker_tpu_torch.kio import read_mat_ark, read_vec_int_ark

    utts = set(frames)
    lls = dict(read_mat_ark(os.path.join(out, "loglike.ark")))
    if set(lls) != utts or not all(m.shape == (frames[k], 3 * MT_PHONES) and np.isfinite(m).all()
                                   for k, m in lls.items()):
        raise AssertionError("loglike.ark: %s" % {k: m.shape for k, m in lls.items()})
    words = dict(read_vec_int_ark(os.path.join(out, "words.ark")))
    if set(words) != utts or not all(np.all(v >= 1) and np.all(v <= MT_PHONES)
                                     for v in words.values()):
        raise AssertionError("words.ark: %s" % words)
    ali = dict(read_vec_int_ark(os.path.join(out, "ali.ark")))
    if any(len(ali[u]) != frames[u] for u in utts):
        raise AssertionError("ali.ark: not one transition-id a frame")
    with open(os.path.join(out, "text")) as f:
        if {line.split()[0] for line in f if line.strip()} != utts:
            raise AssertionError("text: the utterances differ")
    with open(os.path.join(out, "wer")) as f:
        wer_line = f.readline()
    if not wer_line.startswith("%WER"):
        raise AssertionError("wer: %r" % wer_line)
    for name in ("lat.txt", "lat_rescored.txt"):
        lats = dict(read_lattice_ark(os.path.join(out, name)))
        if set(lats) != utts:
            raise AssertionError("%s: %s" % (name, sorted(lats)))
        for u in utts:
            if len(lats[u].best_path(acoustic_scale=0.1)[1]) != frames[u]:
                raise AssertionError("%s %s: the best path's alignment" % (name, u))
    with open(os.path.join(out, "wer.best")) as f:
        best = f.read()
    if "best lmwt" not in best:
        raise AssertionError("wer.best: %r" % best[-400:])
    return wer_line.strip(), best.strip().splitlines()[-1]


def decode_arks(graph, tid2pdf, arks):
    """Each ark's utterances decoded by one native decoder (best path,
    run_decode.sh's acwt/beam, decode_faster's max-active): {ark: {utt:
    (words, cost)}}."""
    from tf_kaldi_speaker_tpu_torch.backend.decoder import WfstDecoder
    from tf_kaldi_speaker_tpu_torch.kio import read_mat_ark

    dec = WfstDecoder(graph, tid2pdf, acoustic_scale=0.1, beam=13.0, max_active=7000)
    out = {}
    for name, ark in arks.items():
        res = {k: dec.decode(m) for k, m in read_mat_ark(ark)}
        out[name] = {k: (list(r.words), r.cost) for k, r in res.items()}
    dec.close()
    return out


def run_decode_phase(torch, root, device="cuda"):
    """Phase 28: the port's v3 run.sh stage 6 (run_decode.sh) on the card
    from phase 26's model. Returns the path's launches and a summary."""
    from tf_kaldi_speaker_tpu_torch.backend import decoder
    from tf_kaldi_speaker_tpu_torch.cli import compute_loglike
    from tf_kaldi_speaker_tpu_torch.kio import native_decode, read_mat_ark
    from tf_kaldi_speaker_tpu_torch.kio.fst import read_fst

    t_phase = time.perf_counter()
    mt = os.path.join(root, "multitask")
    model = os.path.join(mt, "exp", "mt_xvector")
    d = os.path.join(root, "decode")
    os.makedirs(d)
    t0 = time.perf_counter()
    lib = native_decode.build(source=native_decode.WFST_SOURCE)
    build_s = time.perf_counter() - t0
    graph, arpa, tid2pdf = write_decode_graph(d, os.path.join(mt, "tri5a_ali", "final.mdl"))
    data, frames = write_decode_data(d, os.path.join(mt, "data", "split", "valid"))
    fst = read_fst(os.path.join(graph, "HCLG.fst"))
    print("decode (%s): the WFST core built by g++ in %.2f s -> %s; a word-loop HCLG of %d "
          "words, %d states, %d arcs over phase 26's %d-pdf transition model; stage 6 decodes "
          "phase 26's first %d validation utterances, whole: %s frames"
          % (CARD, build_s, os.path.relpath(lib, ROOT), MT_PHONES, fst.num_states, fst.num_arcs,
             3 * MT_PHONES, len(frames), sorted(frames.values())))
    runner = os.path.join(d, "launch_runner.py")
    with open(runner, "w") as f:
        f.write(LAUNCH_RUNNER)
    runner_py = ('py="python -m"', 'py="%s %s"' % (sys.executable, runner))
    with open(DECODE_SCRIPT) as f:
        text = f.read()
    decode_sh = os.path.join(d, "run_decode.sh")
    with open(decode_sh, "w") as f:
        f.write(text.replace(*runner_py))
    with open(MT_SCRIPT) as f:
        text = f.read()
    for old, new in (runner_py, (DECODE_CALL, "bash " + decode_sh)):
        if old not in text:
            raise AssertionError("the multitask run.sh no longer holds %r" % old)
        text = text.replace(old, new)
    patched = os.path.join(d, "run.sh")
    with open(patched, "w") as f:
        f.write(text)
    launch_log = os.path.join(d, "launches.jsonl")
    env = dict(os.environ, data_root=data, exp=os.path.join(d, "exp"), model=model,
               ali_dir=os.path.join(mt, "data", "fisher_ali"), graph_dir=graph, newarpa=arpa,
               device=device, TFKS_LAUNCH_LOG=launch_log)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TFKS_DISABLE_NATIVE", None)
    stage_s, logs = run_stages(patched, env, [6], d)
    out = os.path.join(model, "decode_valid")
    wer_line, best_line = check_decode_outputs(out, frames)

    records = {}
    with open(launch_log) as f:
        for line in f:
            rec = json.loads(line)
            records[rec["module"].rsplit(".", 1)[-1]] = rec
    launches = collections.Counter()
    for rec in records.values():
        launches.update(rec["launches"])
    if sum(launches.values()):
        raise AssertionError("the decode path launched %s" % dict(launches))
    counts = records["decode_faster"]["decoder"]
    if counts != {"native": len(frames)}:
        raise AssertionError("decode_faster decoded %s (want every one of %d natively)"
                             % (counts, len(frames)))
    walls = {m: rec["wall"] for m, rec in records.items()}
    spans = records["decode_faster"]["seconds"]
    n_frames = sum(frames.values())

    # the native best path against the port's Python oracle on a short cut
    lls = dict(read_mat_ark(os.path.join(out, "loglike.ark")))
    key = next(iter(frames))
    short = lls[key][:DECODE_ORACLE_FRAMES]
    dec = decoder.WfstDecoder(os.path.join(graph, "HCLG.fst"), tid2pdf, acoustic_scale=0.1,
                              beam=13.0, max_active=7000)
    t0 = time.perf_counter()
    want = decoder.decode_faster_py(fst, short, tid2pdf, acoustic_scale=0.1, beam=13.0,
                                    max_active=7000)
    oracle_s = time.perf_counter() - t0
    got = dec.decode(short)
    dec.close()
    if not (list(got.words) == list(want.words) and list(got.alignment) == list(want.alignment)
            and got.partial == want.partial
            and abs(got.cost - want.cost) <= 1e-3 * max(1.0, abs(want.cost))):
        raise AssertionError("native vs the Python oracle on %s[:%d]: %s vs %s"
                             % (key, DECODE_ORACLE_FRAMES, got, want))
    print("decode: native best path on %s's first %d frames equals the port's decode_faster_py "
          "(words %s, cost %.6f vs %.6f; the oracle %.2f s) ok"
          % (key, DECODE_ORACLE_FRAMES, list(want.words), got.cost, want.cost, oracle_s))

    # the card's log-likelihoods against the CPU's (and a TF32-on
    # control's) over the whole validation split, at full length
    prior = os.path.join(model, "prior.vec")
    scp = "scp:" + os.path.join(mt, "data", "split", "valid", "feats.scp")
    arks = {name: os.path.join(d, "loglike_%s.ark" % name) for name in ("card", "cpu", "tf32")}
    for name, dev in (("card", device), ("cpu", "cpu"), ("tf32", device)):
        with tf32_on(torch) if name == "tf32" else contextlib.nullcontext():
            r = drive(torch, compute_loglike.main, ["--device", dev, "--prior", prior, model, scp,
                                                    "ark:" + arks[name]])
        if r["rc"] != 0:
            raise RuntimeError("compute_loglike (%s) exited %d" % (name, r["rc"]))
    decoded = decode_arks(os.path.join(graph, "HCLG.fst"), tid2pdf, arks)
    readings = {}
    for name in ("card", "tf32"):
        gaps = [abs(decoded[name][k][1] - c) / abs(c) for k, (_, c) in decoded["cpu"].items()]
        same = sum(decoded[name][k][0] == w for k, (w, _) in decoded["cpu"].items())
        readings[name] = dict(cost_gaps=gaps, words_agree=same / len(gaps))
    sound, tf32 = readings["card"], readings["tf32"]
    n_utts = len(sound["cost_gaps"])
    print("decode of the card's log-likelihoods vs the CPU's (%s; one native decoder, %d "
          "utterances at full length): words agree on %.0f%%, relative best-path cost gaps %s "
          "(bound %g); control tf32: words agree on %.0f%%, gaps %s"
          % (CARD, n_utts, 100 * sound["words_agree"], ["%.3g" % g for g in sound["cost_gaps"]],
             DECODE_COST_GAP, 100 * tf32["words_agree"], ["%.3g" % g for g in tf32["cost_gaps"]]))
    if not max(sound["cost_gaps"]) <= DECODE_COST_GAP:
        raise AssertionError("decode of the card's log-likelihoods vs the CPU's: relative "
                             "best-path cost gaps up to %g > %g"
                             % (max(sound["cost_gaps"]), DECODE_COST_GAP))
    if device != "cpu" and not max(tf32["cost_gaps"]) > DECODE_COST_GAP:
        raise AssertionError("the TF32-on control's relative best-path cost gaps, at most %g, "
                             "sit within the bound %g: the bound does not catch TF32"
                             % (max(tf32["cost_gaps"]), DECODE_COST_GAP))

    lat_s, det_s = spans["decode_lattice"], spans["determinize_lattice"]
    times = dict(stage6_s=stage_s[6], decode_faster_s=walls["decode_faster"], frames=n_frames,
                 lattice_s=lat_s, determinize_s=det_s, frames_per_s=n_frames / lat_s,
                 frames_per_s_determinized=n_frames / (lat_s + det_s),
                 determinize_share=det_s / (lat_s + det_s), lmrescore_s=walls["lmrescore"],
                 sweep_s=walls["lattice_best_path"], compute_loglike_s=walls["compute_loglike"],
                 wfst_build_s=build_s, oracle_s=oracle_s)
    print("decode stage times (%s): stage 6 %.2f s; decode_faster %.2f s (its process); in it, "
          "%d frames' lattice decode (the native search and the lattice) %.2f s = %.1f frames/s, "
          "their determinization %.2f s (%.1f%% of the two; %.1f frames/s with it); lmrescore "
          "%.2f s; the lattice_best_path sweep %.2f s; compute_loglike %.2f s; %s; %s; the phase "
          "%.2f s"
          % (CARD, stage_s[6], walls["decode_faster"], n_frames, lat_s, times["frames_per_s"],
             det_s, 100 * times["determinize_share"], times["frames_per_s_determinized"],
             walls["lmrescore"], walls["lattice_best_path"], walls["compute_loglike"], wer_line,
             best_line, time.perf_counter() - t_phase))
    summary = dict(decode_times=times, decode_decoder_counts=counts, decode_wer=wer_line,
                   decode_best=best_line, decode_card_vs_cpu=sound, decode_tf32_control=tf32)
    return dict(launches), summary


# ---------------------------------------------------------------------------
# Phase 29: the SRE recipe (tf_kaldi_speaker_tpu_torch/recipes/sre/v1/run.sh)
# ---------------------------------------------------------------------------
SRE_SCRIPT = os.path.join(ROOT, "tf_kaldi_speaker_tpu_torch", "recipes", "sre", "v1", "run.sh")
SRE_CONF = os.path.join(ROOT, "recipes", "sre", "v1", "nnet_conf", "tdnn_amsoftmax_m0.15.json")
# the shipped config at full width, cut as the Fisher phase cuts its own
SRE_CUTS = dict(FISHER_CUTS, num_parallel_datasets=4)
# swbd_sre: each background speaker's first 3 utterances (stage 5's
# extraction of all 8 took 83.9 s); the stages start at 2 from the Fisher
# phase's stage 1, as phase 26's do (the SRE stage 1, 12 interpreters,
# took 99.9 s)
SRE_TRAIN_UTTS = 3
# tests/test_torch_sre_recipe.py's cuts of the script (80 training speakers)
SRE_SCRIPT_CUTS = (("--min-len 200 --min-num-utts 8", "--min-len 30 --min-num-utts 2"),
                   ("--valid-speakers 200 --valid-utts 5", "--valid-speakers 2 --valid-utts 2"),
                   ("--lda-dim 150", "--lda-dim 8"))


def write_sre_tree(root, fisher_data):
    """The SRE data dirs from the Fisher phase's 8 kHz corpus and its
    stage-1 output (the SRE recipe's stage 1 runs make_mfcc and compute_vad
    with the same options): each set's wav.scp and utt2spk, and in its
    mfcc/ the Fisher MFCC's feats.scp, vad.scp, utt2num_frames, utt2spk
    and spk2utt rows of its utterances (the arks in place). swbd_sre: the
    80 background speakers' first SRE_TRAIN_UTTS utterances; sre16_major
    (unlabelled, for the adaptation): the next utterance of 20 of them;
    sre10_{enroll,test} and sre16_{enroll,test}: the 10 evaluation
    speakers' 3 + 3 utterances and their trials, sre16_test's split by the
    test speaker into tgl (the first 5) and yue. Returns the data root and
    the trial counts."""
    data = os.path.join(root, "data")

    def rows(name, fname):
        with open(os.path.join(fisher_data, name, *fname)) as f:
            return {line.split()[0]: line for line in f}

    def write_set(name, src, utts):
        wavs = rows(src, ["wav.scp"])
        mfcc = os.path.join(data, name, "mfcc")
        os.makedirs(mfcc)
        with open(os.path.join(data, name, "wav.scp"), "w") as f:
            f.writelines(wavs[u] for u in utts)
        for fname in ("feats.scp", "vad.scp", "utt2num_frames", "utt2spk"):
            table = rows(src, ["mfcc", fname])
            with open(os.path.join(mfcc, fname), "w") as f:
                f.writelines(table[u] for u in utts)
        shutil.copyfile(os.path.join(mfcc, "utt2spk"), os.path.join(data, name, "utt2spk"))
        spk2utt = collections.OrderedDict()
        for u in utts:
            spk2utt.setdefault(u.split("_")[0], []).append(u)
        with open(os.path.join(mfcc, "spk2utt"), "w") as f:
            f.writelines("%s %s\n" % (spk, " ".join(us)) for spk, us in spk2utt.items())

    background = sorted(rows("train_background", ["wav.scp"]))
    write_set("swbd_sre", "train_background",
              [u for u in background if int(u.split("_utt")[1]) < SRE_TRAIN_UTTS])
    write_set("sre16_major", "train_background",
              [u for u in background if int(u.split("_utt")[1]) == SRE_TRAIN_UTTS][:20])
    enroll, test = sorted(rows("enroll", ["wav.scp"])), sorted(rows("test", ["wav.scp"]))
    with open(os.path.join(fisher_data, "test", "trials")) as f:
        trials = f.readlines()
    eval_spks = sorted({u.split("_")[0] for u in enroll})
    tgl = set(eval_spks[:len(eval_spks) // 2])
    for corpus in ("sre10", "sre16"):
        write_set(corpus + "_enroll", "enroll", enroll)
        write_set(corpus + "_test", "test", test)
        with open(os.path.join(data, corpus + "_test", "trials"), "w") as f:
            f.writelines(trials)
    for lang, keep in (("tgl", lambda spk: spk in tgl), ("yue", lambda spk: spk not in tgl)):
        with open(os.path.join(data, "sre16_test", "trials_" + lang), "w") as f:
            f.writelines(t for t in trials if keep(t.split()[1].split("_")[0]))
    return data, dict(trials=len(trials), tgl=sum(t.split()[1].split("_")[0] in tgl
                                                  for t in trials))


def check_sre_outputs(exp, logs, counts):
    """What tests/test_torch_sre_recipe.py asserts of the recipe's outputs."""
    out = "".join(logs.values())
    if "SKIPPING augmentation" not in logs[2]:
        raise AssertionError("stage 2 did not skip the augmentation")
    for name in ("scores_sre10.txt", "scores_sre16.txt"):
        if not os.path.getsize(os.path.join(exp, name)):
            raise AssertionError("%s is empty" % name)
    if "[tgl]" not in out or "[yue]" not in out:
        raise AssertionError("stage 7 reported no per-language split")
    for lang, n in (("tgl", counts["tgl"]), ("yue", counts["trials"] - counts["tgl"])):
        with open(os.path.join(exp, "scores_sre16.txt." + lang)) as f:
            if len(f.read().splitlines()) != n:
                raise AssertionError("scores_sre16.txt.%s: not %d lines" % (lang, n))
    with open(os.path.join(exp, "scores_sre16_cal.txt")) as f:
        if len(f.read().splitlines()) != counts["trials"] or "calibration: llr =" not in out:
            raise AssertionError("stage 8's calibrated scores")
    m = re.search(r"eval Cllr raw-as-llr: ([\d.]+)\s+minCllr: ([\d.]+)\s+"
                  r"Cllr calibrated: ([\d.]+)", out)
    if not m:
        raise AssertionError("stage 8 reported no Cllr")
    cllr_raw, min_cllr, cllr_cal = map(float, m.groups())
    dcfs = [tuple(map(float, x)) for x in re.findall(
        r"p_target=\S+ c_miss=\S+ c_fa=\S+: minDCF ([\d.]+)\s+actDCF ([\d.]+)", out)]
    if not (np.isfinite([cllr_raw, min_cllr, cllr_cal]).all() and cllr_raw >= min_cllr - 1e-6
            and cllr_cal >= min_cllr - 1e-6 and len(dcfs) == 2
            and all(np.isfinite(a) and a >= mn - 1e-6 for mn, a in dcfs)):
        raise AssertionError("stage 8: Cllr %s, DCFs %s" % (m.groups(), dcfs))
    eers = re.findall(r"EER[^0-9]*([0-9.]+)", logs[6] + logs[7])
    return dict(cllr_raw=cllr_raw, min_cllr=min_cllr, cllr_calibrated=cllr_cal, dcfs=dcfs,
                eers=eers)


def sre_stages(root, device="cuda"):
    """Phase 29's CLI work: the SRE data dirs from the Fisher phase's
    stage-1 output and the port's SRE run.sh, stages 2-8 one at a time, on
    the card. Prints nothing (it runs in a thread in :func:`run_cli_chain`);
    returns what :func:`report_sre` reads."""
    t_phase = time.perf_counter()
    d = os.path.join(root, "sre")
    os.makedirs(d)
    data, counts = write_sre_tree(d, os.path.join(root, "fisher", "data"))
    runner = os.path.join(d, "launch_runner.py")
    with open(runner, "w") as f:
        f.write(LAUNCH_RUNNER)
    with open(SRE_SCRIPT) as f:
        script = f.read()
    for old, new in SRE_SCRIPT_CUTS + (('py="python -m"', 'py="%s %s"' % (sys.executable,
                                                                          runner)),):
        if old not in script:
            raise AssertionError("the SRE run.sh no longer holds %r" % old)
        script = script.replace(old, new)
    patched = os.path.join(d, "run.sh")
    with open(patched, "w") as f:
        f.write(script)
    with open(SRE_CONF) as f:
        cfg_path = write_json(os.path.join(d, "sre.json"), dict(json.load(f), **SRE_CUTS))
    exp = os.path.join(d, "exp")
    launch_log = os.path.join(d, "launches.jsonl")
    env = dict(os.environ, data_root=data, exp=exp, device=device, config=cfg_path,
               TFKS_LAUNCH_LOG=launch_log)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TFKS_DISABLE_NATIVE", None)
    stage_s, logs = run_stages(patched, env, range(2, 9), d, may_skip=(2,))
    return dict(exp=exp, launch_log=launch_log, counts=counts, stage_s=stage_s, logs=logs,
                work_s=time.perf_counter() - t_phase)


def report_sre(run):
    """Phase 29: the checks of what :func:`sre_stages` wrote, and its lines.
    Returns the path's launches and shapes and a summary."""
    t0 = time.perf_counter()
    exp, counts, stage_s, logs = run["exp"], run["counts"], run["stage_s"], run["logs"]
    c = FISHER_CORPUS
    print("sre recipe (%s): the port's run.sh stages 2-8 from the Fisher phase's stage-1 output "
          "(swbd_sre %d x %d, SRE10/SRE16 %d speakers' %d + %d utterances, %d trials, "
          "sre16_major 20), config cuts %s, script %s"
          % (CARD, c["background"], SRE_TRAIN_UTTS, c["eval_speakers"],
             c["eval_utts"] // 2, c["eval_utts"] // 2, counts["trials"], SRE_CUTS,
             ["%s -> %s" % cut for cut in SRE_SCRIPT_CUTS]))
    outputs = check_sre_outputs(exp, logs, counts)
    launches, shapes, by_module, native = read_launch_log(run["launch_log"])
    if by_module["train"]["cm_dequantize"] <= 0:
        raise AssertionError("sre cli.train launched cm_dequantize %s times"
                             % by_module["train"]["cm_dequantize"])
    fallbacks = {m: c["fallback"] for m, c in native.items() if c.get("fallback")}
    if fallbacks:
        raise AssertionError("sre recipe: numpy fallbacks by CLI %s" % fallbacks)
    check_launched("sre recipe path (run.sh stages 2-8, every process)",
                   dict(launches=dict(launches), shapes=shapes), ["cm_dequantize"])
    print("sre recipe kernel launches by CLI: %s" % json.dumps(
        {m: dict(c) for m, c in sorted(by_module.items()) if sum(c.values())}))
    print("sre recipe stage times on the card (%s; each stage one bash run, every CLI its own "
          "interpreter): %s s; EERs %s; Cllr raw %.4f, min %.4f, calibrated %.4f; the phase "
          "%.2f s" % (CARD, {s: round(t, 2) for s, t in stage_s.items()}, outputs["eers"],
                      outputs["cllr_raw"], outputs["min_cllr"], outputs["cllr_calibrated"],
                      run["work_s"] + time.perf_counter() - t0))
    return dict(launches), shapes, dict(sre_stage_s=stage_s, sre_outputs=outputs)


# Phase 30, TF interop: the golden config of tests/test_tf_golden.py (its
# CFG, copied: this script may not import tests/), the checkpoints real TF
# 2.21 wrote and the endpoints it computed, held at that test's tolerance
GOLDEN_DIR = os.path.join(ROOT, "tests", "data", "tf_golden")
GOLDEN_CFG = dict(
    seed=0,
    network_type="tdnn",
    tdnn_layer_size=32,
    num_nodes_pooling_layer=64,
    num_nodes_last_layer=32,
    pooling_type="statistics_pooling",
    embedding_node="tdnn6_dense",
    last_layer_linear=True,
    loss_func="additive_margin_softmax",
    amsoftmax_m=0.2,
    amsoftmax_lambda_min=0.0,
    amsoftmax_lambda_base=1000.0,
    amsoftmax_lambda_gamma=1e-4,
    amsoftmax_lambda_power=5.0,
    batchnorm_momentum=0.95,
    optimizer="sgd",
    weight_l2_regularizer=0.0,
)
GOLDEN_TOL = dict(rtol=1e-4, atol=1e-4)
# checkpoint -> (TF's outputs, [(the port's endpoint, TF's name)])
GOLDEN_FORWARDS = {
    "model-0": ("golden.npz", [(n, n) for n in (
        "tdnn1_conv", "tdnn1_bn", "tdnn2_conv", "tdnn3_conv", "tdnn4_dense", "tdnn5_dense",
        "pooling", "tdnn6_dense", "tdnn6_bn", "tdnn7_dense", "tdnn7_bn", "logits")]),
    "export/model-3": ("golden_export.npz", [("tdnn6_dense", "embedding"), ("pooling", "pooling"),
                                             ("logits", "logits")]),
}
# an extraction from the imported dir against one from the original: the
# same weights bit for bit, so byte-equal arks are expected; else each
# embedding within this 1 - cosine
INTEROP_COSINE_GAP = 1e-6
# Phase 31: utterances of phase 5's ark over MULTI_CHUNK frames after the
# host VAD go through the 50%-overlap long path (the feature path); those
# over it before (raw codes) are left out of the pipe
MULTI_CHUNK = 600
# 1 - cosine of the row blocks against one device: float32, the split, pad
# and merge code alone; bf16, also the rounding of products at another row
# count, the server's bound (phase 8; 1.58e-6 read in one run, PERF.md §6)
MULTI_COSINE_GAP = {"f32": 1e-6, "bf16": 1e-3}


def read_tf_prefix(directory):
    """The prefix of the one TensorBundle checkpoint in ``directory``."""
    found = glob.glob(os.path.join(directory, "model-*.index"))
    if len(found) != 1:
        raise AssertionError("%s holds %d checkpoints, not 1" % (directory, len(found)))
    return found[0][:-len(".index")]


def same_trees(a, b):
    """Two checkpoint trees' params and batch_stats, bit for bit."""
    from tf_kaldi_speaker_tpu_torch.convert import flatten

    fa = flatten({k: a[k] for k in ("params", "batch_stats")})
    fb = flatten({k: b[k] for k in ("params", "batch_stats")})
    return sorted(fa) == sorted(fb) and all(
        fa[k].dtype == fb[k].dtype and bool((fa[k] == fb[k]).all()) for k in fa)


def compare_embeddings(name, got, want, gap):
    """Two [(key, embedding)] lists: the keys in the same order; byte-equal,
    or every 1 - cosine <= gap. Returns (byte_equal, the largest 1 - cosine)."""
    if [k for k, _ in got] != [k for k, _ in want]:
        raise AssertionError("%s: the keys or their order differ" % name)
    equal = all(g.dtype == w.dtype and g.tobytes() == w.tobytes() for (_, g), (_, w) in
                zip(got, want))
    worst = max(1.0 - cosine(g, w) for (_, g), (_, w) in zip(got, want))
    if not equal and not worst <= gap:
        raise AssertionError("%s: 1 - cosine %.3g > %g" % (name, worst, gap))
    return equal, worst


def check_golden(torch, root, device="cuda"):
    """tests/data/tf_golden's model-0 (TF's variables) and export/model-3
    (this framework's export, restored by a real TF Saver) imported on the
    card; the float32 eval forward against TF's endpoints and losses.
    Returns the largest error over the endpoints."""
    from tf_kaldi_speaker_tpu_torch.train.tf_import import import_reference_checkpoint
    from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
    from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain

    worst = 0.0
    for ckpt, (npz, names) in GOLDEN_FORWARDS.items():
        gold = np.load(os.path.join(GOLDEN_DIR, npz))
        t = Trainer(ParamsPlain(**GOLDEN_CFG),
                    os.path.join(root, "golden_" + ckpt.replace("/", "_"), "nnet"),
                    dim=20, num_speakers=10, device=device)
        t.build("train", 20, GOLDEN_CFG["loss_func"], 10)
        imported, skipped = import_reference_checkpoint(os.path.join(GOLDEN_DIR, ckpt), t)
        if skipped not in ([], ["global_step"]) or len(imported) < 40:
            raise AssertionError("golden %s: imported %d, skipped %s"
                                 % (ckpt, len(imported), skipped))
        feats = torch.from_numpy(gold["features"]).to(device)
        labels = torch.from_numpy(gold["labels"]).long().to(device)
        with torch.no_grad():
            model = t.network_model.eval()
            loss0, ep = model(feats, labels, 0)
            loss20k, _ = model(feats, labels, 20000)
        for mine, theirs in names:
            worst = max(worst, check_close(
                "golden %s %s" % (ckpt, mine), ep[mine].float().cpu().squeeze(),
                torch.from_numpy(gold[theirs]).squeeze(), quiet=True, **GOLDEN_TOL))
        for step, loss in ((0, loss0), (20000, loss20k)):
            check_close("golden %s loss at step %d" % (ckpt, step), loss.cpu().reshape(1),
                        torch.tensor([float(gold["loss_step%d" % step])]), atol=1e-5, rtol=1e-4,
                        quiet=True)
        print("golden %s imported on %s (%d tensors, skipped %s): the float32 forward's "
              "%d endpoints and the loss at steps 0 and 20000 against real TF's (%s) within "
              "rtol/atol 1e-4 ok" % (ckpt, device, len(imported), skipped, len(names), npz))
    return worst


def insight_reading(torch, main_fn, argv):
    """train_insight's (valid loss, EER, embeddings) from its line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    m = re.search(r"valid_loss (\S+) eer (\S+) \((\d+) embeddings\)", buf.getvalue())
    if rc != 0 or m is None:
        raise AssertionError("train_insight %s: rc %d, %r" % (argv, rc, buf.getvalue()))
    return float(m.group(1)), float(m.group(2)), int(m.group(3))


def run_interop(torch, root, trained, scp, valid, device="cuda"):
    """Phase 30: export the trained flagship as a TF checkpoint, import it
    on the card into a new model dir, extract from both; the golden
    checkpoints' forwards on the card; the three tools on the flagship.
    Returns the path's launches and a summary."""
    from tf_kaldi_speaker_tpu_torch.cli import export_tf_checkpoint, import_tf_checkpoint
    from tf_kaldi_speaker_tpu_torch.cli import extract as cli_extract
    from tf_kaldi_speaker_tpu_torch.cli import (extract_softmax_weights, target_logit_curve,
                                                train_insight)
    from tf_kaldi_speaker_tpu_torch.kio import read_tf_checkpoint, read_vec_flt_ark
    from tf_kaldi_speaker_tpu_torch.train.checkpoints import load_checkpoint, read_pointer

    out = {}
    # the checkpoint the dir serves: phase 15 points it at the best epoch's,
    # and export_tf_checkpoint's default is the newest
    step = read_pointer(os.path.join(trained, "nnet"))
    t0 = time.perf_counter()
    tf_dir = os.path.join(root, "interop_tf")
    if export_tf_checkpoint.main(["--checkpoint", str(step), trained, tf_dir]) != 0:
        raise RuntimeError("export_tf_checkpoint exited non-zero")
    prefix = read_tf_prefix(tf_dir)
    n_tensors = len(read_tf_checkpoint(prefix))
    out["export_s"] = time.perf_counter() - t0
    with open(os.path.join(trained, "nnet", "num_speakers")) as f:
        n_spk = int(f.read())
    imported = os.path.join(root, "interop_imported")
    t0 = time.perf_counter()
    if import_tf_checkpoint.main(["--config", os.path.join(tf_dir, "config.json"),
                                  "--feature-dim", str(FEAT_DIM), "--num-speakers", str(n_spk),
                                  "--device", device, prefix, imported]) != 0:
        raise RuntimeError("import_tf_checkpoint exited non-zero")
    out["import_s"] = time.perf_counter() - t0
    if not same_trees(load_checkpoint(os.path.join(imported, "nnet"))[0],
                      load_checkpoint(os.path.join(trained, "nnet"))[0]):
        raise AssertionError("the imported params/batch_stats differ from the trained checkpoint")
    print("export_tf_checkpoint of the trained flagship: %d tensors (%s) in %.3f s; "
          "import_tf_checkpoint --device %s in %.3f s: params and batch_stats bit-equal to "
          "the trained checkpoint ok" % (n_tensors, os.path.basename(prefix), out["export_s"],
                                         device, out["import_s"]))

    flags = ["--device-pipe", "--cmvn", "--vad", "--batch-size", "32", "--device", device]
    arks = {}
    for name, model in (("original", trained), ("imported", imported)):
        dst = os.path.join(root, "interop_xv_" + name)
        run = drive(torch, cli_extract.main,
                    flags + [model, "scp:" + scp, "ark,scp:%s.ark,%s.scp" % (dst, dst)])
        if run["rc"] != 0:
            raise RuntimeError("cli.extract from the %s dir exited %d" % (name, run["rc"]))
        arks[name] = dst + ".ark"
        out[name + "_extract_s"] = run["wall"]
    launches = check_launched("interop (cli.extract --device-pipe from the imported dir)", run,
                              ["cm_dequantize", "masked_stats_pooling"])
    got, want = (list(read_vec_flt_ark(arks[k])) for k in ("imported", "original"))
    if len(got) != N_UTTS:
        raise AssertionError("imported dir: %d embeddings, not %d" % (len(got), N_UTTS))
    with open(arks["imported"], "rb") as a, open(arks["original"], "rb") as b:
        out["arks_byte_equal"] = a.read() == b.read()
    _, out["interop_max_one_minus_cos"] = compare_embeddings(
        "imported vs original", got, want, INTEROP_COSINE_GAP)
    print("cli.extract --device-pipe --cmvn --vad, imported dir vs the original, %d embeddings: "
          "arks byte-equal %s, largest 1 - cosine %.3g (<= %g) ok"
          % (len(got), out["arks_byte_equal"], out["interop_max_one_minus_cos"],
             INTEROP_COSINE_GAP))
    t0 = time.perf_counter()
    out["golden_max_abs_err"] = check_golden(torch, root, device)
    out["golden_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ark = os.path.join(root, "interop_softmax_weights.ark")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = extract_softmax_weights.main([trained, ark])
    vecs = list(read_vec_flt_ark(ark))
    with open(os.path.join(trained, "nnet", "config.json")) as f:
        width = json.load(f).get("num_nodes_last_layer", 512)
    if rc != 0 or len(vecs) != n_spk or any(v.shape != (width,) or not np.isfinite(v).all()
                                            for _, v in vecs):
        raise AssertionError("extract_softmax_weights: rc %d, %d vectors (want %d of %d-d)"
                             % (rc, len(vecs), n_spk, width))
    out["softmax_weights_s"] = time.perf_counter() - t0
    argv = [valid["data"], valid["spklist"], trained]
    t0 = time.perf_counter()
    insight = drive(torch, lambda a: insight_reading(torch, train_insight.main, a),
                    ["--device", device] + argv)
    card = insight["rc"]
    out["train_insight_card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = insight_reading(torch, train_insight.main, ["--device", "cpu"] + argv)
    out["train_insight_cpu_s"] = time.perf_counter() - t0
    gap = abs(card[0] - cpu[0]) / abs(cpu[0])
    if card[2] != cpu[2] or not np.isfinite(card[0]) or not gap <= CPU_GAP:
        raise AssertionError("train_insight: card %s vs CPU %s (relative loss gap %.3g > %g)"
                             % (card, cpu, gap, CPU_GAP))
    out.update(train_insight_loss_gap=gap, train_insight_eer_card=card[1],
               train_insight_eer_cpu=cpu[1])
    for name, n in insight["launches"].items():
        launches[name] += n
    curves = {}
    t0 = time.perf_counter()
    for dev in (device, "cpu"):
        csv = os.path.join(root, "interop_curve_%s.csv" % dev)
        with contextlib.redirect_stdout(io.StringIO()):
            if target_logit_curve.main(["--device", dev, csv]) != 0:
                raise RuntimeError("target_logit_curve --device %s exited non-zero" % dev)
        with open(csv) as f:
            curves[dev] = f.read()
    out["target_logit_curve_s"] = time.perf_counter() - t0
    if curves[device] != curves["cpu"] or len(curves["cpu"].splitlines()) != 402:
        raise AssertionError("target_logit_curve: the card's CSV differs from the CPU's")
    print("tools on the trained flagship (%s): extract_softmax_weights %d x %d-d in %.3f s; "
          "train_insight --device %s valid loss %.6f EER %.4f (%d embeddings, %.3f s) vs CPU "
          "%.6f EER %.4f (%.3f s): relative loss gap %.3g (<= %g) ok; target_logit_curve "
          "--device %s == --device cpu, 401 rows ok"
          % (CARD, len(vecs), width, out["softmax_weights_s"], device, card[0], card[1],
             card[2], out["train_insight_card_s"], cpu[0], cpu[1], out["train_insight_cpu_s"],
             gap, CPU_GAP, device))
    return launches, out


def run_extract_multi(torch, root, trained, scp, device="cuda"):
    """Phase 31: the Extractor and the DevicePipeExtractor with the bucket
    batches cut into two row blocks on the one card (devices cuda:0 twice),
    and over every visible card where there are several, against one
    device on phase 5's utterances, from the trained flagship (bf16) and
    its float32 copy. Each way runs once to warm up, then once timed.
    Returns the two-block runs' launches and a summary."""
    from tf_kaldi_speaker_tpu_torch.cli.extract import apply_cmvn_vad
    from tf_kaldi_speaker_tpu_torch.extract.device_pipe import DevicePipeExtractor
    from tf_kaldi_speaker_tpu_torch.extract.extractor import Extractor
    from tf_kaldi_speaker_tpu_torch.kio import read_codes_scp, read_mat_scp

    feats = [(k, apply_cmvn_vad(m, True, True)) for k, m in read_mat_scp(scp)]
    codes = [(k, c, h) for k, c, h in read_codes_scp(scp) if c.shape[0] <= MULTI_CHUNK]
    n_long = sum(f.shape[0] > MULTI_CHUNK for _, f in feats)
    if not n_long or not codes:
        raise AssertionError("%d utterances over %d frames after the pipe, %d up to it before"
                             % (n_long, MULTI_CHUNK, len(codes)))
    first = device + ":0" if device == "cuda" else device
    ways = {"one_device": dict(device=first), "two_blocks": dict(devices=[first] * 2)}
    if device == "cuda" and torch.cuda.device_count() > 1:
        ways["every_card"] = dict(device="cuda")
    models = {"bf16": trained, "f32": float32_model(trained, root, "multi_f32_model")}
    kw = dict(batch_size=32, chunk_size=MULTI_CHUNK)
    out, launches = {}, collections.Counter()

    def extract(model, way, timed):
        ex = Extractor(model, **kw, **ways[way])
        pipe = DevicePipeExtractor(model, cmvn=True, vad=True, **kw, **ways[way])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = list(ex.embed_stream(iter(feats)))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        c = list(pipe.embed_codes_stream(iter(codes)))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        timed.update(feature=f, pipe=c, feature_emb_per_s=len(f) / (t1 - t0),
                     pipe_emb_per_s=len(c) / (t2 - t1))
        return 0

    for name, model in models.items():
        results = {}
        for way in ways:
            extract(model, way, {})  # warm-up: cuDNN's and cuBLAS's choices at these shapes
            results[way] = {}
            if way == "two_blocks":
                run = drive(torch, lambda argv: extract(model, way, results[way]), [])
                launches.update(check_launched(
                    "extract_multi (%s: Extractor and DevicePipeExtractor over two row blocks "
                    "on %s)" % (name, first), run, ["cm_dequantize", "masked_stats_pooling"]))
            else:
                extract(model, way, results[way])
            for path in ("feature", "pipe"):
                out["%s_%s_%s_emb_per_s" % (name, way, path)] = results[way][path + "_emb_per_s"]
        for way in ways:
            if way == "one_device":
                continue
            for path in ("feature", "pipe"):
                equal, worst = compare_embeddings(
                    "%s %s %s path vs one device" % (name, way, path), results[way][path],
                    results["one_device"][path], MULTI_COSINE_GAP[name])
                out["%s_%s_%s_byte_equal" % (name, way, path)] = equal
                out["%s_%s_%s_max_one_minus_cos" % (name, way, path)] = worst
    print("extraction over row blocks (%s; rates of one card, not a scaling number): %d "
          "utterances through the feature path (%d over %d frames, 50%%-overlap chunks) and %d "
          "through the device pipe, bounds %s; %s ok"
          % (CARD, len(feats), n_long, MULTI_CHUNK, len(codes), MULTI_COSINE_GAP,
             json.dumps(out)))
    return dict(launches), out


# Phase 32, training quality: the convergence harness's flagship arm at its
# full schedule (tf_kaldi_speaker_tpu_torch.validation.convergence).
QUALITY_SEED = 1
# one epoch on shuffled speaker labels: a control the bounds must exclude,
# beside the untrained network
QUALITY_CONTROL_EPOCHS = 1
# the quality matrix's pool arms: the dequant at D = 12 (64 chunks of the
# shortest bucket) and the pooling layer of width 128 in bf16
QUALITY_KERNEL_SHAPES = {"cm_dequantize": (64, 151, 12), "pooling": (64, 286, 256)}


def outside(value, band):
    """True where ``value`` lies outside ``band`` = (centre, half-width)."""
    return abs(value - band[0]) > band[1]


def check_quality_bounds(summary):
    """The trained arm inside both bands of JAX's am-softmax f32 rows (the
    final held-out EER and the final valid loss), every valid loss finite;
    each control outside at least one of them."""
    if not np.all(np.isfinite(summary["valid_loss"])):
        raise AssertionError("quality: valid losses %s" % summary["valid_loss"])
    for key, value in (("eer", summary["eer"]), ("loss", summary["valid_loss"][-1])):
        if outside(value, summary[key + "_band"]):
            raise AssertionError("quality: %s %.4f outside JAX's am-softmax band %.4f +- %.4f"
                                 % (key, value, *summary[key + "_band"]))
    for name, c in summary["controls"].items():
        if not (outside(c["eer"], summary["eer_band"])
                or outside(c["valid_loss"], summary["loss_band"])):
            raise AssertionError(
                "quality: the %s control (EER %.4f, valid loss %.4f) lies inside both bands: "
                "they do not tell a trained network from it" % (name, c["eer"], c["valid_loss"]))


def run_quality(torch, root, flush=None, device="cuda", steps_per_epoch=None):
    """Phase 32: the convergence corpus, the flagship arm's run as the path
    ``quality`` and its checks (:func:`check_quality_bounds`) against the
    untrained network and a shuffled-label run, and (with ``flush``, on
    the card) the quality matrix's kernel shapes against the plain
    versions. Returns the path's launches, its shapes and a summary."""
    from tf_kaldi_speaker_tpu_torch.validation import common, convergence, corpora

    qroot = os.path.join(root, "quality")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        corpora.make_data(qroot)
    data_s = time.perf_counter() - t0
    argv = ["run", "--arm", "torch", "--loss", "amsoftmax", "--program", "flagship",
            "--seed", str(QUALITY_SEED), "--root", qroot, "--device", device]
    if steps_per_epoch:
        argv += ["--steps-per-epoch", str(steps_per_epoch)]
    run = drive(torch, convergence.main, argv)
    if run["rc"] != 0:
        raise RuntimeError("validation.convergence run exited %d" % run["rc"])
    launches = check_launched("quality path (validation.convergence --program flagship)", run,
                              kernel_wrappers())
    with open(os.path.join(qroot, "results", "torch_amsoftmax_s%d_flagship.json"
                           % QUALITY_SEED)) as f:
        result = json.load(f)
    bands = {}
    for key, ref in (("eer", convergence.jax_eers("amsoftmax")),
                     ("loss", convergence.jax_final_valid_losses("amsoftmax"))):
        j = common.judge([0.0], ref)
        bands[key + "_band"] = (j["jax_mean"], j["band"])
    controls = {}
    for name, epochs in (("untrained", 0), ("shuffled_labels", QUALITY_CONTROL_EPOCHS)):
        t1 = time.perf_counter()
        c = convergence.run_control(qroot, "amsoftmax", QUALITY_SEED, "flagship", device,
                                    epochs=epochs)
        c.update(seconds=time.perf_counter() - t1,
                 eer_outside=outside(c["eer"], bands["eer_band"]),
                 loss_outside=outside(c["valid_loss"], bands["loss_band"]))
        controls[name] = c
    summary = dict(valid_loss=result["valid_loss"], eer=result["eer"],
                   train_wall_s=result["wall_s"], arm_wall_s=run["wall"], data_s=data_s,
                   controls=controls, **bands)
    print("quality (%s): flagship arm seed %d, valid loss by epoch %s (JAX am-softmax f32 "
          "final %.3f +- %.3f), held-out EER %.2f%% (JAX %.2f%% +- %.2f%%); %.1f s training of "
          "%.1f s for the arm" % (
              CARD, QUALITY_SEED, ["%.3f" % v for v in result["valid_loss"]],
              bands["loss_band"][0], bands["loss_band"][1], 100 * result["eer"],
              100 * bands["eer_band"][0], 100 * bands["eer_band"][1], result["wall_s"],
              run["wall"]))
    for name, c in controls.items():
        print("quality control %s (%s): valid loss %.3f (%s the band), EER %.2f%% (%s the "
              "band), %.1f s" % (name, CARD, c["valid_loss"],
                                 "outside" if c["loss_outside"] else "inside", 100 * c["eer"],
                                 "outside" if c["eer_outside"] else "inside", c["seconds"]))
    check_quality_bounds(summary)
    if flush is not None:
        g = torch.Generator().manual_seed(2)
        gdev = torch.Generator(device="cuda").manual_seed(2)
        r = measure_dequant(torch, g, QUALITY_KERNEL_SHAPES["cm_dequantize"], flush, True)
        summary["dequant_d12"] = dict(ms=r["ms"], bound_ms=r["bound_ms"],
                                      plain_ms=r["plain_ms"], max_abs_err=r["max_abs_err"])
        for key, measure in (("pooling_d256", measure_pooling),
                             ("pooling_bwd_d256", measure_pooling_bwd)):
            r = measure(torch, gdev, QUALITY_KERNEL_SHAPES["pooling"], torch.bfloat16, flush,
                        True)
            summary[key] = dict(ms=r["ms"], bound_ms=r["bound_ms"], plain_ms=r["plain_ms"],
                                max_abs_err=r["max_abs_err"])
    summary["phase_s"] = time.perf_counter() - t0
    return launches, run["shapes"], summary


def main():
    import logging

    import torch

    global CARD, SM_MHZ
    t_start = time.perf_counter()
    args = sys.argv[1:]
    spread = args == ["--mt-step-spread"]
    epoch_spread = args == ["--mt-epoch-spread"]
    dp_spread = args == ["--dp-spread"]
    kernels_only = args[:1] == ["--kernels"] and len(args) <= 2
    if args and not (spread or epoch_spread or dp_spread or kernels_only):
        raise SystemExit("usage: python3 chip_smoke.py [--mt-step-spread | --mt-epoch-spread | "
                         "--dp-spread | --kernels [SHAPES_JSON]]")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs the port on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    CARD = smi[0]
    print(CARD)
    SM_MHZ = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if spread:
        root = os.path.join(WORK_DIR, "mt_spread")
        shutil.rmtree(root, ignore_errors=True)
        d, patched, env, _ = setup_fisher_recipe(root)
        run_stages(patched, env, [1], d)
        mt_step_spread(torch, root, os.path.join(env["data_root"], "train_background", "mfcc"))
        return
    if epoch_spread:
        root = os.path.join(WORK_DIR, "mt_epoch_spread")
        shutil.rmtree(root, ignore_errors=True)
        mt_epoch_spread(torch, root)
        return

    from tf_kaldi_speaker_tpu_torch.ops import _build

    t0 = time.perf_counter()
    log = _build.build()
    _build.load()
    print("kernels built from tf_kaldi_speaker_tpu_torch/csrc in %.2f s -> %s"
          % (time.perf_counter() - t0, _build.library_path()))
    for line in log.splitlines():
        if any(w in line for w in ("Compiling entry", "stack frame", "registers")):
            print("  " + line.strip())

    print("torch.backends.cudnn.allow_tf32=%s torch.backends.cuda.matmul.allow_tf32=%s"
          % (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
    flush = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    rows = check_kernels(torch, flush)
    if kernels_only:
        if len(args) == 2:
            replay_saved(torch, args[1], rows, flush)
        print("kernel rows (%s): %s" % (CARD, json.dumps(rows)))
        return

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    os.makedirs(WORK_DIR)
    if dp_spread:
        train, valid = write_corpus(WORK_DIR)
        trained = run_training(torch, WORK_DIR, train, valid)[2]
        summary = run_data_parallel(torch, WORK_DIR, trained, train, valid,
                                    fresh_seeds=(0, 1, 2), n_batches=4)[2]
        print("data-parallel spread (%s): %s" % (CARD, json.dumps(summary)))
        return
    model = write_model_dir(torch, os.path.join(WORK_DIR, "model"))
    scp = write_ark(WORK_DIR)
    launches, shapes, host = run_extraction(torch, model, scp, WORK_DIR)
    check_reference(torch, model, scp, host)
    replay_mix(torch, shapes, rows, flush)
    run_server(model, scp)

    train, valid = write_corpus(WORK_DIR)
    train_launches, train_shapes, trained, step_time = run_training(
        torch, WORK_DIR, train, valid)
    profile = profile_train_group(torch, trained, train)
    replay_mix(torch, train_shapes, rows, flush, prefix="train_mix_")
    check_step_against_cpu(torch, trained, train)
    extract_trained(trained, scp, WORK_DIR)
    print("training summary (%s): %s" % (CARD, json.dumps(dict(step_time, **(profile or {})))))

    stream, streamed, stream_time = run_stream_training(torch, WORK_DIR, train, valid)
    stream_profile = profile_stream_group(torch, streamed, train)
    gap = check_stream_step_against_cpu(torch, streamed, train)
    preempt = run_preemption(WORK_DIR, train, valid)
    finetune = run_finetune(torch, WORK_DIR, trained, train, valid)
    tune = run_tune_lr(torch, WORK_DIR, train)
    paths = {"extract": launches, "train": train_launches, "train_stream": stream["launches"],
             "finetune": finetune["launches"], "tune_lr": tune["launches"]}
    for prefix, run in (("stream_mix_", stream), ("finetune_mix_", finetune),
                        ("tune_lr_mix_", tune)):
        replay_mix(torch, {k: v for k, v in run["shapes"].items() if v}, rows, flush,
                   prefix=prefix)
    print("streaming, preemption, fine-tuning and LR-sweep summary (%s): %s" % (CARD, json.dumps(
        dict(stream_time, **(stream_profile or {}), stream_cpu_loss_gap=gap, **preempt,
             finetune_wall_s=finetune["wall"], tune_lr_wall_s=tune["wall"]))))

    zoo_runs, zoo_summary = run_zoo(torch, WORK_DIR, train, valid, scp, streamed)
    zoo_shapes = {}
    for path, run in zoo_runs.items():
        paths[path] = run["launches"]
        for name, counter in run["shapes"].items():
            zoo_shapes.setdefault(name, collections.Counter()).update(counter)
    replay_mix(torch, {k: v for k, v in zoo_shapes.items() if v}, rows, flush, prefix="zoo_mix_")
    print("zoo summary (%s): %s" % (CARD, json.dumps(zoo_summary)))

    wav_launches, wav_shapes, wav_summary, wav_data = run_wav_to_score(torch, WORK_DIR, trained)
    paths["wav_to_score"] = wav_launches
    replay_mix(torch, {k: v for k, v in wav_shapes.items() if v}, rows, flush, prefix="wav_mix_")
    print("wav-to-score summary (%s): %s" % (CARD, json.dumps(wav_summary)))

    aug_srcs, paths["augment"], aug_summary = run_augmentation(torch, WORK_DIR, wav_data)
    print("augmentation summary (%s): %s" % (CARD, json.dumps(aug_summary)))
    # the CLI work of phases 21, 25, 29 and 26 runs in threads while this
    # one runs phases 22, 24 and 27; every replay waits until they end
    recipe = Beside(recipe_stages, WORK_DIR, aug_srcs)
    chain = Beside(run_cli_chain, WORK_DIR)
    try:
        paths["triplet"], triplet_shapes, triplet_summary = run_triplet(
            torch, WORK_DIR, train, valid)
        print("triplet summary (%s): %s" % (CARD, json.dumps(triplet_summary)))
        paths["mi"], mi_shapes, mi_summary = run_multi_input(torch, WORK_DIR, trained, train,
                                                             valid)
        print("multi-input summary (%s): %s" % (CARD, json.dumps(mi_summary)))
        paths["dp"], dp_shapes, dp_summary = run_data_parallel(torch, WORK_DIR, trained, train,
                                                               valid)
        print("data-parallel summary (%s): %s" % (CARD, json.dumps(dp_summary)))
    finally:
        recipe.join()
        chain.join()
    print("phases 21, 25, 29 and 26's stages ended %.1f s into the script"
          % (time.perf_counter() - t_start))
    paths["recipe"], recipe_shapes, recipe_summary = report_recipe(recipe.result())
    print("recipe summary (%s): %s" % (CARD, json.dumps(recipe_summary)))
    fisher_run, sre_run, mt_run = chain.result()
    paths["fisher"], fisher_shapes, fisher_summary = report_fisher(fisher_run)
    print("fisher recipe summary (%s): %s" % (CARD, json.dumps(fisher_summary)))
    paths["sre"], sre_shapes, sre_summary = report_sre(sre_run)
    print("sre recipe summary (%s): %s" % (CARD, json.dumps(sre_summary)))
    paths["native_reader"], native_summary = run_native_reader(torch, WORK_DIR, train, valid)
    print("native reader summary (%s): %s" % (CARD, json.dumps(native_summary)))
    paths["mt"], mt_summary = report_multitask(torch, mt_run)
    print("multitask recipe summary (%s): %s" % (CARD, json.dumps(mt_summary)))
    for prefix, mix in (("recipe_mix_", recipe_shapes), ("triplet_mix_", triplet_shapes),
                        ("mi_mix_", mi_shapes), ("fisher_mix_", fisher_shapes),
                        ("dp_mix_", dp_shapes), ("sre_mix_", sre_shapes)):
        replay_mix(torch, {k: v for k, v in mix.items() if v}, rows, flush, prefix=prefix)
    paths["decode"], decode_summary = run_decode_phase(torch, WORK_DIR)
    print("decode summary (%s): %s" % (CARD, json.dumps(decode_summary)))
    paths["interop"], interop_summary = run_interop(torch, WORK_DIR, trained, scp, valid)
    print("interop summary (%s): %s" % (CARD, json.dumps(interop_summary)))
    paths["extract_multi"], multi_summary = run_extract_multi(torch, WORK_DIR, trained, scp)
    print("extract_multi summary (%s): %s" % (CARD, json.dumps(multi_summary)))
    paths["quality"], quality_shapes, quality_summary = run_quality(torch, WORK_DIR, flush)
    replay_mix(torch, {k: v for k, v in quality_shapes.items() if v}, rows, flush,
               prefix="quality_mix_")
    del flush
    print("quality summary (%s): %s" % (CARD, json.dumps(quality_summary)))
    write_json(SHAPES_JSON, REPLAYED)

    # the port calls no single PyTorch function that computes any of them
    # (the BatchNorm's would be F.batch_norm, whose momentum and variance
    # differ): library_ms is null
    kernels = []
    for name, (src, rep) in SOURCES.items():
        by_path = {path: counts.get(name, 0) for path, counts in paths.items()}
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=sum(by_path.values()), launches_by_path=by_path, library_ms=None,
            **{k: v for k, v in rows[name].items() if v is not None}))
    print("chip_smoke: every phase passed in %.1f s of command time (%s)"
          % (time.perf_counter() - t_start, CARD))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--dp-cli-rank"]:
        dp_cli_rank_main(sys.argv[2:])
    else:
        main()
    sys.exit(0)
