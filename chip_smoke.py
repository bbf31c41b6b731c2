#!/usr/bin/env python3
"""Drive the PyTorch port (tf_kaldi_speaker_tpu_torch) on one CUDA card.

Usage, from the root of the repository:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. print the card's name and power limit; stop unless CUDA is available;
2. build the CUDA kernels from tf_kaldi_speaker_tpu_torch/csrc;
3. hold each kernel against its plain PyTorch version on the card at fixed
   shapes (dequant also bit for bit against the host codec), and time
   both (CUDA events, median, L2 evicted) beside the kernel's bound;
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
   dequant kernel, the pooling forward and the pooling backward must each
   launch), with every logged loss finite; one ``torch.profiler`` pass over
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
   launch: the dequant everywhere, both pooling kernels for ResNet34); one
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
   ``--adapt-scp`` and cosine with AS-norm on every utterance pair; the
   card's uncompressed MFCC against numpy ``mfcc`` (float32 rounding), its
   VAD decisions against numpy's (equal); the same chain with ``--device
   cpu``, and the card against it: features within one quantization step,
   x-vectors by cosine, scores by their largest difference over their
   spread, EER within one target trial, minDCF within one target and one
   nontarget trial; each stage's time; the path's shapes replayed, as in 7.

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


def time_ms(torch, fn, flush, runs=50, warmup=5):
    """Median device time of one call in ms, CUDA events around each call,
    with the 50 MB L2 evicted before each by a 256 MB memset (the
    extraction path finds its inputs cold)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        flush.zero_()
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
    from the plain forward, g normal) and time it beside its bound; full:
    also the plain version."""
    from tf_kaldi_speaker_tpu_torch.ops.pooling import (
        masked_stats_pooling_backward, masked_stats_pooling_backward_plain,
        masked_stats_pooling_plain)

    xt, mask = pooling_inputs(torch, g, shape, dtype, g.device)
    out = masked_stats_pooling_plain(xt, mask)
    gr = torch.randn(out.shape, generator=g, device=g.device).to(dtype).cuda()
    label = "masked_stats_pooling_backward %s %s" % (str(dtype)[6:], list(shape))
    got = masked_stats_pooling_backward(xt, mask, out, gr)
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


def check_kernels(torch, flush):
    """Each kernel against its plain version at fixed shapes: dequant at a
    device-pipe batch [32, 400, 30] and at a bandwidth-bound [256, 1200, 30];
    pooling at the pooling layer of a 400-frame bucket [32, 386, 1500], in
    bf16 (the flagship's compute dtype, the row's own numbers) and f32.
    Returns each kernel's JSON row."""
    g = torch.Generator().manual_seed(0)
    rows = {}
    deq = measure_dequant(torch, g, (32, 400, FEAT_DIM), flush, True)
    wide = measure_dequant(torch, g, (256, 1200, FEAT_DIM), flush, True)
    rows["cm_dequantize"] = dict(shape=[32, 400, FEAT_DIM], **deq)
    rows["cm_dequantize"].update(
        {"wide_" + k: v for k, v in dict(shape=[256, 1200, FEAT_DIM], **wide).items()})
    shape = (32, 386, 1500)
    for dtype, key in ((torch.bfloat16, ""), (torch.float32, "f32_")):
        r = measure_pooling(torch, torch.Generator().manual_seed(0), shape, dtype, flush, True)
        row = rows.setdefault("masked_stats_pooling", {})
        row.update({key + k: v for k, v in dict(shape=list(shape), dtype=str(dtype)[6:],
                                                 **r).items()})
    # the backward at the train step's middle bucket (L = 300 frames in)
    shape = (64, 286, 1500)
    for dtype, key in ((torch.bfloat16, ""), (torch.float32, "f32_")):
        gdev = torch.Generator(device="cuda").manual_seed(0)
        r = measure_pooling_bwd(torch, gdev, shape, dtype, flush, True)
        row = rows.setdefault("masked_stats_pooling_backward", {})
        row.update({key + k: v for k, v in dict(shape=list(shape), dtype=str(dtype)[6:],
                                                 **r).items()})
    for name in SOURCES:
        row = rows[name]
        row["max_abs_err"] = max(v for k, v in row.items() if k.endswith("max_abs_err"))
    return rows


def replay_mix(torch, shapes, rows, flush, prefix="mix_"):
    """Every (shape, dtype) a main path launched, through kernel and plain
    version on fresh inputs, and the mix's time: sum of count x median
    kernel time, against sum of count x bound (and, for dequant, of count x
    a copy of the same bytes); written to each row under ``prefix``."""
    g = torch.Generator().manual_seed(1)
    gdev = torch.Generator(device="cuda").manual_seed(1)
    for name, counter in shapes.items():
        mix = {prefix + "ms": 0.0, prefix + "bound_ms": 0.0}
        for (shape, dtype), count in sorted(counter.items()):
            if name == "cm_dequantize":
                r = measure_dequant(torch, g, shape, flush, False)
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
    """The three kernel wrappers by name; each counts its launches."""
    from tf_kaldi_speaker_tpu_torch.ops.cm_dequant import cm_dequantize
    from tf_kaldi_speaker_tpu_torch.ops.pooling import (
        masked_stats_pooling, masked_stats_pooling_backward)

    return {"cm_dequantize": cm_dequantize, "masked_stats_pooling": masked_stats_pooling,
            "masked_stats_pooling_backward": masked_stats_pooling_backward}


def write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def drive(torch, main_fn, argv, capture=None):
    """Run a CLI's ``main(argv)`` in this process as one main path: every
    kernel's launch and shape counters set to 0 just before and read just
    after; log records collected as (logger, message); each epoch's start
    and each group's end marked after a synchronize, at the entry and the
    exit of ``_post_group`` (the trainer does not synchronize itself).
    ``capture`` = (list, n): the first n ``train_step_raw`` inputs are
    copied to the host into the list."""
    import logging

    from tf_kaldi_speaker_tpu_torch.train import trainer as trainer_mod

    logged, marks = [], []  # marks: (kind, step, time)
    handler = logging.Handler()
    handler.emit = lambda record: logged.append((record.name, record.getMessage()))
    Trainer = trainer_mod.Trainer
    train_fn, post_group, step_raw = Trainer.train, Trainer._post_group, Trainer.train_step_raw

    def mark(self, kind):
        torch.cuda.synchronize()
        marks.append((kind, self.step, time.perf_counter()))

    def timed_train(self, *args, **kw):
        mark(self, "start")
        return train_fn(self, *args, **kw)

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
    if capture is not None:
        Trainer.train_step_raw = captured_step_raw
    logging.getLogger().addHandler(handler)
    try:
        t0 = time.perf_counter()
        rc = main_fn(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Trainer.train, Trainer._post_group = train_fn, post_group
        Trainer.train_step_raw = step_raw
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
    launches and shapes of the three kernels on this path, the model dir
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
    run = drive(torch, cli_train.main,
                ["--config", cfg_path, "--device", "cuda", train["data"], train["spklist"],
                 valid["data"], valid["spklist"], model], capture=(first, K))
    if run["rc"] != 0:
        raise RuntimeError("cli.train (streaming) exited %d" % run["rc"])
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


def _pool_group(torch, train, device, group, length, seed):
    from tf_kaldi_speaker_tpu_torch.data.device_pool import DevicePool, gather_chunks

    pool = DevicePool(train["data"], train["spklist"], device=device, seed=seed)
    pool.stage()
    starts, utts, labels = (torch.from_numpy(a).to(device) for a in pool.sample_group(
        random.Random(seed), group, TRAIN["num_speakers_per_batch"], 1, length))
    batches = [gather_chunks(pool.frames, pool.headers, starts[i], utts[i], length)
               + (labels[i],) for i in range(group)]
    pool.close()
    return batches


def profile_train_group(torch, model, train):
    """One torch.profiler pass over a group of 8 bf16 pool steps (after one
    group of warm-up): the device's busy and idle share of the host's wall
    time, and the kernels that take most of the device time."""
    t = _trainer_at(torch, model, "cuda", "bfloat16")
    batches = _pool_group(torch, train, "cuda", TRAIN["steps_per_dispatch"], 296, 3)
    for codes, hdr, lab in batches:
        t.train_step_raw(codes, hdr, lab, TRAIN["learning_rate"])
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for codes, hdr, lab in batches:
            t.train_step_raw(codes, hdr, lab, TRAIN["learning_rate"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_s, n_events, by_name = device_busy(torch, prof)
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
    either input branch (the pool's gather or ``device_decode``), and the
    pooling forward and backward where the statistics pooling is fused."""
    fused = cfg.get("use_fused_pooling", False) and cfg["pooling_type"] == "statistics_pooling"
    return ["cm_dequantize"] + (
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
    kernels = ["cm_dequantize"] + zoo_kernels(cfg)[1:2]  # the backward runs in training only
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


def float32_model(trained, root):
    """The trained flagship's checkpoint with compute_dtype float32, so the
    card and the CPU run the same float32 forward."""
    model = os.path.join(root, "wav_model")
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

    backends = torch.backends
    want = dict(read_vec_flt_scp(cpu_out["xvector_raw"] + ".scp"))
    readings = {}
    for control in CONTROLS:
        path = os.path.join(root, "wav_control", control)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tf32 = control == "tf32"
        backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = tf32
        try:
            rc = extract.main(["--device-pipe", "--batch-size", "32", "--cmvn", "--vad",
                               "--device", "cuda", model if tf32 else trained,
                               "scp:" + os.path.join(out["mfcc"], "feats.scp"),
                               "ark,scp:%s.ark,%s.scp" % (path, path)])
        finally:
            backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
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
    """The wav-to-score phase (19). Returns the path's launches and shapes
    and a summary."""
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
                   controls=controls, make_mfcc_batching_walls=batching)
    return launches, shapes, summary


def main():
    import logging

    import torch

    global CARD
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs the port on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    CARD = smi[0]
    print(CARD)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    from tf_kaldi_speaker_tpu_torch.ops import _build

    t0 = time.perf_counter()
    log = _build.build()
    _build.load()
    print("kernels built from tf_kaldi_speaker_tpu_torch/csrc in %.2f s -> %s"
          % (time.perf_counter() - t0, _build.library_path()))
    for line in log.splitlines():
        if any(w in line for w in ("Compiling entry", "stack frame", "registers")):
            print("  " + line.strip())

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("torch.backends.cudnn.allow_tf32=%s torch.backends.cuda.matmul.allow_tf32=%s"
          % (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
    flush = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    rows = check_kernels(torch, flush)

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    os.makedirs(WORK_DIR)
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

    wav_launches, wav_shapes, wav_summary = run_wav_to_score(torch, WORK_DIR, trained)
    paths["wav_to_score"] = wav_launches
    replay_mix(torch, {k: v for k, v in wav_shapes.items() if v}, rows, flush, prefix="wav_mix_")
    del flush
    print("wav-to-score summary (%s): %s" % (CARD, json.dumps(wav_summary)))

    # no single PyTorch call computes any of the three functions: library_ms is null
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
    main()
    sys.exit(0)
