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
12. extract with ``cli.extract --device-pipe`` from the trained model dir.

The line before the last is a JSON object with each kernel's route,
source, launch count on the main paths, error against its plain version,
times and bounds at the fixed shapes and over each path's mix; the last
line is ``{"ok": true, "device": {...}}``.
"""

import collections
import json
import os
import random
import shutil
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
WORK_DIR = os.path.join("build", "chip_smoke")
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
# kernel vs plain: dequant 1 ulp (torch's CUDA division by a scalar
# multiplies by the reciprocal); pooling f32 one-pass shifted sums against
# two passes; bf16 one ulp (both round an f32 result)
DEQ_TOL = dict(atol=1e-6, rtol=1e-6)
POOL_TOL = {"float32": dict(atol=1e-4, rtol=1e-5), "bfloat16": dict(atol=0.0, rtol=2.0 ** -7)}
# backward vs plain (both float32 inside, rounded once): float32 to
# reassociation; bf16 one ulp, and the float32 noise where the mean and
# deviation terms cancel
BWD_TOL = {"float32": dict(atol=1e-6, rtol=1e-5), "bfloat16": dict(atol=1e-6, rtol=2.0 ** -7)}


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


def run_training(torch, root, train, valid):
    """cli.train from the device pool (the training path). Returns the
    launches and shapes of the three kernels on this path, and the model
    dir. The end of each group of 8 steps is timed after a synchronize (one
    per group, which the trainer does not do itself), as is each epoch's
    start."""
    import logging

    from tf_kaldi_speaker_tpu_torch.cli import train as cli_train
    from tf_kaldi_speaker_tpu_torch.ops.cm_dequant import cm_dequantize
    from tf_kaldi_speaker_tpu_torch.ops.pooling import (
        masked_stats_pooling, masked_stats_pooling_backward)
    from tf_kaldi_speaker_tpu_torch.train import trainer as trainer_mod

    model = os.path.join(root, "trained")
    cfg_path = os.path.join(root, "train.json")
    with open(cfg_path, "w") as f:
        json.dump(TRAIN, f)
    logged = []
    handler = logging.Handler()
    handler.emit = lambda record: logged.append(record.getMessage())
    trainer_log = logging.getLogger("tfks_torch.trainer")
    marks = []  # (kind, step, time)
    Trainer = trainer_mod.Trainer
    train_fn, post_group = Trainer.train, Trainer._post_group

    def mark(self, kind):
        torch.cuda.synchronize()
        marks.append((kind, self.step, time.perf_counter()))

    def timed_train(self, *args, **kw):
        mark(self, "start")
        return train_fn(self, *args, **kw)

    def timed_post_group(self, *args, **kw):
        mark(self, "group")
        return post_group(self, *args, **kw)

    wrappers = {"cm_dequantize": cm_dequantize, "masked_stats_pooling": masked_stats_pooling,
                "masked_stats_pooling_backward": masked_stats_pooling_backward}
    for fn in wrappers.values():
        fn.launches = 0
        fn.shapes.clear()
    Trainer.train, Trainer._post_group = timed_train, timed_post_group
    trainer_log.addHandler(handler)
    try:
        t0 = time.perf_counter()
        rc = cli_train.main(["--config", cfg_path, "--device", "cuda", train["data"],
                             train["spklist"], valid["data"], valid["spklist"], model])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Trainer.train, Trainer._post_group = train_fn, post_group
        trainer_log.removeHandler(handler)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    shapes = {name: collections.Counter(fn.shapes) for name, fn in wrappers.items()}
    if rc != 0:
        raise RuntimeError("cli.train exited %d" % rc)
    print("training path (cli.train, device pool, bf16) launches: %s" % json.dumps(launches))
    for name, n in launches.items():
        if n <= 0 or sum(shapes[name].values()) != n:
            raise AssertionError("the training path launched %s %d times at shapes %s"
                                 % (name, n, dict(shapes[name])))
    losses = [float(m.split("loss ")[1].split()[0]) for m in logged if " loss " in m]
    steps = TRAIN["num_epochs"] * TRAIN["num_steps_per_epoch"]
    if len(losses) != steps // TRAIN["steps_per_dispatch"] or not np.all(np.isfinite(losses)):
        raise AssertionError("logged losses %s (expected %d finite)" % (
            losses, steps // TRAIN["steps_per_dispatch"]))
    with open(os.path.join(model, "nnet", "valid_loss")) as f:
        valid_lines = f.read().split()
    print("logged group losses %s; valid_loss file %s" % (losses, valid_lines))
    # the second epoch: its start mark, then the end of each of its groups
    k, n = TRAIN["steps_per_dispatch"], TRAIN["num_steps_per_epoch"]
    epoch2 = [t for kind, step, t in marks
              if (kind, step) == ("start", n) or (kind == "group" and step > n)]
    groups = np.diff(epoch2)
    step_ms = 1e3 * float(np.median(groups)) / k
    rate = n * TRAIN["num_speakers_per_batch"] / (epoch2[-1] - epoch2[0])
    print("train step, second epoch (%d groups of %d steps, bf16, batch %d x 200-400 frames): "
          "median %.3f ms per step (group times %s s), %.1f chunks/s; whole cli.train run "
          "%.2f s" % (len(groups), k, TRAIN["num_speakers_per_batch"], step_ms,
                      ["%.4f" % g for g in groups], rate, wall))
    return launches, shapes, model, dict(step_ms=step_ms, chunks_per_s=rate)


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
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile: no device events in the trace; device idle share not measured")
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.end - e.time_range.start
    busy_s = busy * 1e-6
    print("profile, 8 bf16 train steps [64, 296, 30] from the pool under torch.profiler: "
          "wall %.4f s, device busy %.4f s, device idle %.1f%%, %d device events"
          % (wall, busy_s, 100 * (1 - busy_s / wall), len(kernels)))
    for name, us in by_name.most_common(12):
        print("  %5.1f%%  %8.3f ms  %s" % (100 * us / busy, us * 1e-3, name[:110]))
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


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs the port on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0])
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))

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
    del flush
    check_step_against_cpu(torch, trained, train)
    extract_trained(trained, scp, WORK_DIR)
    smi_line = smi[0]
    print("training summary (%s): %s" % (smi_line, json.dumps(dict(step_time, **(profile or {})))))

    # no single PyTorch call computes any of the three functions: library_ms is null
    kernels = []
    for name, (src, rep) in SOURCES.items():
        by_path = {"extract": launches.get(name, 0), "train": train_launches[name]}
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=sum(by_path.values()), launches_by_path=by_path, library_ms=None,
            **{k: v for k, v in rows[name].items() if v is not None}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
