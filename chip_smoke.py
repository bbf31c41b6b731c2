#!/usr/bin/env python3
"""Drive the PyTorch port (tf_kaldi_speaker_tpu_torch) on one CUDA card.

Usage, from the root of the repository:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. print the card's name and power limit; stop unless CUDA is available;
2. build the CUDA kernels from tf_kaldi_speaker_tpu_torch/csrc;
3. hold each kernel against its plain PyTorch version on the card at the
   extraction path's shapes, and time both (CUDA events, median);
4. write a flagship-width x-vector model dir (random weights from a seed,
   non-trivial BatchNorm statistics, bf16 compute, fused pooling);
5. write a compressed ark of 64 synthetic 30-dim utterances;
6. extract through ``cli.extract`` with ``--device-pipe --cmvn --vad``
   (the main path: both kernels must launch) and through the host path,
   and hold the embeddings against each other and against a float32 CPU
   forward of the same checkpoint;
7. serve 16 requests from 8 client threads through ``EmbeddingServer``
   and hold each reply against ``embed_utterance``.

The line before the last is a JSON object with each kernel's route,
source, launch count on the main path, error against its plain version
and times; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
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


def time_ms(torch, fn, flush, runs=50, warmup=5):
    """Median time of one call in ms, CUDA events around each call, with
    the L2 cache flushed before each (the extraction path finds its
    inputs cold)."""
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


def check_close(name, got, want, atol, rtol):
    """max |got - want| and raise unless |got - want| <= atol + rtol |want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = float(diff.max())
    if not bool((diff <= atol + rtol * want.abs()).all()):
        raise AssertionError("%s: max abs err %.3g exceeds atol %g + rtol %g"
                             % (name, err, atol, rtol))
    print("%s: max abs err %.3g (atol %g, rtol %g) ok" % (name, err, atol, rtol))
    return err


def check_kernels(torch):
    from tf_kaldi_speaker_tpu_torch.models.pooling import floor_sqrt, masked_moments
    from tf_kaldi_speaker_tpu_torch.ops.cm_dequant import cm_dequantize, cm_dequantize_plain
    from tf_kaldi_speaker_tpu_torch.ops.pooling import (
        masked_stats_pooling, masked_stats_pooling_plain)

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = {}

    # CM dequantization at a batch of the device pipe: [32, 400, 30].
    codes = torch.randint(0, 256, (32, 400, FEAT_DIM), generator=g,
                          dtype=torch.uint8).to(dev)
    headers = torch.sort(torch.randn(32, 4, FEAT_DIM, generator=g) * 8.0,
                         dim=1).values.to(dev)
    # torch's CUDA division by a scalar multiplies by the reciprocal, so
    # the plain version may differ from the kernel's division by 1 ulp.
    err = check_close("cm_dequantize [32, 400, 30] vs plain",
                      cm_dequantize(codes, headers),
                      cm_dequantize_plain(codes, headers), atol=1e-6, rtol=1e-6)
    rows["cm_dequantize"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: cm_dequantize(codes, headers), flush),
        plain_ms=time_ms(torch, lambda: cm_dequantize_plain(codes, headers), flush))

    # Statistics pooling at the pooling layer of a 400-frame bucket:
    # [32, 386, 1500], post-ReLU with a large mean, ragged masks (one row
    # empty, one full) and non-zero values on the masked frames.
    b, l, d = 32, 386, 1500
    x = torch.relu(torch.randn(b, l, d, generator=g) * 4.0 + 50.0).to(dev)
    lengths = torch.randint(1, l + 1, (b,), generator=g)
    lengths[0], lengths[1] = 0, l
    mask = (torch.arange(l)[None, :] < lengths[:, None]).float().to(dev)
    for dtype, atol, rtol in ((torch.float32, 1e-4, 1e-5),
                              # one bf16 ulp: both round an f32 result
                              (torch.bfloat16, 0.0, 2.0 ** -7)):
        xt = x.to(dtype)
        name = "masked_stats_pooling %s [%d, %d, %d]" % (str(dtype)[6:], b, l, d)
        got = masked_stats_pooling(xt, mask)
        err = check_close(name + " vs plain", got,
                          masked_stats_pooling_plain(xt, mask), atol, rtol)
        mean, var = masked_moments(xt.float(), mask)
        check_close(name + " vs masked_moments", got,
                    torch.cat([mean, floor_sqrt(var)], 1).to(dtype), atol, rtol)
        ms = time_ms(torch, lambda: masked_stats_pooling(xt, mask), flush)
        plain_ms = time_ms(torch, lambda: masked_stats_pooling_plain(xt, mask), flush)
        print("%s: kernel %.4f ms, plain %.4f ms" % (name, ms, plain_ms))
        if dtype == torch.bfloat16:  # the flagship's compute dtype
            rows["masked_stats_pooling"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    print("cm_dequantize [32, 400, 30]: kernel %.4f ms, plain %.4f ms"
          % (rows["cm_dequantize"]["ms"], rows["cm_dequantize"]["plain_ms"]))
    del flush
    return rows


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
    from tf_kaldi_speaker_tpu.kio.ark import ArkScpWriter

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
    from tf_kaldi_speaker_tpu.kio.ark import read_vec_flt_scp
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

    cm_dequantize.launches = 0
    masked_stats_pooling.launches = 0
    dev, dt_dev = extract("device_pipe", ["--device-pipe"])
    launches = {"cm_dequantize": cm_dequantize.launches,
                "masked_stats_pooling": masked_stats_pooling.launches}
    print("main path (cli.extract --device-pipe --cmvn --vad) launches: %s"
          % json.dumps(launches))
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError("the main path did not launch %s" % name)

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
    return launches, host


def check_reference(torch, model, scp, host):
    """The card's bf16 embeddings against a float32 CPU forward of the same
    checkpoint (plain pooling) on four utterances."""
    from tf_kaldi_speaker_tpu.kio.ark import read_mat_scp
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
    from tf_kaldi_speaker_tpu.kio.ark import read_mat_scp
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


def main():
    # The JAX package's __init__ imports jax whenever JAX_PLATFORMS is set;
    # the port reads only its kio codec, and this run needs no jax.
    os.environ.pop("JAX_PLATFORMS", None)
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
        if "registers" in line:
            print("  " + line.strip())

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("torch.backends.cudnn.allow_tf32=%s torch.backends.cuda.matmul.allow_tf32=%s"
          % (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
    rows = check_kernels(torch)

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    os.makedirs(WORK_DIR)
    model = write_model_dir(torch, os.path.join(WORK_DIR, "model"))
    scp = write_ark(WORK_DIR)
    launches, host = run_extraction(torch, model, scp, WORK_DIR)
    check_reference(torch, model, scp, host)
    run_server(model, scp)

    sources = {
        "cm_dequantize": ("tf_kaldi_speaker_tpu_torch/csrc/cm_dequant.cu",
                          "tf_kaldi_speaker_tpu/ops/cm_dequant_pallas.py:28"),
        "masked_stats_pooling": ("tf_kaldi_speaker_tpu_torch/csrc/stats_pooling.cu",
                                 "tf_kaldi_speaker_tpu/ops/pooling_pallas.py:35"),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **rows[name])
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
