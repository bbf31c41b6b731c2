"""Multi-card training in the port on the CPU: 2 ranks over gloo on
127.0.0.1 against 1 rank and against the JAX package.

- The data-parallel step: 2 ranks, each fed its half of every batch, end
  equal to 1 rank fed the whole batches (float64 at 1e-10: loss, metrics,
  parameters, BatchNorm moving statistics; float32 at the single-card
  tests' bounds), for the TDNN trainer, the multi-input trainer and the
  multitask trainer; both ranks end bit-equal.
- The padded validation loss of a ragged batch on 2 ranks equals 1 rank's.
- ``model_parallel=2`` (the speaker softmax in column blocks) equals
  ``model_parallel=1`` and the JAX step on a (1, 2) mesh at rel 1e-5; its
  checkpoint holds the whole kernel in the JAX layout and loads back into
  the blocks.
- ``sp_embed`` on 2 ranks equals the JAX ``sp_embed`` on a 2-device mesh and
  the whole-utterance forward, at an even and an uneven length.
- ``Trainer.train`` over the streaming loader and over the sharded device
  pool on 2 ranks against the JAX package run as 2 processes of 1 device
  (same data, config, seed and initial variables): the parameters, the step
  and the valid loss.
- SIGTERM to one rank of a 2-rank ``cli.train`` makes both exit 75 at one
  step, with one checkpoint.
- The multitask epoch's ``speaker_egs`` / ``phone_egs`` files hold rank 0's
  own counts on 2 ranks (a 1/nproc sample, as the JAX trainer's process 0
  writes them) and the one rank's counts on 1 rank.

Each worker is this file run as a script (``python test_torch_parallel.py
<worker> <dir>``), one process a rank; every collective times out after
COLLECTIVE_TIMEOUT seconds and every spawn after SPAWN_TIMEOUT, so a
fault fails the test instead of hanging it.
"""

import glob
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLLECTIVE_TIMEOUT = 120
SPAWN_TIMEOUT = 300

DIM, SPEAKERS, LR = 10, 6, 0.02
TINY = dict(
    seed=3, network_type="tdnn", tdnn_layer_size=16, num_nodes_pooling_layer=24,
    num_nodes_last_layer=12, pooling_type="statistics_pooling", embedding_node="tdnn6_dense",
    last_layer_linear=True, loss_func="additive_margin_softmax", amsoftmax_m=0.2,
    amsoftmax_lambda_min=0, amsoftmax_lambda_base=1000, amsoftmax_lambda_gamma=1e-4,
    amsoftmax_lambda_power=5, optimizer="momentum", momentum=0.9, weight_l2_regularizer=1e-2,
    batchnorm_momentum=0.99, use_fused_pooling=True,
    num_speakers_per_batch=4, num_segments_per_speaker=2, min_segment_len=48,
    max_segment_len=48, num_steps_per_epoch=4, steps_per_dispatch=2,
    show_training_progress=0, num_parallel_datasets=1, max_queue_size=4,
    valid_max_iterations=3, stop_poll_groups=1)
# the multi-input trainer: a BNF stream concatenated onto the input
BNF = 8
MI = dict(TINY, loss_func="softmax", aux_feature_dim={"bnf": BNF}, aux_concat_input=["bnf"])
# the multitask trainer (tests/test_multitask.py's model) in all-frames mode
MT = dict(
    seed=0, tdnn_layer_size=16, num_nodes_pooling_layer=24, speaker_dim=12, phone_dim=12,
    pooling_type="statistics_pooling", embedding_node="zs_mu_dense",
    spk_loss_type="additive_margin_softmax", amsoftmax_m=0.2, amsoftmax_lambda_min=0,
    amsoftmax_lambda_base=1000, amsoftmax_lambda_gamma=1e-4, amsoftmax_lambda_power=5,
    phn_loss_type="softmax", spk_loss_weight=1.0, phn_loss_weight=0.5, num_shared_layers=2,
    phone_kernel_size=[5, 5, 7, 1, 3], phone_layer_size=[16] * 5,
    phone_dilation_size=[1, 1, 1, 1, 4], phone_left_context=11, phone_right_context=11,
    speaker_left_context=7, speaker_right_context=7, num_frames_per_utt=-1,
    optimizer="momentum", momentum=0.9, weight_l2_regularizer=1e-4, batchnorm_momentum=0.99)
PHONES = 12
# the multitask epoch whose egs counts are written (2 speakers a rank)
MT_EPOCH = dict(MT, num_frames_per_utt=5, num_steps_per_epoch=4, steps_per_dispatch=2,
                num_speakers_per_batch=4, num_segments_per_speaker=1, min_segment_len=48,
                max_segment_len=48, show_training_progress=0, num_parallel_datasets=1,
                max_queue_size=4, stop_poll_groups=1)
F64 = dict(rtol=1e-10, atol=1e-10)
# the single-card float32 tests' bounds (tests/test_torch_pool.py)
F32 = dict(rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# What a rank runs (also run by the test itself as the one-rank reference)
# --------------------------------------------------------------------------
def _rows(a, rank, world):
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


def _trainer(cls, cfg, root, name, dtype="float32", **kw):
    from tf_kaldi_speaker_tpu_torch.train.trainer import Optimizer
    from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain

    # one model dir a run, shared by its ranks as on one machine
    world = os.environ.get("WORLD_SIZE", "1")
    t = cls(ParamsPlain(**cfg), os.path.join(root, "%s_%s_w%s" % (name, dtype, world)), dim=DIM,
            num_speakers=SPEAKERS, device="cpu", **kw)
    if "num_phones" in kw:
        t.build("train", DIM, num_speakers=SPEAKERS, num_phones=kw["num_phones"])
    else:
        t.build("train", DIM, cfg.get("loss_func"), SPEAKERS)
    if dtype == "float64":
        t.network_model.double()
        t.optimizer = Optimizer(cfg, list(t._params.values()))
    return t


def _state(t):
    from tf_kaldi_speaker_tpu_torch import convert

    return {"/".join(k): v.numpy() for k, v in
            convert.flatten(convert.variables_of(t.network_model)).items()}


def _steps(t, batches, rank, world, step):
    out = []
    for batch in batches:
        m = step(t, [_rows(a, rank, world) for a in batch])
        out.append({k: float(v) for k, v in t._global_mean(m).items()})
    return {"metrics": out, "state": _state(t)}


def data_parallel_runs(root, rank, world):
    """Three steps of each trainer on this rank's rows of fixed batches."""
    from tf_kaldi_speaker_tpu_torch.multitask.trainer import TrainerMultiTask
    from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
    from tf_kaldi_speaker_tpu_torch.train.trainer_mi import TrainerMultiInput

    rng = np.random.RandomState(7)
    tdnn = [(rng.randn(8, 48, DIM), rng.randint(0, SPEAKERS, 8)) for _ in range(3)]
    mi = [(rng.randn(8, 40, DIM), rng.randn(8, 40, BNF), rng.randint(0, SPEAKERS, 8))
          for _ in range(3)]
    mt = []
    for _ in range(3):
        lengths = rng.randint(20, 31, 8)
        mt.append((rng.randn(8, 52, DIM), rng.randint(0, SPEAKERS, 8),
                   rng.randint(0, PHONES, (8, 30)), lengths, np.zeros((8, 1))))
    out = {}
    for dtype in ("float64", "float32"):
        dt = getattr(torch, dtype)

        def cast(a):
            a = torch.from_numpy(np.ascontiguousarray(a))
            return a.to(dt) if a.is_floating_point() else a.to(torch.int32)

        t = _trainer(Trainer, TINY, root, "tdnn", dtype)
        out["tdnn", dtype] = _steps(t, tdnn, rank, world,
                                    lambda t, b: t.train_step(cast(b[0]), cast(b[1]), LR))
        t = _trainer(TrainerMultiInput, MI, root, "mi", dtype)
        out["mi", dtype] = _steps(
            t, mi, rank, world,
            lambda t, b: t.train_step(cast(b[0]), cast(b[2]), LR, {"bnf": cast(b[1])}))
        t = _trainer(TrainerMultiTask, MT, root, "mt", dtype, num_phones=PHONES)
        out["mt", dtype] = _steps(t, mt, rank, world,
                                  lambda t, b: t.train_step(*[cast(a) for a in b], LR))
    return out


def mt_egs_run(work):
    """One multitask epoch; this rank's egs counters and the files rank 0
    wrote (None on the other ranks)."""
    from tf_kaldi_speaker_tpu_torch.multitask.trainer import TrainerMultiTask

    world = int(os.environ.get("WORLD_SIZE", "1"))
    root = os.path.join(work, "egs_w%d" % world)
    t = _trainer(TrainerMultiTask, MT_EPOCH, root, "mt", num_phones=PHONES)
    d = os.path.join(work, "mt_train")
    t.train(d, os.path.join(d, "ali"), os.path.join(d, "spklist"), LR)
    files = {}
    if t.mesh.rank == 0:
        files = {name: np.loadtxt(os.path.join(root, name), dtype=np.int64)[:, 1]
                 for name in ("speaker_egs", "phone_egs")}
    t.close()
    return {"speaker_egs": t.speaker_egs.copy(), "phone_egs": t.phone_egs.copy(),
            "files": files}


def ragged_valid_loss(root):
    """The validation loss of a 13-row batch (padded to the data ranks)."""
    from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer, _row_block

    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(13, 48, DIM).astype(np.float32))
    labels = torch.from_numpy((np.arange(13) % SPEAKERS).astype(np.int32))
    t = _trainer(Trainer, TINY, root, "valid")
    t.build("valid", DIM, TINY["loss_func"], SPEAKERS)
    f, _, l, w = _row_block(feats, None, labels, t.mesh)
    return float(t.valid_loss(f, l, w)), float(w.sum())


def mp_batch():
    rng = np.random.RandomState(0)
    return (rng.randn(8, 48, DIM).astype(np.float32),
            np.arange(8, dtype=np.int32) % SPEAKERS)


def model_parallel_step(root, mp):
    """One float32 step with ``model_parallel=mp`` from the checkpoint 0 in
    ``<root>/mp<mp>``: (metrics, the whole state tree after it, the
    checkpoint rank 0 saves of it, this rank's blocks after the step and as
    a fresh trainer loads them back)."""
    from tf_kaldi_speaker_tpu_torch import convert
    from tf_kaldi_speaker_tpu_torch.parallel.distributed import barrier
    from tf_kaldi_speaker_tpu_torch.train import checkpoints
    from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
    from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain

    cfg = dict(TINY, model_parallel=mp)
    model_dir = os.path.join(root, "mp%d" % mp)

    def trainer():
        t = Trainer(ParamsPlain(**cfg), model_dir, dim=DIM, num_speakers=SPEAKERS,
                    device="cpu")
        t.build("train", DIM, cfg["loss_func"], SPEAKERS)
        return t

    t = trainer()
    assert t.load(0) == 0
    feats, labels = mp_batch()
    m = t.train_step(torch.from_numpy(feats), torch.from_numpy(labels), LR)
    tree = t.state_tree()
    t.save(1)
    barrier("cpu")
    t2 = trainer()
    assert t2.load() == 1
    raw, _ = checkpoints.load_checkpoint(model_dir, 1)
    flat = lambda tr: {"/".join(k): v.numpy() for k, v in convert.flatten(tr).items()
                       if isinstance(v, torch.Tensor)}
    return {"metrics": {k: float(v) for k, v in m.items()}, "tree": flat(tree),
            "saved": flat(raw), "blocks": _state(t), "reloaded": _state(t2)}


def mixed_mesh_step(root):
    """One float32 step on a (data 2, model 2) mesh of 4 ranks from the
    checkpoint 0 in ``<root>/mesh4``: each data rank its half of the rows.
    Returns the metrics and the whole state tree after it."""
    from tf_kaldi_speaker_tpu_torch import convert
    from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
    from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain

    cfg = dict(TINY, model_parallel=2)
    t = Trainer(ParamsPlain(**cfg), os.path.join(root, "mesh4"), dim=DIM,
                num_speakers=SPEAKERS, device="cpu")
    t.build("train", DIM, cfg["loss_func"], SPEAKERS)
    assert (t.mesh.data_size, t.mesh.model_size) == (2, 2)
    assert t.load(0) == 0
    feats, labels = mp_batch()
    rows = slice(4 * t.mesh.data_rank, 4 * t.mesh.data_rank + 4)
    m = t.train_step(torch.from_numpy(feats[rows]), torch.from_numpy(labels[rows]), LR)
    m = t._global_mean(m)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "tree": {"/".join(k): v.numpy() for k, v in convert.flatten(t.state_tree()).items()
                     if isinstance(v, torch.Tensor)}}


def sequence_parallel(model_dir, feats):
    from tf_kaldi_speaker_tpu_torch.extract.extractor import Extractor
    from tf_kaldi_speaker_tpu_torch.parallel import make_mesh
    from tf_kaldi_speaker_tpu_torch.parallel.sequence_parallel import sp_embed

    ex = Extractor(model_dir, min_chunk_size=20, chunk_size=5000, batch_size=2, device="cpu")
    mesh = make_mesh()
    return [sp_embed(ex.net.tdnn, ex.params.dict, f, mesh, node=ex.node) for f in feats]


def epoch_runs(work, kind):
    """``Trainer.train`` (one epoch) and ``valid`` from the JAX run's initial
    checkpoint, over the streaming loader or the sharded pool."""
    from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer

    cfg = dict(TINY, device_pool=kind == "pool")
    t = _trainer(Trainer, cfg, work, "epoch_" + kind)
    assert t.load(0) == 0
    t.build("valid", DIM, cfg["loss_func"], SPEAKERS)
    t.train(os.path.join(work, "train"), os.path.join(work, "train", "spklist"), LR)
    loss, emb, _ = t.valid(os.path.join(work, "valid"), os.path.join(work, "valid", "spklist"),
                           output_embeddings=True)
    pool = t._device_pool
    out = {"step": t.step, "valid_loss": loss, "n_emb": int(emb.shape[0]), "state": _state(t),
           "shard": None if pool is None else [pool.shard, pool.num_shards, len(pool.spk2utts)]}
    t.close()
    return out


# --------------------------------------------------------------------------
# Workers
# --------------------------------------------------------------------------
def _join():
    torch.set_num_threads(1)
    from tf_kaldi_speaker_tpu_torch import parallel

    parallel.initialize("cpu", timeout_s=COLLECTIVE_TIMEOUT)
    return parallel.host_shard_info()


def worker_port(work):
    rank, world = _join()
    out = {"dp": data_parallel_runs(work, rank, world), "valid": ragged_valid_loss(work),
           "mp": model_parallel_step(work, 2)}
    with open(os.path.join(work, "sp_feats.json")) as f:
        lengths = json.load(f)
    feats = [np.load(os.path.join(work, "sp_%d.npy" % n)) for n in lengths]
    out["sp"] = sequence_parallel(os.path.join(work, "sp_model"), feats)
    out["egs"] = mt_egs_run(work)
    torch.save(out, os.path.join(work, "port%d.pt" % rank))


def worker_mesh4(work):
    rank, _ = _join()
    torch.save(mixed_mesh_step(work), os.path.join(work, "mesh4_%d.pt" % rank))


def worker_epochs(work):
    rank, _ = _join()
    out = {kind: epoch_runs(work, kind) for kind in ("stream", "pool")}
    torch.save(out, os.path.join(work, "epochs%d.pt" % rank))


def worker_jax_epochs(work):
    """The JAX package as one process of one CPU device a rank."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    world = int(os.environ["WORLD_SIZE"])
    jax.distributed.initialize("127.0.0.1:%s" % os.environ["MASTER_PORT"],
                               num_processes=world, process_id=int(os.environ["RANK"]))
    assert jax.device_count() == world
    _jax_epochs(work)


def _jax_epochs(work):
    import jax
    from flax import traverse_util

    from tf_kaldi_speaker_tpu.train.trainer import Trainer as JaxTrainer
    from tf_kaldi_speaker_tpu.utils.params import ParamsPlain as JaxParams

    rank = jax.process_index()
    out = {}
    for kind in ("stream", "pool"):
        cfg = dict(TINY, device_pool=kind == "pool")
        jt = JaxTrainer(JaxParams(**cfg), os.path.join(work, "jax_" + kind, "nnet%d" % rank),
                        dim=DIM, num_speakers=SPEAKERS)
        jt.build("train", DIM, cfg["loss_func"], SPEAKERS)
        jt.build("valid", DIM, cfg["loss_func"], SPEAKERS)
        if rank == 0:
            from tf_kaldi_speaker_tpu.train import checkpoints as jck

            jck.save_checkpoint(jt.model, jt.state, 0)
        jt.train(os.path.join(work, "train"), os.path.join(work, "train", "spklist"), LR)
        loss, emb, _ = jt.valid(os.path.join(work, "valid"),
                                os.path.join(work, "valid", "spklist"), output_embeddings=True)
        state = {"params": jax.device_get(jt.state.params),
                 "batch_stats": jax.device_get(jt.state.batch_stats)}
        out[kind] = {"step": int(jt.state.step), "valid_loss": float(loss),
                     "n_emb": int(emb.shape[0]),
                     "state": {"/".join(k): np.asarray(v)
                               for k, v in traverse_util.flatten_dict(state).items()}}
    np.save(os.path.join(work, "jax%d.npy" % rank), out, allow_pickle=True)


def worker_preempt(work):
    """``cli.train`` (streaming), rank 1 sends itself SIGTERM at its first
    group; exits with the CLI's code."""
    torch.set_num_threads(1)
    from tf_kaldi_speaker_tpu_torch.cli import train as cli_train
    from tf_kaldi_speaker_tpu_torch.parallel import distributed
    from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer

    real = distributed.initialize
    distributed_init = lambda device: real(device, timeout_s=COLLECTIVE_TIMEOUT)  # noqa: E731
    cli_train._launch.parallel.initialize = distributed_init
    post = Trainer._post_group

    def post_group(self, cfg, writer, metrics, K, local_group, t0, step0):
        post(self, cfg, writer, metrics, K, local_group, t0, step0)
        if self.mesh.rank == 1 and local_group == 0:
            os.kill(os.getpid(), signal.SIGTERM)

    Trainer._post_group = post_group
    d = os.path.join(work, "train")
    sys.exit(cli_train.main(["--config", os.path.join(work, "pre.json"), "--device", "cpu",
                             d, os.path.join(d, "spklist"), d, os.path.join(d, "spklist"),
                             os.path.join(work, "exp")]))


WORKERS = {"port": worker_port, "mesh4": worker_mesh4, "epochs": worker_epochs,
           "jax_epochs": worker_jax_epochs, "preempt": worker_preempt}


# --------------------------------------------------------------------------
# The test side
# --------------------------------------------------------------------------
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(worker, work, world=2, timeout=SPAWN_TIMEOUT, signal_rank=None):
    """Run ``worker`` as ``world`` ranks; returns [(exit code, output)]. A
    rank still running at ``timeout`` is killed and the test fails."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), worker, work],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
    except subprocess.TimeoutExpired:
        pytest.fail("%s ranks still running after %d s" % (worker, timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _check_ok(results):
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, "rank %d exited %d:\n%s" % (rank, rc, out[-4000:])


def _close(got, want, tol, what):
    assert set(got) == set(want), what
    for k in sorted(want):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), err_msg="%s %s"
                                   % (what, k), **tol)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's 2-rank worker, and what it is held against: the one-rank
    runs, the JAX model-parallel step and the JAX sp_embed."""
    import jax

    from tf_kaldi_speaker_tpu.extract.extractor import Extractor as JaxExtractor
    from tf_kaldi_speaker_tpu.parallel.mesh import make_mesh as jax_mesh
    from tf_kaldi_speaker_tpu.parallel.sequence_parallel import sp_embed as jax_sp_embed
    from tf_kaldi_speaker_tpu.train.trainer import Trainer as JaxTrainer
    from tf_kaldi_speaker_tpu.utils.params import ParamsPlain as JaxParams
    from tf_kaldi_speaker_tpu_torch import convert
    from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
    from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain
    from test_exact_long import make_model

    torch.set_num_threads(1)
    work = str(tmp_path_factory.mktemp("parallel"))
    ref = {}
    # the JAX model-parallel step on a (data 1, model 2) mesh
    cfg = dict(TINY, model_parallel=2)
    jt = JaxTrainer(JaxParams(**cfg), os.path.join(work, "jax_mp"), dim=DIM,
                    num_speakers=SPEAKERS, mesh=jax_mesh(jax.devices()[:2], model_parallel=2))
    jt.build("train", DIM, cfg["loss_func"], SPEAKERS)
    v0 = {"params": jax.device_get(jt.state.params),
          "batch_stats": jax.device_get(jt.state.batch_stats)}
    f, l = jt._shard_batch(*mp_batch())
    state, m = jt._train_step(jt.state, f, l, np.float32(LR))
    ref["jax_mp"] = {"metrics": {k: float(v) for k, v in m.items()},
                     "params": {"/".join(("params",) + k): np.asarray(v) for k, v in
                                convert.flatten(jax.device_get(state.params)).items()}}
    # the port's initial checkpoint from those variables, and its mp=1 step
    t = Trainer(ParamsPlain(**TINY), os.path.join(work, "mp1"), dim=DIM, num_speakers=SPEAKERS,
                device="cpu")
    t.build("train", DIM, TINY["loss_func"], SPEAKERS)
    convert.load_variables(t.network_model, v0)
    t.save(0)
    shutil.copytree(t.model, os.path.join(work, "mp2"))
    shutil.copytree(t.model, os.path.join(work, "mesh4"))
    ref["mp1"] = model_parallel_step(work, 1)
    # sp_embed: a JAX model dir, its whole-utterance and 2-device embeddings
    model = make_model(tmp_path_factory.mktemp("sp"))
    shutil.copytree(model, os.path.join(work, "sp_model"))
    jex = JaxExtractor(model, min_chunk_size=20, chunk_size=5000, batch_size=2)
    variables = {"params": jex.variables["params"]["tdnn"],
                 "batch_stats": jex.variables["batch_stats"].get("tdnn", {})}
    lengths = [1000, 333]
    ref["sp_full"], ref["sp_jax"] = [], []
    for i, n in enumerate(lengths):
        feat = np.random.RandomState(i).randn(n, 20).astype(np.float32)
        np.save(os.path.join(work, "sp_%d.npy" % n), feat)
        ref["sp_full"].append(jex.embed_utterance(feat))
        ref["sp_jax"].append(jax_sp_embed(variables, jex.params.dict, feat,
                                          jax_mesh(jax.devices()[:2]), node=jex.node))
    with open(os.path.join(work, "sp_feats.json"), "w") as fh:
        json.dump(lengths, fh)
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    make_fake_data_dir(os.path.join(work, "mt_train"), num_speakers=SPEAKERS,
                       utts_per_speaker=4, dim=DIM, min_len=60, max_len=120, seed=9,
                       with_vad_ali=True, num_phones=PHONES)

    results = spawn("port", work)
    _check_ok(results)
    ranks = [torch.load(os.path.join(work, "port%d.pt" % r), weights_only=False)
             for r in range(2)]
    _check_ok(spawn("mesh4", work, world=4))
    ref["mesh4"] = [torch.load(os.path.join(work, "mesh4_%d.pt" % r), weights_only=False)
                    for r in range(4)]
    ref["dp"] = data_parallel_runs(work, 0, 1)
    ref["valid"] = ragged_valid_loss(work)
    ref["egs"] = mt_egs_run(work)
    return ranks, ref


@pytest.mark.parametrize("trainer", ["tdnn", "mi", "mt"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_data_parallel_step_equals_one_rank(port_run, trainer, dtype):
    """2 ranks, each fed half of every batch, end where 1 rank fed the
    whole batches ends: metrics, parameters and BatchNorm moving
    statistics; both ranks bit-equal."""
    ranks, ref = port_run
    got, want = ranks[0]["dp"][trainer, dtype], ref["dp"][trainer, dtype]
    tol = F64 if dtype == "float64" else F32
    for g, w in zip(got["metrics"], want["metrics"]):
        _close(g, w, tol, "metrics")
    _close(got["state"], want["state"], tol, "state")
    other = ranks[1]["dp"][trainer, dtype]
    assert other["metrics"] == got["metrics"]
    for k, v in got["state"].items():
        np.testing.assert_array_equal(other["state"][k], v, err_msg=k)


def test_multitask_egs_files_hold_rank_zero_counts(port_run):
    """On 2 ranks each counts its own egs and rank 0 writes its local counts,
    as the JAX trainer's process 0 does (a 1/nproc sample, not the sum);
    on 1 rank the files hold that rank's counts."""
    ranks, ref = port_run
    r0, r1 = ranks[0]["egs"], ranks[1]["egs"]
    assert ranks[1]["egs"]["files"] == {}
    for name in ("speaker_egs", "phone_egs"):
        np.testing.assert_array_equal(r0["files"][name], r0[name])
        assert r1[name].sum() > 0
        assert not np.array_equal(r0["files"][name], r0[name] + r1[name])
        np.testing.assert_array_equal(ref["egs"]["files"][name], ref["egs"][name])
    # 2 speakers a rank x 4 steps; 4 speakers x 4 steps on one rank
    assert r0["speaker_egs"].sum() == r1["speaker_egs"].sum() == 8
    assert ref["egs"]["speaker_egs"].sum() == 16


def test_valid_loss_unbiased_by_rank_padding(port_run):
    """A 13-row batch on 2 ranks (padded to 14, the pad row weighted 0)
    gives 1 rank's validation loss (tests/test_parallel_modes.py)."""
    ranks, ref = port_run
    want, rows = ref["valid"]
    assert rows == 13
    for r in ranks:
        loss, real = r["valid"]
        assert real in (6.0, 7.0)
        assert loss == pytest.approx(want, rel=1e-6)
    assert sum(r["valid"][1] for r in ranks) == 13


def test_model_parallel_matches_one_block_and_jax(port_run):
    """``model_parallel=2``: the loss and the update of one step equal
    ``model_parallel=1``'s and the JAX step's on a (1, 2) mesh at rel
    1e-5, on both ranks."""
    ranks, ref = port_run
    mp1, jax_mp = ref["mp1"], ref["jax_mp"]
    for r in ranks:
        got = r["mp"]
        for key in ("loss", "regularization_loss", "accuracy"):
            assert got["metrics"][key] == pytest.approx(mp1["metrics"][key], rel=1e-5), key
            assert got["metrics"][key] == pytest.approx(jax_mp["metrics"][key], rel=1e-5), key
        params = {k: v for k, v in got["tree"].items() if k.startswith("params/")}
        _close(params, {k: mp1["tree"][k] for k in params}, dict(rtol=1e-5, atol=1e-7),
               "mp=1")
        _close(params, jax_mp["params"], dict(rtol=1e-5, atol=1e-6), "jax")


def test_data_and_model_parallel_mesh_matches_one_rank(port_run):
    """4 ranks as a (data 2, model 2) mesh: each data rank's half of the rows
    and each model rank's half of the kernel give one rank's step, on every
    rank: the loss at rel 1e-5, the state after it at the float32 bounds
    (BatchNorms over 4 rows a rank amplify float32 reassociation)."""
    _, ref = port_run
    mp1 = ref["mp1"]
    for r in ref["mesh4"]:
        assert r["metrics"]["loss"] == pytest.approx(mp1["metrics"]["loss"], rel=1e-5)
        assert r["metrics"]["accuracy"] == pytest.approx(mp1["metrics"]["accuracy"], rel=1e-5)
        got = {k: v for k, v in r["tree"].items() if not k.startswith("opt_state")}
        _close(got, {k: mp1["tree"][k] for k in got}, F32, "mesh4")


def test_model_parallel_checkpoint_round_trip(port_run):
    """The split kernel's checkpoint holds the whole kernel (and its
    momentum) in the JAX layout, equal to the state joined in memory, and
    loads back into each rank's blocks."""
    ranks, _ = port_run
    for rank, r in enumerate(ranks):
        got = r["mp"]
        assert got["saved"]["params/softmax/output_kernel"].shape == (12, SPEAKERS)
        assert got["saved"]["opt_state/trace/softmax/output_kernel"].shape == (12, SPEAKERS)
        for k, v in got["tree"].items():
            np.testing.assert_array_equal(got["saved"][k], v, err_msg=k)
        assert got["blocks"]["params/softmax/output_kernel"].shape == (12, SPEAKERS // 2)
        np.testing.assert_array_equal(
            got["blocks"]["params/softmax/output_kernel"],
            got["saved"]["params/softmax/output_kernel"][:, rank * 3:(rank + 1) * 3])
        _close(got["reloaded"], got["blocks"], dict(rtol=0, atol=0), "reloaded")


@pytest.mark.parametrize("index,length", [(0, 1000), (1, 333)], ids=["even", "uneven"])
def test_sp_embed_matches_jax_and_full_forward(port_run, index, length):
    ranks, ref = port_run
    for r in ranks:
        got = r["sp"][index]
        np.testing.assert_allclose(got, ref["sp_jax"][index], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, ref["sp_full"][index], rtol=5e-3, atol=5e-4)
    np.testing.assert_array_equal(ranks[0]["sp"][index], ranks[1]["sp"][index])


@pytest.fixture(scope="module")
def epoch_runs_pair(tmp_path_factory):
    """The JAX package's 2-process epochs (streaming and sharded pool), then
    the port's 2 ranks from the JAX initial checkpoints."""
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    work = str(tmp_path_factory.mktemp("epochs"))
    make_fake_data_dir(os.path.join(work, "train"), num_speakers=SPEAKERS, utts_per_speaker=4,
                       dim=DIM, min_len=60, max_len=150, seed=5)
    make_fake_data_dir(os.path.join(work, "valid"), num_speakers=SPEAKERS, utts_per_speaker=2,
                       dim=DIM, min_len=60, max_len=150, seed=6, compress=False)
    _check_ok(spawn("jax_epochs", work))
    for kind in ("stream", "pool"):
        # the port's run starts from the JAX run's initial checkpoint
        model_dir = os.path.join(work, "epoch_%s_float32_w2" % kind)
        os.makedirs(model_dir)
        shutil.copy(os.path.join(work, "jax_" + kind, "nnet0", "model-0.msgpack"), model_dir)
    _check_ok(spawn("epochs", work))
    jax_out = [np.load(os.path.join(work, "jax%d.npy" % r), allow_pickle=True).item()
               for r in range(2)]
    port = [torch.load(os.path.join(work, "epochs%d.pt" % r), weights_only=False)
            for r in range(2)]
    return jax_out, port


@pytest.mark.parametrize("kind", ["stream", "pool"])
def test_two_rank_epoch_matches_jax_two_processes(epoch_runs_pair, kind):
    """An epoch of 4 steps in groups of 2 and a validation pass on 2 ranks
    land on the JAX package's 2-process result (tests/test_multihost.py):
    the parameters and statistics, the step and the valid loss; the ranks
    agree bit for bit; the sharded pool stages one shard a rank."""
    jax_out, port = epoch_runs_pair
    want = jax_out[0][kind]
    assert jax_out[1][kind]["valid_loss"] == want["valid_loss"]
    for rank, r in enumerate(port):
        got = r[kind]
        assert got["step"] == want["step"] == 4
        assert got["n_emb"] == want["n_emb"]
        assert got["valid_loss"] == pytest.approx(want["valid_loss"], rel=1e-5)
        for path, w in want["state"].items():
            if path.endswith("bias") and path.split("/")[-2].endswith(("_conv", "_dense")):
                continue  # zero gradient before a BatchNorm: rounding noise on both sides
            np.testing.assert_allclose(got["state"][path], w, err_msg=path, **F32)
        if kind == "pool":
            assert got["shard"][:2] == [rank, 2] and got["shard"][2] > 0
    for k, v in port[0][kind]["state"].items():
        np.testing.assert_array_equal(port[1][kind]["state"][k], v, err_msg=k)
    assert port[0][kind]["valid_loss"] == port[1][kind]["valid_loss"]


def test_sigterm_to_one_rank_stops_both(tmp_path):
    """SIGTERM to rank 1 of a 2-rank ``cli.train`` at its first group: the
    collective poll stops both at the same step, rank 0 writes one
    checkpoint there, and both exit 75 (tests/test_multihost.py:336)."""
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    work = str(tmp_path)
    make_fake_data_dir(os.path.join(work, "train"), num_speakers=SPEAKERS, utts_per_speaker=4,
                       dim=DIM, min_len=60, max_len=150, seed=5)
    with open(os.path.join(work, "pre.json"), "w") as f:
        json.dump(dict(TINY, num_steps_per_epoch=8, num_epochs=1, learning_rate=LR), f)
    results = spawn("preempt", work)
    for rank, (rc, out) in enumerate(results):
        assert rc == 75, "rank %d exited %d:\n%s" % (rank, rc, out[-4000:])
    nnet = os.path.join(work, "exp", "nnet")
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(nnet, "model-*"))) == [
        "model-2.pt"]
    assert not os.path.exists(os.path.join(nnet, "valid_loss"))


# --------------------------------------------------------------------------
# In one process: the samplers' shared length stream, the pool's shards,
# a speaker count that does not divide model_parallel
# --------------------------------------------------------------------------
def _assert_equal_batches(got, want):
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for name in w:
                np.testing.assert_array_equal(g[name], w[name])
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["multi", "v2"])
def test_length_seed_samplers_match_jax(tmp_path, monkeypatch, kind):
    """A data rank's sampler (seed ``seed + d * 7919``, the shared
    ``length_seed``) gives the JAX sampler's batches bit for bit; two ranks'
    samplers draw the same lengths from different rows."""
    from tf_kaldi_speaker_tpu import data as jdata
    from tf_kaldi_speaker_tpu.kio import native_decode as jnd
    from tf_kaldi_speaker_tpu.multitask import data_v2 as jv2
    from tf_kaldi_speaker_tpu_torch import data as tdata
    from tf_kaldi_speaker_tpu_torch.multitask import data_v2 as tv2
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir
    from test_torch_trainer_mi import write_aux_dir

    # the JAX package's numpy codec (its native reader rounds differently)
    monkeypatch.setattr(jnd, "_get_lib", lambda: None)
    d = make_fake_data_dir(str(tmp_path / "main"), num_speakers=SPEAKERS, utts_per_speaker=3,
                           dim=DIM, min_len=60, max_len=150, seed=5, with_vad_ali=kind == "v2",
                           num_phones=PHONES)
    if kind == "multi":
        aux = {"bnf": write_aux_dir(d["data"], str(tmp_path / "bnf"), BNF, 1)}

        def make(m, seed):
            return m.MultiRandomChunkSampler(d["data"], aux, d["spklist"], 2, 2, 40, 56,
                                             seed=seed, length_seed=9, group=2)

        mods = (tdata, jdata)
    else:
        def make(m, seed):
            return m.RandomChunkSamplerV2(d["data"], d["ali_dir"], d["spklist"], 11, 11, 2, 2,
                                          40, 56, seed=seed, length_seed=9, group=2)

        mods = (tv2, jv2)
    for rank in (0, 1):
        got, want = (iter(make(m, 9 + rank * 7919)) for m in mods)
        for _ in range(3):
            _assert_equal_batches(next(got), next(want))
    ranks = [iter(make(mods[0], 9 + rank * 7919)) for rank in (0, 1)]
    for _ in range(4):
        a, b = next(ranks[0]), next(ranks[1])
        main_a, main_b = (x[0]["features"] if kind == "multi" else x[0] for x in (a, b))
        assert main_a.shape == main_b.shape
        assert not np.array_equal(main_a, main_b)


def test_sharded_pool_shards_match_jax(tmp_path):
    """Each rank's ``ShardedDevicePool`` (2 shards) stages the block, the
    utterance table and the speakers that the JAX pool on a 2-device mesh
    holds for that shard, over every rotation window; its rows come from
    its own speakers only."""
    import random

    import jax

    from tf_kaldi_speaker_tpu.data import device_pool as jpool
    from tf_kaldi_speaker_tpu.parallel.mesh import make_mesh as jax_mesh
    from tf_kaldi_speaker_tpu_torch.data import device_pool as tpool
    from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

    d = make_fake_data_dir(str(tmp_path / "cm"), num_speakers=SPEAKERS, utts_per_speaker=3,
                           dim=DIM, min_len=60, max_len=150, seed=5)
    with open(os.path.join(d["data"], "utt2num_frames")) as f:
        frames = sum(int(line.split()[1]) for line in f)
    kw = dict(budget_bytes=int(0.6 * (frames * DIM + 18 * 16 * DIM)), seed=11,
              chunk_frames=56)
    jp = jpool.ShardedDevicePool(d["data"], d["spklist"], jax_mesh(jax.devices()[:2]), **kw)
    ports = [tpool.ShardedDevicePool(d["data"], d["spklist"], num_shards=2, shard=r,
                                     device="cpu", **kw) for r in (0, 1)]
    assert jp.rotation_rounds == ports[0].rotation_rounds == 2
    for window in range(2):
        jp.stage(window)
        frames_j, headers_j = np.asarray(jp.frames), np.asarray(jp.headers)
        for r, tp in enumerate(ports):
            tp.stage(window)
            assert (tp.cap_f, tp.cap_n) == (jp.cap_f, jp.cap_n)
            np.testing.assert_array_equal(tp.frames.numpy(),
                                          frames_j[r * jp.cap_f:(r + 1) * jp.cap_f])
            np.testing.assert_array_equal(tp.headers.numpy(),
                                          headers_j[r * jp.cap_n:(r + 1) * jp.cap_n])
            assert tp.spk2utts == jp.shard_spk2utts[r]
            np.testing.assert_array_equal(tp.utt_len, jp.shard_utt_len[r])
            np.testing.assert_array_equal(tp.utt_offset, jp.shard_utt_offset[r])
            starts, utts, labels = tp.sample_group(random.Random(r), 2, 4, 2, 48)
            assert starts.shape == (2, 4) and set(labels.ravel()) <= set(tp.spk2utts)
            assert np.all(starts + 48 <= tp.utt_offset[utts] + tp.utt_len[utts])
    for tp in ports:
        tp.close()
    jp.close()


def test_speakers_not_dividing_model_parallel_raise(tmp_path):
    """Like JAX, which refuses to place a kernel of 7 columns on a 2-way
    model axis (ValueError from ``device_put``), the port refuses to split
    it."""
    import types

    import jax

    from tf_kaldi_speaker_tpu.parallel.mesh import make_mesh as jax_mesh
    from tf_kaldi_speaker_tpu.train.trainer import Trainer as JaxTrainer
    from tf_kaldi_speaker_tpu.utils.params import ParamsPlain as JaxParams
    from tf_kaldi_speaker_tpu_torch.parallel import shard_model
    from tf_kaldi_speaker_tpu_torch.train.trainer import XVectorModel

    cfg = dict(TINY, model_parallel=2)
    jt = JaxTrainer(JaxParams(**cfg), str(tmp_path / "jax"), dim=DIM, num_speakers=7,
                    mesh=jax_mesh(jax.devices()[:2], model_parallel=2))
    with pytest.raises(ValueError, match="divisible by 2"):
        jt.build("train", DIM, cfg["loss_func"], 7)
    mesh = types.SimpleNamespace(world=2, model_size=2, model_rank=0, data_size=1,
                                 data_group=None, model_group=None)
    with pytest.raises(ValueError, match="does not divide model_parallel=2"):
        shard_model(XVectorModel(cfg, cfg["loss_func"], 7, DIM), mesh)
    model = shard_model(XVectorModel(cfg, cfg["loss_func"], 8, DIM), mesh)
    assert tuple(model.softmax.output_kernel.shape) == (12, 4)


if __name__ == "__main__":
    WORKERS[sys.argv[1]](*sys.argv[2:])
    # leave the process group before the interpreter's exit tears down
    # gloo's threads (a rank can abort there, "terminate called without an
    # active exception", when the host is loaded)
    from tf_kaldi_speaker_tpu_torch import parallel

    parallel.shutdown()
