"""The port's device pool and data modules against the JAX package on the
CPU: the pool's index triples for one seed, fully resident and rotating
(R = 2), and the gathered + dequantized batches; a trainer epoch fed from
the pool against the JAX Trainer's; and the copied framework-free modules
(speaker index, reader, samplers, the synthetic data dir, metrics,
bookkeeping), equal to their originals."""

import filecmp
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu import data as jdata
from tf_kaldi_speaker_tpu.backend import metrics as jmetrics
from tf_kaldi_speaker_tpu.data import device_pool as jpool
from tf_kaldi_speaker_tpu.kio.reader import FeatureReader as JaxReader
from tf_kaldi_speaker_tpu.ops.cm_dequant_pallas import cm_dequantize_jnp
from tf_kaldi_speaker_tpu.parallel.mesh import make_mesh
from tf_kaldi_speaker_tpu.train.trainer import Trainer as JaxTrainer
from tf_kaldi_speaker_tpu.utils import bookkeeping as jbk
from tf_kaldi_speaker_tpu.utils.params import ParamsPlain as JaxParams
from tf_kaldi_speaker_tpu.utils.testdata import make_fake_data_dir as jax_fake_dir
from tf_kaldi_speaker_tpu_torch import convert
from tf_kaldi_speaker_tpu_torch import data as tdata
from tf_kaldi_speaker_tpu_torch.backend import metrics as tmetrics
from tf_kaldi_speaker_tpu_torch.data import device_pool as tpool
from tf_kaldi_speaker_tpu_torch.kio.reader import FeatureReader as PortReader
from tf_kaldi_speaker_tpu_torch.ops.cm_dequant import cm_dequantize
from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
from tf_kaldi_speaker_tpu_torch.utils import bookkeeping as tbk
from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain
from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir

torch.set_num_threads(1)

DIM = 10
# The JAX package decodes chunks with its native reader where that is built,
# whose dequantization rounds differently from the numpy codec that the port
# copies (bit-equal to it, tests/test_torch_kio.py): one float32 ulp.
DECODE_TOL = dict(rtol=1e-6, atol=1e-6)
TINY = dict(
    seed=3, network_type="tdnn", tdnn_layer_size=16, num_nodes_pooling_layer=24,
    num_nodes_last_layer=12, pooling_type="statistics_pooling", embedding_node="tdnn6_dense",
    last_layer_linear=True, loss_func="additive_margin_softmax", amsoftmax_m=0.2,
    amsoftmax_lambda_min=0, amsoftmax_lambda_base=1000, amsoftmax_lambda_gamma=1e-4,
    amsoftmax_lambda_power=5, optimizer="momentum", momentum=0.9, weight_l2_regularizer=1e-2,
    batchnorm_momentum=0.99, use_fused_pooling=True, device_pool=True,
    num_speakers_per_batch=4, num_segments_per_speaker=2, min_segment_len=48,
    max_segment_len=48, num_steps_per_epoch=4, steps_per_dispatch=2,
    show_training_progress=0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Compressed (for the pool) and uncompressed data dirs."""
    root = tmp_path_factory.mktemp("pool")
    cm = make_fake_data_dir(str(root / "cm"), num_speakers=6, utts_per_speaker=3, dim=DIM,
                            min_len=60, max_len=150, seed=5)
    fm = make_fake_data_dir(str(root / "fm"), num_speakers=3, utts_per_speaker=2, dim=DIM,
                            min_len=60, max_len=150, seed=6, compress=False)
    return cm, fm


def _corpus_bytes(d):
    """The pool bytes of the whole corpus: codes plus 4 f32 headers per column."""
    with open(os.path.join(d["data"], "utt2num_frames")) as f:
        frames = [int(line.split()[1]) for line in f]
    return sum(frames) * DIM + len(frames) * 16 * DIM


# ---------------------------------------------------------------- the pool

@pytest.mark.parametrize("rotating", [False, True], ids=["resident", "rotating"])
def test_pool_index_triples_and_batches_match_jax(corpus, rotating):
    """One seed gives the JAX pool's (start, utt, label) triples for every
    group, in every rotation window; the chunks gathered on either side and
    dequantized are equal."""
    cm = corpus[0]
    budget = int(0.6 * _corpus_bytes(cm)) if rotating else None
    kw = dict(budget_bytes=budget, seed=11, chunk_frames=56)
    jp = jpool.DevicePool(cm["data"], cm["spklist"], **kw)
    tp = tpool.DevicePool(cm["data"], cm["spklist"], device="cpu", **kw)
    assert tp.rotation_rounds == jp.rotation_rounds == (2 if rotating else 1)
    for round_id in range(tp.rotation_rounds):
        jp.stage(round_id)
        tp.stage(round_id)
        assert tp.frames.dtype == torch.uint8 and tuple(tp.frames.shape) == jp.frames.shape
        np.testing.assert_array_equal(tp.frames.numpy(), np.asarray(jp.frames))
        np.testing.assert_array_equal(tp.headers.numpy(), np.asarray(jp.headers))
        jr, tr = random.Random(7), random.Random(7)
        for length in (48, 56):
            want = jp.sample_group(jr, 3, 4, 2, length)
            got = tp.sample_group(tr, 3, 4, 2, length)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            starts, utts, _ = got
            for k in range(3):
                jc, jh = jpool.gather_chunks(jp.frames, jp.headers, jnp.asarray(starts[k]),
                                             jnp.asarray(utts[k]), length)
                tc, th = tpool.gather_chunks(tp.frames, tp.headers,
                                             torch.from_numpy(starts[k]),
                                             torch.from_numpy(utts[k]), length)
                np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
                np.testing.assert_allclose(cm_dequantize(tc, th).numpy(),
                                           np.asarray(cm_dequantize_jnp(jc, jh)),
                                           rtol=1e-6, atol=1e-6)
    tp.close()
    jp.close()


def test_trainer_epoch_from_pool_matches_jax(corpus, tmp_path):
    """The slice as a whole on the CPU: one float32 epoch of 4 steps in
    groups of 2 from the device pool, from the JAX Trainer's initial
    variables, lands on the JAX Trainer's parameters, statistics and step."""
    cm = corpus[0]
    jt = JaxTrainer(JaxParams(**TINY), str(tmp_path / "jax"), dim=DIM, num_speakers=6,
                    mesh=make_mesh(devices=jax.devices()[:1]))
    jt.build("train", DIM, TINY["loss_func"], 6)
    v0 = {"params": jax.device_get(jt.state.params),
          "batch_stats": jax.device_get(jt.state.batch_stats)}
    t = Trainer(ParamsPlain(**TINY), str(tmp_path / "port"), dim=DIM, num_speakers=6,
                device="cpu")
    t.build("train", DIM, TINY["loss_func"], 6)
    convert.load_variables(t.network_model, v0)
    jt.train(cm["data"], cm["spklist"], 0.02)
    t.train(cm["data"], cm["spklist"], 0.02)
    t.close()
    assert t.step == int(jt.state.step) == 4
    want = convert.flatten({"params": jax.device_get(jt.state.params),
                            "batch_stats": jax.device_get(jt.state.batch_stats)})
    got = convert.flatten(convert.variables_of(t.network_model))
    for path, w in want.items():
        if path[-1] == "bias" and path[-2].endswith(("_conv", "_dense")):
            continue  # zero gradient before a BatchNorm: rounding noise on both sides
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg="/".join(path))
    assert os.path.exists(tmp_path / "port" / "model-4.pt")


def test_unported_train_paths_raise(corpus, tmp_path):
    """``pool_sharded: true`` on one rank (a one-shard ``ShardedDevicePool``)
    trains as the JAX Trainer does with its ``ShardedDevicePool`` on a
    one-device mesh: the same parameters, statistics and step after an
    epoch of 4 steps in groups of 2 from the JAX initial variables. The
    streaming loader, fine-tuning and end2end validation are ported
    (tests/test_torch_stream.py, tests/test_torch_finetune.py,
    tests/test_torch_triplet_train.py): an end2end validation of this
    softmax-family config gives a finite loss."""
    cm = corpus[0]
    cfg = dict(TINY, pool_sharded=True, num_valid_speakers_per_batch=3,
               num_valid_segments_per_speaker=2, valid_max_iterations=2)
    jt = JaxTrainer(JaxParams(**cfg), str(tmp_path / "jax"), dim=DIM, num_speakers=6,
                    mesh=make_mesh(devices=jax.devices()[:1]))
    jt.build("train", DIM, cfg["loss_func"], 6)
    v0 = {"params": jax.device_get(jt.state.params),
          "batch_stats": jax.device_get(jt.state.batch_stats)}
    t = Trainer(ParamsPlain(**cfg), str(tmp_path / "port"), dim=DIM, num_speakers=6,
                device="cpu")
    t.build("train", DIM, cfg["loss_func"], 6)
    convert.load_variables(t.network_model, v0)
    jt.train(cm["data"], cm["spklist"], 0.02)
    t.train(cm["data"], cm["spklist"], 0.02)
    assert isinstance(jt._device_pool, jpool.ShardedDevicePool)
    assert isinstance(t._device_pool, tpool.ShardedDevicePool)
    assert t._device_pool.num_shards == 1
    assert t.step == int(jt.state.step) == 4
    want = convert.flatten({"params": jax.device_get(jt.state.params),
                            "batch_stats": jax.device_get(jt.state.batch_stats)})
    got = convert.flatten(convert.variables_of(t.network_model))
    for path, w in want.items():
        if path[-1] == "bias" and path[-2].endswith(("_conv", "_dense")):
            continue  # zero gradient before a BatchNorm: rounding noise on both sides
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg="/".join(path))
    t.build("valid", DIM, cfg["loss_func"], 6)
    loss, _, _ = t.valid(cm["data"], cm["spklist"], batch_type="end2end")
    assert np.isfinite(loss)
    t.close()


# ---------------------------------------------------------------- the copies

def test_make_fake_data_dir_is_byte_equal(tmp_path):
    for compress in (True, False):
        kw = dict(num_speakers=3, utts_per_speaker=2, dim=7, min_len=30, max_len=50, seed=2,
                  compress=compress, chan_scale=0.5)
        a = make_fake_data_dir(str(tmp_path / ("port%d" % compress)), **kw)
        b = jax_fake_dir(str(tmp_path / ("jax%d" % compress)), **kw)
        for key in ("utt2num_frames", "spk2utt", "utt2spk", "spklist"):
            assert filecmp.cmp(a[key], b[key], shallow=False), key
        assert filecmp.cmp(os.path.join(a["data"], "feats.ark"),
                           os.path.join(b["data"], "feats.ark"), shallow=False)


def test_speaker_index_is_equal(corpus):
    cm = corpus[0]
    assert tdata.get_speaker_info(cm["data"], cm["spklist"]) == jdata.get_speaker_info(
        cm["data"], cm["spklist"])
    aux = {"aux": corpus[0]["data"]}
    assert tdata.get_aux_speaker_info(cm["data"], aux, cm["spklist"]) == \
        jdata.get_aux_speaker_info(cm["data"], aux, cm["spklist"])


@pytest.mark.parametrize("kind", [0, 1], ids=["compressed", "float"])
def test_reader_is_equal(corpus, kind):
    d = corpus[kind]
    tr, jr = PortReader(d["data"]), JaxReader(d["data"])
    assert tr.dim == jr.dim == DIM and tr.utt2num_frames == jr.utt2num_frames
    with open(d["feats_scp"]) as f:
        segs = [line.strip() for line in f]
    def calls(i):  # each reader draws from its own generator of one seed
        return (dict(), dict(length=40, shuffle=True, rng=random.Random(i)),
                dict(length=33, start=5))

    for i, seg in enumerate(segs):
        for call in ("read", "read_segment"):
            for kt, kj in zip(calls(i), calls(i)):
                (a, sa), (b, sb) = getattr(tr, call)(seg, **kt), getattr(jr, call)(seg, **kj)
                np.testing.assert_allclose(a, b, **DECODE_TOL)
                assert sa == sb
        if kind == 0:
            for kt, kj in zip(calls(i), calls(i)):
                got, want = tr.read_segment_codes(seg, **kt), jr.read_segment_codes(seg, **kj)
                for g, w in zip(got[:2], want[:2]):
                    np.testing.assert_array_equal(g, w)
                assert got[2] == want[2]
    tr.close()
    jr.close()


@pytest.mark.parametrize("raw_codes,group", [(False, 1), (True, 1), (False, 2)])
def test_random_sampler_draws_are_equal(corpus, raw_codes, group):
    cm = corpus[0]
    kw = dict(num_speakers=4, num_segments=2, min_len=40, max_len=56, seed=9,
              raw_codes=raw_codes, group=group)
    ts = tdata.RandomChunkSampler(cm["data"], cm["spklist"], **kw)
    js = jdata.RandomChunkSampler(cm["data"], cm["spklist"], **kw)
    for _, got, want in zip(range(3), ts, js):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if g.dtype == np.float32 and g.ndim > 2:
                np.testing.assert_allclose(g, w, **DECODE_TOL)
            else:  # labels, raw codes and headers: exact
                np.testing.assert_array_equal(g, w)
    ts.close()
    js.close()


def test_sequential_loaders_are_equal(corpus):
    cm = corpus[0]
    kw = dict(batch_size=5, min_len=40, max_len=120, seed=4)
    ts = tdata.SequentialChunkSampler(cm["data"], cm["spklist"], **kw)
    js = jdata.SequentialChunkSampler(cm["data"], cm["spklist"], **kw)
    got, want = list(ts), list(js)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], **DECODE_TOL)
        np.testing.assert_array_equal(g[1], w[1])
    tq = tdata.KaldiDataSeqQueue(cm["data"], cm["spklist"], num_parallel=1, **kw).start()
    jq = jdata.KaldiDataSeqQueue(cm["data"], cm["spklist"], num_parallel=1, **kw).start()
    try:
        for _ in range(4):
            (a, la), (b, lb) = tq.fetch(), jq.fetch()
            np.testing.assert_allclose(a, b, **DECODE_TOL)
            np.testing.assert_array_equal(la, lb)
        with pytest.raises(tdata.DataOutOfRange):
            tq.fetch()
    finally:
        tq.stop()
        jq.stop()
    for args in ((200, 400, 8), (40, 56, 8), (48, 48, 8), (300, 310, 3)):
        assert tdata.bucket_lengths(*args) == jdata.bucket_lengths(*args)


def test_metrics_are_equal():
    rng = np.random.RandomState(0)
    emb = rng.randn(30, 6)
    labels = rng.randint(0, 5, 30)
    scores, trials = rng.randn(200), rng.rand(200) > 0.7
    for a, b in zip(tmetrics.det_curve(scores, trials), jmetrics.det_curve(scores, trials)):
        np.testing.assert_array_equal(a, b)
    assert tmetrics.compute_eer(scores, trials) == jmetrics.compute_eer(scores, trials)
    for max_pairs in (None, 100):
        assert tmetrics.compute_cos_pairwise_eer(emb, labels, max_pairs) == \
            jmetrics.compute_cos_pairwise_eer(emb, labels, max_pairs)


def test_bookkeeping_files_are_equal(tmp_path):
    lr, valid = str(tmp_path / "learning_rate"), str(tmp_path / "valid_loss")
    for epoch, rate, loss in ((1, 0.01, 2.5), (2, 0.005, 2.25)):
        tbk.append_lr(lr, epoch, rate)
        tbk.append_valid_loss(valid, epoch, loss, 0.125)
    assert tbk.load_lr_file(lr) == jbk.load_lr_file(lr) == {1: 0.01, 2: 0.005}
    assert tbk.load_valid_loss(valid) == jbk.load_valid_loss(valid)
    assert tbk.load_learning_rate_schedule(lr, 2) == jbk.load_learning_rate_schedule(lr, 2)
    assert tbk.load_learning_rate_schedule(0.1, 2) is None
    tbk.write_scalar_file(str(tmp_path / "dim"), 30)
    assert jbk.read_scalar_file(str(tmp_path / "dim")) == tbk.read_scalar_file(
        str(tmp_path / "dim")) == 30
