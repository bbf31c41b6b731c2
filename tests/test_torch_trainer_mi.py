"""The multi-input trainer of the port against the JAX package's on the CPU
(the cases of tests/test_trainer_mi.py, with the JAX trainer's initial
variables carried across by ``convert.py``, the first layer wider by the
concatenated aux streams):

- ``MultiRandomChunkSampler`` / ``MultiSequentialChunkSampler`` and the
  ``KaldiMulti*Queue`` loaders give the JAX package's batches bit for bit
  (the JAX native reader off, so both sides decode with the numpy codec's
  rounding, which the port's native reader keeps);
- a 2-step epoch of ``TrainerMultiInput.train`` (groups of 2): the group
  loss within rtol 2e-4 and the updated parameters within rtol 2e-4 /
  atol 1e-5 (the biases that a BatchNorm follows carry only rounding noise
  and are left out); the validation loss over every batch within rtol
  2e-4; the embeddings (per column, as multisets: two loader workers
  order them) and ``predict`` within rtol 1e-3 / atol 5e-4 (they read
  parameters 2 steps apart by up to rtol 2e-4); an aux stream changes the
  embedding;
- the aux rank check;
- a self-attention pooling that taps ``aux_bnf`` and an ECAPA-TDNN with two
  aux streams (concatenated in sorted order): 2 train steps, losses within
  rtol 2e-4 and parameters within rtol 2e-4 / atol 1e-5 (ECAPA's: atol
  5e-5, its train-mode BatchNorms over 4 rows amplify float32 rounding);
- the BNF chain through the port's CLIs with ``--device cpu``:
  ``extract_bnf`` from a JAX-trained checkpoint against the JAX CLI (the
  same scp and ark layout, the matrices within rtol 1e-5 / atol 1e-5: the
  two frameworks' float32 convolutions sum in different orders, so the
  bytes of the values differ), then ``prepare_feats --no-cmvn``,
  ``train_mi`` and ``extract_mi``;
- the witness for that gap: in float64 the JAX network on the JAX CLI's
  zero-padded length bucket, on the unpadded input, and the port's network
  agree within 1e-12 on frames [0:T], and each CLI's float32 ark lies
  within rtol/atol 1e-5 of that float64 function;
- ``extract_bnf --compress``: the same layout and size as the JAX CLI's,
  every value within one quantization step of its column.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu import data as jdata
from tf_kaldi_speaker_tpu.kio import native_decode as jnd
from tf_kaldi_speaker_tpu.parallel.mesh import make_mesh
from tf_kaldi_speaker_tpu.train.trainer import XVectorModel as JaxXVectorModel
from tf_kaldi_speaker_tpu.train.trainer_mi import TrainerMultiInput as JaxMI
from tf_kaldi_speaker_tpu.utils.params import ParamsPlain as JaxParams
from tf_kaldi_speaker_tpu_torch import convert
from tf_kaldi_speaker_tpu_torch import data as tdata
from tf_kaldi_speaker_tpu_torch.kio import ark, read_mat_scp, read_vec_flt_scp
from tf_kaldi_speaker_tpu_torch.train.trainer_mi import TrainerMultiInput
from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain
from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir
from test_torch_zoo_networks import ECAPA
from test_torch_zoo_pooling import bn_follows

torch.set_num_threads(1)

DIM, BNF, SPEAKERS, LR = 10, 8, 6, 0.05
CFG = dict(
    seed=0, network_type="tdnn", tdnn_layer_size=16, num_nodes_pooling_layer=24,
    num_nodes_last_layer=12, pooling_type="statistics_pooling", embedding_node="tdnn6_dense",
    loss_func="softmax", learning_rate=LR, optimizer="momentum", momentum=0.9,
    weight_l2_regularizer=1e-4, batchnorm_momentum=0.99, num_steps_per_epoch=2,
    steps_per_dispatch=2, show_training_progress=1, save_checkpoints_steps=2,
    keep_checkpoint_max=3, valid_max_iterations=100, num_parallel_datasets=1,
    max_queue_size=4, num_speakers_per_batch=4, num_segments_per_speaker=1,
    min_segment_len=40, max_segment_len=56, aux_feature_dim={"bnf": BNF},
    aux_concat_input=["bnf"])


@pytest.fixture(autouse=True)
def jax_numpy_decode(monkeypatch):
    monkeypatch.setattr(jnd, "_get_lib", lambda: None)


def write_aux_dir(main, path, dim, seed):
    """An aux data dir frame-aligned with ``main``: compressed [T, dim]
    matrices (a projection of the main features plus noise) under the same
    keys, frame counts and speaker maps."""
    os.makedirs(path)
    rng = np.random.RandomState(seed)
    ark_path = os.path.join(path, "feats.ark")
    lines = []
    with open(ark_path, "wb") as f:
        for key, m in read_mat_scp(os.path.join(main, "feats.scp")):
            proj = rng.randn(m.shape[1], dim).astype(np.float32) * 0.3
            pos = f.tell() + len(key) + 1
            ark.write_mat(f, (m @ proj + rng.randn(m.shape[0], dim)).astype(np.float32),
                          key=key, compress=True)
            lines.append("%s %s:%d" % (key, ark_path, pos))
    with open(os.path.join(path, "feats.scp"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for name in ("utt2num_frames", "spk2utt", "utt2spk"):
        shutil.copyfile(os.path.join(main, name), os.path.join(path, name))
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("mi")
    d = make_fake_data_dir(str(root / "main"), num_speakers=SPEAKERS, utts_per_speaker=3,
                           dim=DIM, min_len=60, max_len=150, seed=5)
    d["aux"] = {"bnf": write_aux_dir(d["data"], str(root / "bnf"), BNF, 1),
                "asr": write_aux_dir(d["data"], str(root / "asr"), 5, 2)}
    return d


def _assert_batches_equal(got, want):
    gf, gl = got
    wf, wl = want
    np.testing.assert_array_equal(gl, wl)
    assert sorted(gf) == sorted(wf)
    for name in wf:
        assert gf[name].dtype == wf[name].dtype
        np.testing.assert_array_equal(gf[name], wf[name])


@pytest.mark.parametrize("kind", ["random1", "random2", "sequential"])
def test_multi_samplers_match_jax(corpus, kind):
    aux = corpus["aux"]
    if kind == "sequential":
        kw = dict(batch_size=5, min_len=40, max_len=56, seed=4)
        cls = "MultiSequentialChunkSampler"
    else:
        kw = dict(num_speakers=4, num_segments=2, min_len=40, max_len=56, seed=9,
                  group=int(kind[-1]))
        cls = "MultiRandomChunkSampler"
    port = getattr(tdata, cls)(corpus["data"], aux, corpus["spklist"], **kw)
    want = getattr(jdata, cls)(corpus["data"], aux, corpus["spklist"], **kw)
    n = 0
    for g, w in zip(port, want):
        _assert_batches_equal(g, w)
        n += 1
        if n == 3:
            break
    assert n == 3
    port.close()
    want.close()


@pytest.mark.parametrize("kind", ["random", "sequential"])
def test_multi_queues_match_jax(corpus, kind):
    """The random queue's first three groups (one worker); every batch of the
    sequential queue over its two workers' shards, as multisets."""
    if kind == "random":
        kw = dict(num_parallel=1, max_qsize=2, num_speakers=4, min_len=40, max_len=56,
                  seed=3, group=2)
        queues = [m.KaldiMultiDataRandomQueue(corpus["data"], corpus["aux"], corpus["spklist"],
                                              **kw).start() for m in (tdata, jdata)]
        try:
            assert queues[0].num_total_speakers == queues[1].num_total_speakers == SPEAKERS
            for _ in range(3):
                _assert_batches_equal(queues[0].fetch(), queues[1].fetch())
        finally:
            for q in queues:
                q.stop()
        return
    kw = dict(num_parallel=2, batch_size=4, min_len=40, max_len=56, shuffle=True, seed=2)
    got = []
    for m in (tdata, jdata):
        q = m.KaldiMultiDataSeqQueue(corpus["data"], corpus["aux"], corpus["spklist"],
                                     **kw).start()
        batches = list(q)
        q.stop()
        got.append(sorted(batches, key=lambda b: (b[1].tobytes(), b[0]["features"].tobytes())))
    assert len(got[0]) == len(got[1]) > 2
    for g, w in zip(*got):
        _assert_batches_equal(g, w)


class _JitInit(JaxXVectorModel):
    """The JAX XVectorModel with its ``init`` compiled (same variables)."""

    def init(self, rngs, *args, **kw):
        return jax.jit(lambda r: JaxXVectorModel.init(self, r, *args, **kw))(rngs)


def _pair(cfg, tmp_path, dim=DIM):
    """The JAX trainer and the port's, from the JAX trainer's variables."""
    jt = JaxMI(JaxParams(**cfg), str(tmp_path / "jax" / "nnet"), dim=dim,
               num_speakers=SPEAKERS, mesh=make_mesh(devices=jax.devices()[:1]))
    jt.network_model = _JitInit(config=cfg, loss_func=cfg["loss_func"], num_outputs=SPEAKERS)
    jt.build("train", dim, cfg["loss_func"], SPEAKERS)
    jt.build("valid", dim, cfg["loss_func"], SPEAKERS)
    t = TrainerMultiInput(ParamsPlain(**cfg), str(tmp_path / "port" / "nnet"), dim=dim,
                          num_speakers=SPEAKERS, device="cpu")
    t.build("train", dim, cfg["loss_func"], SPEAKERS)
    convert.load_variables(t.network_model, _variables(jt.state))
    return jt, t


def _variables(state):
    return {"params": jax.device_get(state.params),
            "batch_stats": jax.device_get(state.batch_stats)}


def _assert_params_close(t, jax_params, atol=1e-5):
    got = convert.flatten(convert.variables_of(t.network_model)["params"])
    want = convert.flatten(jax_params)
    assert set(got) == set(want)
    for path in want:
        if bn_follows(path, want):
            continue
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(want[path]),
                                   rtol=2e-4, atol=atol, err_msg=str(path))


def _losses(jt, t, monkeypatch):
    """Each group's mean loss: the JAX trainer's K-step program's metrics,
    the port's at ``_post_group``."""
    want, got = [], []
    jax_step = jt._train_step_multi

    def jax_multi(*args):
        state, metrics = jax_step(*args)
        want.append(float(metrics["loss"]))
        return state, metrics

    jt._train_step_multi = jax_multi
    orig = TrainerMultiInput._post_group

    def post_group(self, cfg, *args, **kw):
        got.append(float(args[1]["loss"]))
        return orig(self, cfg, *args, **kw)

    monkeypatch.setattr(TrainerMultiInput, "_post_group", post_group)
    return want, got


def test_multi_input_train_valid_predict(corpus, tmp_path, monkeypatch):
    aux = {"bnf": corpus["aux"]["bnf"]}
    jt, t = _pair(CFG, tmp_path)
    want, got = _losses(jt, t, monkeypatch)
    jt.train(corpus["data"], corpus["spklist"], LR, aux_data=aux)
    t.train(corpus["data"], corpus["spklist"], LR, aux_data=aux)
    assert t.step == int(jt.state.step) == 2
    assert os.path.exists(os.path.join(t.model, "model-2.pt"))
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=2e-4)
    _assert_params_close(t, jax.device_get(jt.state.params))

    jl, je, jlab = jt.valid(corpus["data"], corpus["spklist"], output_embeddings=True,
                            aux_data=aux)
    tl, te, tlab = t.valid(corpus["data"], corpus["spklist"], output_embeddings=True,
                           aux_data=aux)
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    order_t, order_j = np.argsort(tlab, kind="stable"), np.argsort(jlab, kind="stable")
    np.testing.assert_array_equal(np.sort(tlab), np.sort(jlab))
    assert te.shape == je.shape and te.shape[0] == 3 * SPEAKERS
    np.testing.assert_allclose(np.sort(te[order_t], axis=0), np.sort(je[order_j], axis=0),
                               rtol=1e-3, atol=5e-4)

    jt.build("predict", DIM)
    t.build("predict", DIM)
    x = np.random.RandomState(0).randn(80, DIM).astype(np.float32)
    a = {"bnf": np.random.RandomState(1).randn(80, BNF).astype(np.float32)}
    e = t.predict(x, a)
    assert e.shape == (16,) and np.isfinite(e).all()
    np.testing.assert_allclose(e, jt.predict(x, a), rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(t.predict(x[None], {"bnf": a["bnf"][None]})[0], e,
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(e, t.predict(x, {"bnf": a["bnf"] + 1.0}))
    # the converter infers the feature dim past the concatenated stream
    net = convert.network_from_variables(
        {"params": jax.device_get(jt.state.params)["network"],
         "batch_stats": jax.device_get(jt.state.batch_stats)["network"]}, CFG)
    assert net.trunk.tdnn1_conv.in_channels == DIM + BNF


def test_aux_rank_check(tmp_path):
    t = TrainerMultiInput(ParamsPlain(**CFG), str(tmp_path / "nnet"), dim=DIM,
                          num_speakers=SPEAKERS, device="cpu")
    t.build("train", DIM, "softmax", SPEAKERS)
    t.build("predict", DIM)
    x = np.zeros((50, DIM), np.float32)
    with pytest.raises(AssertionError):
        t.predict(x, {"bnf": np.zeros((49, BNF), np.float32)})
    with pytest.raises(AssertionError):
        TrainerMultiInput(ParamsPlain(**{k: v for k, v in CFG.items()
                                         if k != "aux_feature_dim"}),
                          str(tmp_path / "n2"), device="cpu")


ATT_AUX = dict(CFG, pooling_type="self_attention", att_key_input="aux_bnf",
               att_key_num_nodes=[8], att_key_network_type=3, att_value_input="aux_bnf",
               att_value_num_nodes=[], att_value_network_type=0, att_num_heads=2,
               att_split_key=False, att_use_scale=True, att_apply_nonlinear=False,
               att_penalty_term=0.1)
ECAPA_AUX = dict(CFG, **ECAPA, aux_feature_dim={"bnf": BNF, "asr": 5})


@pytest.mark.parametrize("cfg", [ATT_AUX, ECAPA_AUX], ids=["tdnn_att_key_aux", "ecapa_two_aux"])
def test_train_steps_match_jax(cfg, tmp_path):
    jt, t = _pair(cfg, tmp_path)
    rng = np.random.RandomState(3)
    state = jt.state
    for _ in range(2):
        feats = rng.randn(4, 48, DIM).astype(np.float32)
        aux = {name: rng.randn(4, 48, d).astype(np.float32)
               for name, d in sorted(cfg["aux_feature_dim"].items())}
        labels = rng.randint(0, SPEAKERS, 4).astype(np.int32)
        state, m = jt._train_step(state, jnp.asarray(feats),
                                  {k: jnp.asarray(v) for k, v in aux.items()},
                                  jnp.asarray(labels), jnp.float32(LR))
        got = t.train_step(torch.from_numpy(feats), torch.from_numpy(labels), LR,
                           {k: torch.from_numpy(v) for k, v in aux.items()})
        np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=2e-4)
        np.testing.assert_allclose(float(got["penalty_loss"]), float(m["penalty_loss"]),
                                   rtol=2e-4, atol=1e-7)
    if cfg is ATT_AUX:
        assert float(m["penalty_loss"]) > 0
    # ECAPA's train-mode BatchNorms over 4 rows amplify float32 rounding
    # (ROADMAP.md §3): its parameters within atol 5e-5
    _assert_params_close(t, jax.device_get(state.params), 1e-5 if cfg is ATT_AUX else 5e-5)
    first = "tdnn1_conv" if cfg is ATT_AUX else "conv1"
    width = DIM + (BNF if cfg is ATT_AUX else BNF + 5)
    assert getattr(t.network_model.network.trunk, first).weight.shape[1] == width


@pytest.fixture(scope="module")
def bnf_base(tmp_path_factory):
    """A JAX-trained base model (no aux streams) and its uncompressed data
    dir with VAD: (data dir paths, model dir)."""
    from tf_kaldi_speaker_tpu.train.trainer import Trainer as JaxTrainer
    from tf_kaldi_speaker_tpu.utils.testdata import make_fake_data_dir as jax_fake_dir

    root = tmp_path_factory.mktemp("bnf_base")
    d = jax_fake_dir(str(root / "base"), num_speakers=SPEAKERS, utts_per_speaker=4,
                     dim=DIM, min_len=100, max_len=160, with_vad_ali=True, compress=False)
    base_cfg = {k: v for k, v in CFG.items() if not k.startswith("aux_")}
    nnet = str(root / "base_m" / "nnet")
    t0 = JaxTrainer(JaxParams(**base_cfg), nnet, dim=DIM, num_speakers=SPEAKERS,
                    mesh=make_mesh(devices=jax.devices()[:1]))
    t0.network_model = _JitInit(config=base_cfg, loss_func="softmax", num_outputs=SPEAKERS)
    t0.build("train", DIM, "softmax", SPEAKERS)
    t0.train(d["data"], d["spklist"], LR)
    with open(os.path.join(nnet, "config.json"), "w") as f:
        json.dump(base_cfg, f)
    with open(os.path.join(nnet, "feature_dim"), "w") as f:
        f.write("%d\n" % DIM)
    return d, str(root / "base_m")


def _extract_bnf_both(base, out_root, extra=()):
    """The JAX and the port's ``extract_bnf`` over the base data dir:
    {"jax": dir, "port": dir}, each holding bnf.ark and feats.scp; the two
    scps equal but for the directory, the two arks of one size."""
    from tf_kaldi_speaker_tpu.cli import extract_bnf as jax_extract_bnf
    from tf_kaldi_speaker_tpu_torch.cli import extract_bnf

    d, model = base
    outs = {}
    for name, main, dev in (("jax", jax_extract_bnf.main, []),
                            ("port", extract_bnf.main, ["--device", "cpu"])):
        out = out_root / ("bnf_" + name)
        out.mkdir()
        assert main(dev + list(extra) + [model, "scp:" + d["feats_scp"], "ark,scp:%s,%s" % (
            out / "bnf.ark", out / "feats.scp")]) == 0
        outs[name] = out
    with open(outs["jax"] / "feats.scp") as f:
        jax_scp = f.read().replace(str(outs["jax"]), "")
    with open(outs["port"] / "feats.scp") as f:
        assert f.read().replace(str(outs["port"]), "") == jax_scp
    assert os.path.getsize(outs["port"] / "bnf.ark") == os.path.getsize(outs["jax"] / "bnf.ark")
    return outs


def _jax_cli_bucket(n):
    """The JAX ``extract_bnf``'s padded length for n tiled frames."""
    b = 64
    while b < n:
        b = int(b * 1.5)
    return b


def test_extract_bnf_gap_is_float32_rounding(bnf_base, tmp_path):
    """Why the BNF arks are not byte-equal: in float64 the JAX network on
    the JAX CLI's zero-padded bucket, the JAX network on the unpadded tiled
    input and the port's network agree to 1e-12 on frames [0:T] (so the
    padding changes nothing and the two networks compute one function),
    and each CLI's float32 ark lies within float32 rounding (rtol/atol
    1e-5) of that float64 function."""
    from tf_kaldi_speaker_tpu.models import EntireNetwork as JaxNetwork
    from tf_kaldi_speaker_tpu.train import checkpoints as jax_checkpoints
    from tf_kaldi_speaker_tpu_torch.models import TDNN_TOTAL_CONTEXT

    d, model = bnf_base
    outs = _extract_bnf_both(bnf_base, tmp_path)
    nnet = os.path.join(model, "nnet")
    with open(os.path.join(nnet, "config.json")) as f:
        cfg = json.load(f)
    raw, _ = jax_checkpoints.load_checkpoint(nnet)
    variables = {"params": raw["params"]["network"],
                 "batch_stats": raw.get("batch_stats", {}).get("network", {})}
    port_net = convert.network_from_variables(
        jax.tree_util.tree_map(np.asarray, variables), cfg, "tdnn", input_dim=DIM
    ).double().eval()
    jax_net = JaxNetwork(config=cfg, network_type="tdnn")
    half = TDNN_TOTAL_CONTEXT // 2
    cli = {name: dict(read_mat_scp(str(out / "feats.scp"))) for name, out in outs.items()}
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        fwd = jax.jit(lambda v, x: jax_net.apply(v, x, False)[1]["tdnn5_relu"])
        for key, feature in read_mat_scp(d["feats_scp"]):
            T = feature.shape[0]
            tiled = np.concatenate([np.repeat(feature[:1], half, 0), feature,
                                    np.repeat(feature[-1:], half, 0)]).astype(np.float64)
            padded = np.zeros((1, _jax_cli_bucket(len(tiled)), DIM))
            padded[0, :len(tiled)] = tiled
            jax_padded = np.asarray(fwd(v64, jnp.asarray(padded)))[0, :T]
            jax_unpadded = np.asarray(fwd(v64, jnp.asarray(tiled[None])))[0, :T]
            with torch.no_grad():
                port = port_net(torch.from_numpy(tiled[None]))[1]["tdnn5_relu"][0, :T].numpy()
            assert jax_padded.dtype == port.dtype == np.float64
            np.testing.assert_allclose(jax_unpadded, jax_padded, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(port, jax_padded, rtol=1e-12, atol=1e-12, err_msg=key)
            for name in ("jax", "port"):
                np.testing.assert_allclose(cli[name][key], jax_padded, rtol=1e-5, atol=1e-5,
                                           err_msg="%s %s" % (name, key))


def _column_steps(path):
    """Each column's widest quantization step in the CM matrix at the
    ``scp`` entry ``path`` ("ark:offset")."""
    fn, off = path.rsplit(":", 1)
    with open(fn, "rb") as f:
        f.seek(int(off))
        assert f.read(2) == b"\0B"
        _, h = ark._read_compressed_codes(f, f.read(3).decode())
    return np.max([(h[1] - h[0]) / 64, (h[2] - h[1]) / 128, (h[3] - h[2]) / 63], axis=0)


def test_extract_bnf_compressed_within_one_step(bnf_base, tmp_path):
    """``extract_bnf --compress``: the port's and the JAX CLI's arks of one
    layout and size, each value within one quantization step of its
    column (the wider of the two arks' steps) of the JAX CLI's."""
    outs = _extract_bnf_both(bnf_base, tmp_path, ["--compress"])
    scps = {name: dict(line.split() for line in open(out / "feats.scp"))
            for name, out in outs.items()}
    want = dict(read_mat_scp(str(outs["jax"] / "feats.scp")))
    got = dict(read_mat_scp(str(outs["port"] / "feats.scp")))
    assert list(got) == list(want)
    for key in want:
        step = np.maximum(_column_steps(scps["jax"][key]), _column_steps(scps["port"][key]))
        assert np.all(np.abs(got[key] - want[key]) <= step), key


def test_bnf_chain_through_the_port_clis(bnf_base, tmp_path):
    """A JAX-trained base model -> ``extract_bnf`` (port and JAX CLIs) ->
    ``prepare_feats --no-cmvn`` -> ``train_mi`` -> ``extract_mi``."""
    from tf_kaldi_speaker_tpu_torch.cli import extract_mi, prepare_feats, train_mi

    d, _ = bnf_base
    outs = _extract_bnf_both(bnf_base, tmp_path)
    want = dict(read_mat_scp(str(outs["jax"] / "feats.scp")))
    got = dict(read_mat_scp(str(outs["port"] / "feats.scp")))
    frames = dict(read_vec_flt_scp(d["vad_scp"]))
    assert list(got) == list(want)
    for key in want:
        assert got[key].shape == (frames[key].shape[0], 24)  # 1:1 with the input
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5, err_msg=key)

    bnf_raw = outs["port"]
    for name in ("vad.scp", "utt2spk", "spk2utt"):
        shutil.copyfile(os.path.join(d["data"], name), bnf_raw / name)
    assert prepare_feats.main(["--no-cmvn", "--device", "cpu", str(bnf_raw),
                               str(tmp_path / "bnf_egs")]) == 0
    assert prepare_feats.main(["--device", "cpu", d["data"], str(tmp_path / "main_egs")]) == 0
    mi_cfg = dict(CFG, num_epochs=1, num_steps_per_epoch=2, aux_feature_dim={"bnf": 24},
                  valid_max_iterations=2)
    cfg_path = tmp_path / "mi.json"
    cfg_path.write_text(json.dumps(mi_cfg))
    egs, model = str(tmp_path / "main_egs"), str(tmp_path / "mi_m")
    assert train_mi.main(["--config", str(cfg_path), "--device", "cpu",
                          "--aux_data", "bnf:%s" % (tmp_path / "bnf_egs"),
                          egs, d["spklist"], egs, d["spklist"], model]) == 0
    with open(os.path.join(model, "nnet", "valid_loss")) as f:
        assert len(f.read().split("\n")) == 2
    xv = tmp_path / "xv"
    assert extract_mi.main(["--device", "cpu", "--normalize",
                            "--aux_rspecifier", "bnf:scp:%s" % (tmp_path / "bnf_egs" / "feats.scp"),
                            model, "scp:%s/feats.scp" % egs,
                            "ark,scp:%s.ark,%s.scp" % (xv, xv)]) == 0
    emb = dict(read_vec_flt_scp(str(xv) + ".scp"))
    assert len(emb) == SPEAKERS * 4
    for v in emb.values():
        assert v.shape == (16,) and np.isfinite(v).all()
        np.testing.assert_allclose(np.linalg.norm(v), 1.0, rtol=1e-5)
