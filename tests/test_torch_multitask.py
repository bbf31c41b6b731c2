"""The multitask path of the port against the JAX package's on the CPU, at
tests/test_multitask.py's MT_CFG widths:

- the copies hold bit-equal to the originals: the int-vector and posterior
  codecs in both directions, ``make_fake_data_dir(with_vad_ali=True)``'s
  files, ``FeatureReaderV2`` segments (the JAX native reader off, so both
  sides decode with the numpy codec's rounding, which the port's native
  reader keeps), ``make_phone_masks`` draws, ``sample_with_probability``
  and the V2 samplers' and queues' batches for one seed;
- every case of tests/test_transition_model.py against both packages'
  transition model, and ``cli.ali_to_pdf``'s outputs byte-equal to the JAX
  CLI's;
- the ``MultitaskModel`` forward in eval and train mode, in the K-subset
  and all-frames phone-loss modes, on the same numpy weights through
  ``convert.py``: every endpoint, the loss and the updated BatchNorm
  statistics within rtol/atol 1e-5 (float32; XLA and PyTorch sum
  convolutions in different orders); the JAX variables are numpy draws
  into ``jax.eval_shape``'s tree, at a glorot-like scale;
- ``golden_mt.npz``: the TF checkpoint through the JAX importer, then
  ``convert.py``, reproduces tests/test_tf_golden.py's endpoints at its
  1e-4;
- one ``train_step`` against the JAX ``_train_step`` (losses, accuracies
  and updated parameters within 1e-5), and ``TrainerMultiTask.train()``
  for one epoch of one group of 2 steps and ``valid()`` against the JAX
  trainer's, with byte-equal ``speaker_egs``/``phone_egs``;
- the port's state tree carries the JAX names back: a JAX checkpoint
  restores into the port with its optimizer state, and the port's tree
  applies in the JAX module to the same outputs.
"""

import gzip
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_kaldi_speaker_tpu.kio import ark as jark
from tf_kaldi_speaker_tpu.kio import native_decode as jnd
from tf_kaldi_speaker_tpu.kio import transition_model as jtm
from tf_kaldi_speaker_tpu.kio.reader import FeatureReaderV2 as JaxReaderV2
from tf_kaldi_speaker_tpu.multitask import common as jcommon
from tf_kaldi_speaker_tpu.multitask import data_v2 as jdata
from tf_kaldi_speaker_tpu.multitask.model import MultitaskModel as JaxMultitaskModel
from tf_kaldi_speaker_tpu.multitask.trainer import TrainerMultiTask as JaxTrainerMT
from tf_kaldi_speaker_tpu.parallel.mesh import make_mesh
from tf_kaldi_speaker_tpu.utils.params import ParamsPlain as JaxParams
from tf_kaldi_speaker_tpu.utils.testdata import make_fake_data_dir as jax_fake_dir
from tf_kaldi_speaker_tpu_torch import convert
from tf_kaldi_speaker_tpu_torch.kio import ark, transition_model
from tf_kaldi_speaker_tpu_torch.kio.reader import FeatureReaderV2
from tf_kaldi_speaker_tpu_torch.multitask import common, data_v2
from tf_kaldi_speaker_tpu_torch.multitask.model import MultitaskModel
from tf_kaldi_speaker_tpu_torch.multitask.trainer import TrainerMultiTask
from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain
from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir
from test_multitask import MT_CFG, NUM_PHONES

torch.set_num_threads(1)

DIM, SPEAKERS, LR = 20, 5, 0.05
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def jax_numpy_decode(monkeypatch):
    monkeypatch.setattr(jnd, "_get_lib", lambda: None)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("mt")
    return make_fake_data_dir(str(root / "train"), num_speakers=SPEAKERS, utts_per_speaker=4,
                              dim=DIM, min_len=120, max_len=200, with_vad_ali=True,
                              num_phones=NUM_PHONES, phone_signal=0.5)


# ---------------------------------------------------------------------------
# Copies of framework-free code
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["vec_int", "post"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_int_vector_and_posterior_codecs(kind, writer, tmp_path):
    """Each package's writer gives the other's bytes, and each reader reads
    both packages' arks to the same values (a text int vector too)."""
    rng = np.random.RandomState(1)
    if kind == "vec_int":
        items = [("u%d" % i, rng.randint(-5, 3000, size=rng.randint(0, 40)).astype(np.int32))
                 for i in range(4)]
        write, read_ark = "write_vec_int", "read_vec_int_ark"
    else:
        items = [("u%d" % i, [[(int(rng.randint(0, 99)), float(np.float32(rng.rand())))
                               for _ in range(rng.randint(0, 4))]
                              for _ in range(rng.randint(0, 6))]) for i in range(4)]
        write, read_ark = "write_post", "read_post_ark"
    first, second = (ark, jark) if writer == "port" else (jark, ark)
    paths = []
    for mod, name in ((first, "a.ark"), (second, "b.ark")):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            for key, value in items:
                getattr(mod, write)(f, value, key=key)
        paths.append(path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    for mod in (ark, jark):
        got = list(getattr(mod, read_ark)(paths[0]))
        assert [k for k, _ in got] == [k for k, _ in items]
        for (_, g), (_, w) in zip(got, items):
            if kind == "vec_int":
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w
    if kind == "vec_int":
        text = str(tmp_path / "t.txt")
        with open(text, "w") as f:
            f.write("[ 3 1 4 1 5 ]\n")
        np.testing.assert_array_equal(ark.read_vec_int(text), jark.read_vec_int(text))


def test_ranged_vector_reads(tmp_path):
    """The ranged VAD and alignment reads of FeatureReaderV2."""
    rng = np.random.RandomState(2)
    v = rng.rand(50).astype(np.float32)
    a = rng.randint(0, 9, 50).astype(np.int32)
    path = str(tmp_path / "v")
    with open(path, "wb") as f:
        ark.write_vec_flt(f, v)
        off = f.tell()
        ark.write_vec_int(f, a)
    for start, length in ((0, 50), (7, 20), (49, 1)):
        with open(path, "rb") as f:
            f.read(2)
            got = ark._read_subvec_flt_binary(f, start, length)
            f.seek(off + 2)
            got_i = ark._read_subvec_int_binary(f, start, length)
        np.testing.assert_array_equal(got, v[start:start + length])
        np.testing.assert_array_equal(got_i, a[start:start + length])
    with open(path, "rb") as f, pytest.raises(ValueError):
        f.read(2)
        ark._read_subvec_flt_binary(f, 40, 11)


@pytest.mark.parametrize("kw", [dict(), dict(phone_signal=0.5, compress=False, chan_scale=1.0,
                                               ali_dir="elsewhere")])
def test_make_fake_data_dir_with_vad_ali_is_the_jax_one(kw, tmp_path):
    out = {}
    for name, fn in (("port", make_fake_data_dir), ("jax", jax_fake_dir)):
        args = dict(kw)
        if "ali_dir" in args:
            args["ali_dir"] = str(tmp_path / name / args["ali_dir"])
        out[name] = fn(str(tmp_path / name / "d"), num_speakers=3, utts_per_speaker=2, dim=6,
                       min_len=30, max_len=50, with_vad_ali=True, num_phones=7, seed=3, **args)
    assert sorted(out["port"]) == sorted(out["jax"])
    for d in ("data", "ali_dir"):
        files = sorted(os.listdir(out["jax"][d]))
        assert sorted(os.listdir(out["port"][d])) == files
        for name in files:
            if os.path.isdir(os.path.join(out["jax"][d], name)):
                continue
            with open(os.path.join(out["port"][d], name), "rb") as f:
                got = f.read().replace(str(tmp_path / "port").encode(), b"@")
            with open(os.path.join(out["jax"][d], name), "rb") as f:
                want = f.read().replace(str(tmp_path / "jax").encode(), b"@")
            assert got == want, (d, name)


def test_feature_reader_v2_segments(corpus):
    port = FeatureReaderV2(corpus["data"], corpus["ali_dir"], 11, 11)
    want = JaxReaderV2(corpus["data"], corpus["ali_dir"], 11, 11)
    assert port.dim == want.dim == DIM
    r1, r2 = random.Random(4), random.Random(4)
    cases = [(u, None, False, None) for u in list(port.utt2num_frames)[:2]]
    cases += [(u, 64, True, None) for u in port.utt2num_frames]
    cases += [(u, 300, False, None) for u in list(port.utt2num_frames)[:2]]
    cases += [("spk000_utt000", 50, False, 3), ("spk000_utt001", 80, False, 100)]
    for utt, length, shuffle, start in cases:
        g = port.read_segment(utt, length, shuffle, start, r1)
        w = want.read_segment(utt, length, shuffle, start, r2)
        assert g[3] == w[3]
        for a, b in zip(g[:3], w[:3]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    port.close()
    want.close()


def test_phone_masks_and_sampling_draws():
    length = np.array([10, 3, 50, 1, 5])
    for k in (1, 5):
        np.testing.assert_array_equal(
            common.make_phone_masks(length, None, k, np.random.RandomState(7)),
            jcommon.make_phone_masks(length, None, k, np.random.RandomState(7)))
    a, b = random.Random(0), random.Random(0)
    for n in (1, 2, 3):
        assert (data_v2.sample_with_probability(a, list("abcd"), n, [5, 50, 60, 100])
                == jdata.sample_with_probability(b, list("abcd"), n, [5, 50, 60, 100]))
    assert data_v2.sample_with_probability(random.Random(0), ["a", "b"], 2, [0, 0]) == ["a", "b"]


def _assert_batch_equal(got, want):
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["random1", "random2", "sequential"])
def test_v2_samplers_match_jax(corpus, kind):
    args = (corpus["data"], corpus["ali_dir"], corpus["spklist"])
    if kind == "sequential":
        kw = dict(left_context=11, right_context=11, batch_size=3, min_len=64, max_len=96,
                  seed=4)
        cls = "SequentialChunkSamplerV2"
    else:
        kw = dict(left_context=11, right_context=11, num_speakers=3, num_segments=2,
                  min_len=64, max_len=96, seed=9, group=int(kind[-1]))
        cls = "RandomChunkSamplerV2"
    port, want = getattr(data_v2, cls)(*args, **kw), getattr(jdata, cls)(*args, **kw)
    n = 0
    for g, w in zip(port, want):
        _assert_batch_equal(g, w)
        n += 1
        if n == 3:
            break
    assert n == 3
    port.close()
    want.close()


def test_v2_queues_match_jax(corpus):
    args = (corpus["data"], corpus["ali_dir"], corpus["spklist"], 11, 11)
    queues = [m.KaldiDataRandomQueueV2(*args, num_parallel=1, max_qsize=2, num_speakers=3,
                                       min_len=64, max_len=96, seed=3, group=2).start()
              for m in (data_v2, jdata)]
    try:
        assert queues[0].num_total_phones == queues[1].num_total_phones == NUM_PHONES
        for _ in range(2):
            _assert_batch_equal(queues[0].fetch(), queues[1].fetch())
    finally:
        for q in queues:
            q.stop()
    got = []
    for m in (data_v2, jdata):
        q = m.KaldiDataSeqQueueV2(*args, num_parallel=2, batch_size=4, min_len=64, max_len=96,
                                  seed=2).start()
        batches = list(q)
        q.stop()
        got.append(sorted(batches, key=lambda b: (b[4].tobytes(), b[0].tobytes())))
    assert len(got[0]) == len(got[1]) >= 5
    for g, w in zip(*got):
        _assert_batch_equal(g, w)
    assert data_v2.get_num_phones(corpus["ali_dir"]) == NUM_PHONES


# ---------------------------------------------------------------------------
# The transition model and ali_to_pdf (tests/test_transition_model.py)
# ---------------------------------------------------------------------------
TM = {"port": transition_model, "jax": jtm}


def _bakis_model(mod, num_phones=2):
    entries = [[
        (0, 0, [(0, 0.75), (1, 0.25)]),
        (1, 1, [(1, 0.75), (2, 0.25)]),
        (2, 2, [(2, 0.75), (3, 0.25)]),
        (-1, -1, []),
    ]]
    phones = list(range(1, num_phones + 1))
    tuples = [(p, st, 3 * i + st, 3 * i + st) for i, p in enumerate(phones) for st in range(3)]
    return mod.TransitionModel(phones, [-1] + [0] * num_phones, entries, tuples,
                               np.zeros(1 + 6 * num_phones, np.float32))


@pytest.mark.parametrize("which", ["port", "jax"])
def test_transition_model_cases(which, tmp_path):
    """The cases of tests/test_transition_model.py, on each package's
    module; the two modules' binary writers give the same bytes."""
    from test_transition_model import KALDI_TEXT_MDL

    mod = TM[which]
    tm = _bakis_model(mod)
    assert tm.num_transition_ids == 12 and tm.num_pdfs == 6
    np.testing.assert_array_equal(tm.tid2pdf, [0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5])
    chain = mod.TransitionModel([1], [-1, 0], [[(0, 1, [(0, 0.5), (1, 0.5)]), (-1, -1, [])]],
                                [(1, 0, 10, 20)], np.zeros(3, np.float32))
    np.testing.assert_array_equal(chain.tid2pdf, [0, 20, 10])
    assert chain.num_pdfs == 21
    tm3 = _bakis_model(mod, num_phones=3)
    path = str(tmp_path / "final.mdl")
    mod.write_transition_model(path, tm3)
    other = str(tmp_path / "other.mdl")
    TM["jax" if which == "port" else "port"].write_transition_model(other, tm3)
    with open(path, "rb") as f, open(other, "rb") as g:
        data = f.read()
        assert data[:2] == b"\x00B" and data == g.read()
    got = mod.read_transition_model(path)
    np.testing.assert_array_equal(got.tid2pdf, tm3.tid2pdf)
    assert got.num_pdfs == tm3.num_pdfs and got.tuples == tm3.tuples
    text = str(tmp_path / "text.mdl")
    with open(text, "w") as f:
        f.write(KALDI_TEXT_MDL)
    parsed = mod.read_transition_model(text)
    np.testing.assert_array_equal(parsed.tid2pdf, tm.tid2pdf)
    assert parsed.num_pdfs == 6 and len(parsed.log_probs) == 13
    with pytest.raises(mod.TransitionModelError):
        tm.ali_to_pdf(np.array([1, 99]))


def test_ali_to_pdf_cli_is_the_jax_one(tmp_path):
    from tf_kaldi_speaker_tpu.cli import ali_to_pdf as jax_cli
    from tf_kaldi_speaker_tpu_torch.cli import ali_to_pdf

    tm = _bakis_model(transition_model)
    mdl = str(tmp_path / "final.mdl")
    transition_model.write_transition_model(mdl, tm)
    rng = np.random.RandomState(0)
    raw = tmp_path / "ali.1"
    with open(raw, "wb") as f:
        for i in range(4):
            ali = rng.randint(1, tm.num_transition_ids + 1, size=50).astype(np.int32)
            ark.write_vec_int(f, ali, key="utt%d" % i)
    with open(raw, "rb") as f, gzip.open(str(tmp_path / "ali.1.gz"), "wb") as g:
        g.write(f.read())
    outs = {}
    for name, main in (("port", ali_to_pdf.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        d.mkdir()
        assert main(["--num-pdfs-out", str(d / "num_pdfs"), mdl,
                     "ark:gunzip -c %s |" % (tmp_path / "ali.1.gz"),
                     "ark,scp:%s,%s" % (d / "pdf.ark", d / "pdf.scp")]) == 0
        outs[name] = {f: (d / f).read_bytes().replace(str(d).encode(), b"@")
                      for f in ("num_pdfs", "pdf.ark", "pdf.scp")}
    assert outs["port"] == outs["jax"]
    assert outs["port"]["num_pdfs"] == b"6\n"
    pdfs = dict(ark.read_vec_int_ark(str(tmp_path / "port" / "pdf.ark")))
    alis = dict(ark.read_vec_int_ark(str(raw)))
    for k in pdfs:
        np.testing.assert_array_equal(pdfs[k], tm.tid2pdf[alis[k]])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
def draw_variables(shapes, seed):
    """Numpy draws into a JAX variable tree: kernels at a glorot-like scale
    (1/sqrt(fan in)), BatchNorm scales near 1, positive variances, small
    means and biases."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        if name in ("kernel", "output_kernel"):
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _inputs(b=4, length=30, seed=0, context=22):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, length + context, DIM).astype(np.float32)
    spk = rng.randint(0, SPEAKERS, b).astype(np.int32)
    phn = rng.randint(0, NUM_PHONES, (b, length)).astype(np.int32)
    lengths = np.array([length, length - 5, length, 20][:b], np.int32)
    idx = np.stack([rng.choice(n, 5, replace=False) for n in lengths]).astype(np.int32)
    return feats, spk, phn, lengths, idx


def jax_variables(cfg, seed=0, num_speakers=SPEAKERS, num_phones=NUM_PHONES):
    jm = JaxMultitaskModel(config=cfg, num_speakers=num_speakers, num_phones=num_phones)
    feats, spk, phn, lengths, idx = _inputs(
        context=cfg["phone_left_context"] + cfg["phone_right_context"])
    shapes = jax.eval_shape(lambda k: jm.init(k, feats, spk, phn, lengths, idx, 0, True),
                            jax.random.PRNGKey(0))
    return jm, draw_variables(shapes, seed)


def _port_model(cfg, variables):
    model = MultitaskModel(cfg, SPEAKERS, NUM_PHONES, DIM)
    convert.load_variables(model, variables)
    return model


def _assert_endpoints(got, want, names=None, tol=TOL):
    for name in names or want:
        np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(want[name]),
                                   err_msg=name, **tol)


# Float32 train-mode values pass through BatchNorms that normalize over the
# batch's 4 rows, which amplify the float32 rounding of their inputs (XLA
# and PyTorch sum convolutions in different orders) by up to 10x: they are
# held at PR 8's training tolerance, and the same cases in float64 at 1e-10
# show that the two packages compute one function.
TRAIN_TOL = dict(rtol=2e-4, atol=5e-5)
TOL64 = dict(rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["k_subset", "all_frames"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(mode, train, dtype):
    cfg = dict(MT_CFG, spk_last_layer_linear=mode == "all_frames")
    jm, variables = jax_variables(cfg)
    feats, spk, phn, lengths, idx = _inputs(seed=1)
    ix = idx if mode == "k_subset" else None
    weights = np.array([1.0, 1.0, 0.0, 1.0], np.float32) if train else None
    tol = TOL64 if dtype == "float64" else (TRAIN_TOL if train else TOL)
    wide = dtype == "float64"
    if wide:
        feats, weights = feats.astype(np.float64), None if weights is None else weights.astype(
            np.float64)
        variables = jax.tree_util.tree_map(lambda a: a.astype(np.float64), variables)
    args = (feats, spk, phn, lengths, ix, 3, train)
    with jax.enable_x64(wide):
        if train:
            (loss, ep), upd = jm.apply(variables, *args, mutable=["batch_stats"],
                                       sample_weight=weights)
        else:
            loss, ep = jm.apply(variables, *args)
        ep, loss = jax.device_get(ep), float(loss)
        if not train:
            want_lp = np.asarray(jm.apply(variables, feats, method=JaxMultitaskModel.predict_phone))
            want_emb = np.asarray(jm.apply(variables, feats, lengths,
                                           method=JaxMultitaskModel.predict_speaker))
    model = _port_model(cfg, variables).to(getattr(torch, dtype)).train(train)
    with torch.no_grad():
        got_loss, got = model(*(None if a is None else torch.from_numpy(a)
                                for a in (feats, spk, phn, lengths, ix)), 3,
                              sample_weight=None if weights is None else torch.from_numpy(weights))
    assert set(got) == set(ep)
    assert got["mu_zs"].dtype == getattr(torch, dtype)
    _assert_endpoints(got, ep, tol=tol)
    np.testing.assert_allclose(float(got_loss), loss, **(TOL64 if wide else TOL))
    if train:
        stats = convert.flatten(convert.variables_of(model)["batch_stats"])
        want = convert.flatten({"batch_stats": upd["batch_stats"]})
        assert set(stats) == {p[1:] for p in want}
        for path, v in want.items():
            np.testing.assert_allclose(stats[path[1:]].numpy(), np.asarray(v), err_msg=str(path),
                                       **(TOL64 if wide else TOL))
    else:
        lp = model.eval().predict_phone(torch.from_numpy(feats)).detach().numpy()
        np.testing.assert_allclose(lp, want_lp, **tol)
        emb = model.predict_speaker(torch.from_numpy(feats), torch.from_numpy(lengths))
        np.testing.assert_allclose(emb.detach().numpy(), want_emb, **tol)


def test_train_gradients_match_jax_in_float64():
    """The train step's gradient (weighted joint loss plus the L2 term, a
    train-mode forward) in float64: every parameter's within 1e-9 of JAX's,
    so the float32 gaps of the train-step tests are rounding."""
    from tf_kaldi_speaker_tpu.train.trainer import l2_regularization as jax_l2
    from tf_kaldi_speaker_tpu_torch.train.trainer import l2_regularization

    cfg = dict(MT_CFG, weight_l2_regularizer=1e-2)
    jm, variables = jax_variables(cfg)
    variables = jax.tree_util.tree_map(lambda a: a.astype(np.float64), variables)
    feats, spk, phn, lengths, idx = _inputs(seed=4)
    feats = feats.astype(np.float64)
    with jax.enable_x64(True):
        def total(params):
            (loss, _), _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    feats, spk, phn, lengths, idx, 0, True,
                                    mutable=["batch_stats"])
            return loss + jax_l2(params, 1e-2, 1e-2)

        want = convert.flatten({"params": jax.device_get(
            jax.jit(jax.grad(total))(variables["params"]))})
    model = _port_model(cfg, variables).double().train()
    loss, _ = model(*(torch.from_numpy(a) for a in (feats, spk, phn, lengths, idx)))
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss + l2_regularization(params, 1e-2, 1e-2),
                                list(params.values()))
    got = convert.flatten(convert.tree_from_named(zip(params, grads)))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path].numpy(), np.asarray(want[path]), rtol=1e-9,
                                   atol=1e-12, err_msg=str(path))


def test_shared_layers_and_variable_names():
    """The shared prefix lives once (conv1, conv2; no phn_conv1/2); the
    phone branch's dilated conv and its dense layer carry the JAX names;
    a port module's tree goes back onto the JAX tree with nothing left."""
    _, variables = jax_variables(MT_CFG)
    model = MultitaskModel(MT_CFG, SPEAKERS, NUM_PHONES, DIM)
    names = dict(model.named_modules())
    assert {"conv1", "conv2", "phn_conv3", "phn_dense4", "phn_conv5"} <= set(names)
    assert "phn_conv1" not in names and names["phn_conv5"].dilation == (4,)
    tree = convert.variables_of(model)
    got = {p: tuple(v.shape) for p, v in convert.flatten(tree).items()}
    want = {p: tuple(np.shape(v)) for p, v in convert.flatten(variables).items()}
    assert got == want
    no_bn = MultitaskModel(dict(MT_CFG, spk_last_layer_no_bn=True), SPEAKERS, NUM_PHONES, DIM)
    assert not hasattr(no_bn, "zs_bn")


def test_golden_mt_through_the_jax_importer():
    """tests/test_tf_golden.py:354-413 on the port: the TF multitask
    checkpoint through the JAX importer onto the JAX tree (shapes from
    ``jax.eval_shape``), then ``convert.py``; the eval endpoints, the
    train-mode embeddings and the unshared BatchNorms' updates at 1e-4."""
    import types

    from tf_kaldi_speaker_tpu.train.tf_import import import_reference_checkpoint
    from test_tf_golden import GOLD, MT_NUM_PHN, MT_NUM_SPK
    from test_tf_golden import MT_CFG as GOLD_CFG

    _, shapes = jax_variables(GOLD_CFG, num_speakers=MT_NUM_SPK, num_phones=MT_NUM_PHN)
    tree = jax.tree_util.tree_map(np.zeros_like, shapes)

    class _State:
        def __init__(self, params, batch_stats):
            self.params, self.batch_stats = params, batch_stats

        def replace(self, **kw):
            return _State(kw["params"], kw["batch_stats"])

    stub = types.SimpleNamespace(state=_State(tree["params"], tree["batch_stats"]),
                                 tx=types.SimpleNamespace(init=lambda p: None))
    imported, skipped = import_reference_checkpoint(os.path.join(GOLD, "mt-model-0"), stub)
    assert not skipped and len(imported) >= 50
    gold = np.load(os.path.join(GOLD, "golden_mt.npz"))
    model = MultitaskModel(GOLD_CFG, MT_NUM_SPK, MT_NUM_PHN, DIM)
    convert.load_variables(model, {"params": jax.device_get(stub.state.params),
                                   "batch_stats": jax.device_get(stub.state.batch_stats)})
    b, length = gold["features"].shape[0], int(gold["zp"].shape[1])
    args = (torch.from_numpy(gold["features"]), torch.zeros(b, dtype=torch.int32),
            torch.zeros(b, length, dtype=torch.int32), torch.from_numpy(gold["lengths"]), None)
    gtol = dict(rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        _, ep = model.eval()(*args)
    pairs = [("spk_relu1", "shared1"), ("spk_relu2", "shared2"), ("spk_relu3", "relu3"),
             ("spk_relu4", "relu4"), ("spk_relu5", "relu5"), ("spk_pooling", "pooling"),
             ("spk_dense6", "dense6"), ("spk_relu6", "relu6"),
             ("spk_zs_mu_dense", "zs_mu_dense"), ("spk_zs_mu_bn", "zs_mu_bn"),
             ("spk_zs_mu_relu", "zs_mu_relu"), ("phn_phn_conv3", "phn_conv3"),
             ("phn_phn_relu3", "phn_relu3"), ("phn_phn_dense4", "phn_dense4"),
             ("phn_phn_relu4", "phn_relu4"), ("phn_phn_conv5", "phn_conv5"),
             ("phn_phn_relu5", "phn_relu5"), ("phn_zp_mu_dense", "zp_mu_dense"),
             ("phn_zp_mu_bn", "zp_mu_bn"), ("phn_zp_mu_relu", "zp_mu_relu"),
             ("zs", "mu_zs"), ("zp", "mu_zp")]
    for gkey, ekey in pairs:
        want = gold[gkey]
        if want.ndim == 4:  # TF keeps the dummy height axis on conv outputs
            want = want[:, 0]
        np.testing.assert_allclose(ep[ekey].numpy(), want, err_msg=ekey, **gtol)
    with torch.no_grad():
        _, ep = model.train()(*args)
    np.testing.assert_allclose(ep["zs_mu_relu"].numpy(), gold["train_zs"], **gtol)
    np.testing.assert_allclose(ep["zp_mu_relu"].numpy(), gold["train_zp"], **gtol)
    btol = dict(rtol=1e-4, atol=1e-5)
    for bn, key in (("bn6", "encoder_bn6"), ("phn_bn5", "encoder_phone_phn_bn5")):
        mod = getattr(model, bn)
        np.testing.assert_allclose(mod.mean.numpy(), gold["updated_%s_moving_mean" % key], **btol)
        np.testing.assert_allclose(mod.var.numpy(), gold["updated_%s_moving_variance" % key],
                                   **btol)


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------
class _DrawnInit(JaxMultitaskModel):
    """The JAX MultitaskModel whose ``init`` gives numpy draws into the
    variable tree's shapes (no JAX init runs)."""

    def init(self, rngs, *args, **kw):
        shapes = jax.eval_shape(lambda r: JaxMultitaskModel.init(self, r, *args, **kw), rngs)
        return draw_variables(shapes, 5)


TRAIN_CFG = dict(MT_CFG, optimizer="momentum", momentum=0.9, num_steps_per_epoch=2,
                 steps_per_dispatch=2, num_epochs=2, show_training_progress=1,
                 save_checkpoints_steps=2, valid_max_iterations=3)


def _pair(cfg, tmp_path):
    """The JAX trainer (one device) and the port's from its variables."""
    jt = JaxTrainerMT(JaxParams(**cfg), str(tmp_path / "jax" / "nnet"), dim=DIM,
                      num_speakers=SPEAKERS, num_phones=NUM_PHONES,
                      mesh=make_mesh(devices=jax.devices()[:1]))
    jt.network_model = _DrawnInit(config=cfg, num_speakers=SPEAKERS, num_phones=NUM_PHONES)
    jt.build("train", DIM, num_speakers=SPEAKERS, num_phones=NUM_PHONES)
    t = TrainerMultiTask(ParamsPlain(**cfg), str(tmp_path / "port" / "nnet"), dim=DIM,
                         num_speakers=SPEAKERS, num_phones=NUM_PHONES, device="cpu")
    t.build("train", DIM, num_speakers=SPEAKERS, num_phones=NUM_PHONES)
    convert.load_variables(t.network_model, _variables(jt.state))
    return jt, t


def _variables(state):
    return {"params": jax.device_get(state.params),
            "batch_stats": jax.device_get(state.batch_stats)}


def _assert_state_close(t, state, tol=TOL):
    got = convert.flatten(convert.variables_of(t.network_model))
    want = convert.flatten(_variables(state))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path].numpy(), np.asarray(want[path]), err_msg=str(path),
                                   **tol)


@pytest.mark.parametrize("mode", ["k_subset", "all_frames"])
def test_train_step_matches_jax(mode, tmp_path):
    cfg = dict(TRAIN_CFG, num_frames_per_utt=5 if mode == "k_subset" else -1)
    jt, t = _pair(cfg, tmp_path)
    jt.build("valid", DIM)
    feats, spk, phn, lengths, idx = _inputs(seed=2)
    state = jt.state
    for _ in range(2):
        state, m = jt._train_step(state, *(jnp.asarray(a) for a in (feats, spk, phn, lengths,
                                                                       idx)), jnp.float32(LR))
        got = t.train_step(*(torch.from_numpy(a) for a in (feats, spk, phn, lengths, idx)), LR)
        assert set(got) == set(m)
        for key in m:
            np.testing.assert_allclose(float(got[key]), float(m[key]), err_msg=key, **TOL)
    _assert_state_close(t, state, TRAIN_TOL)
    assert t.step == int(state.step) == 2
    w = np.ones(4, np.float32)
    want = jt._valid_step(state, *(jnp.asarray(a) for a in (feats, spk, phn, lengths, idx, w)))
    got = t.valid_step(*(torch.from_numpy(a) for a in (feats, spk, phn, lengths, idx, w)))
    for g, v in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(v), **TRAIN_TOL)


def test_epoch_valid_and_checkpoints_match_jax(corpus, tmp_path, monkeypatch):
    """One epoch (one group of 2 steps from one loader worker) and valid()
    against the JAX trainer; the egs counts byte-equal; the JAX checkpoint
    restores into the port with its momentum trace, and the port's tree
    applies in the JAX module."""
    jt, t = _pair(TRAIN_CFG, tmp_path)
    jt.build("valid", DIM)
    want, got = [], []
    jax_multi = jt._train_step_multi

    def multi(*args):
        state, metrics = jax_multi(*args)
        want.append(jax.device_get(metrics))
        return state, metrics

    jt._train_step_multi = multi
    post_group = TrainerMultiTask._post_group

    def record(self, cfg, writer, metrics, *args):
        got.append({k: float(v) for k, v in metrics.items()})
        return post_group(self, cfg, writer, metrics, *args)

    monkeypatch.setattr(TrainerMultiTask, "_post_group", record)
    data = (corpus["data"], corpus["ali_dir"], corpus["spklist"])
    jt.train(*data, LR)
    t.train(*data, LR)
    assert t.step == int(jt.state.step) == 2 and len(got) == len(want) == 1
    for key in want[0]:
        np.testing.assert_allclose(got[0][key], float(want[0][key]), err_msg=key, **TOL)
    _assert_state_close(t, jt.state, TRAIN_TOL)
    for name in ("speaker_egs", "phone_egs"):
        with open(os.path.join(tmp_path, "port", name)) as f, \
                open(os.path.join(tmp_path, "jax", name)) as g:
            assert f.read() == g.read()
    assert os.path.exists(os.path.join(t.model, "model-2.pt"))

    for emb in (False, True):
        js, jp, je, jl = jt.valid(*data, output_embeddings=emb)
        ts, tp, te, tl = t.valid(*data, output_embeddings=emb)
        np.testing.assert_allclose([ts, tp], [js, jp], **TRAIN_TOL)
        if emb:
            np.testing.assert_array_equal(tl, jl)
            np.testing.assert_allclose(te, je, **TRAIN_TOL)
        else:
            assert te is None and je is None

    jt.build("predict", DIM)
    t.build("predict", DIM)
    x = np.random.RandomState(0).randn(60, DIM).astype(np.float32)
    np.testing.assert_allclose(t.predict_speaker(x), jt.predict_speaker(x), **TRAIN_TOL)
    np.testing.assert_allclose(t.predict_phone(x[None])[0], jt.predict_phone(x), **TRAIN_TOL)

    # the JAX checkpoint restores into a new port trainer, trace and all
    jt.save(2)
    fresh = TrainerMultiTask(ParamsPlain(**TRAIN_CFG), jt.model, dim=DIM, num_speakers=SPEAKERS,
                             num_phones=NUM_PHONES, device="cpu")
    fresh.build("train", DIM, num_speakers=SPEAKERS, num_phones=NUM_PHONES)
    assert fresh.load() == 2 and fresh.step == 2
    _assert_state_close(fresh, jt.state, dict(rtol=0, atol=0))
    trace = convert.flatten(fresh.state_tree()["opt_state"]["trace"])
    want_trace = convert.flatten(jax.device_get(jt.state.opt_state[0].trace))
    assert set(trace) == set(want_trace)
    for path in want_trace:
        np.testing.assert_array_equal(trace[path].numpy(), np.asarray(want_trace[path]))
    # and the port's names go back: its tree in the JAX module
    tree = jax.tree_util.tree_map(lambda v: jnp.asarray(v.numpy()), convert.variables_of(
        t.network_model))
    feats, spk, phn, lengths, idx = _inputs(seed=3)
    _, jep = jt.network_model.apply(tree, feats, spk, phn, lengths, idx, 0, False)
    with torch.no_grad():
        _, tep = t.network_model.eval()(*(torch.from_numpy(a) for a in (feats, spk, phn,
                                                                          lengths, idx)))
    _assert_endpoints(tep, jep, ["mu_zs", "mu_zp", "spk_logits", "phn_logits"], TOL)
