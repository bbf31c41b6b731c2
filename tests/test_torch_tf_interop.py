"""TF1 checkpoint interop in the port against the JAX package and real TF.

``kio/tf_bundle.py``, ``train/tf_import.py``, ``train/tf_export.py`` and the
CLIs ``import_tf_checkpoint`` / ``export_tf_checkpoint`` of
tf_kaldi_speaker_tpu_torch, held against their JAX counterparts on the
committed checkpoints (``tests/data/tf_fixture`` written once by
``tf.compat.v1.train.Saver``, ``tests/data/tf_golden`` by TF 2.21 with that
graph's endpoints): reads bit for bit, imported trees array for array with
the same skipped lists, exported files byte for byte, and the port's eval
forward after its own import against real TF's endpoints at the golden
tests' rtol/atol of 1e-4. The JAX importer runs on a stand-in trainer that
holds the port's tree before the import (no JAX trainer is built)."""

import glob
import json
import os
import types

import numpy as np
import optax
import pytest
import torch

from test_tf_golden import (CFG, MT_CFG, MT_NUM_PHN, MT_NUM_SPK, _CFG_ATT, _CFG_ATT_PRELU,
                            _CFG_VLAD)
from tf_kaldi_speaker_tpu.kio import tf_bundle as jtb
from tf_kaldi_speaker_tpu.train import tf_export as jexport
from tf_kaldi_speaker_tpu.train import tf_import as jimport
from tf_kaldi_speaker_tpu_torch import convert
from tf_kaldi_speaker_tpu_torch.cli import export_tf_checkpoint as export_cli
from tf_kaldi_speaker_tpu_torch.cli import import_tf_checkpoint as import_cli
from tf_kaldi_speaker_tpu_torch.kio import native_decode
from tf_kaldi_speaker_tpu_torch.kio import tf_bundle
from tf_kaldi_speaker_tpu_torch.multitask.trainer import TrainerMultiTask
from tf_kaldi_speaker_tpu_torch.train import checkpoints, tf_export, tf_import
from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "data", "tf_golden")
FIXTURE = os.path.join(HERE, "data", "tf_fixture", "model-1234")
TOL = dict(rtol=1e-4, atol=1e-4)  # test_tf_golden's endpoint tolerance

# every committed checkpoint prefix
PREFIXES = [FIXTURE] + sorted(p[:-len(".index")] for p in
                              glob.glob(os.path.join(GOLD, "**", "*.index"), recursive=True))

_RING = dict(aux_loss_func=["ring_loss"], ring_loss_init=10.0, ring_loss_lambda=0.01)
# golden checkpoint -> (config, multitask); the trained ones with their optimizer
IMPORTS = {
    "model-0": CFG,
    "model-att-0": _CFG_ATT,
    "model-vlad-0": _CFG_VLAD,
    "mt-model-0": MT_CFG,
    "model-trained-2": dict(CFG, optimizer="momentum", momentum=0.9),
    "model-trained-adam-3": dict(CFG, optimizer="adam"),
    "export/model-3": CFG,
    "export_att/model-3": _CFG_ATT,
    "export_vlad/model-3": _CFG_VLAD,
    "export_att_prelu/model-3": _CFG_ATT_PRELU,
}


def _trainer(cfg, root, multitask=False):
    if multitask:
        t = TrainerMultiTask(ParamsPlain(**cfg), str(root / "nnet"), dim=20,
                             num_speakers=MT_NUM_SPK, num_phones=MT_NUM_PHN, device="cpu")
        t.build("train", 20, num_speakers=MT_NUM_SPK, num_phones=MT_NUM_PHN)
    else:
        t = Trainer(ParamsPlain(**cfg), str(root / "nnet"), dim=20, num_speakers=10, device="cpu")
        t.build("train", 20, cfg["loss_func"], 10)
    return t


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _flat(tree):
    return {"/".join(k): v for k, v in convert.flatten(tree).items()}


class _JaxState:
    """What the JAX importer reads and replaces of a flax TrainState."""

    def __init__(self, **fields):
        self.__dict__.update(fields)

    def replace(self, **fields):
        return _JaxState(**dict(self.__dict__, **fields))


def _jax_import(prefix, tree):
    """The JAX importer over ``tree`` (the port's tree before its import)."""
    stub = types.SimpleNamespace(
        state=_JaxState(params=tree["params"], batch_stats=tree["batch_stats"]),
        tx=optax.sgd(0.1))
    imported, skipped = jimport.import_reference_checkpoint(prefix, stub)
    return ({"params": _numpy(stub.state.params), "batch_stats": _numpy(stub.state.batch_stats)},
            imported, skipped)


# ---------------------------------------------------------------- the codec
@pytest.mark.parametrize("prefix", PREFIXES, ids=lambda p: os.path.relpath(p, HERE))
def test_read_matches_jax(prefix):
    got, want = tf_bundle.read_tf_checkpoint(prefix), jtb.read_tf_checkpoint(prefix)
    assert list(got) == list(want) and got
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
    if prefix == FIXTURE:  # the values real TF wrote, stored beside it
        expected = np.load(os.path.join(os.path.dirname(FIXTURE), "expected.npz"))
        assert sorted(got) == sorted(expected.files)
        for name in expected.files:
            assert got[name].dtype == expected[name].dtype, name
            np.testing.assert_array_equal(got[name], expected[name], err_msg=name)


def test_bundle_roundtrip_and_writer_bytes(tmp_path):
    rng = np.random.RandomState(0)
    tensors = {
        "a/b/kernel": rng.randn(3, 4).astype(np.float32),
        "a/b/bias": rng.randn(4).astype(np.float32),
        "scalar": np.float32(2.5).reshape(()),
        "ints": np.arange(6, dtype=np.int64).reshape(2, 3),
        "flags": np.array([True, False]),
    }
    tf_bundle.write_tf_checkpoint(str(tmp_path / "port"), tensors)
    jtb.write_tf_checkpoint(str(tmp_path / "jax"), tensors)
    for ext in (".index", ".data-00000-of-00001"):
        assert (tmp_path / ("port" + ext)).read_bytes() == (tmp_path / ("jax" + ext)).read_bytes()
    got = tf_bundle.read_tf_checkpoint(str(tmp_path / "port"))
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)


def _table_crc(data):
    crc = 0xFFFFFFFF
    for b in data:
        crc = tf_bundle._CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def test_crc32c_against_the_table_loop():
    """The port's checksum (native where built) against the pure-Python
    table and RFC 3720's check value, and its table against JAX's."""
    assert tf_bundle._CRC32C_TABLE == jtb._CRC32C_TABLE
    assert _table_crc(b"123456789") == 0xE3069283
    assert native_decode.native_available()
    rng = np.random.RandomState(0)
    for n in (0, 1, 7, 8, 9, 64, 1000, 4097):
        data = rng.randint(0, 256, n, dtype=np.uint8).tobytes()
        want = _table_crc(data)
        assert native_decode.crc32c_fast(data) == want, n
        assert tf_bundle._crc32c(data) == want, n
        assert tf_bundle._masked_crc32c(data) == jtb._masked_crc32c(data), n


# ---------------------------------------------------------------- import
def test_map_tf_name_matches_jax():
    names = set()
    for prefix in PREFIXES:
        names.update(jtb.read_tf_checkpoint(prefix))
    names.update(["tdnn/tdnn1_conv/kernel/Momentum", "tdnn/tdnn2_conv/kernel/Adam_1",
                  "beta1_power", "softmax_ringloss/r", "tdnn/tdnn3_relu/alpha",
                  "tdnn/vlad/vlad_key0/vlad_key0_relu/alpha", "nothing/known"])
    a = np.arange(5 * 3 * 4, dtype=np.float32).reshape(1, 5, 3, 4)
    for name in sorted(names):
        got, want = tf_import.map_tf_name(name), jimport.map_tf_name(name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert got[:2] == want[:2], name
            np.testing.assert_array_equal(got[2](a), want[2](a))


@pytest.fixture(scope="module")
def imports(tmp_path_factory):
    """Each golden checkpoint imported by the port into a trainer of its
    config, beside the JAX importer's tree from the same starting tree."""
    out = {}
    for ckpt, cfg in IMPORTS.items():
        mt = ckpt.startswith("mt-")
        t = _trainer(cfg, tmp_path_factory.mktemp(ckpt.replace("/", "_")), multitask=mt)
        before = _numpy(convert.variables_of(t.network_model))
        want, jimported, jskipped = _jax_import(os.path.join(GOLD, ckpt), before)
        imported, skipped = tf_import.import_reference_checkpoint(os.path.join(GOLD, ckpt), t)
        out[ckpt] = dict(trainer=t, imported=imported, skipped=skipped, want=want,
                         jax_imported=jimported, jax_skipped=jskipped)
    return out


@pytest.mark.parametrize("ckpt", sorted(IMPORTS))
def test_imported_tree_matches_jax(imports, ckpt):
    case = imports[ckpt]
    assert case["imported"] == case["jax_imported"] and case["skipped"] == case["jax_skipped"]
    assert case["skipped"] == (["global_step"] if ckpt.startswith("export") else [])
    t = case["trainer"]
    got = _flat(_numpy(convert.variables_of(t.network_model)))
    want = _flat(case["want"])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k
    # a fresh optimizer state, as the JAX importer re-initializes opt_state
    assert all(not torch.any(s) for key, v in t.optimizer.state().items() if key != "count"
               for s in v)


def _golden_apply(t, gold, step=0):
    with torch.no_grad():
        return t.network_model.eval()(torch.from_numpy(gold["features"]),
                                      torch.from_numpy(gold["labels"]).long(), step)


GOLDEN_FORWARDS = {
    "model-0": ("golden.npz", ["tdnn1_conv", "tdnn1_bn", "tdnn2_conv", "tdnn3_conv",
                               "tdnn4_dense", "tdnn5_dense", "pooling", "tdnn6_dense", "tdnn6_bn",
                               "tdnn7_dense", "tdnn7_bn", "logits"]),
    "model-att-0": ("golden_att.npz", ["tdnn4_relu", "tdnn5_relu", "pooling", "tdnn6_dense",
                                       "tdnn7_bn", "logits", "attention_weights"]),
    "model-vlad-0": ("golden_vlad.npz", ["tdnn4_relu", "tdnn5_relu", "pooling", "tdnn6_dense",
                                         "tdnn7_bn", "logits", "vlad_weights"]),
    "export/model-3": ("golden_export.npz", ["pooling", "logits"]),
    "export_att/model-3": ("golden_export_att.npz", ["pooling", "logits"]),
    "export_vlad/model-3": ("golden_export_vlad.npz", ["pooling", "logits"]),
    "export_att_prelu/model-3": ("golden_export_att_prelu.npz", ["pooling", "logits"]),
}


@pytest.mark.parametrize("ckpt", sorted(GOLDEN_FORWARDS))
def test_forward_after_import_matches_real_tf(imports, ckpt):
    npz, names = GOLDEN_FORWARDS[ckpt]
    gold = np.load(os.path.join(GOLD, npz))
    t = imports[ckpt]["trainer"]
    loss0, ep = _golden_apply(t, gold, 0)
    if ckpt.startswith("export"):
        np.testing.assert_allclose(ep["tdnn6_dense"].numpy(), gold["embedding"], **TOL)
    for name in names:
        np.testing.assert_allclose(np.squeeze(ep[name].numpy()), np.squeeze(gold[name]),
                                   err_msg=name, **TOL)
    if "att" in ckpt:
        np.testing.assert_allclose(float(ep["attention_penalty"]),
                                   float(gold["attention_penalty"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(loss0), float(gold["loss_step0"]), rtol=1e-4, atol=1e-5)
    loss20k, _ = _golden_apply(t, gold, 20000)
    np.testing.assert_allclose(float(loss20k), float(gold["loss_step20000"]),
                               rtol=1e-4, atol=1e-5)


def test_multitask_forward_after_import_matches_real_tf(imports):
    """test_tf_golden's multitask endpoints, from the port's import."""
    gold = np.load(os.path.join(GOLD, "golden_mt.npz"))
    t = imports["mt-model-0"]["trainer"]
    feats = torch.from_numpy(gold["features"])
    B, L = feats.shape[0], int(gold["zp"].shape[1])
    with torch.no_grad():
        _, ep = t.network_model.eval()(feats, torch.zeros(B, dtype=torch.long),
                                       torch.zeros(B, L, dtype=torch.long),
                                       torch.from_numpy(gold["lengths"]), None, 0)
    pairs = [("spk_relu1", "shared1"), ("spk_relu3", "relu3"), ("spk_pooling", "pooling"),
             ("spk_zs_mu_dense", "zs_mu_dense"), ("spk_zs_mu_relu", "zs_mu_relu"),
             ("phn_phn_conv3", "phn_conv3"), ("phn_phn_conv5", "phn_conv5"),
             ("phn_zp_mu_bn", "zp_mu_bn"), ("zs", "mu_zs"), ("zp", "mu_zp")]
    for gkey, ekey in pairs:
        want = gold[gkey]
        if want.ndim == 4:  # TF keeps the dummy height axis on conv outputs
            want = want[:, 0]
        np.testing.assert_allclose(ep[ekey].numpy(), want, err_msg=ekey, **TOL)


def test_import_refusals(tmp_path):
    """A shape mismatch raises, as in JAX; so does a trainer whose speaker
    softmax is split over a model-parallel group."""
    t = _trainer(CFG, tmp_path / "a")
    bad = str(tmp_path / "bad")
    tf_bundle.write_tf_checkpoint(bad, {"softmax/output/kernel": np.zeros((31, 10), np.float32)})
    with pytest.raises(ValueError, match="Shape mismatch"):
        tf_import.import_reference_checkpoint(bad, t)
    t.mesh = types.SimpleNamespace(model_size=2)
    with pytest.raises(ValueError, match="model_parallel=2"):
        tf_import.import_reference_checkpoint(os.path.join(GOLD, "model-0"), t)


# ---------------------------------------------------------------- export
EXPORTS = {"tdnn_stats": (CFG, False), "att_prelu_ring": (dict(_CFG_ATT_PRELU, **_RING), False),
           "vlad": (_CFG_VLAD, False), "multitask": (MT_CFG, True)}


@pytest.mark.parametrize("momentum_slots", [False, True])
@pytest.mark.parametrize("kind", sorted(EXPORTS))
def test_export_bytes_match_jax(tmp_path, kind, momentum_slots):
    cfg, mt = EXPORTS[kind]
    tree = _numpy(convert.variables_of(_trainer(cfg, tmp_path / "m", multitask=mt).network_model))
    out = {}
    for who, fn in (("port", tf_export.export_reference_checkpoint),
                    ("jax", jexport.export_reference_checkpoint)):
        out[who] = fn(tree["params"], tree["batch_stats"], str(tmp_path / who / "model-7"),
                      step=7, momentum_slots=momentum_slots)
    assert out["port"] == out["jax"]
    exported, skipped = out["port"]
    assert exported
    if mt:  # only the loss heads have no reference name
        assert sorted(skipped) == [
            "params:phn_softmax/output_bias", "params:phn_softmax/output_kernel",
            "params:spk_softmax/output_bias", "params:spk_softmax/output_kernel"]
    else:
        assert skipped == []
    for name in ("model-7.index", "model-7.data-00000-of-00001", "checkpoint"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    got = tf_bundle.read_tf_checkpoint(str(tmp_path / "port" / "model-7"))
    assert int(got["global_step"]) == 7 and got["global_step"].dtype == np.int64
    assert any(k.endswith("/Momentum") for k in got) == momentum_slots


def test_map_flax_leaf_matches_jax(tmp_path):
    tree = _numpy(convert.variables_of(_trainer(dict(_CFG_ATT_PRELU, **_RING),
                                                tmp_path).network_model))
    paths = [(coll, p) for coll in ("params", "batch_stats")
             for p in convert.flatten(tree[coll])]
    paths += [("params", ("network", "ecapa", "block1", "kernel")),
              ("params", ("network", "tdnn", "tdnn1_conv", "oddleaf")),
              ("params", ("conv1", "kernel")), ("batch_stats", ("zp_bn", "var")),
              ("params", ("network", "tdnn", "ghost_vlad", "query"))]
    a = np.zeros((5, 3, 4), np.float32)
    for coll, path in paths:
        got, want = tf_export.map_flax_leaf(coll, path), jexport.map_flax_leaf(coll, path)
        assert (got is None) == (want is None), path
        if got is not None:
            assert got[0] == want[0] and got[1](a).shape == want[1](a).shape, path


# ---------------------------------------------------------------- the CLIs
def _write_config(path, cfg):
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def test_import_then_export_cli(tmp_path):
    """import_tf_checkpoint writes a step-0 .pt and the model-dir files; its
    tree is the library import's; export_tf_checkpoint writes back the
    bundle byte-equal to JAX's exporter on that tree, and every mapped value
    of the golden checkpoint comes back."""
    cfg = _write_config(tmp_path / "c.json", CFG)
    model = tmp_path / "model"
    assert import_cli.main(["--config", cfg, "--feature-dim", "20", "--num-speakers", "10",
                            "--device", "cpu", os.path.join(GOLD, "model-0"), str(model)]) == 0
    nnet = model / "nnet"
    for name in ("model-0.pt", "config.json", "feature_dim", "num_speakers"):
        assert (nnet / name).exists(), name
    assert (nnet / "feature_dim").read_text().strip() == "20"
    raw, step = checkpoints.load_checkpoint(str(nnet))
    assert step == 0 and raw["opt_state"] == {}
    t = _trainer(CFG, tmp_path / "direct")
    tf_import.import_reference_checkpoint(os.path.join(GOLD, "model-0"), t)
    want = _flat(_numpy(convert.variables_of(t.network_model)))
    got = _flat(_numpy({k: raw[k] for k in ("params", "batch_stats")}))
    assert sorted(got) == sorted(want)
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)

    out = tmp_path / "tf"
    assert export_cli.main([str(model), str(out)]) == 0
    for name in ("model-0.index", "model-0.data-00000-of-00001", "checkpoint", "config.json",
                 "feature_dim", "num_speakers"):
        assert (out / name).exists(), name
    jexport.export_reference_checkpoint(_numpy(raw["params"]), _numpy(raw["batch_stats"]),
                                        str(tmp_path / "jax" / "model-0"))
    for name in ("model-0.index", "model-0.data-00000-of-00001", "checkpoint"):
        assert (out / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    back = tf_bundle.read_tf_checkpoint(str(out / "model-0"))
    source = tf_bundle.read_tf_checkpoint(os.path.join(GOLD, "model-0"))
    assert sorted(back) == sorted(list(source) + ["global_step"])
    for name, value in source.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)


def test_import_cli_refusals(tmp_path):
    cfg = _write_config(tmp_path / "c.json", CFG)
    empty = str(tmp_path / "empty")
    tf_bundle.write_tf_checkpoint(empty, {"global_step": np.asarray(3, np.int64)})
    assert import_cli.main(["--config", cfg, "--feature-dim", "20", "--num-speakers", "10",
                            "--device", "cpu", empty, str(tmp_path / "out")]) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            import_cli.main(["--config", cfg, "--feature-dim", "20", "--num-speakers", "10",
                             os.path.join(GOLD, "model-0"), str(tmp_path / "out2")])


def _port_model_dir(tmp_path, cfg=CFG):
    t = _trainer(cfg, tmp_path / "model")
    t.save(0)
    _write_config(tmp_path / "model" / "nnet" / "config.json", cfg)
    (tmp_path / "model" / "nnet" / "feature_dim").write_text("20\n")
    return t, str(tmp_path / "model"), str(tmp_path / "model" / "nnet")


def test_export_cli_step_and_pointer(tmp_path):
    """--checkpoint 0 exports an older step and leaves the source pointer
    where it was; --momentum-slots adds the zero slots."""
    t, model, nnet = _port_model_dir(tmp_path)
    t.save(5)
    assert checkpoints.read_pointer(nnet) == 5
    out = str(tmp_path / "tf_old")
    assert export_cli.main(["--checkpoint", "0", "--momentum-slots", model, out]) == 0
    assert checkpoints.read_pointer(nnet) == 5
    got = tf_bundle.read_tf_checkpoint(os.path.join(out, "model-0"))
    assert int(got["global_step"]) == 0
    assert not np.any(got["tdnn/tdnn1_conv/kernel/Momentum"])
    assert "tdnn/tdnn1_bn/moving_mean/Momentum" not in got
    with open(os.path.join(out, "checkpoint")) as f:
        assert 'model_checkpoint_path: "model-0"' in f.read()


def test_export_cli_failure_writes_nothing(tmp_path, monkeypatch):
    """An export with unmapped variables and no --allow-partial exits 1 and
    writes nothing; with it, the mapped rest is written."""
    _, model, _ = _port_model_dir(tmp_path)
    real_map = tf_export.map_flax_leaf

    def partial_map(coll, path):
        return None if path and path[-1] == "kernel" else real_map(coll, path)

    monkeypatch.setattr(tf_export, "map_flax_leaf", partial_map)
    out = str(tmp_path / "tf_out")
    assert export_cli.main([model, out]) == 1
    assert not os.path.exists(out)
    assert export_cli.main(["--allow-partial", model, out]) == 0
    got = tf_bundle.read_tf_checkpoint(os.path.join(out, "model-0"))
    assert "tdnn/tdnn1_conv/bias" in got and "tdnn/tdnn1_conv/kernel" not in got


def test_export_cli_from_a_jax_msgpack_dir(tmp_path):
    """A model dir the JAX package wrote (``model-<step>.msgpack``) exports
    through the port byte-equal to the JAX CLI's export of it."""
    from flax import serialization

    from tf_kaldi_speaker_tpu.cli import export_tf_checkpoint as jax_export_cli

    t = _trainer(_CFG_VLAD, tmp_path / "src")
    tree = _numpy(convert.variables_of(t.network_model))
    nnet = tmp_path / "jaxmodel" / "nnet"
    nnet.mkdir(parents=True)
    (nnet / "model-4.msgpack").write_bytes(serialization.msgpack_serialize(
        {"params": tree["params"], "batch_stats": tree["batch_stats"], "step": np.int32(4)}))
    (nnet / "checkpoint").write_text('model_checkpoint_path: "model-4"\n')
    _write_config(nnet / "config.json", _CFG_VLAD)
    assert export_cli.main([str(tmp_path / "jaxmodel"), str(tmp_path / "port")]) == 0
    assert jax_export_cli.main([str(tmp_path / "jaxmodel"), str(tmp_path / "jax")]) == 0
    for name in ("model-4.index", "model-4.data-00000-of-00001", "checkpoint", "config.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
