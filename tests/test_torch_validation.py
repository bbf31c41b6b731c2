"""The port's validation harnesses (tf_kaldi_speaker_tpu_torch.validation)
against the JAX side's scripts on the CPU: every copied constant equal to
the script's; the corpora byte-equal to the scripts' output (the size
constants made small in both); the rank test, the band rule, the oracle
EER and the EER protocol equal to JAX's on fixed inputs; the recorded JAX
rows equal to the rows of docs/VALIDATION.md; and the slice as a whole:
``quality_matrix.train_and_eer`` and ``convergence run --arm torch`` (pool
path, float32, width 16, 12 speakers, 2 epochs x 4 steps) from the JAX
trainer's initial variables, against the scripts' ``train_and_eer`` and
``run_tpu`` on the same corpus: embeddings within 1 - cos 1e-5, the EER
equal, the per-epoch valid losses within 1e-5."""

import contextlib
import filecmp
import io
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import scripts.attention_validation as j_att  # noqa: E402
import scripts.ecapa_validation as j_ecapa  # noqa: E402
import scripts.multitask_validation as j_mt  # noqa: E402
import scripts.quality_matrix as j_qm  # noqa: E402
import scripts.reference_convergence as j_conv  # noqa: E402
import scripts.resnet_validation as j_resnet  # noqa: E402
import scripts.synthetic_validation as j_syn  # noqa: E402
from tf_kaldi_speaker_tpu.extract.extractor import Extractor as JaxExtractor  # noqa: E402
from tf_kaldi_speaker_tpu.parallel.mesh import make_mesh  # noqa: E402
from tf_kaldi_speaker_tpu.train import trainer as jtrainer_mod  # noqa: E402
from tf_kaldi_speaker_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from tf_kaldi_speaker_tpu.utils.params import ParamsPlain as JaxParams  # noqa: E402
from tf_kaldi_speaker_tpu_torch.extract.extractor import Extractor  # noqa: E402
from tf_kaldi_speaker_tpu_torch.kio import read_mat_scp  # noqa: E402
from tf_kaldi_speaker_tpu_torch.utils.testdata import make_fake_data_dir  # noqa: E402
from tf_kaldi_speaker_tpu_torch.validation import (attention, common, convergence,  # noqa: E402
                                                   corpora, ecapa, multitask,
                                                   quality_matrix, resnet)

torch.set_num_threads(1)

DOC = os.path.join(ROOT, "docs", "VALIDATION.md")
# The hard corpus and the convergence corpus, cut small in both packages
HARD_SMALL = dict(HARD_NSPK=5)
CONV_SMALL = dict(NSPK=6, UTTS=4, TEST_NSPK=3)
# The slice as a whole: the pool path in float32 at width 16
TINY = dict(tdnn_layer_size=16, num_nodes_pooling_layer=24, num_nodes_last_layer=16,
            num_speakers_per_batch=4, min_segment_len=48, max_segment_len=48,
            num_buckets=1, device_pool=True, device_decode=False, valid_max_iterations=20,
            show_training_progress=0)
NSPK_TINY = 12
LRS_TINY = [0.04, 0.02]
STEPS_TINY = 4
COS_GAP = 1e-5


def _one_device_jax(monkeypatch):
    """The JAX trainers on one CPU device (the conftest gives eight)."""
    make = jtrainer_mod.make_mesh
    monkeypatch.setattr(jtrainer_mod, "make_mesh",
                        lambda **kw: make(devices=jax.devices()[:1], **kw))


def _jax_init(cfg, path, dim, num_speakers):
    """The JAX trainer's initial variables for ``cfg`` (its seed)."""
    jt = JaxTrainer(JaxParams(**cfg), str(path), dim=dim, num_speakers=num_speakers,
                    mesh=make_mesh(devices=jax.devices()[:1]))
    jt.build("train", dim, cfg["loss_func"], num_speakers)
    return {"params": jax.device_get(jt.state.params),
            "batch_stats": jax.device_get(jt.state.batch_stats)}


# ---------------------------------------------------------------- constants

@pytest.mark.parametrize("port, jax_value", [
    (quality_matrix.CFG, j_syn.CFG),
    (quality_matrix.EPOCH_LRS, j_qm.EPOCH_LRS),
    ({k: v for k, v in quality_matrix.PATHS.items() if k != "pool_bf16_fused"}, j_qm.PATHS),
    (quality_matrix.LOSSES, j_qm.LOSSES),
    (convergence.BASE_CFG, j_conv.BASE_CFG),
    (convergence.LOSSES, j_conv.LOSSES),
    (convergence.MT_CFG, j_conv.MT_CFG),
    (convergence.EPOCH_LRS, j_conv.EPOCH_LRS),
    (attention.CFG, j_att.CFG),
    (ecapa.CFG, j_ecapa.CFG),
    (resnet.CFG, j_resnet.CFG),
    (multitask.CFG, j_mt.CFG),
    (multitask.NUM_PHONES, j_mt.NUM_PHONES),
    ((corpora.HARD_DIM, corpora.HARD_NSPK, corpora.HARD_CHAN),
     (j_syn.HARD_DIM, j_syn.HARD_NSPK, j_syn.HARD_CHAN)),
    ((corpora.DIM, corpora.NSPK, corpora.UTTS, corpora.CHAN, corpora.TEST_NSPK,
      corpora.MT_NUM_PHONES, corpora.MT_PHONE_SIGNAL),
     (j_conv.DIM, j_conv.NSPK, j_conv.UTTS, j_conv.CHAN, j_conv.TEST_NSPK,
      j_conv.MT_NUM_PHONES, j_conv.MT_PHONE_SIGNAL)),
], ids=["CFG", "EPOCH_LRS", "PATHS", "LOSSES", "BASE_CFG", "conv_LOSSES", "MT_CFG",
        "conv_EPOCH_LRS", "attention", "ecapa", "resnet", "multitask", "mt_phones",
        "hard_corpus", "conv_corpus"])
def test_constants_equal_the_scripts(port, jax_value):
    assert port == jax_value
    assert json.dumps(port, sort_keys=True) == json.dumps(jax_value, sort_keys=True)


def test_pool_bf16_fused_is_pool_bf16_with_the_fused_kernels():
    assert quality_matrix.PATHS["pool_bf16_fused"] == dict(
        j_qm.PATHS["pool_bf16"], use_fused_pooling=True)
    assert quality_matrix.JUDGED_BY == {"pool_bf16_fused": "pool_bf16"}
    assert convergence.arm_config("amsoftmax", 1, 400, program="flagship") == dict(
        j_conv.BASE_CFG, seed=1, **j_conv.LOSSES["amsoftmax"], compute_dtype="bfloat16",
        device_pool=True, use_fused_pooling=True)


# ---------------------------------------------------------------- the record

def _doc_lines(first, last):
    with open(DOC) as f:
        return f.read().splitlines()[first - 1:last]


def test_recorded_convergence_rows_equal_the_doc():
    """JAX_ROWS is the framework and reference rows of the head-to-head
    table, docs/VALIDATION.md:316-381."""
    rows = []
    for line in _doc_lines(316, 381):
        cells = [c.strip() for c in line.strip("|").split("|")]
        if cells[0] not in ("ref", "tpu", "tpu-bf16"):
            continue
        rows.append((cells[0], cells[1], None if cells[2] == "-" else int(cells[2]),
                     tuple(float(v) for v in cells[3].split()),
                     round(float(cells[4].rstrip("%")) / 100, 6)))
    assert len(rows) == 42
    assert [(a, b, c, d, round(e, 6)) for a, b, c, d, e in convergence.JAX_ROWS] == rows


def _seeds(cells):
    return [round(float(v) / 100, 6) for v in cells.split()]


def test_recorded_quality_rows_equal_the_doc():
    """JAX_PATHS and JAX_LOSSES are the seeds of the quality matrix's
    tables, docs/VALIDATION.md:438-444 and :480-482."""
    names = {"stream": "stream", "pool (full-resident)": "pool",
             "**pool_bf16 (the bench.py flagship program)**": "pool_bf16",
             "pool_rot_utts (budget-forced; default unit)": "pool_rot_utts",
             "pool_rot, speaker windows (1 cycle/epoch)": "pool_rot",
             "pool_rot, speaker windows (3 cycles/epoch)": "pool_rot_c3"}
    paths = {}
    for line in _doc_lines(438, 444):
        cells = [c.strip() for c in line.strip("|").split("|")]
        if cells[0] in names:
            paths[names[cells[0]]] = _seeds(cells[2])
    assert paths == {k: [round(v, 6) for v in vs] for k, vs in quality_matrix.JAX_PATHS.items()}
    losses = {}
    for line in _doc_lines(480, 482):
        cells = [c.strip() for c in line.strip("|").split("|")]
        assert cells[1] == "6x500"
        losses[cells[0]] = _seeds(cells[3])
    assert losses == {k: [round(v, 6) for v in vs]
                      for k, vs in quality_matrix.JAX_LOSSES.items()}


# ---------------------------------------------------------------- statistics

@pytest.mark.parametrize("ref, tpu", [
    ([0.1847, 0.1794, 0.1822], [0.1893, 0.1889, 0.1929, 0.1861, 0.1961]),
    ([0.1740, 0.1811], [0.1739, 0.1768, 0.1814]),
    ([0.18, 0.18, 0.19], [0.18, 0.19, 0.2]),
    ([0.1], [0.3, 0.2]),
])
def test_exact_rank_p_equals_jax(ref, tpu):
    assert common._exact_rank_p(ref, tpu) == j_conv._exact_rank_p(ref, tpu)


def test_band_rule_equals_jax(tmp_path):
    """The band JAX's report prints for a bf16 row against 3 f32 seeds,
    for an sd above and below the 0.5% floor."""
    for eers in ([0.1789, 0.1808, 0.1849], [0.1800, 0.1801, 0.1802]):
        res = tmp_path / ("r%d" % len(os.listdir(tmp_path))) / "results"
        res.mkdir(parents=True)
        for seed, eer in enumerate(eers, start=1):
            (res / ("t%d.json" % seed)).write_text(json.dumps(dict(
                arm="tpu", loss="amsoftmax", seed=seed, dtype="float32", valid_loss=[1.0],
                eer=eer)))
        (res / "b.json").write_text(json.dumps(dict(
            arm="tpu", loss="amsoftmax", seed=1, dtype="bfloat16", valid_loss=[1.0],
            eer=0.18)))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            j_conv.report(str(res.parent), False)
        printed = float(re.search(r"3σ band ±([0-9.]+)%", out.getvalue()).group(1))
        assert printed == float("%.2f" % (common.band(np.std(eers, ddof=1)) * 100))
        j = common.judge([0.18], eers)
        assert j["band"] == common.band(np.std(eers, ddof=1))
    assert common.band(0.001) == 3 * 0.005 and common.band(0.01) == 0.03


@pytest.fixture(scope="module")
def hard(tmp_path_factory):
    """The hard corpus, small, from both packages."""
    root = tmp_path_factory.mktemp("hard")
    mp = pytest.MonkeyPatch()
    try:
        for k, v in HARD_SMALL.items():
            mp.setattr(corpora, k, v)
            mp.setattr(j_syn, k, v)
        port = corpora.make_hard_corpora(str(root / "port"))
        jax_dirs = j_syn.make_hard_corpora(str(root / "jax"))
    finally:
        mp.undo()
    return root, port, jax_dirs


def _same_tree(a, b):
    """Every file under ``a`` byte-equal to its twin under ``b``, scp paths
    read relative to each root."""
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".scp"):
            assert open(pa).read().replace(a, "ROOT") == open(pb).read().replace(b, "ROOT"), rel
        else:
            assert filecmp.cmp(pa, pb, shallow=False), rel
    return files


def test_hard_corpora_are_byte_equal(hard):
    root, port, jax_dirs = hard
    files = _same_tree(str(root / "port"), str(root / "jax"))
    assert "train/feats.ark" in files and "test/feats.ark" in files
    assert [d["data"] for d in port] == [str(root / "port" / s) for s in ("train", "test")]


@pytest.mark.parametrize("mt", [False, True], ids=["speaker", "multitask"])
def test_convergence_corpora_are_byte_equal(tmp_path, monkeypatch, mt):
    for k, v in CONV_SMALL.items():
        monkeypatch.setattr(corpora, k, v)
        monkeypatch.setattr(j_conv, k, v)
    (corpora.make_data_mt if mt else corpora.make_data)(str(tmp_path / "port"))
    (j_conv.make_data_mt if mt else j_conv.make_data)(str(tmp_path / "jax"))
    # the reference arm's tree-info stub is not ported
    if mt:
        os.remove(str(tmp_path / "jax" / "bin" / "tree-info"))
        os.rmdir(str(tmp_path / "jax" / "bin"))
    files = _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    prefix = "mt_" if mt else ""
    assert {prefix + "valid/spk2utt", prefix + "train/feats.ark"} <= set(files)


def test_oracle_and_eer_protocol_equal_jax(hard):
    _, port, jax_dirs = hard
    test_d = port[1]
    assert common.oracle_eer(test_d) == j_qm.oracle_eer(jax_dirs[1])
    proj = np.random.RandomState(0).randn(corpora.HARD_DIM, 5)

    def embed(feats):
        return np.tanh(feats @ proj).mean(0)

    assert common._test_eer(embed, test_d["data"]) == j_conv._test_eer(
        embed, jax_dirs[1]["data"])
    vals = [0.1917, 0.1961, 0.1873]
    assert common.fmt_mean_sd(vals) == j_qm.fmt_mean_sd(vals)


def test_shuffled_labels_keep_counts_and_lose_speakers(hard, tmp_path):
    train = hard[1][0]["data"]
    out = corpora.shuffle_labels(train, str(tmp_path / "shuf"))
    want = dict(line.split() for line in open(os.path.join(train, "utt2spk")))
    got = dict(line.split() for line in open(os.path.join(out["data"], "utt2spk")))
    assert sorted(got) == sorted(want)
    assert sorted(got.values()) == sorted(want.values())
    assert sum(got[u] == want[u] for u in got) < len(got) / 2
    spk2utt = dict((line.split()[0], line.split()[1:])
                   for line in open(os.path.join(out["data"], "spk2utt")))
    assert all(got[u] == s for s, us in spk2utt.items() for u in us)


# ---------------------------------------------------------------- reports

def _result(root, loss, seed, eer, dtype="float32", program=""):
    os.makedirs(os.path.join(root, "results"), exist_ok=True)
    with open(os.path.join(root, "results", "torch_%s_s%d_%s%s.json"
                           % (loss, seed, dtype, program)), "w") as f:
        json.dump(dict(arm="torch", loss=loss, seed=seed, dtype=dtype, program=program,
                       deterministic=False, valid_loss=[3.0, 2.0, 1.0], eer=eer,
                       wall_s=1.0, card="cpu (not a card)"), f)


def test_convergence_report_gates_each_family(tmp_path, capsys):
    """A family inside its JAX band passes, one outside fails, a program
    with fewer than 3 seeds fails; bf16 and flagship against am-softmax."""
    root = str(tmp_path)
    for seed, eer in ((1, 0.178), (2, 0.181), (3, 0.184)):
        _result(root, "amsoftmax", seed, eer)
        _result(root, "amsoftmax", seed, eer + 0.002, "bfloat16", "flagship")
        _result(root, "softmax", seed, eer - 0.005)
    assert convergence.report(root, False) == 0
    assert "rank | amsoftmax | f32 3v3" in capsys.readouterr().out
    _result(root, "asoftmax_m1", 1, 0.25)
    _result(root, "asoftmax_m1", 2, 0.25)
    _result(root, "asoftmax_m1", 3, 0.25)
    assert convergence.report(root, False) == 1
    out = capsys.readouterr().out
    assert "| check | asoftmax_m1 | f32 mean | torch 25.00%" in out and "FAIL" in out
    root2 = str(tmp_path / "two")
    _result(root2, "amsoftmax", 1, 0.18, "bfloat16")
    assert convergence.report(root2, False) == 1


def test_quality_report_gates_each_arm(capsys):
    good = {"paths": {"pool": [0.188, 0.19, 0.185], "pool_bf16_fused": [0.19, 0.193, 0.19]}}
    assert quality_matrix.report(good, 0.1657, [0, 1, 2], False) == 0
    assert "pool_bf16 19.17%" in capsys.readouterr().out
    bad = {"paths": {"pool_bf16_fused": [0.25, 0.25, 0.25]}}
    assert quality_matrix.report(bad, 0.1657, [0, 1, 2], False) == 1
    one_loss = {"losses": {"softmax": [0.187, 0.187, 0.181, 0.187, 0.191]}}
    assert quality_matrix.report(one_loss, 0.1657, [0, 1, 2], False) == 0
    assert "Margin-beats-softmax" not in capsys.readouterr().out


# ---------------------------------------------------------------- the slice

def _embeddings(extractor, test_dir):
    keys, embs = [], []
    for key, feats in read_mat_scp(os.path.join(test_dir, "feats.scp")):
        keys.append(key)
        embs.append(extractor.embed_utterance(feats))
    return keys, np.stack(embs)


def _one_minus_cos(a, b):
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    return float(np.max(1.0 - np.sum(a * b, axis=1)))


def test_train_and_eer_matches_jax(tmp_path, monkeypatch):
    """quality_matrix.train_and_eer on the pool path from the JAX trainer's
    initial variables: the EER equal to the script's train_and_eer, the
    trained models' embeddings within 1 - cos 1e-5."""
    _one_device_jax(monkeypatch)
    cfg = dict(j_syn.CFG, **TINY)
    for mod in (j_qm, quality_matrix):
        monkeypatch.setattr(mod, "CFG", cfg)
    monkeypatch.setattr(j_qm, "HARD_NSPK", NSPK_TINY)
    monkeypatch.setattr(corpora, "HARD_NSPK", NSPK_TINY)
    train_d = make_fake_data_dir(str(tmp_path / "train"), num_speakers=NSPK_TINY,
                                 utts_per_speaker=3, dim=corpora.HARD_DIM, min_len=60,
                                 max_len=90, seed=0, spk_scale=1.0, chan_scale=0.9)
    test_d = make_fake_data_dir(str(tmp_path / "test"), num_speakers=4, utts_per_speaker=4,
                                dim=corpora.HARD_DIM, min_len=100, max_len=120, seed=777,
                                spk_offset=5000, spk_scale=1.0, chan_scale=0.9)
    over = quality_matrix.PATHS["pool"]
    kw = dict(epoch_lrs=LRS_TINY, steps_per_epoch=STEPS_TINY, width=16)
    cfg_run = quality_matrix.arm_config(0, over, STEPS_TINY, 16)
    assert cfg_run == dict(cfg, num_steps_per_epoch=STEPS_TINY, seed=0, num_parallel_datasets=1,
                           **over, tdnn_layer_size=16, num_nodes_pooling_layer=32)
    v0 = _jax_init(cfg_run, tmp_path / "init", corpora.HARD_DIM, NSPK_TINY)
    want = j_qm.train_and_eer(str(tmp_path / "jax"), train_d, test_d, "pool", 0, over, **kw)
    got = quality_matrix.train_and_eer(str(tmp_path / "port"), train_d, test_d, "pool", 0, over,
                                       device="cpu", init_variables=v0, **kw)
    assert got == want
    jkeys, jemb = _embeddings(JaxExtractor(str(tmp_path / "jax" / "exp_pool_s0"),
                                           min_chunk_size=25, batch_size=32), test_d["data"])
    keys, emb = _embeddings(Extractor(str(tmp_path / "port" / "exp_pool_s0"), min_chunk_size=25,
                                      batch_size=32, device="cpu"), test_d["data"])
    assert keys == jkeys
    assert _one_minus_cos(emb, jemb) <= COS_GAP


def test_convergence_run_matches_jax(tmp_path, monkeypatch):
    """``convergence run --arm torch`` against the script's ``run_tpu`` on
    the same (small) corpus from the JAX trainer's initial variables: the
    per-epoch valid losses within 1e-5, the EER equal, the embeddings
    within 1 - cos 1e-5."""
    _one_device_jax(monkeypatch)
    base = dict(j_conv.BASE_CFG, **TINY)
    for mod in (j_conv, convergence):
        monkeypatch.setattr(mod, "BASE_CFG", base)
        monkeypatch.setattr(mod, "EPOCH_LRS", LRS_TINY)
    for mod in (j_conv, corpora):
        for k, v in dict(NSPK=NSPK_TINY, UTTS=5, TEST_NSPK=4).items():
            monkeypatch.setattr(mod, k, v)
    root = str(tmp_path)
    corpora.make_data(root)
    cfg = convergence.arm_config("amsoftmax", 1, STEPS_TINY)
    v0 = _jax_init(cfg, tmp_path / "init", corpora.DIM, NSPK_TINY)
    j_conv.run_tpu(root, "amsoftmax", 1, STEPS_TINY, str(tmp_path / "jax.json"))
    got = convergence.run_torch(root, "amsoftmax", 1, STEPS_TINY, str(tmp_path / "port.json"),
                                device="cpu", init_variables=v0)
    want = json.load(open(str(tmp_path / "jax.json")))
    assert got == json.load(open(str(tmp_path / "port.json")))
    assert len(got["valid_loss"]) == len(want["valid_loss"]) == 2
    np.testing.assert_allclose(got["valid_loss"], want["valid_loss"], rtol=1e-5, atol=1e-5)
    assert got["eer"] == want["eer"]
    assert got["dtype"] == want["dtype"] == "float32" and got["card"] == "cpu (not a card)"
    test_dir = os.path.join(root, "test")
    jkeys, jemb = _embeddings(JaxExtractor(os.path.join(root, "exp_tpu_amsoftmax_s1"),
                                           min_chunk_size=25, batch_size=32), test_dir)
    keys, emb = _embeddings(Extractor(os.path.join(root, "exp_torch_amsoftmax_s1"),
                                      min_chunk_size=25, batch_size=32, device="cpu"), test_dir)
    assert keys == jkeys
    assert _one_minus_cos(emb, jemb) <= COS_GAP
