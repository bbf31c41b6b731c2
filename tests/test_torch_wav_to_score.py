"""The wav-to-score slice as a whole, tiny, on the CPU: 6 synthetic wavs
from 3 speakers through the JAX package's chain (``make_mfcc --compress``
-> ``compute_vad`` -> ``extract --cmvn --vad`` -> ``score``) and through
the port's (the same CLIs with ``--device cpu``; ``extract`` both on the
host path and with ``--device-pipe``), from one model dir: a TDNN of
small widths whose JAX variables are numpy draws into ``jax.eval_shape``'s
tree, saved as a JAX msgpack checkpoint, which the port's converter reads.
A second chain runs ``prepare_feats`` and extracts without flags.

Tolerances: features and VAD byte-equal; embeddings rtol 1e-4 / atol 1e-5
on the host path and rtol 2e-4 / atol 2e-5 through the device pipe (as
``test_torch_extract.py``); cosine scores within 1e-5 absolute; the EER
equal."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_zoo_pooling import fill_variables
from tf_kaldi_speaker_tpu.cli import compute_vad as jax_vad
from tf_kaldi_speaker_tpu.cli import extract as jax_extract
from tf_kaldi_speaker_tpu.cli import make_mfcc as jax_mfcc
from tf_kaldi_speaker_tpu.cli import prepare_feats as jax_prep
from tf_kaldi_speaker_tpu.cli import score as jax_score
from tf_kaldi_speaker_tpu.models import EntireNetwork as JaxEntireNetwork
from tf_kaldi_speaker_tpu.train import checkpoints as jax_checkpoints
from tf_kaldi_speaker_tpu_torch.cli import compute_vad, extract, make_mfcc, prepare_feats, score
from tf_kaldi_speaker_tpu_torch.kio import read_vec_flt_scp
from tf_kaldi_speaker_tpu_torch.utils.testdata import make_wav_data_dir, write_trials

D = 30
TINY = dict(seed=0, network_type="tdnn", tdnn_layer_size=16, num_nodes_pooling_layer=32,
            num_nodes_last_layer=16, pooling_type="statistics_pooling",
            embedding_node="tdnn6_dense", batchnorm_momentum=0.99)
EMB_TOL = dict(rtol=1e-4, atol=1e-5)
PIPE_TOL = dict(rtol=2e-4, atol=2e-5)
SCORE_ATOL = 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("wav_to_score")
    data = make_wav_data_dir(str(root / "data"), num_speakers=3, utts_per_speaker=2,
                             min_seconds=1.0, max_seconds=2.5, seed=1)
    u2s = dict(line.split() for line in open(data["utt2spk"]))
    trials = write_trials(str(root / "trials"), u2s)
    assert len(trials) == 15 and sum(t for _, _, t in trials) == 3

    net = JaxEntireNetwork(config=TINY, network_type="tdnn")
    shapes = jax.eval_shape(lambda k, x: net.init(k, x, False), jax.random.PRNGKey(0),
                            jnp.zeros((2, 40, D)))
    variables = jax.tree.map(np.asarray, fill_variables(shapes, 3))
    nnet = str(root / "model" / "nnet")
    jax_checkpoints.save_checkpoint(nnet, {"params": {"network": variables["params"]},
                                           "batch_stats": {"network": variables["batch_stats"]}},
                                    0)
    with open(os.path.join(nnet, "config.json"), "w") as f:
        json.dump(TINY, f)
    with open(os.path.join(nnet, "feature_dim"), "w") as f:
        f.write("%d\n" % D)
    return dict(root=str(root), data=data, trials=str(root / "trials"),
                model=str(root / "model"))


def _chain(corpus, name, mfcc_main, vad_main, prep_main, extract_main, score_main, capsys,
           cpu, pipe=()):
    d = os.path.join(corpus["root"], name)
    feats = os.path.join(d, "mfcc")
    assert mfcc_main(["--compress"] + cpu + [corpus["data"]["wav_scp"], feats]) == 0
    assert vad_main(cpu + [os.path.join(feats, "feats.scp"), feats]) == 0
    assert prep_main(cpu + [feats, os.path.join(d, "egs")]) == 0
    out = {}
    for path, flags, scp in (("raw", ["--cmvn", "--vad"], feats),
                             ("egs", [], os.path.join(d, "egs"))):
        for variant, extra in (("host", []), ("pipe", list(pipe))):
            if variant == "pipe" and not pipe:
                continue
            xv = os.path.join(d, "xvector_%s_%s" % (path, variant))
            assert extract_main(flags + extra + cpu + [
                "--min-chunk-size", "10", "--batch-size", "4", corpus["model"],
                "scp:" + os.path.join(scp, "feats.scp"), "ark,scp:%s.ark,%s.scp" % (xv, xv)]) == 0
            assert score_main(["--backend", "cosine", "--enroll-scp", xv + ".scp",
                               "--test-scp", xv + ".scp", "--trials", corpus["trials"],
                               "--scores", xv + ".scores"]) == 0
            report = capsys.readouterr().out
            out[path, variant] = dict(
                emb=dict(read_vec_flt_scp(xv + ".scp")),
                scores=np.loadtxt(xv + ".scores", usecols=2),
                eer=float(report.split("EER: ")[1].split("%")[0]))
    return out, d


def test_wav_to_score_matches_jax(corpus, capsys):
    want, jdir = _chain(corpus, "jax", jax_mfcc.main, jax_vad.main, jax_prep.main,
                        jax_extract.main, jax_score.main, capsys, [])
    got, pdir = _chain(corpus, "port", make_mfcc.main, compute_vad.main, prepare_feats.main,
                       extract.main, score.main, capsys, ["--device", "cpu"], ["--device-pipe"])
    for name in ("mfcc/feats.ark", "mfcc/vad.ark", "egs/feats.ark"):
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(pdir, name), "rb") as b:
            assert a.read() == b.read(), name
    utts = corpus["data"]["utts"]
    for (path, variant), run in got.items():
        ref = want[path, "host"]
        assert sorted(run["emb"]) == sorted(ref["emb"]) == sorted(utts)
        tol = PIPE_TOL if variant == "pipe" else EMB_TOL
        for k in utts:
            np.testing.assert_allclose(run["emb"][k], ref["emb"][k], err_msg=k, **tol)
        np.testing.assert_allclose(run["scores"], ref["scores"], rtol=0, atol=SCORE_ATOL)
        assert run["eer"] == ref["eer"], (path, variant)
        assert np.ptp(ref["scores"]) > 0.01
