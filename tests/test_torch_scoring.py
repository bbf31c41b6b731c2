"""The port's scoring back end against the JAX package's, on seeded
synthetic embeddings (modelled on ``test_plda.py``, ``test_score_cli.py``,
``test_calibration.py`` and ``test_tools_cli.py::test_plot_det_cli``).

Every comparison is exact: the port's back end is the same numpy code in
float64, so arrays are ``assert_array_equal``, floats ``==``, and files and
stdout reports byte-equal. The npz format is compared member by member
(the .npy bytes of each array): the zip container stamps each member with
the time it was written."""

import io
import os
import zipfile
from contextlib import redirect_stdout

import numpy as np
import pytest

from tf_kaldi_speaker_tpu.backend import calibration as jcal
from tf_kaldi_speaker_tpu.backend import metrics as jmetrics
from tf_kaldi_speaker_tpu.backend import plda as jplda
from tf_kaldi_speaker_tpu.backend import scoring as jscoring
from tf_kaldi_speaker_tpu.cli import calibrate_scores as jax_calibrate
from tf_kaldi_speaker_tpu.cli import copy_plda as jax_copy_plda
from tf_kaldi_speaker_tpu.cli import plot_det as jax_plot_det
from tf_kaldi_speaker_tpu.cli import score as jax_score
from tf_kaldi_speaker_tpu_torch import backend
from tf_kaldi_speaker_tpu_torch.backend import calibration, metrics, plda, scoring
from tf_kaldi_speaker_tpu_torch.cli import calibrate_scores, copy_plda, plot_det, score
from tf_kaldi_speaker_tpu_torch.kio import write_mat, write_vec_flt

_BASIS = np.linalg.qr(np.random.RandomState(12345).randn(16, 16))[0]


def synth_data(rng, n_spk=40, per=12, dim=16):
    """Two-covariance data with anisotropic within-class noise
    (``test_plda.py``)."""
    q = _BASIS[:dim, :dim]
    ys = rng.randn(n_spk, dim) * np.linspace(0.5, 3.0, dim)[::-1] @ q.T
    xs, labels = [], []
    for i in range(n_spk):
        xs.append(ys[i] + rng.randn(per, dim) * np.linspace(0.2, 2.0, dim) @ q.T)
        labels += [i] * per
    return np.concatenate(xs), np.asarray(labels)


def _eq_plda(a, b):
    for name in ("mean", "transform", "psi"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


def test_backend_exports_match_jax():
    from tf_kaldi_speaker_tpu import backend as jbackend

    asr = {"DecodeResult", "Lattice", "LatticeArc", "WfstDecoder", "arc_posteriors",
           "best_path_confidences", "compute_wer", "decode_faster_py", "decode_lattice_py",
           "depth_stats", "edit_distance", "read_lattice_ark", "read_text_file",
           "write_lattice"}
    assert set(backend.__all__) == set(jbackend.__all__) - asr


def test_lda_and_train_plda_bit_equal():
    x, labels = synth_data(np.random.RandomState(0))
    for f in (0.0, 0.1):
        a = scoring.LDA(10, total_covariance_factor=f).fit(x, labels)
        b = jscoring.LDA(10, total_covariance_factor=f).fit(x, labels)
        np.testing.assert_array_equal(a.transform, b.transform)
        np.testing.assert_array_equal(a.mean, b.mean)
        np.testing.assert_array_equal(a.transform_vecs(x), b.transform_vecs(x))
    for iters in (1, 10):
        _eq_plda(plda.train_plda(x, labels, iters), jplda.train_plda(x, labels, iters))
    np.testing.assert_array_equal(scoring.length_norm(x), jscoring.length_norm(x))
    np.testing.assert_array_equal(scoring.length_norm(x, False), jscoring.length_norm(x, False))
    for got, want in zip(scoring.subtract_global_mean(x), jscoring.subtract_global_mean(x)):
        np.testing.assert_array_equal(got, want)
    keys = ["u%d" % i for i in range(len(x))]
    u2s = {k: "s%02d" % lab for k, lab in zip(keys, labels)}
    got, want = scoring.speaker_means(keys, x, u2s), jscoring.speaker_means(keys, x, u2s)
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])


def test_plda_scoring_adapt_and_smoothing_bit_equal():
    rng = np.random.RandomState(1)
    x, labels = synth_data(rng)
    model, jmodel = plda.train_plda(x, labels), jplda.train_plda(x, labels)
    shifted, _ = synth_data(np.random.RandomState(2), n_spk=20, per=4)
    shifted = shifted * 1.7 + 0.5
    for kw in (dict(), dict(mean_diff_scale=0.5, within_covar_scale=0.75,
                            between_covar_scale=0.25)):
        _eq_plda(model.adapt(shifted, **kw), jmodel.adapt(shifted, **kw))
    for factor in (0.0, 0.1):
        _eq_plda(model.smooth_within_class_covariance(factor),
                 jmodel.smooth_within_class_covariance(factor))
    enroll = {"e%d" % i: x[i] for i in range(0, 60, 3)}
    counts = {k: 1 + i % 3 for i, k in enumerate(sorted(enroll))}
    test = {"t%d" % i: x[i] for i in range(1, 90, 4)}
    trials = [(e, t) for e in sorted(enroll) for t in sorted(test)]
    for simple in (False, True):
        got = model.score_matrix(enroll, counts, test, simple)
        want = jmodel.score_matrix(enroll, counts, test, simple)
        assert got[:2] == want[:2]
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(model.score_trials(enroll, counts, test, trials, simple),
                                      jmodel.score_trials(enroll, counts, test, trials, simple))
    u, f = model.transform_ivector(x[0], 3)
    ju, jf = jmodel.transform_ivector(x[0], 3)
    np.testing.assert_array_equal(u, ju)
    assert f == jf
    assert model.log_likelihood_ratio(u, 3, x[5]) == jmodel.log_likelihood_ratio(ju, 3, x[5])


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("fmt", ["kaldi", "kaldi_text", "npz"])
def test_plda_save_formats_byte_equal(tmp_path, fmt):
    x, labels = synth_data(np.random.RandomState(3), n_spk=20, per=6, dim=8)
    model = plda.train_plda(x, labels)
    jmodel = jplda.Plda(mean=model.mean, transform=model.transform, psi=model.psi)
    ext = ".npz" if fmt == "npz" else ""
    mine, theirs = str(tmp_path / ("port" + ext)), str(tmp_path / ("jax" + ext))
    model.save(mine, format=fmt)
    jmodel.save(theirs, format=fmt)
    if fmt == "npz":
        assert _npz_members(mine) == _npz_members(theirs)
    else:
        assert open(mine, "rb").read() == open(theirs, "rb").read()
    # each side reads the other's file to the same arrays
    _eq_plda(plda.Plda.load(theirs), jplda.Plda.load(mine))
    _eq_plda(plda.Plda.load(mine), jplda.Plda.load(theirs))
    with pytest.raises(ValueError):
        model.save(str(tmp_path / "bad"), format="hdf5")


def test_plda_load_rejects_garbage(tmp_path):
    path = str(tmp_path / "junk")
    with open(path, "w") as f:
        f.write("not a plda")
    with pytest.raises(ValueError, match="not an npz"):
        plda.Plda.load(path)


def test_snorm_cosine_and_metrics_bit_equal():
    rng = np.random.RandomState(4)
    a, b, cohort = rng.randn(7, 12), rng.randn(9, 12), rng.randn(30, 12)
    np.testing.assert_array_equal(scoring.cosine_matrix(a, b), jscoring.cosine_matrix(a, b))
    for k in (0, 10, 30, 40):
        for got, want in zip(scoring.snorm_stats(scoring.cosine_matrix(a, cohort), k),
                             jscoring.snorm_stats(jscoring.cosine_matrix(a, cohort), k)):
            np.testing.assert_array_equal(got, want)
    enroll = {"e%d" % i: v for i, v in enumerate(a)}
    test = {"t%d" % i: v for i, v in enumerate(b)}
    trials = [(e, t) for e in enroll for t in test]
    s = scoring.cosine_score_trials(enroll, test, trials)
    np.testing.assert_array_equal(s, jscoring.cosine_score_trials(enroll, test, trials))
    ec = {k: (float(rng.randn()), float(rng.rand() + 0.1)) for k in enroll}
    tc = {k: (float(rng.randn()), float(rng.rand() + 0.1)) for k in test}
    np.testing.assert_array_equal(scoring.adaptive_snorm(s, trials, ec, tc),
                                  jscoring.adaptive_snorm(s, trials, ec, tc))

    labels = (rng.rand(400) < 0.2).astype(int)
    scores = rng.randn(400) + 1.5 * labels
    scores[:20] = scores[20:40]  # ties
    for got, want in zip(metrics.det_curve(scores, labels), jmetrics.det_curve(scores, labels)):
        np.testing.assert_array_equal(got, want)
    assert metrics.compute_eer(scores, labels) == jmetrics.compute_eer(scores, labels)
    for kw in (dict(), dict(p_target=0.001), dict(p_target=0.05, c_miss=10.0, c_fa=2.0)):
        assert metrics.compute_min_dcf(scores, labels, **kw) == \
            jmetrics.compute_min_dcf(scores, labels, **kw)
    for name in ("min_dcf08", "min_dcf10", "min_dcf12"):
        assert getattr(metrics, name)(scores, labels) == getattr(jmetrics, name)(scores, labels)
    emb, spk = rng.randn(40, 6), np.repeat(np.arange(8), 5)
    for mp in (None, 200):
        assert metrics.compute_cos_pairwise_eer(emb, spk, mp) == \
            jmetrics.compute_cos_pairwise_eer(emb, spk, mp)


def test_calibration_bit_equal():
    rng = np.random.default_rng(7)
    labels = (rng.random(600) < 0.25).astype(int)
    scores = 0.2 * rng.normal(2.0 * labels - 1.0, 1.0) - 3.0
    assert calibration.cllr(scores, labels) == jcal.cllr(scores, labels)
    assert calibration.min_cllr(scores, labels) == jcal.min_cllr(scores, labels)
    y, w = rng.random(50), rng.random(50) + 0.1
    np.testing.assert_array_equal(calibration.pav(y), jcal.pav(y))
    np.testing.assert_array_equal(calibration.pav(y, w), jcal.pav(y, w))
    for prior in (0.5, 0.01):
        a, b = calibration.logistic_calibration(scores, labels, prior=prior)
        assert (a, b) == jcal.logistic_calibration(scores, labels, prior=prior)
        cal = calibration.apply_calibration(scores, a, b)
        np.testing.assert_array_equal(cal, jcal.apply_calibration(scores, a, b))
        for op in ((0.01, 1.0, 1.0), (0.001, 10.0, 1.0)):
            assert calibration.bayes_threshold(*op) == jcal.bayes_threshold(*op)
            assert calibration.actual_dcf(cal, labels, *op) == jcal.actual_dcf(cal, labels, *op)
    for bad in ((scores, np.zeros_like(labels)), (scores[:3], labels)):
        with pytest.raises(ValueError):
            calibration.cllr(*bad)
        with pytest.raises(ValueError):
            jcal.cllr(*bad)


# ----------------------------------------------------------------------
# The CLIs: byte-equal output files and stdout.

def make_embeddings(rng, n_spk=12, per=6, dim=24):
    means = rng.randn(n_spk, dim) * 3
    out, utt2spk = {}, {}
    for s in range(n_spk):
        for u in range(per):
            key = "spk%02d_u%d" % (s, u)
            out[key] = means[s] + rng.randn(dim) * 0.8
            utt2spk[key] = "spk%02d" % s
    return out, utt2spk


def write_xvectors(prefix, embs):
    ark, scp = prefix + ".ark", prefix + ".scp"
    with open(ark, "wb") as fa, open(scp, "w") as fs:
        for k, v in embs.items():
            pos = fa.tell() + len(k) + 1
            write_vec_flt(fa, v.astype(np.float32), key=k)
            fs.write("%s %s:%d\n" % (k, ark, pos))
    return scp


@pytest.fixture(scope="module")
def score_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_score")
    train, train_u2s = make_embeddings(np.random.RandomState(0), n_spk=20, per=8)
    evalset, eval_u2s = make_embeddings(np.random.RandomState(1), n_spk=8, per=6)
    cohort, _ = make_embeddings(np.random.RandomState(5), n_spk=15, per=2)
    shifted = {k: v * 1.3 + 0.7 for k, v in
               make_embeddings(np.random.RandomState(6), n_spk=10, per=3)[0].items()}
    enroll = {k: v for k, v in evalset.items() if int(k[-1]) < 3}
    test = {k: v for k, v in evalset.items() if int(k[-1]) >= 3}
    d = {name: write_xvectors(str(root / name), embs) for name, embs in (
        ("train", train), ("enroll", enroll), ("test", test), ("cohort", cohort),
        ("adapt", shifted))}
    d["train_u2s"], d["enroll_u2s"] = str(root / "train_u2s"), str(root / "enroll_u2s")
    with open(d["train_u2s"], "w") as f:
        f.writelines("%s %s\n" % kv for kv in train_u2s.items())
    with open(d["enroll_u2s"], "w") as f:
        f.writelines("%s %s\n" % (k, eval_u2s[k]) for k in enroll)
    tests_sorted = sorted(test)
    lang = {t: ("tgl" if i < len(tests_sorted) // 2 else "yue")
            for i, t in enumerate(tests_sorted)}
    lines = {"trials": [], "trials_spk": [], "trials_tgl": [], "trials_yue": []}
    for e in sorted(enroll):
        for t in tests_sorted:
            lab = "target" if eval_u2s[t] == eval_u2s[e] else "nontarget"
            lines["trials"].append("%s %s %s" % (e, t, lab))
            lines["trials_" + lang[t]].append("%s %s %s" % (e, t, lab))
    for s in sorted({eval_u2s[k] for k in enroll}):
        for t in tests_sorted:
            lines["trials_spk"].append(
                "%s %s %s" % (s, t, "target" if eval_u2s[t] == s else "nontarget"))
    lines["trials_none"] = ["nobody nothing target"]
    for name, ls in lines.items():
        d[name] = str(root / name)
        with open(d[name], "w") as f:
            f.write("\n".join(ls) + "\n")
    dim = 24
    mean = np.stack([v.astype(np.float32) for v in train.values()]).astype(np.float64).mean(0)
    d["mean_vec"] = str(root / "mean.vec")
    write_vec_flt(d["mean_vec"], mean)
    d["mean_npy"] = str(root / "mean.npy")
    np.save(d["mean_npy"], mean)
    proj = np.random.RandomState(9).randn(16, dim) * 0.3
    d["lda_mat"], d["lda_affine"] = str(root / "lda.mat"), str(root / "affine.mat")
    write_mat(d["lda_mat"], proj)
    write_mat(d["lda_affine"], np.hstack([proj, np.random.RandomState(10).randn(16, 1)]))
    d["root"] = str(root)
    return d


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


SCORE_CASES = {
    "cosine": ["--backend", "cosine"],
    "cosine_enroll_means": ["--backend", "cosine", "--enroll-utt2spk", "{enroll_u2s}",
                            "--trials", "{trials_spk}"],
    "cosine_lda": ["--backend", "cosine", "--lda-dim", "8", "--train-scp", "{train}",
                   "--train-utt2spk", "{train_u2s}"],
    "cosine_asnorm": ["--backend", "cosine", "--cohort-scp", "{cohort}", "--snorm-topk", "10"],
    "cosine_lda_asnorm": ["--backend", "cosine", "--lda-dim", "8", "--train-scp", "{train}",
                          "--train-utt2spk", "{train_u2s}", "--cohort-scp", "{cohort}",
                          "--snorm-topk", "0"],
    "plda": ["--backend", "plda", "--train-scp", "{train}", "--train-utt2spk", "{train_u2s}"],
    "plda_lda": ["--backend", "plda", "--train-scp", "{train}", "--train-utt2spk",
                 "{train_u2s}", "--lda-dim", "16", "--plda-smoothing", "0.1"],
    "plda_adapt": ["--backend", "plda", "--train-scp", "{train}", "--train-utt2spk",
                   "{train_u2s}", "--lda-dim", "16", "--adapt-scp", "{adapt}",
                   "--adapt-within-scale", "0.75", "--adapt-between-scale", "0.25"],
    "plda_asnorm": ["--backend", "plda", "--train-scp", "{train}", "--train-utt2spk",
                    "{train_u2s}", "--cohort-scp", "{cohort}", "--snorm-topk", "10",
                    "--enroll-utt2spk", "{enroll_u2s}", "--trials", "{trials_spk}",
                    "--simple-length-norm"],
    "subset_trials": ["--backend", "cosine", "--subset-trials", "tgl={trials_tgl}",
                      "--subset-trials", "yue={trials_yue}", "--subset-trials",
                      "none={trials_none}"],
}


@pytest.mark.parametrize("case", sorted(SCORE_CASES))
def test_score_cli_matches_jax(score_data, tmp_path, capsys, case):
    argv = ["--enroll-scp", "{enroll}", "--test-scp", "{test}", "--trials", "{trials}"]
    argv = [a.format(**score_data) for a in argv + SCORE_CASES[case]]
    outs = {}
    for name, main in (("jax", jax_score.main), ("port", score.main)):
        scores = str(tmp_path / ("%s.scores" % name))
        rc, out = _run(main, argv + ["--scores", scores], capsys)
        assert rc == 0
        outs[name] = out, open(scores, "rb").read()
        if case == "subset_trials":
            outs[name] += tuple(open("%s.%s" % (scores, s), "rb").read() for s in ("tgl", "yue"))
            assert "[none] no trials matched" in out and not os.path.exists(scores + ".none")
    assert outs["port"] == outs["jax"]
    assert "EER: " in outs["port"][0] and outs["port"][1].count(b"\n") > 10


@pytest.mark.parametrize("fmt", ["kaldi", "kaldi_text", "npz"])
def test_score_cli_plda_out_and_in_match_jax(score_data, tmp_path, capsys, fmt):
    """--plda-out in each format byte-equal; --plda-in with --mean-vec
    (Kaldi vector or npy) and --lda-mat (linear or affine) scores
    byte-equal; the port reads the JAX CLI's file and the other way round."""
    common = ["--backend", "plda", "--enroll-scp", score_data["enroll"], "--test-scp",
              score_data["test"], "--trials", score_data["trials"]]
    files = {}
    for name, main in (("jax", jax_score.main), ("port", score.main)):
        files[name] = str(tmp_path / ("%s_plda%s" % (name, ".npz" if fmt == "npz" else "")))
        rc, _ = _run(main, common + ["--train-scp", score_data["train"], "--train-utt2spk",
                                     score_data["train_u2s"], "--plda-out", files[name],
                                     "--plda-format", fmt, "--plda-smoothing", "0.05"], capsys)
        assert rc == 0
    if fmt == "npz":
        assert _npz_members(files["port"]) == _npz_members(files["jax"])
    else:
        assert open(files["port"], "rb").read() == open(files["jax"], "rb").read()
    for extra in ([], ["--mean-vec", score_data["mean_vec"]],
                  ["--mean-vec", score_data["mean_npy"], "--lda-mat", score_data["lda_mat"]],
                  ["--lda-mat", score_data["lda_affine"], "--plda-smoothing", "0.1"]):
        got, want = [], []
        for main, plda_file, out in ((jax_score.main, files["port"], want),
                                     (score.main, files["jax"], got)):
            if "--lda-mat" in extra:
                # an LDA projection to 16 needs a PLDA of that dim
                plda_file = str(tmp_path / "plda16")
                x = np.random.RandomState(11).randn(120, 16)
                jplda.train_plda(x, np.repeat(np.arange(20), 6)).save(plda_file, "kaldi")
            scores = str(tmp_path / "in.scores")
            rc, stdout = _run(main, common + ["--plda-in", plda_file, "--scores", scores]
                              + extra, capsys)
            assert rc == 0
            out += [stdout, open(scores, "rb").read()]
        assert got == want


def test_copy_plda_cli_matches_jax(tmp_path, capsys):
    x, labels = synth_data(np.random.RandomState(5), n_spk=20, per=6, dim=8)
    src = str(tmp_path / "src")
    jplda.train_plda(x, labels).save(src, format="kaldi")
    for flags in ([], ["--format", "kaldi_text"], ["--smoothing", "0.1", "--format", "kaldi"]):
        outs = []
        for name, main in (("jax", jax_copy_plda.main), ("port", copy_plda.main)):
            dst = str(tmp_path / name)
            rc, out = _run(main, flags + [src, dst], capsys)
            assert rc == 0
            outs.append((out.replace(dst, "@"), open(dst, "rb").read()))
        assert outs[0] == outs[1]


def _scores_and_trials(tmp_path, rng, n, prefix, shift=2.0):
    trials, scores = tmp_path / (prefix + "_trials"), tmp_path / (prefix + "_scores")
    with open(trials, "w") as ft, open(scores, "w") as fs:
        for i in range(n):
            t = int(rng.rand() < 0.3)
            ft.write("e%d t%d %s\n" % (i % 9, i, "target" if t else "nontarget"))
            fs.write("e%d t%d %f\n" % (i % 9, i, rng.randn() + shift * t))
        fs.write("zz zz 1.0\n")  # a score with no trial
    return str(scores), str(trials)


def test_plot_det_cli_matches_jax(tmp_path, capsys):
    scores, trials = _scores_and_trials(tmp_path, np.random.RandomState(0), 200, "det")
    outs = []
    for name, main in (("jax", jax_plot_det.main), ("port", plot_det.main)):
        det, hist = str(tmp_path / (name + ".det")), str(tmp_path / (name + ".hist"))
        rc, out = _run(main, ["--hist", hist, scores, trials, det], capsys)
        assert rc == 0
        outs.append((out, open(det, "rb").read(), open(hist, "rb").read()))
        assert _run(main, [scores], capsys)[0] == 1
    assert outs[0] == outs[1] and "minDCF12" in outs[1][0]


def test_calibrate_scores_cli_matches_jax(tmp_path, capsys):
    rng = np.random.RandomState(1)
    dev = _scores_and_trials(tmp_path, rng, 600, "dev")
    ev = _scores_and_trials(tmp_path, rng, 500, "ev", shift=2.5)
    argv = ["--dev-scores", dev[0], "--dev-trials", dev[1], "--eval-scores", ev[0],
            "--eval-trials", ev[1]]
    for flags in ([], ["--prior", "0.1", "--operating-point", "0.01",
                       "--operating-point", "0.001,10,1"]):
        outs = []
        for name, main in (("jax", jax_calibrate.main), ("port", calibrate_scores.main)):
            cal = str(tmp_path / (name + ".cal"))
            buf = io.StringIO()
            with redirect_stdout(buf):
                rc = main(argv + flags + ["--calibrated-out", cal])
            assert rc == 0
            outs.append((buf.getvalue(), open(cal, "rb").read()))
        assert outs[0] == outs[1] and "actDCF" in outs[1][0]
