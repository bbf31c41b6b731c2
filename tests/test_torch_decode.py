"""The port's WFST decoder, FST codec, WER and decode CLIs
(``tf_kaldi_speaker_tpu_torch/backend/decoder.py``, ``kio/fst.py``,
``backend/wer.py``, ``cli/decode_faster.py``, ``cli/lattice_best_path.py``,
``cli/compute_wer.py``) against the JAX package.

- Every case of ``tests/test_decoder.py`` runs against the port's modules
  (same names, same assertions); the port's native core (its own g++ build
  of ``native/wfst_decoder.cpp``) is held against the port's Python oracle
  at that file's tolerances: words, alignments and the partial flag equal,
  the cost within 1e-3 relative, lattice arcs equal after rounding costs to
  5 and 4 decimals.
- The port's Python oracles are bit-equal to the JAX package's
  (``decode_faster_py``, ``decode_lattice_py``) on graphs and
  log-likelihoods drawn from numpy seeds; the FST codec is byte-equal both
  ways; the decode, best-path and WER CLIs write byte-equal files, the same
  stdout and the same exit codes as the JAX CLIs from the same loglike
  ark, graph and words. Both sides decode in Python there: the JAX
  package builds its native core in place, which no port test depends on.
- ``TFKS_DISABLE_NATIVE=1`` falls back to the Python decoder, and
  ``decoder.counts`` shows it.
"""

import os
import struct

import numpy as np
import pytest

from tf_kaldi_speaker_tpu.backend import decoder as jdec
from tf_kaldi_speaker_tpu.kio import fst as jfst
from tf_kaldi_speaker_tpu_torch.backend import decoder as pdec
from tf_kaldi_speaker_tpu_torch.backend.decoder import (
    WfstDecoder,
    decode_faster_py,
    native_available,
)
from tf_kaldi_speaker_tpu_torch.backend.wer import (
    compute_wer,
    edit_distance,
    read_text_file,
)
from tf_kaldi_speaker_tpu_torch.kio.ark import read_vec_int_ark, write_mat
from tf_kaldi_speaker_tpu_torch.kio.fst import (
    build_fst,
    read_fst,
    read_words_txt,
    write_fst,
)
from tf_kaldi_speaker_tpu_torch.kio.transition_model import (
    TransitionModel,
    write_transition_model,
)


@pytest.fixture
def jax_python_decoder(monkeypatch):
    """The JAX decoder on its Python path (no in-place native build)."""
    monkeypatch.setattr(jdec, "_lib", None)
    monkeypatch.setattr(jdec, "_load_failed", True)


def _bakis_model(num_phones):
    """3-emitting-state Bakis topology, one pdf per (phone, state)."""
    entries = [[
        (0, 0, [(0, 0.75), (1, 0.25)]),
        (1, 1, [(1, 0.75), (2, 0.25)]),
        (2, 2, [(2, 0.75), (3, 0.25)]),
        (-1, -1, []),
    ]]
    phones = list(range(1, num_phones + 1))
    phone2idx = [-1] + [0] * num_phones
    tuples = []
    pdf = 0
    for p in phones:
        for st in range(3):
            tuples.append((p, st, pdf, pdf))
            pdf += 1
    log_probs = np.zeros(1 + 6 * num_phones, np.float32)
    return TransitionModel(phones, phone2idx, entries, tuples, log_probs)


def _word_loop_graph(tm, num_words):
    """HCLG-style word loop: each word = one phone's 3-state HMM chain.

    Arc into each emitting state carries that state's forward tid (frame-
    consuming), self-loops carry the self tid, word olabel on the entry
    arc — the standard shape add-self-loops produces.
    """
    arcs = []
    finals = {0: 0.0}
    state = 1
    word_tids = {}
    for w in range(1, num_words + 1):
        prev = 0
        tids = []
        for st in range(3):
            ts = (w - 1) * 3 + st + 1  # transition-state (1-based)
            self_tid = tm.state2id[ts]  # transitions[0] is the self-loop
            fwd_tid = self_tid + 1
            s = state
            state += 1
            arcs.append(
                (prev, fwd_tid, w if st == 0 else 0,
                 0.5 if st == 0 else 0.0, s)
            )
            arcs.append((s, self_tid, 0, 0.1, s))
            tids.append((self_tid, fwd_tid))
            prev = s
        arcs.append((prev, 0, 0, 0.0, 0))
        word_tids[w] = tids
    return build_fst(0, state, arcs, finals), word_tids


def _synth_loglikes(tm, word_tids, seq, frames_per_state=3, noise=0.1,
                    seed=0):
    rng = np.random.default_rng(seed)
    num_pdfs = tm.num_pdfs
    rows, align = [], []
    for w in seq:
        for st in range(3):
            self_tid, fwd_tid = word_tids[w][st]
            pdf = tm.tid2pdf[fwd_tid]
            for k in range(frames_per_state):
                row = np.full(num_pdfs, -8.0, np.float32)
                row[pdf] = -0.5
                rows.append(row + rng.normal(0, noise, num_pdfs).astype(np.float32))
                align.append(fwd_tid if k == 0 else self_tid)
    return np.stack(rows), align


@pytest.fixture(scope="module")
def setup():
    tm = _bakis_model(num_phones=4)
    fst, word_tids = _word_loop_graph(tm, num_words=4)
    return tm, fst, word_tids


def test_fst_roundtrip_vector_and_const(setup, tmp_path):
    _, fst, _ = setup
    for kind in ("vector", "const"):
        path = str(tmp_path / ("g_%s.fst" % kind))
        write_fst(path, fst, kind)
        back = read_fst(path)
        assert back.start == fst.start
        np.testing.assert_array_equal(back.final, fst.final)
        np.testing.assert_array_equal(back.arc_offsets, fst.arc_offsets)
        np.testing.assert_array_equal(back.ilabels, fst.ilabels)
        np.testing.assert_array_equal(back.olabels, fst.olabels)
        np.testing.assert_array_equal(back.weights, fst.weights)
        np.testing.assert_array_equal(back.nextstates, fst.nextstates)


def test_const_fst_is_aligned_v1(setup, tmp_path):
    """Real HCLGs are OpenFst aligned-const files (version 1, 16-byte
    padded sections) — assert we emit exactly that layout."""
    _, fst, _ = setup
    path = str(tmp_path / "g.fst")
    write_fst(path, fst, "const")
    with open(path, "rb") as fd:
        data = fd.read()
    # magic + "const" + "standard" + version/flags
    assert struct.unpack("<i", data[:4])[0] == 2125659606
    n1 = struct.unpack("<i", data[4:8])[0]
    assert data[8 : 8 + n1] == b"const"
    pos = 8 + n1
    n2 = struct.unpack("<i", data[pos : pos + 4])[0]
    pos += 4 + n2
    version = struct.unpack("<i", data[pos : pos + 4])[0]
    assert version == 1
    # header is followed by padding to a 16-byte boundary
    header_end = pos + 8 + 8 + 24
    state_start = (header_end + 15) // 16 * 16
    assert all(b == 0 for b in data[header_end:state_start])


def test_python_decode_recovers_sequence(setup):
    tm, fst, word_tids = setup
    seq = [2, 1, 4, 3]
    loglikes, align = _synth_loglikes(tm, word_tids, seq)
    res = decode_faster_py(fst, loglikes, tm.tid2pdf[1:], acoustic_scale=1.0,
                           beam=16.0)
    assert list(res.words) == seq
    assert not res.partial
    assert list(res.alignment) == align


def test_native_matches_python_oracle(setup, tmp_path):
    if not native_available():
        pytest.skip("native core unavailable")
    tm, fst, word_tids = setup
    tid2pdf = tm.tid2pdf[1:]
    rng = np.random.default_rng(7)
    for kind in ("vector", "const"):
        path = str(tmp_path / ("n_%s.fst" % kind))
        write_fst(path, fst, kind)
        dec = WfstDecoder(path, tid2pdf, acoustic_scale=0.8, beam=14.0,
                          max_active=64)
        assert dec._handle is not None
        for trial in range(20):
            t = int(rng.integers(3, 50))
            ll = rng.normal(-2.0, 1.5, (t, tm.num_pdfs)).astype(np.float32)
            a = decode_faster_py(fst, ll, tid2pdf, acoustic_scale=0.8,
                                 beam=14.0, max_active=64)
            b = dec.decode(ll)
            assert list(a.words) == list(b.words), trial
            assert list(a.alignment) == list(b.alignment), trial
            assert a.partial == b.partial
            assert abs(a.cost - b.cost) <= 1e-3 * max(1.0, abs(a.cost))
        dec.close()


def test_partial_path_flagged(setup):
    tm, fst, word_tids = setup
    # Stop mid-word: only the first state of word 1 is fed -> no final
    # state reachable, decoder must flag a partial path (Kaldi warns and
    # emits the partial traceback).
    loglikes, _ = _synth_loglikes(tm, word_tids, [1])
    res = decode_faster_py(fst, loglikes[:2], tm.tid2pdf[1:],
                           acoustic_scale=1.0, beam=16.0)
    assert res.partial
    assert len(res.alignment) == 2


def test_decode_and_wer_clis(setup, tmp_path):
    from tf_kaldi_speaker_tpu_torch.cli import compute_wer as wer_cli
    from tf_kaldi_speaker_tpu_torch.cli import decode_faster as decode_cli

    tm, fst, word_tids = setup
    mdl = str(tmp_path / "final.mdl")
    write_transition_model(mdl, tm)
    graph = str(tmp_path / "HCLG.fst")
    write_fst(graph, fst, "const")
    words_txt = str(tmp_path / "words.txt")
    with open(words_txt, "w") as fd:
        fd.write("<eps> 0\n")
        for w in range(1, 5):
            fd.write("w%d %d\n" % (w, w))
    assert read_words_txt(words_txt)[3] == "w3"

    seqs = {"utt1": [1, 2, 3], "utt2": [4, 4], "utt3": [2]}
    loglike_ark = str(tmp_path / "loglike.ark")
    with open(loglike_ark, "wb") as fd:
        for key, seq in seqs.items():
            ll, _ = _synth_loglikes(tm, word_tids, seq,
                                    seed=sum(map(ord, key)) % 97)
            write_mat(fd, ll, key=key)

    words_ark = str(tmp_path / "words.ark")
    ali_ark = str(tmp_path / "ali.ark")
    text_out = str(tmp_path / "text.hyp")
    rc = decode_cli.main([
        "--acoustic-scale", "1.0", "--word-symbol-table", words_txt,
        "--text-out", text_out, "--align-out", "ark:" + ali_ark,
        mdl, graph, "ark:" + loglike_ark, "ark:" + words_ark,
    ])
    assert rc == 0

    decoded = {k: list(v) for k, v in read_vec_int_ark(words_ark)}
    assert decoded == seqs
    # alignments cover every frame and map to the right pdfs
    for key, ali in read_vec_int_ark(ali_ark):
        assert len(ali) == 9 * len(seqs[key])
    hyp = read_text_file(text_out)
    assert hyp["utt1"] == ["w1", "w2", "w3"]

    # WER CLI: perfect hyp = 0%; corrupt one word and re-score
    ref_text = str(tmp_path / "text.ref")
    with open(ref_text, "w") as fd:
        for key, seq in seqs.items():
            fd.write("%s %s\n" % (key, " ".join("w%d" % w for w in seq)))
    assert wer_cli.main([ref_text, text_out]) == 0
    stats = compute_wer(read_text_file(ref_text), read_text_file(text_out))
    assert stats.errors == 0 and stats.wer == 0.0

    bad = dict(hyp)
    bad["utt2"] = ["w1", "w4"]
    stats = compute_wer(read_text_file(ref_text), bad)
    assert stats.substitutions == 1 and stats.errors == 1
    assert stats.wrong_sentences == 1 and stats.sentences == 3


def test_edit_distance_counts():
    assert edit_distance("abc", "abc") == (0, 0, 0, 0)
    assert edit_distance("abc", "axc") == (1, 0, 0, 1)
    assert edit_distance("abc", "abxc") == (1, 1, 0, 0)
    assert edit_distance("abc", "ac") == (1, 0, 1, 0)
    assert edit_distance("", "ab") == (2, 2, 0, 0)
    assert edit_distance("ab", "") == (2, 0, 2, 0)
    # prefer substitution over ins+del on ties
    assert edit_distance("ab", "cd") == (2, 0, 0, 2)


def test_wer_missing_utterance_scored_as_deletions():
    stats = compute_wer({"a": ["x", "y"]}, {})
    assert stats.missing == ["a"]
    assert stats.deletions == 2 and stats.errors == 2
    assert stats.wer == 100.0


# ---------------------------------------------------------------------------
# Lattice generation (latgen-faster-mapped semantics)


def test_lattice_best_path_equals_viterbi(setup):
    from tf_kaldi_speaker_tpu_torch.backend.decoder import decode_lattice_py

    tm, fst, word_tids = setup
    tid2pdf = tm.tid2pdf[1:]
    ll, align = _synth_loglikes(tm, word_tids, [2, 1, 4, 3], noise=0.4,
                                seed=3)
    ref = decode_faster_py(fst, ll, tid2pdf, acoustic_scale=0.7, beam=16.0)
    lat, partial = decode_lattice_py(fst, ll, tid2pdf, acoustic_scale=0.7,
                                     beam=16.0, lattice_beam=10.0)
    assert not partial
    w, a, c = lat.best_path(acoustic_scale=0.7, lm_scale=1.0)
    assert w == list(ref.words)
    assert a == list(ref.alignment)
    assert abs(c - ref.cost) < 1e-3
    # the lattice holds real alternatives, not just the best path
    assert lat.num_paths_bounded() > 1


def test_lattice_scale_sweep_matches_direct_decode(setup):
    """Rescoring property: best path through the lattice at a DIFFERENT
    acoustic scale equals re-decoding at that scale (wide beams so the
    alternatives stay inside the lattice) — the reason lattices exist."""
    from tf_kaldi_speaker_tpu_torch.backend.decoder import decode_lattice_py

    tm, fst, word_tids = setup
    tid2pdf = tm.tid2pdf[1:]
    ll, _ = _synth_loglikes(tm, word_tids, [1, 3], noise=0.5, seed=9)
    lat, _ = decode_lattice_py(fst, ll, tid2pdf, acoustic_scale=0.7,
                               beam=20.0, lattice_beam=14.0)
    for scale in (0.4, 0.7, 1.0, 1.4):
        direct = decode_faster_py(fst, ll, tid2pdf, acoustic_scale=scale,
                                  beam=24.0)
        w, _, c = lat.best_path(acoustic_scale=scale)
        assert w == list(direct.words), scale
        assert abs(c - direct.cost) < 1e-3, scale


def test_lattice_native_matches_oracle(setup, tmp_path):
    from tf_kaldi_speaker_tpu_torch.backend.decoder import decode_lattice_py

    if not native_available():
        pytest.skip("native core unavailable")
    tm, fst, word_tids = setup
    tid2pdf = tm.tid2pdf[1:]
    path = str(tmp_path / "lat.fst")
    write_fst(path, fst, "vector")
    dec = WfstDecoder(path, tid2pdf, acoustic_scale=0.6, beam=14.0,
                      max_active=64)
    assert dec._handle is not None
    rng = np.random.default_rng(21)
    for trial in range(15):
        t = int(rng.integers(4, 40))
        ll = rng.normal(-2, 1.5, (t, tm.num_pdfs)).astype(np.float32)
        a, pa = decode_lattice_py(fst, ll, tid2pdf, acoustic_scale=0.6,
                                  beam=14.0, lattice_beam=6.0, max_active=64)
        b, pb = dec.decode_lattice(ll, lattice_beam=6.0)
        assert pa == pb
        assert a.num_states == b.num_states, trial
        ka = sorted((x.src, x.dst, x.ilabel, x.olabel,
                     round(x.graph_cost, 5), round(x.acoustic_cost, 4))
                    for x in a.arcs)
        kb = sorted((x.src, x.dst, x.ilabel, x.olabel,
                     round(x.graph_cost, 5), round(x.acoustic_cost, 4))
                    for x in b.arcs)
        assert ka == kb, trial
        assert a.finals == b.finals
    dec.close()


def test_lattice_text_roundtrip(setup, tmp_path):
    from tf_kaldi_speaker_tpu_torch.backend.decoder import decode_lattice_py
    from tf_kaldi_speaker_tpu_torch.backend.lattice import (
        read_lattice_ark,
        write_lattice,
    )

    tm, fst, word_tids = setup
    tid2pdf = tm.tid2pdf[1:]
    path = str(tmp_path / "lat.txt")
    lats = {}
    with open(path, "w") as fd:
        for i, seq in enumerate(([2], [4, 1], [3, 3, 2])):
            ll, _ = _synth_loglikes(tm, word_tids, seq, noise=0.3, seed=i)
            lat, _ = decode_lattice_py(fst, ll, tid2pdf, acoustic_scale=0.8,
                                       beam=15.0, lattice_beam=8.0)
            lats["u%d" % i] = lat
            write_lattice(fd, lat, "u%d" % i)
    back = dict(read_lattice_ark(path))
    assert set(back) == set(lats)
    for k, lat in lats.items():
        b = back[k]
        assert b.num_states == lat.num_states
        assert len(b.arcs) == len(lat.arcs)
        assert b.finals.keys() == lat.finals.keys()
        w0, a0, c0 = lat.best_path(acoustic_scale=0.8)
        w1, a1, c1 = b.best_path(acoustic_scale=0.8)
        assert (w0, a0) == (w1, a1)
        assert abs(c0 - c1) < 1e-4


def test_lattice_clis(setup, tmp_path):
    """decode_faster --lattice-out -> lattice_best_path (incl. the lmwt
    sweep against a reference text)."""
    from tf_kaldi_speaker_tpu_torch.cli import decode_faster as decode_cli
    from tf_kaldi_speaker_tpu_torch.cli import lattice_best_path as lbp_cli

    tm, fst, word_tids = setup
    mdl = str(tmp_path / "final.mdl")
    write_transition_model(mdl, tm)
    graph = str(tmp_path / "HCLG.fst")
    write_fst(graph, fst, "const")
    words_txt = str(tmp_path / "words.txt")
    with open(words_txt, "w") as fd:
        fd.write("<eps> 0\n")
        for w in range(1, 5):
            fd.write("w%d %d\n" % (w, w))

    seqs = {"utt1": [1, 2], "utt2": [4]}
    loglike_ark = str(tmp_path / "loglike.ark")
    with open(loglike_ark, "wb") as fd:
        for key, seq in seqs.items():
            ll, _ = _synth_loglikes(tm, word_tids, seq, noise=0.3,
                                    seed=len(seq))
            write_mat(fd, ll, key=key)

    lat_out = str(tmp_path / "lat.txt")
    rc = decode_cli.main([
        "--acoustic-scale", "1.0", "--lattice-out", lat_out,
        "--word-symbol-table", words_txt,
        "--text-out", str(tmp_path / "text.hyp"),
        mdl, graph, "ark:" + loglike_ark,
        "ark:" + str(tmp_path / "words.ark"),
    ])
    assert rc == 0
    decoded = {k: list(v)
               for k, v in read_vec_int_ark(str(tmp_path / "words.ark"))}
    assert decoded == seqs

    # best-path CLI at the decode scale reproduces the words
    rc = lbp_cli.main([
        "--acoustic-scale", "1.0", "--word-symbol-table", words_txt,
        "--text-out", str(tmp_path / "text.lbp"),
        lat_out, "ark:" + str(tmp_path / "words2.ark"),
    ])
    assert rc == 0
    again = {k: list(v)
             for k, v in read_vec_int_ark(str(tmp_path / "words2.ark"))}
    assert again == seqs

    # lmwt sweep against the true transcripts finds a 0% WER operating point
    ref_text = str(tmp_path / "ref.text")
    with open(ref_text, "w") as fd:
        for k, seq in seqs.items():
            fd.write("%s %s\n" % (k, " ".join("w%d" % w for w in seq)))
    rc = lbp_cli.main([
        "--sweep-lmwt", "1:3", "--ref-text", ref_text,
        "--word-symbol-table", words_txt,
        lat_out, "ark:" + str(tmp_path / "words3.ark"),
    ])
    assert rc == 0


def test_fst_codec_fuzz_roundtrip():
    """Random FSTs round-trip both on-disk formats bit-exactly, and the
    native loader agrees with the Python reader (guards the codec against
    layout drift — no OpenFst exists here to cross-check, so the two
    independent readers checking each other is the defense)."""
    import tempfile

    from tf_kaldi_speaker_tpu_torch.backend import decoder as dec_mod

    rng = np.random.default_rng(123)
    for trial in range(10):
        n_states = int(rng.integers(2, 40))
        n_arcs = int(rng.integers(1, 120))
        arcs = [
            (int(rng.integers(0, n_states)), int(rng.integers(0, 50)),
             int(rng.integers(0, 30)), float(np.float32(rng.normal())),
             int(rng.integers(0, n_states)))
            for _ in range(n_arcs)
        ]
        finals = {int(s): float(np.float32(abs(rng.normal())))
                  for s in rng.integers(0, n_states, 3)}
        fst = build_fst(int(rng.integers(0, n_states)), n_states, arcs, finals)
        with tempfile.TemporaryDirectory() as td:
            for kind in ("vector", "const"):
                p = os.path.join(td, kind + ".fst")
                write_fst(p, fst, kind)
                back = read_fst(p)
                np.testing.assert_array_equal(back.ilabels, fst.ilabels)
                np.testing.assert_array_equal(back.weights, fst.weights)
                np.testing.assert_array_equal(back.final, fst.final)
                np.testing.assert_array_equal(back.arc_offsets, fst.arc_offsets)
                assert back.start == fst.start
                if native_available():
                    lib = dec_mod._get_lib()
                    h = lib.tfks_fst_load(p.encode())
                    assert h, (trial, kind)
                    assert lib.tfks_fst_states(h) == fst.num_states
                    assert lib.tfks_fst_arcs(h) == fst.num_arcs
                    assert lib.tfks_fst_start(h) == fst.start
                    lib.tfks_fst_free(h)


def test_lattice_posteriors_and_confidences(setup):
    """Forward-backward arc posteriors: mass across the start cut is 1,
    confident (clean-loglike) best-path words approach posterior 1, and
    the --confidence-out CLI emits them."""
    from tf_kaldi_speaker_tpu_torch.backend.decoder import decode_lattice_py
    from tf_kaldi_speaker_tpu_torch.backend.lattice import (
        arc_posteriors,
        best_path_confidences,
        write_lattice,
    )

    tm, fst, word_tids = setup
    tid2pdf = tm.tid2pdf[1:]
    ll, _ = _synth_loglikes(tm, word_tids, [2, 3], noise=0.6, seed=5)
    lat, _ = decode_lattice_py(fst, ll, tid2pdf, acoustic_scale=0.8,
                               beam=18.0, lattice_beam=12.0)
    post = arc_posteriors(lat, acoustic_scale=0.8)
    start_mass = sum(
        post[i] for i, a in enumerate(lat.arcs) if a.src == lat.start)
    assert abs(start_mass - 1.0) < 1e-6
    assert np.all(post >= 0) and np.all(post <= 1 + 1e-9)
    conf = best_path_confidences(lat, acoustic_scale=0.8)
    assert [w for w, _ in conf] == [2, 3]
    assert all(c > 0.5 for _, c in conf)


def test_lattice_confidence_cli(setup, tmp_path):
    from tf_kaldi_speaker_tpu_torch.backend.decoder import decode_lattice_py
    from tf_kaldi_speaker_tpu_torch.backend.lattice import write_lattice
    from tf_kaldi_speaker_tpu_torch.cli import lattice_best_path as lbp_cli

    tm, fst, word_tids = setup
    tid2pdf = tm.tid2pdf[1:]
    lat_path = str(tmp_path / "lat.txt")
    with open(lat_path, "w") as fd:
        ll, _ = _synth_loglikes(tm, word_tids, [1, 4], noise=0.3, seed=2)
        lat, _ = decode_lattice_py(fst, ll, tid2pdf, acoustic_scale=1.0,
                                   beam=16.0, lattice_beam=8.0)
        write_lattice(fd, lat, "u0")
    words_txt = str(tmp_path / "words.txt")
    with open(words_txt, "w") as fd:
        fd.write("<eps> 0\n")
        for w in range(1, 5):
            fd.write("w%d %d\n" % (w, w))
    conf_out = str(tmp_path / "conf")
    rc = lbp_cli.main([
        "--acoustic-scale", "1.0", "--word-symbol-table", words_txt,
        "--confidence-out", conf_out,
        lat_path, "ark:" + str(tmp_path / "w.ark"),
    ])
    assert rc == 0
    line = open(conf_out).read().split()
    assert line[0] == "u0"
    toks = [t.rsplit(":", 1) for t in line[1:]]
    assert [t[0] for t in toks] == ["w1", "w4"]
    assert all(0.0 <= float(t[1]) <= 1.0 for t in toks)


def test_lattice_depth_stats(setup):
    from tf_kaldi_speaker_tpu_torch.backend.decoder import decode_lattice_py
    from tf_kaldi_speaker_tpu_torch.backend.lattice import depth_stats

    tm, fst, word_tids = setup
    ll, _ = _synth_loglikes(tm, word_tids, [2, 3], noise=0.6, seed=5)
    lat, _ = decode_lattice_py(fst, ll, tm.tid2pdf[1:], acoustic_scale=0.8,
                               beam=18.0, lattice_beam=12.0)
    mean_d, max_d = depth_stats(lat)
    assert mean_d >= 1.0 and max_d >= 1  # at least the best path per frame
    assert max_d >= mean_d


def test_wfst_decoder_python_fallback(setup, tmp_path, monkeypatch):
    """With the native core unavailable, WfstDecoder transparently uses the
    pure-Python implementations for both decode modes."""
    from tf_kaldi_speaker_tpu_torch.backend import decoder as dec_mod

    tm, fst, word_tids = setup
    tid2pdf = tm.tid2pdf[1:]
    path = str(tmp_path / "fb.fst")
    write_fst(path, fst, "vector")
    monkeypatch.setattr(dec_mod, "_lib", None)
    monkeypatch.setattr(dec_mod, "_load_failed", True)
    dec = dec_mod.WfstDecoder(path, tid2pdf, acoustic_scale=1.0, beam=16.0)
    assert dec._handle is None and dec._fst is not None
    ll, align = _synth_loglikes(tm, word_tids, [3, 1], seed=4)
    res = dec.decode(ll)
    assert list(res.words) == [3, 1]
    assert list(res.alignment) == align
    lat, partial = dec.decode_lattice(ll, lattice_beam=8.0)
    w, a, c = lat.best_path(acoustic_scale=1.0)
    assert w == [3, 1] and not partial
    dec.close()  # no-op without native handles


def test_read_compact_lattice_text(tmp_path):
    """CompactLattice text (lattice-copy's default) reads into the same
    container: tid strings expand to per-frame chains, word on the first
    arc, final alignment strings routed through a fresh final state."""
    from tf_kaldi_speaker_tpu_torch.backend.lattice import read_lattice_ark

    path = str(tmp_path / "compact.txt")
    with open(path, "w") as fd:
        fd.write("utt_c\n")
        fd.write("0 1 7 1.5,2.5,3_4_5\n")   # word 7 over tids 3,4,5
        fd.write("0 2 8 0.5,1.0,3_4\n")     # competing word 8
        fd.write("1 3 0 0,0,\n")            # eps arc, no tids
        fd.write("2 3 0 0.25,0,6\n")        # eps word, one tid
        fd.write("3 1.0,0.5,9\n")           # final with alignment string
        fd.write("\n")
    key, lat = next(iter(read_lattice_ark(path)))
    assert key == "utt_c"
    # chains: 3 tids -> 2 extra states; finals routed through 1 new state
    words, align, cost = lat.best_path(acoustic_scale=1.0)
    # best path: 0->2 (word 8, cost 1.5) -> 3 (0.25) -> final chain (1.5)
    assert words == [8]
    assert align == [3, 4, 6, 9]
    ref_cost = (0.5 + 1.0) + 0.25 + (1.0 + 0.5)
    assert abs(cost - ref_cost) < 1e-6
    # the 3-tid path exists too
    from tf_kaldi_speaker_tpu_torch.backend.lattice import arc_posteriors
    post = arc_posteriors(lat, acoustic_scale=1.0)
    assert len(post) == len(lat.arcs) and abs(sum(
        post[i] for i, a in enumerate(lat.arcs) if a.src == lat.start) - 1.0
    ) < 1e-9


def test_python_decode_tolerates_unused_bad_tid2pdf_rows(setup):
    """Validation parity with the native path: tid2pdf entries for
    transition-ids the graph never references may be garbage (e.g. a
    reduced phone head) — only graph-referenced entries are checked."""
    tm, fst, word_tids = setup
    seq = [2, 1]
    loglikes, _ = _synth_loglikes(tm, word_tids, seq)
    tid2pdf = np.concatenate([
        tm.tid2pdf[1:], np.array([999999, -5], np.int32)])  # unused tail
    res = decode_faster_py(fst, loglikes, tid2pdf, acoustic_scale=1.0,
                           beam=16.0)
    assert list(res.words) == seq

    # ... but a graph-referenced bad entry must still be rejected.
    bad = tid2pdf.copy()
    used = np.asarray(fst.ilabels)
    used = used[used > 0]
    bad[used[0] - 1] = 999999
    with pytest.raises(ValueError, match="tid2pdf"):
        decode_faster_py(fst, loglikes, bad, acoustic_scale=1.0, beam=16.0)


def test_best_path_word_ins_penalty():
    """lattice-add-penalty semantics (scripts/diagnostic/score.sh): the
    penalty is added per WORD-emitting arc after scaling, so raising it
    flips the best path from a cheap many-word route to a pricier
    few-word route; oracle = brute-force path enumeration."""
    from tf_kaldi_speaker_tpu_torch.backend.lattice import Lattice, LatticeArc

    # two routes 0->3: three words (cost 3x1.0) vs one word (cost 3.5)
    lat = Lattice(num_states=4)
    lat.arcs = [
        LatticeArc(0, 1, 1, 10, 0.5, 0.5),
        LatticeArc(1, 2, 2, 11, 0.5, 0.5),
        LatticeArc(2, 3, 3, 12, 0.5, 0.5),
        LatticeArc(0, 3, 4, 20, 2.0, 1.5),
    ]
    lat.finals = {3: (0.0, 0.0)}

    w0, _, c0 = lat.best_path()
    assert w0 == [10, 11, 12] and abs(c0 - 3.0) < 1e-9
    # wip=0.5: route A 3.0+1.5=4.5 > route B 3.5+0.5=4.0 -> flips
    w1, _, c1 = lat.best_path(word_ins_penalty=0.5)
    assert w1 == [20] and abs(c1 - 4.0) < 1e-9

    # oracle on every (scale, wip): enumerate both paths by hand
    for acw in (0.5, 1.0, 2.0):
        for wip in (0.0, 0.3, 1.0):
            costs = {
                (10, 11, 12): 1.5 + acw * 1.5 + 3 * wip,
                (20,): 2.0 + acw * 1.5 + wip,
            }
            want_words, want_cost = min(
                ((k, v) for k, v in costs.items()), key=lambda kv: kv[1])
            w, _, c = lat.best_path(acoustic_scale=acw,
                                    word_ins_penalty=wip)
            assert tuple(w) == want_words, (acw, wip)
            assert abs(c - want_cost) < 1e-9, (acw, wip)


def test_wer_filter_words(tmp_path, capsys):
    """--filter-words strips tokens from BOTH sides before scoring (the
    wer_output_filter hook): noise-only disagreements stop counting."""
    from tf_kaldi_speaker_tpu_torch.backend.wer import (
        compute_wer, filter_transcripts)
    from tf_kaldi_speaker_tpu_torch.cli import compute_wer as wer_cli

    refs = {"u1": ["<NOISE>", "a", "b"], "u2": ["c", "<UNK>"]}
    hyps = {"u1": ["a", "b"], "u2": ["c", "d"]}
    assert compute_wer(refs, hyps).errors == 2  # del <NOISE>, sub <UNK>/d
    drop = ["<NOISE>", "<UNK>"]
    fr, fh = filter_transcripts(refs, drop), filter_transcripts(hyps, drop)
    assert compute_wer(fr, fh).errors == 1  # only the inserted 'd' remains

    ref_f, hyp_f = str(tmp_path / "ref"), str(tmp_path / "hyp")
    with open(ref_f, "w") as fd:
        fd.writelines("%s %s\n" % (k, " ".join(v)) for k, v in refs.items())
    with open(hyp_f, "w") as fd:
        fd.writelines("%s %s\n" % (k, " ".join(v)) for k, v in hyps.items())
    assert wer_cli.main(["--filter-words", "<NOISE>,<UNK>", ref_f, hyp_f]) == 0
    out = capsys.readouterr().out
    assert "[ 1 / 3" in out  # 1 error over 3 filtered ref words


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------
def _random_graph(rng, num_tids):
    """A random emitting graph over tids 1..num_tids with epsilon arcs,
    words and finals (the fuzz test's shape, every state reachable)."""
    n = int(rng.integers(3, 12))
    arcs = [(s, int(rng.integers(1, num_tids + 1)), int(rng.integers(0, 6)),
             float(np.float32(rng.uniform(0, 2))), s + 1) for s in range(n - 1)]
    for _ in range(int(rng.integers(n, 4 * n))):
        il = int(rng.integers(0, num_tids + 1)) if rng.random() < 0.8 else 0
        src, dst = int(rng.integers(0, n)), int(rng.integers(0, n))
        if il == 0 and dst <= src:
            dst = min(src + 1, n - 1)
            if dst == src:
                continue
        arcs.append((src, il, int(rng.integers(0, 6)), float(np.float32(rng.uniform(0, 2))),
                     dst))
    finals = {int(s): float(np.float32(rng.uniform(0, 1))) for s in rng.integers(0, n, 2)}
    return n, arcs, finals


def _pair_fsts(n, arcs, finals):
    return build_fst(0, n, arcs, finals), jfst.build_fst(0, n, arcs, finals)


def _lattice_key(lat):
    return (lat.num_states, lat.start, [tuple(vars(a).values()) for a in lat.arcs],
            lat.finals)


@pytest.mark.parametrize("seed", range(4))
def test_python_oracles_bit_equal_to_jax(setup, seed):
    """``decode_faster_py`` and ``decode_lattice_py``: words, alignments,
    costs (==) and partial flags, and every lattice arc, state and final,
    on the word-loop graph and on random graphs."""
    tm, fst, _ = setup
    tid2pdf = tm.tid2pdf[1:]
    rng = np.random.default_rng(seed)
    graphs = [(fst, jfst.build_fst(0, fst.num_states, [
        (s, int(fst.ilabels[a]), int(fst.olabels[a]), float(fst.weights[a]),
         int(fst.nextstates[a]))
        for s in range(fst.num_states) for a in range(fst.arc_offsets[s], fst.arc_offsets[s + 1])
    ], {0: 0.0}))]
    graphs.append(_pair_fsts(*_random_graph(rng, len(tid2pdf))))
    for pf, jf in graphs:
        for _ in range(3):
            t = int(rng.integers(3, 30))
            ll = rng.normal(-2.0, 1.5, (t, tm.num_pdfs)).astype(np.float32)
            kw = dict(acoustic_scale=float(rng.uniform(0.3, 1.2)), beam=12.0,
                      max_active=int(rng.choice([0, 16, 64])))
            try:
                want = jdec.decode_faster_py(jf, ll, tid2pdf, **kw)
            except RuntimeError as e:  # the beam collapsed: so must the port's
                with pytest.raises(RuntimeError, match=str(e)):
                    decode_faster_py(pf, ll, tid2pdf, **kw)
                continue
            got = decode_faster_py(pf, ll, tid2pdf, **kw)
            np.testing.assert_array_equal(got.words, want.words)
            np.testing.assert_array_equal(got.alignment, want.alignment)
            assert got.cost == want.cost and got.partial == want.partial
            want_lat, want_partial = jdec.decode_lattice_py(jf, ll, tid2pdf, lattice_beam=6.0,
                                                            **kw)
            got_lat, got_partial = pdec.decode_lattice_py(pf, ll, tid2pdf, lattice_beam=6.0,
                                                          **kw)
            assert got_partial == want_partial
            assert _lattice_key(got_lat) == _lattice_key(want_lat)


def test_fst_codec_byte_equal_to_jax(tmp_path):
    """Both on-disk layouts: the port writes the JAX package's bytes, and
    each reads the other's file into the same arrays; words.txt alike."""
    rng = np.random.default_rng(5)
    for trial in range(6):
        n, arcs, finals = _random_graph(rng, 40)
        pf, jf = _pair_fsts(n, arcs, finals)
        for kind in ("vector", "const"):
            p, j = str(tmp_path / ("p_%s.fst" % kind)), str(tmp_path / ("j_%s.fst" % kind))
            write_fst(p, pf, kind)
            jfst.write_fst(j, jf, kind)
            with open(p, "rb") as a, open(j, "rb") as b:
                assert a.read() == b.read(), (trial, kind)
            for got, want in ((read_fst(j), jfst.read_fst(j)), (jfst.read_fst(p), read_fst(p))):
                assert got.start == want.start
                for name in ("final", "arc_offsets", "ilabels", "olabels", "weights",
                             "nextstates"):
                    np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    words = tmp_path / "words.txt"
    words.write_text("<eps> 0\nw1 1\n\nw2 2\n")
    assert read_words_txt(str(words)) == jfst.read_words_txt(str(words))


def _cli_inputs(tm, word_tids, tmp_path, seqs, noise):
    mdl = str(tmp_path / "final.mdl")
    write_transition_model(mdl, tm)
    graph = str(tmp_path / "HCLG.fst")
    fst, _ = _word_loop_graph(tm, 4)
    write_fst(graph, fst, "const")
    words_txt = str(tmp_path / "words.txt")
    with open(words_txt, "w") as fd:
        fd.write("<eps> 0\n")
        for w in range(1, 5):
            fd.write("w%d %d\n" % (w, w))
    loglike_ark = str(tmp_path / "loglike.ark")
    with open(loglike_ark, "wb") as fd:
        for key, seq in seqs.items():
            ll, _ = _synth_loglikes(tm, word_tids, seq, noise=noise,
                                    seed=sum(map(ord, key)) % 97)
            write_mat(fd, ll, key=key)
    ref_text = str(tmp_path / "ref.text")
    with open(ref_text, "w") as fd:
        for key, seq in seqs.items():
            fd.write("%s %s\n" % (key, " ".join("w%d" % w for w in seq[::-1])))
    return mdl, graph, words_txt, loglike_ark, ref_text


def _run_both(capsys, tmp_path, port_main, jax_main, argv):
    """Each CLI's exit code, stdout and files, ``{}`` in ``argv`` standing
    for the side's output directory."""
    out = {}
    for side, main in (("port", port_main), ("jax", jax_main)):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        rc = main([a.format(str(d)) for a in argv])
        stdout = capsys.readouterr().out.replace(str(d), "{}")
        files = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
        out[side] = (rc, stdout, files)
    return out


@pytest.mark.parametrize("lattice", ["none", "raw", "determinized"])
def test_decode_clis_byte_equal_to_jax(setup, tmp_path, capsys, monkeypatch,
                                       jax_python_decoder, lattice):
    """``decode_faster`` (best path, raw and determinized lattices), then
    ``lattice_best_path`` (one scale, the lmwt sweep with confidences) and
    ``compute_wer`` over the port's outputs: each writes the JAX CLI's
    bytes and prints its stdout, with its exit code."""
    from tf_kaldi_speaker_tpu.cli import compute_wer as jwer_cli
    from tf_kaldi_speaker_tpu.cli import decode_faster as jdecode_cli
    from tf_kaldi_speaker_tpu.cli import lattice_best_path as jlbp_cli
    from tf_kaldi_speaker_tpu_torch.cli import compute_wer as wer_cli
    from tf_kaldi_speaker_tpu_torch.cli import decode_faster as decode_cli
    from tf_kaldi_speaker_tpu_torch.cli import lattice_best_path as lbp_cli

    monkeypatch.setenv("TFKS_DISABLE_NATIVE", "1")
    tm, _, word_tids = setup
    seqs = {"utt1": [1, 2, 3], "utt2": [4, 4], "utt3": [2]}
    mdl, graph, words_txt, ll_ark, ref = _cli_inputs(tm, word_tids, tmp_path, seqs, 0.8)
    argv = ["--acoustic-scale", "0.5", "--word-symbol-table", words_txt,
            "--text-out", "{}/text", "--align-out", "ark:{}/ali.ark", "--num-threads", "2"]
    if lattice != "none":
        argv += ["--lattice-out", "{}/lat.txt", "--lattice-beam", "6.0",
                 "--determinize-lattice", "true" if lattice == "determinized" else "false"]
    out = _run_both(capsys, tmp_path, decode_cli.main, jdecode_cli.main,
                    argv + [mdl, graph, "ark:" + ll_ark, "ark:{}/words.ark"])
    assert out["port"] == out["jax"]
    assert out["port"][0] == 0 and "words.ark" in out["port"][2]
    port_dir = str(tmp_path / "port")
    out = _run_both(capsys, tmp_path, wer_cli.main, jwer_cli.main,
                    [ref, os.path.join(port_dir, "text")])
    assert out["port"] == out["jax"] and "%WER" in out["port"][1]
    if lattice == "none":
        return
    lat = os.path.join(port_dir, "lat.txt")
    for extra in (["--acoustic-scale", "0.5", "--confidence-out", "{}/conf"],
                  ["--sweep-lmwt", "1:4", "--word-ins-penalty", "0.0,0.5", "--ref-text", ref]):
        out = _run_both(capsys, tmp_path, lbp_cli.main, jlbp_cli.main,
                        extra + ["--word-symbol-table", words_txt, "--text-out", "{}/text.lbp",
                                 "--align-out", "ark:{}/ali.lbp", lat, "ark:{}/words.lbp"])
        assert out["port"] == out["jax"], extra
        assert out["port"][0] == 0


def test_disable_native_falls_back_and_counts(setup, tmp_path, monkeypatch):
    """``TFKS_DISABLE_NATIVE=1``: the decoder reads the graph in Python,
    both decode modes run the oracle, and ``counts`` records them as
    Python decodes; without it the native core decodes (when g++ built it)
    and is counted as native."""
    tm, fst, word_tids = setup
    path = str(tmp_path / "g.fst")
    write_fst(path, fst, "vector")
    ll, align = _synth_loglikes(tm, word_tids, [3, 1], seed=4)
    monkeypatch.setenv("TFKS_DISABLE_NATIVE", "1")
    pdec.reset_counts()
    dec = WfstDecoder(path, tm.tid2pdf[1:], acoustic_scale=1.0, beam=16.0)
    assert dec._handle is None and not native_available()
    assert list(dec.decode(ll).words) == [3, 1]
    lat, partial = dec.decode_lattice(ll)
    assert lat.best_path(acoustic_scale=1.0)[0] == [3, 1] and not partial
    assert pdec.counts == {"python": 2}
    monkeypatch.delenv("TFKS_DISABLE_NATIVE")
    if not native_available():
        pytest.skip("native core unavailable")
    pdec.reset_counts()
    dec = WfstDecoder(path, tm.tid2pdf[1:], acoustic_scale=1.0, beam=16.0)
    res = dec.decode(ll)
    assert list(res.words) == [3, 1] and list(res.alignment) == align
    dec.decode_lattice(ll)
    assert pdec.counts == {"native": 2}
    dec.close()


def test_native_library_builds_under_build_dir():
    """The port's core is its own copy, built by ``kio.native_decode`` into
    ``build/tfks_torch_native/`` (never the JAX package's in-place build)."""
    from tf_kaldi_speaker_tpu_torch.kio import native_decode

    if not native_available():
        pytest.skip("native core unavailable")
    path = native_decode.library_path(source=native_decode.WFST_SOURCE)
    assert os.path.exists(path) and os.path.basename(path).startswith("libtfks_wfst_decoder_")
    assert os.sep + os.path.join("build", "tfks_torch_native") + os.sep in path
    assert path != native_decode.library_path()
    jax_src = os.path.join(os.path.dirname(jdec.__file__), "..", "native", "wfst_decoder.cpp")
    with open(native_decode.WFST_SOURCE, "rb") as a, open(jax_src, "rb") as b:
        assert a.read() == b.read()
