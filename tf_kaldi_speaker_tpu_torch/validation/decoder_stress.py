"""The WFST decoder at a realistic graph size, through the port (a copy of
``scripts/decoder_stress.py`` over ``backend/decoder.py`` and
``kio/fst.py``; host code, the native core).

Builds a word-loop graph (default 20,000 words x 3 phones x 3-state HMMs:
about 180k states and 0.5M arcs over 1,980 pdfs), decodes a minute of
synthetic log-likelihoods whose best path is a known word sequence, and
reports frames/s and the real-time factor at 100 frames/s for the best
path, the lattice decode, and 8 utterances over 4 threads sharing one
decoder. Every word must come back (exit 1 otherwise).

Run: ``python -m tf_kaldi_speaker_tpu_torch.validation.decoder_stress
[num_words [num_frames]] [--root DIR] [--write-doc]``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..backend.decoder import WfstDecoder, native_available
from ..kio.fst import build_fst, write_fst
from ..kio.transition_model import TransitionModel
from .common import append_doc


def make_model(num_phones):
    entries = [[
        (0, 0, [(0, 0.75), (1, 0.25)]),
        (1, 1, [(1, 0.75), (2, 0.25)]),
        (2, 2, [(2, 0.75), (3, 0.25)]),
        (-1, -1, []),
    ]]
    phones = list(range(1, num_phones + 1))
    tuples = []
    pdf = 0
    for p in phones:
        for st in range(3):
            tuples.append((p, st, pdf, pdf))
            pdf += 1
    return TransitionModel(phones, [-1] + [0] * num_phones, entries, tuples,
                           np.zeros(1 + 6 * num_phones, np.float32))


def make_graph(tm, lexicon, rng):
    """Word loop; each word is a chain of its phones' 3-state HMMs with a
    random unigram cost on the entry arc."""
    arcs = []
    state = 1
    word_entries = {}
    for w, phones in enumerate(lexicon, start=1):
        prev = 0
        lm = float(rng.uniform(2.0, 8.0))
        seq = []
        for pi, p in enumerate(phones):
            for st in range(3):
                ts = (p - 1) * 3 + st + 1
                self_tid = tm.state2id[ts]
                fwd_tid = self_tid + 1
                s = state
                state += 1
                first = pi == 0 and st == 0
                arcs.append((prev, fwd_tid, w if first else 0,
                             lm if first else 0.0, s))
                arcs.append((s, self_tid, 0, 0.1, s))
                seq.append((self_tid, fwd_tid))
                prev = s
        arcs.append((prev, 0, 0, 0.0, 0))
        word_entries[w] = seq
    return build_fst(0, state, arcs, {0: 0.0}), word_entries


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("num_words", type=int, nargs="?", default=20000)
    p.add_argument("num_frames", type=int, nargs="?", default=6000)
    p.add_argument("--root", default=None)
    p.add_argument("--write-doc", action="store_true")
    args = p.parse_args(argv)
    num_words, num_frames = args.num_words, args.num_frames
    num_phones = 660
    rng = np.random.default_rng(0)
    tm = make_model(num_phones)
    lexicon = [list(rng.integers(1, num_phones + 1, 3)) for _ in range(num_words)]
    fst, word_entries = make_graph(tm, lexicon, rng)
    print("graph: %d states, %d arcs, %d tids, %d pdfs"
          % (fst.num_states, fst.num_arcs, tm.num_transition_ids, tm.num_pdfs))
    path = os.path.join(args.root or tempfile.mkdtemp(prefix="tfks_torch_stress_"),
                        "stress_hclg.fst")
    write_fst(path, fst, "const")
    print("graph file: %.1f MB" % (os.path.getsize(path) / 1e6))

    # synthesize frames for a random word sequence (3 frames/state)
    rows, truth = [], []
    t = 0
    while t < num_frames:
        w = int(rng.integers(1, num_words + 1))
        truth.append(w)
        for self_tid, fwd_tid in word_entries[w]:
            pdf = tm.tid2pdf[fwd_tid]
            for k in range(3):
                row = np.full(tm.num_pdfs, -8.0, np.float32)
                row[pdf] = -0.5
                rows.append(row + rng.normal(0, 0.1, tm.num_pdfs).astype(np.float32))
                t += 1
    loglikes = np.stack(rows)
    seconds = len(rows) / 100.0
    print("loglikes: %d frames (%.1f s of speech at 100 fps)" % (len(rows), seconds))

    if not native_available():
        raise RuntimeError("the stress run needs the native decoder core")
    t0 = time.perf_counter()
    dec = WfstDecoder(path, tm.tid2pdf[1:], acoustic_scale=1.0, beam=13.0, max_active=7000)
    load_s = time.perf_counter() - t0
    print("graph load: %.2f s" % load_s)
    if dec._handle is None:
        raise RuntimeError("the native core did not load the graph")

    t0 = time.perf_counter()
    res = dec.decode(loglikes)
    viterbi_s = time.perf_counter() - t0
    best_ok = list(res.words) == truth and len(res.alignment) == len(rows)
    print("viterbi: %.2f s -> %.0f frames/s (RTF %.4f), %d of %d words, correct: %s"
          % (viterbi_s, len(rows) / viterbi_s, viterbi_s / seconds, len(res.words),
             len(truth), best_ok))

    t0 = time.perf_counter()
    lat, partial = dec.decode_lattice(loglikes, lattice_beam=7.0)
    lattice_s = time.perf_counter() - t0
    w, _, _ = lat.best_path(acoustic_scale=1.0)
    lattice_ok = list(w) == truth
    print("lattice: %.2f s -> %.0f frames/s (RTF %.4f); %d states, %d arcs, partial=%s, "
          "correct: %s" % (lattice_s, len(rows) / lattice_s, lattice_s / seconds,
                           lat.num_states, len(lat.arcs), partial, lattice_ok))

    # Concurrent decode through one shared decoder (per-thread native
    # contexts): the audio cut into utterances, all of them aligned whole.
    n_utts = 8
    per = len(rows) // n_utts
    chunks = [loglikes[i * per:(i + 1) * per] for i in range(n_utts)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(dec.decode, chunks))
    threaded_s = time.perf_counter() - t0
    got = sum(len(r.words) for r in results)
    threaded_ok = all(len(r.alignment) == per for r in results)
    print("threaded (4 workers, %d utts): %.2f s -> %.0f frames/s total, %d words"
          % (n_utts, threaded_s, n_utts * per / threaded_s, got))
    ok = best_ok and lattice_ok and threaded_ok
    text = (
        "\n## WFST decoder stress through the port (host, native core)\n\n"
        "`python -m tf_kaldi_speaker_tpu_torch.validation.decoder_stress` — %d words, %d "
        "states, %d arcs, %d pdfs; %d frames (%.1f s at 100 fps). Graph load %.2f s; best "
        "path %.2f s (%.0f frames/s, RTF %.4f); lattice %.2f s (%.0f frames/s, RTF %.4f); "
        "4 threads over %d utterances %.2f s (%.0f frames/s). Every word recovered "
        "(best path and lattice): **%s**. Host code: the card is not used.\n"
        % (num_words, fst.num_states, fst.num_arcs, tm.num_pdfs, len(rows), seconds, load_s,
           viterbi_s, len(rows) / viterbi_s, viterbi_s / seconds, lattice_s,
           len(rows) / lattice_s, lattice_s / seconds, n_utts, threaded_s,
           n_utts * per / threaded_s, "PASS" if ok else "FAIL"))
    print(text, flush=True)
    if args.write_doc:
        append_doc(text)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
