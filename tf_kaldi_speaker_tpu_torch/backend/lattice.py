"""Lattices: container, Kaldi-text interchange, best-path with scales.

Completes the native decode toolchain (reference nnet/run_decode.sh +
egs ``local/score.sh``): the lattice decoder in ``backend/decoder.py`` /
``native/wfst_decoder.cpp`` emits these, and scoring sweeps
acoustic/LM scales over them WITHOUT re-decoding — the reason Kaldi
recipes keep lattices at all.

The on-disk format is Kaldi's text ``Lattice`` archive (what
``lattice-copy --write-compact=false ark:in 'ark,t:-'`` prints):

    utt-id
    <from> <to> <ilabel(tid)> <olabel(word)> <graph_cost>,<acoustic_cost>
    ...
    <final-state> [<graph_cost>,<acoustic_cost>]
    <blank line>

States are topologically numbered by the decoder (0 = start). Costs are
tropical; total path cost = lm_scale * graph + acoustic_scale * acoustic
(Kaldi applies the inverse acoustic scale at write time — we store the
UNSCALED acoustic cost, as latgen does with --acoustic-scale compensation,
so rescoring sweeps are exact).

Counterpart of ``tf_kaldi_speaker_tpu/backend/lattice.py``, whole (numpy
only); ``tests/test_torch_decode.py`` holds it equal to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, TextIO, Tuple

import numpy as np


@dataclass
class LatticeArc:
    src: int
    dst: int
    ilabel: int  # transition-id (0 = epsilon)
    olabel: int  # word id (0 = epsilon)
    graph_cost: float
    acoustic_cost: float


@dataclass
class Lattice:
    """Acyclic weighted word/alignment lattice for one utterance."""

    num_states: int
    arcs: List[LatticeArc] = field(default_factory=list)
    # state -> (graph_cost, acoustic_cost); only final states present
    finals: Dict[int, Tuple[float, float]] = field(default_factory=dict)
    start: int = 0

    def num_paths_bounded(self, bound: int = 1 << 20) -> int:
        """Path count (capped) — test/diagnostic helper."""
        order = self.topological_order()
        counts = {self.start: 1}
        out: Dict[int, List[LatticeArc]] = {}
        for a in self.arcs:
            out.setdefault(a.src, []).append(a)
        total = 0
        for s in order:
            c = counts.get(s, 0)
            if not c:
                continue
            if s in self.finals:
                total = min(bound, total + c)
            for a in out.get(s, ()):
                counts[a.dst] = min(bound, counts.get(a.dst, 0) + c)
        return total

    def topological_order(self) -> List[int]:
        indeg = [0] * self.num_states
        out: Dict[int, List[int]] = {}
        for a in self.arcs:
            indeg[a.dst] += 1
            out.setdefault(a.src, []).append(a.dst)
        stack = [s for s in range(self.num_states) if indeg[s] == 0]
        order = []
        while stack:
            s = stack.pop()
            order.append(s)
            for d in out.get(s, ()):
                indeg[d] -= 1
                if indeg[d] == 0:
                    stack.append(d)
        if len(order) != self.num_states:
            raise ValueError("lattice has a cycle")
        return order

    def best_path_arcs(
        self, acoustic_scale: float = 1.0, lm_scale: float = 1.0,
        word_ins_penalty: float = 0.0,
    ) -> Tuple[List[int], float]:
        """Arc indices of the shortest path under scaled costs, in path
        order, plus the total cost (shared core of best_path and the
        confidence extraction).

        ``word_ins_penalty`` adds a constant to every word-emitting arc
        AFTER scaling — Kaldi's ``lattice-add-penalty`` applied between
        lattice-scale and lattice-best-path (scripts/diagnostic/score.sh
        word_ins_penalty sweep)."""
        # The topo order and adjacency depend only on the graph; cache them
        # so scale sweeps (lmwt x wip = dozens of best_path calls per
        # lattice) pay the setup once. Keyed on the arc count, the only way
        # this immutable-by-convention structure is ever grown.
        cached = getattr(self, "_dp_cache", None)
        if cached is not None and cached[0] == len(self.arcs):
            _, order, out = cached
        else:
            order = self.topological_order()
            out = {}
            for i, a in enumerate(self.arcs):
                out.setdefault(a.src, []).append((i, a))
            self._dp_cache = (len(self.arcs), order, out)
        INF = float("inf")
        cost = [INF] * self.num_states
        back: List[Tuple[int, int]] = [(-1, -1)] * self.num_states  # (state, arc idx)
        cost[self.start] = 0.0
        for s in order:
            if cost[s] == INF:
                continue
            for i, a in out.get(s, ()):
                c = cost[s] + lm_scale * a.graph_cost + acoustic_scale * a.acoustic_cost
                if a.olabel > 0:
                    c += word_ins_penalty
                if c < cost[a.dst]:
                    cost[a.dst] = c
                    back[a.dst] = (s, i)
        best_state, best_cost = -1, INF
        for s, (g, ac) in self.finals.items():
            if cost[s] == INF:
                continue
            c = cost[s] + lm_scale * g + acoustic_scale * ac
            if c < best_cost:
                best_state, best_cost = s, c
        if best_state < 0:
            raise ValueError("lattice has no reachable final state")
        path: List[int] = []
        s = best_state
        while s != self.start:
            ps, ai = back[s]
            path.append(ai)
            s = ps
        return path[::-1], best_cost

    def best_path(
        self, acoustic_scale: float = 1.0, lm_scale: float = 1.0,
        word_ins_penalty: float = 0.0,
    ) -> Tuple[List[int], List[int], float]:
        """Shortest path under scaled costs: (words, alignment, total_cost).

        Equivalent to ``lattice-scale --acoustic-scale=a --lm-scale=l``
        [+ ``lattice-add-penalty``] + ``lattice-best-path``; sweeping
        scales here replaces re-decoding.
        """
        path, best_cost = self.best_path_arcs(
            acoustic_scale, lm_scale, word_ins_penalty)
        words = [self.arcs[i].olabel for i in path if self.arcs[i].olabel > 0]
        align = [self.arcs[i].ilabel for i in path if self.arcs[i].ilabel > 0]
        return words, align, best_cost


def write_lattice(fd: TextIO, lat: Lattice, key: str) -> None:
    """Write one utterance in Kaldi text-Lattice archive form.

    Kaldi/OpenFst text readers take the first state mentioned as the start
    state; the in-repo decoders always renumber their start token to 0 and
    list its outgoing arcs first, which we assert rather than assume."""
    if lat.start != 0:
        raise ValueError("text lattices require start state 0 (got %d)"
                         % lat.start)
    fd.write("%s\n" % key)
    # OpenFst/Kaldi text readers adopt the first mentioned state as start;
    # emit state-0 arcs first so an incoming-epsilon ordering (arcs grouped
    # by destination) can never promote some other src to the start state.
    for a in sorted(lat.arcs, key=lambda a: a.src != 0):
        fd.write(
            "%d %d %d %d %.7g,%.7g\n"
            % (a.src, a.dst, a.ilabel, a.olabel, a.graph_cost, a.acoustic_cost)
        )
    for s in sorted(lat.finals):
        g, ac = lat.finals[s]
        if g == 0.0 and ac == 0.0:
            fd.write("%d\n" % s)
        else:
            fd.write("%d %.7g,%.7g\n" % (s, g, ac))
    fd.write("\n")


def read_lattice_ark(path: str) -> Iterable[Tuple[str, Lattice]]:
    """Read a text lattice archive (yields (utt-id, Lattice)).

    Accepts BOTH Kaldi text forms:
    - ``Lattice`` (5-field arcs ``src dst tid word g,a``) — what
      :func:`write_lattice` emits;
    - ``CompactLattice`` (4-field arcs ``src dst word g,a,tid1_tid2_...``,
      the default of ``lattice-copy ark:in ark,t:out``) — each compact arc
      expands into a chain of per-frame arcs with the word on the first,
      so externally produced lattices score with the same tools.
    """
    with open(path) as fd:
        key = None
        entries: List[tuple] = []
        max_state = -1
        first_state = None

        def emit():
            nonlocal max_state
            arcs: List[LatticeArc] = []
            finals: Dict[int, Tuple[float, float]] = {}
            next_state = max_state + 1

            def chain(src, dst, word, g, ac, tids):
                nonlocal next_state
                if not tids:
                    arcs.append(LatticeArc(src, dst, 0, word, g, ac))
                    return
                prev = src
                for j, tid in enumerate(tids):
                    last = j == len(tids) - 1
                    nxt = dst if last else next_state
                    if not last:
                        next_state += 1
                    arcs.append(LatticeArc(
                        prev, nxt, tid, word if j == 0 else 0,
                        g if j == 0 else 0.0, ac if j == 0 else 0.0))
                    prev = nxt

            for e in entries:
                if e[0] == "arc":
                    arcs.append(LatticeArc(*e[1:]))
                elif e[0] == "carc":
                    chain(*e[1:])
                else:  # final
                    _, st, g, ac, tids = e
                    if tids:
                        # final weight carries an alignment string: route it
                        # through a fresh chain to a new final state
                        fs = next_state
                        next_state += 1
                        chain(st, fs, 0, g, ac, tids)
                        finals[fs] = (0.0, 0.0)
                    else:
                        finals[st] = (g, ac)
            n = max(max_state + 1, next_state)
            return Lattice(num_states=max(n, 1), arcs=arcs, finals=finals,
                           start=first_state if first_state is not None else 0)

        def parse_weight3(w):
            g, ac, tids = (w.split(",") + ["", ""])[:3]
            tid_list = [int(t) for t in tids.split("_") if t] if tids else []
            return float(g or 0.0), float(ac or 0.0), tid_list

        for line in fd:
            parts = line.split()
            if not parts:
                if key is not None:
                    yield key, emit()
                key, entries, max_state = None, [], -1
                first_state = None
                continue
            if key is None:
                if len(parts) != 1:
                    raise ValueError("expected utterance id, got %r" % line)
                key = parts[0]
                continue
            if len(parts) == 1:  # final, unit weight
                st = int(parts[0])
                first_state = st if first_state is None else first_state
                entries.append(("final", st, 0.0, 0.0, []))
                max_state = max(max_state, st)
            elif len(parts) == 2:  # final with weight (either form)
                st = int(parts[0])
                first_state = st if first_state is None else first_state
                if parts[1].count(",") >= 2:
                    g, ac, tids = parse_weight3(parts[1])
                else:
                    gs, acs = parts[1].split(",")
                    g, ac, tids = float(gs), float(acs), []
                entries.append(("final", st, g, ac, tids))
                max_state = max(max_state, st)
            elif len(parts) == 4:  # CompactLattice arc
                src, dst, word = int(parts[0]), int(parts[1]), int(parts[2])
                first_state = src if first_state is None else first_state
                g, ac, tids = parse_weight3(parts[3])
                entries.append(("carc", src, dst, word, g, ac, tids))
                max_state = max(max_state, src, dst)
            elif len(parts) == 5:  # Lattice arc
                g, ac = parts[4].split(",")[:2]
                a = ("arc", int(parts[0]), int(parts[1]), int(parts[2]),
                     int(parts[3]), float(g), float(ac))
                first_state = a[1] if first_state is None else first_state
                entries.append(a)
                max_state = max(max_state, a[1], a[2])
            else:
                raise ValueError("bad lattice line %r" % line)
        if key is not None:
            yield key, emit()


def arc_posteriors(
    lat: Lattice, acoustic_scale: float = 1.0, lm_scale: float = 1.0
) -> np.ndarray:
    """Posterior probability of each arc under the scaled lattice
    distribution (Kaldi ``lattice-to-post``): log-domain forward/backward
    over the acyclic lattice; posterior(arc) =
    exp(alpha[src] + logw(arc) + beta[dst] - total), where logw = the
    negated scaled tropical cost. Arc posteriors sum to 1 across any
    topological cut; per-word confidences come from the best path's arcs.
    """
    order = lat.topological_order()
    NEG = -np.inf
    logw = np.array(
        [-(lm_scale * a.graph_cost + acoustic_scale * a.acoustic_cost)
         for a in lat.arcs]
    )
    out: Dict[int, list] = {}
    inn: Dict[int, list] = {}
    for i, a in enumerate(lat.arcs):
        out.setdefault(a.src, []).append(i)
        inn.setdefault(a.dst, []).append(i)
    alpha = np.full(lat.num_states, NEG)
    alpha[lat.start] = 0.0
    for s in order:
        if alpha[s] == NEG:
            continue
        for i in out.get(s, ()):
            d = lat.arcs[i].dst
            alpha[d] = np.logaddexp(alpha[d], alpha[s] + logw[i])
    beta = np.full(lat.num_states, NEG)
    for s, (g, ac) in lat.finals.items():
        beta[s] = -(lm_scale * g + acoustic_scale * ac)
    for s in reversed(order):
        for i in out.get(s, ()):
            a = lat.arcs[i]
            if beta[a.dst] != NEG:
                beta[s] = np.logaddexp(beta[s], logw[i] + beta[a.dst])
    total = NEG
    for s, (g, ac) in lat.finals.items():
        if alpha[s] != NEG:
            total = np.logaddexp(
                total, alpha[s] - (lm_scale * g + acoustic_scale * ac))
    if total == NEG:
        raise ValueError("lattice has no complete path")
    post = np.zeros(len(lat.arcs))
    for i, a in enumerate(lat.arcs):
        if alpha[a.src] != NEG and beta[a.dst] != NEG:
            post[i] = np.exp(alpha[a.src] + logw[i] + beta[a.dst] - total)
    return post


def _state_frames(lat: Lattice) -> List[int]:
    """Frame index per state (number of emitting arcs from the start —
    well-defined: every path to a state consumes the same frame count)."""
    order = lat.topological_order()
    frame = [-1] * lat.num_states
    frame[lat.start] = 0
    out: Dict[int, List[LatticeArc]] = {}
    for a in lat.arcs:
        out.setdefault(a.src, []).append(a)
    for s in order:
        if frame[s] < 0:
            continue
        for a in out.get(s, ()):
            nf = frame[s] + (1 if a.ilabel > 0 else 0)
            if frame[a.dst] < 0:
                frame[a.dst] = nf
            elif frame[a.dst] != nf:
                raise ValueError("inconsistent frame alignment in lattice")
    return frame


def best_path_confidences(
    lat: Lattice, acoustic_scale: float = 1.0, lm_scale: float = 1.0,
    word_ins_penalty: float = 0.0,
):
    """Best-path words with PER-OCCURRENCE posterior confidences: for each
    word arc on the best path, the total posterior of lattice arcs carrying
    the same word label at the same frame index (a light-weight stand-in
    for Kaldi's MBR/sausage confidences — time-aligned competitors pool,
    other occurrences of the same word do not).

    ``word_ins_penalty`` picks the same best path the sweep selected; the
    posteriors themselves stay penalty-free (Kaldi's lattice-to-post is run
    on the scaled, un-penalized lattice)."""
    post = arc_posteriors(lat, acoustic_scale, lm_scale)
    frame = _state_frames(lat)
    pooled: Dict[Tuple[int, int], float] = {}
    for i, a in enumerate(lat.arcs):
        if a.olabel > 0:
            key = (a.olabel, frame[a.src])
            pooled[key] = pooled.get(key, 0.0) + post[i]
    path, _ = lat.best_path_arcs(acoustic_scale, lm_scale, word_ins_penalty)
    return [
        (lat.arcs[i].olabel,
         min(1.0, pooled.get((lat.arcs[i].olabel, frame[lat.arcs[i].src]),
                             0.0)))
        for i in path if lat.arcs[i].olabel > 0
    ]


def depth_stats(lat: Lattice) -> Tuple[float, int]:
    """Lattice depth: mean/max number of frame-consuming arcs per frame
    (the headline statistic of Kaldi's diagnostic analyze_lats.sh).

    Frame index of a state = number of emitting arcs on any path from the
    start (well-defined: every path to a state consumes the same number of
    frames)."""
    frame = _state_frames(lat)
    per_frame: Dict[int, int] = {}
    for a in lat.arcs:
        if a.ilabel > 0 and frame[a.src] >= 0:
            per_frame[frame[a.src]] = per_frame.get(frame[a.src], 0) + 1
    if not per_frame:
        return 0.0, 0
    counts = list(per_frame.values())
    return float(np.mean(counts)), int(max(counts))


# ----------------------------------------------------------------------
# CompactLattice + determinization
# ----------------------------------------------------------------------

@dataclass
class CompactArc:
    src: int
    dst: int
    word: int
    graph_cost: float
    acoustic_cost: float
    tids: Tuple[int, ...] = ()


@dataclass
class CompactLattice:
    """Word-deterministic lattice: per word sequence exactly one path, arcs
    carry the transition-id alignment string (Kaldi CompactLattice — the
    output contract of latgen-faster-mapped determinize-lattice=true,
    reference nnet/run_decode.sh:77-91)."""

    num_states: int
    arcs: List[CompactArc] = field(default_factory=list)
    # state -> (graph_cost, acoustic_cost, tids)
    finals: Dict[int, Tuple[float, float, Tuple[int, ...]]] = field(
        default_factory=dict)
    start: int = 0

    def topological_order(self) -> List[int]:
        indeg = [0] * self.num_states
        out: Dict[int, List[int]] = {}
        for a in self.arcs:
            indeg[a.dst] += 1
            out.setdefault(a.src, []).append(a.dst)
        stack = [s for s in range(self.num_states) if indeg[s] == 0]
        order = []
        while stack:
            s = stack.pop()
            order.append(s)
            for d in out.get(s, ()):
                indeg[d] -= 1
                if indeg[d] == 0:
                    stack.append(d)
        if len(order) != self.num_states:
            raise ValueError("compact lattice has a cycle")
        return order

    def best_path(
        self, acoustic_scale: float = 1.0, lm_scale: float = 1.0
    ) -> Tuple[List[int], List[int], float]:
        """(words, alignment, total_cost) of the shortest path."""
        order = self.topological_order()
        INF = float("inf")
        cost = [INF] * self.num_states
        back: Dict[int, CompactArc] = {}
        cost[self.start] = 0.0
        out: Dict[int, List[CompactArc]] = {}
        for a in self.arcs:
            out.setdefault(a.src, []).append(a)
        for s in order:
            if cost[s] == INF:
                continue
            for a in out.get(s, ()):
                c = cost[s] + lm_scale * a.graph_cost + acoustic_scale * a.acoustic_cost
                if c < cost[a.dst]:
                    cost[a.dst] = c
                    back[a.dst] = a
        best_state, best_cost, best_fin = -1, INF, None
        for s, (g, ac, tids) in self.finals.items():
            if cost[s] == INF:
                continue
            c = cost[s] + lm_scale * g + acoustic_scale * ac
            if c < best_cost:
                best_state, best_cost, best_fin = s, c, tids
        if best_state < 0:
            raise ValueError("compact lattice has no reachable final state")
        rev: List[CompactArc] = []
        s = best_state
        while s != self.start:
            a = back[s]
            rev.append(a)
            s = a.src
        words, align = [], []
        for a in reversed(rev):
            if a.word > 0:
                words.append(a.word)
            align.extend(a.tids)
        align.extend(best_fin)
        return words, align, best_cost

    def paths(self, limit: int = 100000):
        """Enumerate (word tuple, align tuple, total cost) of every path —
        test/diagnostic helper (determinized lattices are small)."""
        out: Dict[int, List[CompactArc]] = {}
        for a in self.arcs:
            out.setdefault(a.src, []).append(a)
        results = []
        stack = [(self.start, (), (), 0.0, 0.0)]
        while stack:
            s, words, tids, g, ac = stack.pop()
            if len(results) >= limit:
                raise ValueError("path limit exceeded")
            if s in self.finals:
                fg, fa, ftids = self.finals[s]
                results.append((words, tids + ftids, g + fg, ac + fa))
            for a in out.get(s, ()):
                stack.append((
                    a.dst,
                    words + ((a.word,) if a.word > 0 else ()),
                    tids + a.tids, g + a.graph_cost, ac + a.acoustic_cost,
                ))
        return results


def determinize_lattice(
    lat: Lattice,
    acoustic_scale: float = 1.0,
    lm_scale: float = 1.0,
    beam: float | None = None,
    max_states: int = 200000,
) -> CompactLattice:
    """Determinize a raw state-level lattice on WORD labels (Kaldi
    DeterminizeLatticePruned semantics, the default latgen post-pass).

    Weighted subset construction in the lattice semiring: a determinized
    state is a normalized set of (raw state, residual (graph, acoustic)
    cost, residual tid string); plus-selection keeps the single best
    residual per raw state (LatticeWeight's min-by-total), which makes
    determinization functional — per word sequence exactly the best path
    survives, with its frame alignment on the arc strings. ``beam`` prunes
    members whose best completion exceeds best_total + beam (the raw
    lattice is already lattice-beam-pruned, so the default keeps
    everything). Raises if ``max_states`` determinized states are exceeded
    (Kaldi falls back to the raw lattice in that case — callers catch).

    Scales enter COMPARISONS only (member selection, pruning); stored
    costs stay unscaled, so downstream scale sweeps remain exact.
    """
    order = lat.topological_order()
    out_eps: Dict[int, List[LatticeArc]] = {}
    out_word: Dict[int, Dict[int, List[LatticeArc]]] = {}
    for a in lat.arcs:
        if a.olabel == 0:
            out_eps.setdefault(a.src, []).append(a)
        else:
            out_word.setdefault(a.src, {}).setdefault(a.olabel, []).append(a)

    def total(g: float, ac: float) -> float:
        return lm_scale * g + acoustic_scale * ac

    # Backward best-completion bound for pruning.
    INF = float("inf")
    beta = [INF] * lat.num_states
    for s, (g, ac) in lat.finals.items():
        beta[s] = total(g, ac)
    out_all: Dict[int, List[LatticeArc]] = {}
    for a in lat.arcs:
        out_all.setdefault(a.src, []).append(a)
    for s in reversed(order):
        for a in out_all.get(s, ()):
            c = total(a.graph_cost, a.acoustic_cost) + beta[a.dst]
            if c < beta[s]:
                beta[s] = c
    if beta[lat.start] == INF:
        raise ValueError("lattice has no complete path")
    best_total = beta[lat.start]

    def closure(members: Dict[int, Tuple[float, float, Tuple[int, ...]]]):
        """Absorb word-epsilon arcs; keep the best residual per state."""
        stack = list(members.items())
        while stack:
            s, (g, ac, ts) = stack.pop()
            cur = members.get(s)
            if cur is None or total(cur[0], cur[1]) < total(g, ac) - 1e-12:
                continue  # superseded
            for a in out_eps.get(s, ()):
                ng, na = g + a.graph_cost, ac + a.acoustic_cost
                nts = ts + ((a.ilabel,) if a.ilabel > 0 else ())
                old = members.get(a.dst)
                if old is None or total(ng, na) < total(old[0], old[1]) - 1e-12:
                    members[a.dst] = (ng, na, nts)
                    stack.append((a.dst, (ng, na, nts)))
        return members

    def normalize(members, fwd_cost):
        """Prune, subtract the best member's cost pair, factor the common
        tid prefix. Returns (base_g, base_ac, prefix, key, norm_members)."""
        if beam is not None:
            members = {
                s: m for s, m in members.items()
                if beta[s] < INF
                and fwd_cost + total(m[0], m[1]) + beta[s]
                <= best_total + beam + 1e-9
            }
        else:
            members = {s: m for s, m in members.items()
                       if beta[s] < INF or s in lat.finals}
        if not members:
            return None
        base_s = min(members, key=lambda s: total(members[s][0], members[s][1]))
        bg, ba, _ = members[base_s]
        prefix: Tuple[int, ...] | None = None
        for _, (_, _, ts) in members.items():
            if prefix is None:
                prefix = ts
            else:
                n = 0
                for x, y in zip(prefix, ts):
                    if x != y:
                        break
                    n += 1
                prefix = prefix[:n]
        prefix = prefix or ()
        norm = {
            s: (g - bg, ac - ba, ts[len(prefix):])
            for s, (g, ac, ts) in members.items()
        }
        key = tuple(sorted(
            (s, round(g, 6), round(ac, 6), ts) for s, (g, ac, ts) in norm.items()
        ))
        return bg, ba, prefix, key, norm

    # The start det-state is NOT normalized: an OpenFst start state carries
    # no weight/string to hang a base cost or prefix on. Its key is a
    # sentinel so no normalized state can alias it.
    start_members = closure({lat.start: (0.0, 0.0, ())})
    if beam is not None:
        start_members = {
            s: m for s, m in start_members.items()
            if beta[s] < INF and total(m[0], m[1]) + beta[s]
            <= best_total + beam + 1e-9
        }
    else:
        start_members = {s: m for s, m in start_members.items()
                         if beta[s] < INF}
    if not start_members:
        raise ValueError("lattice start pruned away")

    det_ids: Dict[tuple, int] = {("__start__",): 0}
    det_members = {0: start_members}
    det_fwd = {0: 0.0}
    arcs: List[CompactArc] = []
    finals: Dict[int, Tuple[float, float, Tuple[int, ...]]] = {}
    queue = [0]

    while queue:
        d = queue.pop()
        members = det_members[d]
        fwd = det_fwd[d]
        # finals
        best_fin = None
        for s, (g, ac, ts) in members.items():
            if s in lat.finals:
                fg, fa = lat.finals[s]
                cand = (g + fg, ac + fa, ts)
                if best_fin is None or total(cand[0], cand[1]) < total(
                        best_fin[0], best_fin[1]):
                    best_fin = cand
        if best_fin is not None:
            finals[d] = best_fin
        # word transitions
        words = sorted({
            w for s in members for w in out_word.get(s, {})
        })
        for w in words:
            new: Dict[int, Tuple[float, float, Tuple[int, ...]]] = {}
            for s, (g, ac, ts) in members.items():
                for a in out_word.get(s, {}).get(w, ()):
                    ng, na = g + a.graph_cost, ac + a.acoustic_cost
                    nts = ts + ((a.ilabel,) if a.ilabel > 0 else ())
                    old = new.get(a.dst)
                    if old is None or total(ng, na) < total(old[0], old[1]) - 1e-12:
                        new[a.dst] = (ng, na, nts)
            res = normalize(closure(new), fwd)
            if res is None:
                continue
            bg, ba, prefix, key, norm = res
            nd = det_ids.get(key)
            if nd is None:
                nd = len(det_ids)
                if nd >= max_states:
                    raise ValueError(
                        "determinization exceeded %d states" % max_states)
                det_ids[key] = nd
                det_members[nd] = norm
                det_fwd[nd] = fwd + total(bg, ba)
                queue.append(nd)
            else:
                det_fwd[nd] = min(det_fwd[nd], fwd + total(bg, ba))
            arcs.append(CompactArc(d, nd, w, bg, ba, prefix))

    return CompactLattice(
        num_states=len(det_ids), arcs=arcs, finals=finals, start=0
    )


def write_compact_lattice(fd: TextIO, clat: CompactLattice, key: str) -> None:
    """Write one utterance in Kaldi CompactLattice text-archive form
    (``lattice-copy ark:in ark,t:out`` default): 4-field arcs
    ``src dst word graph,acoustic,tid1_tid2_...``; interoperates with real
    Kaldi lattice-* tools and with :func:`read_lattice_ark`."""
    if clat.start != 0:
        raise ValueError("text lattices require start state 0 (got %d)"
                         % clat.start)
    fd.write("%s\n" % key)
    for a in sorted(clat.arcs, key=lambda a: a.src != 0):
        fd.write("%d %d %d %.7g,%.7g,%s\n" % (
            a.src, a.dst, a.word, a.graph_cost, a.acoustic_cost,
            "_".join(str(t) for t in a.tids)))
    for s in sorted(clat.finals):
        g, ac, tids = clat.finals[s]
        if g == 0.0 and ac == 0.0 and not tids:
            fd.write("%d\n" % s)
        else:
            fd.write("%d %.7g,%.7g,%s\n" % (
                s, g, ac, "_".join(str(t) for t in tids)))
    fd.write("\n")
