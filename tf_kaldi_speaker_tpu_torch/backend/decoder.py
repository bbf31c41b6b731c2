"""WFST beam decoding for the multitask phone head (hybrid ASR).

Replaces the external Kaldi ``latgen-faster-mapped`` + ``lattice-best-path``
pair from the reference decode flow (reference nnet/run_decode.sh:77-91):
HCLG graph + per-frame pdf log-likelihoods -> best word sequence and
frame-level transition-id alignment. "Mapped" semantics: graph input labels
are transition-ids, scored as ``-acoustic_scale * loglike[t, tid2pdf[tid]]``.

Two implementations with identical semantics:
- the native core (native/wfst_decoder.cpp via ctypes; GIL released, so a
  thread pool parallelizes across utterances), used when available;
- a pure-Python token-passing reference (`decode_faster_py`), the test
  oracle and automatic fallback.

Both are Viterbi beam searches with epsilon closure and max-active
pruning — equivalent to Kaldi's faster-decoder followed by best-path
extraction. :func:`decode_lattice_py` additionally generates pruned word
lattices (latgen-faster-mapped semantics; see ``backend/lattice.py`` for
the container, interchange format and scale-sweep best path), so the full
decode-and-score loop — transcripts, WER, scale sweeps — runs with zero
Kaldi binaries.

Counterpart of ``tf_kaldi_speaker_tpu/backend/decoder.py``: the Python code
is a copy (``tests/test_torch_decode.py`` holds ``decode_faster_py`` and
``decode_lattice_py`` bit-equal to the originals). The native core is the
port's copy of ``native/wfst_decoder.cpp``, which g++ builds at first use
through ``kio/native_decode.build`` into ``build/tfks_torch_native/``
(with ``-ffp-contract=off``, so its float costs need not be bit-equal to
the JAX build's; it is held against the Python oracle). A failed build logs
once at WARNING and ``TFKS_DISABLE_NATIVE=1`` forces the Python path.
:data:`counts` counts each decode by the core that ran it (``native`` /
``python``), so a fallback can be seen and asserted against.
"""

from __future__ import annotations

import collections
import ctypes
import logging
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..kio import native_decode
from ..kio.fst import StdFst, read_fst

log = logging.getLogger("tfks_torch.decoder")

_lib = None
_lib_lock = threading.Lock()
_load_failed = False
_count_lock = threading.Lock()
counts: "collections.Counter[str]" = collections.Counter()


def _count(kind: str) -> None:
    with _count_lock:
        counts[kind] += 1


def reset_counts() -> None:
    with _count_lock:
        counts.clear()


def load(path: str) -> ctypes.CDLL:
    """The WFST core's library at ``path`` with its entry points typed."""
    lib = ctypes.CDLL(path)
    lib.tfks_fst_load.restype = ctypes.c_void_p
    lib.tfks_fst_load.argtypes = [ctypes.c_char_p]
    lib.tfks_fst_free.argtypes = [ctypes.c_void_p]
    for fn in (lib.tfks_fst_states, lib.tfks_fst_arcs, lib.tfks_fst_start):
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.tfks_fst_validate.restype = ctypes.c_int
    lib.tfks_fst_validate.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.tfks_decoder_new.restype = ctypes.c_void_p
    lib.tfks_decoder_new.argtypes = [ctypes.c_void_p]
    lib.tfks_decoder_free.argtypes = [ctypes.c_void_p]
    lib.tfks_decode_faster.restype = ctypes.c_int
    lib.tfks_decode_faster.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.tfks_decode_lattice.restype = ctypes.c_int
    lib.tfks_decode_lattice.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if os.environ.get("TFKS_DISABLE_NATIVE") == "1":
        return None
    if _lib is not None or _load_failed:
        return _lib
    with _lib_lock:
        if _lib is None and not _load_failed:
            try:
                _lib = load(native_decode.build(source=native_decode.WFST_SOURCE))
            except Exception as e:  # noqa: BLE001 - logged once, Python path after
                _load_failed = True
                log.warning("native WFST decoder unavailable, decoding in Python: %s", e)
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


@dataclass
class DecodeResult:
    words: np.ndarray  # int32 word ids (olabels > 0), in order
    alignment: np.ndarray  # int32 transition-ids, one per frame
    cost: float  # total tropical cost of the best path
    partial: bool  # True if no final state was reachable


class WfstDecoder:
    """Beam decoder over an HCLG graph.

    ``tid2pdf[i]`` maps transition-id ``i+1`` to its pdf row in the loglike
    matrix (build it with ``TransitionModel.ali_to_pdf(np.arange(1, N+1))``).
    """

    def __init__(
        self,
        graph_path: str,
        tid2pdf: np.ndarray,
        acoustic_scale: float = 0.1,
        beam: float = 13.0,
        max_active: int = 7000,
    ):
        self.tid2pdf = np.ascontiguousarray(tid2pdf, dtype=np.int32)
        self.acoustic_scale = float(acoustic_scale)
        self.beam = float(beam)
        self.max_active = int(max_active)
        self._handle = None
        self._fst: Optional[StdFst] = None
        # Native decoder contexts are reusable but single-threaded: one per
        # calling thread (created lazily), all freed before the fst handle.
        self._tls = threading.local()
        self._ctxs: list = []
        self._ctx_lock = threading.Lock()
        self._validated_pdfs: Optional[int] = None
        lib = _get_lib()
        if lib is not None:
            h = lib.tfks_fst_load(graph_path.encode())
            if h:
                self._handle = h
        if self._handle is None:
            self._fst = read_fst(graph_path)

    def _thread_ctx(self):
        ctx = getattr(self._tls, "ctx", None)
        if ctx is None:
            ctx = _get_lib().tfks_decoder_new(self._handle)
            if not ctx:
                raise RuntimeError("failed to create native decoder context")
            self._tls.ctx = ctx
            with self._ctx_lock:
                self._ctxs.append(ctx)
        return ctx

    def close(self) -> None:
        lib = _get_lib()
        with self._ctx_lock:
            for ctx in self._ctxs:
                lib.tfks_decoder_free(ctx)
            self._ctxs = []
        self._tls = threading.local()
        if self._handle is not None:
            lib.tfks_fst_free(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - finalizer
        try:
            self.close()
        except Exception:
            pass

    def decode(self, loglikes: np.ndarray) -> DecodeResult:
        loglikes = np.ascontiguousarray(loglikes, dtype=np.float32)
        if loglikes.ndim != 2:
            raise ValueError("loglikes must be [num_frames, num_pdfs]")
        if self._handle is not None:
            _count("native")
            return self._decode_native(loglikes)
        _count("python")
        return decode_faster_py(
            self._fst, loglikes, self.tid2pdf,
            acoustic_scale=self.acoustic_scale, beam=self.beam,
            max_active=self.max_active,
        )

    def decode_lattice(self, loglikes: np.ndarray, lattice_beam: float = 8.0):
        """Pruned raw lattice + partial flag (latgen-faster-mapped)."""
        loglikes = np.ascontiguousarray(loglikes, dtype=np.float32)
        if loglikes.ndim != 2:
            raise ValueError("loglikes must be [num_frames, num_pdfs]")
        if self._handle is not None:
            _count("native")
            return self._decode_lattice_native(loglikes, lattice_beam)
        _count("python")
        return decode_lattice_py(
            self._fst, loglikes, self.tid2pdf,
            acoustic_scale=self.acoustic_scale, beam=self.beam,
            lattice_beam=lattice_beam, max_active=self.max_active,
        )

    def _decode_lattice_native(self, loglikes: np.ndarray,
                               lattice_beam: float):
        from .lattice import Lattice, LatticeArc

        lib = _get_lib()
        t, p = loglikes.shape
        if self._validated_pdfs != p:
            rc = lib.tfks_fst_validate(
                self._handle,
                self.tid2pdf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(self.tid2pdf), p,
            )
            if rc != 0:
                raise ValueError(
                    "graph ilabels do not map into [0, %d) pdfs via the "
                    "transition model (%d tids)" % (p, len(self.tid2pdf))
                )
            self._validated_pdfs = p
        ctx = self._thread_ctx()
        cap_arcs = max(4096, 64 * t)
        cap_finals = 4096
        narcs = ctypes.c_int32()
        nfinals = ctypes.c_int32()
        nstates = ctypes.c_int32()
        start = ctypes.c_int32()
        while True:
            arcs = np.empty(4 * cap_arcs, dtype=np.int32)
            arc_costs = np.empty(2 * cap_arcs, dtype=np.float32)
            finals = np.empty(cap_finals, dtype=np.int32)
            final_costs = np.empty(cap_finals, dtype=np.float32)
            rc = lib.tfks_decode_lattice(
                ctx,
                loglikes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                t, p,
                self.tid2pdf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(self.tid2pdf),
                self.acoustic_scale, self.beam, float(lattice_beam),
                self.max_active,
                arcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                arc_costs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                cap_arcs,
                finals.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                final_costs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                cap_finals,
                ctypes.byref(narcs), ctypes.byref(nfinals),
                ctypes.byref(nstates), ctypes.byref(start),
            )
            if rc == -3 and cap_arcs < (1 << 27):  # TFKS_ERR_CAPACITY
                cap_arcs *= 4
                cap_finals *= 4
                continue
            break
        if rc < 0:
            raise RuntimeError("native lattice decode failed (rc=%d)" % rc)
        quads = arcs[: 4 * narcs.value].reshape(-1, 4)
        costs = arc_costs[: 2 * narcs.value].reshape(-1, 2)
        lat = Lattice(
            num_states=int(nstates.value),
            arcs=[
                LatticeArc(int(s), int(d), int(il), int(ol), float(g), float(a))
                for (s, d, il, ol), (g, a) in zip(quads, costs)
            ],
            finals={
                int(finals[i]): (float(final_costs[i]), 0.0)
                for i in range(nfinals.value)
            },
            start=int(start.value),
        )
        return lat, rc == 1

    def _decode_native(self, loglikes: np.ndarray) -> DecodeResult:
        lib = _get_lib()
        t, p = loglikes.shape
        if self._validated_pdfs != p:
            # Once per (graph, model, num_pdfs): every emitting ilabel must
            # map into the loglike matrix (keeps the per-utterance hot path
            # free of the O(num_arcs) scan).
            rc = lib.tfks_fst_validate(
                self._handle,
                self.tid2pdf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(self.tid2pdf), p,
            )
            if rc != 0:
                raise ValueError(
                    "graph ilabels do not map into [0, %d) pdfs via the "
                    "transition model (%d tids)" % (p, len(self.tid2pdf))
                )
            self._validated_pdfs = p
        ctx = self._thread_ctx()
        nw = ctypes.c_int32()
        na = ctypes.c_int32()
        cost = ctypes.c_float()
        cap_w = t + 16
        while True:
            # Output-pushed graphs can emit more words than frames through
            # epsilon-input arcs; grow the buffer on TFKS_ERR_CAPACITY.
            words = np.empty(cap_w, dtype=np.int32)
            align = np.empty(t + 1, dtype=np.int32)
            rc = lib.tfks_decode_faster(
                ctx,
                loglikes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                t, p,
                self.tid2pdf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(self.tid2pdf),
                self.acoustic_scale, self.beam, self.max_active,
                words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap_w,
                align.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), t + 1,
                ctypes.byref(nw), ctypes.byref(na), ctypes.byref(cost),
            )
            if rc == -3 and cap_w < (1 << 24):  # TFKS_ERR_CAPACITY
                cap_w *= 4
                continue
            break
        if rc < 0:
            raise RuntimeError("native decode failed (rc=%d)" % rc)
        return DecodeResult(
            words=words[: nw.value].copy(),
            alignment=align[: na.value].copy(),
            cost=float(cost.value),
            partial=rc == 1,
        )


def _validate_labels_py(fst: StdFst, tid2pdf: np.ndarray, num_pdfs: int) -> None:
    """Python mirror of ``tfks_fst_validate``: reject out-of-range emitting
    ilabels / pdf ids once per decode instead of IndexError-ing (or silently
    negative-index-wrapping) mid-utterance in the hot loop."""
    ilabels = np.asarray(fst.ilabels)
    if ilabels.size:
        lo, hi = int(ilabels.min()), int(ilabels.max())
        if lo < 0 or hi > len(tid2pdf):
            raise ValueError(
                "graph ilabels out of range [0, %d]: min=%d max=%d"
                % (len(tid2pdf), lo, hi))
        # Like the native check, only validate tid2pdf entries the graph
        # actually references: a model whose table has extra/out-of-range
        # rows for transition-ids never used as ilabels must still decode
        # (the two paths must accept the same inputs).
        emitting = ilabels[ilabels > 0]
        if emitting.size:
            pdfs = np.asarray(tid2pdf)[emitting - 1]
            if int(pdfs.min()) < 0 or int(pdfs.max()) >= num_pdfs:
                raise ValueError(
                    "tid2pdf maps graph ilabels outside [0, %d): min=%d "
                    "max=%d" % (num_pdfs, int(pdfs.min()), int(pdfs.max())))


def decode_faster_py(
    fst: StdFst,
    loglikes: np.ndarray,
    tid2pdf: np.ndarray,
    acoustic_scale: float = 0.1,
    beam: float = 13.0,
    max_active: int = 7000,
) -> DecodeResult:
    """Pure-Python token-passing Viterbi (oracle for the native core)."""
    loglikes = np.asarray(loglikes, dtype=np.float32)
    t_total, num_pdfs = loglikes.shape
    tid2pdf = np.asarray(tid2pdf)
    if fst.start < 0:
        raise ValueError("empty decoding graph")
    _validate_labels_py(fst, tid2pdf, num_pdfs)

    # arena of backpointers: (prev, ilabel, olabel)
    arena: List[Tuple[int, int, int]] = []

    def eps_closure(toks: dict) -> None:
        if not toks:
            return
        best = min(c for c, _ in toks.values())
        cutoff = best + beam
        queue = list(toks.keys())
        while queue:
            s = queue.pop()
            cost, bp = toks[s]
            if cost > cutoff:
                continue
            lo, hi = fst.arc_offsets[s], fst.arc_offsets[s + 1]
            for a in range(lo, hi):
                if fst.ilabels[a] != 0:
                    continue
                nc = cost + float(fst.weights[a])
                if nc > cutoff:
                    continue
                ns = int(fst.nextstates[a])
                old = toks.get(ns)
                if old is None or nc < old[0]:
                    arena.append((bp, 0, int(fst.olabels[a])))
                    toks[ns] = (nc, len(arena) - 1)
                    queue.append(ns)
                    if nc < best:
                        best = nc
                        cutoff = best + beam

    toks = {int(fst.start): (0.0, -1)}
    eps_closure(toks)

    for t in range(t_total):
        frame = loglikes[t]
        costs = [c for c, _ in toks.values()]
        cutoff = min(costs) + beam
        if max_active > 0 and len(costs) > max_active:
            cutoff = min(cutoff, float(np.partition(costs, max_active - 1)[max_active - 1]))
        nxt: dict = {}
        next_best = np.inf
        for s, (cost, bp) in toks.items():
            if cost > cutoff:
                continue
            lo, hi = fst.arc_offsets[s], fst.arc_offsets[s + 1]
            for a in range(lo, hi):
                il = int(fst.ilabels[a])
                if il == 0:
                    continue
                nc = cost + float(fst.weights[a]) - acoustic_scale * float(
                    frame[tid2pdf[il - 1]]
                )
                if nc >= next_best + beam:
                    continue
                next_best = min(next_best, nc)
                ns = int(fst.nextstates[a])
                old = nxt.get(ns)
                if old is None or nc < old[0]:
                    arena.append((bp, il, int(fst.olabels[a])))
                    nxt[ns] = (nc, len(arena) - 1)
        if not nxt:
            raise RuntimeError("beam collapsed at frame %d" % t)
        toks = nxt
        eps_closure(toks)

    best_cost, best_bp, partial = np.inf, -1, True
    for s, (cost, bp) in toks.items():
        fw = float(fst.final[s])
        if np.isfinite(fw) and cost + fw < best_cost:
            best_cost, best_bp, partial = cost + fw, bp, False
    if partial:
        for s, (cost, bp) in toks.items():
            if cost < best_cost:
                best_cost, best_bp = cost, bp
    words: List[int] = []
    align: List[int] = []
    bp = best_bp
    while bp >= 0:
        prev, il, ol = arena[bp]
        if ol > 0:
            words.append(ol)
        if il > 0:
            align.append(il)
        bp = prev
    return DecodeResult(
        words=np.array(words[::-1], dtype=np.int32),
        alignment=np.array(align[::-1], dtype=np.int32),
        cost=float(best_cost),
        partial=partial,
    )


def decode_lattice_py(
    fst: StdFst,
    loglikes: np.ndarray,
    tid2pdf: np.ndarray,
    acoustic_scale: float = 0.1,
    beam: float = 13.0,
    lattice_beam: float = 8.0,
    max_active: int = 7000,
):
    """Lattice-generating beam decode (latgen-faster-mapped semantics).

    Token-passing like :func:`decode_faster_py`, but every surviving arc
    expansion is kept as a lattice link; after the last frame the token
    graph is pruned to paths within ``lattice_beam`` of the best and
    emitted as a :class:`~.lattice.Lattice`. Acoustic costs are stored
    UNSCALED (as latgen writes them), so scale sweeps at scoring time are
    exact without re-decoding.
    """
    from .lattice import Lattice, LatticeArc

    loglikes = np.asarray(loglikes, dtype=np.float32)
    t_total, _num_pdfs = loglikes.shape
    tid2pdf = np.asarray(tid2pdf)
    if fst.start < 0:
        raise ValueError("empty decoding graph")
    _validate_labels_py(fst, tid2pdf, _num_pdfs)

    # Global token table: cost (scaled domain), frame, links (incoming:
    # (src_tok, ilabel, olabel, graph_cost, raw_acoustic_cost)).
    tok_cost: List[float] = []
    tok_frame: List[int] = []
    tok_links: List[List[Tuple[int, int, int, float, float]]] = []
    tok_expanded: List[bool] = []

    def new_tok(frame: int, cost: float) -> int:
        tok_cost.append(cost)
        tok_frame.append(frame)
        tok_links.append([])
        tok_expanded.append(False)
        return len(tok_cost) - 1

    def add_link(dst: int, src: int, il: int, ol: int, gc: float, ac: float):
        tok_links[dst].append((src, il, ol, gc, ac))

    def eps_closure(frame: int, toks: dict) -> None:
        best = min((tok_cost[t] for t in toks.values()), default=np.inf)
        cutoff = best + beam
        queue = list(toks.items())
        while queue:
            s, ti = queue.pop()
            cost = tok_cost[ti]
            if cost > cutoff:
                continue
            # Links carry arc costs only, so each (source, arc) is linked at
            # most once per EXISTING destination — on the source's FIRST
            # expansion under the then-current cutoff; re-pops after
            # improvement propagate cost only. A re-pop that CREATES a
            # destination must still link it, or the new token survives
            # pruning with no incoming arc (identical rule in the native
            # core).
            first = not tok_expanded[ti]
            tok_expanded[ti] = True
            lo, hi = fst.arc_offsets[s], fst.arc_offsets[s + 1]
            for a in range(lo, hi):
                if fst.ilabels[a] != 0:
                    continue
                gc = float(fst.weights[a])
                nc = cost + gc
                if nc > cutoff:
                    continue
                ns = int(fst.nextstates[a])
                dst = toks.get(ns)
                created = dst is None
                if created:
                    dst = new_tok(frame, nc)
                    toks[ns] = dst
                    queue.append((ns, dst))
                elif nc < tok_cost[dst]:
                    tok_cost[dst] = nc
                    queue.append((ns, dst))
                if first or created:
                    add_link(dst, ti, 0, int(fst.olabels[a]), gc, 0.0)
                if nc < best:
                    best = nc
                    cutoff = best + beam

    toks: dict = {int(fst.start): new_tok(0, 0.0)}
    eps_closure(0, toks)

    for t in range(t_total):
        frame = loglikes[t]
        costs = [tok_cost[ti] for ti in toks.values()]
        cutoff = min(costs) + beam
        if max_active > 0 and len(costs) > max_active:
            cutoff = min(cutoff, float(
                np.partition(costs, max_active - 1)[max_active - 1]))
        nxt: dict = {}
        next_best = np.inf
        for s, ti in toks.items():
            cost = tok_cost[ti]
            if cost > cutoff:
                continue
            lo, hi = fst.arc_offsets[s], fst.arc_offsets[s + 1]
            for a in range(lo, hi):
                il = int(fst.ilabels[a])
                if il == 0:
                    continue
                gc = float(fst.weights[a])
                raw_ac = -float(frame[tid2pdf[il - 1]])
                nc = cost + gc + acoustic_scale * raw_ac
                if nc >= next_best + beam:
                    continue
                next_best = min(next_best, nc)
                ns = int(fst.nextstates[a])
                dst = nxt.get(ns)
                if dst is None:
                    dst = new_tok(t + 1, nc)
                    nxt[ns] = dst
                elif nc < tok_cost[dst]:
                    tok_cost[dst] = nc
                add_link(dst, ti, il, int(fst.olabels[a]), gc, raw_ac)
        if not nxt:
            raise RuntimeError("beam collapsed at frame %d" % t)
        toks = nxt
        eps_closure(t + 1, toks)

    # Final tokens: (token, final graph cost). Partial path fallback keeps
    # every last-frame token with zero final cost (Kaldi
    # GetRawLattice(use_final_probs=false)).
    finals: Dict[int, float] = {}
    partial = True
    for s, ti in toks.items():
        fw = float(fst.final[s])
        if np.isfinite(fw):
            finals[ti] = fw
            partial = False
    if partial:
        finals = {ti: 0.0 for ti in toks.values()}

    # Backward pass over the token DAG (tokens are created in topological
    # order: frame-majority, eps links point to earlier ids... except
    # in-frame improvement loops — iterate in reverse id order, which is
    # reverse-topological for all emitting links and converges for eps
    # chains because link costs are nonnegative; repeat until stable).
    n = len(tok_cost)
    INF = float("inf")
    beta = [INF] * n
    for ti, fw in finals.items():
        beta[ti] = fw  # scaled domain: final graph cost only
    while True:
        changed = False
        for dst in range(n - 1, -1, -1):
            bd = beta[dst]
            if bd == INF:
                continue
            for (src, il, ol, gc, ac) in tok_links[dst]:
                cand = bd + gc + acoustic_scale * ac
                if cand < beta[src] - 1e-12:
                    beta[src] = cand
                    changed = True
        if not changed:
            break

    best_total = min(tok_cost[ti] + fw for ti, fw in finals.items())
    # alpha = tok_cost is the exact forward best; prune by
    # alpha(src) + link + beta(dst) - best <= lattice_beam.
    keep_tok = [
        i for i in range(n)
        if beta[i] != INF and tok_cost[i] + beta[i] - best_total <= lattice_beam
    ]
    renum = {ti: j for j, ti in enumerate(keep_tok)}
    arcs = []
    for dst in keep_tok:
        for (src, il, ol, gc, ac) in tok_links[dst]:
            if src not in renum:
                continue
            if (tok_cost[src] + gc + acoustic_scale * ac + beta[dst]
                    - best_total) > lattice_beam + 1e-9:
                continue
            arcs.append(LatticeArc(renum[src], renum[dst], il, ol, gc, ac))
    lat = Lattice(
        num_states=len(keep_tok),
        arcs=arcs,
        finals={renum[ti]: (fw, 0.0) for ti, fw in finals.items()
                if ti in renum},
        start=renum[next(i for i in keep_tok if tok_frame[i] == 0
                         and tok_cost[i] == 0.0)],
    )
    return lat, partial
