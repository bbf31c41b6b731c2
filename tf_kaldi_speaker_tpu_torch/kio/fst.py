"""OpenFst binary codec for decoding graphs (HCLG.fst), no OpenFst needed.

The reference decodes its multitask phone head with the external Kaldi
binary ``latgen-faster-mapped`` (reference nnet/run_decode.sh:77-91), whose
graph input is an OpenFst file written by ``mkgraph.sh``. This module reads
(and writes) those files natively so the in-repo WFST decoder
(native/wfst_decoder.cpp, backend/decoder.py) can consume real Kaldi graphs
directly.

Supported: the two on-disk representations Kaldi emits for HCLG —
``vector`` (VectorFst) and ``const`` (ConstFst) — with ``standard``
(tropical-weight) arcs. Layout per OpenFst src/include/fst/fst.h
(FstHeader), vector-fst.h and const-fst.h:

  int32  magic = 2125659606
  string fsttype, string arctype        (int32 length + bytes)
  int32  version, int32 flags           (flags: bit0/bit1 = symbol tables)
  uint64 properties
  int64  start, int64 numstates, int64 numarcs
  [optional input/output SymbolTable if flagged]
  vector body: per state -> float final, int64 narcs,
               narcs x {int32 ilabel, int32 olabel, float weight,
                        int32 nextstate}
  const body:  numstates x ConstState{float final, uint32 pos,
               uint32 narcs, uint32 niepsilons, uint32 noepsilons},
               then numarcs x the 16-byte arc struct; file version 1
               ("aligned") pads both sections to 16-byte file offsets.

The in-memory form is CSR over numpy arrays — the same layout the native
decoder mmaps — so a 100 MB HCLG loads in one pass with no per-arc Python.

Counterpart of ``tf_kaldi_speaker_tpu/kio/fst.py``, whole (numpy only);
``tests/test_torch_decode.py`` holds it equal to the original.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

FST_MAGIC = 2125659606
SYMBOL_TABLE_MAGIC = 2125658996
NO_STATE = -1
# TropicalWeight::Zero() — marks a non-final state.
INF = np.float32(np.inf)

_ARC_DTYPE = np.dtype(
    [("ilabel", "<i4"), ("olabel", "<i4"), ("weight", "<f4"), ("nextstate", "<i4")]
)
_CONST_STATE_DTYPE = np.dtype(
    [
        ("final", "<f4"),
        ("pos", "<u4"),
        ("narcs", "<u4"),
        ("niepsilons", "<u4"),
        ("noepsilons", "<u4"),
    ]
)


class FstError(ValueError):
    pass


@dataclass
class StdFst:
    """Tropical-weight WFST in CSR form.

    ``final[s]`` is the final weight (+inf when not final); arcs of state s
    are ``arcs[arc_offsets[s]:arc_offsets[s+1]]`` over the parallel arrays.
    """

    start: int
    final: np.ndarray  # float32 [num_states]
    arc_offsets: np.ndarray  # int64 [num_states + 1]
    ilabels: np.ndarray  # int32 [num_arcs]
    olabels: np.ndarray  # int32 [num_arcs]
    weights: np.ndarray  # float32 [num_arcs]
    nextstates: np.ndarray  # int32 [num_arcs]

    @property
    def num_states(self) -> int:
        return len(self.final)

    @property
    def num_arcs(self) -> int:
        return len(self.ilabels)

    def state_arcs(self, s: int):
        lo, hi = self.arc_offsets[s], self.arc_offsets[s + 1]
        return (
            self.ilabels[lo:hi],
            self.olabels[lo:hi],
            self.weights[lo:hi],
            self.nextstates[lo:hi],
        )


def _read_string(fd) -> str:
    (n,) = struct.unpack("<i", fd.read(4))
    if n < 0 or n > 1 << 20:
        raise FstError("corrupt string length %d" % n)
    return fd.read(n).decode("utf-8", errors="replace")


def _write_string(fd, s: str) -> None:
    b = s.encode()
    fd.write(struct.pack("<i", len(b)))
    fd.write(b)


def _skip_symbol_table(fd) -> None:
    (magic,) = struct.unpack("<i", fd.read(4))
    if magic != SYMBOL_TABLE_MAGIC:
        raise FstError("bad SymbolTable magic %d" % magic)
    _read_string(fd)  # name
    _avail, size = struct.unpack("<qq", fd.read(16))
    for _ in range(size):
        _read_string(fd)
        fd.read(8)  # key


def read_fst(path: str) -> StdFst:
    """Read an OpenFst binary file (vector or const, standard arcs)."""
    with open(path, "rb") as fd:
        (magic,) = struct.unpack("<i", fd.read(4))
        if magic != FST_MAGIC:
            raise FstError(
                "%s: not an OpenFst file (magic %d)" % (path, magic)
            )
        fsttype = _read_string(fd)
        arctype = _read_string(fd)
        if arctype != "standard":
            raise FstError(
                "%s: unsupported arc type %r (only tropical StdArc graphs "
                "like HCLG are supported)" % (path, arctype)
            )
        version, flags = struct.unpack("<ii", fd.read(8))
        (_properties,) = struct.unpack("<Q", fd.read(8))
        start, num_states, num_arcs = struct.unpack("<qqq", fd.read(24))
        if flags & 0x1:
            _skip_symbol_table(fd)
        if flags & 0x2:
            _skip_symbol_table(fd)
        if fsttype == "vector":
            return _read_vector_body(fd, path, version, start, num_states)
        if fsttype == "const":
            return _read_const_body(
                fd, path, version, start, num_states, num_arcs
            )
        raise FstError("%s: unsupported fst type %r" % (path, fsttype))


def _read_vector_body(fd, path, version, start, num_states) -> StdFst:
    if version < 2:
        raise FstError("%s: VectorFst file version %d unsupported" % (path, version))
    if num_states < 0:
        raise FstError("%s: streamed VectorFst (numstates unknown) unsupported" % path)
    # One pass over the raw bytes: per state a 12-byte (final, narcs)
    # prelude then narcs 16-byte arcs. Parse with numpy views per state —
    # state count is ~arcs/3 for HCLG, and each state costs O(1) Python.
    data = fd.read()
    final = np.empty(num_states, dtype=np.float32)
    counts = np.empty(num_states, dtype=np.int64)
    chunks = []
    pos = 0
    for s in range(num_states):
        final[s] = np.frombuffer(data, dtype="<f4", count=1, offset=pos)[0]
        narcs = int(np.frombuffer(data, dtype="<q", count=1, offset=pos + 4)[0])
        if narcs < 0:
            raise FstError("%s: negative arc count at state %d" % (path, s))
        counts[s] = narcs
        pos += 12
        if narcs:
            chunks.append(
                np.frombuffer(data, dtype=_ARC_DTYPE, count=narcs, offset=pos)
            )
            pos += 16 * narcs
    arcs = (
        np.concatenate(chunks) if chunks else np.empty(0, dtype=_ARC_DTYPE)
    )
    offsets = np.zeros(num_states + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return StdFst(
        start=int(start),
        final=final,
        arc_offsets=offsets,
        ilabels=np.ascontiguousarray(arcs["ilabel"]),
        olabels=np.ascontiguousarray(arcs["olabel"]),
        weights=np.ascontiguousarray(arcs["weight"]),
        nextstates=np.ascontiguousarray(arcs["nextstate"]),
    )


def _read_const_body(fd, path, version, start, num_states, num_arcs) -> StdFst:
    if version not in (1, 2):
        raise FstError("%s: ConstFst file version %d unsupported" % (path, version))
    aligned = version == 1
    if aligned:
        _align_input(fd)
    states = np.frombuffer(
        fd.read(num_states * _CONST_STATE_DTYPE.itemsize),
        dtype=_CONST_STATE_DTYPE,
        count=num_states,
    )
    if aligned:
        _align_input(fd)
    arcs = np.frombuffer(
        fd.read(num_arcs * _ARC_DTYPE.itemsize), dtype=_ARC_DTYPE, count=num_arcs
    )
    pos = states["pos"].astype(np.int64)
    narcs = states["narcs"].astype(np.int64)
    # ConstFst arcs are already grouped per state via (pos, narcs); Kaldi
    # writes them contiguously in state order, but re-gather to be safe.
    offsets = np.zeros(num_states + 1, dtype=np.int64)
    np.cumsum(narcs, out=offsets[1:])
    if num_states and not (
        np.array_equal(pos, offsets[:-1]) and offsets[-1] == num_arcs
    ):
        idx = np.concatenate(
            [np.arange(p, p + n, dtype=np.int64) for p, n in zip(pos, narcs)]
        ) if num_states else np.empty(0, np.int64)
        arcs = arcs[idx]
    return StdFst(
        start=int(start),
        final=np.ascontiguousarray(states["final"]),
        arc_offsets=offsets,
        ilabels=np.ascontiguousarray(arcs["ilabel"]),
        olabels=np.ascontiguousarray(arcs["olabel"]),
        weights=np.ascontiguousarray(arcs["weight"]),
        nextstates=np.ascontiguousarray(arcs["nextstate"]),
    )


def _align_input(fd, alignment: int = 16) -> None:
    pos = fd.tell()
    pad = (-pos) % alignment
    if pad:
        fd.read(pad)


def _align_output(fd, alignment: int = 16) -> None:
    pad = (-fd.tell()) % alignment
    if pad:
        fd.write(b"\x00" * pad)


def write_fst(path: str, fst: StdFst, fst_type: str = "vector") -> None:
    """Write an OpenFst binary file readable by OpenFst/Kaldi tools."""
    if fst_type not in ("vector", "const"):
        raise FstError("unsupported fst type %r" % fst_type)
    with open(path, "wb") as fd:
        fd.write(struct.pack("<i", FST_MAGIC))
        _write_string(fd, fst_type)
        _write_string(fd, "standard")
        # ConstFst on disk is the "aligned" layout (file version 1) —
        # that's what OpenFst emits for seekable files, i.e. every real
        # HCLG.fst; VectorFst uses its file version 2.
        version = 2 if fst_type == "vector" else 1
        fd.write(struct.pack("<ii", version, 0))
        fd.write(struct.pack("<Q", 0))  # properties: none asserted
        fd.write(
            struct.pack("<qqq", fst.start, fst.num_states, fst.num_arcs)
        )
        arcs = np.empty(fst.num_arcs, dtype=_ARC_DTYPE)
        arcs["ilabel"] = fst.ilabels
        arcs["olabel"] = fst.olabels
        arcs["weight"] = fst.weights
        arcs["nextstate"] = fst.nextstates
        if fst_type == "vector":
            for s in range(fst.num_states):
                lo, hi = fst.arc_offsets[s], fst.arc_offsets[s + 1]
                fd.write(struct.pack("<fq", fst.final[s], int(hi - lo)))
                fd.write(arcs[lo:hi].tobytes())
        else:
            states = np.empty(fst.num_states, dtype=_CONST_STATE_DTYPE)
            states["final"] = fst.final
            states["pos"] = fst.arc_offsets[:-1]
            narcs = np.diff(fst.arc_offsets)
            states["narcs"] = narcs
            for s in range(fst.num_states):
                il = fst.ilabels[fst.arc_offsets[s] : fst.arc_offsets[s + 1]]
                ol = fst.olabels[fst.arc_offsets[s] : fst.arc_offsets[s + 1]]
                states["niepsilons"][s] = int(np.count_nonzero(il == 0))
                states["noepsilons"][s] = int(np.count_nonzero(ol == 0))
            _align_output(fd)
            fd.write(states.tobytes())
            _align_output(fd)
            fd.write(arcs.tobytes())


def build_fst(start: int, num_states: int, arcs, finals) -> StdFst:
    """Build a StdFst from (src, ilabel, olabel, weight, dst) tuples and a
    {state: final_weight} dict — the fixture/construction helper."""
    arcs = sorted(arcs, key=lambda a: a[0])
    src = np.array([a[0] for a in arcs], dtype=np.int64)
    counts = np.bincount(src, minlength=num_states) if len(arcs) else np.zeros(
        num_states, dtype=np.int64
    )
    offsets = np.zeros(num_states + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    final = np.full(num_states, INF, dtype=np.float32)
    for s, w in finals.items():
        final[s] = w
    return StdFst(
        start=start,
        final=final,
        arc_offsets=offsets,
        ilabels=np.array([a[1] for a in arcs], dtype=np.int32),
        olabels=np.array([a[2] for a in arcs], dtype=np.int32),
        weights=np.array([a[3] for a in arcs], dtype=np.float32),
        nextstates=np.array([a[4] for a in arcs], dtype=np.int32),
    )


def read_words_txt(path: str) -> Dict[int, str]:
    """Kaldi words.txt symbol table: one "<symbol> <id>" per line."""
    table: Dict[int, str] = {}
    with open(path) as fd:
        for line in fd:
            parts = line.split()
            if len(parts) != 2:
                if parts:
                    raise FstError("%s: bad symbol-table line %r" % (path, line))
                continue
            table[int(parts[1])] = parts[0]
    return table
