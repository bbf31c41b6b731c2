"""Kaldi TransitionModel parser: transition-ids -> pdf-ids, natively.

A copy of ``tf_kaldi_speaker_tpu/kio/transition_model.py`` (numpy only)
on the port's ``open_or_fd``; ``tests/test_torch_multitask.py`` runs the
JAX package's transition-model cases against both.

Replaces the external ``ali-to-pdf`` / ``tree-info`` binaries in the
multitask data path (reference scripts/prepare_pdf_for_multitask_egs.sh:20,
dataset/multitask/data_loader_v2.py:228): alignments produced by a Kaldi
GMM/chain system store *transition-ids*; the phone classifier trains on
*pdf-ids* (senones). The mapping lives in the transition model at the head
of ``final.mdl``.

Supports both serializations Kaldi emits:
- binary (``\\0B`` marker) with either the modern ``<Tuples>`` table
  (phone, hmm-state, forward-pdf, self-loop-pdf) or the legacy
  ``<Triples>`` (phone, hmm-state, pdf);
- text (as produced by ``copy-transition-model --binary=false``).

Layout (kaldi/src/hmm/transition-model.cc Write / hmm-topology.cc Write):
  <TransitionModel> <Topology> ... <Tuples|Triples> N rows </Tuples|Triples>
  <LogProbs> FV dim floats </LogProbs> </TransitionModel>
The derived tid->pdf mapping follows TransitionModel::ComputeDerived:
transition-state s (1-based, one per tuple) owns transition-indices
0..len(transitions)-1 of its topology state; tid = state2id[s] + index; a
transition whose destination equals its own HMM state is a self-loop and
maps to the self-loop pdf, every other transition to the forward pdf.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from .rspecifier import open_or_fd


class TransitionModelError(ValueError):
    pass


# ----------------------------------------------------------------------
# Low-level Kaldi binary primitives
# ----------------------------------------------------------------------

def _expect_token(fd, token: str):
    got = _read_token(fd)
    if got != token:
        raise TransitionModelError("expected %r, got %r" % (token, got))


def _read_token(fd) -> str:
    chars = []
    b = fd.read(1)
    while b in (b" ", b"\t", b"\n", b"\r"):
        b = fd.read(1)
    while b not in (b"", b" ", b"\t", b"\n", b"\r"):
        chars.append(b)
        b = fd.read(1)
    return b"".join(chars).decode()


def _read_basic_int(fd) -> int:
    sz = fd.read(1)
    if sz != b"\x04":
        raise TransitionModelError("bad int size byte %r" % sz)
    return struct.unpack("<i", fd.read(4))[0]


def _read_basic_float(fd) -> float:
    sz = fd.read(1)
    if sz == b"\x04":
        return struct.unpack("<f", fd.read(4))[0]
    if sz == b"\x08":
        return struct.unpack("<d", fd.read(8))[0]
    raise TransitionModelError("bad float size byte %r" % sz)


def _read_int_vector(fd) -> List[int]:
    sz = fd.read(1)
    if sz != b"\x04":
        raise TransitionModelError("bad int-vector size byte %r" % sz)
    n = struct.unpack("<i", fd.read(4))[0]
    return list(struct.unpack("<%di" % n, fd.read(4 * n)))


def _read_float_vector(fd) -> np.ndarray:
    token = _read_token(fd)
    if token == "FV":
        dt, width = "<f4", 4
    elif token == "DV":
        dt, width = "<f8", 8
    else:
        raise TransitionModelError("bad vector marker %r" % token)
    sz = fd.read(1)
    if sz != b"\x04":
        raise TransitionModelError("bad vector dim size byte %r" % sz)
    n = struct.unpack("<i", fd.read(4))[0]
    return np.frombuffer(fd.read(width * n), dtype=dt).astype(np.float32)


# ----------------------------------------------------------------------
# Model
# ----------------------------------------------------------------------

class TransitionModel:
    """tid->pdf mapping derived from topology + tuples.

    ``entries``: per topology-entry list of states; each state is
    (forward_pdf_class, self_loop_pdf_class, [(dest_state, prob), ...]).
    ``tuples``: (phone, hmm_state, forward_pdf, self_loop_pdf) per
    transition state (legacy triples store forward == self_loop).
    """

    def __init__(self, phones, phone2idx, entries, tuples, log_probs=None):
        self.phones = phones
        self.phone2idx = phone2idx
        self.entries = entries
        self.tuples = tuples
        self.log_probs = log_probs
        self._compute_derived()

    def _compute_derived(self):
        # state2id[s] = first transition-id of transition-state s (1-based)
        self.state2id = [0, 1]
        for phone, hmm_state, _fwd, _self in self.tuples:
            entry = self.entries[self.phone2idx[phone]]
            n_trans = len(entry[hmm_state][2])
            self.state2id.append(self.state2id[-1] + n_trans)
        num_tids = self.state2id[-1] - 1
        tid2pdf = np.zeros(num_tids + 1, dtype=np.int32)  # index 0 unused
        for s, (phone, hmm_state, fwd_pdf, self_pdf) in enumerate(self.tuples, 1):
            entry = self.entries[self.phone2idx[phone]]
            transitions = entry[hmm_state][2]
            base = self.state2id[s]
            for idx, (dest, _prob) in enumerate(transitions):
                is_self_loop = dest == hmm_state
                tid2pdf[base + idx] = self_pdf if is_self_loop else fwd_pdf
        self.tid2pdf = tid2pdf

    @property
    def num_transition_ids(self) -> int:
        return len(self.tid2pdf) - 1

    @property
    def num_pdfs(self) -> int:
        if not self.tuples:
            return 0
        return 1 + max(max(f, s) for _, _, f, s in self.tuples)

    def ali_to_pdf(self, alignment: np.ndarray) -> np.ndarray:
        """Map an utterance's transition-id alignment to pdf-ids
        (kaldi ali-to-pdf semantics)."""
        ali = np.asarray(alignment, dtype=np.int64)
        if ali.size and (ali.min() < 1 or ali.max() > self.num_transition_ids):
            raise TransitionModelError(
                "transition-id out of range [1, %d]" % self.num_transition_ids
            )
        return self.tid2pdf[ali]


# ----------------------------------------------------------------------
# Readers
# ----------------------------------------------------------------------

def read_transition_model(rxfilename: str) -> TransitionModel:
    """Read the TransitionModel heading a Kaldi .mdl (binary or text)."""
    fd = open_or_fd(rxfilename)
    try:
        head = fd.read(2)
        if head == b"\x00B":
            return _read_binary(fd)
        # text model: pull the whole stream
        rest = head + fd.read()
        return _read_text(rest.decode())
    finally:
        fd.close()


def _read_binary(fd) -> TransitionModel:
    _expect_token(fd, "<TransitionModel>")
    _expect_token(fd, "<Topology>")
    phones = _read_int_vector(fd)
    phone2idx = _read_int_vector(fd)
    n_entries = _read_basic_int(fd)
    entries = []
    for _ in range(n_entries):
        n_states = _read_basic_int(fd)
        states = []
        for _ in range(n_states):
            fwd_class = _read_basic_int(fd)
            self_class = _read_basic_int(fd)
            n_trans = _read_basic_int(fd)
            transitions = []
            for _ in range(n_trans):
                dest = _read_basic_int(fd)
                prob = _read_basic_float(fd)
                transitions.append((dest, prob))
            states.append((fwd_class, self_class, transitions))
        entries.append(states)
    token = _read_token(fd)
    if token == "</Topology>":
        token = _read_token(fd)
    tuples = []
    if token == "<Tuples>":
        n = _read_basic_int(fd)
        for _ in range(n):
            phone = _read_basic_int(fd)
            hmm_state = _read_basic_int(fd)
            fwd = _read_basic_int(fd)
            slf = _read_basic_int(fd)
            tuples.append((phone, hmm_state, fwd, slf))
        _expect_token(fd, "</Tuples>")
    elif token == "<Triples>":
        n = _read_basic_int(fd)
        for _ in range(n):
            phone = _read_basic_int(fd)
            hmm_state = _read_basic_int(fd)
            pdf = _read_basic_int(fd)
            tuples.append((phone, hmm_state, pdf, pdf))
        _expect_token(fd, "</Triples>")
    else:
        raise TransitionModelError("expected <Tuples>/<Triples>, got %r" % token)
    _expect_token(fd, "<LogProbs>")
    log_probs = _read_float_vector(fd)
    _expect_token(fd, "</LogProbs>")
    _expect_token(fd, "</TransitionModel>")
    return TransitionModel(phones, phone2idx, entries, tuples, log_probs)


def _read_text(text: str) -> TransitionModel:
    toks = text.split()
    pos = 0

    def tk():
        nonlocal pos
        t = toks[pos]
        pos += 1
        return t

    def expect(t):
        got = tk()
        if got != t:
            raise TransitionModelError("expected %r, got %r" % (t, got))

    expect("<TransitionModel>")
    expect("<Topology>")
    entries = []
    entry_phones: List[List[int]] = []
    while toks[pos] == "<TopologyEntry>":
        tk()
        expect("<ForPhones>")
        phones_here = []
        while toks[pos] != "</ForPhones>":
            phones_here.append(int(tk()))
        tk()  # </ForPhones>
        states = []
        while toks[pos] == "<State>":
            tk()
            int(tk())  # state index
            fwd_class, self_class = -1, -1
            transitions = []
            while toks[pos] not in ("</State>",):
                t = tk()
                if t == "<PdfClass>":
                    fwd_class = int(tk())
                    self_class = fwd_class
                elif t == "<ForwardPdfClass>":
                    fwd_class = int(tk())
                elif t == "<SelfLoopPdfClass>":
                    self_class = int(tk())
                elif t == "<Transition>":
                    dest = int(tk())
                    prob = float(tk())
                    transitions.append((dest, prob))
                else:
                    raise TransitionModelError("unexpected token %r in <State>" % t)
            tk()  # </State>
            states.append((fwd_class, self_class, transitions))
        expect("</TopologyEntry>")
        entries.append(states)
        entry_phones.append(phones_here)
    expect("</Topology>")

    phones = sorted(p for plist in entry_phones for p in plist)
    phone2idx = [-1] * (max(phones) + 1 if phones else 1)
    for i, plist in enumerate(entry_phones):
        for p in plist:
            phone2idx[p] = i

    table = tk()
    tuples = []
    if table == "<Tuples>":
        n = int(tk())
        for _ in range(n):
            tuples.append((int(tk()), int(tk()), int(tk()), int(tk())))
        expect("</Tuples>")
    elif table == "<Triples>":
        n = int(tk())
        for _ in range(n):
            phone, hmm_state, pdf = int(tk()), int(tk()), int(tk())
            tuples.append((phone, hmm_state, pdf, pdf))
        expect("</Triples>")
    else:
        raise TransitionModelError("expected <Tuples>/<Triples>, got %r" % table)
    expect("<LogProbs>")
    expect("[")
    probs = []
    while toks[pos] != "]":
        probs.append(float(tk()))
    tk()  # ]
    expect("</LogProbs>")
    expect("</TransitionModel>")
    return TransitionModel(
        phones, phone2idx, entries, tuples, np.asarray(probs, np.float32)
    )


# ----------------------------------------------------------------------
# Writer (fixtures/round-trip tests only)
# ----------------------------------------------------------------------

def write_transition_model(path: str, model: TransitionModel) -> None:
    """Binary writer mirroring Kaldi's layout (for round-trip tests)."""
    with open(path, "wb") as f:
        f.write(b"\x00B")

        def token(t):
            f.write(t.encode() + b" ")

        def wint(v):
            f.write(b"\x04" + struct.pack("<i", v))

        def wfloat(v):
            f.write(b"\x04" + struct.pack("<f", v))

        def wintvec(v):
            f.write(b"\x04" + struct.pack("<i", len(v)))
            f.write(struct.pack("<%di" % len(v), *v))

        token("<TransitionModel>")
        token("<Topology>")
        wintvec(model.phones)
        wintvec(model.phone2idx)
        wint(len(model.entries))
        for states in model.entries:
            wint(len(states))
            for fwd_class, self_class, transitions in states:
                wint(fwd_class)
                wint(self_class)
                wint(len(transitions))
                for dest, prob in transitions:
                    wint(dest)
                    wfloat(prob)
        token("</Topology>")
        token("<Tuples>")
        wint(len(model.tuples))
        for phone, hmm_state, fwd, slf in model.tuples:
            wint(phone)
            wint(hmm_state)
            wint(fwd)
            wint(slf)
        token("</Tuples>")
        token("<LogProbs>")
        token("FV")
        probs = (
            model.log_probs
            if model.log_probs is not None
            else np.zeros(0, np.float32)
        )
        f.write(b"\x04" + struct.pack("<i", len(probs)))
        f.write(np.asarray(probs, "<f4").tobytes())
        token("</LogProbs>")
        token("</TransitionModel>")
