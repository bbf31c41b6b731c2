"""ARPA n-gram language model: reader + deterministic on-demand scoring.

Native replacement for the const-arpa rescoring chain
(the reference's scripts/lmrescore_const_arpa.sh:1-70: lattice-lmrescore
--lm-scale=-1 with the old G + lattice-lmrescore-const-arpa with the new
ARPA): :class:`ArpaLm` reads the standard ARPA text format (any order,
log10 probs + backoffs) and exposes Kaldi-ConstArpaLm-style deterministic
scoring — ``score(history, word)`` always resolves via backoff, and LM
states are the longest n-gram context suffixes, so composing a
word-deterministic CompactLattice with the model stays deterministic.

Costs are NEGATED NATURAL logs (lattice graph-cost convention); the ARPA
file's log10 values are converted once at load.

Counterpart of ``tf_kaldi_speaker_tpu/backend/arpa.py``, whole (numpy
only); ``tests/test_torch_lattice.py`` holds it equal to the original.
"""

from __future__ import annotations

import gzip
import logging
import math
from typing import Dict, Optional, Tuple

log = logging.getLogger("tfks.arpa")

LN10 = math.log(10.0)
# ARPA convention: -99 (log10) marks an impossible event (e.g. p(<s>)).
IMPOSSIBLE_LOG10 = -98.0


class ArpaLm:
    """In-memory ARPA model with backoff scoring.

    ``ngrams``: tuple(words) -> (logprob_ln, backoff_ln); words are the
    file's strings. ``contexts``: the live LM states for truncation — every
    tuple that extends to a higher-order n-gram PLUS every non-top-order
    n-gram with a nonzero backoff weight (pruned ARPA files keep such
    histories without continuations; ConstArpaLm semantics).
    """

    def __init__(self) -> None:
        self.order = 0
        self.ngrams: Dict[Tuple[str, ...], Tuple[float, float]] = {}
        self.contexts: set = set()
        self.unk: Optional[str] = None

    # ------------------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "ArpaLm":
        lm = cls()
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as fd:
            section = None
            counts = {}
            for raw in fd:
                line = raw.strip()
                if not line:
                    continue
                if line == "\\data\\":
                    section = "data"
                    continue
                if line.startswith("\\") and line.endswith("-grams:"):
                    section = int(line[1:-7])
                    lm.order = max(lm.order, section)
                    continue
                if line == "\\end\\":
                    break
                if section == "data":
                    if line.startswith("ngram"):
                        n, c = line.split()[1].split("=")
                        counts[int(n)] = int(c)
                    continue
                if isinstance(section, int):
                    parts = line.split()
                    n = section
                    logp = float(parts[0]) * LN10
                    words = tuple(parts[1 : 1 + n])
                    backoff = (
                        float(parts[1 + n]) * LN10
                        if len(parts) > 1 + n else 0.0
                    )
                    lm.ngrams[words] = (logp, backoff)
        for words, (_, backoff) in lm.ngrams.items():
            # A history is a live LM state if it extends to a higher-order
            # n-gram OR carries a nonzero backoff weight: pruned ARPA files
            # (SRILM/KenLM) routinely keep 'b c' with a backoff but no
            # 'b c *' continuations, and dropping that state would lose the
            # backoff penalty (Kaldi ConstArpaLm keeps such states too).
            for i in range(1, len(words)):
                lm.contexts.add(words[:i])
            if backoff != 0.0 and len(words) < lm.order:
                lm.contexts.add(words)
        if ("<unk>",) in lm.ngrams:
            lm.unk = "<unk>"
        elif ("<UNK>",) in lm.ngrams:
            lm.unk = "<UNK>"
        log.info("ARPA: order %d, %d n-grams%s", lm.order, len(lm.ngrams),
                 ", has <unk>" if lm.unk else "")
        return lm

    # ------------------------------------------------------------------
    def _truncate(self, hist: Tuple[str, ...]) -> Tuple[str, ...]:
        """Longest suffix of ``hist`` that is a context of some n-gram and
        fits the model order — the deterministic LM state."""
        hist = hist[-(self.order - 1):] if self.order > 1 else ()
        while hist and hist not in self.contexts:
            hist = hist[1:]
        return hist

    def start_state(self) -> Tuple[str, ...]:
        return self._truncate(("<s>",))

    def logp(self, hist: Tuple[str, ...], word: str) -> float:
        """ln P(word | hist) with standard backoff; OOV falls back to
        <unk> when present, else a -20 log10 floor (warned once)."""
        if (word,) not in self.ngrams:
            if self.unk is not None:
                word = self.unk
            else:
                if not getattr(self, "_warned_oov", False):
                    log.warning("OOV word %r (no <unk>); flooring", word)
                    self._warned_oov = True
                return -20.0 * LN10
        backoff_sum = 0.0
        while True:
            ng = hist + (word,)
            hit = self.ngrams.get(ng)
            if hit is not None and hit[0] > IMPOSSIBLE_LOG10 * LN10:
                return backoff_sum + hit[0]
            if not hist:
                # unigram miss can only be the impossible -99 marker
                return backoff_sum + (hit[0] if hit else -20.0 * LN10)
            bo = self.ngrams.get(hist)
            backoff_sum += bo[1] if bo is not None else 0.0
            hist = hist[1:]

    def score(self, state: Tuple[str, ...], word: str) -> Tuple[float, Tuple[str, ...]]:
        """(cost, next_state): cost = -ln P(word|state); next state is the
        truncated extended history (deterministic on-demand FST view)."""
        lp = self.logp(state, word)
        return -lp, self._truncate(state + (word,))

    def final_cost(self, state: Tuple[str, ...]) -> float:
        """-ln P(</s> | state) (sentence-end probability, as Kaldi's G.fst
        final weights / ConstArpaLmDeterministicFst finals)."""
        return -self.logp(state, "</s>")

    def sentence_cost(self, words) -> float:
        """-ln P(w1..wn </s> | <s>) — whole-sequence cost (test oracle +
        perplexity tooling)."""
        state = self.start_state()
        total = 0.0
        for w in words:
            c, state = self.score(state, w)
            total += c
        return total + self.final_cost(state)
