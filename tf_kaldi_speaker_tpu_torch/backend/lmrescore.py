"""Lattice LM rescoring: replace graph LM scores via ARPA composition.

Native equivalent of the reference's scripts/lmrescore_const_arpa.sh
(lattice-lmrescore --lm-scale=-1 <old G> + lattice-lmrescore-const-arpa
--lm-scale=1 <new const arpa>): compose a word-deterministic
CompactLattice with deterministic on-demand ARPA models, adding
``scale * (-ln P(word|hist))`` to the graph costs (negative scale
subtracts the old LM, positive adds the new one), including sentence-end
probabilities at finals. Both passes run in ONE product walk.

The product of a deterministic lattice with deterministic LMs is
deterministic, so the result is still a valid CompactLattice.

Counterpart of ``tf_kaldi_speaker_tpu/backend/lmrescore.py``, whole (numpy
only); ``tests/test_torch_lattice.py`` holds it equal to the original.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .arpa import ArpaLm
from .lattice import CompactArc, CompactLattice


def lmrescore_compact(
    clat: CompactLattice,
    id2word: Dict[int, str],
    new_lm: ArpaLm,
    old_lm: Optional[ArpaLm] = None,
    new_scale: float = 1.0,
    old_scale: float = -1.0,
) -> CompactLattice:
    """Compose ``clat`` with (old_scale·old_lm + new_scale·new_lm).

    ``id2word`` maps lattice word ids to LM strings (words.txt). States of
    the product are (lattice state, old-LM state, new-LM state); epsilon
    word labels pass through without LM transitions (word-deterministic
    lattices from :func:`determinize_lattice` have none, but expanded
    inputs may).
    """
    lms: List[Tuple[ArpaLm, float]] = [(new_lm, new_scale)]
    if old_lm is not None:
        lms.append((old_lm, old_scale))

    out: Dict[int, List[CompactArc]] = {}
    for a in clat.arcs:
        out.setdefault(a.src, []).append(a)

    start_key = (clat.start,) + tuple(lm.start_state() for lm, _ in lms)
    ids: Dict[tuple, int] = {start_key: 0}
    arcs: List[CompactArc] = []
    finals: Dict[int, Tuple[float, float, Tuple[int, ...]]] = {}
    stack = [start_key]
    while stack:
        key = stack.pop()
        sid = ids[key]
        ls, lm_states = key[0], key[1:]
        if ls in clat.finals:
            g, ac, tids = clat.finals[ls]
            for (lm, scale), st in zip(lms, lm_states):
                g += scale * lm.final_cost(st)
            finals[sid] = (g, ac, tids)
        for a in out.get(ls, ()):
            g = a.graph_cost
            if a.word > 0:
                w = id2word.get(a.word)
                if w is None:
                    raise KeyError(
                        "lattice word id %d missing from the symbol table"
                        % a.word)
                next_lm_states = []
                for (lm, scale), st in zip(lms, lm_states):
                    cost, nst = lm.score(st, w)
                    g += scale * cost
                    next_lm_states.append(nst)
                nkey = (a.dst,) + tuple(next_lm_states)
            else:
                nkey = (a.dst,) + lm_states
            nid = ids.get(nkey)
            if nid is None:
                nid = ids[nkey] = len(ids)
                stack.append(nkey)
            arcs.append(CompactArc(sid, nid, a.word, g, a.acoustic_cost,
                                   a.tids))
    return CompactLattice(num_states=len(ids), arcs=arcs, finals=finals,
                          start=0)
