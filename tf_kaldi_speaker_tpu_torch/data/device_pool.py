"""Device-resident compressed-feature pool: sample training chunks on the card.

Counterpart of ``tf_kaldi_speaker_tpu/data/device_pool.py``: every resident
utterance's *compressed* Kaldi codes (1 byte per element) live in one flat
uint8 tensor on the device, staged once, and each train step gathers its
random chunks there (:func:`gather_chunks`) and dequantizes them with the
``cm_dequantize`` kernel. The host ships only (start, utt, label) index
triples, a few KB per group of steps.

Sampling semantics are the JAX pool's: speaker-balanced N x M batches,
random starts inside each utterance, one bucket length per group, the
reference's speaker-resampling rule (data_loader.py:277-288). The planning
and sampling helpers below are copied from the JAX module (lines 92-460)
unchanged, so that a seed gives the JAX pool's index triples
(``tests/test_torch_pool.py``). When the corpus exceeds the budget,
residency rotates through ``rotation_rounds`` windows per coverage cycle,
"utts" (every speaker in every window) or "speakers" (a partition of the
speaker set); see the JAX module's docstring for the measured trade-off.

:class:`ShardedDevicePool` splits the pool over the data ranks of a
multi-card run: every rank computes the same speaker-to-shard map and
stages only its own shard on its card.

Left out: the JAX module's 4 MB staging slices, which work around a
high-latency host link (the card takes one copy per array).
"""

from __future__ import annotations

import logging
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kio.reader import FeatureReader
from .speaker_index import get_speaker_info

log = logging.getLogger("tfks_torch.device_pool")


def _spk_bytes(reader, dim, segs):
    """Pool bytes one speaker's utterances occupy: codes (frames * dim *
    1 B) + percentile headers (4 * dim float32 per utterance). The
    frame-axis sublane padding (<8 rows) is noise."""
    return (
        sum(reader.utt2num_frames[s.split(" ")[0]] for s in segs) * dim
        + len(segs) * 16 * dim
    )


def _seg_frames(reader, seg):
    return reader.utt2num_frames[seg.split(" ")[0]]


def _seg_bytes(reader, dim, seg):
    return _seg_frames(reader, seg) * dim + 16 * dim


def _lpt_assign(weight_of: Dict, shards: int):
    """Deterministic least-loaded (LPT) assignment of keys to shards:
    heaviest first, ties broken by key, each to the least-loaded shard.
    Returns ({key: shard}, per-shard load). The capacity planners and
    ``ShardedDevicePool.stage`` MUST all use this one function — the
    fixed-shape/no-recompile guarantee depends on planned and staged
    assignments staying in lockstep (same order, same tie-break)."""
    load = [0] * shards
    out = {}
    for k in sorted(weight_of, key=lambda k: (-weight_of[k], k)):
        d = int(np.argmin(load))
        out[k] = d
        load[d] += weight_of[k]
    return out, load


def _plan_cycle_utts(spk2features, R, seed, cycle, len_of=None,
                     need_gt=None):
    """Partition UTTERANCES into R windows with every speaker present in
    every window: each speaker's (seeded, per-cycle) shuffled utterance
    list is dealt round-robin across the windows from a random offset, so
    a cycle's R windows cover each speaker's utterances exactly once when
    the speaker has >= R of them. Speakers with fewer repeat utterances
    across windows (at-least-once coverage) so they never drop out of the
    per-step sampling distribution. With ``need_gt`` (the longest chunk
    length training will request) and ``len_of``, every window of every
    speaker that HAS an utterance longer than ``need_gt`` keeps one
    resident (the longest is duplicated into windows the deal left
    without one) — so the reference's speaker-resampling rule fires in a
    rotation window exactly when it would fire fully resident, and
    ``sample_group`` can never hit the no-long-utterance error in a
    window when the corpus itself has long utterances. Returns R lists
    of (spk, seg)."""
    wins: List[List[Tuple[int, str]]] = [[] for _ in range(R)]
    for spk in sorted(spk2features):
        segs = list(spk2features[spk])
        rng = random.Random(seed + 104729 * cycle + 7919 * (spk + 1))
        rng.shuffle(segs)
        off = rng.randrange(R)
        n = len(segs)
        spk_wins: List[List[str]] = [[] for _ in range(R)]
        if n >= R:
            for i, seg in enumerate(segs):
                spk_wins[(off + i) % R].append(seg)
        else:
            for w in range(R):
                spk_wins[w].append(segs[(off + w) % n])
        if need_gt is not None and len_of is not None:
            long = [s for s in segs if len_of(s) > need_gt]
            if long:
                longest = max(long, key=len_of)
                for w in range(R):
                    if not any(len_of(s) > need_gt for s in spk_wins[w]):
                        spk_wins[w].append(longest)
        for w in range(R):
            wins[w].extend((spk, s) for s in spk_wins[w])
    return wins


def _plan_rotation_utts(reader, spk2features, dim, budget_bytes, seed,
                        chunk_frames=None):
    """(R, total_bytes) for utterance-unit rotation: start from the byte
    quotient and raise R until cycle 0's largest window fits the budget.
    Few-utterance speakers put a floor under the window size (each window
    must hold >= 1 utterance of every speaker); if the budget sits below
    that floor, stage over budget with a warning rather than crash."""
    total = sum(
        _spk_bytes(reader, dim, segs) for segs in spk2features.values()
    )
    if budget_bytes is None or total <= budget_bytes:
        return 1, total
    R = int(-(-total // max(1, budget_bytes)))
    cap = 4 * R + 8
    while True:
        wins = _plan_cycle_utts(
            spk2features, R, seed, 0,
            len_of=lambda s: _seg_frames(reader, s), need_gt=chunk_frames)
        worst = max(
            sum(_seg_bytes(reader, dim, seg) for _, seg in w) for w in wins
        )
        if worst <= budget_bytes:
            return R, total
        if R >= cap:
            log.warning(
                "utterance-rotation windows cannot fit the %.1f MB budget "
                "even at R=%d (one-utterance-per-speaker floor is %.1f MB); "
                "staging over budget",
                budget_bytes / 1e6, R, worst / 1e6,
            )
            return R, total
        R += 1


def _plan_capacity_utts(reader, spk2features, dim, R, seed, shards=1,
                        chunk_frames=None):
    """Fixed staging capacity (cap_frames, cap_utts) for utterance-unit
    rotation windows, from the first three cycles' partitions plus one
    max-utterance of headroom (the round-robin deal keeps windows within
    a few utterances of balanced across cycles; rare exceedance falls
    back to the grow-only recompile path). ``shards`` > 1 mirrors
    ShardedDevicePool's per-window LPT speaker->shard balancing."""
    max_f = max_n = 0
    for cycle in range(3):
        for win in _plan_cycle_utts(
                spk2features, R, seed, cycle,
                len_of=lambda s: _seg_frames(reader, s),
                need_gt=chunk_frames):
            if shards == 1:
                f = sum(_seg_frames(reader, seg) for _, seg in win)
                n = len(win)
            else:
                spk_w: Dict[int, List[str]] = {}
                for spk, seg in win:
                    spk_w.setdefault(spk, []).append(seg)
                frames_of = {
                    s: sum(_seg_frames(reader, g) for g in segs)
                    for s, segs in spk_w.items()
                }
                assign, load = _lpt_assign(frames_of, shards)
                count = [0] * shards
                for s, d in assign.items():
                    count[d] += len(spk_w[s])
                f, n = max(load), max(count)
            max_f, max_n = max(max_f, f), max(max_n, n)
    head_f = max(
        _seg_frames(reader, s)
        for segs in spk2features.values()
        for s in segs
    )
    return -(-(max_f + head_f) // 8) * 8, max_n + 2


def _select_resident_items_utts(reader, spk2features, dim, budget_bytes,
                                seed, round_id, R, chunk_frames=None):
    """Utterance-unit residency for one round: window ``round_id % R`` of
    cycle ``round_id // R``'s utterance deal (see :func:`_plan_cycle_utts`).
    R is the pool's precomputed rotation_rounds (avoids re-running the
    budget-fit search every stage)."""
    if R == 1:
        total = sum(
            _spk_bytes(reader, dim, segs) for segs in spk2features.values()
        )
        if budget_bytes is not None and total > budget_bytes:
            log.warning(
                "device pool: staging the whole %.0f MB corpus over the "
                "%.0f MB budget", total / 1e6, budget_bytes / 1e6,
            )
        return [
            (spk, seg) for spk, segs in spk2features.items() for seg in segs
        ], True
    cycle, window = divmod(round_id, R)
    win = _plan_cycle_utts(
        spk2features, R, seed, cycle,
        len_of=lambda s: _seg_frames(reader, s), need_gt=chunk_frames,
    )[window]
    used = sum(_seg_bytes(reader, dim, seg) for _, seg in win)
    log.info(
        "device pool: resident %d utts of all %d speakers (utterance "
        "window %d/%d of cycle %d, %.0f MB)",
        len(win), len(spk2features), window, R, cycle, used / 1e6,
    )
    return list(win), False


def _effective_rounds(reader, spk2features, dim, budget_bytes, seed=0,
                      min_speakers=1):
    """(R, total_bytes): rotation windows needed to cover the corpus under
    the byte budget, capped so every window can still hold ``min_speakers``
    (the sharded pool's shard count). Starts from the byte quotient and
    raises R until cycle 0's largest window actually fits — the greedy
    balancer leaves the max window above total/R, so the quotient alone
    routinely plans windows over budget. R == 1 means no rotation; when
    the speaker floor caps R below a fit, windows stage over budget (the
    selection path warns)."""
    total = sum(
        _spk_bytes(reader, dim, segs) for segs in spk2features.values()
    )
    if budget_bytes is None or total <= budget_bytes:
        return 1, total
    r_max = max(1, len(spk2features) // max(1, min_speakers))
    R = min(r_max, int(-(-total // max(1, budget_bytes))))
    while 1 < R < r_max:
        bins = _plan_cycle(
            reader, spk2features, dim, R, seed, 0, min_speakers)
        worst = max(
            sum(_spk_bytes(reader, dim, spk2features[s]) for s in b)
            for b in bins
        )
        if worst <= budget_bytes:
            break
        R += 1
    return R, total


def _plan_cycle(reader, spk2features, dim, R, seed, cycle, min_speakers):
    """Partition ALL speakers into R byte-balanced windows for one rotation
    cycle (seeded per-cycle shuffle + least-loaded greedy), so R consecutive
    rounds cover every speaker exactly once. A post-pass moves speakers
    from the fullest windows until each holds >= ``min_speakers``."""
    order = list(spk2features.keys())
    random.Random(seed + 104729 * cycle).shuffle(order)
    bins: List[List[int]] = [[] for _ in range(R)]
    load = [0] * R
    for spk in order:
        d = int(np.argmin(load))
        bins[d].append(spk)
        load[d] += _spk_bytes(reader, dim, spk2features[spk])
    for b in bins:
        while len(b) < min_speakers:
            donor = max(
                (x for x in bins if x is not b), key=len, default=None
            )
            if donor is None or len(donor) <= min_speakers:
                raise ValueError(
                    "cannot hold %d speakers in each of %d rotation "
                    "windows with %d speakers total"
                    % (min_speakers, R, len(order)))
            b.append(donor.pop())
    return bins


def _spk_frames(reader, spk2features, spk):
    return sum(
        reader.utt2num_frames[s.split(" ")[0]] for s in spk2features[spk]
    )


def _plan_capacity(reader, spk2features, dim, R, seed, min_speakers=1,
                   shards=1):
    """Fixed staging capacity (cap_frames, cap_utts) across rotation
    windows: the max over cycle 0's R windows plus one max-speaker
    headroom (greedy least-loaded keeps every cycle's windows within one
    speaker of balanced, so later cycles almost never exceed it). A fixed
    capacity means the pool arrays keep ONE shape across windows, so the
    scanned train step compiles once per bucket length instead of once
    per (bucket, window) — restaging cost drops from a ~100 s recompile
    to the window's H2D copy. ``shards`` > 1 sizes the PER-SHARD block of
    ShardedDevicePool (mirrors its LPT speaker->shard balancing)."""
    bins = _plan_cycle(reader, spk2features, dim, R, seed, 0, min_speakers)
    frames_of = {s: _spk_frames(reader, spk2features, s)
                 for s in spk2features}
    max_f = max_n = 0
    for b in bins:
        if shards == 1:
            f = sum(frames_of[s] for s in b)
            n = sum(len(spk2features[s]) for s in b)
        else:
            assign, load = _lpt_assign(
                {s: frames_of[s] for s in b}, shards)
            count = [0] * shards
            for s, d in assign.items():
                count[d] += len(spk2features[s])
            f, n = max(load), max(count)
        max_f, max_n = max(max_f, f), max(max_n, n)
    head_f = max(frames_of.values())
    head_n = max(len(v) for v in spk2features.values())
    return -(-(max_f + head_f) // 8) * 8, max_n + head_n


def _select_resident_items(reader, spk2features, dim, budget_bytes, seed,
                           round_id, min_speakers=1):
    """(speaker, segment) resident list for one residency round, plus a
    full_resident flag. Shared by DevicePool and ShardedDevicePool: when
    the corpus exceeds the budget, ``round_id`` selects window
    ``round_id % R`` of the cycle-``round_id // R`` partition, so R
    consecutive rounds cover every speaker exactly once (see
    :func:`_plan_cycle`). If the ``min_speakers`` floor (the sharded
    pool's shard count) caps R at 1, the whole corpus is staged over
    budget rather than crashing a later rotation round."""
    R, total = _effective_rounds(
        reader, spk2features, dim, budget_bytes, seed,
        min_speakers=min_speakers)
    if R == 1:
        if budget_bytes is not None and total > budget_bytes:
            log.warning(
                "device pool: %d-speaker floor forces staging the whole "
                "%.0f MB corpus over the %.0f MB budget",
                min_speakers, total / 1e6, budget_bytes / 1e6,
            )
        return [
            (spk, seg) for spk, segs in spk2features.items() for seg in segs
        ], True
    cycle, window = divmod(round_id, R)
    bins = _plan_cycle(
        reader, spk2features, dim, R, seed, cycle, min_speakers)
    chosen_spk = bins[window]
    used = sum(
        _spk_bytes(reader, dim, spk2features[s]) for s in chosen_spk)
    if budget_bytes is not None and used > budget_bytes:
        log.warning(
            "device pool: speaker window %d stages %.0f MB over the "
            "%.0f MB budget (the %d-speaker floor caps rotation at R=%d; "
            "raise the budget or use rotation_unit='utts')",
            window, used / 1e6, budget_bytes / 1e6, min_speakers, R,
        )
    log.info(
        "device pool: resident %d/%d speakers (window %d/%d of cycle %d, "
        "%.0f MB of %.0f MB corpus)",
        len(chosen_spk), len(spk2features), window, R, cycle,
        used / 1e6, total / 1e6,
    )
    return [
        (spk, seg) for spk in chosen_spk for seg in spk2features[spk]
    ], False


def _resolve_speaker(rng, spk2utts, utt_len_of, spk, batch_speakers, i,
                     batch_length):
    """Pick utterances of ``spk`` longer than ``batch_length``, resampling
    the speaker when it has none (the reference's resampling rule,
    data_loader.py:277-288). Terminates: already-tried speakers are
    excluded, and an explicit error replaces the previous silent infinite
    loop / IndexError when NO resident speaker has a long-enough utterance."""
    tried = set()
    while True:
        cand = [u for u in spk2utts[spk] if utt_len_of(u) > batch_length]
        if cand:
            batch_speakers[i] = spk
            return spk, cand
        tried.add(spk)
        pool = [
            s for s in spk2utts
            if s not in tried and s not in batch_speakers
        ]
        if not pool:
            raise ValueError(
                "no resident speaker has an utterance longer than %d "
                "frames; lower max_segment_len or raise the pool budget"
                % batch_length
            )
        spk = rng.choice(pool)


def _draw_speaker_rows(rng, spk2utts, utt_len_of, utt_offset_of,
                       batch_speakers, i, num_segments, batch_length):
    """One speaker's rows of a batch: resolve the speaker (resampling rule),
    then draw ``num_segments`` (utt, start) pairs with random chunk starts
    inside each utterance. Shared by DevicePool and ShardedDevicePool so the
    sampling distribution cannot diverge between the replicated and sharded
    paths. Returns (spk, [(utt, start), ...])."""
    spk, cand = _resolve_speaker(
        rng, spk2utts, utt_len_of, batch_speakers[i], batch_speakers, i,
        batch_length,
    )
    if len(cand) < num_segments:
        cand = cand * (num_segments // len(cand) + 1)
    rows = [
        (u, utt_offset_of(u) + rng.randint(0, utt_len_of(u) - batch_length))
        for u in rng.sample(cand, num_segments)
    ]
    return spk, rows


class DevicePool:
    """Device pool of compressed utterance codes + host-side index sampler.

    Args:
        data_dir: Kaldi data dir with compressed ('CM ') feature arks.
        spklist: speaker->index file (same contract as the samplers).
        budget_bytes: cap on the frames-buffer size; residency rotates
            through coverage windows when the corpus exceeds it.
        device: where the pool tensors live (``cuda`` for training).
        seed: base seed for residency selection and sampling.
        rotation_unit: "utts" (default) or "speakers" (see module doc).
        chunk_frames: the longest chunk length training will request
            (max_segment_len); with utterance-unit rotation every window
            keeps one longer-than-this utterance per speaker that has one.
    """

    def __init__(
        self,
        data_dir: str,
        spklist: str,
        budget_bytes: Optional[int] = None,
        device="cuda",
        seed: int = 0,
        rotation_unit: str = "utts",
        chunk_frames: Optional[int] = None,
    ):
        if rotation_unit not in ("utts", "speakers"):
            raise ValueError("rotation_unit must be 'utts' or 'speakers'")
        self.data_dir = data_dir
        self.budget_bytes = budget_bytes
        self.device = torch.device(device)
        self.seed = seed
        self.rotation_unit = rotation_unit
        self.chunk_frames = chunk_frames
        spk2features, _, _ = get_speaker_info(data_dir, spklist)
        self.spk2features = spk2features
        self.reader = FeatureReader(data_dir)
        self.dim = self.reader.dim
        # Windows per rotation cycle (1 = the whole corpus fits); all
        # windows stage into tensors of one planned capacity.
        if rotation_unit == "utts":
            self.rotation_rounds, _ = _plan_rotation_utts(
                self.reader, spk2features, self.dim, budget_bytes, seed,
                chunk_frames=chunk_frames)
        else:
            self.rotation_rounds, _ = _effective_rounds(
                self.reader, spk2features, self.dim, budget_bytes, seed)
        self._cap_f = self._cap_n = 0
        if self.rotation_rounds > 1:
            if rotation_unit == "utts":
                self._cap_f, self._cap_n = _plan_capacity_utts(
                    self.reader, spk2features, self.dim,
                    self.rotation_rounds, seed, chunk_frames=chunk_frames)
            else:
                self._cap_f, self._cap_n = _plan_capacity(
                    self.reader, spk2features, self.dim,
                    self.rotation_rounds, seed)

        # Device tensors (set by stage()):
        self.frames: Optional[torch.Tensor] = None   # [F, D] uint8 codes
        self.headers: Optional[torch.Tensor] = None  # [N, 4, D] float32 headers
        # Host-side index (resident subset):
        self.utt_offset: Optional[np.ndarray] = None  # [N] int32
        self.utt_len: Optional[np.ndarray] = None     # [N] int32
        self.spk2utts: Dict[int, List[int]] = {}
        self.resident_round = -1
        self.full_resident = False

    def _select_resident(self, round_id: int) -> List[Tuple[int, str]]:
        """(speaker, segment) list for this residency round."""
        if self.rotation_unit == "utts":
            items, full = _select_resident_items_utts(
                self.reader, self.spk2features, self.dim, self.budget_bytes,
                self.seed, round_id, self.rotation_rounds,
                chunk_frames=self.chunk_frames,
            )
        else:
            items, full = _select_resident_items(
                self.reader, self.spk2features, self.dim, self.budget_bytes,
                self.seed, round_id,
            )
        if full:
            self.full_resident = True
        return items

    def stage(self, round_id: int = 0) -> None:
        """(Re)load the resident utterance set onto the device."""
        if self.resident_round == round_id or (
            self.full_resident and self.frames is not None
        ):
            return
        items = self._select_resident(round_id)
        n = len(items)
        lens = np.array(
            [self.reader.utt2num_frames[s.split(" ")[0]] for _, s in items],
            np.int32,
        )
        total_frames = int(np.sum(lens, dtype=np.int64))
        if total_frames >= 2**31:
            raise ValueError(
                "pool of %d frames exceeds the int32 index space; set a "
                "pool budget" % total_frames)
        offsets = np.zeros((n,), np.int32)
        offsets[1:] = np.cumsum(lens, dtype=np.int64)[:-1]
        f_pad = -(-total_frames // 8) * 8
        # Rotation windows share one planned capacity (grow-only).
        if self.rotation_rounds > 1:
            if f_pad > self._cap_f or n > self._cap_n:
                log.warning(
                    "rotation window (%d frames, %d utts) exceeds planned "
                    "capacity (%d, %d); growing",
                    f_pad, n, self._cap_f, self._cap_n,
                )
                self._cap_f = max(self._cap_f, f_pad)
                self._cap_n = max(self._cap_n, n)
            cap_f, cap_n = self._cap_f, self._cap_n
        else:
            cap_f, cap_n = f_pad, n

        host_frames = np.zeros((cap_f, self.dim), np.uint8)
        host_headers = np.zeros((cap_n, 4, self.dim), np.float32)
        self.spk2utts = {}
        for i, (spk, seg) in enumerate(items):
            codes, headers, _ = self.reader.read_segment_codes(seg)
            host_frames[offsets[i] : offsets[i] + lens[i]] = codes
            host_headers[i] = headers
            self.spk2utts.setdefault(spk, []).append(i)

        # Free the previous round's tensors before allocating the new ones:
        # rotation sizes the pool near free device memory.
        self.frames = self.headers = None
        self.frames = torch.from_numpy(host_frames).to(self.device)
        self.headers = torch.from_numpy(host_headers).to(self.device)
        self.utt_offset = offsets
        self.utt_len = lens
        self.resident_round = round_id
        log.info(
            "device pool staged: %d utts, %.1f MB codes, %d speakers",
            n, host_frames.nbytes / 1e6, len(self.spk2utts),
        )

    def sample_group(
        self,
        rng: random.Random,
        group: int,
        num_speakers: int,
        num_segments: int,
        batch_length: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(starts [K,B] absolute frame index, utts [K,B], labels [K,B]).

        Speaker-balanced sampling with the reference's resampling rule;
        chunks never cross utterance boundaries (start <= n - L inside the
        utterance's own frame block)."""
        B = num_speakers * num_segments
        starts = np.zeros((group, B), np.int32)
        utts = np.zeros((group, B), np.int32)
        labels = np.zeros((group, B), np.int32)
        speakers = list(self.spk2utts.keys())
        if len(speakers) < num_speakers:
            speakers = speakers * (num_speakers // len(speakers) + 1)
        for k in range(group):
            batch_speakers = rng.sample(speakers, num_speakers)
            for i in range(num_speakers):
                spk, rows = _draw_speaker_rows(
                    rng, self.spk2utts,
                    lambda u: int(self.utt_len[u]),
                    lambda u: int(self.utt_offset[u]),
                    batch_speakers, i, num_segments, batch_length,
                )
                labels[k, i * num_segments : (i + 1) * num_segments] = spk
                for j, (u, s) in enumerate(rows):
                    utts[k, i * num_segments + j] = u
                    starts[k, i * num_segments + j] = s
        return starts, utts, labels

    def close(self) -> None:
        self.reader.close()
        self.frames = None
        self.headers = None
        # A later stage() must rebuild rather than no-op on a closed pool.
        self.resident_round = -1
        self.full_resident = False


class ShardedDevicePool:
    """The corpus pool split over ``num_shards`` data ranks (JAX
    ``ShardedDevicePool``, ``device_pool.py:693-958``): shard d holds its
    own speakers, so the pool's capacity grows with the card count and
    every gather stays on the rank's card.

    Every rank computes the same speaker-to-shard assignment (``_lpt_assign``
    over the shared data dir, frames-balanced) and the same planned
    per-shard capacity, reads and stages only shard ``shard`` (its data
    rank) onto ``device``, and :meth:`sample_group` yields that shard's
    ``[K, B_local]`` rows, drawn from its resident speakers with
    shard-local starts and utterance rows: the counterpart of one JAX
    process holding one device of the data axis. One shard of one is the
    JAX pool on a one-device mesh."""

    def __init__(
        self,
        data_dir: str,
        spklist: str,
        num_shards: int = 1,
        shard: int = 0,
        budget_bytes: Optional[int] = None,
        seed: int = 0,
        rotation_unit: str = "utts",
        chunk_frames: Optional[int] = None,
        device="cuda",
    ):
        if rotation_unit not in ("utts", "speakers"):
            raise ValueError("rotation_unit must be 'utts' or 'speakers'")
        if not 0 <= shard < num_shards:
            raise ValueError("shard %d of %d" % (shard, num_shards))
        self.rotation_unit = rotation_unit
        self.chunk_frames = chunk_frames
        self.data_dir = data_dir
        self.num_shards = int(num_shards)
        self.shard = int(shard)
        self.device = torch.device(device)
        self.budget_bytes = budget_bytes
        self.seed = seed
        spk2features, _, _ = get_speaker_info(data_dir, spklist)
        self.spk2features = spk2features
        self.reader = FeatureReader(data_dir)
        self.dim = self.reader.dim
        if rotation_unit == "utts":
            self.rotation_rounds, _ = _plan_rotation_utts(
                self.reader, spk2features, self.dim, budget_bytes, seed,
                chunk_frames=chunk_frames)
        else:
            self.rotation_rounds, _ = _effective_rounds(
                self.reader, spk2features, self.dim, budget_bytes, seed,
                min_speakers=self.num_shards)
        # one planned per-shard capacity for every rotation window
        self._cap_f = self._cap_n = 0
        if self.rotation_rounds > 1:
            if rotation_unit == "utts":
                self._cap_f, self._cap_n = _plan_capacity_utts(
                    self.reader, spk2features, self.dim, self.rotation_rounds, seed,
                    shards=self.num_shards, chunk_frames=chunk_frames)
            else:
                self._cap_f, self._cap_n = _plan_capacity(
                    self.reader, spk2features, self.dim, self.rotation_rounds, seed,
                    min_speakers=self.num_shards, shards=self.num_shards)
        self.frames: Optional[torch.Tensor] = None   # [cap_f, D] this shard's codes
        self.headers: Optional[torch.Tensor] = None  # [cap_n, 4, D]
        # this shard's host index: utterance rows and frame offsets are local
        self.spk2utts: Dict[int, List[int]] = {}
        self.utt_len = np.zeros(0, np.int32)
        self.utt_offset = np.zeros(0, np.int32)
        self.cap_f = self.cap_n = 0
        self.resident_round = -1
        self.full_resident = False

    def _select_resident(self, round_id: int) -> List[Tuple[int, str]]:
        if self.rotation_unit == "utts":
            items, full = _select_resident_items_utts(
                self.reader, self.spk2features, self.dim, self.budget_bytes,
                self.seed, round_id, self.rotation_rounds, chunk_frames=self.chunk_frames)
        else:
            items, full = _select_resident_items(
                self.reader, self.spk2features, self.dim, self.budget_bytes,
                self.seed, round_id, min_speakers=self.num_shards)
        if full:
            self.full_resident = True
        return items

    def stage(self, round_id: int = 0) -> None:
        """(Re)load this shard's resident utterances onto the device."""
        if self.resident_round == round_id or (self.full_resident and self.frames is not None):
            return
        items = self._select_resident(round_id)
        spk_items: Dict[int, List[str]] = {}
        for spk, seg in items:
            spk_items.setdefault(spk, []).append(seg)
        spk_frames = {spk: sum(self.reader.utt2num_frames[s.split(" ")[0]] for s in segs)
                      for spk, segs in spk_items.items()}
        S = self.num_shards
        if len(spk_items) < S:
            raise ValueError("sharded pool needs >= %d resident speakers (got %d)"
                             % (S, len(spk_items)))
        shard_of, load = _lpt_assign(spk_frames, S)
        cap_f = -(-max(load) // 8) * 8
        cap_n = max(sum(len(spk_items[s]) for s in spk_items if shard_of[s] == d)
                    for d in range(S))
        # rotation windows share the planned capacity (grow-only)
        if self.rotation_rounds > 1:
            if cap_f > self._cap_f or cap_n > self._cap_n:
                log.warning("rotation window (%d frames, %d utts per shard) exceeds planned "
                            "capacity (%d, %d); growing", cap_f, cap_n, self._cap_f, self._cap_n)
                self._cap_f = max(self._cap_f, cap_f)
                self._cap_n = max(self._cap_n, cap_n)
            cap_f, cap_n = self._cap_f, self._cap_n
        if cap_f >= 2**31:
            raise ValueError("per-shard pool of %d frames exceeds the int32 index space; set "
                             "a pool budget" % cap_f)
        host_frames = np.zeros((cap_f, self.dim), np.uint8)
        host_headers = np.zeros((cap_n, 4, self.dim), np.float32)
        self.spk2utts = {}
        self.utt_len = np.zeros(cap_n, np.int32)
        self.utt_offset = np.zeros(cap_n, np.int32)
        fill_f = fill_n = 0
        for spk in sorted(spk_items):
            if shard_of[spk] != self.shard:
                continue
            for seg in spk_items[spk]:
                codes, headers, _ = self.reader.read_segment_codes(seg)
                n = codes.shape[0]
                host_frames[fill_f:fill_f + n] = codes
                host_headers[fill_n] = headers
                self.utt_len[fill_n] = n
                self.utt_offset[fill_n] = fill_f
                self.spk2utts.setdefault(spk, []).append(fill_n)
                fill_f += n
                fill_n += 1
        self.cap_f, self.cap_n = cap_f, cap_n
        self.frames = self.headers = None
        self.frames = torch.from_numpy(host_frames).to(self.device)
        self.headers = torch.from_numpy(host_headers).to(self.device)
        self.resident_round = round_id
        log.info("sharded device pool staged: shard %d of %d, %d frames cap (%.1f MB), "
                 "%d of %d speakers", self.shard, S, cap_f, cap_f * self.dim / 1e6,
                 len(self.spk2utts), len(spk_items))

    def sample_group(
        self,
        rng: random.Random,
        group: int,
        num_speakers: int,
        num_segments: int,
        batch_length: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(starts, utts, labels) [K, B_local]: this shard's rows of the
        global batch (``num_speakers / num_shards`` speakers each), starts
        and utterance rows local to the shard's tensors."""
        S = self.num_shards
        if num_speakers % S:
            raise ValueError("num_speakers_per_batch=%d must divide the %d-way data axis"
                             % (num_speakers, S))
        per = num_speakers // S
        B_local = per * num_segments
        starts = np.zeros((group, B_local), np.int32)
        utts = np.zeros((group, B_local), np.int32)
        labels = np.zeros((group, B_local), np.int32)
        speakers = list(self.spk2utts.keys())
        if len(speakers) < per:
            speakers = speakers * (per // len(speakers) + 1)
        for k in range(group):
            batch_speakers = rng.sample(speakers, per)
            for i in range(per):
                try:
                    spk, rows = _draw_speaker_rows(
                        rng, self.spk2utts, lambda u: int(self.utt_len[u]),
                        lambda u: int(self.utt_offset[u]),
                        batch_speakers, i, num_segments, batch_length)
                except ValueError as e:
                    raise ValueError("shard %d: %s" % (self.shard, e)) from None
                r0 = i * num_segments
                labels[k, r0:r0 + num_segments] = spk
                for j, (u, st) in enumerate(rows):
                    utts[k, r0 + j] = u
                    starts[k, r0 + j] = st
        return starts, utts, labels

    def close(self) -> None:
        self.reader.close()
        self.frames = None
        self.headers = None
        self.resident_round = -1
        self.full_resident = False


def gather_chunks(pool_frames: torch.Tensor, pool_headers: torch.Tensor,
                  starts: torch.Tensor, utts: torch.Tensor, chunk_len: int):
    """On-device chunk fetch: codes [B, L, D] uint8 + headers [B, 4, D].

    ``starts`` [B] are absolute frame indices into the pool and ``utts``
    [B] its utterance rows, both on the pool's device; every chunk lies
    inside its utterance, as :meth:`DevicePool.sample_group` draws it."""
    rows = starts.long()[:, None] + torch.arange(chunk_len, device=starts.device)
    return pool_frames[rows], pool_headers[utts.long()]
