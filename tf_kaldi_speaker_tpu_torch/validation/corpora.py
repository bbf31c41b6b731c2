"""The synthetic corpora of the validation harnesses, written through the
port's ``utils/testdata.make_fake_data_dir`` (byte-equal to the JAX
package's for the same arguments):

- the hard corpus (``scripts/synthetic_validation.py:81-97``): 600 crowded
  speakers in a 12-dim space with per-utterance channel offsets, so that
  the frame-mean oracle EER sits near 16.6% and a subtly wrong loss or
  BatchNorm shows up as a worse EER;
- the convergence corpus (``scripts/reference_convergence.py:46-52,
  :227-302``): 200 speakers x 10 utterances (2 held out per speaker into a
  valid dir), dim 12, and its multitask twin with learnable phone
  alignments. The reference arm's ``tree-info`` stub is left out: only the
  TF reference loader shells out to it.

The size constants are module globals read at call time, so a test can
shrink them."""

from __future__ import annotations

import os
from typing import Dict, Tuple

from ..utils.testdata import make_fake_data_dir

# The hard corpus (scripts/synthetic_validation.py:81-83)
HARD_DIM = 12        # crowded feature space: margin effects need class
HARD_NSPK = 600      # crowding
HARD_CHAN = 0.9      # per-utterance channel offsets -> irreducible EER

# The convergence corpus (scripts/reference_convergence.py:46-52)
DIM = 12
NSPK = 200
UTTS = 10          # per speaker; 2 held out into the valid dir
CHAN = 0.9
TEST_NSPK = 40

# Its multitask twin (scripts/reference_convergence.py:175-176)
MT_NUM_PHONES = 32
MT_PHONE_SIGNAL = 0.5


def make_hard_corpora(root: str) -> Tuple[Dict[str, str], Dict[str, str]]:
    """The hard corpus's train and held-out test dirs under ``root``."""
    train_d = make_fake_data_dir(
        os.path.join(root, "train"), num_speakers=HARD_NSPK,
        utts_per_speaker=8, dim=HARD_DIM, min_len=320, max_len=600, seed=0,
        spk_scale=1.0, chan_scale=HARD_CHAN,
    )
    test_d = make_fake_data_dir(
        os.path.join(root, "test"), num_speakers=40, utts_per_speaker=10,
        dim=HARD_DIM, min_len=320, max_len=600, seed=777, spk_offset=5000,
        spk_scale=1.0, chan_scale=HARD_CHAN,
    )
    return train_d, test_d


def _split_valid(train_dir: str, valid_dir: str, per_spk: int = 2) -> None:
    """Hold out the last ``per_spk`` utts of every speaker into a valid
    data dir (scp-level split; both dirs reference the same ark)."""
    os.makedirs(valid_dir, exist_ok=True)
    utt2spk = {}
    for line in open(os.path.join(train_dir, "utt2spk")):
        u, s = line.split()
        utt2spk[u] = s
    by_spk = {}
    for u in sorted(utt2spk):
        by_spk.setdefault(utt2spk[u], []).append(u)
    heldout = set()
    for s, utts in by_spk.items():
        heldout.update(utts[-per_spk:])

    for fname in ("feats.scp", "utt2spk", "utt2num_frames", "vad.scp"):
        src = os.path.join(train_dir, fname)
        if not os.path.exists(src):
            continue
        keep_t, keep_v = [], []
        for line in open(src):
            (keep_v if line.split()[0] in heldout else keep_t).append(line)
        with open(src, "w") as f:
            f.writelines(keep_t)
        with open(os.path.join(valid_dir, fname), "w") as f:
            f.writelines(keep_v)
    for d in (train_dir, valid_dir):
        u2s = [line.split() for line in open(os.path.join(d, "utt2spk"))]
        s2u = {}
        for u, s in u2s:
            s2u.setdefault(s, []).append(u)
        with open(os.path.join(d, "spk2utt"), "w") as f:
            for s in sorted(s2u):
                f.write("%s %s\n" % (s, " ".join(s2u[s])))


def shuffle_labels(src_dir: str, dst_dir: str, seed: int = 0) -> Dict[str, str]:
    """A copy of data dir ``src_dir`` (its scp lines, the same ark) whose
    utterances carry a random permutation of the speaker labels: as many
    utterances a speaker as before, none of the speaker structure. A run
    trained on it is a control the trained run's quality bound must
    exclude."""
    import numpy as np

    os.makedirs(dst_dir, exist_ok=True)
    pairs = [line.split() for line in open(os.path.join(src_dir, "utt2spk"))]
    spks = [s for _, s in pairs]
    perm = np.random.RandomState(seed).permutation(len(spks))
    utt2spk = {u: spks[i] for (u, _), i in zip(pairs, perm)}
    for fname in ("feats.scp", "utt2num_frames", "spklist", "vad.scp"):
        src = os.path.join(src_dir, fname)
        if os.path.exists(src):
            with open(src) as f, open(os.path.join(dst_dir, fname), "w") as g:
                g.write(f.read())
    with open(os.path.join(dst_dir, "utt2spk"), "w") as f:
        f.writelines("%s %s\n" % (u, utt2spk[u]) for u, _ in pairs)
    s2u: Dict[str, list] = {}
    for u, _ in pairs:
        s2u.setdefault(utt2spk[u], []).append(u)
    with open(os.path.join(dst_dir, "spk2utt"), "w") as f:
        f.writelines("%s %s\n" % (s, " ".join(s2u[s])) for s in sorted(s2u))
    return {"data": dst_dir, "spklist": os.path.join(dst_dir, "spklist")}


def make_data(root: str) -> None:
    """The convergence corpus: ``root/{train,valid,test}``."""
    train_d = make_fake_data_dir(
        os.path.join(root, "train"), num_speakers=NSPK,
        utts_per_speaker=UTTS, dim=DIM, min_len=250, max_len=450, seed=0,
        spk_scale=1.0, chan_scale=CHAN)
    _split_valid(os.path.join(root, "train"), os.path.join(root, "valid"))
    make_fake_data_dir(
        os.path.join(root, "test"), num_speakers=TEST_NSPK,
        utts_per_speaker=10, dim=DIM, min_len=250, max_len=450, seed=777,
        spk_offset=5000, spk_scale=1.0, chan_scale=CHAN)
    print("corpus at", root, "spklist", train_d["spklist"], flush=True)


def make_data_mt(root: str) -> None:
    """The multitask convergence corpus: ``root/{mt_train,mt_valid,mt_test}``
    with VAD and pdf alignments (``mt_train/ali``, ``mt_test/ali``)."""
    train_d = make_fake_data_dir(
        os.path.join(root, "mt_train"), num_speakers=NSPK,
        utts_per_speaker=UTTS, dim=DIM, min_len=250, max_len=450, seed=0,
        spk_scale=1.0, chan_scale=CHAN, with_vad_ali=True,
        num_phones=MT_NUM_PHONES, phone_signal=MT_PHONE_SIGNAL)
    _split_valid(os.path.join(root, "mt_train"), os.path.join(root, "mt_valid"))
    make_fake_data_dir(
        os.path.join(root, "mt_test"), num_speakers=TEST_NSPK,
        utts_per_speaker=10, dim=DIM, min_len=250, max_len=450, seed=777,
        spk_offset=5000, spk_scale=1.0, chan_scale=CHAN, with_vad_ali=True,
        num_phones=MT_NUM_PHONES, phone_signal=MT_PHONE_SIGNAL)
    print("mt corpus at", root, "spklist", train_d["spklist"], flush=True)
