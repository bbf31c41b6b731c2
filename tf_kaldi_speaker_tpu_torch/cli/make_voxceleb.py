"""Build Kaldi data dirs from a distributed VoxCeleb corpus tree.

Counterpart of ``tf_kaldi_speaker_tpu/cli/make_voxceleb.py``, copied as it is
(the port imports nothing of the JAX package).

The reference recipe's stage 0 shells out to Kaldi's
``local/make_voxceleb1.pl`` / ``local/make_voxceleb2.pl`` list builders
(the reference's egs/voxceleb/v1/run.sh:45-50 — the perl scripts
themselves are symlinked from an installed Kaldi egs tree at stage -1 and
are not part of the reference). This native equivalent walks the
published corpus layouts and writes ``wav.scp / utt2spk / spk2utt``:

- **voxceleb1**: ``$root/wav/idXXXXX/<video>/<clip>.wav`` (the
  consolidated post-2019 layout) or ``$root/{dev,test}/wav/...`` (the
  original split downloads). The official verification list
  (``veri_test.txt``: ``<label> id.../v/c.wav id.../v/c.wav`` with label
  1=target/0=nontarget) defines the held-out speaker set: every speaker
  named in it goes to ``voxceleb1_test``, all others to
  ``voxceleb1_train``, and the list is rewritten as a Kaldi ``trials``
  file (``enroll-utt test-utt target|nontarget``) in the test dir —
  exactly the train/test/trials contract run.sh:28-52 consumes.
- **voxceleb2**: ``$root/{dev,test}/aac/idXXXXX/<video>/<clip>.m4a``;
  ``.m4a`` entries become on-the-fly ffmpeg decode pipes in wav.scp
  (Kaldi-style ``command |`` rxfilenames, handled by our wav reader),
  ``.wav`` trees (pre-converted distributions) are referenced directly.

Utterance ids are ``<spk>-<video>-<clip>`` and speaker ids are the
``idXXXXX`` dir names, so utterances sort after their speaker prefix
(Kaldi's validate_data_dir requirement).

Usage:
    python -m tf_kaldi_speaker_tpu_torch.cli.make_voxceleb voxceleb1 \
        <corpus_root> <out_root> --trials veri_test.txt
        # -> out_root/voxceleb1_{train,test}
    python -m tf_kaldi_speaker_tpu_torch.cli.make_voxceleb voxceleb2 \
        <corpus_root> <out_root> --part dev
"""

from __future__ import annotations

import argparse
import logging
import os
import shlex
import sys
from typing import Dict, List, Tuple

log = logging.getLogger("tfks.make_voxceleb")

AUDIO_EXTS = (".wav", ".m4a")


def _scan_tree(root: str) -> List[Tuple[str, str, str, str]]:
    """[(spk, video, clip, abspath)] for every audio file under
    ``root/<spk>/<video>/<clip>.<ext>``."""
    out = []
    for spk in sorted(os.listdir(root)):
        spk_dir = os.path.join(root, spk)
        if not (spk.startswith("id") and os.path.isdir(spk_dir)):
            continue
        for video in sorted(os.listdir(spk_dir)):
            vdir = os.path.join(spk_dir, video)
            if not os.path.isdir(vdir):
                continue
            for fn in sorted(os.listdir(vdir)):
                base, ext = os.path.splitext(fn)
                if ext.lower() in AUDIO_EXTS:
                    out.append((spk, video, base, os.path.join(vdir, fn)))
    return out


def _wav_entry(path: str) -> str:
    if path.lower().endswith(".m4a"):
        # Same decode pipe Kaldi's make_voxceleb2.pl emits: stream the AAC
        # through ffmpeg to 16-bit PCM on stdout. The path is interpolated
        # into a shell pipe, so quote it (spaces/metacharacters in the
        # corpus mount point must not split or be interpreted).
        return ("ffmpeg -v 8 -i %s -f wav -acodec pcm_s16le - |"
                % shlex.quote(path))
    return path


def _write_dir(out: str, items: List[Tuple[str, str, str, str]]) -> None:
    os.makedirs(out, exist_ok=True)
    spk2utt: Dict[str, List[str]] = {}
    with open(os.path.join(out, "wav.scp"), "w") as wf, \
            open(os.path.join(out, "utt2spk"), "w") as uf:
        for spk, video, clip, path in items:
            utt = "%s-%s-%s" % (spk, video, clip)
            wf.write("%s %s\n" % (utt, _wav_entry(path)))
            uf.write("%s %s\n" % (utt, spk))
            spk2utt.setdefault(spk, []).append(utt)
    with open(os.path.join(out, "spk2utt"), "w") as f:
        for spk in sorted(spk2utt):
            f.write("%s %s\n" % (spk, " ".join(spk2utt[spk])))
    log.info("%s: %d utterances, %d speakers", out, sum(
        len(v) for v in spk2utt.values()), len(spk2utt))


def _veri_utt(path_field: str) -> str:
    """'id10270/GWXujl-xAVM/00017.wav' -> 'id10270-GWXujl-xAVM-00017'."""
    parts = path_field.strip().split("/")
    if len(parts) != 3:
        raise SystemExit("bad trials path field: %r" % path_field)
    return "%s-%s-%s" % (parts[0], parts[1], os.path.splitext(parts[2])[0])


def make_voxceleb1(root: str, out_root: str, trials: str) -> None:
    """voxceleb1_{train,test} + test/trials from the corpus tree + the
    official verification list."""
    wav_root = os.path.join(root, "wav")
    if os.path.isdir(wav_root):
        items = _scan_tree(wav_root)
    else:  # original split downloads: {dev,test}/wav
        items = []
        for part in ("dev", "test"):
            pdir = os.path.join(root, part, "wav")
            if os.path.isdir(pdir):
                items += _scan_tree(pdir)
        items.sort()
    if not items:
        raise SystemExit("no idXXXXX speaker dirs found under %s" % root)

    pairs: List[Tuple[str, str, str]] = []  # (enroll, test, target|nontarget)
    test_spk = set()
    with open(trials) as f:
        for line in f:
            fields = line.split()
            if len(fields) != 3:
                continue
            label, enr, tst = fields
            enr_u, tst_u = _veri_utt(enr), _veri_utt(tst)
            pairs.append((enr_u, tst_u,
                          "target" if label == "1" else "nontarget"))
            test_spk.add(enr_u.split("-")[0])
            test_spk.add(tst_u.split("-")[0])

    train = [it for it in items if it[0] not in test_spk]
    test = [it for it in items if it[0] in test_spk]
    _write_dir(os.path.join(out_root, "voxceleb1_train"), train)
    _write_dir(os.path.join(out_root, "voxceleb1_test"), test)

    have = {"%s-%s-%s" % (s, v, c) for s, v, c, _ in test}
    missing = [p for p in pairs if p[0] not in have or p[1] not in have]
    if missing:
        log.warning("trials: %d/%d pairs reference clips absent from the "
                    "corpus tree (kept out of the trials file)",
                    len(missing), len(pairs))
    with open(os.path.join(out_root, "voxceleb1_test", "trials"), "w") as f:
        for enr, tst, lab in pairs:
            if enr in have and tst in have:
                f.write("%s %s %s\n" % (enr, tst, lab))
    log.info("voxceleb1: %d train / %d test speakers, %d trial pairs",
             len({i[0] for i in train}), len(test_spk), len(pairs))


def make_voxceleb2(root: str, out_root: str, part: str) -> None:
    """out_root/voxceleb2_<part> from $root/<part>/{aac,wav}/..."""
    for sub in ("aac", "wav"):
        pdir = os.path.join(root, part, sub)
        if os.path.isdir(pdir):
            items = _scan_tree(pdir)
            break
    else:
        raise SystemExit("neither %s/%s/aac nor .../wav exists" %
                         (root, part))
    if not items:
        raise SystemExit("no idXXXXX speaker dirs found under %s" % pdir)
    _write_dir(os.path.join(out_root, "voxceleb2_%s" % part), items)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="corpus", required=True)
    p1 = sub.add_parser("voxceleb1",
                        help="build voxceleb1_{train,test} + trials")
    p1.add_argument("root", help="VoxCeleb1 corpus root")
    p1.add_argument("out_root", help="output parent dir")
    p1.add_argument("--trials", required=True,
                    help="official verification list (veri_test.txt)")
    p2 = sub.add_parser("voxceleb2", help="build voxceleb2_<part>")
    p2.add_argument("root", help="VoxCeleb2 corpus root")
    p2.add_argument("out_root", help="output parent dir")
    p2.add_argument("--part", default="dev", choices=("dev", "test"))
    args = parser.parse_args(argv)
    if args.corpus == "voxceleb1":
        make_voxceleb1(args.root, args.out_root, args.trials)
    else:
        make_voxceleb2(args.root, args.out_root, args.part)
    return 0


if __name__ == "__main__":
    sys.exit(main())
