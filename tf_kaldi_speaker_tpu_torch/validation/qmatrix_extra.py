"""Follow-ups to :mod:`.quality_matrix` on the same corpus root, through
the port (a copy of ``scripts/qmatrix_extra.py``):

  --c3        the pool_rot_c3 arm (3 coverage cycles an epoch)
  --utts      the pool_rot_utts arm (utterance-unit rotation windows under
              the same forced 8 MB budget)
  --losses3k  softmax vs am-softmax at the 3 x 1000-step schedule

Run: ``python -m tf_kaldi_speaker_tpu_torch.validation.qmatrix_extra --root
DIR --c3 [--device cuda]``. Prints the same per-run lines as the matrix.
"""

from __future__ import annotations

import argparse

from ..cli._frontend import device_or_raise
from . import corpora
from .common import card_name, fmt_mean_sd
from .quality_matrix import PATHS, train_and_eer

LRS_3K = [0.04, 0.02, 0.01]


def _print(name, eers):
    print("%s: %s | %s" % (name, fmt_mean_sd(eers),
                           " ".join("%.2f" % (e * 100) for e in eers)), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True)
    p.add_argument("--c3", action="store_true")
    p.add_argument("--utts", action="store_true")
    p.add_argument("--losses3k", action="store_true")
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = device_or_raise(args.device)
    print("card:", card_name(device), flush=True)
    train_d, test_d = corpora.make_hard_corpora(args.root)  # deterministic regen
    seeds = list(range(args.seeds))

    for flag, name in ((args.c3, "pool_rot_c3"), (args.utts, "pool_rot_utts")):
        if flag:
            _print(name, [train_and_eer(args.root, train_d, test_d, "path_" + name, s,
                                        PATHS[name], device=device) for s in seeds])

    if args.losses3k:
        base = dict(device_decode=False, device_pool=True)
        for name, over in [
            ("softmax_3x1000", dict(base, loss_func="softmax")),
            ("amsoftmax_3x1000", dict(base, loss_func="additive_margin_softmax")),
        ]:
            _print(name, [train_and_eer(args.root, train_d, test_d, name, s, over,
                                        epoch_lrs=LRS_3K, steps_per_epoch=1000,
                                        device=device) for s in seeds])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
