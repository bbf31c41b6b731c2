"""What the training CLIs share to run on several cards.

One process a card, started by a launcher: ``torchrun --nproc_per_node N
-m tf_kaldi_speaker_tpu_torch.cli.train ...`` (or anything that sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``). Every rank joins (``parallel.initialize``: NCCL on the
cards, gloo with ``--device cpu``); rank 0 alone logs at INFO and writes the
model dir's bookkeeping files; the others read the config rank 0 wrote.
Without a launcher this is the one-process CLI.
"""

from __future__ import annotations

import atexit
import logging

from .. import parallel
from ..utils import bookkeeping as bk
from ._frontend import device_or_raise


def start(device: str):
    """Join the launcher's ranks (left at exit); returns this rank's
    device (checked, and TF32 off, by ``device_or_raise``)."""
    dev = parallel.initialize(device_or_raise(device))
    atexit.register(parallel.shutdown)
    if not parallel.is_main():
        logging.getLogger().setLevel(logging.WARNING)
    return dev


def model_dir_params(cont: bool, model_dir: str, config, device):
    """The run's config: rank 0 prepares the model dir (the code snapshot
    and the config copy), then the other ranks read its copy."""
    if parallel.is_main():
        params = bk.save_codes_and_config(cont, model_dir, config)
    parallel.barrier(device)
    if not parallel.is_main():
        params = bk.save_codes_and_config(True, model_dir, None)
    return params


def on_main(fn, *args) -> None:
    """``fn(*args)`` on rank 0 only (a bookkeeping file's write)."""
    if parallel.is_main():
        fn(*args)
