"""SIGTERM-graceful preemption handling for the training CLIs.

A copy of ``tf_kaldi_speaker_tpu/train/preemption.py`` for one process
(reference recovery is restart-based only: ``--cont`` re-derives the epoch
from the last checkpoint, reference train.py:38-48). Preemptible machines
deliver SIGTERM with a grace window before the kill; catching it lets the
trainer finish the group of steps in flight, save a checkpoint at the exact
step reached, and exit with a distinct status so schedulers requeue the job
with ``--cont`` and lose no steps (instead of up to
``save_checkpoints_steps`` of work).

The handler only flips a flag (async-signal-safe); the training loop polls
it at each group boundary and the validation loops at each batch
(``Trainer._should_stop``).
"""

from __future__ import annotations

import logging
import signal

# BSD sysexits EX_TEMPFAIL: "temporary failure, retry later" — the
# conventional requeue-me exit status.
EXIT_PREEMPTED = 75

log = logging.getLogger("tfks_torch.preempt")


def install_preemption_handler(trainer) -> None:
    """Route SIGTERM to ``trainer.request_stop()``.

    Call from the CLI main thread after the trainer is constructed
    (CPython delivers signals to the main thread only)."""

    def _handler(signum, frame):
        log.info(
            "SIGTERM: finishing the group of steps in flight, then "
            "checkpointing and exiting %d (resume with --cont)",
            EXIT_PREEMPTED,
        )
        trainer.request_stop()

    signal.signal(signal.SIGTERM, _handler)


def exit_code_if_preempted(trainer) -> int | None:
    """Returns EXIT_PREEMPTED (and logs the resume hint) when the epoch was
    cut short by request_stop(); None for a normal epoch end.

    Keys on ``stop_acknowledged`` (the stop that a loop's poll acted on),
    not the raw flag: a SIGTERM that lands after the loop's last poll is
    acted on by the next phase's first poll."""
    if not trainer.stop_acknowledged:
        return None
    log.info(
        "preempted: checkpoint saved at step %d; rerun with --cont to "
        "resume the remainder of the epoch", trainer.step,
    )
    return EXIT_PREEMPTED
