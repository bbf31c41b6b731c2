"""Kaldi r/w-specifier plumbing: files, pipes, gzip, byte offsets.

Counterpart of ``tf_kaldi_speaker_tpu/kio/rspecifier.py``, whole. Behavioral
parity with reference dataset/kaldi_io.py:344-426 (open_or_fd,
popen, read_key) so rspecifiers like ``"ark:apply-cmvn-sliding ... |"`` and
scp entries ``file.ark:12345`` work unchanged.
"""

from __future__ import annotations

import gzip
import io
import re
import subprocess
import threading


class SubprocessFailed(Exception):
    pass


_SPECIFIER_RE = re.compile(r"^(ark|scp)(,scp|,b|,t|,n?f|,n?p|,b?o|,n?s|,n?cs)*:")
_OFFSET_RE = re.compile(r":[0-9]+$")


def popen(cmd: str, mode: str = "rb"):
    """Run a shell pipeline, returning its stdin/stdout as a file object.

    A watcher thread raises SubprocessFailed if the command exits non-zero,
    matching the reference's pipe-failure detection (kaldi_io.py:377-410).
    """
    if not isinstance(cmd, str):
        raise TypeError("invalid cmd type (%s, expected string)" % type(cmd))

    def _watch(proc):
        ret = proc.wait()
        if ret > 0:
            raise SubprocessFailed("cmd %s returned %d !" % (cmd, ret))

    if mode in ("r", "rb"):
        proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE)
        threading.Thread(target=_watch, args=(proc,), daemon=True).start()
        return io.TextIOWrapper(proc.stdout) if mode == "r" else proc.stdout
    if mode in ("w", "wb"):
        proc = subprocess.Popen(cmd, shell=True, stdin=subprocess.PIPE)
        threading.Thread(target=_watch, args=(proc,), daemon=True).start()
        return io.TextIOWrapper(proc.stdin) if mode == "w" else proc.stdin
    raise ValueError("invalid mode %s" % mode)


def open_or_fd(file, mode: str = "rb"):
    """Open a file / gzipped file / pipe, or pass a descriptor through.

    Handles the optional ``ark:``/``scp:`` prefix and a ``:offset`` suffix.
    """
    offset = None
    try:
        if _SPECIFIER_RE.search(file):
            _, file = file.split(":", 1)
        if _OFFSET_RE.search(file):
            file, offset = file.rsplit(":", 1)
        if file == "-":              # stdin/stdout (Kaldi's "-" rxfilename)
            import sys

            fd = sys.stdin.buffer if "r" in mode else sys.stdout.buffer
        elif file[-1] == "|":        # input pipe
            fd = popen(file[:-1], "rb")
        elif file[0] == "|":         # output pipe
            fd = popen(file[1:], "wb")
        elif file.split(".")[-1] == "gz":
            fd = gzip.open(file, mode)
        else:
            fd = open(file, mode)
    except TypeError:
        fd = file                    # already an open descriptor
    if offset is not None:
        fd.seek(int(offset))
    return fd


def read_key(fd):
    """Read a space-terminated utterance key; None at end of stream."""
    chars = []
    while True:
        c = fd.read(1).decode("latin1")
        if c in ("", " "):
            break
        chars.append(c)
    key = "".join(chars).strip()
    if not key:
        return None
    if re.match(r"^\S+$", key) is None:
        raise ValueError("Malformed ark key: %r" % key)
    return key
