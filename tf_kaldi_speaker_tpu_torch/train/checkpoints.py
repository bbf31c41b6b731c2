"""Checkpoint store with the reference's model-dir contract.

Counterpart of ``tf_kaldi_speaker_tpu/train/checkpoints.py``. Inside
``<model>/nnet``:

- ``model-<step>.pt``       written by the port with ``torch.save``: the
  same nested tree, in the JAX package's layout, as its msgpack, as CPU
  tensors (``convert.py`` is the only place where layouts change). Loaded
  with ``weights_only=True``. A train state holds ``params`` and
  ``batch_stats`` (``params/network/tdnn/...``,
  ``params/softmax/output_kernel``), ``opt_state`` (``{}``, ``{"trace":
  tree}`` or ``{"count", "mu", "nu"}``, trees in the params' layout) and
  ``step``.
- ``model-<step>.msgpack``  written by the JAX package (msgpack with
  its own array extension types). The port decodes it itself when no ``.pt`` of that step
  exists, so a model dir trained by the JAX package serves from the port,
  and its train state resumes there (:func:`opt_state_from_raw` reads
  optax's chain layout).
- ``checkpoint``            TF-style text pointer file:
      model_checkpoint_path: "model-<step>"
      all_model_checkpoint_paths: "model-<k>" ...
  :func:`select_checkpoint` (``make_checkpoint``'s best/last selection)
  rewrites only this file.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_CKPT_RE = re.compile(r"^model-(\d+)\.(pt|msgpack)$")

# msgpack extension codes of the JAX package's checkpoint writer
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def list_steps(model_dir: str) -> List[int]:
    if not os.path.isdir(model_dir):
        return []
    steps = set()
    for name in os.listdir(model_dir):
        m = _CKPT_RE.match(name)
        if m:
            steps.add(int(m.group(1)))
    return sorted(steps)


def read_pointer(model_dir: str) -> Optional[int]:
    path = os.path.join(model_dir, "checkpoint")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        for line in f:
            m = re.match(r'^model_checkpoint_path: "model-(\d+)"', line.strip())
            if m:
                return int(m.group(1))
    return None


def write_pointer(model_dir: str, step: int) -> None:
    steps = list_steps(model_dir)
    with open(os.path.join(model_dir, "checkpoint"), "w") as f:
        f.write('model_checkpoint_path: "model-%d"\n' % step)
        for s in steps:
            f.write('all_model_checkpoint_paths: "model-%d"\n' % s)


def save_checkpoint(model_dir: str, tree: Any, step: int, keep_max: int = 0) -> str:
    """Write ``tree`` (nested dicts of tensors) as ``model-<step>.pt``, keep
    only the newest ``keep_max`` steps (all when 0) and point the pointer
    file at it."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, "model-%d.pt" % step)
    torch.save(tree, path + ".tmp")
    os.replace(path + ".tmp", path)
    if keep_max and keep_max > 0:
        for s in list_steps(model_dir)[:-keep_max]:
            for ext in ("pt", "msgpack"):
                old = os.path.join(model_dir, "model-%d.%s" % (s, ext))
                if os.path.exists(old):
                    os.remove(old)
    write_pointer(model_dir, step)
    return path


def checkpoint_path(model_dir: str, step: int) -> str:
    """The file of checkpoint ``step``: the port's ``.pt`` where it exists,
    else the JAX package's ``.msgpack``."""
    pt = os.path.join(model_dir, "model-%d.pt" % step)
    return pt if os.path.exists(pt) else os.path.join(model_dir, "model-%d.msgpack" % step)


def select_checkpoint(model_dir: str, checkpoint="last", write: bool = True) -> int:
    """Resolve "last" / step-id / "-1" (best by valid_loss) to a step and
    rewrite the pointer (reference misc/utils.py:217-270 + make_checkpoint.py).
    ``write=False`` resolves only, leaving the model dir untouched.

    A copy of the JAX package's ``select_checkpoint``: "best" reads
    ``<model_dir>/../valid_loss`` lines "epoch loss eer" and maps the best
    epoch to step best_epoch*num_steps_per_epoch (1-based epochs, as
    cli/train.py writes them), snapping to the closest existing checkpoint.
    """
    steps = list_steps(model_dir)
    if not steps:
        raise FileNotFoundError("No checkpoints in %s" % model_dir)
    if checkpoint in ("-1", -1, "best"):
        valid_loss_path = os.path.join(os.path.dirname(model_dir), "valid_loss")
        if not os.path.exists(valid_loss_path):
            valid_loss_path = os.path.join(model_dir, "valid_loss")
        best_epoch, best_loss = None, None
        with open(valid_loss_path) as f:
            for line in f:
                parts = line.split()
                epoch, loss = int(parts[0]), float(parts[1])
                if best_loss is None or loss < best_loss:
                    best_epoch, best_loss = epoch, loss
        with open(os.path.join(model_dir, "config.json")) as f:
            num_steps = json.load(f)["num_steps_per_epoch"]
        step = best_epoch * num_steps
        # fall back to the closest existing checkpoint
        step = min(steps, key=lambda s: abs(s - step))
    elif checkpoint == "last":
        step = steps[-1]
    else:
        step = int(checkpoint)
    assert step in steps, "checkpoint model-%d not found" % step
    if write:
        write_pointer(model_dir, step)
    return step


def opt_state_from_raw(opt_state: Any) -> Dict[str, Any]:
    """The optimizer state of a loaded checkpoint in the port's layout:
    ``{}``, ``{"trace": tree}`` or ``{"count": int, "mu": tree, "nu":
    tree}``. A JAX checkpoint holds optax's chain, a dict of the chained
    states by position (``{"0": {}, "1": {"trace": ...}}`` with clipping);
    the one that carries a trace or Adam moments is taken."""
    if not isinstance(opt_state, dict):
        return {}
    if "trace" in opt_state:
        return {"trace": opt_state["trace"]}
    if "mu" in opt_state:
        return {"count": int(opt_state["count"]), "mu": opt_state["mu"],
                "nu": opt_state["nu"]}
    for key in sorted(opt_state, key=lambda k: (len(str(k)), str(k))):
        found = opt_state_from_raw(opt_state[key])
        if found:
            return found
    return {}


def load_checkpoint(model_dir: str, step: Optional[int] = None) -> Tuple[Any, int]:
    """Load the pointed-to (or given-step) checkpoint as a nested dict whose
    array leaves are CPU tensors."""
    if step is None:
        step = read_pointer(model_dir)
    if step is None:
        steps = list_steps(model_dir)
        if not steps:
            raise FileNotFoundError("No checkpoint in %s" % model_dir)
        step = steps[-1]
    path = checkpoint_path(model_dir, step)
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu", weights_only=True), step
    with open(path, "rb") as f:
        return msgpack_restore(f.read()), step


def _array_from_bytes(data: bytes):
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":  # numpy has no bfloat16: reinterpret bits
        bits = np.frombuffer(buffer, np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buffer, np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == _EXT_NPSCALAR:
        arr = _array_from_bytes(data)
        return arr.item() if isinstance(arr, torch.Tensor) else arr[()]
    return msgpack.ExtType(code, data)


def _to_tensors(tree: Any) -> Any:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:  # the writer splits arrays > 1 GiB
            chunks = [_to_tensors(tree["chunks"][k]) for k in
                      sorted(tree["chunks"], key=int)]
            shape = tuple(tree["shape"][k] for k in sorted(tree["shape"], key=int))
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def msgpack_restore(encoded: bytes) -> Any:
    """Decode a JAX-written msgpack checkpoint; array leaves become
    CPU tensors."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError(
            "reading a JAX-written model-<step>.msgpack needs the msgpack "
            "package; convert the checkpoint to model-<step>.pt where "
            "msgpack is installed") from e
    return _to_tensors(msgpack.unpackb(encoded, ext_hook=_ext_hook, raw=False))
