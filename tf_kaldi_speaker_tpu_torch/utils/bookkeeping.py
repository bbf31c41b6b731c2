"""Experiment bookkeeping: code/config snapshots, LR & valid-loss files.

A copy of ``tf_kaldi_speaker_tpu/utils/bookkeeping.py`` (reference
misc/utils.py:64-270): the model dir is the source of truth —
``config.json``, ``feature_dim``, ``num_speakers``, ``learning_rate`` (one
"epoch lr" line per epoch), ``valid_loss`` ("epoch loss eer"), a code
snapshot in ``<model>/codes``, and checkpoint files under ``<model>/nnet``.
``get_pretrain_model`` copies the port's ``.pt`` or the JAX package's
``.msgpack``, whichever the pretrain dir holds for its step.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional, Tuple


def save_codes_and_config(cont: bool, model_dir: str, config_path: Optional[str]) -> object:
    """Prepare the model dir; snapshot code + config (misc/utils.py:64-123).

    Returns the loaded Params. With ``cont`` the existing snapshot config is
    reloaded; otherwise the model dir is (re)created from config_path.
    """
    from .params import Params

    nnet_dir = os.path.join(model_dir, "nnet")
    if cont:
        cfg = os.path.join(nnet_dir, "config.json")
        if not os.path.isfile(cfg):
            raise FileNotFoundError("Cannot continue: %s missing" % cfg)
        return Params(cfg)

    assert config_path is not None and os.path.isfile(config_path)
    if os.path.isdir(nnet_dir):
        backup = os.path.join(model_dir, ".backup")
        if os.path.isdir(backup):
            shutil.rmtree(backup)
        os.makedirs(backup, exist_ok=True)
        for name in ("nnet", "codes"):
            src = os.path.join(model_dir, name)
            if os.path.isdir(src):
                shutil.move(src, os.path.join(backup, name))
    os.makedirs(nnet_dir, exist_ok=True)

    # Snapshot the package so old models extract with old code.
    codes_dir = os.path.join(model_dir, "codes")
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(
        pkg_root,
        os.path.join(codes_dir, os.path.basename(pkg_root)),
        ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.pyc"),
        dirs_exist_ok=True,
    )
    shutil.copyfile(config_path, os.path.join(nnet_dir, "config.json"))
    return Params(os.path.join(nnet_dir, "config.json"))


def get_pretrain_model(pretrain_nnet: str, finetune_nnet: str) -> None:
    """Copy a pretrained checkpoint in as step 0 (misc/utils.py:126-183)."""
    from ..train import checkpoints

    steps = checkpoints.list_steps(pretrain_nnet)
    if not steps:
        raise FileNotFoundError("No checkpoint in %s" % pretrain_nnet)
    step = checkpoints.read_pointer(pretrain_nnet) or steps[-1]
    src = checkpoints.checkpoint_path(pretrain_nnet, step)
    os.makedirs(finetune_nnet, exist_ok=True)
    shutil.copyfile(src, os.path.join(finetune_nnet, "model-0" + os.path.splitext(src)[1]))
    checkpoints.write_pointer(finetune_nnet, 0)


def load_lr_file(path: str) -> Dict[int, float]:
    """Parse the learning_rate bookkeeping file: lines "epoch lr"."""
    out: Dict[int, float] = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    out[int(parts[0])] = float(parts[1])
    return out


def append_lr(path: str, epoch: int, lr: float) -> None:
    with open(path, "a") as f:
        f.write("%d %.8f\n" % (epoch, lr))


def load_valid_loss(path: str) -> List[Tuple[int, float, float]]:
    """Parse valid_loss: lines "epoch loss eer"."""
    out = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    out.append((int(parts[0]), float(parts[1]), float(parts[2])))
    return out


def append_valid_loss(path: str, epoch: int, loss: float, eer: float) -> None:
    with open(path, "a") as f:
        f.write("%d %f %f\n" % (epoch, loss, eer))


def load_learning_rate_schedule(value, num_epochs: int) -> Optional[Dict[int, float]]:
    """``learning_rate`` config: float, or a path to per-epoch "epoch lr"
    lines (reference train.py:53-60). Returns None for plain float."""
    if isinstance(value, (int, float)):
        return None
    assert isinstance(value, str) and os.path.isfile(value), (
        "learning_rate must be a float or a file: %r" % value
    )
    return load_lr_file(value)


def write_scalar_file(path: str, value) -> None:
    with open(path, "w") as f:
        f.write("%s\n" % value)


def read_scalar_file(path: str, cast=int):
    with open(path) as f:
        return cast(f.read().strip())
