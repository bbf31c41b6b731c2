"""JSON config system.

Counterpart of ``tf_kaldi_speaker_tpu/utils/params.py`` (reference
``misc/utils.py:13-61``): a JSON file becomes an attribute object,
presence-based defaulting goes through ``"key" in params.dict`` and unknown
keys are tolerated, so the public ``nnet_conf/*.json`` configs load as they
are. ``remove_params_prefix`` (the multitask loss heads' ``spk_``/``phn_``
keys) is a copy too. The JAX package's module cannot be imported without jax (its package
``__init__`` imports the summary writer), so the port carries its own.
"""

from __future__ import annotations

import json
from typing import Any, Dict


class Params:
    """Loads hyperparameters from a JSON file into attributes."""

    def __init__(self, json_path: str):
        with open(json_path) as f:
            self.__dict__.update(json.load(f))

    @property
    def dict(self) -> Dict[str, Any]:
        """Dict-style access, e.g. ``params.dict["learning_rate"]``."""
        return self.__dict__

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def __repr__(self) -> str:  # pragma: no cover
        return "Params(%s)" % ", ".join(sorted(self.__dict__))


class ParamsPlain(Params):
    """Params filled from keyword arguments (tests and smoke runs)."""

    def __init__(self, **kwargs):
        self.__dict__.update(kwargs)



def remove_params_prefix(params: Params, prefix: str) -> ParamsPlain:
    """Strip ``<prefix>_`` from keys (multitask ``spk_``/``phn_`` configs).

    Mirrors reference misc/utils.py:349-366: a key ``spk_loss_func`` becomes
    ``loss_func`` in the returned object; keys without the prefix are kept.
    """
    new = ParamsPlain()
    pre = prefix if prefix.endswith("_") else prefix + "_"
    for k, v in params.dict.items():
        if k.startswith(pre):
            new.dict[k[len(pre):]] = v
        else:
            new.dict.setdefault(k, v)
    return new
