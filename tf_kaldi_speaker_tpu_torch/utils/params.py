"""JSON config system.

Counterpart of ``tf_kaldi_speaker_tpu/utils/params.py`` (reference
``misc/utils.py:13-61``): a JSON file becomes an attribute object,
presence-based defaulting goes through ``"key" in params.dict`` and unknown
keys are tolerated, so the public ``nnet_conf/*.json`` configs load as they
are. The JAX package's module cannot be imported without jax (its package
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

