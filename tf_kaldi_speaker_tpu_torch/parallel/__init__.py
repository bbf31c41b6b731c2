"""Multi-card training: process groups, collectives, the sharded softmax and
sequence parallelism.

Counterpart of ``tf_kaldi_speaker_tpu/parallel``. One process drives one
card; a launcher (``torchrun``, or anything that sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) starts
the processes, and :func:`initialize` joins them. A JAX mesh
``(data, model)`` maps onto process groups: rank = data index *
``model_parallel`` + model index (``make_mesh``'s row-major reshape), so a
model group is ``model_parallel`` consecutive ranks. A world of one rank
builds no group and runs no collective.
"""

from .distributed import (barrier, host_shard_info, initialize, is_main, per_host_batch,
                          shutdown)
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, pad_batch_to_devices
from .sharding_rules import DEFAULT_RULES, shard_model, sharded_dim

__all__ = [
    "DATA_AXIS",
    "DEFAULT_RULES",
    "MODEL_AXIS",
    "Mesh",
    "barrier",
    "host_shard_info",
    "initialize",
    "is_main",
    "make_mesh",
    "pad_batch_to_devices",
    "per_host_batch",
    "shard_model",
    "sharded_dim",
    "shutdown",
]
