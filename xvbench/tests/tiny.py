"""Tiny sizes of the cells for the CPU tests: the published widths cut to a
few dozen channels, a few dozen utterances, the kernels' plain versions."""

import copy

CELLS = {
    "tdnn_pool_train_b256": {
        "config": {"tdnn_layer_size": 32, "num_nodes_pooling_layer": 48,
                   "num_nodes_last_layer": 32, "num_speakers": 20, "utts_per_speaker": 4},
        "traffic": {"corpus": {"lengths": {"kind": "even", "min": 401, "max": 600}},
                    "trainer": {"num_speakers_per_batch": 8}},
    },
}


def overrides(cell, **config):
    out = copy.deepcopy(CELLS[cell])
    out["config"].update(config)
    return out
