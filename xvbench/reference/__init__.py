"""The plain reference that decides ``correct``: float32 PyTorch and numpy
that import nothing of the program. ``codec`` (Kaldi's compressed
matrices), ``sampler`` (the trainer's chunk sampling), ``common`` (the
head, the L2 term, the optimizer, the control's rounding), one module a
network (``tdnn``), and the comparisons (``compare``)."""

import importlib


def network(cfg):
    """The reference module that a configuration names under ``reference``."""
    return importlib.import_module("xvbench.reference." + cfg["reference"])
