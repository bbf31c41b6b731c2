"""Initial weights from the seed, made on the device in one draw.

One ``torch.rand`` of every parameter's elements at once, from a
generator on the run's device, then cut into the parameters of
``param_spec`` in its order: kernels glorot-uniform, biases and BatchNorm
shifts in [-0.1, 0.1], BatchNorm scales in [0.8, 1.2], running means in
[-0.1, 0.1] and running variances in [0.5, 1.5]. The same seed gives the
same weights on the same device, so the reference draws them again after
the window instead of keeping a copy.
"""

from __future__ import annotations

from typing import Dict

import torch

from .reference.common import glorot_limit


def make(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights for a reference module's ``param_spec``."""
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in spec]
    g = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out = {}
    for (name, shape, kind), part in zip(spec, torch.split(u, sizes)):
        s = 2.0 * part.view(shape) - 1.0  # uniform in [-1, 1)
        if kind == "kernel":
            out[name] = s * glorot_limit(shape)
        elif kind in ("bias", "bn_bias", "bn_mean"):
            out[name] = 0.1 * s
        elif kind == "bn_scale":
            out[name] = 1.0 + 0.2 * s
        else:  # bn_var
            out[name] = 1.0 + 0.5 * s
    return out
