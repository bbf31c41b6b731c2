"""The numbers that decide ``correct``.

Training (the checked steps from the benchmark's weights: step 1, then
one group of K): each epoch's loss as a relative gap; the first gradient
and the change of the parameters after the checked steps by their worst
leaf, as the gap between the program's norm and the reference's over the
larger of the reference's norm of that leaf and of the median leaf. Leaves whose reference gradient is under a
thousandth of the median leaf's are left out (the biases that a BatchNorm
follows: their gradient is zero but for rounding). Where the later steps
part by rounding alone (a trunk whose steps amplify float32's last bits),
the first step's loss and the median leaf's change are the steady
readings.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

LEAF_FLOOR = 1e-3


def counted_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in ref_grads.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n >= LEAF_FLOOR * med]


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: Sequence[str]) -> List[float]:
    """Per leaf: |the program's norm - the reference's| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in names}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    med = float(np.median([rn[k] for k in names]))
    return [abs(pn[k] - rn[k]) / max(rn[k], med) for k in names]


def training_numbers(prog_losses, ref_losses, prog_grad, ref_grad, prog_change,
                     ref_change) -> Dict[str, float]:
    """Every number a training check may compare; the cell's file names
    the ones it does."""
    names = counted_leaves(ref_grad)
    change = leaf_gaps(prog_change, ref_change, names)
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses)),
        "first_loss_gap": abs(prog_losses[0] - ref_losses[0]) / abs(ref_losses[0]),
        "grad_norm_gap": max(leaf_gaps(prog_grad, ref_grad, names)),
        "update_norm_gap": max(change),
        "median_update_gap": float(np.median(change)),
    }

