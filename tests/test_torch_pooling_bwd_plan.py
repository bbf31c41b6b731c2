"""The pooling backward kernel's plan (ops/pooling.py backward_plan) on the
CPU: the work items the kernel decodes from it cover every (row, frame,
4-column group) of x exactly once, none is empty, the grid stays resident,
and the plan is a function of its inputs."""

import numpy as np
import pytest

from tf_kaldi_speaker_tpu_torch.ops.pooling import (
    BWD_ITEM_STAGES,
    BackwardGeometry,
    backward_plan,
)

SMS = 132  # the H100 SXM's SMs
# The kernel's geometry as its library reports it on the H100: 128-column
# tiles, ring stages of 32 bf16 or 16 float32 frames, and 5 resident
# blocks a SM (48 registers a thread, 256 threads); and a lower occupancy.
DTYPES = {"bfloat16": BackwardGeometry(128, 32, SMS, 5),
          "float32": BackwardGeometry(128, 16, SMS, 5),
          "bfloat16, 2 a SM": BackwardGeometry(128, 32, SMS, 2)}


def _items(plan, b, l):
    """Each item as the kernel decodes it: (row, tile, first frame, end)."""
    k = np.arange(plan.items)
    tile = k % plan.tiles
    rng = (k // plan.tiles) % plan.splits
    row = k // (plan.tiles * plan.splits)
    f0 = rng * plan.frames_per_item
    return row, tile, f0, np.minimum(l, f0 + plan.frames_per_item)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b", [1, 3, 64, 256])
@pytest.mark.parametrize("l", [0, 1, 25, 46, 286, 2500])
def test_plan_covers_the_work_once(dtype, b, l):
    geo = DTYPES[dtype]
    for d in (8, 20, 257, 1500, 1501):
        plan = backward_plan(b, l, d, geo)
        groups = -(-d // 4)  # 4-column groups of a frame
        assert plan.tiles == -(-d // geo.cols)
        # every tile holds a group, and the tiles cover the groups
        assert geo.cols // 4 * (plan.tiles - 1) < groups <= geo.cols // 4 * plan.tiles
        if l == 0:
            assert plan.items == plan.blocks == 0
            continue
        cap = SMS * geo.blocks_per_sm
        assert 1 <= plan.blocks <= min(plan.items, cap)
        assert plan.items == b * plan.tiles * plan.splits
        row, tile, f0, f1 = _items(plan, b, l)
        assert (f1 > f0).all(), (b, l, d, plan)  # no item empty
        # per (row, tile), the frame ranges lie end to end from 0 to l
        order = np.lexsort((f0, tile, row))
        row, tile, f0, f1 = row[order], tile[order], f0[order], f1[order]
        first = np.ones(plan.items, bool)
        first[1:] = (row[1:] != row[:-1]) | (tile[1:] != tile[:-1])
        last = np.roll(first, -1)
        assert (f0[first] == 0).all() and (f1[last] == l).all()
        assert (f0[~first] == f1[np.flatnonzero(~first) - 1]).all()
        # every (row, tile) pair once
        pairs = row[first] * plan.tiles + tile[first]
        assert np.array_equal(pairs, np.arange(b * plan.tiles))
        # block i takes items i, i + blocks, ...: each item one block
        walked = np.concatenate([np.arange(i, plan.items, plan.blocks)
                                 for i in range(plan.blocks)])
        assert np.array_equal(np.sort(walked), np.arange(plan.items))
        # rows split only where rows x tiles give under two items a block,
        # into ranges of BWD_ITEM_STAGES stages
        if b * plan.tiles >= 2 * cap:
            assert plan.splits == 1
        else:
            assert plan.frames_per_item == min(l, BWD_ITEM_STAGES * geo.stage_frames)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plan_is_a_function_of_its_inputs(dtype):
    geo = DTYPES[dtype]
    shapes = [(b, l, d) for b in (1, 3, 64, 256) for l in (0, 1, 25, 46, 286, 2500)
              for d in (8, 20, 257, 1500, 1501)]
    first = [backward_plan(*s, geo) for s in shapes]
    assert [backward_plan(*s, BackwardGeometry(*geo)) for s in shapes] == first


@pytest.mark.parametrize("shape, esize, want", [
    # the flagship train bucket: 768 (row, tile) pairs < 2 x 660 blocks, so
    # ranges of 96 frames (bf16) or 48 (float32)
    ((64, 286, 1500), 2, (660, 2304, 96, 12, 3)),
    ((64, 286, 1500), 4, (660, 4608, 48, 12, 6)),
    # the quality path's pooling width: one round of 384 items
    ((64, 286, 256), 2, (384, 384, 96, 2, 3)),
    # ResNet34's short frame axes: whole rows
    ((64, 25, 1024), 4, (512, 512, 25, 8, 1)),
    ((64, 46, 1024), 4, (512, 512, 46, 8, 1)),
    # two items a block: whole rows
    ((256, 1200, 1500), 2, (660, 3072, 1200, 12, 1)),
    # one long row
    ((1, 2500, 8), 2, (27, 27, 96, 1, 27)),
])
def test_plan_at_main_shapes(shape, esize, want):
    geo = DTYPES["bfloat16" if esize == 2 else "float32"]
    assert tuple(backward_plan(*shape, geo)) == want


def test_plan_refuses_no_resident_block():
    with pytest.raises(ValueError, match="no resident block"):
        backward_plan(64, 286, 1500, BackwardGeometry(128, 32, SMS, 0))
