"""K2's listed march on the CPU: the live boxes of a single-device solve
(`kernels/tiling.live_boxes`, the rule the list kernels of
`csrc/jacobi.cu` follow) and the passes over them.

A torch emulation follows the listed solve as the kernels do: both
ping-pong buffers start as c2e (the list scan's fill); the first pass
reads q0; every pass computes each live box from its own window with the
plain PyTorch sweeps and stitches the box into its buffer, the dead boxes
left as they are.  That must equal `jacobi_sweeps_plain` bitwise, every
float's bits (a -0.0 for a +0.0 fails).  A box the rule leaves out that
changes, or a dead neighbour a live box reads wrong, shows as a
difference.  The file imports no JAX: its `cuda` tests run on the card
against the plain version."""

import numpy as np
import pytest
import torch

from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.kernels import tiling
from tpu_fluid_torch.kernels.jacobi import (jacobi_fold_plain,
                                            jacobi_pass_plain,
                                            jacobi_sweeps_plain)

torch.set_num_threads(2)
K = tiling.BLOCKED_K
SMS = (132, 3)            # the card's count, and a few: longer boxes
SHAPE = (40, 50, 70)      # 3 y tiles and 2 z tiles of the K-ring geometry


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def random_types(r, shape):
    """About 40% WATER, the rest AIR and INACTIVE, SOLID walls."""
    t = np.where(r.random(shape) < 0.4, 2, 0).astype(np.uint8)
    t[0], t[-1], t[:, 0], t[:, -1], t[:, :, 0], t[:, :, -1] = (3,) * 6
    t[(t == 0) & (r.random(shape) < 0.3)] = 1
    return t


def window(p: tiling.Pass, box):
    """A block's input window: its box with p.halo planes and rings a
    side, clipped to the grid."""
    return tuple(slice(max(lo - p.halo, 0), min(hi + p.halo, n))
                 for (lo, hi), n in zip(box, p.shape))


def stitch(out, box, win, got):
    """Copy the result's box (window coordinates) into out."""
    (x0, x1), (y0, y1), (z0, z1) = box
    wx, wy, wz = (w.start for w in win)
    out[x0:x1, y0:y1, z0:z1] = got[x0 - wx:x1 - wx, y0 - wy:y1 - wy,
                                   z0 - wz:z1 - wz]


def emulate_listed(plan: tiling.Plan, q0, code, c2e, n_iters):
    """q0 after the listed plan's sweeps, only the live boxes computed."""
    assert plan.listed
    first = plan.passes[0]
    assert all(p.halo == K and p.seg == first.seg
               and p.tiles == first.tiles for p in plan.passes)
    boxes = list(first.blocks())
    live = tiling.live_boxes(first, q0, code, c2e, n_iters)
    out, tmp = c2e.clone(), c2e.clone()
    src = q0
    for i, p in enumerate(plan.passes):
        dst = out if (len(plan.passes) - 1 - i) % 2 == 0 else tmp
        for b in live:
            win = window(p, boxes[b])
            stitch(dst, boxes[b], win,
                   jacobi_pass_plain(src[win], code[win], c2e[win], 0,
                                     p.levels))
        src = dst
    return out, live


def bits(a):
    return a.contiguous().view(torch.int32)


def walled(shape, fill=CellType.AIR):
    """A grid of `fill` inside one ring of SOLID cells."""
    t = np.full(shape, fill, dtype=np.uint8)
    t[0], t[-1], t[:, 0], t[:, -1], t[:, :, 0], t[:, :, -1] = \
        (CellType.SOLID,) * 6
    return t


def fold(types, seed, boundary, div_at=None):
    r = np.random.default_rng(seed)
    div = (r.standard_normal(types.shape) * 50).astype(np.float32)
    if div_at is not None:
        for at, v in div_at:
            div[at] = v
    return jacobi_fold_plain(T(types), T(div), 1.0, boundary)


def check(shape, types, n_iters, sms, boundary=1.0, seed=3, div_at=None):
    q0, code, c2e = fold(types, seed, boundary, div_at)
    plan = tiling.jacobi_plan(shape, n_iters, sms=sms)
    got, live = emulate_listed(plan, q0, code, c2e, n_iters)
    assert torch.equal(bits(got), bits(jacobi_sweeps_plain(q0, code, c2e,
                                                           n_iters)))
    return plan, live


def compact_water(shape):
    """The fountain's source: a cube of WATER in AIR, SOLID walls."""
    t = walled(shape)
    t[10:22, 8:30, 12:40] = CellType.WATER
    return t


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("boundary", [1.0, 0.0])
@pytest.mark.parametrize("n_iters", [1, 3, 4, 7, 9])
def test_listed_march_of_compact_water_equals_plain(n_iters, boundary, sms):
    """A cube of water: only its boxes are live; the rest hold c2e from
    the fill, which is what every sweep gives them; remainder passes of 1
    and 3 sweeps march the same boxes."""
    plan, live = check(SHAPE, compact_water(SHAPE), n_iters, sms, boundary)
    assert 0 < len(live) < plan.passes[0].n_blocks


def boxes_of(p: tiling.Pass):
    return list(p.blocks())


@pytest.mark.parametrize("sms", (132, 24))   # 20 and 4 x segments
@pytest.mark.parametrize("gap", [0, 1, K, K + 1])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_water_beside_a_box_edge(axis, gap, sms):
    """One water cell `gap` cells before the first cell of a box along
    each axis (0: in that box's neighbour, against the edge): the box
    beyond it is dead, its neighbour live, and the live box's sweeps read
    the dead box's c2e."""
    plan = tiling.jacobi_plan(SHAPE, 7, sms=sms)
    p = plan.passes[0]
    step = (p.seg, p.inner_y, p.inner_z)[axis]
    edge = step * -(-(gap + 2) // step)   # a box's first cell past the wall
    assert edge < SHAPE[axis] - 1
    t = walled(SHAPE)
    at = [SHAPE[0] // 2, SHAPE[1] // 2, SHAPE[2] // 2]
    at[axis] = edge - 1 - gap
    t[tuple(at)] = CellType.WATER
    _, live = check(SHAPE, t, 7, sms)
    blocks = boxes_of(p)
    holding = [i for i, box in enumerate(blocks)
               if all(lo <= c < hi for c, (lo, hi) in zip(at, box))]
    assert live == holding


@pytest.mark.parametrize("sms", SMS)
def test_no_water_lists_no_box(sms):
    """No WATER: nothing is live and the result is c2e, the fill."""
    plan, live = check(SHAPE, walled(SHAPE), 7, sms)
    assert live == []


@pytest.mark.parametrize("sms", SMS)
def test_all_water_lists_every_box(sms):
    plan, live = check(SHAPE, walled(SHAPE, CellType.WATER), 7, sms)
    assert live == list(range(len(boxes_of(plan.passes[0]))))


@pytest.mark.parametrize("boundary", [1.0, 0.0])
def test_water_pockets_with_no_open_neighbour(boundary):
    """WATER cells whose six neighbours are SOLID have code 0 and c2e =
    q0 = boundary: a box holding only such a pocket is dead."""
    t = walled(SHAPE)
    pocket = (30, 40, 60)
    t[29:32, 39:42, 59:62] = CellType.SOLID
    t[pocket] = CellType.WATER
    t[5:8, 5:9, 5:9] = CellType.WATER
    plan, live = check(SHAPE, t, 9, 3, boundary)
    q0, code, _ = fold(t, 3, boundary)
    assert int(code[pocket]) == 0 and float(q0[pocket]) == boundary
    blocks = boxes_of(plan.passes[0])
    assert not any(all(lo <= c < hi for c, (lo, hi) in zip(pocket, blocks[b]))
                   for b in live)


@pytest.mark.parametrize("sms", SMS)
def test_random_cells_equal_plain(sms):
    """A random cell field, about 40% of it WATER."""
    r = np.random.default_rng(5)
    plan, live = check(SHAPE, random_types(r, SHAPE), 7, sms)
    assert live == list(range(len(boxes_of(plan.passes[0]))))


@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   -float("inf"), 2.0 ** 110])
def test_guard_lists_every_box(value):
    """A non-finite or huge divergence on one water cell: its c2e is past
    the guard, every box is live, and the march is the dense one."""
    at = (15, 20, 20)
    plan, live = check(SHAPE, compact_water(SHAPE), 7, 3,
                       div_at=[(at, value)])
    assert live == list(range(len(boxes_of(plan.passes[0]))))


def test_guard_rule():
    """The guard's other cases: a q0 past the limit where the code is > 0,
    a -0.0 c2e where the code is 0, and LIVE_MAX_SWEEPS sweeps list every
    box; a c2e at the limit, or a q0 past it where the code is 0 (where
    K2f's q0 is c2e), does not."""
    t = compact_water(SHAPE)
    q0, code, c2e = fold(t, 3, 1.0)
    p = tiling.jacobi_plan(SHAPE, 7, sms=3).passes[0]
    total = len(boxes_of(p))
    some = tiling.live_boxes(p, q0, code, c2e, 7)
    assert 0 < len(some) < total
    assert tiling.live_boxes(p, q0, code, c2e,
                             tiling.LIVE_MAX_SWEEPS) == list(range(total))
    assert tiling.live_boxes(p, q0, code, c2e,
                             tiling.LIVE_MAX_SWEEPS - 1) == some
    huge = q0.clone()
    huge[15, 20, 20] = 2.0 ** 101
    assert int(code[15, 20, 20]) > 0
    assert tiling.live_boxes(p, huge, code, c2e, 7) == list(range(total))
    huge = q0.clone()
    huge[1, 1, 1] = float("nan")
    assert tiling.live_boxes(p, huge, code, c2e, 7) == some
    neg = c2e.clone()
    neg[1, 1, 1] = -0.0
    assert int(code[1, 1, 1]) == 0
    assert tiling.live_boxes(p, q0, code, neg, 7) == list(range(total))
    edge = c2e.clone()
    edge[1, 1, 1] = -tiling.LIVE_LIMIT
    assert tiling.live_boxes(p, q0, code, edge, 7) == some


def test_negative_zero_c2e_needs_the_guard():
    """Why a -0.0 c2e where the code is 0 makes every box live: a sweep
    gives such a cell 0 * sum + -0.0, +0.0 for a positive sum, so it does
    not keep its c2e."""
    q0, code, c2e = fold(walled(SHAPE), 3, -0.0)
    c2e = torch.where(code == 0, -0.0, c2e)
    q = jacobi_sweeps_plain(q0, code, c2e, 1)
    assert torch.equal(q, c2e) and not torch.equal(bits(q), bits(c2e))


@pytest.mark.parametrize("sms", (132, 114, 3))
@pytest.mark.parametrize("shape", [(128,) * 3, (256,) * 3, (512,) * 3,
                                   (37, 45, 29), (200, 96, 300)])
def test_all_live_costs_no_more_than_the_dense_launch(shape, sms):
    """With every box live a listed pass takes ceil(boxes / sms) rounds of
    seg + 2K planes: no more than the dense launch's waves of its
    segments (`segment_rows`, one block a box)."""
    p = tiling.jacobi_plan(shape, 199, sms=sms).passes[0]
    tz, ty = p.tiles
    boxes = p.n_blocks
    assert boxes == len(boxes_of(p))
    rounds = -(-boxes // sms)
    dense = tiling.segment_rows(shape[0], K, tz * ty, sms)
    waves = -(-(tz * ty * -(-shape[0] // dense)) // sms)
    assert rounds * (p.seg + 2 * K) <= waves * (dense + 2 * K)
    assert p.seg <= dense


def test_only_the_single_device_solve_is_listed():
    assert tiling.jacobi_plan((256,) * 3, 199).listed
    assert not tiling.jacobi_plan((20,) * 3, 199).listed
    assert not tiling.jacobi_plan((80, 256, 256), 8, halo=8).listed
    p = tiling.jacobi_plan((256,) * 3, 199).passes
    assert [q.levels for q in p] == [K] * 49 + [3]
    assert {(q.halo, q.seg, q.tiles) for q in p} == {(K, 37, (5, 11))}


# ------------------------------------------------------------------ on card
N_ITERS = 199             # the fountain's solve: jacobi_iters - 1 sweeps
LATER_STEPS = 300


def card_sms() -> int:
    from tpu_fluid_torch.kernels import build
    return build.sm_count(0)


@pytest.fixture(scope="module")
def fountain_solves():
    """The single-device solve inputs (q0, code, c2e) of fountain-256's
    step from the seeded state and from the state LATER_STEPS steps on,
    recorded from eager steps on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled and run "
                    "only there")
    from tpu_fluid_torch import FluidConfig, initial_state, jit_step, step
    from tpu_fluid_torch.kernels import jacobi
    from tpu_fluid_torch.stages import pressure
    cfg = FluidConfig.scaled_scene(256, particle_count=2_000_000)
    seen = []

    def record(q0, code, c2e, n_iters):
        seen.append((q0.clone(), code.clone(), c2e.clone()))
        return jacobi.jacobi_sweeps_cuda(q0, code, c2e, n_iters)

    def recorded_step(state):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pressure, "jacobi_sweeps_cuda", record)
            return step(state, cfg)

    state = recorded_step(initial_state(cfg, torch.device("cuda", 0)))
    for _ in range(LATER_STEPS - 1):
        state = jit_step(state, cfg)
    recorded_step(state)
    torch.cuda.synchronize()
    return {"seeded": seen[0], "later": seen[-1]}


def synthetic_solve(kind: str, device):
    """all_water, no_water or non_finite (the fountain's cube of water
    with NaN and infinite divergences) inputs at 256^3, folded on the
    card."""
    shape = (256,) * 3
    t = walled(shape, CellType.WATER if kind == "all_water"
               else CellType.AIR)
    if kind == "non_finite":
        t[64:192, 26:154, 19:45] = CellType.WATER
    r = np.random.default_rng(11)
    div = (r.standard_normal(shape) * 50).astype(np.float32)
    if kind == "non_finite":
        div[100, 100, 30], div[120, 60, 20] = np.nan, np.inf
        div[150, 140, 40] = -np.inf
    return jacobi_fold_plain(T(t).to(device), T(div).to(device), 1.0, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["seeded", "later", "all_water",
                                  "no_water", "non_finite"])
def test_cuda_listed_solve_equals_plain_at_256(fountain_solves, case):
    """The listed solve at fountain-256's shape and sweeps, bitwise (a NaN
    matching a NaN); its device list is the plain rule's, all boxes where
    the guard fails."""
    from tpu_fluid_torch.kernels.jacobi import (jacobi_sweeps_cuda,
                                                live_boxes_cuda)
    device = torch.device("cuda", 0)
    q0, code, c2e = (fountain_solves[case] if case in fountain_solves
                     else synthetic_solve(case, device))
    got = jacobi_sweeps_cuda(q0, code, c2e, N_ITERS)
    want = jacobi_sweeps_plain(q0, code, c2e, N_ITERS)
    listed = live_boxes_cuda(q0, code, c2e, N_ITERS).tolist()
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(bits(torch.where(nan, 0.0, got)),
                       bits(torch.where(nan, 0.0, want)))
    p = tiling.jacobi_plan(q0.shape, N_ITERS, sms=card_sms()).passes[0]
    assert listed == tiling.live_boxes(p, q0, code, c2e, N_ITERS)
    total = len(boxes_of(p))
    if case in ("all_water", "non_finite"):
        assert listed == list(range(total))
    elif case == "no_water":
        assert listed == []
    else:
        assert 0 < len(listed) < total


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["compact", "pockets", "random"])
def test_cuda_listed_solve_equals_plain_at_odd_shapes(case):
    """The CPU tests' fields on the card, at z sizes that are not a
    multiple of 4 (the list scan's one-cell loads): the solve bitwise, the
    device list the plain rule's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled and run "
                    "only there")
    from tpu_fluid_torch.kernels.jacobi import (jacobi_sweeps_cuda,
                                                live_boxes_cuda)
    device = torch.device("cuda", 0)
    shape = (37, 45, 29) if case == "random" else SHAPE
    types = {"compact": compact_water(SHAPE),
             "random": random_types(np.random.default_rng(5), shape)}.get(
        case)
    if types is None:
        types = walled(SHAPE)
        types[29:32, 39:42, 59:62] = CellType.SOLID
        types[30, 40, 60] = CellType.WATER
        types[5:8, 5:9, 5:9] = CellType.WATER
    q0, code, c2e = (a.to(device) for a in fold(types, 3, 1.0))
    for n_iters in (7, N_ITERS):
        got = jacobi_sweeps_cuda(q0, code, c2e, n_iters)
        listed = live_boxes_cuda(q0, code, c2e, n_iters).tolist()
        want = jacobi_sweeps_plain(q0, code, c2e, n_iters)
        assert torch.equal(bits(got), bits(want))
        p = tiling.jacobi_plan(shape, n_iters, sms=card_sms()).passes[0]
        assert listed == tiling.live_boxes(p, q0, code, c2e, n_iters)


@pytest.mark.cuda
def test_cuda_solve_counts_live_boxes_under_tracing(fountain_solves):
    """Under tracing a solve adds its live boxes (on the device) and all
    its boxes to `jacobi.live_boxes` and `jacobi.boxes`; untraced, it
    records nothing."""
    from tpu_fluid_torch.kernels.jacobi import (jacobi_sweeps_cuda,
                                                live_boxes_cuda)
    from tpu_fluid_torch.utils import profiling
    q0, code, c2e = fountain_solves["seeded"]
    live = len(live_boxes_cuda(q0, code, c2e, N_ITERS))
    total = tiling.jacobi_plan(q0.shape, N_ITERS,
                               sms=card_sms()).passes[0].n_blocks
    profiling.reset()
    jacobi_sweeps_cuda(q0, code, c2e, N_ITERS)
    assert "jacobi.live_boxes" not in profiling.report()
    profiling.tracing(True)
    try:
        for _ in range(2):
            jacobi_sweeps_cuda(q0, code, c2e, N_ITERS)
        rep = profiling.report()
    finally:
        profiling.tracing(False)
        profiling.reset()
    assert rep["jacobi.live_boxes"]["count"] == 2 * live
    assert rep["jacobi.live_boxes"]["calls"] == 2
    assert rep["jacobi.boxes"]["count"] == 2 * total
