"""The launch plans of the marching kernels (`kernels/tiling.py`): K2's
routes and passes, K5's launches and K1's, K6a's, K6b's and K6c's passes,
checked on the CPU before any card runs them.

A torch emulation follows a plan block by block, as the CUDA kernels do:
each block computes its levels from its own window (its output rows and
tile with `halo` planes and rings around them, clipped to the grid, zero
beyond the window) with the plain PyTorch arithmetic, and only its output
box is stitched into outputs that start as NaN.  That must equal the plain
version on the whole grid bitwise: a lead-in, halo, segment or remainder
that is one short leaves a stale ring or a NaN in the result.  The
geometry is what the kernels are given (`Pass.blocks` lists each block's
box as the kernel derives it from its block index)."""

import dataclasses
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_grid_fused import sparse_occupancy
from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.state import initial_state, state_from_numpy
from tpu_fluid_torch.kernels import tiling
from tpu_fluid_torch.kernels.advect import (advect_from_types_halo_plain,
                                            advect_from_types_plain)
from tpu_fluid_torch.kernels.grid_fused import (
    classify_extrap_halo_plain, classify_extrap_plain,
    forces_solids_div_halo_plain, forces_solids_div_plain,
    project_halo_plain, project_plain)
from tpu_fluid_torch.kernels.jacobi import (jacobi_fold_plain,
                                            jacobi_pass_plain,
                                            jacobi_sweeps_plain)
from tpu_fluid_torch.kernels.surface_fused import (_blur, _surface,
                                                   surface_fused_halo_plain,
                                                   surface_fused_plain)
from tpu_fluid_torch.parallel.mesh import make_mesh
from tpu_fluid_torch.stages.surface_fields import solid_parent_mask

torch.set_num_threads(2)
SMS = (132, 3)            # the card's count, and a few: more x segments
SHARDS = 4


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def random_types(r, shape):
    t = np.where(r.random(shape) < 0.4, 2, 0).astype(np.uint8)
    t[0], t[-1], t[:, 0], t[:, -1], t[:, :, 0], t[:, :, -1] = (3,) * 6
    t[(t == 0) & (r.random(shape) < 0.3)] = 1
    return t


def window(p: tiling.Pass, box, ring=None):
    """A block's input window: its box with `ring` = (below, above) planes
    and rings (p.halo a side by default), clipped to the input."""
    below, above = (p.halo, p.halo) if ring is None else ring
    return tuple(slice(max(lo - below, 0), min(hi + above, n))
                 for (lo, hi), n in zip(box, p.shape))


def stitch(p: tiling.Pass, outs, box, win, got):
    """Copy each result's box (window coordinates) into its output, whose
    row 0 is input row p.out_x0."""
    (x0, x1), (y0, y1), (z0, z1) = box
    wx, wy, wz = (w.start for w in win)
    for out, g in zip(outs, got):
        out[x0 - p.out_x0:x1 - p.out_x0, y0:y1, z0:z1] = \
            g[x0 - wx:x1 - wx, y0 - wy:y1 - wy, z0 - wz:z1 - wz]


def nan_like(a, rows):
    out = torch.empty((rows,) + tuple(a.shape[1:]), dtype=a.dtype)
    if a.dtype.is_floating_point:
        out.fill_(float("nan"))
    else:
        out.fill_(-1 if a.dtype != torch.uint8 else 255)
    return out


def out_rows(p: tiling.Pass) -> int:
    return p.shape[0] if p.out_x0 == 0 else p.xe - p.out_x0


# ------------------------------------------------------------------ K2
def emulate_jacobi(plan: tiling.Plan, q0, code, c2e, n_iters):
    """q0 after the plan's sweeps, every block from its own window."""
    if plan.route == "copy":
        return q0
    if plan.route == "whole":
        # one block, whose window is the grid
        return jacobi_pass_plain(q0, code, c2e, 0, n_iters)
    src = q0
    for p in plan.passes:
        dst = nan_like(q0, out_rows(p))
        for box in p.blocks():
            win = window(p, box)
            stitch(p, (dst,), box, win,
                   (jacobi_pass_plain(src[win], code[win], c2e[win], 0,
                                      p.levels),))
        src = dst
    return src


def jacobi_case(shape, seed):
    """(q0, code, c2e) of a random cell field: K2f's outputs, which every
    pass of a plan reads."""
    r = np.random.default_rng(seed)
    types = T(random_types(r, shape))
    div = T((r.standard_normal(shape) * 50).astype(np.float32))
    return jacobi_fold_plain(types, div, 1.0, 1.0)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n_iters", [0, 1, 5, 6, 7, "k+1"])
@pytest.mark.parametrize("shape", [(25, 20, 20), (13, 33, 31), (37, 45, 29),
                                   (7, 9, 130)])
def test_jacobi_blocked_plan_equals_plain(shape, n_iters, sms):
    """The blocked route at grids the one-block route cannot hold: 20^2
    planes with 13-row column chunks, an odd non-cubic grid with a
    1023-cell plane, one that needs several y tiles and one that needs
    several z tiles; the sweeps end in a remainder pass of 1, 2 or 3 where
    k does not divide them."""
    k = tiling.BLOCKED_K
    n = k + 1 if n_iters == "k+1" else n_iters
    q0, code, c2e = jacobi_case(shape, 1)
    plan = tiling.jacobi_plan(shape, n, sms=sms)
    assert tiling.whole_grid_parts(shape) is None
    if n:
        assert plan.route == "blocked"
        assert [p.levels for p in plan.passes] == \
            [k] * (n // k) + ([n % k] if n % k else [])
    got = emulate_jacobi(plan, q0, code, c2e, n)
    assert torch.equal(got, jacobi_sweeps_plain(q0, code, c2e, n))


@pytest.mark.parametrize("shape", [(20, 20, 20), (13, 22, 17)])
def test_jacobi_whole_route_takes_the_small_grids(shape):
    plan = tiling.jacobi_plan(shape, 199)
    assert plan.route == "whole" and plan.passes == () and plan.parts == 2
    q0, code, c2e = jacobi_case(shape, 4)
    assert torch.equal(emulate_jacobi(plan, q0, code, c2e, 9),
                       jacobi_sweeps_plain(q0, code, c2e, 9))
    assert tiling.jacobi_plan(shape, 0).route == "copy"
    assert tiling.jacobi_plan((40, 20, 20), 5).route == "blocked"
    for shape, parts in (((5, 10, 10), 5), ((30, 6, 5), 30),
                         ((24, 20, 20), 2), ((40, 10, 10), 10)):
        chunk = -(-shape[0] // parts)
        assert tiling.whole_grid_parts(shape) == parts
        assert (parts - 1) * chunk < shape[0] and chunk <= 12
    assert tiling.whole_grid_parts((25, 20, 20)) is None
    assert tiling.whole_grid_parts((4, 40, 40)) is None


@pytest.mark.parametrize("n", [128, 256])
def test_jacobi_large_grids_run_k_sweeps_a_launch(n):
    plan = tiling.jacobi_plan((n, n, n), 199)
    k = tiling.BLOCKED_K
    assert plan.route == "blocked" and k >= 2
    assert len(plan.passes) == -(-199 // k)
    assert sum(p.levels for p in plan.passes) == 199
    p = plan.passes[0]
    assert p.inner_y == tiling.TILE - 2 * k
    assert p.inner_z == tiling.PAIR_TILE_Z - 2 * k
    assert all(q.xs == 0 and q.xe == n for q in plan.passes)


def sharded_slab(shape, shard, h, seed):
    """Shard `shard` of SHARDS of a folded solve's inputs, extended by h
    planes a side, zero planes with code 0 past the domain."""
    q0, code, c2e = jacobi_case(shape, seed)
    lx = shape[0] // SHARDS
    rows = np.arange(shard * lx - h, (shard + 1) * lx + h)
    inside = T((rows >= 0) & (rows < shape[0]))
    idx = T(np.clip(rows, 0, shape[0] - 1))
    return [torch.where(inside[:, None, None], a[idx],
                        torch.zeros_like(a[idx])) for a in (q0, code, c2e)]


@pytest.mark.parametrize("shard", [0, 1, 3])
@pytest.mark.parametrize("h,kk", [(3, 1), (3, 3), (8, 5), (10, 10)])
def test_jacobi_pass_plan_equals_plain(shard, h, kk):
    """The sharded pass at the first, a middle and the last of 4 shards of
    a (32, 22, 17) grid; 5 and 10 sweeps need 2 and 3 launches of at most
    BLOCKED_K."""
    q, code, c2e = sharded_slab((32, 22, 17), shard, h, 2 + shard)
    plan = tiling.jacobi_plan(q.shape, kk, halo=h, sms=3)
    assert len(plan.passes) == -(-kk // tiling.BLOCKED_K)
    assert plan.passes[-1].xs == h and plan.passes[-1].out_x0 == h
    got = emulate_jacobi(plan, q, code, c2e, kk)
    assert torch.equal(got, jacobi_pass_plain(q, code, c2e, h, kk))


def test_jacobi_plan_rejects_what_no_kernel_runs():
    with pytest.raises(ValueError):
        tiling.jacobi_plan((10, 8, 8), 4, halo=3)
    with pytest.raises(ValueError):
        tiling.jacobi_plan((10, 8, 8), 6, halo=5)


# ------------------------------------------------------------------ K5
def surface_kw(cfg, steps):
    return dict(steps=steps, k=cfg.float_density_diffuse_coefficient,
                inc_filled=cfg.inertia_increase_filled,
                inc_neigh=cfg.inertia_increase_neighbour,
                required_hits=cfg.inertia_required_neighbour_hits,
                dec=cfg.inertia_decrease, max_inertia=cfg.max_inertia,
                div_coef=cfg.float_density_division_coefficient)


def emulate_surface(plan, fields, xb, gx, h, kw):
    """(inertia', f1', f2') of K5's launches `plan` on `fields` (the rows of
    each input; row 0 at global x xb of a domain gx rows wide, h halo
    planes a side): the first launch from (occ, inertia, f2, skip), each
    later one blur passes only from the (f1, f2) pair of the one before."""
    skip, x0 = fields[3], 0
    for i, p in enumerate(plan):
        f = fields[2] if i == 0 else fields[0]
        outs = [nan_like(f, out_rows(p)), nan_like(f, out_rows(p))]
        if i == 0:
            outs.insert(0, nan_like(fields[1], out_rows(p)))
            first = p
        for box in p.blocks():
            win = window(p, box)
            rows = torch.arange(win[0].start, win[0].stop) + xb + x0
            in_dom = ((rows >= 0) & (rows < gx)).reshape(-1, 1, 1)
            if i == 0:
                got = _surface(*(a[win] for a in fields), in_dom,
                               **dict(kw, steps=p.levels))
            else:
                got = _blur(fields[0][win], fields[1][win],
                            skip[x0:][win], in_dom, p.levels, kw["k"])
            stitch(p, outs, box, win, got)
        if i == 0:
            inertia, outs = outs[0], outs[1:]
        fields = outs
        x0 += p.xs
    lo = h - first.xs
    return (inertia[lo:lo + inertia.shape[0] - 2 * lo],) + tuple(fields)


def surface_case(shape, inertia_dtype, seed):
    cfg = FluidConfig()
    if inertia_dtype == np.int32:
        cfg = cfg.replace(max_inertia=300)
    r = np.random.default_rng(seed)
    occ = (r.random(shape) < 0.3).astype(np.uint8)
    inertia = r.integers(0, cfg.max_inertia + 1, shape).astype(inertia_dtype)
    f2 = r.normal(size=shape).astype(np.float32)
    skip = (r.random(shape) < 0.2).astype(np.uint8)
    return cfg, [T(occ), T(inertia), T(f2), T(skip)]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("inertia_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("steps", [0, 1, 2, 4, 6, 12])
@pytest.mark.parametrize("shape", [(20, 20, 20), (13, 22, 17),
                                   (13, 22, 70)])
def test_surface_plan_equals_plain(shape, steps, inertia_dtype, sms):
    """Up to 8 blur passes in one launch; 12 in a second launch of blur
    passes only."""
    cfg, fields = surface_case(shape, inertia_dtype, 3 + steps)
    kw = surface_kw(cfg, steps)
    plan = tiling.surface_plan(shape, steps, sms=sms)
    assert [p.levels for p in plan] == ([steps] if steps <= 8 else [8, 4])
    assert all(p.halo == p.levels + 1 and (p.xs, p.xe) == (0, shape[0])
               for p in plan)
    got = emulate_surface(plan, fields, 0, shape[0], 0, kw)
    want = surface_fused_plain(*fields, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("shard", [0, 1, 3])
@pytest.mark.parametrize("inertia_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("steps", [0, 1, 4, 12])
def test_surface_halo_plan_equals_plain(steps, inertia_dtype, shard):
    """The halo form at the first, a middle and the last of 4 detailed
    slabs of (40, 22, 17), with steps + 1 neighbour planes a side (zeros
    past the domain) and the skip mask of a solid-parent field; 12 blur
    passes take two launches, the first writing the rows the second
    reads."""
    shape = (40, 22, 17)
    cfg, fields = surface_case(shape, inertia_dtype, 7 + shard)
    types = np.random.default_rng(shard).integers(0, 4, (20, 11, 9))
    fields[3] = solid_parent_mask(T(types.astype(np.uint8)),
                                  cfg.replace(surface_render_resolution=2)
                                  )[:, :22, :17].to(torch.uint8).contiguous()
    kw = surface_kw(cfg, steps)
    h, lx = steps + 1, shape[0] // SHARDS
    x0 = shard * lx
    rows = np.arange(x0 - h, x0 + lx + h)
    inside = T((rows >= 0) & (rows < shape[0]))[:, None, None]
    idx = T(np.clip(rows, 0, shape[0] - 1))
    ext = [torch.where(inside, a[idx], torch.zeros_like(a[idx]))
           for a in fields]
    plan = tiling.surface_plan(ext[0].shape, steps, halo=h, sms=3)
    assert len(plan) == (1 if steps <= 8 else 2)
    assert plan[-1].xe - plan[-1].xs == lx
    got = emulate_surface(plan, ext, x0 - h, shape[0], h, kw)
    want = surface_fused_halo_plain(
        *(a[h:h + lx] for a in ext), halos=tuple(
            (a[:h], a[h + lx:]) for a in ext), x0=x0, global_gx=shape[0],
        **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_surface_plan_chains_launches_beyond_max_levels():
    (p,) = tiling.surface_plan((100, 100, 100), 4)
    assert p.inner_y == p.inner_z == tiling.TILE - 10 and p.levels == 4
    plan = tiling.surface_plan((20, 20, 20), 2 * tiling.MAX_LEVELS + 1)
    assert [p.levels for p in plan] == [tiling.MAX_LEVELS] * 2 + [1]
    # halo form: each launch keeps the rows the rest still lose
    plan = tiling.surface_plan((60, 20, 20), 17, halo=18)
    assert [(p.shape[0], p.xs, p.xe) for p in plan] == \
        [(60, 9, 51), (42, 8, 34), (26, 1, 25)]
    with pytest.raises(ValueError):
        tiling.surface_plan((20, 20, 20), -1)
    with pytest.raises(ValueError):
        tiling.surface_plan((60, 20, 20), 4, halo=4)


# ------------------------------------------------------------------ K6
# K6a and K6b march one pass each.  Their emulation asks the converse of
# the stitching above: every input cell outside a block's window is
# replaced by a random value (out-of-domain rows of a halo slab stay zero,
# as the halo exchange delivers them), and the plain version's output
# must not change in the block's box.  A halo one plane or ring short
# leaves a cell of the box reading a replaced value.
K6_SHAPES = [(13, 22, 17), (37, 45, 29), (24, 24, 24)]


def scramble(a, win, rows_in_domain, rng, pool=1):
    """`a` ((X, Y, Z), or (3, X, Y, Z)) with every in-domain cell outside
    the window `win` (sim-grid slices; `pool` times finer for a detailed
    field) replaced by a random one of its values, so that a sparse
    occupancy stays sparse."""
    keep = torch.zeros(a.shape[-3:], dtype=torch.bool)
    keep[tuple(slice(w.start * pool, w.stop * pool) for w in win)] = True
    dom = rows_in_domain.repeat_interleave(pool).reshape(-1, 1, 1)
    noise = a.flatten()[T(rng.permutation(a.numel()))].reshape(a.shape)
    return torch.where(keep | ~dom, a, noise)


def k6_case(shape, seed):
    """Detailed-free K6 inputs on `shape` and a config with a solid box,
    extra forces and the fountain inside it, those cells wet."""
    r = np.random.default_rng(seed)
    gx, gy, gz = shape
    fountain = (gx // 2, gy - 3, gz // 2)
    force_cell = (gx // 3, gy // 2, gz // 3)
    cfg = FluidConfig(grid_size=shape, fountain_position=fountain,
                      solid_boxes=(((gx // 4, 2, 3),
                                    (gx // 2, gy // 2, gz - 4)),),
                      extra_forces=((force_cell, (40.0, 0.0, -25.0)),))
    types = random_types(r, shape)
    for cell in (fountain, force_cell):
        types[cell[0], cell[1] - 1:cell[1] + 1, cell[2]] = 2
    old = r.integers(0, 4, shape).astype(np.uint8)
    vel = (r.standard_normal((3,) + shape) * 3).astype(np.float32)
    return cfg, r, T(types), T(old), T(vel)


def check_k6_plan(p: tiling.Pass, fields, pools, run, rows_in_domain, rng,
                  rings=None):
    """For every block of `p`: scramble `fields` outside its window (each
    field's (below, above) ring of `rings`, p.halo a side by default) and
    compare `run(*fields)` (outputs whose row 0 is input row p.out_x0) in
    the block's box with the unscrambled result."""
    want = run(*fields)
    blocks = list(p.blocks())
    assert blocks and all(w.numel() for w in want)
    rings = rings or (None,) * len(fields)
    for box in blocks:
        got = run(*(scramble(a, window(p, box, ring), rows_in_domain, rng,
                             pool)
                    for a, pool, ring in zip(fields, pools, rings)))
        out = tuple(slice(lo - off, hi - off) for (lo, hi), off
                    in zip(box, (p.out_x0, 0, 0)))
        for g, w in zip(got, want):
            assert torch.equal(g[(...,) + out], w[(...,) + out]), box
    return want


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("pool", [1, 2, 3])
@pytest.mark.parametrize("shape", K6_SHAPES)
def test_classify_plan_blocks_see_their_windows(shape, pool, sms):
    """K6a at pools 1-3: the detailed occupancy is pool times finer."""
    cfg, r, _, old, vel = k6_case(shape, 11 + pool)
    occ = T(sparse_occupancy(r, shape, pool))
    p = tiling.grid_fused_pass(shape, tiling.CLASSIFY_HALO, sms=sms)
    assert (p.levels, p.halo, p.xs, p.xe, p.out_x0) == \
        (2, 2, 0, shape[0], 0)
    assert (p.inner_y, p.inner_z) == (tiling.TILE - 4,) * 2
    check_k6_plan(p, (occ, old, vel), (pool, 1, 1),
                  lambda *f: classify_extrap_plain(*f, cfg, pool=pool),
                  torch.ones(shape[0], dtype=torch.bool), r)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", K6_SHAPES)
def test_forces_plan_blocks_see_their_windows(shape, sms):
    cfg, r, types, _, vel = k6_case(shape, 21)
    p = tiling.grid_fused_pass(shape, tiling.FORCES_HALO, sms=sms)
    assert (p.levels, p.halo, p.xs, p.xe) == (2, 1, 0, shape[0])
    assert p.inner_y == tiling.TILE - 2
    check_k6_plan(p, (types, vel), (1, 1),
                  lambda *f: forces_solids_div_plain(*f, cfg),
                  torch.ones(shape[0], dtype=torch.bool), r)


def k6_halo_case(kind, shard, seed):
    """The extended slab of shard `shard` of SHARDS of a (40, 45, 29) grid
    (K6a: occupancy, old types, velocity; K6b: types, velocity) with the
    form's halo planes, zeros past the domain; the halo plain version as a
    function of the extended fields; and the slab's in-domain rows."""
    shape = (40, 45, 29)
    cfg, r, types, old, vel = k6_case(shape, seed)
    h = tiling.CLASSIFY_HALO if kind == "classify" else tiling.FORCES_HALO
    lx = shape[0] // SHARDS
    x0 = shard * lx
    rows = np.arange(x0 - h, x0 + lx + h)
    inside = T((rows >= 0) & (rows < shape[0]))
    idx = T(np.clip(rows, 0, shape[0] - 1))
    occ = T((r.random(shape) < 1 / 3).astype(np.uint8))
    fields = (occ, old, vel) if kind == "classify" else (types, vel)
    ext = [torch.where(inside.reshape(-1, 1, 1), a[..., idx, :, :],
                       torch.zeros_like(a[..., idx, :, :])) for a in fields]
    plain = (classify_extrap_halo_plain if kind == "classify"
             else forces_solids_div_halo_plain)

    def rows_of(a, lo, hi):
        return a[..., lo:hi, :, :].contiguous()

    def run(*e):
        return plain(*(rows_of(a, h, h + lx) for a in e), cfg,
                     halos=tuple((rows_of(a, 0, h), rows_of(a, h + lx, None))
                                 for a in e), x0=x0, global_gx=shape[0])
    p = tiling.grid_fused_pass(ext[0].shape[-3:], h, slab_halo=h, sms=3)
    assert (p.xs, p.xe, p.out_x0) == (h, h + lx, h)
    return p, ext, run, inside, r


@pytest.mark.parametrize("kind", ["classify", "forces"])
@pytest.mark.parametrize("shard", [0, 1, 3])
def test_k6_halo_plan_blocks_see_their_windows(kind, shard):
    """The halo forms at the first, a middle and the last of 4 slabs; the
    sharded step pools its slab before K6a, so K6a runs at pool 1."""
    p, ext, run, inside, r = k6_halo_case(kind, shard, 31 + shard)
    check_k6_plan(p, ext, (1,) * len(ext), run, inside, r)


# ------------------------------------------------------------------ K6c
# K6c reads the types and pressure of the cell below along each axis and
# the velocity of its own cell only: a block's window is its box with a
# low ring of the types and pressure and no ring of the velocity, and its
# tile has no halo.  (12, 40, 70) adds tiles along z.
PROJECT_RINGS = ((1, 0), (1, 0), (0, 0))
PROJECT_SHAPES = K6_SHAPES + [(12, 40, 70)]


def k6c_fields(shape, seed):
    """A config with a solid box, cell types with the solid border, and a
    pressure and velocity from a numpy seed."""
    cfg, r, types, _, _ = k6_case(shape, seed)
    p = T((r.standard_normal(shape) * 50).astype(np.float32))
    vel = T((r.standard_normal((3,) + shape) * 3).astype(np.float32))
    return cfg, r, (types, p, vel)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", PROJECT_SHAPES)
def test_project_plan_blocks_see_their_windows(shape, sms):
    cfg, r, fields = k6c_fields(shape, 41)
    p = tiling.project_pass(shape, sms=sms)
    assert (p.levels, p.halo, p.xs, p.xe, p.out_x0) == \
        (1, 0, 0, shape[0], 0)
    assert (p.inner_y, p.inner_z) == (tiling.PROJECT_ROWS,
                                      tiling.PROJECT_COLS)
    check_k6_plan(p, fields, (1, 1, 1),
                  lambda *f: (project_plain(*f, cfg),),
                  torch.ones(shape[0], dtype=torch.bool), r, PROJECT_RINGS)


@pytest.mark.parametrize("shard", [0, 1, 3])
def test_project_halo_plan_blocks_see_their_windows(shard):
    """The halo form at the first, a middle and the last of 4 slabs of
    (40, 45, 70).  The kernel runs the slab's own plan and reads the left
    planes of the types and pressure as the row before the slab's first:
    here that plan is shifted by the one left plane the extended fields
    hold, and the right planes and the velocity's lie outside every
    window."""
    shape = (40, 45, 70)
    cfg, r, fields = k6c_fields(shape, 71 + shard)
    lx = shape[0] // SHARDS
    x0 = shard * lx
    rows = np.arange(x0 - 1, x0 + lx + 1)
    inside = T((rows >= 0) & (rows < shape[0]))
    idx = T(np.clip(rows, 0, shape[0] - 1))
    ext = [torch.where(inside.reshape(-1, 1, 1), a[..., idx, :, :],
                       torch.zeros_like(a[..., idx, :, :])) for a in fields]

    def run(*e):
        return (project_halo_plain(
            *(a[..., 1:1 + lx, :, :].contiguous() for a in e), cfg,
            halos=tuple((a[..., :1, :, :].contiguous(),
                         a[..., 1 + lx:, :, :].contiguous()) for a in e),
            x0=x0, global_gx=shape[0]),)
    p = tiling.project_pass((lx,) + shape[1:], sms=3)
    assert (p.xs, p.xe, p.out_x0) == (0, lx, 0)
    shifted_plan = dataclasses.replace(p, shape=tuple(ext[0].shape), xs=1,
                                       xe=1 + lx, out_x0=1)
    (want,) = check_k6_plan(shifted_plan, ext, (1, 1, 1), run, inside, r,
                            PROJECT_RINGS)
    assert torch.equal(want, project_plain(*fields, cfg)[:, x0:x0 + lx])


def test_project_pass_matches_the_kernel():
    """The plan's tile is the kernel's; 256^3 marches 2 segments of 128
    rows, a 64-row slab 2 of 32: one wave of blocks, not one plane a
    block."""
    src = (Path(tiling.__file__).parents[1] / "csrc" / "grid_fused.cu"
           ).read_text()
    assert f"constexpr int kProjectCols = {tiling.PROJECT_COLS};" in src
    assert "kProjectRows = kTilePlane / kProjectCols;" in src
    assert tiling.PROJECT_ROWS * tiling.PROJECT_COLS == tiling.TILE ** 2
    big = tiling.project_pass((256,) * 3)
    assert (big.tiles, big.seg, big.segments) == ((4, 16), 128, 2)
    slab = tiling.project_pass((64, 256, 256))
    assert (slab.seg, slab.segments) == (32, 2)


# ------------------------------------------------------------------ K1
# K1 marches K6's tiles with an R-cell ring (tiling.grid_fused_pass, halo
# R): its face averages and taps read velocity up to R cells away, its
# condition masks read the types of i + e_c, one cell above.  So the
# velocity is scrambled outside each block's R ring and the types outside
# the box grown by one cell upwards.
ADVECT_R = 2


def k1_rings(p: tiling.Pass):
    """(velocity ring, types ring) of a K1 block: the plan's halo a side,
    and one cell above."""
    return (p.halo, p.halo), (0, 1)


def k1_case(shape, seed):
    r = np.random.default_rng(seed)
    vel = T((r.standard_normal((3,) + shape) * 60).astype(np.float32))
    return r, vel, T(random_types(r, shape))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", K6_SHAPES)
def test_advect_plan_blocks_see_their_windows(shape, sms):
    r, vel, types = k1_case(shape, 51)
    p = tiling.grid_fused_pass(shape, ADVECT_R, sms=sms)
    assert (p.halo, p.xs, p.xe, p.out_x0) == (ADVECT_R, 0, shape[0], 0)
    assert (p.inner_y, p.inner_z) == (tiling.TILE - 2 * ADVECT_R,) * 2
    check_k6_plan(p, (vel, types), (1, 1),
                  lambda v, t: (advect_from_types_plain(v, t, ADVECT_R,
                                                        0.01),),
                  torch.ones(shape[0], dtype=torch.bool), r, k1_rings(p))


@pytest.mark.parametrize("shard", [0, 1, 3])
def test_advect_halo_plan_blocks_see_their_windows(shard):
    """K1's halo form at the first, a middle and the last of 4 slabs of
    (40, 45, 29): the velocity with R neighbour planes a side and the types
    with one, both held here in the velocity's rows (zeros past the
    domain)."""
    shape, h = (40, 45, 29), ADVECT_R
    r, vel, types = k1_case(shape, 61 + shard)
    lx = shape[0] // SHARDS
    x0 = shard * lx
    rows = np.arange(x0 - h, x0 + lx + h)
    inside = T((rows >= 0) & (rows < shape[0]))
    idx = T(np.clip(rows, 0, shape[0] - 1))
    ext = [torch.where(inside.reshape(-1, 1, 1), a[..., idx, :, :],
                       torch.zeros_like(a[..., idx, :, :]))
           for a in (vel, types)]

    def run(v, t):
        halo = (v[:, :h].contiguous(), v[:, h + lx:].contiguous())
        return (advect_from_types_halo_plain(
            v[:, h:h + lx].contiguous(), t[h - 1:h + lx + 1].contiguous(),
            ADVECT_R, 0.01, halo, x0, shape),)
    p = tiling.grid_fused_pass(ext[1].shape, h, slab_halo=h, sms=3)
    assert (p.xs, p.xe, p.out_x0) == (h, h + lx, h)
    want = check_k6_plan(p, ext, (1, 1), run, inside, r, k1_rings(p))
    single = advect_from_types_plain(vel, types, ADVECT_R, 0.01)
    assert torch.equal(want[0], single[:, x0:x0 + lx])


def test_k6_passes_fill_the_card():
    """256^3: K6a's 10 x 10 and K6b's 9 x 9 tiles are fewer than the SMs,
    so each cuts x into segments."""
    a = tiling.grid_fused_pass((256,) * 3, tiling.CLASSIFY_HALO)
    b = tiling.grid_fused_pass((256,) * 3, tiling.FORCES_HALO)
    assert a.tiles == (10, 10) and b.tiles == (9, 9)
    assert a.segments > 1 and b.segments > 1
    assert a.seg * a.segments >= 256 and b.seg * b.segments >= 256
    with pytest.raises(ValueError):
        tiling.grid_fused_pass((4, 8, 8), 2, slab_halo=2)


def test_segments_fill_the_card():
    """Few tiles get many x segments, many tiles few; every row is in
    exactly one segment."""
    assert tiling.segment_rows(20, 4, 1, 132) == 1
    assert tiling.segment_rows(256, 4, 121, 132) == 256
    for rows, halo, tiles, sms in ((128, 4, 36, 132), (512, 5, 576, 132),
                                   (7, 3, 2, 3)):
        seg = tiling.segment_rows(rows, halo, tiles, sms)
        assert 1 <= seg <= rows


# ------------------------------------------------------- entry points
def test_entry_points_default_to_the_card():
    """initial_state, state_from_numpy and make_mesh put tensors on the
    card unless the caller passes device="cpu"."""
    for fn in (initial_state, state_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(make_mesh).parameters["device"].default == \
        "cuda"
    mesh = make_mesh(1, device="cpu")
    assert mesh.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            make_mesh(1)
