"""The halo forms of the port's kernels, which the x-slab multi-device step
runs: each plain version against the JAX package's Pallas kernel in the
Pallas interpreter, called directly with explicit neighbour planes (zeros
past the domain), `x0` and the global extent, at the first, a middle and
the last of three shards; and against the port's single-device plain
version on the same rows, bitwise.  K3+K4's local-slab form, which
domain-sharded particles run, is held against JAX's table and
`sample_and_move` on a numpy-built edge-replicated slab, stragglers
included.  On a CUDA card only (marked `cuda`), each halo-form CUDA kernel
against its plain version, bitwise (K6a, K6b and K6c also at every shard
of an odd grid, and on 192-row slabs of 768^2 planes, the 768^3 cell's).  K6c's halo form reads no right halo plane and no
velocity plane: NaN there leaves its result as it was, on the CPU and on
the card.

`jacobi_sweeps_sharded`, whose passes exchange planes with the neighbours,
is held against JAX under shard_map in tests/test_torch_spmd.py.

Integer results must be equal.  f32 results allow 1 ULP of the field's
scale against JAX (2 for K5's blurred fields, as tests/test_torch_kernels.py
allows): XLA:CPU may contract a*b+c into one fused multiply-add inside the
interpreted kernel, where the plain version rounds twice."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid.kernels.advect import (advect_all_pallas,
                                      advect_component_pallas,
                                      advect_one_pallas)
from tpu_fluid.kernels.grid_fused import (classify_extrap_pallas,
                                          forces_solids_div_pallas,
                                          project_pallas)
from tpu_fluid.kernels.pack_table import build_packed_table_pallas
from tpu_fluid.kernels.particle_sample import sample_and_move
from tpu_fluid.kernels.surface_fused import (surface_fused_auto,
                                             surface_fused_pallas)
from tpu_fluid.stages.velocity import _advect_condition as jax_advect_condition
from tpu_fluid.stages.velocity import face_center_velocity as jax_face_center
from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.kernels.advect import (advect_all_halo_cuda,
                                            advect_all_halo_plain,
                                            advect_all_plain,
                                            advect_conditions,
                                            advect_from_types_halo_plain,
                                            advect_from_types_plain)
from tpu_fluid_torch.kernels.grid_fused import (
    classify_extrap_halo_cuda, classify_extrap_halo_plain,
    classify_extrap_plain, forces_solids_div_halo_cuda,
    forces_solids_div_halo_plain, forces_solids_div_plain, project_halo_cuda,
    project_halo_plain, project_plain)
from tpu_fluid_torch.kernels.jacobi import (jacobi_fold_plain,
                                            jacobi_pass_cuda,
                                            jacobi_pass_plain,
                                            jacobi_sweeps_plain)
from tpu_fluid_torch.kernels.particle_move import (particle_move_local_cuda,
                                                   particle_move_local_plain,
                                                   particle_move_plain)
from tpu_fluid_torch.kernels.surface_fused import (surface_fused_halo_cuda,
                                                   surface_fused_halo_plain,
                                                   surface_fused_plain)
from tpu_fluid_torch.stages.surface_fields import solid_parent_mask

torch.set_num_threads(2)
EPS = np.finfo(np.float32).eps
N_SHARDS = 3
SHARDS = [0, 1, 2]                      # first, middle, last
GRID = (24, 10, 12)                     # 8-row slabs
ADVECT_GRID = (12, 6, 8)                # 4-row slabs: one interpreted block
BOXES = (((4, 3, 2), (11, 8, 6)),)      # across the first shard border
FORCES = (((8, 4, 3), (100.0, 0.0, -50.0)),
          ((16, 7, 6), (0.0, -30.0, 0.0)))


def T(a):
    return torch.from_numpy(np.array(a))


def same(got, want, ulp=0):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype
    if ulp == 0:
        np.testing.assert_array_equal(g, w)
    else:
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=ulp * EPS,
                                   atol=ulp * EPS * scale)


def slab(a, shard, n=N_SHARDS, h=0):
    """Rows of shard `shard` along dim ndim-3 with h planes a side, zeros
    past the domain: (local, (left, right)), numpy."""
    ax = a.ndim - 3
    lx = a.shape[ax] // n
    x0 = shard * lx
    pad = [(0, 0)] * a.ndim
    pad[ax] = (h, h)
    ap = np.pad(a, pad)
    take = lambda lo, hi: np.ascontiguousarray(        # noqa: E731
        np.take(ap, np.arange(lo + h, hi + h), axis=ax))
    return take(x0, x0 + lx), (take(x0 - h, x0), take(x0 + lx, x0 + lx + h))


def torch_halos(halos):
    return tuple((T(l), T(r)) for l, r in halos)


def jax_halos(halos):
    return tuple((jnp.asarray(l), jnp.asarray(r)) for l, r in halos)


def random_types(r, shape):
    t = np.where(r.random(shape) < 0.4, 2, 0).astype(np.uint8)
    t[0], t[-1], t[:, 0], t[:, -1], t[:, :, 0], t[:, :, -1] = (3,) * 6
    t[(t == 0) & (r.random(shape) < 0.3)] = 1
    return t


# ------------------------------------------------------------------ K1
def advect_case(seed=0):
    """Velocity with displacements up to R, and the advection conditions
    of a cell field with the solid border, as the step makes them."""
    r = np.random.default_rng(seed)
    vel = (r.standard_normal((3,) + ADVECT_GRID) * 80).astype(np.float32)
    types = random_types(r, ADVECT_GRID)
    return vel, advect_conditions(T(types)).numpy(), types


@pytest.mark.parametrize("shard", SHARDS)
def test_advect_halo_matches_advect_all_and_one_pallas(shard):
    vel, cond3, _ = advect_case()
    R, dt = 2, 0.01
    lx = ADVECT_GRID[0] // N_SHARDS
    v, halo = slab(vel, shard, h=R)
    c, _ = slab(cond3, shard)
    got = advect_all_halo_plain(T(v), T(c), R, dt, (T(halo[0]), T(halo[1])),
                                shard * lx, ADVECT_GRID)
    same(got, advect_all_plain(T(vel), T(cond3), R, dt)[
        :, shard * lx:(shard + 1) * lx])
    jhalo = (jnp.asarray(halo[0]), jnp.asarray(halo[1]))
    want = advect_all_pallas(jnp.asarray(v), jnp.asarray(c), R, dt,
                             halo=jhalo, x0=shard * lx,
                             global_shape=ADVECT_GRID, interpret=True)
    same(got, want, ulp=1)
    # one component a shard: the three shards cover all three
    comp = shard
    want = advect_one_pallas(jnp.asarray(v), jnp.asarray(c[comp]), comp, R,
                             dt, halo=jhalo, x0=shard * lx,
                             global_shape=ADVECT_GRID, interpret=True)
    same(got[comp], want, ulp=1)


@pytest.mark.parametrize("shard", SHARDS)
def test_advect_halo_covers_advect_component_pallas(shard):
    """advect_component_pallas's halo form, called directly with the
    displacement JAX's step computes from a 1-plane halo block; one
    component a shard."""
    vel, cond3, _ = advect_case(1)
    R, dt = 2, 0.01
    lx = ADVECT_GRID[0] // N_SHARDS
    v, halo = slab(vel, shard, h=R)
    c, _ = slab(cond3, shard)
    got = advect_all_halo_plain(T(v), T(c), R, dt, (T(halo[0]), T(halo[1])),
                                shard * lx, ADVECT_GRID)
    v1, (l1, r1) = slab(vel, shard, h=1)
    vel_e = jnp.asarray(np.concatenate([l1, v1, r1], axis=1))
    comp = shard
    u = -jax_face_center(vel_e, comp)[:, 1:-1] * dt
    _, hc = slab(vel[comp], shard, h=R)
    want = advect_component_pallas(
        jnp.asarray(v[comp]), u, jnp.asarray(c[comp]), R, tx=4,
        halo=(jnp.asarray(hc[0]), jnp.asarray(hc[1])), x0=shard * lx,
        global_shape=ADVECT_GRID, interpret=True)
    same(got[comp], want, ulp=1)


@pytest.mark.parametrize("shard", [0, 1, 3])
def test_advect_halo_from_types_matches_advect_all_pallas(shard):
    """K1's halo form with its condition masks taken in, from the slab's
    types with one neighbour plane a side, at the first, a middle and the
    last of 4 shards: against JAX's advect_all_pallas with `halo`, `x0` and
    `global_shape` given JAX's masks of the whole grid, and against the
    single-device route's rows bitwise."""
    grid, n = (16, 6, 8), 4
    r = np.random.default_rng(45 + shard)
    vel = (r.standard_normal((3,) + grid) * 80).astype(np.float32)
    types = random_types(r, grid)
    R, dt = 2, 0.01
    lx = grid[0] // n
    x0 = shard * lx
    v, halo = slab(vel, shard, n, h=R)
    t, (t_lo, t_hi) = slab(types, shard, n, h=1)
    types_e = np.concatenate([t_lo, t, t_hi])
    got = advect_from_types_halo_plain(T(v), T(types_e), R, dt,
                                       (T(halo[0]), T(halo[1])), x0, grid)
    same(got, advect_from_types_plain(T(vel), T(types), R, dt)[
        :, x0:x0 + lx])
    jcond = jnp.stack([jax_advect_condition(jnp.asarray(types), c)
                       for c in range(3)]).astype(jnp.uint8)[:, x0:x0 + lx]
    want = advect_all_pallas(jnp.asarray(v), jcond, R, dt,
                             halo=(jnp.asarray(halo[0]),
                                   jnp.asarray(halo[1])),
                             x0=x0, global_shape=grid, interpret=True)
    same(got, want, ulp=1)


# ------------------------------------------------------------------ K5
def surface_case(steps, seed):
    cfg = FluidConfig(grid_size=(GRID[0] // 2, 8, 7),
                      surface_render_resolution=2,
                      float_density_diffuse_steps=steps)
    r = np.random.default_rng(seed)
    d = cfg.detailed_size
    occ = (r.random(d) < 0.3).astype(np.uint8)
    inertia = r.integers(0, cfg.max_inertia + 1, d).astype(np.uint8)
    f2 = r.normal(size=d).astype(np.float32)
    types = r.integers(0, 4, cfg.grid_size).astype(np.uint8)
    skip = solid_parent_mask(T(types), cfg).to(torch.uint8).numpy()
    kw = dict(steps=steps, k=cfg.float_density_diffuse_coefficient,
              inc_filled=cfg.inertia_increase_filled,
              inc_neigh=cfg.inertia_increase_neighbour,
              required_hits=cfg.inertia_required_neighbour_hits,
              dec=cfg.inertia_decrease, max_inertia=cfg.max_inertia,
              div_coef=cfg.float_density_division_coefficient)
    return (occ, inertia, f2, skip), kw


@pytest.mark.parametrize("shard", SHARDS)
@pytest.mark.parametrize("steps", [0, 3])
def test_surface_halo_matches_surface_fused_pallas(steps, shard):
    fields, kw = surface_case(steps, 5 + steps)
    h, gx = steps + 1, fields[0].shape[0]
    lx = gx // N_SHARDS
    parts = [slab(a, shard, h=h) for a in fields]
    local = [T(p[0]) for p in parts]
    halos = [p[1] for p in parts]
    got = surface_fused_halo_plain(*local, halos=torch_halos(halos),
                                   x0=shard * lx, global_gx=gx, **kw)
    single = surface_fused_plain(*map(T, fields), **kw)
    for g, w in zip(got, single):
        same(g, w[shard * lx:(shard + 1) * lx])
    want = surface_fused_pallas(*(jnp.asarray(p[0]) for p in parts),
                                halos=jax_halos(halos), x0=shard * lx,
                                global_gx=gx, interpret=True, **kw)
    for g, w, ulp in zip(got, want, (0, 2, 2)):
        same(g, w, ulp=ulp)


@pytest.mark.parametrize("shard", SHARDS)
def test_surface_halo_covers_the_y_chunk_route(shard):
    """surface_fused_auto's route for planes above max_plane under
    sharding: y-chunks with h-wide overlaps, here forced by a small
    max_plane on a 16 x 14 detailed plane."""
    fields, kw = surface_case(2, 9)
    h, gx = 3, fields[0].shape[0]
    lx = gx // N_SHARDS
    parts = [slab(a, shard, h=h) for a in fields]
    got = surface_fused_halo_plain(*(T(p[0]) for p in parts),
                                   halos=torch_halos([p[1] for p in parts]),
                                   x0=shard * lx, global_gx=gx, **kw)
    want = surface_fused_auto(*(jnp.asarray(p[0]) for p in parts),
                              halos=jax_halos([p[1] for p in parts]),
                              x0=shard * lx, global_gx=gx, max_plane=120,
                              interpret=True, **kw)
    for g, w, ulp in zip(got, want, (0, 2, 2)):
        same(g, w, ulp=ulp)


# ------------------------------------------------------------------ K6
def configs(**kw):
    kw = dict(grid_size=GRID, **kw)
    return JaxConfig(**kw), FluidConfig(**kw)


def grid_case(seed):
    r = np.random.default_rng(seed)
    occ = (r.random(GRID) < 0.35).astype(np.uint8)
    old = r.integers(0, 4, GRID).astype(np.uint8)
    types = random_types(r, GRID)
    # the fountain and the extra-force cells wet, so their forces land
    types[12, 7:9, 6] = 2
    types[8, 3:5, 3], types[16, 6:8, 6] = 2, 2
    vel = (3.0 * r.standard_normal((3,) + GRID)).astype(np.float32)
    p = r.standard_normal(GRID).astype(np.float32)
    return occ, old, types, vel, p


def run_grid(kind, shard, jcfg, cfg, seed):
    """(port halo plain, port single-device rows, JAX interpret) of one K6
    kernel at one shard."""
    occ, old, types, vel, p = grid_case(seed)
    lx = GRID[0] // N_SHARDS
    rows = slice(shard * lx, (shard + 1) * lx)
    if kind == "classify":
        arrays, h, fns = (occ, old, vel), 2, (classify_extrap_halo_plain,
                                              classify_extrap_plain,
                                              classify_extrap_pallas)
    elif kind == "forces":
        arrays, h, fns = (types, vel), 1, (forces_solids_div_halo_plain,
                                           forces_solids_div_plain,
                                           forces_solids_div_pallas)
    else:
        arrays, h, fns = (types, p, vel), 1, (project_halo_plain,
                                              project_plain, project_pallas)
    parts = [slab(a, shard, h=h) for a in arrays]
    halo_fn, single_fn, jax_fn = fns
    got = halo_fn(*(T(q[0]) for q in parts), cfg,
                  halos=torch_halos([q[1] for q in parts]), x0=shard * lx,
                  global_gx=GRID[0])
    single = single_fn(*map(T, arrays), cfg)
    want = jax_fn(*(jnp.asarray(q[0]) for q in parts), jcfg,
                  halos=jax_halos([q[1] for q in parts]), x0=shard * lx,
                  global_gx=GRID[0], interpret=True)
    got = got if isinstance(got, tuple) else (got,)
    single = single if isinstance(single, tuple) else (single,)
    want = want if isinstance(want, tuple) else (want,)
    for g, s in zip(got, single):
        same(g, s[..., rows, :, :])
    return got, want


@pytest.mark.parametrize("shard", SHARDS)
def test_classify_extrap_halo_matches_pallas_interpret(shard):
    jcfg, cfg = configs(solid_boxes=BOXES)
    (got_t, got_v), (want_t, want_v) = run_grid("classify", shard, jcfg,
                                                cfg, 0)
    same(got_t, want_t)
    same(got_v, want_v, ulp=1)


@pytest.mark.parametrize("shard", SHARDS)
def test_forces_solids_div_halo_matches_pallas_interpret(shard):
    jcfg, cfg = configs(solid_boxes=BOXES, extra_forces=FORCES,
                        fountain_position=(12, 8, 6))
    (got_v, got_div), (want_v, want_div) = run_grid("forces", shard, jcfg,
                                                    cfg, 2)
    same(got_v, want_v, ulp=1)
    same(got_div, want_div, ulp=1)


@pytest.mark.parametrize("shard", SHARDS)
def test_project_halo_matches_pallas_interpret(shard):
    jcfg, cfg = configs(dt=0.013, fluid_density=0.7, cell_width=1.3)
    (got,), (want,) = run_grid("project", shard, jcfg, cfg, 3)
    same(got, want, ulp=1)


# ------------------------------------------------------------------ K2 pass
@pytest.mark.parametrize("shard", SHARDS)
def test_jacobi_pass_equals_single_device_rows(shard):
    """One pass of kk <= h sweeps on an h-extended slab gives the
    single-device rows after kk sweeps; past the domain the zero planes
    with code 0 act as the zero pad."""
    r = np.random.default_rng(11)
    types = T(random_types(r, GRID))
    rhs = T((r.standard_normal(GRID) * 50).astype(np.float32))
    q0, code, c2e = jacobi_fold_plain(types, rhs, 1.0, 1.0)
    lx = GRID[0] // N_SHARDS
    h = 4
    for kk in (1, 3, 4):
        ext = [torch.cat([T(q[1][0]), T(q[0]), T(q[1][1])]) for q in
               (slab(a.numpy(), shard, h=h) for a in (q0, code, c2e))]
        got = jacobi_pass_plain(*ext, h, kk)
        same(got, jacobi_sweeps_plain(q0, code, c2e, kk)[
            shard * lx:(shard + 1) * lx])


# ------------------------------------------------------------ K3+K4 local
def local_particle_case(shard, seed):
    """The edge-replicated slab (3, lx + 2, Y, Z) of a random velocity
    field at `shard`, built with numpy, and global positions: the shard's
    own particles, stragglers up to 3 rows past both slab ends and up to
    1.5 cells past every domain face, some inactive."""
    r = np.random.default_rng(seed)
    gx = GRID[0]
    lx = gx // N_SHARDS
    x0 = shard * lx
    vel = (r.standard_normal((3,) + GRID) * 4).astype(np.float32)
    rows = np.clip(np.arange(x0 - 1, x0 + lx + 1), 0, gx - 1)
    vel_e = np.ascontiguousarray(vel[:, rows])
    top = np.array(GRID, np.float32)
    own = r.random((600, 3)) * top
    own[:, 0] = x0 + r.random(600) * lx
    near = r.random((400, 3)) * top
    near[:, 0] = np.where(r.random(400) < 0.5, x0 - 3 * r.random(400),
                          x0 + lx + 3 * r.random(400))
    far = r.random((200, 3)) * (top + 3) - 1.5
    pos = np.concatenate([own, near, far]).astype(np.float32)
    act = r.random(len(pos)) < 0.9
    return vel, vel_e, pos, act, x0, lx


@pytest.mark.parametrize("shard", SHARDS)
def test_particle_move_local_matches_pallas_interpret(shard):
    """JAX's move_particles_local with its Pallas kernels
    (`tpu_fluid/parallel/particles_domain.py:139-151`): the table of the
    extended slab, the slab-local row, the global weights; stragglers
    included.  For the particles whose clipped cell lies in the slab, the
    single-device plain version's result, bitwise."""
    vel, vel_e, pos, act, x0, lx = local_particle_case(shard, 60 + shard)
    dt = 0.01
    got = particle_move_local_plain(T(vel_e), T(pos), T(act), dt, x0, GRID)
    j = jnp.clip(jnp.floor(jnp.asarray(pos)).astype(jnp.int32), 0,
                 jnp.array([g - 1 for g in GRID], dtype=jnp.int32))
    jx = jnp.clip(j[:, 0] - x0 + 1, 0, lx + 1)
    flat = jx * (GRID[1] * GRID[2]) + j[:, 1] * GRID[2] + j[:, 2]
    table = build_packed_table_pallas(jnp.asarray(vel_e), interpret=True)
    rows = jnp.take(table, flat, axis=0, mode="clip")
    want = sample_and_move(rows, jnp.asarray(pos).T, jnp.asarray(act), GRID,
                           dt, interpret=True).T
    same(got, want, ulp=1)
    cell_x = np.clip(np.floor(pos[:, 0]), 0, GRID[0] - 1)
    inside = (cell_x >= x0) & (cell_x < x0 + lx)
    assert 0 < inside.sum() < len(pos)
    single = particle_move_plain(T(vel), T(pos), T(act), dt)
    same(got[T(inside)], single[T(inside)].numpy())


# ------------------------------------------------------------------ on card
def halo_calls(device):
    """(halo-form wrapper, plain version, args, kwargs) at the middle and
    the last shard, K3+K4's local-slab form included."""
    dev = lambda a: T(a).to(device)                   # noqa: E731
    lx = GRID[0] // N_SHARDS
    calls = []
    for shard in (1, 2):
        x0 = shard * lx
        vel, _, types = advect_case(20 + shard)
        v, halo = slab(vel, shard, h=2)
        t, (t_lo, t_hi) = slab(types, shard, h=1)
        calls.append((advect_all_halo_cuda, advect_from_types_halo_plain,
                      (dev(v), dev(np.concatenate([t_lo, t, t_hi])), 2, 0.01,
                       (dev(halo[0]), dev(halo[1])),
                       shard * ADVECT_GRID[0] // N_SHARDS, ADVECT_GRID), {}))
        fields, kw = surface_case(3, 30 + shard)
        parts = [slab(a, shard, h=4) for a in fields]
        calls.append((surface_fused_halo_cuda, surface_fused_halo_plain,
                      tuple(dev(q[0]) for q in parts),
                      dict(halos=tuple((dev(q[1][0]), dev(q[1][1]))
                                       for q in parts),
                           x0=shard * fields[0].shape[0] // N_SHARDS,
                           global_gx=fields[0].shape[0], **kw)))
        _, cfg = configs(solid_boxes=BOXES, extra_forces=FORCES,
                         fountain_position=(12, 8, 6))
        occ, old, types, vel, p = grid_case(40 + shard)
        for wrapper, plain, arrays, h in (
                (classify_extrap_halo_cuda, classify_extrap_halo_plain,
                 (occ, old, vel), 2),
                (forces_solids_div_halo_cuda, forces_solids_div_halo_plain,
                 (types, vel), 1),
                (project_halo_cuda, project_halo_plain, (types, p, vel), 1)):
            parts = [slab(a, shard, h=h) for a in arrays]
            calls.append((wrapper, plain,
                          tuple(dev(q[0]) for q in parts) + (cfg,),
                          dict(halos=tuple((dev(q[1][0]), dev(q[1][1]))
                                           for q in parts),
                               x0=x0, global_gx=GRID[0])))
        r = np.random.default_rng(50 + shard)
        folded = jacobi_fold_plain(
            T(random_types(r, GRID)),
            T((r.standard_normal(GRID) * 50).astype(np.float32)), 1.0, 1.0)
        ext = [torch.cat([T(q[1][0]), T(q[0]), T(q[1][1])]).to(device)
               for q in (slab(a.numpy(), shard, h=3) for a in folded)]
        calls.append((jacobi_pass_cuda, jacobi_pass_plain,
                      tuple(ext) + (3, 3), {}))
        _, vel_e, pos, act, x0, _ = local_particle_case(shard, 70 + shard)
        calls.append((particle_move_local_cuda, particle_move_local_plain,
                      (dev(vel_e), dev(pos), dev(act), 0.01, x0, GRID), {}))
    # the first shard too, K5 with 0, 1 and 12 blur passes (12: a second
    # launch of blur passes only), and K2 passes of 5, 10 and 7 sweeps (2, 3
    # and 2 launches of at most 4)
    for shard, steps, h, kk in ((0, 0, 8, 5), (1, 1, 10, 10),
                                (2, 4, 10, 10), (2, 12, 8, 7)):
        fields, kw = surface_case(steps, 80 + shard)
        parts = [slab(a, shard, h=steps + 1) for a in fields]
        calls.append((surface_fused_halo_cuda, surface_fused_halo_plain,
                      tuple(dev(q[0]) for q in parts),
                      dict(halos=tuple((dev(q[1][0]), dev(q[1][1]))
                                       for q in parts),
                           x0=shard * fields[0].shape[0] // N_SHARDS,
                           global_gx=fields[0].shape[0], **kw)))
        r = np.random.default_rng(90 + shard)
        folded = jacobi_fold_plain(
            T(random_types(r, GRID)),
            T((r.standard_normal(GRID) * 50).astype(np.float32)), 1.0, 1.0)
        ext = [torch.cat([T(q[1][0]), T(q[0]), T(q[1][1])]).to(device)
               for q in (slab(a.numpy(), shard, h=h) for a in folded)]
        calls.append((jacobi_pass_cuda, jacobi_pass_plain,
                      tuple(ext) + (h, kk), {}))
    # K6a, K6b and K6c at every shard of an odd grid split 3 ways: 13-row
    # slabs, two tiles along y
    shape = ODD_GRID
    r = np.random.default_rng(100)
    cfg = FluidConfig(grid_size=shape, fountain_position=(19, 19, 8),
                      solid_boxes=(((10, 2, 3), (20, 11, 13)),),
                      extra_forces=(((12, 11, 5), (40.0, 0.0, -25.0)),))
    occ = (r.random(shape) < 0.35).astype(np.uint8)
    old = r.integers(0, 4, shape).astype(np.uint8)
    types = random_types(r, shape)
    types[19, 18:20, 8], types[12, 10:12, 5] = 2, 2
    vel = (3.0 * r.standard_normal((3,) + shape)).astype(np.float32)
    p = (50.0 * r.standard_normal(shape)).astype(np.float32)
    for shard in SHARDS:
        for wrapper, plain, arrays, h in (
                (classify_extrap_halo_cuda, classify_extrap_halo_plain,
                 (occ, old, vel), 2),
                (forces_solids_div_halo_cuda, forces_solids_div_halo_plain,
                 (types, vel), 1),
                (project_halo_cuda, project_halo_plain, (types, p, vel), 1)):
            parts = [slab(a, shard, h=h) for a in arrays]
            calls.append((wrapper, plain,
                          tuple(dev(q[0]) for q in parts) + (cfg,),
                          dict(halos=tuple((dev(q[1][0]), dev(q[1][1]))
                                           for q in parts),
                               x0=shard * shape[0] // N_SHARDS,
                               global_gx=shape[0])))
    return calls


ODD_GRID = (39, 45, 17)
N_HALO_CALLS = 31


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled and run "
                    "only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(N_HALO_CALLS))
def test_cuda_halo_kernel_matches_plain_bitwise(cuda_device, case):
    wrapper, plain, args, kw = halo_calls(cuda_device)[case]
    before = wrapper.launches
    got, want = wrapper(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.device == cuda_device and torch.equal(g, w)


def big_slab_call(device, kind, shard, n=768):
    """(wrapper, plain, args, kwargs) of one K6 halo form on rank `shard`'s
    slab of the 768^3 cell over 4 ranks: 192 rows of 768^2 planes, their
    halo planes zeros past the domain, so that flat offsets reach 3 x 196 x
    768^2 (about 347M).  Fields are drawn on the card."""
    ranks = 4
    lx = n // ranks
    x0 = shard * lx
    h = 2 if kind == "classify" else 1
    rows = lx + 2 * h
    shape = (rows, n, n)
    g = torch.Generator(device=device).manual_seed(110 + shard)
    rand = lambda: torch.rand(shape, generator=g, device=device)  # noqa: E731
    gx = torch.arange(x0 - h, x0 + lx + h, device=device)
    inside = ((gx >= 0) & (gx < n)).view(-1, 1, 1)
    types = torch.where(rand() < 0.4, 2, 0).to(torch.uint8)
    types[(gx == 0) | (gx == n - 1)] = 3
    types[:, 0], types[:, -1], types[:, :, 0], types[:, :, -1] = (3,) * 4
    types[(types == 0) & (rand() < 0.3)] = 1
    occ = (rand() < 0.35).to(torch.uint8)
    old = torch.randint(0, 4, shape, generator=g, device=device,
                        dtype=torch.uint8)
    vel = 3.0 * torch.randn((3,) + shape, generator=g, device=device)
    p = 50.0 * torch.randn(shape, generator=g, device=device)
    occ, old, types, p = (a * inside for a in (occ, old, types, p))
    vel = vel * inside
    cfg = FluidConfig.scaled_scene(n)
    wrapper, plain, arrays = {
        "classify": (classify_extrap_halo_cuda, classify_extrap_halo_plain,
                     (occ, old, vel)),
        "forces": (forces_solids_div_halo_cuda, forces_solids_div_halo_plain,
                   (types, vel)),
        "project": (project_halo_cuda, project_halo_plain,
                    (types, p, vel))}[kind]
    cut = lambda a, lo, hi: a[..., lo:hi, :, :].contiguous()  # noqa: E731
    return (wrapper, plain,
            tuple(cut(a, h, h + lx) for a in arrays) + (cfg,),
            dict(halos=tuple((cut(a, 0, h), cut(a, h + lx, rows))
                             for a in arrays),
                 x0=x0, global_gx=n))


@pytest.mark.cuda
@pytest.mark.parametrize("shard", [0, 2, 3])
@pytest.mark.parametrize("kind", ["classify", "forces", "project"])
def test_cuda_grid_halo_kernels_at_768_planes_match_plain_bitwise(
        cuda_device, kind, shard):
    """K6a-c's halo forms at the 768^3 cell's slab shape, where the gate
    runs them although JAX's plane limit would not: bitwise their plain
    versions, the fountain (rank 2) and both domain ends included."""
    wrapper, plain, args, kw = big_slab_call(cuda_device, kind, shard)
    before = wrapper.launches
    got = wrapper(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = plain(*args, **kw)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    for g, w in zip(got, want):
        assert g.device == cuda_device and torch.equal(g, w)


@pytest.mark.parametrize("case", range(N_HALO_CALLS))
def test_halo_wrapper_on_cpu_runs_plain_version_without_launch(case):
    wrapper, plain, args, kw = halo_calls("cpu")[case]
    before = wrapper.launches
    got, want = wrapper(*args, **kw), plain(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert wrapper.launches == before


def project_halo_unread(device, shard):
    """(K6c's halo-form arguments at `shard` with the right halo planes
    and both velocity halo planes replaced, the same with the true planes)
    at the odd grid: the right type plane all WATER, every replaced float
    NaN."""
    _, cfg = configs(dt=0.013, fluid_density=0.7, cell_width=1.3)
    r = np.random.default_rng(110 + shard)
    types = random_types(r, ODD_GRID)
    p = (50.0 * r.standard_normal(ODD_GRID)).astype(np.float32)
    vel = (3.0 * r.standard_normal((3,) + ODD_GRID)).astype(np.float32)
    parts = [slab(a, shard, h=1) for a in (types, p, vel)]
    dev = lambda a: T(a).to(device)                   # noqa: E731
    true = tuple((dev(q[1][0]), dev(q[1][1])) for q in parts)
    nan = lambda a: torch.full_like(a, float("nan"))  # noqa: E731
    (t_lo, t_hi), (p_lo, p_hi), (v_lo, v_hi) = true
    unread = ((t_lo, torch.full_like(t_hi, 2)), (p_lo, nan(p_hi)),
              (nan(v_lo), nan(v_hi)))
    args = tuple(dev(q[0]) for q in parts) + (cfg,)
    kw = dict(x0=shard * ODD_GRID[0] // N_SHARDS, global_gx=ODD_GRID[0])
    return args, dict(kw, halos=unread), dict(kw, halos=true)


@pytest.mark.parametrize("shard", SHARDS)
def test_project_halo_reads_no_right_or_velocity_plane(shard):
    """K6c's halo form reads only the left planes of the types and
    pressure: the plain version's result is the same whatever the right
    planes and the velocity planes hold."""
    args, unread, true = project_halo_unread("cpu", shard)
    assert torch.equal(project_halo_plain(*args, **unread),
                       project_halo_plain(*args, **true))


@pytest.mark.cuda
@pytest.mark.parametrize("shard", SHARDS)
def test_cuda_project_halo_reads_no_right_or_velocity_plane(cuda_device,
                                                             shard):
    args, unread, true = project_halo_unread(cuda_device, shard)
    got = project_halo_cuda(*args, **unread)
    torch.cuda.synchronize()
    assert torch.equal(got, project_halo_plain(*args, **true))
