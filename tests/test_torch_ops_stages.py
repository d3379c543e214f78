"""The PyTorch port's ops and stages against the JAX package's, one test
per stage (mirroring tests/test_stages.py and tests/test_occupancy.py):
the same numpy-seeded inputs go through both.

Integer, bool and u8 results must be equal.  f32 results are equal where
both sides round the same operations; a few stages allow a few ULP of the
result's scale, because XLA:CPU may contract a*b+c into one fused
multiply-add where PyTorch rounds twice (the same allowance as commit
5687bef in the JAX package's own tests)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid.ops import packed_sampler as jps
from tpu_fluid.ops import sampling as jsampling
from tpu_fluid.ops import stencil as jstencil
from tpu_fluid.stages import celltypes as jcell
from tpu_fluid.stages import particles as jparticles
from tpu_fluid.stages import pressure as jpressure
from tpu_fluid.stages import surface_fields as jsurface
from tpu_fluid.stages import velocity as jvel
from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.ops import packed_sampler as tps
from tpu_fluid_torch.ops import sampling as tsampling
from tpu_fluid_torch.ops import stencil as tstencil
from tpu_fluid_torch.stages import celltypes as tcell
from tpu_fluid_torch.stages import particles as tparticles
from tpu_fluid_torch.stages import pressure as tpressure
from tpu_fluid_torch.stages import surface_fields as tsurface
from tpu_fluid_torch.stages import velocity as tvel

torch.set_num_threads(2)

N = 10
KW = dict(grid_size=(N, N, N), particle_count=500,
          particle_init_cube_resolution=(8, 8, 8),
          particle_init_cube_offset=(2.0, 2.0, 2.0),
          particle_init_cube_size=(5.0, 5.0, 5.0),
          surface_render_resolution=2, jacobi_iters=30)
JCFG, TCFG = JaxConfig(**KW), FluidConfig(**KW)
EPS = np.finfo(np.float32).eps


def configs(**kw):
    return JaxConfig(**KW).replace(**kw), FluidConfig(**KW).replace(**kw)


def rng(seed):
    return np.random.default_rng(seed)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


def random_types(r, shape=(N, N, N)):
    dens = (r.random(shape) < 0.3).astype(np.int64)
    return oracle.update_air(oracle.update_water(dens)).astype(np.uint8)


def random_vel(r, shape=(N, N, N), scale=1.0):
    return (r.standard_normal((3,) + shape) * scale).astype(np.float32)


def same(got, want, ulp=0):
    """got (torch) equals want (jax) bitwise, or within `ulp` units of the
    f32 result's largest magnitude."""
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype,
                                                        w.shape, w.dtype)
    if ulp == 0:
        np.testing.assert_array_equal(g, w)
    else:
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=ulp * EPS,
                                   atol=ulp * EPS * scale)


# ------------------------------------------------------------------ ops
@pytest.mark.parametrize("offset", [(1, 0, 0), (0, -1, 0), (0, 0, 2),
                                    (-1, 1, -1), (0, 0, 0)])
def test_shifted(offset):
    a = rng(0).standard_normal((2, 5, 6, 7)).astype(np.float32)
    same(tstencil.shifted(T(a), offset), jstencil.shifted(J(a), offset))
    m = a[0] > 0
    same(tstencil.shifted(T(m), offset, fill=False),
         jstencil.shifted(J(m), offset, fill=False))


def test_neighbor_sum():
    a = rng(1).standard_normal((6, 5, 4)).astype(np.float32)
    same(tstencil.neighbor_sum(T(a)), jstencil.neighbor_sum(J(a)))


def test_velocity_at_clamp_to_edge():
    r = rng(2)
    vel = random_vel(r, (6, 9, 12))
    pos = (r.random((3000, 3)) * np.array([10, 13, 16]) - 2).astype(
        np.float32)
    same(tsampling.velocity_at(T(vel), T(pos)),
         jsampling.velocity_at(J(vel), J(pos)))


@pytest.mark.parametrize("offset", [(1, 0, 0), (0, -1, 1), (-1, -1, -1)])
def test_edge_shift(offset):
    a = rng(3).standard_normal((4, 5, 6)).astype(np.float32)
    same(tps._edge_shift(T(a), offset), jps._edge_shift(J(a), offset))


def test_packed_table_and_rows():
    r = rng(4)
    vel = random_vel(r, (6, 9, 12))
    pos = (r.random((2000, 3)) * np.array([8, 11, 14]) - 1).astype(
        np.float32)
    table = tps.build_packed_table(T(vel))
    same(table, jps.build_packed_table(J(vel)))
    same(tps.packed_row_indices(T(pos), (6, 9, 12)).to(torch.int32),
         jps.packed_row_indices(J(pos), (6, 9, 12)))
    assert [tps._lane(*a) for a in [(0, 0, -1, -1), (2, 1, 1, 1)]] == \
        [jps._lane(*a) for a in [(0, 0, -1, -1), (2, 1, 1, 1)]]
    # the 18-lane sums run in each framework's own reduction order
    same(tps.sample_velocity_packed(table, (6, 9, 12), T(pos)),
         jps.sample_velocity_packed(jps.build_packed_table(J(vel)),
                                    (6, 9, 12), J(pos)), ulp=4)


# ------------------------------------------------------------------ 01/15
def test_detailed_occupancy_heavy_duplication_and_oob():
    r = rng(7)
    heavy = np.full((5000, 3), 3.25, np.float32)
    spread = (r.random((400, 3)) * (N + 2) - 1.5).astype(np.float32)
    pos = np.concatenate([heavy, spread])
    act = r.random(len(pos)) < 0.9
    got = tparticles.detailed_occupancy(T(pos), T(act), TCFG)
    same(got, jparticles.detailed_occupancy(J(pos), J(act), JCFG))
    assert set(np.unique(got.numpy())) <= {0, 1}


def test_negative_coordinates_truncate_for_occupancy():
    """Particles in (-1, 0) truncate to cell 0 for occupancy."""
    pos = np.array([[-0.3, 1.0, 1.0], [1.0, -0.45, 1.0], [-1.2, 1, 1]],
                   np.float32)
    act = np.ones(3, bool)
    got = tparticles.detailed_occupancy(T(pos), T(act), TCFG)
    same(got, jparticles.detailed_occupancy(J(pos), J(act), JCFG))
    assert int(got.sum()) == 2


def test_occupancy_to_sim_grid():
    jcfg, tcfg = configs(surface_render_resolution=3)
    r = rng(8)
    pos = (r.random((4000, 3)) * N).astype(np.float32)
    act = np.ones(4000, bool)
    tocc = tparticles.detailed_occupancy(T(pos), T(act), tcfg)
    jocc = jparticles.detailed_occupancy(J(pos), J(act), jcfg)
    same(tparticles.occupancy_to_sim_grid(tocc, tcfg),
         jparticles.occupancy_to_sim_grid(jocc, jcfg))


# ------------------------------------------------------------------ 02/03
def test_update_water():
    r = rng(4)
    dens = ((r.random((N, N, N)) < 0.4) * r.integers(1, 5, (N, N, N))
            ).astype(np.uint8)
    same(tcell.update_water(T(dens)), jcell.update_water(J(dens)))


def test_update_air_with_obstacles():
    jcfg, tcfg = configs(solid_boxes=(((2, 3, 4), (5, 6, 7)),))
    t02 = oracle.update_water(
        (rng(5).random((N, N, N)) < 0.3).astype(np.int64)).astype(np.uint8)
    same(tcell.update_air(T(t02), tcfg), jcell.update_air(J(t02), jcfg))
    same(tcell.solid_mask((N, 7, 5), tcfg), jcell.solid_mask((N, 7, 5), jcfg))


# ------------------------------------------------------------------ 04/05
def test_compute_extrapolated():
    r = rng(6)
    types, vel = random_types(r), random_vel(r)
    same(tvel.compute_extrapolated_velocities(T(types), T(vel)),
         jvel.compute_extrapolated_velocities(J(types), J(vel)))


def test_set_extrapolated():
    old_t, new_t = random_types(rng(7)), random_types(rng(8))
    vel, ext = random_vel(rng(9)), random_vel(rng(10))
    same(tvel.set_extrapolated_velocities(T(old_t), T(new_t), T(vel), T(ext)),
         jvel.set_extrapolated_velocities(J(old_t), J(new_t), J(vel),
                                          J(ext)))


# ------------------------------------------------------------------ 07
def test_advect_condition_and_face_center_velocity():
    r = rng(11)
    types, vel = random_types(r), random_vel(r)
    for c in range(3):
        same(tvel.advect_condition(T(types), c),
             jvel._advect_condition(J(types), c))
        same(tvel.face_center_velocity(T(vel), c),
             jvel.face_center_velocity(J(vel), c))


@pytest.mark.parametrize("method,scale", [("shift", 2.0), ("shift", 150.0),
                                          ("gather", 2.0), ("auto", 3.0)])
def test_advect(method, scale):
    """auto takes the K1 route, whose CPU formulation is advect_shift."""
    jcfg, tcfg = configs(advect_method=method)
    r = rng(12)
    types, vel = random_types(r), random_vel(r, scale=scale)
    jmethod = "shift" if method == "auto" else method
    same(tvel.advect(T(types), T(vel), tcfg),
         jvel.advect(J(types), J(vel), jcfg.replace(advect_method=jmethod)))


# ------------------------------------------------------------------ 08-10
def test_forces_with_extra_forces():
    jcfg, tcfg = configs(extra_forces=(((3, 4, 5), (20.0, 0.0, -7.5)),))
    r = rng(13)
    types = random_types(r)
    types[jcfg.fountain] = CellType.WATER
    types[3, 4, 5] = CellType.WATER
    vel = random_vel(r)
    same(tvel.apply_forces(T(types), T(vel), tcfg),
         jvel.apply_forces(J(types), J(vel), jcfg))


@pytest.mark.parametrize("noop", [True, False])
def test_diffuse(noop):
    jcfg, tcfg = configs(reference_diffuse_noop=noop)
    r = rng(14)
    types, vel = random_types(r), random_vel(r)
    same(tvel.diffuse(T(types), T(vel), tcfg),
         jvel.diffuse(J(types), J(vel), jcfg))


def test_solids():
    r = rng(15)
    types, vel = random_types(r), random_vel(r, scale=0.02)
    same(tvel.apply_solids(T(types), T(vel), TCFG),
         jvel.apply_solids(J(types), J(vel), JCFG))


# ------------------------------------------------------------------ 11-13
def test_divergence_and_jacobi_stats():
    r = rng(16)
    types, vel = random_types(r), random_vel(r)
    same(tpressure.compute_divergence(T(vel)),
         jpressure.compute_divergence(J(vel)))
    for got, want in zip(tpressure.jacobi_stats(T(types), TCFG),
                         jpressure.jacobi_stats(J(types), JCFG)):
        same(got, want)


@pytest.mark.parametrize("parity", [True, False])
def test_jacobi_solve(parity):
    """The port solves in the kernel's folded form.  The JAX XLA loop
    divides (neigh + const) / aii where the fold multiplies by 1/aii and
    adds c2; the JAX kernel in the interpreter folds alike, but XLA:CPU may
    contract rd * sum + c2e.  Both stay within a few ULP."""
    jcfg, tcfg = configs(jacobi_iters=8, reference_pressure_parity=parity)
    r = rng(17)
    types = random_types(r)
    div = oracle.divergence(random_vel(r)).astype(np.float32)
    got = tpressure.jacobi_solve(T(types), T(div), tcfg)
    same(got, jpressure.jacobi_solve(J(types), J(div), jcfg), ulp=2)
    kernel_path = jpressure.jacobi_solve(J(types), J(div),
                                         jcfg.replace(pallas_mode="interpret"))
    same(got, kernel_path, ulp=1)


def test_pressure_project():
    r = rng(18)
    types, vel = random_types(r), random_vel(r)
    p = r.standard_normal((N, N, N)).astype(np.float32)
    same(tpressure.pressure_project(T(types), T(p), T(vel), TCFG),
         jpressure.pressure_project(J(types), J(p), J(vel), JCFG))


@pytest.mark.parametrize("solver", ["multigrid"])
def test_other_pressure_solvers_raise(solver):
    _, tcfg = configs(pressure_solver=solver)
    types = torch.from_numpy(random_types(rng(19)))
    with pytest.raises(ValueError):
        tpressure.jacobi_solve(types, torch.zeros(N, N, N), tcfg)


# ------------------------------------------------------------------ 14
@pytest.mark.parametrize("sampler", ["packed", "gather"])
def test_move_particles(sampler):
    """packed: the K3+K4 route against the JAX kernel path run in the
    Pallas interpreter; both accumulate the lanes one by one, but XLA:CPU
    may contract the weighted sum (1 ULP).  gather: bitwise."""
    jcfg, tcfg = configs(particle_sampler=sampler)
    if sampler == "packed":
        jcfg = jcfg.replace(pallas_mode="interpret")
    r = rng(19)
    vel = random_vel(r)
    pos = (r.random((600, 3)) * (N + 2) - 1).astype(np.float32)
    act = r.random(600) < 0.7
    same(tparticles.move_particles(T(vel), T(pos), T(act), tcfg),
         jparticles.move_particles(J(vel), J(pos), J(act), jcfg),
         ulp=1 if sampler == "packed" else 0)


# ------------------------------------------------------------------ 16-18
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_update_inertia(dtype):
    r = rng(20)
    shape = TCFG.detailed_size
    occ = (r.random(shape) < 0.3).astype(np.uint8)
    inertia = r.integers(0, 101, shape).astype(dtype)
    same(tsurface.update_inertia(T(occ), T(inertia), TCFG),
         jsurface.update_inertia(J(occ), J(inertia), JCFG))


def test_float_densities():
    inertia = rng(21).integers(0, 101, TCFG.detailed_size).astype(np.uint8)
    same(tsurface.float_densities(T(inertia), TCFG),
         jsurface.float_densities(J(inertia), JCFG))


def test_solid_parent_mask_and_blur():
    r = rng(22)
    types = random_types(r)
    shape = TCFG.detailed_size
    f1 = r.standard_normal(shape).astype(np.float32)
    f2 = r.standard_normal(shape).astype(np.float32)
    same(tsurface.solid_parent_mask(T(types), TCFG),
         jsurface.solid_parent_mask(J(types), JCFG))
    for got, want in zip(
            tsurface.blur_float_densities(T(types), T(f1), T(f2), TCFG),
            jsurface.blur_float_densities(J(types), J(f1), J(f2), JCFG)):
        same(got, want)


@pytest.mark.parametrize("steps", [0, 3, 4])
def test_update_surface_fields(steps):
    """The K5 route against the JAX XLA stages (other neighbour order) and
    against the JAX fused kernel in the Pallas interpreter (same order, but
    XLA:CPU rounds the signed field's division and the blur's mul-adds its
    own way): inertia equal, floats within 2 ULP of the field's scale."""
    jcfg, tcfg = configs(float_density_diffuse_steps=steps)
    r = rng(23)
    types = random_types(r)
    shape = TCFG.detailed_size
    occ = (r.random(shape) < 0.3).astype(np.uint8)
    inertia = r.integers(0, 101, shape).astype(np.uint8)
    f2 = r.standard_normal(shape).astype(np.float32)
    got = tsurface.update_surface_fields(T(types), T(occ), T(inertia),
                                         T(f2), tcfg)
    xla = jsurface.update_surface_fields(J(types), J(occ), J(inertia),
                                         J(f2), jcfg)
    fused = jsurface.update_surface_fields(
        J(types), J(occ), J(inertia), J(f2),
        jcfg.replace(pallas_mode="interpret"))
    same(got[0], xla[0])
    for g, x, f in zip(got[1:], xla[1:], fused[1:]):
        same(g, x, ulp=2)
        same(g, f, ulp=2)
    same(got[0], fused[0])
    pick = tsurface.surface_field(got[1], got[2], tcfg)
    assert pick is (got[2] if steps % 2 else got[1])
