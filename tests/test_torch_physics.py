"""The options beyond the reference in the PyTorch port, against the JAX
package on the same numpy-seeded inputs: the particle histogram
(`ops/scatter.py`), the volume drift (`stages/volume.py`), the red-black
solver (`stages/pressure.redblack_solve`), the level set
(`surface/levelset.py`), scene fields and presets (`core/scene_fields.py`,
`core/scenes.py`), and full steps with each option, through `step`.

Integer results and the stages that both sides add in the same order are
bitwise equal.  The volume potential runs the port's folded Jacobi form
against JAX's interpreted kernel, full steps are held to
`test_torch_step.TOL` (the port's Jacobi route folds where JAX's XLA route
divides), and the cadence of the volume correction is held bitwise against
steps that always and never correct."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_step import KW, assert_states_close, jax_numpy
from tpu_fluid.core import scene_fields as jscene
from tpu_fluid.core import scenes as jscenes
from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid.core.state import initial_state as jax_initial_state
from tpu_fluid.ops.scatter import particle_cell_histogram as jax_histogram
from tpu_fluid.solver.step import simulation_step as jax_step
from tpu_fluid.stages import celltypes as jcell
from tpu_fluid.stages import particles as jparticles
from tpu_fluid.stages import pressure as jpressure
from tpu_fluid.stages import surface_fields as jsurface
from tpu_fluid.stages import velocity as jvel
from tpu_fluid.stages import volume as jvolume
from tpu_fluid.surface import levelset as jlevelset
from tpu_fluid_torch import (SCENES, CellType, FluidConfig, SceneFields,
                             initial_state, solid_sphere, step,
                             uniform_force, vortex_force)
from tpu_fluid_torch.core.state import state_to_numpy
from tpu_fluid_torch.ops.scatter import particle_cell_histogram
from tpu_fluid_torch.solver.step import simulation_step
from tpu_fluid_torch.stages import celltypes as tcell
from tpu_fluid_torch.stages import particles as tparticles
from tpu_fluid_torch.stages import pressure as tpressure
from tpu_fluid_torch.stages import surface_fields as tsurface
from tpu_fluid_torch.stages import velocity as tvel
from tpu_fluid_torch.stages import volume as tvolume
from tpu_fluid_torch.surface import levelset as tlevelset

torch.set_num_threads(2)
EPS = np.finfo(np.float32).eps
SHAPE = (14, 12, 10)
SMALL = dict(grid_size=SHAPE, particle_count=2000,
             particle_init_cube_resolution=(16, 16, 8),
             particle_init_cube_offset=(3.0, 2.0, 2.0),
             particle_init_cube_size=(7.0, 6.0, 5.0),
             surface_render_resolution=2, jacobi_iters=40)
# a target off the initial density, so that the drift is not zero
VOLUME = dict(volume_correction=1.0, volume_target_density=4.0)


def configs(**kw):
    return JaxConfig(**SMALL).replace(**kw), FluidConfig(**SMALL).replace(**kw)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


def same(got, want):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype,
                                                        w.shape, w.dtype)
    np.testing.assert_array_equal(g, w)


def random_types(r, shape=SHAPE):
    """Solid border, then WATER, AIR and INACTIVE cells at random."""
    t = r.choice(np.array([CellType.WATER, CellType.AIR, CellType.INACTIVE],
                          np.uint8), size=shape, p=(0.6, 0.25, 0.15))
    t[0], t[-1], t[:, 0], t[:, -1], t[:, :, 0], t[:, :, -1] = \
        (CellType.SOLID,) * 6
    return t


def random_positions(r, n, grid, extremes=True):
    """Positions over the grid and a cell past each side, with NaN,
    infinite and huge coordinates among them, and random activity."""
    pos = (r.random((n, 3)) * (np.array(grid) + 2) - 1).astype(np.float32)
    if extremes:
        bad = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 1e30, -0.5],
                       np.float32)
        rows = r.choice(n, size=n // 8, replace=False)
        pos[rows, r.integers(0, 3, len(rows))] = r.choice(bad, len(rows))
        pos[rows[:8]] = np.nan                      # NaN on every axis
    active = r.random(n) < 0.85
    return pos, active


# ------------------------------------------------------------ histogram
@pytest.mark.parametrize("scale,grid", [(1.0, SHAPE), (2.0, (28, 24, 20)),
                                        (1.0, (5, 1, 7))])
def test_histogram_with_non_finite_and_out_of_range_rows(scale, grid):
    """NaN lands on index 0 of its axis, infinite and huge coordinates
    saturate out of the grid, -0.5 truncates to 0; inactive rows add 0."""
    pos, active = random_positions(np.random.default_rng(1), 3000,
                                   np.array(grid) / scale)
    got = particle_cell_histogram(T(pos), T(active), grid, scale=scale)
    same(got, jax_histogram(J(pos), J(active), grid, scale=scale))
    assert got.dtype == torch.int32 and int(got.sum()) > 0


def test_particle_and_detailed_densities():
    jcfg, tcfg = configs()
    pos, active = random_positions(np.random.default_rng(2), 4000, SHAPE)
    same(tparticles.particle_densities(T(pos), T(active), tcfg),
         jparticles.particle_densities(J(pos), J(active), jcfg))
    same(tparticles.detailed_densities(T(pos), T(active), tcfg),
         jparticles.detailed_densities(J(pos), J(active), jcfg))


def test_histogram_heavy_duplication():
    """Every particle in one of three cells: counts in the thousands."""
    r = np.random.default_rng(3)
    pos = (np.array([[1.2, 2.5, 3.9], [5.0, 0.0, 0.0], [13.9, 11.9, 9.9]],
                    np.float32)[r.integers(0, 3, 10000)])
    active = np.ones(10000, bool)
    same(particle_cell_histogram(T(pos), T(active), SHAPE),
         jax_histogram(J(pos), J(active), SHAPE))


# ------------------------------------------------------------ level set
def random_occupancy(r, shape, fill=0.04):
    return (r.random(shape) < fill).astype(np.uint8)


@pytest.mark.parametrize("metric", ["euclid26", "manhattan6"])
@pytest.mark.parametrize("sweeps", [0, 1, 4])
def test_chamfer_distance(metric, sweeps):
    occ = random_occupancy(np.random.default_rng(4), (13, 11, 9))
    got = tlevelset.chamfer_distance(T(occ), sweeps, metric)
    same(got, jlevelset.chamfer_distance(J(occ), sweeps, metric))
    assert float(got.max()) >= tlevelset._BIG or sweeps >= 4


def test_chamfer_distance_empty_and_unknown_metric():
    occ = np.zeros((4, 5, 6), np.uint8)
    same(tlevelset.chamfer_distance(T(occ), 2),
         jlevelset.chamfer_distance(J(occ), 2))
    with pytest.raises(ValueError):
        tlevelset.chamfer_distance(T(occ), 1, "octagonal")


@pytest.mark.parametrize("change", [dict(), dict(levelset_smooth=0),
                                    dict(levelset_iso=2.5,
                                         levelset_sweeps=5),
                                    dict(surface_render_resolution=3)])
def test_levelset_field(change):
    jcfg, tcfg = configs(surface_method="levelset", **change)
    r = np.random.default_rng(5)
    types = random_types(r)
    occ = random_occupancy(r, tcfg.detailed_size)
    same(tlevelset.levelset_fields(T(types), T(occ), tcfg)[0],
         jax.jit(jlevelset.levelset_field, static_argnums=2)(
             J(types), J(occ), jcfg))


def test_update_surface_fields_levelset_branch():
    """(inertia as given, f, f): one tensor for both fields, as JAX."""
    jcfg, tcfg = configs(surface_method="levelset")
    r = np.random.default_rng(6)
    types = random_types(r)
    d = tcfg.detailed_size
    occ = random_occupancy(r, d, 0.2)
    inertia = r.integers(0, 101, d).astype(np.uint8)
    f2 = r.standard_normal(d).astype(np.float32)
    got = tsurface.update_surface_fields(T(types), T(occ), T(inertia),
                                         T(f2), tcfg)
    assert got[1] is got[2]
    want = jax.jit(jsurface.update_surface_fields, static_argnums=4)(
        J(types), J(occ), J(inertia), J(f2), jcfg)
    for g, w in zip(got, want):
        same(g, w)


# ------------------------------------------------------------ red-black
def solve_inputs(seed, shape=SHAPE):
    r = np.random.default_rng(seed)
    return random_types(r, shape), \
        (r.standard_normal(shape) * 30).astype(np.float32)


@pytest.mark.parametrize("iters,boundary", [(1, 1.0), (7, 1.0), (25, 0.0),
                                            (60, 0.0)])
def test_redblack_poisson_solve(iters, boundary):
    """The same unfolded sweep in the same order as JAX's XLA loop
    (`(neigh + const) / denom`, neighbours added to zeros in MOVES order,
    even half first): bitwise."""
    jcfg, tcfg = configs(pressure_solver="redblack")
    types, rhs = solve_inputs(7)
    got = tpressure.poisson_solve(T(types), T(rhs), tcfg, iters=iters,
                                  boundary_value=boundary)
    want = jax.jit(jpressure.poisson_solve, static_argnums=(2, 3, 4))(
        J(types), J(rhs), jcfg, iters, boundary)
    same(got, want)


def test_redblack_jacobi_solve_and_odd_shape():
    jcfg, tcfg = configs(pressure_solver="redblack", jacobi_iters=30)
    types, div = solve_inputs(8, (9, 13, 6))
    same(tpressure.jacobi_solve(T(types), T(div), tcfg),
         jax.jit(jpressure.jacobi_solve, static_argnums=2)(
             J(types), J(div), jcfg))


def test_redblack_converges_faster_than_jacobi():
    """tests/test_redblack.py's claim, on the port: after the same sweeps
    the red-black residual is below the Jacobi one."""
    _, tcfg = configs(pressure_solver="redblack")
    types, rhs = solve_inputs(9)
    types, rhs = T(types), T(rhs)
    water, aii, n_air = tpressure.jacobi_stats(types, tcfg)

    def residual(p):
        pw = torch.where(water, p, 0.0)
        neigh = sum(torch.roll(pw, s, d) for d in range(3) for s in (1, -1))
        r = torch.where(water & (aii > 0), neigh - aii * p - rhs, 0.0)
        return float(r.abs().max())

    rb = tpressure.poisson_solve(types, rhs, tcfg, iters=20,
                                 boundary_value=0.0)
    jac = tpressure.poisson_solve(types, rhs,
                                  tcfg.replace(pressure_solver="jacobi"),
                                  iters=20, boundary_value=0.0)
    assert residual(rb) < residual(jac)


# --------------------------------------------------------------- volume
def volume_inputs(seed):
    r = np.random.default_rng(seed)
    types = random_types(r)
    counts = r.integers(0, 12, SHAPE).astype(np.int32)
    return types, counts


def test_volume_potential_against_jax_kernel():
    """The folded sweeps against JAX's kernel in the Pallas interpreter,
    which folds alike but whose XLA:CPU may contract rd * sum + c2e: 60
    sweeps measured 1 ULP of the field's scale at most, the bound of
    test_torch_ops_stages.test_jacobi_solve."""
    jcfg, tcfg = configs(pallas_mode="interpret", **VOLUME)
    types, counts = volume_inputs(10)
    got = tvolume.volume_potential(T(counts), T(types), tcfg).numpy()
    want = np.asarray(jvolume.volume_potential(J(counts), J(types), jcfg))
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=EPS, atol=EPS * scale)


@pytest.mark.parametrize("change", [dict(), dict(volume_correction=3.0,
                                                 volume_drift_max=0.05),
                                    dict(pressure_solver="redblack")])
def test_density_drift(change):
    """Against JAX's XLA stages, which solve unfolded: atol 1e-5."""
    jcfg, tcfg = configs(pallas_mode="off", **{**VOLUME, **change})
    types, counts = volume_inputs(11)
    got = tvolume.density_drift(T(counts), T(types), tcfg).numpy()
    want = np.asarray(jvolume.density_drift(J(counts), J(types), jcfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got).max() > 0
    assert np.abs(got).max() <= tcfg.volume_drift_max


def test_drift_pushes_excess_away_and_solids_block():
    """tests/test_volume.py's two drift checks, on the port."""
    cfg = FluidConfig(grid_size=(24, 24, 24), volume_correction=1.0,
                      volume_target_density=8.0)
    counts = torch.full((24, 24, 24), 8, dtype=torch.int32)
    types = torch.full((24, 24, 24), CellType.WATER, dtype=torch.uint8)
    assert not tvolume.density_drift(counts, types, cfg).any()
    counts[10, 10, 10] = 48
    drift = tvolume.density_drift(counts, types, cfg)
    assert drift[0, 10, 10, 10] < 0 and drift[0, 11, 10, 10] > 0
    types[9, 10, 10] = CellType.SOLID
    types[11, 10, 10] = CellType.AIR
    drift = tvolume.density_drift(counts, types, cfg)
    assert drift[0, 10, 10, 10] == 0 and drift[0, 11, 10, 10] > 0


def test_corrected_move_velocity():
    jcfg, tcfg = configs(pallas_mode="off", **VOLUME)
    r = np.random.default_rng(12)
    types = random_types(r)
    vel = r.standard_normal((3,) + SHAPE).astype(np.float32)
    pos, active = random_positions(r, 3000, SHAPE, extremes=False)
    got = tvolume.corrected_move_velocity(T(vel), T(pos), T(active),
                                          T(types), tcfg).numpy()
    want = np.asarray(jvolume.corrected_move_velocity(
        J(vel), J(pos), J(active), J(types), jcfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("every,step,due", [(1, 7, True), (4, 0, True),
                                            (4, 5, False), (4, 8, True),
                                            (0, 3, True)])
def test_volume_due(every, step, due):
    cfg = FluidConfig(volume_correction=0.5, volume_correction_every=every)
    assert tvolume.volume_due(cfg, step) is due
    assert tvolume.volume_due(cfg.replace(volume_correction=0.0),
                              step) is False


# --------------------------------------------------------- scene fields
def test_scene_helpers_equal_jax():
    jcfg, tcfg = configs()
    pairs = [
        (solid_sphere(tcfg, (7, 6, 5), 3.5, device="cpu"),
         jscene.solid_sphere(jcfg, (7, 6, 5), 3.5)),
        (uniform_force(tcfg, (1.5, -2.0, 0.25), device="cpu"),
         jscene.uniform_force(jcfg, (1.5, -2.0, 0.25))),
        (vortex_force(tcfg, (6.5, 4.0), 30.0, device="cpu"),
         jscene.vortex_force(jcfg, (6.5, 4.0), 30.0))]
    for got, want in pairs:
        assert got.device.type == "cpu"
        same(got, want)


def test_scene_validate():
    _, tcfg = configs()
    with pytest.raises(ValueError):
        SceneFields(solid=torch.zeros(8, 8, 8, dtype=torch.uint8)
                    ).validate(tcfg)
    with pytest.raises(ValueError):
        SceneFields(force=torch.zeros(3, 8, 8, 8)).validate(tcfg)
    scene = SceneFields(solid=torch.zeros(SHAPE, dtype=torch.uint8),
                        force=torch.zeros((3,) + SHAPE))
    assert scene.validate(tcfg) is scene
    with pytest.raises(ValueError):
        step(initial_state(tcfg, device="cpu"), tcfg,
             SceneFields(solid=torch.zeros(8, 8, 8, dtype=torch.uint8)))


@pytest.mark.parametrize("dtype", [np.uint8, np.bool_])
def test_update_air_with_extra_solid(dtype):
    jcfg, tcfg = configs(solid_boxes=(((2, 3, 4), (5, 6, 7)),))
    r = np.random.default_rng(13)
    t02 = np.where(r.random(SHAPE) < 0.4, CellType.WATER,
                   CellType.INACTIVE).astype(np.uint8)
    extra = (r.random(SHAPE) < 0.1).astype(dtype)
    same(tcell.update_air(T(t02), tcfg, extra_solid=T(extra)),
         jcell.update_air(J(t02), jcfg, extra_solid=J(extra)))


def test_apply_forces_with_force_field():
    """The field's adds come after the extra forces, as in JAX."""
    jcfg, tcfg = configs(extra_forces=(((3, 4, 5), (20.0, 0.0, -7.5)),))
    r = np.random.default_rng(14)
    types = random_types(r)
    types[3, 4, 5] = CellType.WATER
    vel = r.standard_normal((3,) + SHAPE).astype(np.float32)
    force = (r.standard_normal((3,) + SHAPE) * 50).astype(np.float32)
    same(tvel.apply_forces(T(types), T(vel), tcfg, force_field=T(force)),
         jvel.apply_forces(J(types), J(vel), jcfg, force_field=J(force)))


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("n", [20, 32])
def test_scene_presets_equal_jax_field_by_field(name, n):
    got = SCENES[name](n, particle_count=50_000)
    want = jscenes.SCENES[name](n, particle_count=50_000)
    for field in want.__dataclass_fields__:
        assert getattr(got, field) == getattr(want, field), field
    assert got.detailed_size == want.detailed_size


# ----------------------------------------------------------- full steps
def scene_pair(tcfg, jcfg):
    sphere = ((8, 12, 8), 2.5)
    vortex = ((8, 8), 40.0)
    return (SceneFields(solid_sphere(tcfg, *sphere, device="cpu"),
                        vortex_force(tcfg, *vortex, device="cpu")),
            jscene.SceneFields(jscene.solid_sphere(jcfg, *sphere),
                               jscene.vortex_force(jcfg, *vortex)))


def step_configs(option):
    """(JAX config, port config, with a scene) of option (a)-(d) at 16^3
    or below; the JAX side runs its XLA stages."""
    if option == "scene":
        t = SCENES["dam_break_obstacle"](16, particle_count=4096).replace(
            surface_render_resolution=2, jacobi_iters=60)
        j = jscenes.SCENES["dam_break_obstacle"](16, particle_count=4096
                                                 ).replace(
            surface_render_resolution=2, jacobi_iters=60)
        return j.replace(pallas_mode="off"), t, True
    change = {"volume": dict(volume_correction_every=2, **VOLUME),
              "levelset": dict(surface_method="levelset"),
              "redblack": dict(pressure_solver="redblack")}[option]
    return (JaxConfig(**KW).replace(pallas_mode="off", **change),
            FluidConfig(**KW).replace(**change), False)


@pytest.mark.parametrize("option", ["volume", "levelset", "redblack",
                                    "scene"])
def test_three_steps_match_jax(option):
    jcfg, tcfg, with_scene = step_configs(option)
    scene, jscene_ = scene_pair(tcfg, jcfg) if with_scene else (None, None)
    state = initial_state(tcfg, device="cpu")
    jstate = jax_initial_state(jcfg)
    jstep = jax.jit(jax_step, static_argnums=1)
    for k in range(3):
        state = step(state, tcfg, scene)
        jstate = jstep(jstate, jcfg, jscene_)
        assert_states_close(state_to_numpy(state), jax_numpy(jstate),
                            f"{option} step {k}")
    if with_scene:
        assert bool((state.cell_types[scene.solid != 0]
                     == CellType.SOLID).all())


def test_volume_cadence_runs_one_branch():
    """every = 2: the step at phase 0 equals an always-corrected step, the
    step at phase 1 an uncorrected one, bitwise, and the two differ."""
    _, cfg2 = configs(volume_correction_every=2, **VOLUME)
    cfg1 = cfg2.replace(volume_correction_every=1)
    cfg0 = cfg2.replace(volume_correction=0.0)
    s0 = initial_state(cfg2, device="cpu")
    a = step(s0, cfg2)
    for got, want in zip(a, step(s0, cfg1)):
        assert torch.equal(got, want)
    b = step(a, cfg2)
    for got, want in zip(b, step(a, cfg0)):
        assert torch.equal(got, want)
    assert not torch.equal(b.positions, step(a, cfg1).positions)
    # the caller may name the step instead of the state's own
    for got, want in zip(simulation_step(a, cfg2, volume_step=4),
                         step(a, cfg1)):
        assert torch.equal(got, want)
