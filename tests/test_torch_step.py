"""Full steps of the PyTorch port: against the JAX package's step and the
loop-based NumPy oracle (tests/test_full_step_oracle.py), a state carried
across from JAX, and the physical invariants of tests/test_step.py.

On the CPU the port runs each kernel's plain version, which adds in the
kernels' order where the JAX XLA stages add in MOVES order and divide where
the fold multiplies by a reciprocal, so full steps are held to the oracle
test's tolerances; integer fields must be equal."""

import jax
import numpy as np
import pytest
import torch

from test_full_step_oracle import CFG as JAX_ORACLE_CFG, oracle_step
from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid.core.state import initial_state as jax_initial_state
from tpu_fluid.solver.step import simulation_step as jax_step
from tpu_fluid_torch import (CellType, FluidConfig, initial_state,
                             simulation_step, step)
from tpu_fluid_torch.core.state import state_from_numpy, state_to_numpy
from tpu_fluid_torch.kernels import fuse_grid_choice
from tpu_fluid_torch.kernels.grid_fused import (classify_extrap_cuda,
                                                forces_solids_div_cuda,
                                                project_cuda)
from tpu_fluid_torch.stages.pressure import compute_divergence

torch.set_num_threads(2)

ORACLE_CFG = FluidConfig(**{f: getattr(JAX_ORACLE_CFG, f)
                             for f in JAX_ORACLE_CFG.__dataclass_fields__})
TOL = {"velocity": (2e-4, 2e-5), "positions": (1e-4, 1e-5),
       "float_dens_1": (1e-4, 1e-5), "float_dens_2": (1e-4, 1e-5)}

KW = dict(grid_size=(12, 12, 12), particle_count=4000,
          particle_init_cube_resolution=(16, 16, 16),
          particle_init_cube_offset=(3.0, 1.5, 1.0),
          particle_init_cube_size=(6.0, 6.0, 1.5),
          surface_render_resolution=2, jacobi_iters=100,
          fountain_force=-300.0)
CFG = FluidConfig(**KW)


def assert_states_close(got: dict, want: dict, label: str):
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, (label, name)
        if name in TOL:
            rtol, atol = TOL[name]
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f"{label} {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")


def jax_numpy(state) -> dict:
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def test_three_steps_match_jax_and_oracle():
    jcfg = JAX_ORACLE_CFG.replace(pallas_mode="off")
    jstate = jax_initial_state(jcfg)
    state = initial_state(ORACLE_CFG, device="cpu")
    s_np = tuple(np.asarray(getattr(jstate, f)) for f in (
        "velocity", "cell_types", "inertia", "float_dens_1",
        "float_dens_2", "positions", "active"))
    s_np = (s_np[0].astype(np.float64), s_np[1], s_np[2].astype(np.int64),
            s_np[3].astype(np.float64), s_np[4].astype(np.float64),
            s_np[5].astype(np.float64), s_np[6])
    jstep = jax.jit(jax_step, static_argnums=1)
    for k in range(3):
        state = step(state, ORACLE_CFG)
        jstate = jstep(jstate, jcfg)
        s_np = oracle_step(s_np, ORACLE_CFG)
        got = state_to_numpy(state)
        assert_states_close(got, jax_numpy(jstate), f"step {k} vs jax")
        vel, types, inertia, f1, f2, pos, _ = s_np
        oracle = {"cell_types": types, "inertia": inertia.astype(np.uint8),
                  "velocity": vel.astype(np.float32),
                  "positions": pos.astype(np.float32),
                  "float_dens_1": f1.astype(np.float32),
                  "float_dens_2": f2.astype(np.float32)}
        assert_states_close(got, oracle, f"step {k} vs oracle")


def test_state_carried_from_jax_steps_alike():
    """A JAX state after two steps crosses into the port through numpy;
    one more step on each side agrees."""
    jcfg = JaxConfig(**KW).replace(pallas_mode="off")
    jstep = jax.jit(jax_step, static_argnums=1)
    jstate = jax_initial_state(jcfg)
    for _ in range(2):
        jstate = jstep(jstate, jcfg)
    state = state_from_numpy(jax_numpy(jstate), device="cpu")
    assert_states_close(state_to_numpy(step(state, CFG)),
                        jax_numpy(jstep(jstate, jcfg)), "carried")


def test_fused_grid_slice_matches_jax_interpret():
    """The grid_fused path (K6 and every other kernel's plain version,
    pallas_mode="interpret") against JAX's interpreted Pallas kernels, two
    steps from one JAX initial state, on the scene of
    tests/test_grid_fused.py:96-117."""
    kw = dict(grid_size=(16, 16, 16), particle_count=2048,
              particle_init_cube_resolution=(16, 16, 8),
              particle_init_cube_offset=(3.0, 2.0, 3.0),
              particle_init_cube_size=(10.0, 8.0, 8.0),
              surface_render_resolution=2, jacobi_iters=20,
              advect_max_displacement=1, pallas_mode="interpret",
              grid_fused=True)
    jcfg, cfg = JaxConfig(**kw), FluidConfig(**kw)
    assert fuse_grid_choice(cfg, torch.device("cpu"))
    jstate = jax_initial_state(jcfg)
    state = state_from_numpy(jax_numpy(jstate), device="cpu")
    launches = [w.launches for w in (classify_extrap_cuda,
                                     forces_solids_div_cuda, project_cuda)]
    for k in range(2):
        jstate = jax_step(jstate, jcfg)
        state = step(state, cfg)
        got, want = state_to_numpy(state), jax_numpy(jstate)
        for name, w in want.items():
            g = got[name]
            assert g.dtype == w.dtype and g.shape == w.shape, name
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5,
                                           err_msg=f"step {k} {name}")
            else:
                np.testing.assert_array_equal(g, w,
                                              err_msg=f"step {k} {name}")
    assert launches == [w.launches for w in (
        classify_extrap_cuda, forces_solids_div_cuda, project_cuda)]


@pytest.fixture(scope="module")
def run():
    """States of the CFG scene after 0 to 30 steps."""
    state = initial_state(CFG, device="cpu")
    out = {0: state}
    for k in range(1, 31):
        state = step(state, CFG)
        out[k] = state
    return out


def test_particle_count_conserved(run):
    assert int(run[10].active.sum()) == CFG.particle_count
    assert int(run[10].step) == 10


def test_particles_stay_in_box(run):
    pos = run[30].positions[run[30].active]
    assert float(pos.min()) > 0.0
    assert float(pos.max()) < 12.0


def test_cell_type_partition_valid(run):
    t = run[10].cell_types.numpy()
    assert set(np.unique(t)) <= {CellType.INACTIVE, CellType.AIR,
                                 CellType.WATER, CellType.SOLID}
    for ax in range(3):
        assert (np.take(t, 0, axis=ax) == CellType.SOLID).all()
        assert (np.take(t, t.shape[ax] - 1, axis=ax) == CellType.SOLID).all()


def test_post_projection_divergence_small(run):
    state = run[5]
    d = compute_divergence(state.velocity).abs()[
        state.cell_types == CellType.WATER]
    assert d.numel() > 0
    assert float(d.median()) < 0.05


def test_inertia_bounds(run):
    inertia = run[15].inertia
    assert int(inertia.min()) >= 0
    assert int(inertia.max()) <= CFG.max_inertia


def test_determinism_bitwise(run):
    state = initial_state(CFG, device="cpu")
    for _ in range(3):
        state = simulation_step(state, CFG)
    for a, b in zip(state, run[3]):
        assert torch.equal(a, b)


def test_pallas_mode_off_equals_auto_on_cpu(run):
    state = initial_state(CFG, device="cpu")
    off = CFG.replace(pallas_mode="off")
    for _ in range(3):
        state = step(state, off)
    for a, b in zip(state, run[3]):
        assert torch.equal(a, b)


def test_fountain_erupts():
    cfg = CFG.replace(fountain_force=-3000.0, jacobi_iters=60,
                      particle_init_cube_offset=(3.0, 6.0, 4.0),
                      particle_init_cube_size=(6.0, 4.5, 4.0))
    state = initial_state(cfg, device="cpu")
    for _ in range(25):
        state = step(state, cfg)
    fx, fy, fz = cfg.fountain
    assert float(state.velocity[1][fx, :fy + 1, fz].min()) < -0.5


def test_sim_only_mode():
    cfg = CFG.replace(surface_enabled=False)
    state = initial_state(cfg, device="cpu")
    for _ in range(5):
        state = step(state, cfg)
    assert int(state.step) == 5
    assert int(state.inertia.max()) == 0
    assert bool((state.cell_types == CellType.WATER).any())
    pos = state.positions[state.active]
    assert float(pos.min()) > 0 and float(pos.max()) < 12
