"""The port's x-slab multi-device step (`tpu_fluid_torch/parallel/`) on the
CPU: n = 2 and n = 4 ranks, each a spawned process on a gloo group, against
the port's single-device step (bitwise) and JAX's single-device
`simulation_step` (the tolerances of tests/test_torch_step.py), on the
scene of tests/test_spmd_step.py:31-43; the program form `jit_spmd_step`
(on CPU states its eager route through `solver/graph.replay`) from the
program's `layout_state` against the same; the sharded Jacobi sweeps against
JAX's `jacobi_sweeps_sharded` under shard_map; the halo helpers and
collectives; one shard without spawning; and the config rejections.

One spawn per mesh size runs every scenario (a fixture with its own
timeout): a rank that raises, hangs or mismatches a collective fails the
fixture, with the rank's traceback, well inside the run's time limit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpu_fluid.core import scene_fields as jscene
from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid.core.state import initial_state as jax_initial_state
from tpu_fluid.kernels.jacobi import jacobi_sweeps_sharded
from tpu_fluid.parallel.mesh import make_mesh as jax_make_mesh
from tpu_fluid.solver.step import simulation_step as jax_step
from tpu_fluid_torch import (FluidConfig, SceneFields, initial_state,
                             solid_sphere, step, vortex_force)
from tpu_fluid_torch.core.state import state_to_numpy
from tpu_fluid_torch.kernels.jacobi import (jacobi_fold_plain,
                                            jacobi_sweeps_plain,
                                            jacobi_sweeps_sharded_cuda,
                                            jacobi_sweeps_sharded_plain)
from tpu_fluid_torch.parallel.halo import (all_gather_x, exchange_x_halo,
                                           halo_planes, jacobi_solve_halo,
                                           ppermute_neighbours, psum,
                                           psum_scatter_x)
from tpu_fluid_torch.parallel.launch import run_ranks
from tpu_fluid_torch.parallel.mesh import (gather_state, make_mesh,
                                           shard_scene, shard_state)
from tpu_fluid_torch.parallel.particles_domain import layout_state
from tpu_fluid_torch.parallel.spmd_step import (jit_spmd_step,
                                                spmd_multi_step, spmd_step,
                                                validate_spmd_config)
from tpu_fluid_torch.stages.pressure import fold_slab, jacobi_solve

torch.set_num_threads(2)
EPS = np.finfo(np.float32).eps
STEPS = 3
SPAWN_TIMEOUT = 240.0
TOL = {"velocity": (2e-4, 2e-5), "positions": (1e-4, 1e-5),
       "float_dens_1": (1e-4, 1e-5), "float_dens_2": (1e-4, 1e-5)}

BASE = dict(grid_size=(32, 16, 16), particle_count=4096,
            particle_init_cube_resolution=(16, 16, 16),
            particle_init_cube_offset=(5.0, 2.0, 2.0),
            particle_init_cube_size=(20.0, 9.0, 5.0),
            surface_render_resolution=2, jacobi_iters=30,
            advect_max_displacement=2)
BOX = (((6, 8, 4), (10, 14, 8)),)
FORCE = (((9, 12, 11), (50.0, -80.0, 0.0)),)
SCENARIOS = {
    # the plain stage formulations
    "off": dict(pallas_mode="off"),
    # the fused grid path (K6 halo forms) and every kernel's halo plain
    # version, with a solid box and an extra force across shard borders
    "fused": dict(pallas_mode="interpret", grid_fused=True, solid_boxes=BOX,
                  extra_forces=FORCE),
    # the unfused stages with global-coordinate features and the shift
    # advection on an (R + 1)-extended block
    "obstacles": dict(pallas_mode="off", solid_boxes=BOX, extra_forces=FORCE,
                      advect_method="shift"),
    "sim_only": dict(pallas_mode="off", surface_enabled=False),
    # 16 blur passes: K5's halo (17 planes) fits the 32-row detailed slab
    # of 2 shards, not the 16-row slab of 4, which takes the per-pass path
    "long_blur": dict(pallas_mode="interpret",
                      float_density_diffuse_steps=16),
    # the options beyond the reference together, with scene fields (a
    # solid sphere and a vortex force across the shard borders): volume
    # correction at steps 0 and 2 through the red-black solver, the level
    # set on a block with its band's halo
    "physics": dict(pallas_mode="off", volume_correction=1.0,
                    volume_correction_every=2, volume_target_density=4.0,
                    surface_method="levelset", pressure_solver="redblack"),
    # volume correction through the folded Jacobi sweeps: index-sharded
    # counts summed onto the slabs
    "volume": dict(pallas_mode="interpret", volume_correction=1.0,
                   volume_correction_every=2, volume_target_density=4.0),
    # a band of 20 + 2 detailed cells, ht = 11 sim planes: the halo route
    # on the 16-row slabs of 2 shards, the gathered route on the 8-row
    # slabs of 4
    "levelset_wide": dict(pallas_mode="off", surface_method="levelset",
                          levelset_sweeps=20),
}
WITH_SCENE = ("physics",)
# the scenarios also run through jit_spmd_step: the plain stages, and the
# options beyond the reference with scene fields and the volume cadence
JIT_SCENARIOS = ("off", "physics")
SPHERE, VORTEX = ((16, 13, 8), 2.5), ((16, 8), 40.0)
JACOBI_SHAPE, JACOBI_ITERS, JACOBI_KS = (16, 8, 8), 11, (1, 3, None)
JACOBI_CFG = FluidConfig(grid_size=JACOBI_SHAPE, jacobi_iters=25)


def cfg_of(name, package=FluidConfig):
    return package(**BASE, **SCENARIOS[name])


def scene_of(name, cfg, helpers=None):
    """The scenario's SceneFields (the port's, or JAX's with `helpers` =
    tpu_fluid.core.scene_fields), else None."""
    if name not in WITH_SCENE:
        return None
    if helpers is None:
        return SceneFields(solid_sphere(cfg, *SPHERE, device="cpu"),
                           vortex_force(cfg, *VORTEX, device="cpu"))
    return helpers.SceneFields(helpers.solid_sphere(cfg, *SPHERE),
                               helpers.vortex_force(cfg, *VORTEX))


def jacobi_scene():
    """Cell types with the solid border and a right-hand side."""
    r = np.random.default_rng(7)
    t = np.where(r.random(JACOBI_SHAPE) < 0.4, 2, 0).astype(np.uint8)
    t[0], t[-1], t[:, 0], t[:, -1], t[:, :, 0], t[:, :, -1] = (3,) * 6
    rhs = (r.standard_normal(JACOBI_SHAPE) * 50).astype(np.float32)
    return torch.from_numpy(t), torch.from_numpy(rhs)


def fold_scene():
    """Cell types of every type with WATER on both x faces, so the slab
    folds read water across the shard boundaries and past the domain
    ends; div with NaN, an infinity and -0.0."""
    r = np.random.default_rng(8)
    t = r.integers(0, 4, JACOBI_SHAPE).astype(np.uint8)
    t[0], t[-1] = 2, 2
    div = (r.standard_normal(JACOBI_SHAPE) * 50).astype(np.float32)
    div.reshape(-1)[:3] = (np.nan, np.inf, -0.0)
    return torch.from_numpy(t), torch.from_numpy(div)


# (boundary_value, scale): the pressure solve's and the volume solve's
FOLD_BOUNDARIES = ((JACOBI_CFG.air_pressure, JACOBI_CFG.fluid_density
                    * JACOBI_CFG.cell_width / JACOBI_CFG.dt), (0.0, 1.0))


def jacobi_inputs():
    """(q0, code, c2e): the folded inputs the port's sweeps take.  JAX's
    sweeps fold c2 themselves, and c2e folds to itself."""
    return jacobi_fold_plain(*jacobi_scene(), 1.0, 1.0)


# ------------------------------------------------------------ rank worker
def _rank(rank, n, init_method):
    """Every scenario on this rank: the gathered states (on rank 0), the
    sharded sweeps and the helpers' results."""
    torch.set_num_threads(1)
    mesh = make_mesh(n, rank, init_method, device="cpu")
    out = {}
    for name in SCENARIOS:
        cfg = cfg_of(name)
        local = shard_state(initial_state(cfg, device="cpu"), rank, n)
        scene = shard_scene(scene_of(name, cfg), rank, n)
        local = spmd_multi_step(cfg, mesh, STEPS, scene)(local)
        full = gather_state(local, mesh)
        out[name] = state_to_numpy(full) if rank == 0 else None
    for name in JIT_SCENARIOS:
        cfg = cfg_of(name)
        run = jit_spmd_step(cfg, mesh, shard_scene(scene_of(name, cfg),
                                                   rank, n))
        local = layout_state(initial_state(cfg, device="cpu"), rank, n, cfg)
        for _ in range(STEPS):
            local = run(local)
        full = gather_state(local, mesh)
        out["jit " + name] = state_to_numpy(full) if rank == 0 else None
    q0, code, c2e = jacobi_inputs()
    lx = JACOBI_SHAPE[0] // n
    sl = slice(rank * lx, (rank + 1) * lx)
    args = (q0[sl].contiguous(), code[sl].contiguous(), c2e[sl].contiguous(),
            JACOBI_ITERS, mesh)
    out["jacobi"] = [jacobi_sweeps_sharded_plain(*args, k=k).numpy()
                     for k in JACOBI_KS]
    out["jacobi_cuda_wrapper"] = jacobi_sweeps_sharded_cuda(*args).numpy()
    types, div = fold_scene()
    out["fold_slab"] = [[a.numpy() for a in fold_slab(
        jacobi_fold_plain, types[sl].contiguous(), div[sl].contiguous(),
        scale, boundary_value, mesh)]
        for boundary_value, scale in FOLD_BOUNDARIES]
    types, div = jacobi_scene()
    out["jacobi_solve_halo"] = jacobi_solve_halo(
        mesh, types[sl].contiguous(), div[sl].contiguous(),
        JACOBI_CFG).numpy()
    a = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3) \
        + 100 * rank
    out["halo"] = [x.numpy() for x in halo_planes(a, 2, mesh)]
    out["halo_bool"] = [x.numpy() for x in halo_planes(a > 110, 1, mesh)]
    out["exchange"] = exchange_x_halo(a, mesh).numpy()
    # migrate's exchange: (m, 3) f32 rows and int32 flags, either direction
    rows = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 100 * rank
    flags = torch.tensor([rank, -rank], dtype=torch.int32)
    out["ppermute"] = [x.numpy() for x in ppermute_neighbours(
        rows, rows + 1000, mesh) + ppermute_neighbours(-flags, flags, mesh)]
    out["gather"] = all_gather_x(a[None].repeat(3, 1, 1, 1), mesh,
                                 axis=1).numpy()
    counts = torch.full((n * 2, 3, 3), rank + 1, dtype=torch.uint8)
    out["psum_scatter"] = psum_scatter_x(counts, mesh).numpy()
    out["psum"] = psum(torch.tensor(rank + 1, dtype=torch.int32), mesh).item()
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def sharded(request, tmp_path_factory):
    n = request.param
    ranks = run_ranks(_rank, n, timeout=SPAWN_TIMEOUT,
                      workdir=tmp_path_factory.mktemp(f"rendezvous{n}"))
    return n, ranks


@pytest.fixture(scope="module")
def single():
    """The port's single-device states after STEPS steps."""
    out = {}
    for name in SCENARIOS:
        cfg = cfg_of(name)
        state = initial_state(cfg, device="cpu")
        for _ in range(STEPS):
            state = step(state, cfg, scene_of(name, cfg))
        out[name] = state_to_numpy(state)
    return out


def assert_bitwise(got: dict, want: dict, label: str):
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, (label, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")


def scenario_state(sharded, name):
    return sharded[1][0][name]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_steps_equal_single_device_bitwise(sharded, single, name):
    got = scenario_state(sharded, name)
    assert_bitwise(got, single[name], f"n={sharded[0]} {name}")
    assert int(got["step"]) == STEPS


@pytest.fixture(scope="module")
def jax_single():
    """JAX's single-device states after STEPS jitted steps (XLA stages),
    from JAX's initial state, per scenario; computed once for both mesh
    sizes.  The fused path of the port's single-device step is held
    against JAX's interpreted kernels in tests/test_torch_step.py."""
    out = {}

    def get(name):
        if name not in out:
            jcfg = cfg_of(name, JaxConfig)
            jstate = jax_initial_state(jcfg)
            jstep = jax.jit(jax_step, static_argnums=1)
            scene = scene_of(name, jcfg, jscene)
            for _ in range(STEPS):
                jstate = jstep(jstate, jcfg, scene)
            out[name] = {k: np.asarray(v) for k, v in
                         jstate._asdict().items()}
        return out[name]
    return get


def assert_matches_jax(got: dict, want: dict):
    for field, w in want.items():
        g = got[field]
        assert g.dtype == w.dtype and g.shape == w.shape, field
        if field in TOL:
            rtol, atol = TOL[field]
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=field)
        else:
            np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("name", ["off", "obstacles", "physics"])
def test_sharded_steps_match_jax_single_device(sharded, jax_single, name):
    assert_matches_jax(scenario_state(sharded, name), jax_single(name))


@pytest.mark.parametrize("name", JIT_SCENARIOS)
def test_jit_spmd_step_equals_single_device_and_jax(sharded, single,
                                                     jax_single, name):
    """STEPS `jit_spmd_step` calls on each rank's `layout_state`: gathered,
    the port's single-device steps bitwise and JAX's at TOL."""
    got = scenario_state(sharded, "jit " + name)
    assert_bitwise(got, single[name], f"n={sharded[0]} jit {name}")
    assert int(got["step"]) == STEPS
    assert_matches_jax(got, jax_single(name))


def test_sharded_jacobi_independent_of_k_and_matches_jax(sharded):
    """The sharded sweeps at k = 1, 3 and the default, and through the
    kernel wrapper's CPU route, equal the single-device sweeps bitwise and
    JAX's jacobi_sweeps_sharded (interpreted, under shard_map on n CPU
    devices) within 1 ULP of the field's scale (XLA:CPU may contract a
    mul+add in the interpreted kernel)."""
    n, ranks = sharded
    q0, code, c2e = jacobi_inputs()
    want = jacobi_sweeps_plain(q0, code, c2e, JACOBI_ITERS).numpy()
    for i, k in enumerate(JACOBI_KS):
        got = np.concatenate([r["jacobi"][i] for r in ranks])
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")
    np.testing.assert_array_equal(
        np.concatenate([r["jacobi_cuda_wrapper"] for r in ranks]), want)
    # the XLA-path sharded solve, one plane exchanged a sweep
    types, div = jacobi_scene()
    np.testing.assert_array_equal(
        np.concatenate([r["jacobi_solve_halo"] for r in ranks]),
        jacobi_solve(types, div, JACOBI_CFG).numpy())

    mesh = jax_make_mesh(n)
    fn = jax.shard_map(
        lambda q, rd, c: jacobi_sweeps_sharded(q, rd, c, JACOBI_ITERS, "x",
                                               k=3, interpret=True),
        mesh=mesh, in_specs=(P("x"),) * 3, out_specs=P("x"),
        check_vma=False)
    jax_q = np.asarray(fn(*(jnp.asarray(a.numpy()) for a in (q0, code, c2e))))
    scale = float(np.abs(jax_q).max())
    np.testing.assert_allclose(want, jax_q, rtol=EPS, atol=EPS * scale)


def test_sharded_fold_equals_single_device_bitwise(sharded):
    """Each shard's fold of its slab with one halo plane of the types
    (`stages/pressure.fold_slab`) is the single-device fold's rows, bit
    for bit, NaNs too, at both boundaries."""
    n, ranks = sharded
    types, div = fold_scene()
    for i, (boundary_value, scale) in enumerate(FOLD_BOUNDARIES):
        want = jacobi_fold_plain(types, div, scale, boundary_value)
        for j, w in enumerate(want):
            got = np.concatenate([r["fold_slab"][i][j] for r in ranks])
            w = w.numpy()
            assert got.dtype == w.dtype and got.shape == w.shape
            if w.dtype == np.float32:
                got, w = got.view(np.int32), w.view(np.int32)
            np.testing.assert_array_equal(got, w, err_msg=f"{i} {j}")


def test_halo_planes_and_collectives(sharded):
    n, ranks = sharded
    a = [np.arange(24, dtype=np.float32).reshape(2, 4, 3) + 100 * r
         for r in range(n)]
    for r, out in enumerate(ranks):
        left, right = out["halo"]
        np.testing.assert_array_equal(
            left, a[r - 1][-2:] if r > 0 else np.zeros((2, 4, 3)))
        np.testing.assert_array_equal(
            right, a[r + 1][:2] if r < n - 1 else np.zeros((2, 4, 3)))
        np.testing.assert_array_equal(
            out["exchange"], np.concatenate([left[-1:], a[r], right[:1]]))
        bl, br = out["halo_bool"]
        assert bl.dtype == br.dtype == np.bool_
        np.testing.assert_array_equal(
            bl, a[r - 1][-1:] > 110 if r > 0 else np.zeros((1, 4, 3), bool))
        np.testing.assert_array_equal(
            out["gather"], np.concatenate(a)[None].repeat(3, 0))
        np.testing.assert_array_equal(
            out["psum_scatter"], np.full((2, 3, 3), n * (n + 1) // 2))
        assert out["psum"] == n * (n + 1) // 2


def test_ppermute_neighbours(sharded):
    """from_left is what the -x neighbour sent right, from_right what the
    +x neighbour sent left; the domain ends receive zeros; int32 stays
    int32."""
    n, ranks = sharded
    rows = [np.arange(12, dtype=np.float32).reshape(4, 3) + 100 * r
            for r in range(n)]
    flags = [np.array([r, -r], np.int32) for r in range(n)]
    for r, out in enumerate(ranks):
        from_left, from_right, flag_left, flag_right = out["ppermute"]
        np.testing.assert_array_equal(
            from_left, rows[r - 1] + 1000 if r > 0 else np.zeros((4, 3)))
        np.testing.assert_array_equal(
            from_right, rows[r + 1] if r < n - 1 else np.zeros((4, 3)))
        assert flag_left.dtype == flag_right.dtype == np.int32
        np.testing.assert_array_equal(
            flag_left, flags[r - 1] if r > 0 else np.zeros(2, np.int32))
        np.testing.assert_array_equal(
            flag_right, -flags[r + 1] if r < n - 1 else np.zeros(2, np.int32))


# ------------------------------------------------------------- one shard
def test_one_shard_without_spawning_equals_single_device(single):
    cfg = cfg_of("fused")
    mesh = make_mesh(1, device="cpu")
    state = spmd_multi_step(cfg, mesh, STEPS)(
        shard_state(initial_state(cfg, device="cpu"), 0, 1))
    assert_bitwise(state_to_numpy(gather_state(state, mesh)),
                   single["fused"], "n=1")


@pytest.mark.parametrize("name", ["obstacles", "physics"])
def test_one_shard_through_the_kernel_wrappers(single, monkeypatch, name):
    """The unfused stages with every kernel wrapper in place of the plain
    calls: on CPU tensors each wrapper checks its inputs (dtype, shape,
    contiguity) as on the card, then runs its plain version."""
    from tpu_fluid_torch.parallel import spmd_step as spmd_module
    monkeypatch.setattr(spmd_module, "kernel_choice", lambda cfg, dev: True)
    cfg = cfg_of(name)
    mesh = make_mesh(1, device="cpu")
    state = spmd_multi_step(cfg, mesh, STEPS, scene_of(name, cfg))(
        shard_state(initial_state(cfg, device="cpu"), 0, 1))
    assert_bitwise(state_to_numpy(gather_state(state, mesh)), single[name],
                   f"n=1 wrappers {name}")


def test_validate_spmd_config_rejections():
    cfg = cfg_of("off")
    with pytest.raises(ValueError):
        validate_spmd_config(cfg.replace(grid_size=(18, 16, 16)), 8)
    with pytest.raises(ValueError):
        validate_spmd_config(cfg.replace(particle_count=4097), 8)
    with pytest.raises(ValueError):
        validate_spmd_config(cfg, 16)      # 2-row slabs, halo R + 1 = 3
    domain = cfg.replace(particle_sharding="domain")
    with pytest.raises(ValueError):
        validate_spmd_config(domain.replace(particle_sampler="gather"), 2)
    with pytest.raises(ValueError):
        validate_spmd_config(cfg.replace(particle_sharding="rows"), 2)
    # slots are sized per shard, so the count need not divide the mesh
    validate_spmd_config(domain.replace(particle_count=4097), 8)


def test_make_mesh_rejections():
    with pytest.raises(RuntimeError):
        make_mesh(torch.cuda.device_count() + 1, backend="nccl")
    with pytest.raises(ValueError):
        make_mesh(2, rank=2, device="cpu")
    with pytest.raises(ValueError):
        make_mesh(2, rank=0, device="cpu")  # no init_method
