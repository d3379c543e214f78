"""Domain-sharded particles in the port (`tpu_fluid_torch/parallel/
particles_domain.py`, `FluidConfig.particle_sharding="domain"`), on the CPU:
the tests of tests/test_particles_domain.py, each on spawned gloo ranks
(n = 2 and 4) against the port's single-device step, and the port against
the JAX package's `migrate`, `domain_shard_state`, local scatters and
domain-sharded `spmd_step` on the same inputs.

Contract, as in JAX: the grid fields equal the single-device step's
bitwise, the set of active positions equals it bitwise and nothing is
dropped; the slot order is not the single-device one, but `migrate` keeps
JAX's slot order bitwise.  Against JAX's domain step the port allows the
tolerances of tests/test_torch_spmd.py (the two steps sum in other orders).

One spawn per mesh size runs every scenario and migrate case (a fixture
with its own timeout)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_torch_donation import sentinel
from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid.core.state import initial_state as jax_initial_state
from tpu_fluid.parallel import particles_domain as jpd
from tpu_fluid.parallel.mesh import AXIS
from tpu_fluid.parallel.mesh import make_mesh as jax_make_mesh
from tpu_fluid.parallel.spmd_step import spmd_step as jax_spmd_step
from tpu_fluid_torch import FluidConfig, initial_state, step
from tpu_fluid_torch.core.state import state_to_numpy
from tpu_fluid_torch.parallel import particles_domain as pd
from tpu_fluid_torch.parallel import spmd_step as spmd_module
from tpu_fluid_torch.parallel.halo import all_gather_x, psum
from tpu_fluid_torch.parallel.launch import run_ranks
from tpu_fluid_torch.parallel.mesh import gather_state, make_mesh
from tpu_fluid_torch.parallel.spmd_step import spmd_multi_step

torch.set_num_threads(2)
STEPS = 3
SPAWN_TIMEOUT = 240.0
TOL = {"velocity": (2e-4, 2e-5), "positions": (1e-4, 1e-5),
       "float_dens_1": (1e-4, 1e-5), "float_dens_2": (1e-4, 1e-5)}
GRID_FIELDS = ("velocity", "cell_types", "inertia", "float_dens_1",
               "float_dens_2", "detailed_occ")

# the scene of tests/test_particles_domain.py:18-33, plus +x forces on
# water cells next to the slab borders of 2 and 4 shards: without them no
# particle crosses a border in 3 steps, and migrate would move nothing
BASE = dict(grid_size=(32, 16, 16), particle_count=4096,
            particle_init_cube_resolution=(16, 16, 16),
            particle_init_cube_offset=(5.0, 2.0, 2.0),
            particle_init_cube_size=(20.0, 9.0, 5.0),
            surface_render_resolution=2, jacobi_iters=40,
            advect_max_displacement=1, fountain_force=-2000.0,
            fountain_position=(16, 14, 8), particle_sharding="domain",
            extra_forces=tuple(((x, 6, 4), (20000.0, 0.0, 0.0))
                               for x in (7, 15, 23)))
SCENARIOS = {
    "off": dict(pallas_mode="off"),
    # every kernel's plain version, the fused grid groups (K6) included
    "interpret": dict(pallas_mode="interpret", grid_fused=True),
    # volume correction at steps 0 and 2: the slab's own particle counts,
    # the sharded volume solve and the drift's halo plane
    "volume": dict(pallas_mode="off", volume_correction=1.0,
                   volume_correction_every=2, volume_target_density=4.0),
}
MIGRATE_CASES = ("exchange", "send_overflow", "slot_exhaustion",
                 "multi_slab", "tight", "random", "non_finite")
# x coordinates whose cell XLA converts by its own rule: NaN to cell 0,
# infinities and huge values saturated (ops/indexing.float_to_index)
NON_FINITE_X = (float("nan"), float("inf"), -float("inf"), 1e30, -1e30,
                3e9, -3e9)


def cfg_of(name, package=FluidConfig):
    return package(**BASE, **SCENARIOS[name])


def sorted_active(pos, act):
    p = np.asarray(pos)[np.asarray(act)]
    return p[np.lexsort((p[:, 2], p[:, 1], p[:, 0]))]


def migrate_case(name, n):
    """(positions, active, lx, m, exchanges) over n shards of `slots` rows
    each, shard i owning x in [lx i, lx (i + 1))."""
    lx = 8
    if name == "exchange":
        # one stayer a shard, one crosser to each neighbour; m = slots, so
        # 2 m > slots (the hole gather of ADVICE.md:6)
        slots, m = 128, 128
    elif name == "send_overflow":
        slots, m = 128, 4
    elif name == "slot_exhaustion":
        slots, m = 8, 4
    elif name == "multi_slab":
        slots, m = 128, 8
    elif name == "non_finite":
        slots, m = 16, 8
    elif name == "tight":
        slots, m = 16, 12                      # 2 m > slots, holes run out
    else:
        slots, m = 64, 8
    pos = np.zeros((n * slots, 3), np.float32)
    act = np.zeros((n * slots,), bool)
    hops = 1
    if name == "exchange":
        for i in range(n):
            base = i * slots
            pos[base], act[base] = (8 * i + 4.0, 1.0, 1.0), True
            if i < n - 1:
                pos[base + 1], act[base + 1] = (8 * i + 8.5, 2.0, i), True
            if i > 0:
                pos[base + 2], act[base + 2] = (8 * i - 0.5, 3.0, i), True
    elif name == "send_overflow":
        for j in range(m + 2):                 # 6 right-crossers, buffer 4
            pos[j], act[j] = (8.5, 1.0, j), True
    elif name == "slot_exhaustion":
        pos[0:2] = ((8.5, 1.0, 0.0), (8.5, 1.0, 1.0))
        act[0:2] = True
        for j in range(slots):                 # shard 1: no free slot
            pos[slots + j], act[slots + j] = (12.0, 1.0, j), True
    elif name == "multi_slab":
        hops = min(2, n - 1)                   # owned by shard `hops`
        pos[0], act[0] = (8 * hops + 4.5, 1.0, 7.0), True
    elif name == "non_finite":
        # each shard: a stayer, then every non-finite or huge x
        for i in range(n):
            base = i * slots
            pos[base], act[base] = (8 * i + 3.0, 1.0, 1.0), True
            for j, x in enumerate(NON_FINITE_X, start=1):
                pos[base + j], act[base + j] = (x, 2.0, j), True
    else:
        # crossers both ways on every shard, past both domain ends too
        r = np.random.default_rng(5 if name == "tight" else 6)
        for i in range(n):
            seg = slice(i * slots, (i + 1) * slots)
            pos[seg, 0] = 8 * i + r.uniform(-1.5, 9.5, slots)
            pos[seg, 1:] = r.uniform(0, 16, (slots, 2))
            act[seg] = r.random(slots) < (0.9 if name == "tight" else 0.6)
    return pos, act, lx, m, hops


# ------------------------------------------------------------ rank worker
def _rank(rank, n, init_method):
    """Every scenario's gathered state after STEPS domain-sharded steps (on
    rank 0), the collectives and crossers counted in them, and each migrate
    case's gathered result."""
    torch.set_num_threads(1)
    mesh = make_mesh(n, rank, init_method, device="cpu")
    calls = {"all_gather_x": 0, "psum_scatter_x": 0}
    for helper in calls:
        def counted(*args, _name=helper, _fn=getattr(spmd_module, helper)):
            calls[_name] += 1
            return _fn(*args)
        setattr(spmd_module, helper, counted)
    crossers = []
    real_migrate = spmd_module.migrate

    def counting_migrate(pos, active, x0, lx, m, mesh, out=None):
        cx = torch.floor(pos[:, 0])
        crossers.append(int((active & ((cx < x0) | (cx >= x0 + lx))).sum()))
        return real_migrate(pos, active, x0, lx, m, mesh, out=out)

    spmd_module.migrate = counting_migrate
    out = {}
    for name in SCENARIOS:
        cfg = cfg_of(name)
        local = pd.domain_shard_state(initial_state(cfg, device="cpu"),
                                      rank, n, cfg)
        crossers.clear()
        local = spmd_multi_step(cfg, mesh, STEPS)(local)
        full = gather_state(local, mesh)
        out[name] = {"state": state_to_numpy(full) if rank == 0 else None,
                     "crossers": psum(torch.tensor(crossers), mesh).tolist()}
    out["calls"] = dict(calls)
    for name in MIGRATE_CASES:
        pos, act, lx, m, hops = migrate_case(name, n)
        slots = len(pos) // n
        seg = slice(rank * slots, (rank + 1) * slots)
        p, a = torch.from_numpy(pos[seg]), torch.from_numpy(act[seg])
        runs = []
        for _ in range(hops):
            p, a, nd = pd.migrate(p, a, rank * lx, lx, m, mesh)
            runs.append((all_gather_x(p, mesh, axis=0).numpy(),
                         all_gather_x(a, mesh, axis=0).numpy(),
                         int(psum(nd, mesh))))
        out[f"migrate_{name}"] = runs
        out[f"migrate_out_{name}"] = {
            form: migrate_out_runs(form, pos[seg], act[seg], rank * lx, lx,
                                   m, hops, mesh)
            for form in ("in_place", "given")}
    return out


def migrate_out_runs(form, pos, act, x0, lx, m, hops, mesh) -> list:
    """`migrate`'s out= form, `hops` times: into the rows it is given
    ("in_place", as the step passes the moved rows) with sentinel flags,
    or into sentinel-filled positions and flags ("given"); each hop's
    gathered rows, flags and drop count, and whether the given tensors
    were returned."""
    p, a = torch.from_numpy(pos), torch.from_numpy(act)
    runs = []
    for _ in range(hops):
        given = ((p.clone() if form == "in_place" else sentinel(p)),
                 sentinel(a))
        src = given[0] if form == "in_place" else p
        p, a, nd = pd.migrate(src, a, x0, lx, m, mesh, out=given)
        runs.append((all_gather_x(p, mesh, axis=0).numpy(),
                     all_gather_x(a, mesh, axis=0).numpy(),
                     int(psum(nd, mesh)), p is given[0] and a is given[1]))
    return runs


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
            state = step(state, cfg)
        out[name] = state_to_numpy(state)
    return out


def assert_matches_single(got: dict, want: dict, label: str):
    for name in GRID_FIELDS:
        assert got[name].dtype == want[name].dtype, (label, name)
        np.testing.assert_array_equal(got[name], want[name],
                                      err_msg=f"{label} {name}")
    a = sorted_active(want["positions"], want["active"])
    b = sorted_active(got["positions"], got["active"])
    assert a.shape == b.shape, label                # nothing dropped
    np.testing.assert_array_equal(a, b, err_msg=label)
    assert int(got["dropped"]) == 0


# ------------------------------------------------------------- the step
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_domain_steps_equal_single_device(sharded, single, name):
    n, ranks = sharded
    got = ranks[0][name]["state"]
    assert_matches_single(got, single[name], f"n={n} {name}")
    assert int(got["step"]) == STEPS
    assert got["positions"].shape[0] % n == 0
    # particles did cross slab borders, so the exchange was exercised
    assert sum(ranks[0][name]["crossers"]) > 0, ranks[0][name]["crossers"]


def test_domain_step_runs_no_volume_collective(sharded):
    """The domain path replaces the velocity all_gather and the occupancy
    psum_scatter of index sharding: neither runs in any step."""
    _, ranks = sharded
    for rank in ranks:
        assert rank["calls"] == {"all_gather_x": 0, "psum_scatter_x": 0}


def test_one_shard_without_spawning_exchanges_nothing(single, monkeypatch):
    """make_mesh(1): halo_planes, migrate and psum take their no-neighbour
    shortcuts, so no torch.distributed call is made, and the result is the
    single-device step's."""
    def refuse(*args, **kw):
        raise AssertionError("a one-shard mesh exchanged data")

    for fn in ("batch_isend_irecv", "all_reduce", "all_gather",
               "reduce_scatter_tensor"):
        monkeypatch.setattr(torch.distributed, fn, refuse)
    cfg = cfg_of("off")
    mesh = make_mesh(1, device="cpu")
    local = pd.domain_shard_state(initial_state(cfg, device="cpu"), 0, 1,
                                  cfg)
    local = spmd_multi_step(cfg, mesh, STEPS)(local)
    assert_matches_single(state_to_numpy(gather_state(local, mesh)),
                          single["off"], "n=1")


@pytest.fixture(scope="module")
def jax_domain():
    """JAX's domain-sharded spmd_step (XLA stages) on n CPU devices, STEPS
    steps from JAX's initial state of the "off" scenario."""
    out = {}

    def get(n):
        if n not in out:
            jcfg = cfg_of("off", JaxConfig)
            mesh = jax_make_mesh(n)
            state = jpd.domain_shard_state(jax_initial_state(jcfg), mesh,
                                           jcfg)
            stepn = jax_spmd_step(mesh, jcfg, donate=False)
            for _ in range(STEPS):
                state = stepn(state)
            out[n] = {k: np.asarray(v) for k, v in state._asdict().items()}
        return out[n]
    return get


def test_domain_steps_match_jax_domain_step(sharded, jax_domain):
    """Slot for slot: the same census packing and the same migrate give
    the same active masks, and positions within the step's tolerance."""
    n, ranks = sharded
    got = ranks[0]["off"]["state"]
    for field, w in jax_domain(n).items():
        g = got[field]
        assert g.dtype == w.dtype and g.shape == w.shape, field
        if field in TOL:
            rtol, atol = TOL[field]
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=field)
        else:
            np.testing.assert_array_equal(g, w, err_msg=field)


# ------------------------------------------------------------- migrate
def jax_migrate(n, pos, act, lx, m, hops):
    """JAX's migrate under shard_map on n CPU devices, `hops` times."""
    def local(p, a):
        x0 = jax.lax.axis_index(AXIS).astype(jnp.int32) * lx
        p, a, nd = jpd.migrate(p, a, x0, lx, m)
        return p, a, jax.lax.psum(nd, AXIS)

    fn = jax.jit(jax.shard_map(local, mesh=jax_make_mesh(n),
                               in_specs=(P(AXIS), P(AXIS)),
                               out_specs=(P(AXIS), P(AXIS), P())))
    p, a = jnp.asarray(pos), jnp.asarray(act)
    runs = []
    for _ in range(hops):
        p, a, nd = fn(p, a)
        runs.append((np.asarray(p), np.asarray(a), int(nd)))
    return runs


@pytest.mark.parametrize("name", MIGRATE_CASES)
def test_migrate_equals_jax_bitwise(sharded, name):
    """Positions of every slot (stale rows included), active mask and
    drop count after each exchange, against JAX's migrate."""
    n, ranks = sharded
    pos, act, lx, m, hops = migrate_case(name, n)
    want = jax_migrate(n, pos, act, lx, m, hops)
    got = ranks[0][f"migrate_{name}"]
    assert len(got) == len(want) == hops
    for (gp, ga, gd), (wp, wa, wd) in zip(got, want):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(ga, wa)
        assert gd == wd
        # the drop count is exactly the particles lost
        assert ga.sum() == act.sum() - gd
        act = ga


@pytest.mark.parametrize("name", MIGRATE_CASES)
def test_migrate_out_form_equals_its_return_and_jax(sharded, name):
    """`migrate` writing into the tensors it is given, in place over the
    moved rows and over sentinels (so that a row or flag left unwritten
    shows): every slot's row, the flags and the drop count after each hop,
    bitwise against its returning form and JAX's migrate.  The cases hold
    a full send buffer, full slots, a multi-slab crosser, fewer holes
    than 2m, fewer slots than 2m and non-finite positions."""
    n, ranks = sharded
    pos, act, lx, m, hops = migrate_case(name, n)
    want = jax_migrate(n, pos, act, lx, m, hops)
    ret = ranks[0][f"migrate_{name}"]
    for form, runs in ranks[0][f"migrate_out_{name}"].items():
        assert len(runs) == hops, form
        for (gp, ga, gd, same), (rp, ra, rd), (wp, wa, wd) in zip(
                runs, ret, want):
            assert same, form
            for g, r, w in ((gp, rp, wp), (ga, ra, wa)):
                np.testing.assert_array_equal(g, r, err_msg=form)
                np.testing.assert_array_equal(g, w, err_msg=form)
            assert gd == rd == wd, form


def _migrated(sharded, name):
    n, ranks = sharded
    pos, act, lx, m, hops = migrate_case(name, n)
    return n, pos, act, lx, m, ranks[0][f"migrate_{name}"]


def test_migrate_exchanges_boundary_crossers(sharded):
    n, pos, act, lx, m, [(new_pos, new_act, nd)] = _migrated(sharded,
                                                             "exchange")
    slots = len(pos) // n
    assert nd == 0 and new_act.sum() == act.sum()
    for i in range(n):
        seg = slice(i * slots, (i + 1) * slots)
        xs = np.floor(new_pos[seg][new_act[seg]][:, 0]).astype(int)
        assert ((xs >= lx * i) & (xs < lx * (i + 1))).all()   # owned now
    np.testing.assert_array_equal(sorted_active(pos, act),
                                  sorted_active(new_pos, new_act))


def test_migrate_send_overflow_counts_drops(sharded):
    """Crossers beyond the m-row buffer are deactivated and counted."""
    n, pos, act, lx, m, [(new_pos, new_act, nd)] = _migrated(
        sharded, "send_overflow")
    slots = len(pos) // n
    assert nd == 2 and new_act.sum() == act.sum() - 2
    seg = slice(slots, 2 * slots)
    arrived = new_pos[seg][new_act[seg]]
    assert len(arrived) == m and (np.floor(arrived[:, 0]) == 8).all()


def test_migrate_slot_exhaustion_counts_drops(sharded):
    """Arrivals beyond the destination's free slots are dropped and
    counted."""
    n, pos, act, lx, m, [(new_pos, new_act, nd)] = _migrated(
        sharded, "slot_exhaustion")
    slots = len(pos) // n
    assert nd == 2 and new_act.sum() == act.sum() - 2
    assert new_act[slots:2 * slots].all()                    # undisturbed


def test_migrate_multi_slab_crosser_one_hop_per_exchange(sharded):
    n, pos, act, lx, m, runs = _migrated(sharded, "multi_slab")
    slots = len(pos) // n
    for hop, (new_pos, new_act, nd) in enumerate(runs, start=1):
        assert nd == 0 and new_act.sum() == 1
        assert new_act[hop * slots:(hop + 1) * slots].sum() == 1
    seg = slice(len(runs) * slots, (len(runs) + 1) * slots)
    np.testing.assert_array_equal(new_pos[seg][new_act[seg]][0], pos[0])


# ------------------------------------------------------------- layout
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_domain_shard_state_equals_jax(n):
    cfg, jcfg = cfg_of("off"), cfg_of("off", JaxConfig)
    state = initial_state(cfg, device="cpu")
    parts = [pd.domain_shard_state(state, r, n, cfg) for r in range(n)]
    want = jpd.domain_shard_state(jax_initial_state(jcfg), jax_make_mesh(n),
                                  jcfg)
    for field in ("positions", "active") + GRID_FIELDS:
        dim = 1 if field == "velocity" else 0
        got = torch.cat([getattr(p, field) for p in parts], dim=dim).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(want, field)),
                                      err_msg=field)


def test_domain_shard_state_packs_by_slab():
    cfg = cfg_of("off")
    state = initial_state(cfg, device="cpu")
    lx = 32 // 8
    total = 0
    for i in range(8):
        st = pd.domain_shard_state(state, i, 8, cfg)
        seg = st.positions[st.active].numpy()
        total += len(seg)
        xs = np.floor(seg[:, 0]).astype(int)
        assert ((xs >= i * lx) & (xs < (i + 1) * lx)).all()
        # packed at the front, in index order
        assert st.active[:len(seg)].all() and not st.active[len(seg):].any()
    assert total == 4096                                     # none lost


def test_domain_shard_state_census_sizing_uneven_scene():
    """Slots come from the census of the fullest slab: here every particle
    lies in one of 8 slabs, which the mean-based size (1024 slots) would
    cut to a quarter."""
    cfg = cfg_of("off").replace(particle_init_cube_offset=(4.1, 2.0, 2.0),
                                particle_init_cube_size=(3.8, 9.0, 5.0))
    state = initial_state(cfg, device="cpu")
    parts = [pd.domain_shard_state(state, i, 8, cfg) for i in range(8)]
    assert sum(int(p.active.sum()) for p in parts) == 4096   # zero drops
    assert parts[1].active.sum() == 4096
    assert parts[0].positions.shape[0] >= 4096
    assert pd.domain_slots(cfg, 8) < 4096                    # the old floor
    assert pd.migrate_capacity(parts[0].positions.shape[0], cfg) == \
        jpd.migrate_capacity(parts[0].positions.shape[0], cfg)


def test_domain_shard_state_flagship_scene_zero_drops():
    """scaled_scene(128): the cube spans half the x extent, so half the
    slabs hold twice the mean; census sizing shards it drop-free 8 ways."""
    cfg = FluidConfig.scaled_scene(128, particle_count=1_000_000,
                                   jacobi_iters=1).replace(
        particle_sharding="domain")
    state = initial_state(cfg, device="cpu")
    held = sum(int(pd.domain_shard_state(state, i, 8, cfg).active.sum())
               for i in range(8))
    assert held == 1_000_000


# ------------------------------------------------------------- scatters
def scatter_case(seed):
    """Positions over the whole grid and past it on every side, some
    inactive."""
    r = np.random.default_rng(seed)
    g = np.array(BASE["grid_size"], np.float32)
    pos = (r.random((3000, 3)) * (g + 3) - 1.5).astype(np.float32)
    act = r.random(3000) < 0.8
    return pos, act


@pytest.mark.parametrize("shard", [0, 1, 3])
def test_detailed_occupancy_local_equals_jax(shard):
    cfg, jcfg = cfg_of("off"), cfg_of("off", JaxConfig)
    pos, act = scatter_case(shard)
    res = cfg.surface_render_resolution
    lx = 8
    got = pd.detailed_occupancy_local(torch.from_numpy(pos),
                                      torch.from_numpy(act), cfg,
                                      shard * lx * res, lx * res)
    want = jpd.detailed_occupancy_local(jnp.asarray(pos), jnp.asarray(act),
                                        jcfg, shard * lx * res, lx * res)
    assert got.dtype == torch.uint8 and got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def non_finite_scatter_case(seed):
    """scatter_case with NaN, infinite and huge coordinates on each axis,
    and all-NaN positions."""
    pos, act = scatter_case(seed)
    extremes = (float("nan"),) + NON_FINITE_X
    for row, (d, x) in enumerate((d, x) for d in range(3) for x in extremes):
        pos[row, d], act[row] = x, True
    pos[30:34] = float("nan")
    act[30:34] = True
    return pos, act


@pytest.mark.parametrize("shard", [0, 1, 3])
def test_local_scatters_non_finite_equal_jax(shard):
    """A NaN coordinate converts to index 0, as in JAX, in both local
    scatters: the first shard holds cell 0 and counts those particles."""
    cfg, jcfg = cfg_of("off"), cfg_of("off", JaxConfig)
    pos, act = non_finite_scatter_case(20 + shard)
    res, lx = cfg.surface_render_resolution, 8
    got = pd.detailed_occupancy_local(torch.from_numpy(pos),
                                      torch.from_numpy(act), cfg,
                                      shard * lx * res, lx * res)
    want = jpd.detailed_occupancy_local(jnp.asarray(pos), jnp.asarray(act),
                                        jcfg, shard * lx * res, lx * res)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = pd.cell_histogram_local(torch.from_numpy(pos),
                                  torch.from_numpy(act), BASE["grid_size"],
                                  shard * lx, lx)
    want = jpd.cell_histogram_local(jnp.asarray(pos), jnp.asarray(act),
                                    BASE["grid_size"], shard * lx, lx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if shard == 0:
        assert int(got[0, 0, 0]) >= 4


def test_domain_shard_state_non_finite_equals_jax():
    """Non-finite and huge x at set-up: the census converts them as JAX's
    numpy code does."""
    cfg, jcfg = cfg_of("off"), cfg_of("off", JaxConfig)
    state = initial_state(cfg, device="cpu")
    pos = state.positions.clone()
    pos[:len(NON_FINITE_X), 0] = torch.tensor(NON_FINITE_X)
    state = state._replace(positions=pos)
    jstate = jax_initial_state(jcfg)
    jstate = jstate._replace(positions=jnp.asarray(pos.numpy()))
    parts = [pd.domain_shard_state(state, r, 4, cfg) for r in range(4)]
    want = jpd.domain_shard_state(jstate, jax_make_mesh(4), jcfg)
    for field in ("positions", "active"):
        got = torch.cat([getattr(p, field) for p in parts]).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(want, field)),
                                      err_msg=field)


@pytest.mark.parametrize("case", ["finite", "non_finite", "outside"])
@pytest.mark.parametrize("shard", [0, 1, 3])
def test_detailed_occupancy_local_out_form_equals_jax(shard, case):
    """The scatter into a given slab of exactly its cells, prefilled with
    a sentinel: the particles outside the slab, NaN, infinite and huge
    ones among them, take no spare cell and clear no cell, and with none
    inside it the slab stays empty; bitwise against the returning form
    and JAX's."""
    cfg, jcfg = cfg_of("off"), cfg_of("off", JaxConfig)
    pos, act = (non_finite_scatter_case(20 + shard) if case == "non_finite"
                else scatter_case(shard))
    res, lx = cfg.surface_render_resolution, 8
    if case == "outside":
        pos[:, 0] = shard * lx + lx + 1.5
    args = (torch.from_numpy(pos), torch.from_numpy(act), cfg,
            shard * lx * res, lx * res)
    ret = pd.detailed_occupancy_local(*args)
    given = sentinel(ret)
    got = pd.detailed_occupancy_local(*args, out=given)
    want = jpd.detailed_occupancy_local(jnp.asarray(pos), jnp.asarray(act),
                                        jcfg, shard * lx * res, lx * res)
    assert got is given and bool(got.any()) == (case != "outside")
    assert torch.equal(got, ret)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shard", [0, 1, 3])
def test_cell_histogram_local_equals_jax(shard):
    """Ported for the volume correction of the domain path, which the
    sharded step does not run yet."""
    pos, act = scatter_case(10 + shard)
    got = pd.cell_histogram_local(torch.from_numpy(pos),
                                  torch.from_numpy(act), BASE["grid_size"],
                                  shard * 8, 8)
    want = jpd.cell_histogram_local(jnp.asarray(pos), jnp.asarray(act),
                                    BASE["grid_size"], shard * 8, 8)
    assert got.dtype == torch.int32 and int(got.sum()) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
