"""Buffer donation in the graphed steps (`tpu_fluid_torch/solver/graph.py`):
each step writes its new fields into the set it is given (`into`), each
by the field's last writer, and the graph of each lineage steps between
two buffer sets.

On the CPU: `simulation_step(state, cfg, into=dst)` and one shard's
`_local_step(..., into=dst)` (a 1-rank mesh in this process, 2 gloo ranks
spawned) put every field they write at `dst`'s pointers under either
particle sharding, leave the input as it was, and equal the step without
`into` bitwise, in each variant of the options; the domain-sharded
program's graph body (`graph._record`) ends with no residual hand-over;
every kernel wrapper's `out=` form equals its return without it; behind
the stand-in capture of tests/test_torch_graph.py, two interleaved
lineages alternate between their sets and equal their eager steps
bitwise, and a lineage under the volume cadence stays in its entry."""

import numpy as np
import pytest
import torch

from test_torch_graph import (VOLUME, assert_states_equal, cloned, eager,
                              option_scene, stand_in)  # noqa: F401
from test_torch_spmd import SPAWN_TIMEOUT, cfg_of, scene_of
from test_torch_step import CFG
from tpu_fluid_torch import initial_state, jit_step, simulation_step
from tpu_fluid_torch.core.state import FluidState
from tpu_fluid_torch.kernels import grid_fused as k6
from tpu_fluid_torch.kernels.particle_move import (particle_move_cuda,
                                                   particle_move_local_cuda)
from tpu_fluid_torch.kernels.surface_fused import (surface_fused_cuda,
                                                   surface_fused_halo_cuda)
from tpu_fluid_torch.parallel.launch import run_ranks
from tpu_fluid_torch.parallel.mesh import make_mesh, shard_scene
from tpu_fluid_torch.parallel.particles_domain import layout_state
from tpu_fluid_torch.parallel.spmd_step import (_local_step, _surface_kw,
                                                spmd_program)
from tpu_fluid_torch.solver import graph

torch.set_num_threads(2)

# the step's variants: the options beyond the reference and the paths
STEP_VARIANTS = {
    "default": {},
    "fused": dict(pallas_mode="interpret", grid_fused=True),
    "volume": VOLUME,
    "levelset": dict(surface_method="levelset"),
    "redblack": dict(pressure_solver="redblack"),
    "scene": {},
    "surface_off": dict(surface_enabled=False),
}
# the fields each variant passes through unchanged
PASSED = {"surface_off": ("inertia", "float_dens_1", "float_dens_2"),
          "levelset": ("inertia",)}
SHARDED = ("fused", "obstacles", "physics")


def sentinel(t: torch.Tensor) -> torch.Tensor:
    """A tensor like `t` to write into, every element a value no step
    writes (NaN, 0xAB, -7), so that an element left unwritten shows."""
    if t.dtype.is_floating_point:
        return torch.full_like(t, float("nan"))
    if t.dtype == torch.bool:
        return torch.ones_like(t)
    return torch.full_like(t, 0xAB if t.dtype == torch.uint8 else -7)


def sentinel_like(state) -> FluidState:
    return FluidState(*(sentinel(t) for t in state))


def into_problems(got, state, dst, before, want, passed):
    """What breaks the `into` contract: a field passed through that should
    not be or the other way round, a written field not at `dst`'s pointer,
    the input changed, or the result not `want` bitwise."""
    problems = []
    for name, g, s, d, b, w in zip(FluidState._fields, got, state, dst,
                                   before, want):
        if (g is s) != (name in passed):
            problems.append(f"{name}: passed through {g is s}")
        elif g is not s and g.data_ptr() != d.data_ptr():
            problems.append(f"{name}: not written into the set")
        if not torch.equal(s, b):
            problems.append(f"{name}: the input changed")
        if not (g.dtype == w.dtype and torch.equal(g, w)):
            problems.append(f"{name}: differs from the step without into")
    return problems


@pytest.mark.parametrize("name", list(STEP_VARIANTS))
def test_step_into_writes_every_field_in_place(name):
    """From the state after 2 eager steps (for volume, step 2: a corrected
    one) and after 3 (step 3: not corrected)."""
    cfg = CFG.replace(**STEP_VARIANTS[name])
    scene = option_scene(name, cfg)
    state = eager(initial_state(cfg, device="cpu"), cfg, 2, scene)
    for k in range(2):
        before = cloned(state)
        want = simulation_step(state, cfg, scene)
        dst = sentinel_like(state)
        got = simulation_step(state, cfg, scene, into=dst)
        assert into_problems(got, state, dst, before, want,
                             ("active", "dropped") + PASSED.get(name, ())
                             ) == [], (name, k)
        state = want


def local_into_problems(cfg, mesh, scene) -> list:
    """`_local_step` with `into` against it without, from this shard's
    layout of the state after 1 and after 2 eager sharded steps."""
    state = layout_state(initial_state(cfg, device="cpu"), mesh.rank,
                         mesh.size, cfg)
    state = _local_step(state, cfg, mesh, scene)
    problems = []
    for k in range(2):
        before = cloned(state)
        want = _local_step(state, cfg, mesh, scene)
        dst = sentinel_like(state)
        got = _local_step(state, cfg, mesh, scene, into=dst)
        problems += [f"step {k + 1}: {p}" for p in into_problems(
            got, state, dst, before, want, passed_fields(cfg, mesh))]
        state = want
    return problems


def passed_fields(cfg, mesh) -> tuple:
    """The fields the sharded step passes through."""
    passed = ("dropped",) if cfg.particle_sharding == "index" else ()
    if cfg.particle_sharding == "index" or mesh.size == 1:
        passed += ("active",)
    if cfg.surface_method == "levelset":
        passed += ("inertia",)
    return passed


def sharded_config(name, sharding):
    return cfg_of(name).replace(particle_sharding=sharding)


@pytest.mark.parametrize("sharding", ["index", "domain"])
@pytest.mark.parametrize("name", SHARDED)
def test_local_step_into_on_one_rank(name, sharding):
    cfg = sharded_config(name, sharding)
    assert local_into_problems(cfg, make_mesh(1, device="cpu"),
                               scene_of(name, cfg)) == []


def record_residuals(cfg, mesh, scene) -> dict:
    """The residual fields `graph._record` finds for this shard's program
    of 1 and of 2 steps, from each set of a new entry in turn, as its
    graphs are captured."""
    program = spmd_program(cfg, mesh)
    state = layout_state(initial_state(cfg, device="cpu"), mesh.rank,
                         mesh.size, cfg)
    out = {}
    for n_steps in (1, 2):
        entry = graph._Entry.of(state, scene)
        for src in (0, 1):
            out[(n_steps, src)] = graph._record(entry, src, cfg, n_steps, 0,
                                                program)
            entry.graphs[(src, None)] = "recorded"
    return out


def _into_rank(rank, n, init_method):
    torch.set_num_threads(1)
    mesh = make_mesh(n, rank, init_method, device="cpu")
    out = {}
    for sharding in ("index", "domain"):
        for name in SHARDED:
            cfg = sharded_config(name, sharding)
            scene = scene_of(name, cfg)
            if scene is not None:
                scene = shard_scene(scene, rank, n)
            out[(name, sharding)] = local_into_problems(cfg, mesh, scene)
            if sharding == "domain":
                out[(name, "record")] = record_residuals(cfg, mesh, scene)
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """`_into_rank`'s results on 2 gloo ranks, one spawn for the file."""
    return run_ranks(_into_rank, 2, timeout=SPAWN_TIMEOUT,
                     workdir=tmp_path_factory.mktemp("rendezvous"))


def test_local_step_into_on_two_gloo_ranks(two_ranks):
    for rank, out in enumerate(two_ranks):
        problems = {k: v for k, v in out.items() if k[1] != "record"}
        assert all(p == [] for p in problems.values()), (rank, problems)


@pytest.mark.parametrize("name", SHARDED)
def test_domain_program_records_no_residual_on_one_rank(name):
    cfg = sharded_config(name, "domain")
    residual = record_residuals(cfg, make_mesh(1, device="cpu"),
                                scene_of(name, cfg))
    assert all(r == [] for r in residual.values()), residual


@pytest.mark.parametrize("name", SHARDED)
def test_domain_program_records_no_residual_on_two_gloo_ranks(two_ranks,
                                                              name):
    for rank, out in enumerate(two_ranks):
        residual = out[(name, "record")]
        assert all(r == [] for r in residual.values()), (rank, residual)


# ------------------------------------------------------ the wrappers' out=
def _rng_tensor(rng, shape, kind):
    if kind == "f32":
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    if kind == "occ":
        return torch.from_numpy((rng.random(shape) < 0.3).astype(np.uint8))
    return torch.from_numpy(rng.integers(0, 4, shape).astype(np.uint8))


def _halos(rng, shape, h, kind):
    """(slab, (left, right)) with h random planes a side on dim -3."""
    ext = list(shape)
    ext[-3] += 2 * h
    a = _rng_tensor(rng, tuple(ext), kind)
    lx = shape[-3]
    return (a.narrow(-3, h, lx).contiguous(),
            (a.narrow(-3, 0, h).contiguous(),
             a.narrow(-3, h + lx, h).contiguous()))


def wrapper_cases():
    """(name, wrapper, args, kwargs, how many outputs) on small seeded
    inputs; None as the count for a single tensor."""
    rng = np.random.default_rng(3)
    cfg = CFG
    n = cfg.grid_size[0]
    grid = (n, n, n)
    kw5 = _surface_kw(cfg)
    h5 = kw5["steps"] + 1
    vel = _rng_tensor(rng, (3,) + grid, "f32")
    types = _rng_tensor(rng, grid, "types")
    pos = torch.from_numpy((rng.random((600, 3)) * (n + 2) - 1).astype(
        np.float32))
    active = torch.from_numpy(rng.random(600) < 0.9)
    d = (2 * n,) * 3
    surf = [_rng_tensor(rng, d, "occ"), _rng_tensor(rng, d, "types"),
            _rng_tensor(rng, d, "f32"), _rng_tensor(rng, d, "occ")]
    slab = (2 * h5,) + d[1:]
    surf_h = [_halos(rng, slab, h5, k) for k in ("occ", "types", "f32",
                                                  "occ")]
    lx = 4
    s6 = (lx, n, n)
    occ_s, occ_h = _halos(rng, s6, 2, "occ")
    old_s, old_h = _halos(rng, s6, 2, "types")
    vel_s, vel_h = _halos(rng, (3,) + s6, 2, "f32")
    t1, t1_h = _halos(rng, s6, 1, "types")
    p1, p1_h = _halos(rng, s6, 1, "f32")
    v1, v1_h = _halos(rng, (3,) + s6, 1, "f32")
    vel_e = _rng_tensor(rng, (3, lx + 2, n, n), "f32")
    return [
        ("K3+K4", particle_move_cuda,
         (vel, pos, active, cfg.dt, 2), {}, 2),
        ("K3+K4 local", particle_move_local_cuda,
         (vel_e, pos, active, cfg.dt, 4, grid), {}, None),
        ("K5", surface_fused_cuda, tuple(surf), kw5, 3),
        ("K5 halo", surface_fused_halo_cuda, tuple(a for a, _ in surf_h),
         dict(kw5, halos=tuple(h for _, h in surf_h), x0=2 * h5,
              global_gx=6 * h5), 3),
        ("K6a", k6.classify_extrap_cuda,
         (_rng_tensor(rng, d, "occ"), types, vel, cfg), dict(pool=2), 2),
        ("K6a halo", k6.classify_extrap_halo_cuda,
         (occ_s, old_s, vel_s, cfg),
         dict(halos=(occ_h, old_h, vel_h), x0=4, global_gx=n), 2),
        ("K6c", k6.project_cuda,
         (types, _rng_tensor(rng, grid, "f32"), vel, cfg), {}, None),
        ("K6c halo", k6.project_halo_cuda, (t1, p1, v1, cfg),
         dict(halos=(t1_h, p1_h, v1_h), x0=4, global_gx=n), None),
    ]


CASES = {case[0]: case for case in wrapper_cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_out_form_equals_its_return(name):
    """On CPU tensors each wrapper's `out=` form (every output given, then
    the first only) writes the given tensors and returns them, equal
    bitwise to its return without `out=`."""
    _, wrapper, args, kw, count = CASES[name]
    want = wrapper(*args, **kw)
    if count is None:
        out = sentinel(want)
        got = wrapper(*args, out=out, **kw)
        assert got is out and torch.equal(got, want)
        return
    for given in (count, 1):
        out = tuple(sentinel(w) if i < given else None
                    for i, w in enumerate(want))
        got = wrapper(*args, out=out, **kw)
        for g, o, w in zip(got, out, want):
            assert o is None or g is o, (name, given)
            assert torch.equal(g, w), (name, given)


def test_wrapper_out_form_checks_the_given_tensors():
    _, wrapper, args, kw, _ = CASES["K6c"]
    want = wrapper(*args, **kw)
    for bad in (want[:2].clone(), want.double(), want.transpose(1, 2)):
        with pytest.raises((TypeError, ValueError)):
            wrapper(*args, out=bad, **kw)


# ----------------------------------------- the two sets, behind a stand-in
@pytest.mark.parametrize("name", ["plain", "volume"])
def test_interleaved_lineages_alternate_sets_behind_a_stand_in(stand_in,
                                                                name):
    """Two lineages, 5 `jit_step` calls each in turn: each result bitwise
    against its own eager steps, in the set its state two calls before
    was in, never in the set of the state it was given."""
    cfg = CFG.replace(**(VOLUME if name == "volume" else {}))
    a = initial_state(cfg, stand_in)
    b = eager(initial_state(cfg, stand_in), cfg, 3)
    b = b._replace(velocity=b.velocity + 0.5)
    want = [a, b]
    got = [a, b]
    ptrs = [[], []]
    for k in range(5):
        for i in (0, 1):
            given = got[i].velocity.data_ptr()
            got[i] = jit_step(got[i], cfg)
            want[i] = eager(want[i], cfg, 1)
            ptr = got[i].velocity.data_ptr()
            assert ptr != given
            if k >= 2:
                assert ptr == ptrs[i][k - 2], (i, k)
            ptrs[i].append(ptr)
        for i in (0, 1):
            assert_states_equal(got[i], want[i], f"lineage {i}, call {k}")
    assert len(set(ptrs[0][:2] + ptrs[1][:2])) == 4


@pytest.mark.parametrize("every", [2, 4])
def test_volume_lineage_stays_in_its_entry_behind_a_stand_in(
        stand_in, monkeypatch, every):
    """A lineage under the volume cadence: one entry a key, its graphs by
    (set, phase), and no state copied in after its first call."""
    cfg = CFG.replace(**dict(VOLUME, volume_correction_every=every))
    copied = []
    load = graph._load

    def counting_load(buffers, values):
        copied.extend(d.data_ptr() != s.data_ptr()
                      for d, s in zip(buffers, values) if s is not None)
        load(buffers, values)
    monkeypatch.setattr(graph, "_load", counting_load)
    s0 = initial_state(cfg, stand_in)
    s = jit_step(s0, cfg)
    want = eager(s0, cfg, 1)
    for k in range(2 * every + 1):
        s = jit_step(s, cfg)
        want = eager(want, cfg, 1)
        assert_states_equal(s, want, f"call {k + 1}")
    assert not any(copied)
    (entries,) = graph._GRAPHS.values()
    (entry,) = entries
    assert sorted(entry.graphs) == sorted(
        (k % 2, k % every) for k in range(max(2, every)))
