"""The SPMD program form (`tpu_fluid_torch/parallel/spmd_step.py`:
`jit_spmd_step`, `jit_spmd_multi_step`).

On the CPU the graphed entry points run the eager sharded step: they are
held against `spmd_multi_step` bitwise and against JAX's jitted 1-device
`spmd_step` (pallas_mode "off", or "interpret" for the fused path, as the
JAX package's own SPMD tests run it) at the tolerances of
tests/tpu/test_spmd_tpu.py:_assert_parity; the unrolled volume cadence
against the eager host read; the graph entries' bookkeeping for the
sharded program behind the CPU stand-in capture of test_torch_graph.py.
On the card (the `cuda` tests, which skip here) 1-rank replays against
eager sharded steps bitwise, the host-staged refusal and the nccl mesh's
current card."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_graph import stand_in  # noqa: F401  (a fixture)
from test_torch_spmd import cfg_of, scene_of
from tpu_fluid.core import scene_fields as jscene
from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid.core.state import initial_state as jax_initial_state
from tpu_fluid.parallel.mesh import make_mesh as jax_make_mesh
from tpu_fluid.parallel.mesh import shard_state as jax_shard_state
from tpu_fluid.parallel.particles_domain import \
    domain_shard_state as jax_domain_shard_state
from tpu_fluid.parallel.spmd_step import spmd_step as jax_spmd_step
from tpu_fluid_torch import initial_state
from tpu_fluid_torch.core.state import state_to_numpy
from tpu_fluid_torch.parallel.mesh import Mesh, make_mesh
from tpu_fluid_torch.parallel.particles_domain import layout_state
from tpu_fluid_torch.parallel.spmd_step import (_local_step,
                                                jit_spmd_multi_step,
                                                jit_spmd_step,
                                                spmd_multi_step, spmd_program)
from tpu_fluid_torch.solver import graph

torch.set_num_threads(2)
STEPS = 3
CONFIGS = ("fused", "obstacles", "physics")
SHARDINGS = ("index", "domain")
# tests/tpu/test_spmd_tpu.py:_assert_parity
RTOL = ATOL = 3e-7
VOLUME4 = dict(volume_correction=1.0, volume_correction_every=4,
               volume_target_density=4.0)


def cpu_mesh():
    return make_mesh(1, device="cpu")


def local_state(cfg, device="cpu"):
    """The 1-rank layout of cfg's initial state, by its sharding."""
    return layout_state(initial_state(cfg, device=device), 0, 1, cfg)


def config(name, sharding, package=None):
    return (cfg_of(name) if package is None else cfg_of(name, package)
            ).replace(particle_sharding=sharding)


def assert_states_equal(got, want, label=""):
    for name, g, w in zip(want._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (label, name)
        assert torch.equal(g, w), (label, name)


def cloned(state):
    return type(state)(*(t.clone() for t in state))


def sorted_rows(pos, act):
    rows = pos[act]
    return rows[np.lexsort(rows.T[::-1])]


# ------------------------------------------------------------- on the CPU
@pytest.mark.parametrize("sharding", SHARDINGS)
@pytest.mark.parametrize("name", CONFIGS)
def test_jit_spmd_equals_eager_spmd_bitwise(name, sharding):
    cfg = config(name, sharding)
    mesh = cpu_mesh()
    scene = scene_of(name, cfg)
    state0 = local_state(cfg)
    n0 = len(graph.captures)
    want = spmd_multi_step(cfg, mesh, STEPS, scene)(state0)
    step = jit_spmd_step(cfg, mesh, scene)
    s = state0
    for _ in range(STEPS):
        s = step(s)
    assert_states_equal(s, want, "jit_spmd_step")
    assert_states_equal(jit_spmd_multi_step(cfg, mesh, STEPS, scene)(state0),
                        want, "jit_spmd_multi_step")
    assert int(s.step) == STEPS
    assert len(graph.captures) == n0             # no graph on the CPU


@pytest.mark.parametrize("sharding", SHARDINGS)
@pytest.mark.parametrize("name", CONFIGS)
def test_jit_spmd_matches_jax_spmd_step(name, sharding):
    """STEPS steps of `jit_spmd_multi_step` against JAX's jitted
    `spmd_step(make_mesh(1), cfg, donate=False)`: integer fields exact,
    f32 fields and the active positions (as sorted rows) to rtol and atol
    3e-7.  "physics" runs the volume cadence every 2 (steps 0 and 2
    corrected) with scene fields."""
    cfg = config(name, sharding)
    jcfg = config(name, sharding, JaxConfig)
    got = state_to_numpy(jit_spmd_multi_step(
        cfg, cpu_mesh(), STEPS, scene_of(name, cfg))(local_state(cfg)))
    jmesh = jax_make_mesh(1)
    jstate = jax_initial_state(jcfg)
    jstate = (jax_domain_shard_state(jstate, jmesh, jcfg)
              if sharding == "domain" else jax_shard_state(jstate, jmesh))
    jscene_ = scene_of(name, jcfg, jscene)
    run = jax_spmd_step(jmesh, jcfg, donate=False, scene=jscene_)
    for _ in range(STEPS):
        jstate = run(jstate) if jscene_ is None else run(jstate, jscene_)
    want = {k: np.asarray(jax.device_get(v))
            for k, v in jstate._asdict().items()}
    for field in ("cell_types", "inertia", "detailed_occ", "step",
                  "dropped"):
        np.testing.assert_array_equal(got[field], want[field],
                                      err_msg=field)
    for field in ("velocity", "float_dens_1", "float_dens_2"):
        np.testing.assert_allclose(got[field], want[field], rtol=RTOL,
                                   atol=ATOL, err_msg=field)
    a = sorted_rows(got["positions"], got["active"])
    b = sorted_rows(want["positions"], want["active"])
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                               err_msg="positions")


@pytest.mark.parametrize("sharding", SHARDINGS)
@pytest.mark.parametrize("phase", range(4))
def test_unrolled_volume_step_picks_the_eager_branch(phase, sharding):
    """From a state at each phase of the cadence every 4: the step given
    its number (as a graph unrolls it) equals the step that reads it on
    the host, and differs from the step given the next number where only
    one of the two is corrected."""
    cfg = config("obstacles", sharding).replace(**VOLUME4)
    mesh = cpu_mesh()
    state = local_state(cfg)
    state = state._replace(step=torch.full_like(state.step, phase))
    eager = _local_step(state, cfg, mesh)
    assert_states_equal(_local_step(state, cfg, mesh, volume_step=phase),
                        eager, f"phase {phase}")
    other = _local_step(state, cfg, mesh, volume_step=phase + 1)
    assert torch.equal(other.positions, eager.positions) == \
        ((phase % 4 == 0) == ((phase + 1) % 4 == 0))


@pytest.mark.parametrize("sharding", SHARDINGS)
@pytest.mark.parametrize("name", ["off", "volume"])
def test_one_rank_through_every_kernel_wrapper(monkeypatch, name,
                                               sharding):
    """The 1-rank step with every stage's kernel wrapper in place of its
    plain call, as on the card: on CPU tensors each wrapper checks its
    inputs (dtype, shape, contiguity) as there, then runs its plain
    version.  Equal to the eager plain step bitwise."""
    from tpu_fluid_torch.parallel import particles_domain
    from tpu_fluid_torch.parallel import spmd_step as spmd_module
    from tpu_fluid_torch.stages import (particles, pressure, surface_fields,
                                        velocity)
    cfg = config(name, sharding).replace(advect_method="auto")
    mesh = cpu_mesh()
    want = spmd_multi_step(cfg, mesh, STEPS)(local_state(cfg))
    for module in (spmd_module, particles_domain, particles, pressure,
                   surface_fields, velocity):
        monkeypatch.setattr(module, "kernel_choice", lambda cfg, dev: True)
    got = jit_spmd_multi_step(cfg, mesh, STEPS)(local_state(cfg))
    assert_states_equal(got, want, f"{name} {sharding}")


# ------------------------------------------- graph entries, behind a stand-in
def eager_spmd(state, cfg, n):
    return spmd_multi_step(cfg, cpu_mesh(), n)(state)


@pytest.mark.parametrize("volume", [False, True], ids=["plain", "volume"])
def test_spmd_lineages_keep_their_entries_behind_a_stand_in(stand_in,  # noqa: F811
                                                            volume):
    """Two lineages of one sharded graph key in turn (B after 2 eager
    steps, or 3 with the cadence every 2: the other phase), then a
    `jit_spmd_multi_step` of 3 each, each bitwise against its own eager
    sharded steps; one warm-up a key, and every capture of the sharded
    program."""
    cfg = config("obstacles", "index")
    b_steps = 2
    if volume:
        cfg = cfg.replace(volume_correction=1.0, volume_correction_every=2,
                          volume_target_density=4.0)
        b_steps = 3
    mesh = cpu_mesh()
    one, three = jit_spmd_step(cfg, mesh), jit_spmd_multi_step(cfg, mesh, 3)
    n0 = len(graph.captures)
    a = local_state(cfg)
    b = eager_spmd(local_state(cfg), cfg, b_steps)
    b = b._replace(velocity=b.velocity + 0.5)
    want_a, want_b = cloned(a), cloned(b)
    for k in range(3):
        a, b = one(a), one(b)
        want_a, want_b = eager_spmd(want_a, cfg, 1), eager_spmd(want_b, cfg, 1)
        assert_states_equal(a, want_a, f"A, jit_spmd_step {k}")
        assert_states_equal(b, want_b, f"B, jit_spmd_step {k}")
    a, b = three(a), three(b)
    assert_states_equal(a, eager_spmd(want_a, cfg, 3), "A, multi")
    assert_states_equal(b, eager_spmd(want_b, cfg, 3), "B, multi")
    made = graph.captures[n0:]
    assert {c["program"] for c in made} == {spmd_program(cfg, mesh).key}
    keys = [c["n_steps"] for c in made]
    assert [c["warm_up"] for c in made] == \
        [keys.index(k) == i for i, k in enumerate(keys)]
    assert all(c["residual"] == [] for c in made)
    if not volume:
        assert [(c["n_steps"], c["src"]) for c in made] == \
            [(1, 0), (1, 0), (1, 1), (1, 1), (3, 0), (3, 0)]


def test_spmd_dropped_lineage_entry_is_reused_behind_a_stand_in(stand_in):  # noqa: F811
    cfg = config("obstacles", "domain")
    step = jit_spmd_step(cfg, cpu_mesh())
    a = step(step(local_state(cfg)))
    n0 = len(graph.captures)
    kept = a.velocity[0]
    del a
    b = step(eager_spmd(local_state(cfg), cfg, 1))
    assert len(graph.captures) == n0 + 1         # a's entry is held
    del kept, b
    c0 = eager_spmd(local_state(cfg), cfg, 2)
    c = step(c0)
    assert len(graph.captures) == n0 + 1         # a's entry, reused
    assert_states_equal(c, eager_spmd(c0, cfg, 1), "reused entry")


def test_spmd_state_is_consumed_only_when_passed_in(stand_in):  # noqa: F811
    cfg = config("obstacles", "index")
    step = jit_spmd_step(cfg, cpu_mesh())
    s0 = local_state(cfg)
    keep0 = cloned(s0)
    s1 = step(s0)
    assert_states_equal(s0, keep0, "foreign state")
    keep1 = cloned(s1)
    other = step(local_state(cfg))
    assert_states_equal(s1, keep1, "another lineage's call")
    s2 = step(s1)
    assert s2.velocity.data_ptr() != s1.velocity.data_ptr()
    assert_states_equal(s1, keep1, "s1 until s2 is passed in")
    keep2 = cloned(s2)
    assert_states_equal(s2, eager_spmd(keep1, cfg, 1), "s2, in the other set")
    s3 = step(s2)
    assert s3.velocity.data_ptr() == s1.velocity.data_ptr()
    assert_states_equal(s3, eager_spmd(keep2, cfg, 1), "s3, in s1's set")
    assert other.velocity.data_ptr() not in (s2.velocity.data_ptr(),
                                             s3.velocity.data_ptr())


def test_mesh_is_part_of_the_graph_key(stand_in):  # noqa: F811
    """The single-device program and the 1-rank sharded one capture apart;
    two entry points of one mesh share their key; meshes of another rank,
    size, backend or device key apart."""
    from tpu_fluid_torch import jit_step
    cfg = config("obstacles", "index")
    mesh = cpu_mesh()
    n0 = len(graph.captures)
    jit_step(local_state(cfg), cfg)
    s = jit_spmd_step(cfg, mesh)(local_state(cfg))
    assert [c["program"] for c in graph.captures[n0:]] == \
        [None, spmd_program(cfg, mesh).key]
    jit_spmd_step(cfg, cpu_mesh())(s)            # a new function, one key
    # of that key's entry: the graph from the lineage's other set, with no
    # warm-up
    assert len(graph.captures) == n0 + 3
    assert graph.captures[-1]["src"] == 1
    assert not graph.captures[-1]["warm_up"]
    key = spmd_program(cfg, mesh).key
    assert key == ("spmd", 0, 1, None, torch.device("cpu"))
    assert len({key, ("spmd", 1, 2, "gloo", torch.device("cpu")),
                ("spmd", 0, 2, "nccl", torch.device("cuda", 0)),
                ("spmd", 0, 1, None, torch.device("cuda", 0))}) == 4


@pytest.fixture
def host_staged_mesh(tmp_path):
    """A 1-rank gloo group in this process, as a mesh on a CUDA device:
    the host-staged transport."""
    dist.init_process_group("gloo", init_method=(tmp_path / "rdv").as_uri(),
                            rank=0, world_size=1)
    try:
        yield Mesh(0, 1, torch.device("cuda", 0), dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def test_host_staged_mesh_raises_naming_the_eager_step(host_staged_mesh):
    assert host_staged_mesh.host_staged
    cfg = config("obstacles", "index")
    for make in (lambda: jit_spmd_step(cfg, host_staged_mesh),
                 lambda: jit_spmd_multi_step(cfg, host_staged_mesh, 3)):
        with pytest.raises(ValueError, match="eager spmd_step"):
            make()


def test_bad_calls_raise():
    cfg = config("obstacles", "index")
    with pytest.raises(ValueError):
        jit_spmd_multi_step(cfg, cpu_mesh(), 0)(local_state(cfg))
    with pytest.raises(ValueError):              # 32 rows over 64 shards
        jit_spmd_step(cfg, Mesh(0, 64, torch.device("cpu")))


# ------------------------------------------------------------------ on card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured and "
                    "replayed only there")
    graph.clear_graphs()
    yield torch.device("cuda", 0)
    graph.clear_graphs()


CARD = dict(grid_size=(16, 16, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("sharding", SHARDINGS)
def test_cuda_spmd_replays_equal_eager_spmd_bitwise(cuda_device, sharding,
                                                    fused):
    cfg = config("obstacles", sharding).replace(
        advect_method="auto", grid_fused=fused, pallas_mode="auto", **CARD)
    mesh = make_mesh(1, device=cuda_device)
    state0 = spmd_multi_step(cfg, mesh, 2)(local_state(cfg, cuda_device))
    want = spmd_multi_step(cfg, mesh, STEPS)(state0)
    step = jit_spmd_step(cfg, mesh)
    s = state0
    for _ in range(STEPS):
        s = step(s)
    assert_states_equal(s, want, "jit_spmd_step")
    assert_states_equal(jit_spmd_multi_step(cfg, mesh, STEPS)(state0), want,
                        "jit_spmd_multi_step")


@pytest.mark.cuda
def test_cuda_host_staged_mesh_raises(cuda_device, host_staged_mesh):
    cfg = config("obstacles", "index").replace(**CARD)
    with pytest.raises(ValueError, match="eager spmd_step"):
        jit_spmd_step(cfg, host_staged_mesh)(local_state(cfg, cuda_device))


@pytest.mark.cuda
def test_cuda_nccl_mesh_makes_its_card_current(cuda_device):
    last = torch.cuda.device_count() - 1
    try:
        mesh = make_mesh(1, device=f"cuda:{last}", backend="nccl")
        assert mesh.device == torch.device("cuda", last)
        assert torch.cuda.current_device() == last
        mesh = make_mesh(1, backend="nccl")
        assert torch.cuda.current_device() == mesh.device.index == 0
    finally:
        torch.cuda.set_device(0)
