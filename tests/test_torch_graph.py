"""`jit_step` and `jit_multi_step` (`tpu_fluid_torch/solver/graph.py`): on
the CPU n eager steps, against the port's `step` bitwise and against the
JAX package's `jit_multi_step` on a state carried from JAX; the entries'
bookkeeping (one per live lineage, the donation rule) behind a stand-in
capture that replays eager steps on the CPU; on the card (the `cuda`
tests, which skip here) CUDA-graph replays against the eager step bitwise,
the capture cache and the donation rule."""

import jax
import numpy as np
import pytest
import torch

from test_torch_step import CFG, KW, assert_states_close, jax_numpy
from tpu_fluid.core import scene_fields as jscene
from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid.core.state import initial_state as jax_initial_state
from tpu_fluid.solver.step import jit_multi_step as jax_jit_multi_step
from tpu_fluid.solver.step import simulation_step as jax_step
from tpu_fluid_torch import (SceneFields, initial_state, jit_multi_step,
                             jit_step, solid_sphere, step, vortex_force)
from tpu_fluid_torch.core.state import state_from_numpy, state_to_numpy
from tpu_fluid_torch.solver import graph

torch.set_num_threads(2)


def assert_states_equal(got, want, label=""):
    for name, g, w in zip(want._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (label, name)
        assert torch.equal(g, w), (label, name)


def cloned(state):
    return type(state)(*(t.clone() for t in state))


def eager(state, cfg, n, scene=None):
    for _ in range(n):
        state = step(state, cfg, scene)
    return state


# the options beyond the reference: (a) volume correction every 2 steps,
# (b) the level set, (c) the red-black solver, (d) scene fields
VOLUME = dict(volume_correction=1.0, volume_correction_every=2,
              volume_target_density=4.0)
OPTIONS = {"volume": VOLUME, "levelset": dict(surface_method="levelset"),
           "redblack": dict(pressure_solver="redblack"), "scene": {}}


def option_scene(name, cfg, device="cpu", helpers=None):
    """(d)'s SceneFields, the port's or, with `helpers` =
    tpu_fluid.core.scene_fields, JAX's; None for the other options."""
    if name != "scene":
        return None
    n = cfg.grid_size[0]
    sphere, vortex = ((n // 2, 3 * n // 4, n // 2), n / 6), \
        ((n / 2, n / 2), 30.0)
    if helpers is None:
        return SceneFields(solid_sphere(cfg, *sphere, device=device),
                           vortex_force(cfg, *vortex, device=device))
    return helpers.SceneFields(helpers.solid_sphere(cfg, *sphere),
                               helpers.vortex_force(cfg, *vortex))


def test_jit_multi_step_on_cpu_equals_eager_steps():
    state = eager(initial_state(CFG, device="cpu"), CFG, 2)
    assert_states_equal(jit_multi_step(state, CFG, 3), eager(state, CFG, 3))
    assert_states_equal(jit_step(state, CFG), step(state, CFG))


def test_jit_multi_step_matches_jax_on_a_carried_state():
    """A JAX state after two steps crosses into the port through numpy;
    three more steps on each side, JAX's through its own
    `jit_multi_step` (XLA stages, pallas_mode="off")."""
    jcfg = JaxConfig(**KW).replace(pallas_mode="off")
    jstep = jax.jit(jax_step, static_argnums=1)
    jstate = jax_initial_state(jcfg)
    for _ in range(2):
        jstate = jstep(jstate, jcfg)
    state = state_from_numpy(jax_numpy(jstate), device="cpu")
    want = jax_numpy(jax_jit_multi_step(jstate, jcfg, 3))
    got = state_to_numpy(jit_multi_step(state, CFG, 3))
    assert_states_close(got, want, "carried")
    assert int(got["step"]) == 5


@pytest.mark.parametrize("name", list(OPTIONS))
def test_jit_multi_step_with_options_matches_jax(name):
    """(a)-(d) on a state carried from JAX after two steps, three more on
    each side through `jit_multi_step` (JAX's XLA stages); for (a) the
    carried step 2 is corrected, 3 not, 4 again."""
    jcfg = JaxConfig(**KW).replace(pallas_mode="off", **OPTIONS[name])
    cfg = CFG.replace(**OPTIONS[name])
    jscene_ = option_scene(name, jcfg, helpers=jscene)
    jstep = jax.jit(jax_step, static_argnums=1)
    jstate = jax_initial_state(jcfg)
    for _ in range(2):
        jstate = jstep(jstate, jcfg, jscene_)
    state = state_from_numpy(jax_numpy(jstate), device="cpu")
    want = jax_numpy(jax_jit_multi_step(jstate, jcfg, 3, jscene_))
    got = state_to_numpy(jit_multi_step(state, cfg, 3,
                                        option_scene(name, cfg)))
    assert_states_close(got, want, name)


def test_cpu_state_is_left_as_it_was():
    state = initial_state(CFG, device="cpu")
    before = tuple(t.clone() for t in state)
    jit_multi_step(state, CFG, 2)
    for b, t in zip(before, state):
        assert torch.equal(b, t)
    assert not graph._GRAPHS                     # no graph on the CPU


def step_two_lineages(cfg, device, b_steps):
    """Lineage A from the initial state and B after `b_steps` eager steps,
    both of one graph key: 3 `jit_step`s each in turn, then one
    `jit_multi_step` of 3 each, every result held bitwise against its own
    eager steps after the other lineage's call.  B's velocity is offset,
    so that no step of one lineage equals a step of the other."""
    a = initial_state(cfg, device)
    b = eager(initial_state(cfg, device), cfg, b_steps)
    b = b._replace(velocity=b.velocity + 0.5)
    want_a, want_b = a, b
    for k in range(3):
        a = jit_step(a, cfg)
        b = jit_step(b, cfg)
        want_a, want_b = step(want_a, cfg), step(want_b, cfg)
        assert_states_equal(a, want_a, f"A, jit_step {k}")
        assert_states_equal(b, want_b, f"B, jit_step {k}")
    a = jit_multi_step(a, cfg, 3)
    b = jit_multi_step(b, cfg, 3)
    assert_states_equal(a, eager(want_a, cfg, 3), "A, jit_multi_step")
    assert_states_equal(b, eager(want_b, cfg, 3), "B, jit_multi_step")


def reuse_dropped_lineage(cfg, device):
    """A lineage held through a view of one field keeps its entry; once
    dropped, the next lineage of its key replays in that entry, with no
    capture."""
    a = jit_step(jit_step(initial_state(cfg, device), cfg), cfg)
    n0 = len(graph.captures)
    kept = a.velocity[0]
    del a
    b0 = eager(initial_state(cfg, device), cfg, 1)
    b = jit_step(b0, cfg)
    assert len(graph.captures) == n0 + 1         # a's entry is held
    del kept, b
    c0 = eager(initial_state(cfg, device), cfg, 2)
    c = jit_step(c0, cfg)
    assert len(graph.captures) == n0 + 1         # a's entry, reused
    assert_states_equal(c, step(c0, cfg), "reused entry")


class StandInGraph:
    """What a captured graph does, as eager steps on the CPU: its entry's
    `graph._record` from its set (n steps of its program, the last written
    into the other set, then the residual hand-over)."""

    def __init__(self, *record_args):
        self.record_args = record_args

    def replay(self):
        graph._record(*self.record_args)


@pytest.fixture
def stand_in(monkeypatch):
    """jit_step on CPU states through the graph cache, each capture a
    StandInGraph; records whether a capture asked for the warm-up.  A
    capture runs the step's code once, as `torch.cuda.graph` does, here
    for real: it writes the set the graph writes, which holds nothing
    live, and shares the passed-through fields at an entry's first
    capture."""
    def capture(entry, src, cfg, n_steps, first, warm_up, program):
        args = (entry, src, cfg, n_steps, first, program)
        residual = graph._record(*args)
        return StandInGraph(*args), {"warm_up": warm_up,
                                     "residual": residual}
    monkeypatch.setattr(graph, "on_cuda", lambda t: True)
    monkeypatch.setattr(graph, "_capture", capture)
    graph.clear_graphs()
    yield torch.device("cpu")
    graph.clear_graphs()


@pytest.mark.parametrize("name,b_steps", [("plain", 2), ("volume", 3)])
def test_lineages_keep_their_entries_behind_a_stand_in(stand_in, name,
                                                       b_steps):
    """Two lineages of one key in turn, each bitwise against its own
    eager steps; with the volume cadence every 2 at different phases.  One
    warm-up a key, however many entries it has."""
    cfg = CFG.replace(**(VOLUME if name == "volume" else {}))
    n0 = len(graph.captures)
    step_two_lineages(cfg, stand_in, b_steps)
    made = graph.captures[n0:]
    keys = [c["n_steps"] for c in made]
    assert [c["warm_up"] for c in made] == \
        [keys.index(k) == i for i, k in enumerate(keys)]
    assert all(c["residual"] == [] for c in made)
    if name == "plain":
        # each lineage's two sets: a graph from each, at n = 1; at n = 3
        # one replay each, from set A
        assert [(c["n_steps"], c["src"]) for c in made] == \
            [(1, 0), (1, 0), (1, 1), (1, 1), (3, 0), (3, 0)]


def test_dropped_lineage_entry_is_reused_behind_a_stand_in(stand_in):
    reuse_dropped_lineage(CFG, stand_in)


def test_returned_state_is_consumed_only_when_passed_in(stand_in):
    """A returned state is written by the call given it, and by no other
    call; a state no entry owns is left as it was."""
    s0 = initial_state(CFG, stand_in)
    keep0 = cloned(s0)
    s1 = jit_step(s0, CFG)
    assert_states_equal(s0, keep0, "foreign state")
    keep1 = cloned(s1)
    other = jit_step(initial_state(CFG, stand_in), CFG)
    assert_states_equal(s1, keep1, "another lineage's call")
    s2 = jit_step(s1, CFG)
    assert s2.velocity.data_ptr() != s1.velocity.data_ptr()
    assert_states_equal(s1, keep1, "s1 until s2 is passed in")
    keep2 = cloned(s2)
    assert_states_equal(s2, step(keep1, CFG), "s2, in the other set")
    s3 = jit_step(s2, CFG)
    assert s3.velocity.data_ptr() == s1.velocity.data_ptr()
    assert_states_equal(s3, step(keep2, CFG), "s3, in s1's set")
    assert other.velocity.data_ptr() not in (s2.velocity.data_ptr(),
                                             s3.velocity.data_ptr())


@pytest.mark.parametrize("call", [
    lambda s: jit_multi_step(s, CFG, 0)])
def test_bad_calls_raise(call):
    with pytest.raises(ValueError):
        call(initial_state(CFG, device="cpu"))


# ------------------------------------------------------------------ on card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured and "
                    "replayed only there")
    graph.clear_graphs()
    yield torch.device("cuda", 0)
    graph.clear_graphs()


# a 16^3 scene on the unfused path, and the same with the K6 kernels
CARD_CFGS = {
    "16": CFG.replace(grid_size=(16, 16, 16)),
    "16-fused": CFG.replace(grid_size=(16, 16, 16), grid_fused=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CFGS))
def test_cuda_replays_equal_eager_steps_bitwise(cuda_device, name):
    cfg = CARD_CFGS[name]
    state0 = eager(initial_state(cfg, cuda_device), cfg, 2)
    want = eager(state0, cfg, 3)
    s = state0
    for _ in range(3):
        s = jit_step(s, cfg)
    assert_states_equal(s, want, "jit_step")
    assert_states_equal(jit_multi_step(state0, cfg, 3), want, "multi")
    # an eager step from the graph's buffers
    assert_states_equal(step(s, cfg), step(want, cfg), "eager after")


@pytest.mark.cuda
def test_cuda_capture_is_cached_per_config(cuda_device):
    cfg = CARD_CFGS["16"]
    n0 = len(graph.captures)
    s = jit_step(initial_state(cfg, cuda_device), cfg)
    s = jit_step(s, cfg)
    s = jit_step(s, cfg)
    # one graph from each of the lineage's two sets
    assert [c["src"] for c in graph.captures[n0:]] == [0, 1]
    other = cfg.replace(jacobi_iters=cfg.jacobi_iters + 1)
    jit_step(initial_state(other, cuda_device), other)
    jit_multi_step(s, cfg, 2)
    assert len(graph.captures) == n0 + 4
    assert graph.captures[-1]["n_steps"] == 2


@pytest.mark.cuda
def test_cuda_state_passed_in_is_consumed(cuda_device):
    """The returned state is one of its lineage's two buffer sets: the
    call given it returns the other set, and the call after that
    overwrites it; a state that is not the graph's own is left as it
    was."""
    cfg = CARD_CFGS["16"]
    s0 = initial_state(cfg, cuda_device)
    keep = cloned(s0)
    s1 = jit_step(s0, cfg)
    assert_states_equal(s0, keep, "foreign state")
    s1_before = cloned(s1)
    s2 = jit_step(s1, cfg)
    assert s2.velocity.data_ptr() != s1.velocity.data_ptr()
    assert int(s1.step) == 1
    assert_states_equal(s2, step(s1_before, cfg), "second replay")
    s2_before = cloned(s2)
    s3 = jit_step(s2, cfg)
    assert s3.velocity.data_ptr() == s1.velocity.data_ptr()
    assert int(s1.step) == 3 and int(s2_before.step) == 2
    assert_states_equal(s3, step(s2_before, cfg), "third replay")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(OPTIONS))
def test_cuda_options_replay_equal_eager_steps_bitwise(cuda_device, name):
    """(a)-(d) captured: 3 jit_step replays and one jit_multi_step of 3
    from the state after 2 eager steps equal 3 eager steps bitwise."""
    cfg = CARD_CFGS["16"].replace(**OPTIONS[name])
    scene = option_scene(name, cfg, cuda_device)
    state0 = eager(initial_state(cfg, cuda_device), cfg, 2, scene)
    want = eager(state0, cfg, 3, scene)
    s = state0
    for _ in range(3):
        s = jit_step(s, cfg, scene)
    assert_states_equal(s, want, "jit_step")
    assert_states_equal(jit_multi_step(state0, cfg, 3, scene), want,
                        "multi")


@pytest.mark.cuda
def test_cuda_volume_cadence_across_replays(cuda_device):
    """every = 2: the phase-0 graph corrects and the phase-1 graph does
    not, one graph a phase, and the step of a graph's own buffers is
    known without reading it back."""
    cfg = CARD_CFGS["16"].replace(**VOLUME)
    always = cfg.replace(volume_correction_every=1)
    never = cfg.replace(volume_correction=0.0)
    n0 = len(graph.captures)
    s0 = initial_state(cfg, cuda_device)
    s1 = jit_step(s0, cfg)
    assert_states_equal(s1, step(s0, always), "phase 0")
    keep1 = cloned(s1)
    s2 = jit_step(s1, cfg)
    assert_states_equal(s2, step(keep1, never), "phase 1")
    assert not torch.equal(s2.positions, step(keep1, always).positions)
    keep2 = cloned(s2)
    s3 = jit_step(s2, cfg)
    assert_states_equal(s3, step(keep2, always), "phase 0 again")
    assert [c["phase"] for c in graph.captures[n0:]] == [0, 1]


@pytest.mark.cuda
def test_cuda_two_lineages_of_one_key_step_apart(cuda_device):
    """Two lineages of one key in turn, 3 jit_steps and a jit_multi_step
    of 3 each, bitwise against their own eager steps."""
    step_two_lineages(CARD_CFGS["16"], cuda_device, 2)


@pytest.mark.cuda
def test_cuda_two_lineages_at_two_volume_phases(cuda_device):
    """The same with the volume cadence every 2, the lineages at phases 0
    and 1."""
    step_two_lineages(CARD_CFGS["16"].replace(**VOLUME), cuda_device, 3)


@pytest.mark.cuda
def test_cuda_dropped_lineage_entry_is_reused(cuda_device):
    reuse_dropped_lineage(CARD_CFGS["16"], cuda_device)
