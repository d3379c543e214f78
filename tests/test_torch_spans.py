"""The port's spans (`tpu_fluid_torch/utils/profiling.py`): the switch and
the registry on the CPU (the off path, self time, the stage groups of the
step on both paths, the facade's spans, the level set's spans and
counters, the sync count and what tracing puts back, a graph's marks read
before it replays again), and on the card (the `cuda` test, which skips
here) traced and untraced graphed steps."""

import types
import warnings

import pytest
import torch

from fluid_bench.reference import step_levelset as ref_levelset
from tpu_fluid_torch import FluidConfig, Simulation, initial_state, step
from tpu_fluid_torch.render.export import to_host
from tpu_fluid_torch.solver import graph
from tpu_fluid_torch.surface import levelset
from tpu_fluid_torch.utils import profiling

torch.set_num_threads(2)

CFG = FluidConfig(grid_size=(12, 12, 12), particle_count=2000,
                  particle_init_cube_resolution=(16, 16, 8),
                  particle_init_cube_offset=(3.0, 1.5, 1.0),
                  particle_init_cube_size=(6.0, 6.0, 1.5),
                  surface_render_resolution=2, jacobi_iters=20)
UNFUSED = ["01-03 pool and cell typing", "04+05 extrapolate", "07 advect",
           "08-10 forces/solids", "11 divergence", "12 jacobi x20",
           "13 project", "14+15 move and scatter", "16-18 surface fields"]
FUSED = ["01-06 classify and extrapolate (K6a)", "07 advect",
         "08-11 forces, solids, divergence (K6b)", "12 jacobi x20",
         "13 project (K6c)", "14+15 move and scatter",
         "16-18 surface fields"]
PATHS = [(CFG, UNFUSED),
         (CFG.replace(pallas_mode="interpret", grid_fused=True), FUSED)]


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.tracing(False)
    profiling.reset()
    yield
    profiling.tracing(False)
    profiling.reset()


def test_off_span_is_the_shared_null_context_and_records_nothing(
        monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("the off path made a dispatcher call")
    monkeypatch.setattr(profiling.torch.profiler, "record_function",
                        refused)
    monkeypatch.setattr(profiling, "time", None)       # no clock read
    assert profiling.span("a") is profiling.span("b") is profiling._NULL
    assert profiling.stages() is profiling._no_stage
    with profiling.span("a"):
        mark = profiling.stages()
        mark("x")
        mark()
    assert profiling.report() == {}


def test_nested_spans_give_self_time(monkeypatch):
    ticks = iter([0.0, 1.0, 4.0, 5.0, 7.0, 10.0])
    clock = types.SimpleNamespace(perf_counter=lambda: next(ticks))
    monkeypatch.setattr(profiling, "time", clock)
    profiling.tracing(True)
    with profiling.span("outer"):               # 0 .. 10
        with profiling.span("inner"):           # 1 .. 4
            pass
        mark = profiling.stages()
        mark("group")                           # 5 .. 7
        mark()
    rep = profiling.report()
    assert list(rep) == ["inner", "group", "outer"]
    assert rep["outer"]["parent"] is None
    assert rep["inner"]["parent"] == rep["group"]["parent"] == "outer"
    assert (rep["outer"]["host_s"], rep["outer"]["self_s"]) == (10.0, 5.0)
    assert (rep["inner"]["host_s"], rep["inner"]["self_s"]) == (3.0, 3.0)
    assert rep["group"]["host_s"] == 2.0
    assert all(r["calls"] == 1 and r["device_calls"] == 0
               for r in rep.values())


@pytest.mark.parametrize("cfg,groups", PATHS, ids=["unfused", "fused"])
def test_stage_spans_tile_an_eager_step_in_order(cfg, groups):
    state = step(initial_state(cfg, device="cpu"), cfg)
    profiling.tracing(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("whole"):
            step(state, cfg)
    rep = profiling.report()
    assert list(rep) == groups + ["whole"]
    assert all(rep[g]["parent"] == "whole" and rep[g]["calls"] == 1
               for g in groups)
    # the groups cover the step: what lies between them is a few Python
    # statements
    assert rep["whole"]["self_s"] < 0.1 * rep["whole"]["host_s"], rep
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.name.startswith(profiling.PREFIX)
                    and e.name != profiling.PREFIX + "whole")
    assert [name for _, _, name in ranges] == \
        [profiling.PREFIX + g for g in groups]
    assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))


def test_stage_breakdown_reads_the_spans_and_leaves_tracing_off(
        monkeypatch):
    calls = []
    monkeypatch.setattr(profiling, "time_chained",
                        lambda f, x0, n: calls.append(n) or 1.0)
    bd = profiling.stage_breakdown(CFG, n=2, warm_steps=1, device="cpu")
    assert list(bd) == UNFUSED + [profiling.TOTAL]
    assert calls == [2]                  # only the whole step is chained
    assert not profiling.enabled()


def test_facade_spans(tmp_path):
    sim = Simulation(cfg=CFG, device="cpu")
    profiling.tracing(True)
    sim.step(1)
    to_host(sim.render_frame(48, 48, method="splat"))
    rep = profiling.report()
    assert list(rep) == UNFUSED + [
        "step", "surface_mesh", "splat.surface_lattice", "splat.sprites",
        "splat.scatter", "splat", "render_frame", "to_host"]
    assert all(rep[g]["parent"] == "step" for g in UNFUSED)
    assert rep["surface_mesh"]["parent"] == rep["splat"]["parent"] == \
        "render_frame"
    assert [n for n, r in rep.items() if r["parent"] == "splat"] == \
        ["splat.surface_lattice", "splat.sprites", "splat.scatter"]
    assert rep["splat"]["host_s"] >= sum(
        rep[n]["host_s"] for n in ("splat.surface_lattice",
                                   "splat.sprites", "splat.scatter"))
    for name in ("step", "render_frame", "to_host"):
        assert rep[name]["parent"] is None
    assert all(r["calls"] == 1 for r in rep.values())


# the level-set surface, with a solid box whose detailed cells the
# smoothing keeps
LEVELSET = CFG.replace(surface_method="levelset",
                       solid_boxes=(((4, 6, 1), (7, 11, 4)),))


@pytest.mark.parametrize("cfg,groups", PATHS, ids=["unfused", "fused"])
def test_the_level_set_spans_and_counters(cfg, groups):
    """With tracing on, the level set is the span `levelset` inside the
    stage group `16-18 surface fields`, with `levelset.chamfer` and
    `levelset.smooth` inside it; it counts the detailed cells and the
    cells its distance reaches, which a plain count of the reference's
    distance gives."""
    cfg = cfg.replace(surface_method=LEVELSET.surface_method,
                      solid_boxes=LEVELSET.solid_boxes)
    state = step(initial_state(cfg, device="cpu"), cfg)
    profiling.tracing(True)
    out = step(state, cfg)
    rep = profiling.report()
    assert [n for n in rep if n[0].isdigit()] == groups
    assert rep["levelset"]["parent"] == "16-18 surface fields"
    for name in ("levelset.chamfer", "levelset.smooth", "levelset.cells",
                 "levelset.band_cells"):
        assert rep[name]["parent"] == "levelset", name
        assert rep[name]["calls"] == 1, name
    assert rep["levelset"]["host_s"] >= (rep["levelset.chamfer"]["host_s"]
                                         + rep["levelset.smooth"]["host_s"])
    cells = out.detailed_occ.numel()
    assert rep["levelset.cells"]["count"] == cells == \
        cfg.detailed_size[0] * cfg.detailed_size[1] * cfg.detailed_size[2]
    sweeps = cfg.levelset_sweeps_value
    phi = ref_levelset.chamfer(out.detailed_occ, sweeps, torch.float32)
    band = int((phi <= sweeps).sum())
    assert rep["levelset.band_cells"]["count"] == band
    assert int(out.detailed_occ.sum()) < band < cells


def test_the_level_set_records_and_counts_nothing_with_tracing_off(
        monkeypatch):
    """With tracing off the level set makes no record, and its band is
    never counted."""
    def refused(*args, **kwargs):
        raise AssertionError("the band was counted")
    monkeypatch.setattr(levelset, "band_cells", refused)
    state = initial_state(LEVELSET, device="cpu")
    for _ in range(2):
        state = step(state, LEVELSET)
    assert profiling.report() == {}
    assert all(int(acc) == 0 for acc in profiling._DEVICE_COUNTS.values())


def test_syncs_count_under_the_innermost_span_and_are_not_shown():
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        profiling.tracing(True)
        with profiling.span("outer"):
            for _ in range(3):
                warnings.warn(profiling.SYNC_WARNING + " (at one line)")
            with profiling.span("inner"):
                warnings.warn(profiling.SYNC_WARNING)
        warnings.warn(profiling.SYNC_WARNING)      # under no span
        warnings.warn("another warning")
        profiling.tracing(False)
    rep = profiling.report()
    assert (rep["outer"]["syncs"], rep["inner"]["syncs"]) == (3, 1)
    assert [str(w.message) for w in shown] == ["another warning"]


def test_tracing_off_puts_back_the_sync_mode_and_the_filters(monkeypatch):
    modes = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    filters, show = list(warnings.filters), warnings.showwarning
    profiling.tracing(True)
    assert modes == [0, "warn"]
    assert warnings.filters != filters and warnings.showwarning is not show
    profiling.tracing(False)
    assert modes == [0, "warn", 0]
    assert warnings.filters == filters and warnings.showwarning is show


class FakeEvent:
    """A timing event recorded by a graph's replays: `ms` is when the last
    replay recorded it, set by FakeGraph."""

    def __init__(self):
        self.ms = None
        self.synced = 0

    def synchronize(self):
        self.synced += 1

    def elapsed_time(self, other):
        return other.ms - self.ms


class FakeGraph:
    """A graph whose replay records its three events at the times given."""

    def __init__(self, events, times):
        self.events, self.times = events, iter(times)

    def replay(self):
        for event, ms in zip(self.events, next(self.times)):
            event.ms = ms


def test_marks_are_read_before_their_graph_replays_again():
    a, b, c = FakeEvent(), FakeEvent(), FakeEvent()
    marks = profiling.Marks()
    marks.spans += [("first", None, a, b), ("second", None, b, c)]
    g = FakeGraph([a, b, c], [(0, 1, 4), (10, 12, 13), (20, 22, 27)])
    marks.replay(g)
    assert profiling._record("first", None).device_calls == 0  # pending
    marks.replay(g)                     # reads the first replay first
    assert (profiling._RECORDS["first"].device_ms,
            profiling._RECORDS["second"].device_ms) == (1, 3)
    marks.replay(g)
    rep = profiling.report()            # reads the last replay
    assert (rep["first"]["device_ms"], rep["second"]["device_ms"]) == \
        (1 + 2 + 2, 3 + 1 + 5)
    assert rep["first"]["calls"] == rep["first"]["device_calls"] == 3
    assert c.synced == 3 and not profiling._PENDING
    marks.replay(g.__class__([a, b, c], [(0, 0, 0)]))
    profiling.reset()                   # forgets the pending replay
    assert profiling.report() == {}


def test_tracing_is_part_of_the_graph_key():
    state = initial_state(CFG, device="cpu")
    off = graph._key(state, CFG, 1, None, graph.SINGLE_DEVICE)
    profiling.tracing(True)
    on = graph._key(state, CFG, 1, None, graph.SINGLE_DEVICE)
    assert off[:-1] == on[:-1] and (off[-1], on[-1]) == (False, True)


# ------------------------------------------------- the x-slab step's spans
# a domain-sharded scene whose force cells beside the slab borders of 2
# ranks push particles across them (tests/test_torch_particles_domain.py)
DOMAIN = FluidConfig(grid_size=(32, 16, 16), particle_count=4096,
                     particle_init_cube_resolution=(16, 16, 16),
                     particle_init_cube_offset=(5.0, 2.0, 2.0),
                     particle_init_cube_size=(20.0, 9.0, 5.0),
                     surface_render_resolution=2, jacobi_iters=40,
                     advect_max_displacement=1, fountain_force=-2000.0,
                     fountain_position=(16, 14, 8),
                     particle_sharding="domain",
                     extra_forces=tuple(((x, 6, 4), (20000.0, 0.0, 0.0))
                                        for x in (7, 15, 23)))
DOMAIN_STEPS = 3
EXCHANGES = ["exchange.halo", "exchange.solve", "exchange.migrate"]


def _domain_rank(rank, n, init_method, cfg, traced):
    """DOMAIN_STEPS eager steps of this rank's part: the registry's report,
    the bytes the step's sends carried, and the particles that left the
    slab toward a neighbour (at most a buffer a direction), counted from
    the positions `migrate` was given."""
    import torch.distributed as dist

    from tpu_fluid_torch.ops.indexing import float_to_index
    from tpu_fluid_torch.parallel import spmd_step as spmd
    from tpu_fluid_torch.parallel.mesh import make_mesh
    from tpu_fluid_torch.parallel.particles_domain import layout_state
    torch.set_num_threads(1)
    mesh = make_mesh(n, rank, init_method, device="cpu", backend="gloo")
    state = layout_state(initial_state(cfg, device="cpu"), rank, n, cfg)
    sent = {"bytes": 0, "leavers": 0}
    batch, migrate = dist.batch_isend_irecv, spmd.migrate

    def counting_batch(ops):
        sent["bytes"] += sum(op.tensor.nbytes for op in ops
                             if op.op is dist.isend)
        return batch(ops)

    def counting_migrate(pos, active, x0, lx, m, mesh_, out=None):
        cx = float_to_index(torch.floor(pos[:, 0]), torch.int32)
        if mesh_.rank > 0:
            sent["leavers"] += min(int((active & (cx < x0)).sum()), m)
        if mesh_.rank < mesh_.size - 1:
            sent["leavers"] += min(int((active & (cx >= x0 + lx)).sum()), m)
        return migrate(pos, active, x0, lx, m, mesh_, out=out)

    dist.batch_isend_irecv = counting_batch
    spmd.migrate = counting_migrate
    if not traced:
        def refused(*args, **kwargs):
            raise AssertionError("a span or an event was made")
        profiling._Span = profiling._Open = refused
        profiling.torch.cuda.Event = refused
    profiling.tracing(traced)
    step_fn = spmd.spmd_step(cfg, mesh)
    for _ in range(DOMAIN_STEPS):
        state = step_fn(state)
    rep = profiling.report()
    # numbers only: a tensor would cross the pipe as shared memory, which
    # a rank that exits at once takes with it
    return rep, sent, [key[0] for key in profiling._DEVICE_COUNTS]


@pytest.fixture(scope="module")
def domain_ranks():
    from tpu_fluid_torch.parallel.launch import run_ranks
    return {traced: run_ranks(_domain_rank, 2, DOMAIN, traced,
                              timeout=240.0)
            for traced in (True, False)}


def test_the_x_slab_step_records_its_stages_and_exchanges(domain_ranks):
    """With tracing on, an eager 2-rank domain step records the stage
    groups of the single-device step, each once a step, and the exchanges
    inside them: the halo exchanges, the solve's and the migration's."""
    for rep, _, _ in domain_ranks[True]:
        groups = [name for name in rep if name[0].isdigit()]
        assert groups == UNFUSED[:5] + ["12 jacobi x40"] + UNFUSED[6:]
        assert all(rep[g]["calls"] == DOMAIN_STEPS for g in groups)
        for name in EXCHANGES:
            assert rep[name]["calls"] >= DOMAIN_STEPS, name
        assert rep["exchange.solve"]["parent"] == "12 jacobi x40"
        assert rep["exchange.migrate"]["parent"] == "14+15 move and scatter"
        # every exchange of the solve and of the migration is a halo
        # exchange inside it, as are those of the stages
        parents = {rep[n]["parent"] for n in rep if n == "exchange.halo"}
        assert parents <= set(groups) | set(EXCHANGES)


def test_the_halo_bytes_are_those_sent(domain_ranks):
    """The halo-bytes counter equals the bytes of the step's sends: every
    send goes through the neighbour exchange."""
    for rep, sent, _ in domain_ranks[True]:
        assert sent["bytes"] > 0
        assert rep["exchange.halo_bytes"]["count"] == sent["bytes"]


def test_the_migrate_counter_is_the_leavers_sent(domain_ranks):
    """The device counter of particles sent equals the leavers counted
    from the positions `migrate` was given, and some left."""
    total = 0
    for rep, sent, _ in domain_ranks[True]:
        assert rep["exchange.migrate_sent"]["count"] == sent["leavers"]
        assert rep["exchange.migrate_sent"]["calls"] == DOMAIN_STEPS
        total += sent["leavers"]
    assert total > 0


def test_tracing_off_makes_no_span_and_no_event(domain_ranks):
    """With tracing off the same steps make no span, no event and no
    counter: the registry stays empty."""
    for (rep, sent, counters), (_, traced, _) in zip(domain_ranks[False],
                                                     domain_ranks[True]):
        assert rep == {} and counters == []
        assert sent == traced


# ------------------------------------------------------------------ on card
@pytest.mark.cuda
def test_traced_graph_steps_equal_untraced_and_time_the_stages():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and their event nodes "
                    "exist only there")
    cfg = FluidConfig.reference_scene()
    graph.clear_graphs()
    start = initial_state(cfg)
    runs = {}
    for traced in (False, True):
        profiling.tracing(traced)
        s = type(start)(*(t.clone() for t in start))
        for _ in range(3):
            s = graph.jit_step(s, cfg)
        runs[traced] = s
    for name, a, b in zip(start._fields, runs[False], runs[True]):
        assert torch.equal(a, b), name
    keys = [k for k in graph._GRAPHS if k[1] == cfg]
    assert sorted(k[-1] for k in keys) == [False, True]

    # 20 replays back to back, timed whole by two events
    profiling.reset()
    s = runs[True]
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(20):
        s = graph.jit_step(s, cfg)
    b.record()
    b.synchronize()
    rep = profiling.report()
    profiling.tracing(False)
    graph.clear_graphs()
    assert list(rep) == \
        UNFUSED[:5] + [f"12 jacobi x{cfg.jacobi_iters}"] + UNFUSED[6:]
    assert all(r["device_calls"] == 20 and r["device_ms"] > 0
               for r in rep.values()), rep
    total = sum(r["device_ms"] for r in rep.values())
    assert abs(total - a.elapsed_time(b)) < 0.05 * a.elapsed_time(b)
