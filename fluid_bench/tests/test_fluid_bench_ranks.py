"""Multi-card cells come as new files and entries: a 2-rank gloo cell on
the CPU (`spmd_stream`), a broken rank, a sharded reference, the merge of
the ranks' numbers, the slab seed, ranks that fail, and names with no
file."""

from __future__ import annotations

import json
import time

import pytest
import torch

from fluid_bench import check, loop, ranks, run, stats
from fluid_bench.manifest import Manifest
from fluid_bench.state import initial
from fluid_bench.tests.conftest import REPO, add_cell, tiny_root, write

SEED = 2 ** 31 + 41
# a rank's limit in these tests: two spawns at 12^3 take about 10 s
LIMIT = 120.0

# a sharded reference over index-sharded particles: it checks that it is
# handed the group and its rank's part only, gathers, steps whole, cuts
SHARDED_REFERENCE = '''
from pathlib import Path

import torch
import torch.distributed as dist

from fluid_bench.reference.step import FIELDS, FLOAT_FIELDS, Scene  # noqa
from fluid_bench.reference.step import step as _step

SHARDED = True
SLAB = ("velocity", "cell_types", "inertia", "float_dens_1",
        "float_dens_2", "detailed_occ")
PARTICLES = ("positions", "active")


def _dim(k):
    return 1 if k == "velocity" else 0


def part(state, scene, group):
    r, n = dist.get_rank(group), dist.get_world_size(group)
    return {k: (v.chunk(n)[r].contiguous() if k in PARTICLES else v)
            for k, v in state.items()}


def _gathered(v, dim, group):
    n = dist.get_world_size(group)
    flag = v.dtype == torch.bool
    v = v.to(torch.uint8) if flag else v.contiguous()
    parts = [torch.empty_like(v) for _ in range(n)]
    dist.all_gather(parts, v, group=group)
    out = torch.cat(parts, dim=dim)
    return out.bool() if flag else out


def step(inp, scene, dtype=torch.float32, group=None):
    assert group is not None
    r, n = dist.get_rank(group), dist.get_world_size(group)
    lx = scene.grid_size[0] // n
    assert inp["cell_types"].shape[0] == lx, inp["cell_types"].shape
    assert inp["velocity"].shape[1] == lx
    assert inp["positions"].shape[0] == scene.particle_count // n
    with open(Path(__file__).parents[2] / f"sharded_{r}", "a") as f:
        f.write(f"{lx} {inp['positions'].shape[0]}\\n")
    whole = {k: (_gathered(v, _dim(k), group) if k in SLAB
                 else _gathered(v, 0, group) if k in PARTICLES else v)
             for k, v in inp.items()}
    out = _step(whole, scene, dtype)
    return {k: (v.chunk(n, dim=_dim(k))[r].contiguous()
                if k in SLAB + PARTICLES else v) for k, v in out.items()}
'''

# spmd_stream with rank 1's step handing its state back unchanged (the
# step still runs, so every collective is met)
UNCHANGED_RANK_LOOP = '''
from fluid_bench.manifest import loop_module

_real = loop_module("spmd_stream")
MULTI_CARD = True
end_to_end = _real.end_to_end


def run(traffic, fields, seed, seconds, trace, device, t0, ranks=None):
    import tpu_fluid_torch.parallel.spmd_step as spmd
    real = spmd.jit_spmd_step

    def broken(cfg, mesh, scene=None):
        call = real(cfg, mesh, scene)
        if mesh.rank != 1:
            return call

        def unchanged(s):
            call(s)
            return s
        return unchanged
    spmd.jit_spmd_step = broken
    return _real.run(traffic, fields, seed, seconds, trace, device, t0,
                     ranks=ranks)
'''

RAISING_LOOP = '''
MULTI_CARD = True


def run(traffic, fields, seed, seconds, trace, device, t0, ranks=None):
    if ranks.rank == 1:
        raise RuntimeError("rank 1 broke on purpose")
    import time
    time.sleep(600)
'''

HANGING_LOOP = '''
MULTI_CARD = True


def run(traffic, fields, seed, seconds, trace, device, t0, ranks=None):
    import time
    time.sleep(600)
'''

# a per-layer metric with a merge of its own
MAX_READER = '''
def read(run):
    return float(run.window.count)


def merge(values):
    return max(values)
'''


def _spmd_mix(loop_name: str) -> dict:
    mix = json.loads((REPO / "fluid_bench/traffic/spmd_stream.json")
                     .read_text())
    mix["loop"] = loop_name
    return mix


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("ranks"))
    add_cell(root, "tiny2.spmd_stream", "spmd_stream", chips=2)
    add_cell(root, "broken2.spmd_broken", "spmd_broken", chips=2,
             loop_source=UNCHANGED_RANK_LOOP, mix=_spmd_mix("spmd_broken"))
    add_cell(root, "sharded2.spmd_stream", "spmd_stream", chips=2,
             reference="sharded_ref")
    write(root, "fluid_bench/reference/sharded_ref.py", SHARDED_REFERENCE)
    add_cell(root, "raises2.raising", "raising", chips=2,
             loop_source=RAISING_LOOP, mix=_spmd_mix("raising"))
    add_cell(root, "hangs2.hanging", "hanging", chips=2,
             loop_source=HANGING_LOOP, mix=_spmd_mix("hanging"))
    add_cell(root, "noloop.nowhere", "nowhere",
             mix={"loop": "nowhere", "why": "test"})
    add_cell(root, "noref.stream", "stream", reference="nowhere")
    write(root, "fluid_bench/metrics/test.count_max.py", MAX_READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append(
        {"name": "test.count_max", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "test",
         "moves": "steps_per_s", "workloads": ["tiny2.spmd_stream"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def _run(root, cell, **kw):
    return run.run_cell(root, cell, SEED, 0.3, False, "cpu",
                        time.perf_counter(), limit=LIMIT, **kw)


def test_two_gloo_ranks_are_correct(root):
    """(b) 2 ranks on gloo, index-sharded particles: the same calls on
    both ranks, the samples gathered whole and judged correct."""
    payloads = ranks.run(root, "tiny2.spmd_stream", SEED, 0.3, False, "cpu",
                         time.perf_counter(), limit=LIMIT)
    assert [p["rank"] for p in payloads] == [0, 1]
    assert payloads[0]["attempted"] == payloads[1]["attempted"] > 0
    assert len(payloads[0]["times"]) == payloads[0]["attempted"]
    assert payloads[0]["verdict"]["correct"]
    assert payloads[1]["verdict"] is None
    cell = Manifest(root).cell("tiny2.spmd_stream")
    r = run.merge(payloads, cell, Manifest(root), False, root)
    assert r["correct"] and r["failed"] == 0
    assert r["device"]["count"] == 2
    assert set(r["metrics"]) == {"steps_per_s", "step_ms_p95", "setup_s"}
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


def test_a_rank_that_hands_its_state_back_is_not_correct(root):
    """(c) Rank 1's step returns its state unchanged."""
    r = _run(root, "broken2.spmd_broken")
    assert not r["correct"] and r["failed"] >= 1
    assert r["checks"]["state_mismatch"]["value"] > 0


def test_a_sharded_reference_gets_its_group_and_part(root):
    """(d) A SHARDED reference is called on every rank with the group and
    that rank's part only, and judges the run correct."""
    for r in (0, 1):
        (root / f"sharded_{r}").unlink(missing_ok=True)
    r = _run(root, "sharded2.spmd_stream")
    assert r["correct"] and r["failed"] == 0
    cfg = json.loads((root / "fluid_bench/configs/tiny.json").read_text())
    lx = cfg["fields"]["grid_size"][0] // 2
    rows = cfg["fields"]["particle_count"] // 2
    for rank in (0, 1):
        calls = (root / f"sharded_{rank}").read_text().splitlines()
        assert calls and set(calls) == {f"{lx} {rows}"}


def _payload(rank, seconds, times, peak, numbers, bad, per_layer, busy,
             attempted=4):
    return {"rank": rank, "kind": "cpu", "attempted": attempted,
            "seconds": seconds, "times": times, "setup_s": 5.0 + rank,
            "setup": [], "memory_peak_bytes": peak,
            "verdict": {"numbers": numbers, "bad": bad, "failed": sum(bad),
                        "correct": not any(bad)},
            "per_layer": per_layer, "busy_s": busy, "window_s": 0.5,
            "breakdown": {"device_ops": [[f"rank{rank}", 1.0]],
                          "idle_gaps": []} if rank == 0 else None,
            "forbidden": []}


def test_the_merge_rules(root):
    """(e) The rules of `run.py`'s docstring on made-up payloads."""
    manifest = Manifest(root)
    cell = manifest.cell("tiny2.spmd_stream")
    a = _payload(0, 1.0, [0.25, 0.1, 0.3, 0.2], 100,
                 {"state_gap": 1e-6, "state_mismatch": 1,
                  "window_mismatch": 0}, [False, True, False],
                 {"device.idle_pct.stream": 10.0, "test.count_max": 4.0},
                 0.4)
    b = _payload(1, 1.25, [0.2, 0.3, 0.1, 0.2], 300,
                 {"state_gap": 3e-6, "state_mismatch": 2,
                  "window_mismatch": 1}, [False, True, True],
                 {"device.idle_pct.stream": 20.0, "test.count_max": 7.0},
                 0.2)
    r = run.merge([a, b], cell, manifest, False, root)
    m = r["metrics"]
    assert m["steps_per_s"]["value"] == 4 / 1.25
    per_call = [0.25, 0.3, 0.3, 0.2]
    assert m["step_ms_p95"]["value"] == pytest.approx(
        stats.percentile(per_call, 95) * 1e3)
    assert m["setup_s"]["value"] == 6.0
    assert r["checks"]["state_gap"]["value"] == 3e-6
    assert r["checks"]["state_mismatch"]["value"] == 3
    assert r["checks"]["window_mismatch"]["value"] == 1
    assert r["failed"] == 2 and not r["correct"]
    assert r["device"]["memory_peak_bytes"] == 300
    assert r["attempted"] == 4
    t = run.merge([a, b], cell, manifest, True, root)
    assert t["metrics"]["device.idle_pct.stream"]["value"] == 15.0
    assert t["metrics"]["test.count_max"]["value"] == 7.0
    assert t["device"]["busy_s"] == pytest.approx(0.3)
    assert t["device"]["window_s"] == 0.5
    assert t["device"]["ranks"] == [[0.4, 0.5], [0.2, 0.5]]
    assert t["breakdown"] == a["breakdown"]
    b["per_layer"].pop("test.count_max")
    assert "test.count_max" not in run.merge(
        [a, b], cell, manifest, True, root)["metrics"]
    # every rank sound, but one made another number of calls
    for p, n in ((a, 4), (b, 5)):
        p["attempted"] = n
        p["verdict"].update(bad=[False] * 3, correct=True)
    assert not run.merge([a, b], cell, manifest, False, root)["correct"]
    # a rank that loaded JAX gives no result
    b["forbidden"] = ["jax"]
    with pytest.raises(ranks.RankFailure, match="jax"):
        run.merge([a, b], cell, manifest, False, root)


@pytest.mark.parametrize("n", [2, 4])
def test_the_slab_seed_is_the_whole_seed_cut(n):
    """(f) The slabs of the seed, put together, are the whole seed
    bitwise, the detailed occupancy at the slab edges too."""
    import dataclasses

    from tpu_fluid_torch.core.config import FluidConfig
    fields = json.loads(json.dumps(dataclasses.asdict(
        FluidConfig.scaled_scene(12, particle_count=20000))))
    whole = initial(fields, SEED, "cpu")
    r = fields["surface_render_resolution"]
    lx = fields["grid_size"][0] // n
    parts = [initial(fields, SEED, "cpu", x_range=(i * lx, (i + 1) * lx))
             for i in range(n)]
    for k, v in whole.items():
        if v.dim() >= 3:
            dim = 1 if k == "velocity" else 0
            joined = torch.cat([p[k] for p in parts], dim=dim)
        else:
            joined = parts[n - 1][k]
            for p in parts:
                assert torch.equal(p[k], v), k
        assert joined.dtype == v.dtype and torch.equal(joined, v), k
    edges = [i * lx * r for i in range(1, n)]
    assert any(int(whole["detailed_occ"][e].sum()) > 0 for e in edges)
    for i, p in enumerate(parts):
        assert torch.equal(p["detailed_occ"][0],
                           whole["detailed_occ"][i * lx * r])


def _alive_children():
    import multiprocessing
    return multiprocessing.active_children()


@pytest.mark.parametrize("cell", ["raises2.raising", "hangs2.hanging"])
def test_a_failed_rank_ends_the_run(root, cell):
    """(g) A rank that raises, and one that passes its limit, end the run
    with an error within the limit and the grace, every rank ended."""
    limit = 15.0
    start = time.monotonic()
    with pytest.raises(ranks.RankFailure):
        run.run_cell(root, cell, SEED, 0.3, False, "cpu",
                     time.perf_counter(), limit=limit)
    assert time.monotonic() - start < limit + ranks.GRACE + 30
    assert not _alive_children()


def test_a_failed_rank_gives_no_result_line(root, monkeypatch, capsys):
    """(g) The command exits non-zero and prints no result line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(run, "ROOT", root)
    real = run.run_cell

    def on_cpu(root_, name, seed, seconds, trace, device, *a, **kw):
        return real(root_, name, seed, seconds, trace, "cpu", *a,
                    limit=30.0, **{k: v for k, v in kw.items()
                                   if k != "limit"})
    monkeypatch.setattr(run, "run_cell", on_cpu)
    code = run.main(["--workload", "raises2.raising", "--seed", "1",
                     "--seconds", "0.3", "--trace", "0"])
    assert code != 0
    assert not capsys.readouterr().out.strip()


def test_names_with_no_file_are_refused(root):
    """(h) A mix naming no loop file, a configuration naming no reference
    file: refused, naming the file looked for."""
    with pytest.raises(FileNotFoundError, match="loops/nowhere.py"):
        Manifest(root).cell("noloop.nowhere")
    with pytest.raises(FileNotFoundError, match="reference/nowhere.py"):
        Manifest(root).cell("noref.stream")
    with pytest.raises(FileNotFoundError, match="loops/nowhere.py"):
        loop.run({"loop": "nowhere"}, {}, 1, 0.1, False,
                 torch.device("cpu"), time.perf_counter(), root=root)


@pytest.mark.parametrize("name, given, match", [
    ("stream", ranks.Ranks(0, 2, "", "gloo"), "one card"),
    ("spmd_stream", None, "chips")])
def test_a_loop_refuses_the_wrong_cards(root, name, given, match):
    """A one-card loop given ranks, a multi-card loop given none."""
    with pytest.raises(ValueError, match=match):
        loop.run({"loop": name}, {}, 1, 0.1, False, torch.device("cpu"),
                 time.perf_counter(), ranks=given, root=root)


def test_merged_verdicts_take_the_widest_gap_and_sum_counts():
    merged = check.merge_verdicts([
        {"numbers": {"state_gap": 1.0, "state_mismatch": 2},
         "bad": [False, True]},
        {"numbers": {"state_gap": 3.0, "state_mismatch": 4},
         "bad": [False, True]}])
    assert merged["numbers"] == {"state_gap": 3.0, "state_mismatch": 6}
    assert merged["failed"] == 1 and not merged["correct"]
    assert not check.merge_verdicts([])["correct"]


@pytest.mark.parametrize("cell", ["tiny2.spmd_stream",
                                  "sharded2.spmd_stream"])
def test_the_control_of_a_multi_card_cell_is_not_correct(root, cell):
    """`control.py` reads a multi-card cell on its ranks: the program
    correct, the control (bfloat16) not, routed whole or sharded."""
    from fluid_bench import control
    r = control.readings(root, cell, SEED, 0.3, True, device="cpu")
    assert r["attempted"][0] == r["attempted"][1]
    assert r["program"]["correct"]
    assert not r["control"]["correct"] and r["control"]["failed"] > 0
    assert r["control"]["numbers"]["state_gap"] > \
        100 * check.LIMITS["state_gap"]


def test_a_rank_roofline_takes_its_slab_share_of_the_bound(root):
    """A rank of a multi-card cell does 1/size of the work the bound
    counts for the whole grid."""
    import types
    fields = Manifest(root).cell("tiny2.spmd_stream").config["fields"]
    trace = types.SimpleNamespace(kernel_ms_per_step=lambda match: 0.5)
    one = run.Run(types.SimpleNamespace(trace=trace, mesh=None), fields,
                  root).roofline_pct("jacobi")
    two = run.Run(types.SimpleNamespace(
        trace=trace, mesh=types.SimpleNamespace(size=2)), fields,
        root).roofline_pct("jacobi")
    assert one > 0 and two == pytest.approx(one / 2)
