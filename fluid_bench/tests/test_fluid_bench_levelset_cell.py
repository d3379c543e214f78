"""The level-set cell, `fountain-256-levelset.stream_spans`: its
configuration is judged by its own reference and refused by the default
one; its loop is the stream loop under `--trace 0` and reads the
program's spans over the window only under `--trace 1`, leaving tracing
off on every exit; its reader reads the level set's span and nothing
else.  Driven on the CPU at a tiny copy of the configuration."""

from __future__ import annotations

import dataclasses
import json
import time
import types

import pytest
import torch

from fluid_bench import run
from fluid_bench.manifest import Manifest, loop_module
from fluid_bench.tests.conftest import REPO, add_cell, tiny_root
from tpu_fluid_torch.solver import graph
from tpu_fluid_torch.utils import profiling

CELL = "fountain-256-levelset.stream_spans"
TINY = "tinyls.stream_spans"
SEED = 2 ** 31 + 41


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.tracing(False)
    profiling.reset()
    yield
    profiling.tracing(False)
    profiling.reset()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The benchmark's files with the tiny fountain under the level set as
    a cell of the `stream_spans` mix, judged by `step_levelset`."""
    root = tiny_root(tmp_path_factory.mktemp("levelset"))
    add_cell(root, TINY, "stream_spans", reference="step_levelset")
    path = root / "fluid_bench/configs/tinyls.json"
    data = json.loads(path.read_text())
    data["fields"]["surface_method"] = "levelset"
    path.write_text(json.dumps(data))
    return root


def test_the_cell_is_judged_by_its_own_reference():
    manifest = Manifest(REPO)
    cell = manifest.cell(CELL)
    assert (cell.reference, cell.chips, cell.traffic["loop"]) == \
        ("step_levelset", 1, "stream_spans")
    assert cell.config["fields"]["surface_method"] == "levelset"
    reference = run.judged_by(manifest, cell)
    assert reference.SUPPORTED["surface_method"] == "levelset"
    with pytest.raises(run.Unjudged, match="surface_method"):
        run.judged_by(manifest, dataclasses.replace(cell, reference="step"))


def test_the_cell_resolves_as_a_stream_cell():
    """The cell reports the stream's end-to-end metrics, every per-layer
    metric it lists has a reader, and it is seeded at its reference's
    sizes."""
    from fluid_bench import state
    from fluid_bench.loop import program_config
    manifest = Manifest(REPO)
    cell = manifest.cell(CELL)
    fields = cell.config["fields"]
    program_config(fields)
    assert {m["name"] for m in cell.end_to_end} == {"steps_per_s",
                                                    "step_ms_p95",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"device.idle_pct.stream",
                                                   "stages.levelset_ms"}
    for m in cell.per_layer:
        assert callable(manifest.reader(m["name"]))
    scene = manifest.reference(cell.reference).Scene(fields)
    assert state.detailed_size(fields) == scene.detailed_size == \
        (512, 512, 512)
    assert state.inertia_dtype(fields) == scene.inertia_dtype
    assert (scene.levelset_sweeps_value, scene.levelset_smooth) == (4, 2)
    assert abs(scene.levelset_iso_value - 1.426) < 1e-3


def test_the_configuration_is_fountain_256_with_the_level_set():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in bench["configs"]}
    plain = json.loads((REPO / files["fountain-256"]).read_text())["fields"]
    ls = json.loads((REPO / files["fountain-256-levelset"]).read_text())
    assert ls["reduced"] == []
    assert {k for k in plain if plain[k] != ls["fields"][k]} == \
        {"surface_method"}
    assert set(plain) == set(ls["fields"])


def _watch(monkeypatch, fail: bool = False) -> list:
    """`graph.jit_step` recording, at each call, whether the program's
    tracing is on; raising at the third call where `fail`."""
    real, seen = graph.jit_step, []

    def jit_step(state, cfg, *args, **kwargs):
        seen.append(profiling.enabled())
        if fail and len(seen) == 3:
            raise RuntimeError("a planted failure")
        return real(state, cfg, *args, **kwargs)
    monkeypatch.setattr(graph, "jit_step", jit_step)
    return seen


def _window(root, trace: bool):
    cell = Manifest(root).cell(TINY)
    return loop_module("stream_spans", root).run(
        cell.traffic, cell.config["fields"], SEED, 0.2, trace,
        torch.device("cpu"), time.perf_counter())


def test_untraced_it_is_the_stream_loop(root, monkeypatch):
    seen = _watch(monkeypatch)
    window = _window(root, False)
    assert seen and not any(seen)
    assert not hasattr(window, "program_spans")
    assert not profiling.enabled() and profiling.report() == {}


def test_traced_it_reads_the_window_calls_only(root, monkeypatch):
    """The report holds the level set once a window call: not set-up's
    calls, and not the call after the window."""
    seen = _watch(monkeypatch)
    window = _window(root, True)
    assert seen and all(seen)
    spans = window.program_spans
    assert spans["levelset"]["calls"] == window.count
    assert spans["levelset.band_cells"]["calls"] == window.count
    assert spans["levelset.cells"]["count"] == window.count * 24 ** 3
    assert spans["levelset.chamfer"]["parent"] == "levelset"
    assert not profiling.enabled()


def test_tracing_goes_off_when_the_loop_raises(root, monkeypatch):
    _watch(monkeypatch, fail=True)
    with pytest.raises(RuntimeError, match="planted"):
        _window(root, True)
    assert not profiling.enabled()


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_a_run_of_the_cell_is_correct(root, trace):
    r = run.run_cell(root, TINY, SEED, 0.2, trace, "cpu",
                     time.perf_counter())
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["state_gap"]["value"] == 0
    if not trace:
        assert set(r["metrics"]) == {"steps_per_s", "step_ms_p95",
                                     "setup_s"}
    assert not profiling.enabled()


def _read(window):
    reader = Manifest(REPO).reader("stages.levelset_ms")
    return reader(types.SimpleNamespace(window=window))


def test_the_reader_reads_the_level_set_span_only():
    def rec(ms, calls):
        return {"parent": "16-18 surface fields", "calls": calls,
                "host_s": 0.0, "self_s": 0.0, "device_ms": ms,
                "device_calls": calls, "syncs": 0, "count": 0}
    assert _read(types.SimpleNamespace()) is None
    assert _read(types.SimpleNamespace(program_spans={})) is None
    assert _read(types.SimpleNamespace(program_spans={
        "16-18 surface fields": rec(9.0, 3)})) is None
    assert _read(types.SimpleNamespace(program_spans={
        "levelset": rec(0.0, 0)})) is None
    assert _read(types.SimpleNamespace(program_spans={
        "levelset": rec(12.0, 4)})) == 3.0
