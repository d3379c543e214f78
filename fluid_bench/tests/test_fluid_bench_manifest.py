"""BENCHMARK.json keeps the benchmark contract's naming rules, and every
cell finds its files by name."""

from __future__ import annotations

import json
import re
import time

import pytest

from fluid_bench.manifest import Manifest
from fluid_bench.run import run_cell
from fluid_bench.tests.conftest import REPO, add_cell, tiny_root, write

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
LOOP_METRICS = {"stream": {"steps_per_s", "step_ms_p95"},
                "view": {"frames_per_s", "frame_ms_p95"},
                "spmd_stream": {"steps_per_s", "step_ms_p95"}}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path)
        assert not path.startswith("/") and ".." not in path
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", ()):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert LINE.match(entry[key])


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metric_entries():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in names
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(name):
    from fluid_bench.loop import program_config
    cell = Manifest(REPO).cell(name)
    program_config(cell.config["fields"])
    assert cell.config["name"] == BENCH["workloads"][
        [w["name"] for w in BENCH["workloads"]].index(name)]["config"]
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported
    assert reported - {"setup_s"} == LOOP_METRICS[cell.traffic["loop"]]
    assert cell.per_layer
    manifest = Manifest(REPO)
    for m in cell.per_layer:
        assert callable(manifest.reader(m["name"]))
        assert m["moves"] in reported


def test_config_files_hold_what_is_run():
    for c in BENCH["configs"]:
        data = json.loads((REPO / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert c["file"].startswith("fluid_bench/")


# a loop that wraps `stream` and marks that it ran
MARKED_LOOP = '''
from pathlib import Path

from fluid_bench.manifest import loop_module


def run(traffic, fields, seed, seconds, trace, device, t0, ranks=None):
    (Path(__file__).parents[2] / "loop_ran").write_text(traffic["loop"])
    return loop_module("stream").run(traffic, fields, seed, seconds, trace,
                                     device, t0)
'''

# a reference that is `step`'s, and marks that it judged
MARKED_REFERENCE = '''
from pathlib import Path

from fluid_bench.reference.step import FIELDS, FLOAT_FIELDS, Scene  # noqa
from fluid_bench.reference.step import step as _step


def step(inp, scene, dtype=None, **kw):
    (Path(__file__).parents[2] / "reference_ran").write_text("step")
    return _step(inp, scene) if dtype is None else _step(inp, scene, dtype)
'''


def test_a_fourth_cell_needs_only_new_files_and_entries(tmp_path):
    """New cells, and a cell whose mix names a new loop file and whose
    configuration names a new reference file, resolve and run after new
    files and entries only; every file the repository has is as it was."""
    root = tiny_root(tmp_path)
    add_cell(root, "marked.stream", "marked", reference="marked_ref",
             loop_source=MARKED_LOOP, mix={"loop": "marked", "why": "test"})
    write(root, "fluid_bench/reference/marked_ref.py", MARKED_REFERENCE)
    manifest = Manifest(root)
    for name in ("tiny.stream", "tiny.view", "marked.stream"):
        cell = manifest.cell(name)
        assert {m["name"] for m in cell.per_layer}
    assert manifest.cell("tiny.stream").config["name"] == "tiny"
    assert manifest.cell("tiny.stream").reference == "step"
    assert manifest.cell("marked.stream").reference == "marked_ref"
    r = run_cell(root, "marked.stream", 2 ** 31 + 3, 0.2, False, "cpu",
                 time.perf_counter())
    assert r["correct"] and r["failed"] == 0
    assert (root / "loop_ran").read_text() == "marked"
    assert (root / "reference_ran").read_text() == "step"
    for path in (REPO / "fluid_bench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(REPO)
            assert (root / rel).read_bytes() == path.read_bytes(), rel
