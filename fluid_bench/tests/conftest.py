"""A copy of the benchmark in a temporary root with tiny cells added by new
files and entries only, which the tests drive on the CPU."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def tiny_root(tmp: Path, grid: int = 12, particles: int = 20000,
              frame: int = 64, **config) -> Path:
    """The benchmark's files copied under `tmp`, plus the configuration
    `tiny` (the fountain at `grid`^3) and the cells `tiny.stream` and
    `tiny.view` (frames `frame` px wide), added as new files and new
    entries of every list that names cells of the same mix."""
    from tpu_fluid_torch.core.config import FluidConfig
    root = tmp / "checkout"
    shutil.copytree(REPO / "fluid_bench", root / "fluid_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = FluidConfig.scaled_scene(grid, particle_count=particles)
    cfg = cfg.replace(**config)
    (root / "fluid_bench/configs/tiny.json").write_text(json.dumps(
        {"name": "tiny", "source": "test", "reduced": [], "assumed": {},
         "fields": dataclasses.asdict(cfg)}))
    view = json.loads((root / "fluid_bench/traffic/view.json").read_text())
    view.update(width=frame, height=frame)
    (root / "fluid_bench/traffic/view-tiny.json").write_text(
        json.dumps(view))
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "fluid_bench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"] += [
        {"name": "tiny.stream", "config": "tiny", "traffic": "stream",
         "chips": 1, "why": "test"},
        {"name": "tiny.view", "config": "tiny", "traffic": "view-tiny",
         "chips": 1, "why": "test"}]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        cells = metric.get("workloads")
        if cells is None:
            continue
        if any(c.endswith(".stream") for c in cells):
            cells.append("tiny.stream")
        if any(c.endswith(".view") for c in cells):
            cells.append("tiny.view")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)
