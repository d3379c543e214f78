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


def write(root, rel: str, text: str) -> None:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def add_cell(root, name: str, traffic: str, chips: int = 1,
             reference: str | None = None, loop_source: str | None = None,
             mix: dict | None = None) -> None:
    """Add cell `name` on a copy of the configuration `tiny` as new files
    and entries only: the configuration file (naming `reference`), the
    mix `traffic` (with its loop file where given), and the cell in every
    list of metrics that names `tiny.stream`."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((root / "fluid_bench/configs/tiny.json").read_text())
    cname = name.split(".")[0]
    config["name"] = cname
    if reference is not None:
        config["reference"] = reference
    write(root, f"fluid_bench/configs/{cname}.json", json.dumps(config))
    if loop_source is not None:
        write(root, f"fluid_bench/loops/{traffic}.py", loop_source)
    if mix is not None:
        write(root, f"fluid_bench/traffic/{traffic}.json", json.dumps(mix))
    bench["configs"].append({"name": cname, "source": "test",
                             "file": f"fluid_bench/configs/{cname}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": cname,
                               "traffic": traffic, "chips": chips,
                               "why": "test"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "tiny.stream" in metric.get("workloads", ()):
            metric["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)
