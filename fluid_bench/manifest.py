"""`BENCHMARK.json` and the files it names, found by name.

A cell names a configuration (its file, `configs[].file`) and a traffic
mix (`fluid_bench/traffic/<traffic>.json`); a per-layer metric is read by
`fluid_bench/metrics/<name>.py`; a kernel family is
`fluid_bench/kernels/<family>.py`.  Adding a cell, mix, configuration,
metric or family adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic mix's parameters
    traffic_name: str
    chips: int
    end_to_end: tuple     # the manifest's metric entries this cell reports
    per_layer: tuple


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.configs = {c["name"]: c for c in self.bench["configs"]}
        self.workloads = {w["name"]: w for w in self.bench["workloads"]}

    def _reports(self, metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def cell(self, name: str) -> Cell:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = self.workloads[name]
        config = json.loads(
            (self.root / self.configs[w["config"]]["file"]).read_text())
        traffic = json.loads(self.traffic_path(w["traffic"]).read_text())
        return Cell(
            name=name, config=config, traffic=traffic,
            traffic_name=w["traffic"], chips=int(w["chips"]),
            end_to_end=tuple(m for m in self.bench["end_to_end"]
                             if self._reports(m, name)),
            per_layer=tuple(m for m in self.bench["per_layer"]
                            if self._reports(m, name)))

    def traffic_path(self, traffic: str) -> Path:
        return self.root / "fluid_bench" / "traffic" / f"{traffic}.json"

    def reader_path(self, metric: str) -> Path:
        return self.root / "fluid_bench" / "metrics" / f"{metric}.py"

    def reader(self, metric: str):
        """The `read(run)` function of a per-layer metric's reader."""
        return load(self.reader_path(metric), f"fluid_bench_metric_{metric}").read


def load(path: Path, name: str):
    """The module in the file `path`, loaded under `name`."""
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def family(name: str, root: Path | None = None):
    """The kernel family `fluid_bench/kernels/<name>.py`: NAMES, the kernel
    names it matches in the trace, and bound(fields) -> (ms, by)."""
    base = HERE if root is None else Path(root) / "fluid_bench"
    return load(base / "kernels" / f"{name}.py", f"fluid_bench_family_{name}")
