"""`BENCHMARK.json` and the files it names, found by name.

A cell names a configuration (its file, `configs[].file`) and a traffic
mix (`fluid_bench/traffic/<traffic>.json`).  The mix's `loop` is the module
`fluid_bench/loops/<loop>.py` that drives it; the configuration file's
optional `reference` is the module `fluid_bench/reference/<name>.py` that
judges it (`step` where it names none); a per-layer metric is read by
`fluid_bench/metrics/<name>.py`; a kernel family is
`fluid_bench/kernels/<family>.py`.  A name with no file is refused when the
cell is read, naming the file looked for.

So a new cell, mix, loop, configuration, reference, metric or family adds
files and entries and edits none.  A cell with `"chips": n > 1` runs one
rank a card (`fluid_bench/ranks.py`) under a loop that sets
`MULTI_CARD = True`, such as `spmd_stream`; a configuration whose reference
sets `SHARDED = True` is judged on every rank from that rank's part.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
DEFAULT_REFERENCE = "step"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic mix's parameters
    traffic_name: str
    chips: int
    end_to_end: tuple     # the manifest's metric entries this cell reports
    per_layer: tuple
    reference: str = DEFAULT_REFERENCE   # fluid_bench/reference/<name>.py


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
        reference = config.get("reference", DEFAULT_REFERENCE)
        _existing(loop_path(traffic["loop"], self.root), "traffic loop",
                  traffic["loop"])
        _existing(reference_path(reference, self.root), "reference",
                  reference)
        return Cell(
            name=name, config=config, traffic=traffic,
            traffic_name=w["traffic"], chips=int(w["chips"]),
            end_to_end=tuple(m for m in self.bench["end_to_end"]
                             if self._reports(m, name)),
            per_layer=tuple(m for m in self.bench["per_layer"]
                            if self._reports(m, name)),
            reference=reference)

    def traffic_path(self, traffic: str) -> Path:
        return self.root / "fluid_bench" / "traffic" / f"{traffic}.json"

    def reader_path(self, metric: str) -> Path:
        return self.root / "fluid_bench" / "metrics" / f"{metric}.py"

    def reader_module(self, metric: str):
        """The module of a per-layer metric's reader: `read(run)`, and
        optionally `merge(values)` over the ranks' values in rank order."""
        return load(self.reader_path(metric),
                    f"fluid_bench_metric_{metric}")

    def reader(self, metric: str):
        """The `read(run)` function of a per-layer metric's reader."""
        return self.reader_module(metric).read

    def reference(self, name: str):
        """The reference module `name` of this checkout."""
        return reference_module(name, self.root)


def _base(root) -> Path:
    return HERE if root is None else Path(root) / "fluid_bench"


def loop_path(name: str, root=None) -> Path:
    """The file of the traffic loop `name` (in this package where `root`,
    the checkout, is None)."""
    return _base(root) / "loops" / f"{name}.py"


def reference_path(name: str, root=None) -> Path:
    return _base(root) / "reference" / f"{name}.py"


def _existing(path: Path, what: str, name: str) -> Path:
    if not path.is_file():
        raise FileNotFoundError(f"no {what} {name!r}: {path} does not "
                                f"exist")
    return path


def loop_module(name: str, root=None):
    """The traffic loop `name`: `run(...) -> loop.Window`."""
    return load(_existing(loop_path(name, root), "traffic loop", name),
                f"fluid_bench_loop_{name}")


def reference_module(name: str, root=None):
    """The reference `name`: `Scene(fields)`, `step(inp, scene, dtype)`,
    `FIELDS`, `FLOAT_FIELDS`, and where `SHARDED` is true `part(state,
    scene, group)` and a `group=` argument of `step`."""
    return load(_existing(reference_path(name, root), "reference", name),
                f"fluid_bench_reference_{name}")


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
    return load(_base(root) / "kernels" / f"{name}.py",
                f"fluid_bench_family_{name}")
