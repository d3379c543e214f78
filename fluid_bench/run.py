"""Run one cell of the benchmark once and print its result line.

    python3 -m fluid_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks
for.  The cell (`BENCHMARK.json`'s `workloads`) names a configuration and a
traffic mix; the run makes the initial state from the seed, drives the
program (`tpu_fluid_torch`) through set-up and a window of `--seconds`
(the mix's loop, `fluid_bench/loops/<loop>.py`, through
`fluid_bench/loop.py`), checks what the window produced against the
configuration's plain reference (`fluid_bench/check.py`), and prints one
JSON line as the last line of standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device`, with `--trace 1`
`breakdown`, and last `checks`, each number compared beside its limit,
which are also the last lines of standard error.

A cell with `"chips": n > 1` runs one rank a card (`fluid_bench/ranks.py`)
under a loop that sets `MULTI_CARD`; the ranks' numbers are merged into
the one line (`merge`):

  attempted          the same on every rank, or the run is not correct
  the window         calls over the longest rank window, each call's time
                     the longest rank's; the loop's `end_to_end(count,
                     seconds, times)` turns them into its metrics
                     (`steps_per_s`: calls / longest window; `step_ms_p95`:
                     the 95th percentile of the per-call maximum)
  setup_s            the last rank's: its window's start less the parent's
                     first statement
  checks             `state_gap` the widest over the ranks, the counts summed
  failed             samples that failed on any rank
  memory_peak_bytes  the fullest card's peak
  busy_s, window_s   means over the ranks (so their ratio is the cards'
                     mean busy share); each rank's pair in `device.ranks`
  per-layer metrics  the reader's `merge(values)` over the ranks' values in
                     rank order where it defines one, else their mean; a
                     metric some rank did not read is left out
  breakdown          rank 0's

It exits non-zero and prints no result where no CUDA card is visible, or
fewer than the cell asks for, where the cell's reference refuses its
configuration (`judged_by`, asked before any set-up or rank), where JAX
or the JAX package was loaded into the process (or into a rank), or where
a rank raised, died or did not answer in time.  Caches go to `.bench_cache/` in the checkout, Python's
bytecode too where the installation keeps none beside torch's sources.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that must never be loaded: JAX and the JAX
# package the program was ported from (compared whole: the program's own
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_fluid")


def use_cache_dirs(root: Path) -> None:
    """Point every build and kernel cache a run could fill into fixed
    directories of the checkout."""
    base = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(base / "nv")


def use_bytecode_cache(root: Path) -> None:
    """Keep compiled bytecode in the checkout where the installation has
    none beside torch's sources: with writing it turned off as well
    (PYTHONDONTWRITEBYTECODE), every run would compile those sources
    anew, seconds of set-up that vary from run to run."""
    import importlib.util
    spec = importlib.util.find_spec("torch")
    if spec is None or not spec.origin or \
            os.path.exists(importlib.util.cache_from_source(spec.origin)):
        return
    sys.pycache_prefix = str(root / ".bench_cache" / "pycache")
    sys.dont_write_bytecode = False


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def library_kernels() -> tuple:
    """The names of the program's own CUDA kernels: every `__global__`
    function in its sources."""
    import tpu_fluid_torch
    csrc = Path(tpu_fluid_torch.__file__).parent / "csrc"
    names = []
    for src in sorted(csrc.glob("*.cu")):
        names += re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
            r"(\w+)\s*\(", src.read_text())
    return tuple(names)


def matcher(names):
    """A test of a kernel's name in the trace for any of `names`."""
    pattern = re.compile(r"\b(?:" + "|".join(map(re.escape, names))
                         + r")\b")
    return lambda name: bool(pattern.search(name))


class Run:
    """What a per-layer metric's reader reads."""

    def __init__(self, window, fields: dict, root: Path):
        from fluid_bench.manifest import family
        self.window = window
        self.fields = fields
        self.root = root
        self.library = matcher(library_kernels())
        self._family = family

    def roofline_pct(self, name: str):
        """100 x the bound of a kernel family's work a step over its
        device ms a step in the trace, or None where it did not run."""
        if not self.window.trace:
            return None
        fam = self._family(name, self.root)
        ms = self.window.trace.kernel_ms_per_step(matcher(fam.NAMES))
        if ms is None:
            return None
        # a rank of a multi-card cell does its slab's share of the work
        shards = getattr(self.window.mesh, "size", 1)
        return 100.0 * fam.bound(self.fields)[0] / shards / ms


def card_name(device) -> str:
    import torch
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "power limit not read"


class Unjudged(ValueError):
    """The cell's reference cannot judge its configuration."""


def judged_by(manifest, cell):
    """The cell's reference module, once its `Scene` has taken the
    configuration; `Unjudged`, naming the option and the reference, where
    it refuses it.  Asked before any set-up, so such a run ends in
    seconds."""
    reference = manifest.reference(cell.reference)
    try:
        reference.Scene(cell.config["fields"])
    except ValueError as e:
        raise Unjudged(
            f"{cell.name}: the reference {cell.reference!r} "
            f"(fluid_bench/reference/{cell.reference}.py) cannot judge the "
            f"configuration: {e}") from None
    return reference


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device, t0: float, notes: list | None = None,
             marks: list | None = None, limit: float | None = None) -> dict:
    """One run of cell `name`: the result line as a dict.  A line on the
    window's times, and one on set-up's phases (from `marks`, the
    (phase, host clock at its end) of what came before, and then the
    loop's own), are appended to `notes` where given.  A multi-card cell
    runs its ranks on `device`'s type, each answering within `limit`
    seconds (`ranks.LIMIT` where None)."""
    import torch

    from fluid_bench import check, loop
    from fluid_bench.manifest import Manifest

    manifest = Manifest(root)
    cell = manifest.cell(name)
    fields = cell.config["fields"]
    reference = judged_by(manifest, cell)
    device = torch.device(device)
    if cell.chips > 1:
        from fluid_bench import ranks
        payloads = ranks.run(root, name, seed, seconds, trace, device.type,
                             t0, limit=limit)
        result = merge(payloads, cell, manifest, trace, root)
        if notes is not None:
            times = [max(ts) for ts in zip(*(p["times"] for p in payloads))]
            notes.append(f"fluid_bench: window {spread(times)} (the "
                         f"slowest of {cell.chips} ranks a call)")
            marks = marks or [("start", t0)]
            notes.append(f"fluid_bench: rank 0 "
                         f"{setup_split(marks + payloads[0]['setup'])}")
            notes.append("fluid_bench: peak bytes by card " + ", ".join(
                str(p["memory_peak_bytes"]) for p in payloads))
        return result
    window = loop.run(cell.traffic, fields, seed, seconds, trace, device, t0,
                      root=root)

    # the program's graphs and pools go before the reference runs; the
    # samples keep the states they hold
    from tpu_fluid_torch.solver import graph
    graph.clear_graphs()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    verdict = check.judge(window.samples, fields, cell.traffic, device,
                          reference=reference)
    window.samples = None

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": card_name(device), "count": cell.chips,
           "memory_peak_bytes": window.memory_peak_bytes}
    metrics = {}
    if trace:
        run = Run(window, fields, root)
        for m in cell.per_layer:
            value = manifest.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if window.trace is not None and window.trace.device:
            dev["busy_s"] = window.trace.busy_seconds()
            dev["window_s"] = window.trace.seconds
    else:
        values = dict(window.end_to_end, setup_s=window.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": verdict["correct"], "attempted": window.count,
              "failed": verdict["failed"], "metrics": metrics,
              "device": dev}
    if trace and window.trace is not None and window.trace.device:
        result["breakdown"] = window.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in verdict["numbers"].items()}
    if notes is not None:
        notes.append(f"fluid_bench: window {spread(window.times)}")
        marks = marks or [("start", t0)]
        notes.append(f"fluid_bench: {setup_split(marks + window.setup)}")
    return result


def merge(payloads: list, cell, manifest, trace: bool, root: Path) -> dict:
    """The result line of a multi-card run from its ranks' payloads, by
    the rules of this module's docstring."""
    from fluid_bench import check
    from fluid_bench.manifest import loop_module
    from fluid_bench.ranks import RankFailure
    found = sorted({m for p in payloads for m in p["forbidden"]})
    if found:
        raise RankFailure(f"a rank loaded {', '.join(found)}")
    attempted = {p["attempted"] for p in payloads}
    verdict = check.merge_verdicts(
        [p["verdict"] for p in payloads if p["verdict"] is not None])
    kind = payloads[0]["kind"]
    dev = {"platform": "cpu" if kind == "cpu" else "gpu", "kind": kind,
           "count": len(payloads),
           "memory_peak_bytes": max(p["memory_peak_bytes"]
                                    for p in payloads)}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            values = [p["per_layer"].get(m["name"]) for p in payloads]
            if any(v is None for v in values):
                continue
            reader = manifest.reader_module(m["name"])
            fold = getattr(reader, "merge", None)
            value = fold(values) if fold else sum(values) / len(values)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        pairs = [(p["busy_s"], p["window_s"]) for p in payloads]
        if all(b is not None for b, _ in pairs):
            dev["busy_s"] = sum(b for b, _ in pairs) / len(pairs)
            dev["window_s"] = sum(w for _, w in pairs) / len(pairs)
            dev["ranks"] = [list(pair) for pair in pairs]
    else:
        loop = loop_module(cell.traffic["loop"], root)
        times = [max(ts) for ts in zip(*(p["times"] for p in payloads))]
        values = loop.end_to_end(max(attempted),
                                 max(p["seconds"] for p in payloads), times)
        values["setup_s"] = max(p["setup_s"] for p in payloads)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": verdict["correct"] and len(attempted) == 1,
              "attempted": max(attempted), "failed": verdict["failed"],
              "metrics": metrics, "device": dev}
    if trace and payloads[0]["breakdown"] is not None:
        result["breakdown"] = payloads[0]["breakdown"]
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in verdict["numbers"].items()}
    return result


def setup_split(marks: list) -> str:
    """One line on set-up: the seconds of each phase, from (phase, host
    clock at its end) marks that start at the process's first statement."""
    parts = [f"{name} {b - a:.3f}"
             for (_, a), (name, b) in zip(marks, marks[1:])]
    return (f"set-up s: {', '.join(parts)}; total "
            f"{marks[-1][1] - marks[0][1]:.3f}")


def spread(times) -> str:
    """One line on the window's step (or frame) times, for the record."""
    from fluid_bench.stats import percentile
    p50 = percentile(times, 50)
    slow = sum(t for t in times if t > 2 * p50)
    return (f"{len(times)} samples, ms p50 {p50 * 1e3:.4f} p95 "
            f"{percentile(times, 95) * 1e3:.4f} p99 "
            f"{percentile(times, 99) * 1e3:.4f} max {max(times) * 1e3:.4f}, "
            f"{slow / sum(times) * 100:.2f}% of the time in samples over "
            f"2 x p50")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    use_cache_dirs(ROOT)
    use_bytecode_cache(ROOT)
    marks = [("start", T0)]

    import torch
    marks.append(("import torch", time.perf_counter()))

    from fluid_bench.manifest import Manifest
    cell = Manifest(ROOT).cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"fluid_bench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    marks.append(("cell and card query", time.perf_counter()))
    notes = []
    from fluid_bench.ranks import RankFailure
    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", T0, notes, marks)
    except (RankFailure, Unjudged) as e:
        print(f"fluid_bench: {e}", file=sys.stderr)
        return 1
    found = forbidden_modules()
    if found:
        print(f"fluid_bench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 1
    print(f"fluid_bench: card {power_limit()}", file=sys.stderr)
    for line in notes:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
