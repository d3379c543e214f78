"""A device trace of a bounded stretch of the window, and what is read
from it.

`Stretch` runs `torch.profiler` (CPU and CUDA activity) around a few calls
of the window, inside a harness span `fluid_bench.stretch` that ends once
the device has finished them.  The Chrome trace it exports (to the run's
temporary directory, deleted once read) gives each device operation
(kernels, copies, fills) with its start and duration on the same clock as
the host's spans, which the harness opens with `span` around the calls it
makes into the program.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import time
from collections import defaultdict

import torch

from fluid_bench import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "fluid_bench.stretch"
# the harness's spans, by what the host does inside them
SPANS = ("jit_step", "wait", "step", "render_frame", "to_host")


def span(name: str, on: bool):
    """A named host span in the trace where tracing is on."""
    if on:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class Summary:
    """The stretch's device operations and the harness's host spans, in
    microseconds on one clock; `steps` is the number of steps (one a call,
    or a frame) the stretch holds."""

    def __init__(self, events: list, steps: int):
        self.steps = steps
        self.device = []      # (start, end, name, cat)
        self.spans = []       # (start, end, name)
        stretch = None
        for e in events:
            if e.get("ph") != "X":
                continue
            start = float(e["ts"])
            end = start + float(e.get("dur", 0.0))
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append((start, end, e.get("name", ""), cat))
            elif cat == "user_annotation":
                if e.get("name") == STRETCH:
                    stretch = (start, end)
                elif e.get("name") in SPANS:
                    self.spans.append((start, end, e["name"]))
        if stretch is None:
            raise RuntimeError("the trace holds no fluid_bench.stretch span")
        self.start, self.end = stretch

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-6

    def intervals(self) -> list:
        return [(a, b) for a, b, _, _ in self.device]

    def busy_seconds(self) -> float:
        return stats.covered(self.intervals(), self.start, self.end) * 1e-6

    def idle_pct(self) -> float | None:
        if not self.device:
            return None
        return stats.idle_pct(self.intervals(), self.start, self.end)

    def kernel_ms_per_step(self, match) -> float | None:
        """Device ms a step of the kernels whose name `match` accepts, or
        None where none ran."""
        times = [b - a for a, b, name, cat in self.device
                 if cat == "kernel" and match(name)
                 and self.start <= a < self.end]
        if not times or self.steps <= 0:
            return None
        return sum(times) * 1e-3 / self.steps

    def breakdown(self) -> dict:
        """The ten device operations that took most time, by name, and the
        ten longest idle gaps, each by the harness span open on the host
        at its middle ("host" where none was)."""
        by_name = defaultdict(float)
        for a, b, name, _ in self.device:
            if self.start <= a < self.end:
                by_name[short(name)] += (b - a) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = []
        for a, b in stats.gaps(self.intervals(), self.start, self.end):
            mid = (a + b) / 2
            open_ = [s for s in self.spans if s[0] <= mid <= s[1]]
            label = max(open_, key=lambda s: s[0])[2] if open_ else "host"
            idle.append([label, (b - a) * 1e-6])
        idle.sort(key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": idle[:10]}


def short(name: str) -> str:
    """A kernel's name without its return type, arguments and template
    arguments past 80 characters."""
    name = re.sub(r"^void ", "", name)
    return name[:80]


class Stretch:
    """The profiler over a stretch of the window: `start` turns it on,
    `warm` calls later `open` syncs and opens the stretch's span, `calls`
    calls later `close` syncs, closes the span and turns the profiler off;
    `read` exports and reads the trace (after the window).  `paused` is the
    host time spent in these, which the window does not count."""

    def __init__(self, device: torch.device, warm: int, calls: int):
        self.device = device
        self.warm = warm
        self.calls = calls
        self.phase = "off"          # off, warm, open, closed
        self.paused = 0.0
        self.prof = None

    def on(self) -> bool:
        """Whether the profiler is recording."""
        return self.phase in ("warm", "open")

    def start(self):
        t = time.perf_counter()
        self._sync()
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.phase = "warm"
        self.paused += time.perf_counter() - t

    def advance(self, calls_done: int) -> None:
        """Open or close the stretch once `calls_done` calls of the
        window were made."""
        t = time.perf_counter()
        if self.phase == "warm" and calls_done >= self.warm:
            self._sync()
            self.span = torch.profiler.record_function(STRETCH)
            self.span.__enter__()
            self.phase = "open"
        elif self.phase == "open" and calls_done >= self.warm + self.calls:
            self.close()
        self.paused += time.perf_counter() - t

    def close(self):
        if self.phase == "open":
            self._sync()
            self.span.__exit__(None, None, None)
        if self.on():
            self._sync()
            self.prof.__exit__(None, None, None)
            self.phase = "closed" if self.phase == "open" else "off"

    def read(self) -> Summary | None:
        """The stretch's summary, or None where it never closed."""
        self.close()
        if self.phase != "closed":
            return None
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return Summary(events, self.calls)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
