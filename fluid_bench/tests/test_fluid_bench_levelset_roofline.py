"""The level set's roofline: its family's bound at the level-set cell's
shapes, its names against the kernels of the program's source, and its
reader, which reads only the family's kernels in the traced stretch."""

from __future__ import annotations

import json
import re
import types

import pytest

from fluid_bench import run
from fluid_bench.manifest import Manifest, family
from fluid_bench.tests.conftest import REPO
from fluid_bench.trace import STRETCH, Summary

CELL = "fountain-256-levelset.stream_spans"


def _fields():
    return json.loads((REPO / "fluid_bench/configs/fountain-256-levelset.json")
                      .read_text())["fields"]


def test_the_bound_is_the_byte_floor_at_the_cells_shapes():
    """The 512^3 detailed grid's u8 occupancy read and f1 and f2 written,
    9 bytes a cell, and the 256^3 types read once: 1,224,736,768 bytes at
    3.35 TB/s; the smoothing's operations never bound it."""
    fields = _fields()
    ms, by = family("levelset").bound(fields)
    moved = 9 * 512 ** 3 + 256 ** 3
    assert moved == 1_224_736_768
    assert by == "bytes"
    assert ms == pytest.approx(moved / 3.35e12 * 1e3)
    assert round(ms, 4) == 0.3656
    ops_ms = 9 * 512 ** 3 * fields["levelset_smooth"] / 67e12 * 1e3
    assert ops_ms < ms


def test_the_names_are_every_kernel_of_the_level_sets_source():
    src = (REPO / "tpu_fluid_torch/csrc/levelset.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                       r"\([^)]*\)\s*)?(\w+)\s*\(", src)
    assert sorted(family("levelset").NAMES) == sorted(names)
    assert set(names) <= set(run.library_kernels())


def test_the_metric_moves_the_cells_steps():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"]
                 if m["name"] == "kernel.levelset_roofline")
    assert entry == {"name": "kernel.levelset_roofline", "unit": "%",
                     "better": "higher", "source": "device_trace",
                     "layer": "CUDA kernels", "moves": "steps_per_s",
                     "workloads": [CELL]}
    assert callable(Manifest(REPO).reader("kernel.levelset_roofline"))


def _window(kernels, steps=4):
    """A window whose traced stretch holds `kernels` (name, microseconds)
    one after another."""
    events = [{"ph": "X", "cat": "user_annotation", "name": STRETCH,
               "ts": 0.0, "dur": 1e6}]
    at = 10.0
    for name, us in kernels:
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": at,
                       "dur": us})
        at += us + 1.0
    return types.SimpleNamespace(trace=Summary(events, steps), mesh=None)


def _read(window):
    reader = Manifest(REPO).reader("kernel.levelset_roofline")
    return reader(run.Run(window, _fields(), REPO))


def test_the_reader_gives_none_without_a_trace_or_its_kernels():
    assert _read(types.SimpleNamespace(trace=None, mesh=None)) is None
    plain = _window([("void at::native::vectorized_elementwise_kernel<4, "
                      "at::native::CUDAFunctor_add<float>>(int)", 5000.0),
                     ("(anonymous namespace)::surface_march_kernel<unsigned "
                      "char, 4, false>(unsigned char const*)", 900.0)])
    assert _read(plain) is None


def test_the_reader_takes_the_whole_family_a_step():
    """Scan, flags and march: 3 steps of 100 + 20 + 880 us, so 1 ms a
    step, against the 0.3656 ms bound."""
    kernels = []
    for _ in range(3):
        kernels += [("(anonymous namespace)::levelset_live_scan_kernel("
                     "(anonymous namespace)::Params, int)", 100.0),
                    ("(anonymous namespace)::levelset_live_flag_kernel("
                     "(anonymous namespace)::Params, int)", 20.0),
                    ("void (anonymous namespace)::levelset_march_kernel<4, "
                     "2>((anonymous namespace)::Params, int*)", 880.0),
                    ("(anonymous namespace)::jacobi_march_kernel<4>(float "
                     "const*)", 2500.0)]
    got = _read(_window(kernels, steps=3))
    assert got == pytest.approx(100.0 * family("levelset").bound(
        _fields())[0] / 1.0)
    assert 0 < got < 100
