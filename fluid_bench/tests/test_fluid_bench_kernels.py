"""The frozen roofline arithmetic at the cells' shapes, and the names the
trace is read by."""

from __future__ import annotations

import json

import pytest

from fluid_bench.manifest import family
from fluid_bench.run import library_kernels, matcher
from fluid_bench.tests.conftest import REPO


def _fields(name):
    return json.loads((REPO / f"fluid_bench/configs/{name}.json")
                      .read_text())["fields"]


def test_bounds_at_256():
    fields = _fields("fountain-256")
    ms, by = family("jacobi").bound(fields)
    # 7 operations x 256^3 cells x 199 sweeps / 67 TFLOP/s
    assert by == "operations"
    assert ms == pytest.approx(7 * 256 ** 3 * 199 / 67e12 * 1e3)
    assert round(ms, 3) == 0.349
    ms, by = family("surface").bound(fields)
    # 16 bytes a cell of the 512^3 detailed grid / 3.35 TB/s
    assert by == "bytes"
    assert ms == pytest.approx(16 * 512 ** 3 / 3.35e12 * 1e3)
    assert round(ms, 3) == 0.641


def test_bounds_at_20():
    fields = _fields("fountain-20")
    ms, by = family("jacobi").bound(fields)
    assert by == "operations" and ms == pytest.approx(0.000166, rel=1e-2)
    ms, by = family("surface").bound(fields)
    assert by == "bytes" and ms == pytest.approx(0.00478, rel=1e-2)


def test_library_kernel_names():
    names = library_kernels()
    for name in ("jacobi_whole_kernel", "jacobi_march_kernel",
                 "surface_march_kernel", "advect_march_kernel",
                 "particle_move_kernel", "classify_march_kernel",
                 "forces_march_kernel", "project_march_kernel"):
        assert name in names
    for fam in ("jacobi", "surface"):
        assert set(family(fam).NAMES) <= set(names)
    lib = matcher(names)
    assert lib("void (anonymous namespace)::jacobi_march_kernel<4>"
               "(float const*, unsigned char const*, float*)")
    assert lib("surface_march_kernel(unsigned char const*)")
    assert not lib("void at::native::vectorized_elementwise_kernel<4, "
                   "at::native::CUDAFunctor_add<float>>(int)")
    assert not lib("jacobi_march_kernel_v2")
