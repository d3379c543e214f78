"""The port's bench (`tpu_fluid_torch/bench.py`) against the JAX package's
`bench.py`: the same override parser, the same JSON keys; it refuses to
run without CUDA, and its timed loop runs on the CPU when asked to (the
SPMD and multi-card routes: tests/test_torch_spmd_graph.py)."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest

from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid_torch import bench
from tpu_fluid_torch.core.config import FluidConfig

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


def jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(ROOT, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("spec", [
    "", "grid_fused=true,jacobi_iters=7,gravity=9.81",
    "grid_fused=no,reference_pressure_parity=0",
    "pallas_mode=off,advect_method=shift,dt=0.02",
    "surface_render_resolution=3,particle_count=1000"])
def test_apply_overrides_matches_bench_py(spec):
    want, want_applied = jax_bench()._apply_overrides(
        JaxConfig.scaled_scene(16), spec)
    got, applied = bench._apply_overrides(FluidConfig.scaled_scene(16), spec)
    assert applied == want_applied
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), \
            field.name


@pytest.mark.parametrize("spec,error", [("grid_fused=ture", ValueError),
                                        ("not_a_field=1", AttributeError),
                                        ("jacobi_iters=x", ValueError)])
def test_apply_overrides_raises_as_bench_py(spec, error):
    with pytest.raises(error):
        jax_bench()._apply_overrides(JaxConfig.scaled_scene(16), spec)
    with pytest.raises(error):
        bench._apply_overrides(FluidConfig.scaled_scene(16), spec)


def test_json_line_has_bench_py_keys(monkeypatch):
    """bench.py's line, with its run replaced by a fixed result, against
    the port's line: the same keys, and the card named in `metric`."""
    module = jax_bench()
    monkeypatch.setattr(module, "_run_once", lambda *a: (1, 12.5, [12.5]))
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        module.main()
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    line = bench.result_line(128, 1_000_000, 61.234,
                             "NVIDIA H100 80GB HBM3, 700.00 W",
                             env={"TPU_FLUID_BENCH_SET": "jacobi_iters=9"})
    assert list(line) == list(want)
    assert line["unit"] == want["unit"] == "steps/s"
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in line["metric"]
    assert "overrides [jacobi_iters=9]" in line["metric"]
    assert line["value"] == 61.23 and line["vs_baseline"] == 1.021
    json.dumps(line)


def test_main_without_cuda_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "tpu_fluid_torch.bench"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert r.stderr.strip().splitlines() == [
        "tpu_fluid_torch.bench: no CUDA device; the bench runs on the card "
        "only"]


def test_run_once_on_the_cpu():
    ndev, sps, chunks = bench._run_once(8, 300, steps=5, sync_every=2,
                                        device="cpu")
    assert ndev == 1 and sps > 0
    assert len(chunks) == 3 and all(c > 0 for c in chunks)


def test_sharded_route_is_not_ported(monkeypatch):
    """No route raises "not ported": TPU_FLUID_BENCH_SPMD=1 runs the SPMD
    program form on a 1-rank mesh (on the CPU, its eager steps)."""
    monkeypatch.setenv("TPU_FLUID_BENCH_SPMD", "1")
    ndev, sps, chunks = bench._run_once(8, 300, steps=1, sync_every=1,
                                        device="cpu")
    assert ndev == 1 and sps > 0 and len(chunks) == 1
