"""A domain-sharded multi-card cell judged by its own sharded reference
(`reference/step_domain.py`), as `fountain-768.spmd_stream` is: a tiny copy
on 2 gloo ranks is correct, and a sampled output broken on one rank (an
active particle moved half a cell, a cell type changed, the step counter
off by one) is not; the control is not correct either; and the cell's
readers of the ranks (`exchange.nccl_ms`, `ranks.imbalance_pct`,
`stages.plain_ms.spmd`) read a made-up trace and merge the ranks' values
as their docstrings say."""

from __future__ import annotations

import json
import time
import types

import pytest

from fluid_bench import check, run, trace
from fluid_bench.manifest import Manifest
from fluid_bench.tests.conftest import REPO, add_cell, tiny_root

SEED = 2 ** 31 + 2 ** 30 + 5
LIMIT = 120.0
CELL = "fountain-768.spmd_stream"

# spmd_stream, with one thing of rank 1's window's last sample broken
BROKEN_LOOP = '''
import torch

from fluid_bench.manifest import loop_module

_real = loop_module("spmd_stream")
MULTI_CARD = True
end_to_end = _real.end_to_end
BREAK = {kind!r}


def run(traffic, fields, seed, seconds, trace, device, t0, ranks=None):
    window = _real.run(traffic, fields, seed, seconds, trace, device, t0,
                       ranks=ranks)
    if ranks.rank == 1:
        out = dict(window.samples[1]["output"])
        if BREAK == "particle":
            pos = out["positions"].clone()
            i = int(torch.nonzero(out["active"])[0, 0])
            pos[i, 0] += 0.5
            out["positions"] = pos
        elif BREAK == "cell_type":
            types = out["cell_types"].clone()
            types.view(-1)[types.numel() // 2] ^= 1
            out["cell_types"] = types
        else:
            out["step"] = out["step"] + 1
        window.samples[1]["output"] = out
    return window
'''
BROKEN = ("particle", "cell_type", "step")


def _set_domain(root, config: str) -> None:
    path = root / f"fluid_bench/configs/{config}.json"
    data = json.loads(path.read_text())
    data["fields"]["particle_sharding"] = "domain"
    path.write_text(json.dumps(data))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("domain"))
    add_cell(root, "domain2.spmd_stream", "spmd_stream", chips=2,
             reference="step_domain")
    _set_domain(root, "domain2")
    mix = json.loads((REPO / "fluid_bench/traffic/spmd_stream.json")
                     .read_text())
    for kind in BROKEN:
        name = f"broken_{kind}"
        add_cell(root, f"{name}2.{name}", name, chips=2,
                 reference="step_domain",
                 loop_source=BROKEN_LOOP.format(kind=kind),
                 mix=dict(mix, loop=name))
        _set_domain(root, f"{name}2")
    return root


def _run(root, cell):
    return run.run_cell(root, cell, SEED, 0.3, False, "cpu",
                        time.perf_counter(), limit=LIMIT)


def test_the_committed_cell_names_the_sharded_reference():
    manifest = Manifest(REPO)
    cell = manifest.cell(CELL)
    assert cell.chips == 4 and cell.traffic["loop"] == "spmd_stream"
    assert cell.reference == "step_domain"
    assert run.judged_by(manifest, cell).SHARDED
    assert {m["name"] for m in cell.end_to_end} == {
        "steps_per_s", "step_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "kernel.jacobi_roofline", "kernel.surface_roofline",
        "exchange.nccl_ms", "ranks.imbalance_pct", "device.idle_pct.stream",
        "stages.plain_ms.spmd"}


def test_the_seed_sizes_are_the_sharded_references():
    """The committed configuration is seeded at the sizes its own
    reference's `Scene` gives (the default reference refuses its domain
    sharding)."""
    from fluid_bench import state
    from fluid_bench.reference.step_domain import Scene
    fields = Manifest(REPO).cell(CELL).config["fields"]
    scene = Scene(fields)
    assert state.detailed_size(fields) == scene.detailed_size
    assert state.inertia_dtype(fields) == scene.inertia_dtype


def test_a_tiny_copy_is_correct(root):
    """Every sample of both ranks equals the sharded reference: the gap
    and every count 0."""
    r = _run(root, "domain2.spmd_stream")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["device"]["count"] == 2
    assert all(c["value"] == 0 for c in r["checks"].values()), r["checks"]


@pytest.mark.parametrize("kind", BROKEN)
def test_a_broken_sample_on_one_rank_is_not_correct(root, kind):
    r = _run(root, f"broken_{kind}2.broken_{kind}")
    assert not r["correct"] and r["failed"] >= 1
    checks = {k: c["value"] for k, c in r["checks"].items()}
    if kind == "particle":
        assert checks["state_gap"] > check.LIMITS["state_gap"]
    elif kind == "cell_type":
        assert checks["state_mismatch"] == 1
    else:
        assert checks["window_mismatch"] >= 1


def test_the_control_is_not_correct(root):
    from fluid_bench import control
    r = control.readings(root, "domain2.spmd_stream", SEED, 0.3, True,
                         device="cpu")
    assert r["program"]["correct"]
    assert not r["control"]["correct"] and r["control"]["failed"] > 0
    assert r["control"]["numbers"]["state_gap"] > \
        100 * check.LIMITS["state_gap"]


# ------------------------------------------------------------ the readers
def _summary(ops, steps=2) -> trace.Summary:
    """A trace of a stretch from 0 to 1000 us holding `ops`, (start, us,
    name, cat) each, and one before the stretch."""
    events = [{"ph": "X", "ts": 0.0, "dur": 1000.0, "cat": "user_annotation",
               "name": trace.STRETCH},
              {"ph": "X", "ts": -50.0, "dur": 10.0, "cat": "kernel",
               "name": "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)"}]
    events += [{"ph": "X", "ts": a, "dur": d, "cat": cat, "name": name}
               for a, d, name, cat in ops]
    return trace.Summary(events, steps)


def _run_of(summary):
    return types.SimpleNamespace(window=types.SimpleNamespace(
        trace=summary, mesh=types.SimpleNamespace(size=4)),
        library=run.matcher(("jacobi_march_kernel",)))


OPS = [(10.0, 100.0, "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)",
        "kernel"),
       (120.0, 60.0, "ncclKernel_AllReduce_RING_LL_Sum_int64_t", "kernel"),
       (200.0, 300.0, "void jacobi_march_kernel<4>(float const*)", "kernel"),
       (520.0, 40.0, "Memcpy DtoD (Device -> Device)", "gpu_memcpy"),
       (600.0, 20.0, "Memset (Device)", "gpu_memset")]


def test_the_nccl_reader():
    reader = Manifest(REPO).reader_module("exchange.nccl_ms")
    assert reader.read(_run_of(_summary(OPS))) == pytest.approx(0.08)
    assert reader.read(_run_of(_summary(OPS[2:]))) is None
    assert reader.read(_run_of(None)) is None
    assert reader.merge([0.5, 0.2, 0.9, 0.3]) == 0.2


def test_the_imbalance_reader():
    reader = Manifest(REPO).reader_module("ranks.imbalance_pct")
    assert reader.read(_run_of(_summary(OPS))) == pytest.approx(0.18)
    assert reader.read(_run_of(_summary([]))) is None
    assert reader.read(_run_of(None)) is None
    assert reader.merge([2.0, 4.0, 3.0, 1.0]) == pytest.approx(75.0)
    assert reader.merge([2.5, 2.5]) == 0.0
    assert reader.merge([0.0, 0.0]) == 0.0


def test_the_plain_spmd_reader():
    """PyTorch's kernels only: neither the library's K2 nor NCCL's, and no
    copy or fill; the rank with the most plain work is the cell's."""
    reader = Manifest(REPO).reader_module("stages.plain_ms.spmd")
    plain = (700.0, 50.0, "void at::native::vectorized_elementwise_kernel",
             "kernel")
    assert reader.read(_run_of(_summary(OPS + [plain]))) == \
        pytest.approx(0.025)
    assert reader.read(_run_of(_summary(OPS))) is None
    assert reader.read(_run_of(None)) is None
    assert reader.merge([0.5, 0.2, 0.9, 0.3]) == 0.9
