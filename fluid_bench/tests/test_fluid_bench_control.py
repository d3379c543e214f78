"""The comparison that decides `correct` fails what it must: the control
(the reference in bfloat16 put in the program's place) and each fault a
cell of this benchmark can have, planted under a whole run driven on the
CPU with the harness's look for a card skipped."""

from __future__ import annotations

import time

import pytest
import torch

from fluid_bench import check, loop
from fluid_bench.manifest import Manifest
from fluid_bench.run import run_cell


def _run(root, cell):
    return run_cell(root, cell, 2 ** 31 + 5, 0.2, False, "cpu",
                    time.perf_counter())


@pytest.mark.parametrize("cell", ["tiny.stream", "tiny.view"])
def test_a_sound_run_is_correct(tiny, cell):
    r = _run(tiny, cell)
    assert r["correct"] and r["failed"] == 0
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", ["tiny.stream", "tiny.view"])
def test_the_control_is_not_correct(tiny, cell):
    c = Manifest(tiny).cell(cell)
    fields = c.config["fields"]
    window = loop.run(c.traffic, fields, 99, 0.2, False,
                      torch.device("cpu"), time.perf_counter())
    sound = check.judge(window.samples, fields, c.traffic, "cpu")
    control = check.judge(window.samples, fields, c.traffic, "cpu",
                          substitute=check.control(fields))
    assert sound["correct"]
    assert not control["correct"]
    assert control["numbers"]["state_gap"] > 100 * check.LIMITS["state_gap"]
    assert control["numbers"]["state_mismatch"] > 0


def _unchanged(real):
    return lambda s, cfg, scene=None: s


def _half_unmoved(real):
    def step(s, cfg, scene=None):
        out = real(s, cfg, scene)
        pos = out.positions.clone()
        half = pos.shape[0] // 2
        pos[half:] = s.positions[half:]
        return out._replace(positions=pos)
    return step


def _altered(real):
    def step(s, cfg, scene=None):
        out = real(s, cfg, scene)
        pos = out.positions.clone()
        pos[0, 1] += 0.5
        return out._replace(positions=pos)
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_unmoved, _altered],
                         ids=["unchanged", "half_unmoved", "altered"])
@pytest.mark.parametrize("cell", ["tiny.stream", "tiny.view"])
def test_a_broken_step_is_not_correct(tiny, monkeypatch, cell, fault):
    import tpu_fluid_torch.engine as engine
    from tpu_fluid_torch.solver import graph
    broken = fault(graph.jit_step)
    monkeypatch.setattr(graph, "jit_step", broken)
    monkeypatch.setattr(engine, "jit_step", broken)
    r = _run(tiny, cell)
    assert not r["correct"] and r["failed"] > 0


def _skips(real, k):
    """The k-th call leaves its state as it was."""
    calls = []

    def step(s, cfg, scene=None):
        calls.append(None)
        return s if len(calls) == k else real(s, cfg, scene)
    return step


@pytest.mark.parametrize("cell,first", [
    ("tiny.stream", loop.SETUP_CALLS + 1),
    ("tiny.view", loop.SETUP_FRAMES + 1)])
def test_a_skipped_window_step_is_not_correct(tiny, monkeypatch, cell,
                                              first):
    """The window's first call, which no sample reads unless the window
    holds one call alone, leaves its state as it was."""
    import tpu_fluid_torch.engine as engine
    from tpu_fluid_torch.solver import graph
    broken = _skips(graph.jit_step, first)
    monkeypatch.setattr(graph, "jit_step", broken)
    monkeypatch.setattr(engine, "jit_step", broken)
    r = _run(tiny, cell)
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["window_mismatch"]["value"] > 0


def test_an_altered_mesh_is_not_correct(tiny, monkeypatch):
    """The mesh judged is the one the timed frame was drawn from."""
    from tpu_fluid_torch.engine import Simulation
    real = Simulation.surface_mesh

    def surface_mesh(self):
        mesh = real(self)
        verts = mesh.vertices.clone()
        verts[mesh.valid.nonzero()[0, 0]] += 0.25
        return mesh._replace(vertices=verts)
    monkeypatch.setattr(Simulation, "surface_mesh", surface_mesh)
    r = _run(tiny, "tiny.view")
    assert not r["correct"]
    assert r["checks"]["mesh_mismatch"]["value"] > 0
    assert r["checks"]["state_gap"]["value"] == 0.0


def test_an_altered_pixel_is_not_correct(tiny, monkeypatch):
    from tpu_fluid_torch.engine import Simulation
    real = Simulation.render_frame

    def render(self, *a, **kw):
        img = real(self, *a, **kw).clone()
        img[3, 4, 0] ^= 1
        return img
    monkeypatch.setattr(Simulation, "render_frame", render)
    r = _run(tiny, "tiny.view")
    assert not r["correct"]
    assert r["checks"]["frame_pixels"]["value"] > 0
    assert r["checks"]["state_gap"]["value"] == 0.0
