"""Configurations with options the default reference refuses: the seed
takes them (it reads sizes, not options), the domain layout made from the
slab seed is the program's, a cell whose reference refuses its
configuration ends before any set-up or rank, a domain-sharded cell
with a sharded reference of its own comes as new files and entries, and
the judge's numbers are taken a block at a time."""

from __future__ import annotations

import dataclasses
import json
import time

import pytest
import torch

from fluid_bench import check, ranks, run, state
from fluid_bench.manifest import Manifest, loop_module
from fluid_bench.reference.step import Scene
from fluid_bench.tests.conftest import REPO, add_cell, tiny_root, write

SEED = 2 ** 31 + 77
LIMIT = 120.0
# the options `reference/step.py` refuses that the program runs
OPTIONS = {
    "domain": {"particle_sharding": "domain"},
    "volume": {"volume_correction": 1.0, "volume_correction_every": 4},
    "levelset": {"surface_method": "levelset"},
    "redblack": {"pressure_solver": "redblack"},
}

# a sharded reference that takes domain-sharded particles: it cuts the
# slab seed's particles as the domain layout does, records the shapes it
# is handed on each rank, and steps nothing (a plain domain-decomposed
# step is not this test's)
DOMAIN_REFERENCE = '''
import math
from pathlib import Path

import torch
import torch.distributed as dist

from fluid_bench.reference.step import FIELDS, FLOAT_FIELDS  # noqa: F401
from fluid_bench.reference.step import Scene as _Scene

SHARDED = True


class Scene(_Scene):
    def __init__(self, fields):
        super().__init__(dict(fields, particle_sharding="index"))
        self.f = dict(fields)


def part(state, scene, group):
    r, n = dist.get_rank(group), dist.get_world_size(group)
    gx = scene.grid_size[0]
    pos, act = state["positions"], state["active"]
    owner = torch.clamp(torch.floor(pos[:, 0]), 0, gx - 1).long() // (gx // n)
    census = torch.bincount(owner[act], minlength=n)
    peak = max(1, int(census.max()))
    slots = max(peak, math.ceil(peak * scene.particle_slot_slack))
    slots = -(-slots // 128) * 128
    src = torch.nonzero(act & (owner == r)).squeeze(1)
    positions = torch.zeros((slots, 3), dtype=pos.dtype, device=pos.device)
    positions[:len(src)] = pos[src]
    active = torch.zeros((slots,), dtype=torch.bool, device=act.device)
    active[:len(src)] = True
    return dict(state, positions=positions, active=active)


def step(inp, scene, dtype=torch.float32, group=None):
    r = dist.get_rank(group)
    with open(Path(__file__).parents[2] / f"domain_{r}", "a") as f:
        f.write(" ".join(str(x) for x in (
            inp["velocity"].shape[1], inp["cell_types"].shape[0],
            inp["detailed_occ"].shape[0], inp["positions"].shape[0],
            int(inp["active"].sum()))) + "\\n")
    return {k: v.clone() for k, v in inp.items()}
'''

# a loop that must never be entered
STAND_IN_LOOP = '''
MULTI_CARD = True


def run(traffic, fields, seed, seconds, trace, device, t0, ranks=None):
    raise RuntimeError("the loop was entered")
'''


def _fields(**option) -> dict:
    from tpu_fluid_torch.core.config import FluidConfig
    cfg = FluidConfig.scaled_scene(12, particle_count=20000).replace(
        **option)
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def _set_fields(root, config: str, option: dict) -> None:
    path = root / f"fluid_bench/configs/{config}.json"
    data = json.loads(path.read_text())
    data["fields"].update(option)
    path.write_text(json.dumps(data))


@pytest.mark.parametrize("x_range", [None, (0, 6), (6, 12)])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_the_seed_reads_no_option(option, x_range):
    """(a) A configuration with an option the default reference refuses
    is seeded, bitwise as the same configuration without it."""
    plain = state.initial(_fields(), SEED, "cpu", x_range=x_range)
    seeded = state.initial(_fields(**OPTIONS[option]), SEED, "cpu",
                           x_range=x_range)
    assert seeded.keys() == plain.keys()
    for k, v in plain.items():
        assert seeded[k].dtype == v.dtype and torch.equal(seeded[k], v), k


@pytest.mark.parametrize("config", json.loads(
    (REPO / "BENCHMARK.json").read_text())["configs"],
    ids=lambda c: c["name"])
def test_the_seed_sizes_are_the_default_references(config):
    """Every committed configuration is seeded at the sizes the default
    reference's `Scene` gave the seed before it read sizes itself."""
    fields = json.loads((REPO / config["file"]).read_text())["fields"]
    scene = Scene(fields)
    assert state.detailed_size(fields) == scene.detailed_size
    assert state.inertia_dtype(fields) == scene.inertia_dtype


@pytest.mark.parametrize("n", [2, 4])
def test_the_domain_share_is_the_programs_layout(n):
    """(b) `spmd_stream.share` of a domain-sharded configuration, from the
    slab seed, is `domain_shard_state` of the whole seed on every rank,
    field by field and bitwise."""
    from fluid_bench.loop import as_state, program_config
    from tpu_fluid_torch.parallel.particles_domain import domain_shard_state
    fields = _fields(**OPTIONS["domain"])
    cfg = program_config(fields)
    whole = as_state(state.initial(fields, SEED, "cpu"))
    share = loop_module("spmd_stream").share
    for rank in range(n):
        got = share(fields, SEED, torch.device("cpu"), cfg, rank, n)
        want = domain_shard_state(whole, rank, n, cfg)
        for k in want._fields:
            a, b = getattr(got, k), getattr(want, k)
            assert a.dtype == b.dtype and torch.equal(a, b), (rank, k)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("options"))
    for chips in (1, 2):
        for option in OPTIONS:
            name = f"{option}{chips}"
            add_cell(root, f"{name}.stand_in", "stand_in", chips=chips,
                     loop_source=STAND_IN_LOOP,
                     mix={"loop": "stand_in", "why": "test"})
            _set_fields(root, name, OPTIONS[option])
    add_cell(root, "domain2sharded.spmd_stream", "spmd_stream", chips=2,
             reference="domain_ref")
    _set_fields(root, "domain2sharded", OPTIONS["domain"])
    write(root, "fluid_bench/reference/domain_ref.py", DOMAIN_REFERENCE)
    return root


@pytest.mark.parametrize("chips", [1, 2])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_a_refused_configuration_ends_before_set_up(root, option, chips,
                                                    monkeypatch, capsys):
    """(c) A cell whose configuration the default reference refuses exits
    non-zero with no result line, in seconds, naming the option and the
    reference: its loop is never entered and no rank is spawned."""
    def no_ranks(*a, **kw):
        raise AssertionError("a rank was spawned")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: chips)
    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(ranks, "run", no_ranks)
    start = time.monotonic()
    code = run.main(["--workload", f"{option}{chips}.stand_in", "--seed",
                     str(SEED), "--seconds", "1", "--trace", "0"])
    assert code != 0
    assert time.monotonic() - start < 30
    out, err = capsys.readouterr()
    assert not out.strip()
    key = next(iter(OPTIONS[option]))
    assert key in err and "'step'" in err and "reference/step.py" in err


def test_a_domain_sharded_cell_comes_as_new_files(root):
    """(d) A domain-sharded 2-rank gloo cell, its configuration naming a
    sharded reference of its own that takes domain-sharded particles:
    both ranks reach the window with the same calls, and each rank's
    reference is handed that rank's part of every sample."""
    from fluid_bench.loop import as_state, program_config
    from tpu_fluid_torch.parallel.particles_domain import domain_shard_state
    for r in (0, 1):
        (root / f"domain_{r}").unlink(missing_ok=True)
    manifest = Manifest(root)
    cell = manifest.cell("domain2sharded.spmd_stream")
    fields = cell.config["fields"]
    assert run.judged_by(manifest, cell).SHARDED
    payloads = ranks.run(root, cell.name, SEED, 0.3, False, "cpu",
                         time.perf_counter(), limit=LIMIT)
    assert [p["rank"] for p in payloads] == [0, 1]
    assert payloads[0]["attempted"] == payloads[1]["attempted"] > 0
    whole = as_state(state.initial(fields, SEED, "cpu"))
    lx = fields["grid_size"][0] // 2
    dx = lx * fields["surface_render_resolution"]
    for rank in (0, 1):
        seeded = domain_shard_state(whole, rank, 2, program_config(fields))
        calls = [line.split() for line in
                 (root / f"domain_{rank}").read_text().splitlines()]
        # the start, the window's last step and the call after it, each
        # this rank's slab and its slots
        assert len(calls) == 3
        assert {tuple(c[:4]) for c in calls} == {
            (str(lx), str(lx), str(dx), str(seeded.positions.shape[0]))}
        assert int(calls[0][4]) == int(seeded.active.sum())


def _whole_numbers(out: dict, ref: dict) -> tuple:
    """`check.state_numbers` as it took each field whole."""
    from fluid_bench.reference.step import FIELDS, FLOAT_FIELDS
    gap, mismatch = 0.0, 0
    for k in FIELDS:
        a, b = out[k], ref[k]
        if k in FLOAT_FIELDS:
            a, b = a.float(), b.float()
            fa, fb = torch.isfinite(a), torch.isfinite(b)
            both_nan = torch.isnan(a) & torch.isnan(b)
            same_inf = (~fa) & (~fb) & (a == b)
            mismatch += int(((fa != fb) | ((~fa) & (~fb) & ~both_nan
                                           & ~same_inf)).sum())
            both = fa & fb
            if bool(both.any()):
                scale = float(b[both].abs().max())
                diff = float((a[both] - b[both]).abs().max())
                gap = max(gap, diff / scale if scale > 0 else diff)
        else:
            mismatch += int((a != b).sum())
    return gap, mismatch


@pytest.mark.parametrize("block", [check.BLOCK, 1000, 97])
@pytest.mark.parametrize("case", ["equal", "noisy", "non-finite",
                                  "zero reference", "nothing finite"])
def test_the_state_numbers_are_the_whole_fields(case, block, monkeypatch):
    """The judge's numbers, taken block by block, equal those of whole
    fields bitwise, and leave the states it is given as they were."""
    monkeypatch.setattr(check, "BLOCK", block)
    fields = _fields()
    ref = state.initial(fields, SEED, "cpu")
    g = torch.Generator().manual_seed(7)
    for k in check.ref_step.FLOAT_FIELDS:
        ref[k] = torch.randn(ref[k].shape, generator=g) - 0.25
    out = {k: v.clone() for k, v in ref.items()}
    if case != "equal":
        for k in check.ref_step.FLOAT_FIELDS:
            out[k] += 1e-3 * torch.randn(out[k].shape, generator=g)
    if case == "non-finite":
        for k, v in (("velocity", float("nan")), ("positions", float("inf")),
                     ("float_dens_1", -float("inf"))):
            out[k].view(-1)[::97] = v
            ref[k].view(-1)[::89] = v
        ref["float_dens_2"].view(-1)[::5] = 1e30
    if case == "zero reference":
        ref["float_dens_1"].zero_()
    if case == "nothing finite":
        out["float_dens_2"].fill_(float("nan"))
    before = [{k: v.clone() for k, v in d.items()} for d in (out, ref)]
    got = check.state_numbers(out, ref)
    assert got == _whole_numbers(out, ref)
    for d, kept in zip((out, ref), before):
        for k, v in kept.items():
            torch.testing.assert_close(d[k], v, rtol=0, atol=0,
                                       equal_nan=True)
