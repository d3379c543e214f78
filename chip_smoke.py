#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each (more for the parity and scene phases):
  1 device    the card's name and power limit, as nvidia-smi gives them
  2 build     compile the CUDA kernels from tpu_fluid_torch/csrc
  3 parity    each kernel against its plain PyTorch version on the card, at
              the shapes of the three scenes (K6 at the large one only,
              K6a on the 512^3 detailed occupancy at pool 2), on
              numpy-seeded inputs (K1 from velocity and cell types, with
              its condition masks; K3+K4 returning the moved positions and
              the detailed occupancy, with NaN, infinite, huge and (-1, 0)
              positions among them, and positions NaN on one, two and
              three axes, which move only their NaN coordinates and
              occupy detailed index 0 on those axes), and K1, K2, K3+K4,
              K5, K6a and K6b
              also at two odd non-cubic shapes (5 and 199 sweeps; 0, 1, 4
              and 12 blur passes, u8 and int32 inertia; K6a at pools 1, 2
              and 3); K1 and K3+K4 also on the velocity, types, positions
              and active flags of scaled_scene(256) after 2 steps: every
              output must match bitwise (tolerance 0; a NaN matches a NaN
              in the same place); times by CUDA
              events beside each call's bound (bytes over 3.35 TB/s or f32
              operations over 67 TFLOP/s); and the kernel launches each
              K2, K5 and K6 call makes, read from the C counters: one for
              K2's one-block route (20^3), for K5 up to 8 blur passes (12
              take two) and for each K6 call, one a pass of k >= 2 sweeps
              on K2's blocked route
  4 reference FluidConfig.reference_scene() (20^3, 1M particles), 20 steps,
              invariants; then 3 steps with the kernels and 3 with
              pallas_mode="off" from the same state must agree
  5 bench     FluidConfig.scaled_scene(128) (1M particles), 1 warm-up and
              10 timed steps, invariants, steps/s
  6 launches  every kernel ran during phases 4 and 5
  7 large     FluidConfig.scaled_scene(256) (1M particles, 512^3 detailed
              grid, grid_fused on), 1 warm-up and 5 timed steps,
              invariants, steps/s, and every kernel, K6 included, launched
              in it (K6 also by its C counter: one launch a wrapper call,
              the max-pool taken into K6a), and no plain condition mask or
              occupancy scatter run beside K1 and K3+K4; then 2 steps with
              the kernels
              and 2 with
              pallas_mode="off" (the unfused stage path) must agree
  8 sharded   the x-slab multi-device step (tpu_fluid_torch/parallel/):
              first each halo-form kernel against its plain version,
              bitwise, at the local-slab shapes of scaled_scene(256) split
              4 ways (K1, K2's pass and K6 on (64 + 2h) x 256 x 256 slabs,
              K5 on a 128 x 512 x 512 detailed slab), at shards 0, 1 and 3;
              then scaled_scene(256) on 4 ranks, spawned processes that
              share this one card over a gloo group (halo planes and
              collectives staged through the host), for 2 steps: the
              gathered state must equal 2 single-device steps from the
              same initial state bitwise in every field, hold the
              invariants, and every halo-form kernel must have launched on
              every rank (K6 also by its C counter).  Its steps/s measures
              the host-staged transport, not the port.
  9 domain    domain-sharded particles (particle_sharding="domain",
              tpu_fluid_torch/parallel/particles_domain.py): first K3+K4's
              local-slab form against its plain version, bitwise, on the
              (3, 66, 256, 256) edge-replicated slabs of scaled_scene(256)
              split 4 ways at shards 0, 1 and 3, with the shard's own
              particles, stragglers past both slab ends and both domain
              ends, and inactive slots; then scaled_scene(256) with domain
              sharding on 4 ranks sharing this card over gloo for 2 steps:
              the gathered grid fields must equal 2 single-device steps
              bitwise, the active positions as sorted sets bitwise, with
              nothing dropped, at least one particle migrated, the
              invariants held, no velocity all_gather or occupancy
              psum_scatter run, and the local-slab kernel and every
              halo-form kernel launched on every rank (K6 also by its C
              counter).  It prints steps/s
              and the host-staged transport of each step: the halo planes
              beside the migration exchange.
 10 graph     the CUDA-graph step (tpu_fluid_torch/solver/graph.py) at the
              reference, bench and large scenes, from the state after 2
              eager steps: 3 jit_step replays, one jit_multi_step of 3
              steps, and an eager step from the graph's buffers against
              the eager steps, every field bitwise; every kernel of the
              scene's path captured (the wrappers' counts over the warm-up
              steps and captures); each capture's seconds and graph pool;
              eager, jit_step and jit_multi_step ms a step (medians of 7
              after a warm-up, CUDA events); at the large scene the state
              hand-over, the copy each replay ends with.  Then
              tpu_fluid_torch.bench at 128^3 for 40 steps, whose JSON line
              it prints.
 11 physics   the options beyond the reference at the bench scene's width
              (128^3, 1M particles): (a) volume_correction=1.0 every 4
              steps toward a density of 4.0, (b) surface_method=
              "levelset", (c) pressure_solver="redblack", (d) the
              dam_break_obstacle(128) preset with scene fields (a solid
              sphere and a vortex force).  Each: 5 eager steps with the
              invariants (for (a) K2 called twice on the corrected steps
              0 and 4, once on the others, with the volume solve's
              launches); the same steps with pallas_mode="off" within the
              step tolerances; 3 jit_step replays and a jit_multi_step of
              3 against 3 eager steps, every field bitwise, from the state
              after 2 steps (for (a) from the steps at phases 0 and 1 of
              the cadence); every kernel of the path launched and no other
              (the level set skips K5, the red-black solver K2); eager,
              jit_step and jit_multi_step ms a step (medians of 8, CUDA
              events; for (a) corrected and uncorrected steps apart) and
              each capture's pool.  At (a) K2 on the volume solve's folded
              inputs and K3+K4 on vel + drift against their plain
              versions bitwise, and the correction's parts timed; at (b)
              the plain level set against K5's stage.  Then
              scaled_scene(64) with 250,000 particles on 4 ranks sharing
              the card over gloo for 2 steps: (a)+(b)+(c) with (d)'s scene
              fields under index sharding, and (a) under domain sharding;
              each gathered state bitwise against the single-device steps
              (domain: the active positions as sorted sets).
 12 facade    the engine, checkpoints, meshing, rendering and the CLI
              (tpu_fluid_torch/engine.py, io/, surface/, render/, cli.py):
              Simulation(scaled_scene(128)) on the card runs 10 steps
              with frames, meshes and diagnostics every 5 and a
              checkpoint at 10 (1024^2 frames): the final state must
              equal 10 jit_step replays bitwise, every kernel of the path
              must launch under the run, the PNGs and OBJs must be written
              and non-empty; it prints the run's steps/s including host
              work, surface_mesh, splat and native render_frame ms
              (medians of 5) with the triangle count, and the checkpoint's
              save and load seconds and megabytes; the loaded checkpoint
              must equal the state and step as it bitwise.  Then
              reference_scene() after 5 engine steps: the card's mesh
              against the port's CPU mesh of the same field (count and
              mask bitwise, vertices within 2 ULP, normals within 1e-6)
              and the card's 512^2 splat frame against the CPU's (at
              least 99.9% of the pixels equal).  Then
              `python -m tpu_fluid_torch.cli` for 4 steps with frames,
              meshes and a checkpoint, and its --resume for 2, in
              subprocesses: both must exit 0, the resume at step 4.
The line before the last is a JSON object with the kernels' numbers (times
and bounds at the large scene, the halo forms' and the local-slab form's at
shard 1 of phases 8 and 9, the launches of phases 4-12; library_ms is
null: no single PyTorch call computes any of these functions); the last
line is
{"ok": true, "device": {...}}.  Any
failed check raises, so the script then exits nonzero without that line;
without CUDA it exits 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
REF_STEPS = 20
BENCH_STEPS = 10
COMPARE_STEPS = 3
LARGE_STEPS = 5
LARGE_COMPARE_STEPS = 2
SHARDS = 4
SHARDED_STEPS = 2
# phase 10: eager steps against graph replays, timed steps a median takes,
# the bench's window
GRAPH_STEPS = 3
GRAPH_TIMED = 7
BENCH_WINDOW = 40
PARITY_SHARDS = (0, 1, 3)
ODD_SHAPES = ((13, 22, 17), (37, 45, 29))
RANK_TIMEOUT = 480.0
# f32 tolerances of the kernel path against pallas_mode="off" where the two
# are not bitwise equal (tests/test_full_step_oracle.py)
STEP_TOLERANCES = {"velocity": (2e-4, 2e-5), "positions": (1e-4, 1e-5),
                   "float_dens_1": (1e-4, 1e-5),
                   "float_dens_2": (1e-4, 1e-5)}


# The halo forms of phase 8: source, and the TPU kernel each replaces.
HALO_SOURCES = {
    "advect_all_halo_cuda": (
        "tpu_fluid_torch/csrc/advect.cu",
        "tpu_fluid/kernels/advect.py:321 (advect_all_pallas, halo form, with "
        "the condition masks of tpu_fluid/parallel/spmd_step.py:153 taken "
        "in), "
        "tpu_fluid/kernels/advect.py:244 (advect_one_pallas, halo form "
        "_advect_one_kernel_halo :238, covered), "
        "tpu_fluid/kernels/advect.py:369 (advect_component_pallas, halo "
        "form, covered)"),
    "jacobi_pass_cuda": (
        "tpu_fluid_torch/csrc/jacobi.cu",
        "tpu_fluid/kernels/jacobi.py:367 (jacobi_sweeps_sharded: _one_pass "
        "halo branch :309, _halo_blocks :249)"),
    "surface_fused_halo_cuda": (
        "tpu_fluid_torch/csrc/surface_fused.cu",
        "tpu_fluid/kernels/surface_fused.py:345 (surface_fused_pallas, halo "
        "branch :431), tpu_fluid/kernels/surface_fused.py:438 "
        "(surface_fused_auto y-chunk route, covered)"),
    "classify_extrap_halo_cuda": (
        "tpu_fluid_torch/csrc/grid_fused.cu",
        "tpu_fluid/kernels/grid_fused.py:411 (classify_extrap_pallas, halo "
        "form; pallas_call in _call :340)"),
    "forces_solids_div_halo_cuda": (
        "tpu_fluid_torch/csrc/grid_fused.cu",
        "tpu_fluid/kernels/grid_fused.py:443 (forces_solids_div_pallas, "
        "halo form; pallas_call in _call :340)"),
    "project_halo_cuda": (
        "tpu_fluid_torch/csrc/grid_fused.cu",
        "tpu_fluid/kernels/grid_fused.py:473 (project_pallas, halo form; "
        "pallas_call in _call :340)"),
}
# K3+K4's extreme positions (x, y, z): NaN, infinities, beyond 2^31 once
# scaled, inside (-1, 0), and beside the grid's upper faces.
EXTREME_POSITIONS = (
    (float("nan"), 1.5, 1.5), (1.5, float("nan"), 1.5),
    (1.5, 1.5, float("nan")), (float("inf"), 1.5, 1.5),
    (-float("inf"), 1.5, 1.5), (1.5, float("inf"), -float("inf")),
    (3e9, 1.5, 1.5), (1.5, -3e9, 1.5), (1.5, 1.5, 2.5e9),
    (-0.5, -0.25, -0.999), (-0.999, 1.5, 1.5), (1.5, -1e-7, 1.5),
    (2.0 ** 31, 2.0 ** 32, 1.5), (1e38, -1e38, 1.5))
# The local-slab form of phase 9.
LOCAL_SOURCE = (
    "tpu_fluid_torch/csrc/particle_move.cu",
    "tpu_fluid/kernels/pack_table.py:75, "
    "tpu_fluid/kernels/particle_sample.py:77 (local slab, "
    "tpu_fluid/parallel/particles_domain.py:128)")
STRAGGLERS = 20_000
# +-x force on single water cells at the slab borders (extra_forces): the
# scene alone falls straight down, so no particle would cross a border in
# 2 steps and the migration exchange would carry nothing
BORDER_FORCE = 20000.0


# The bound of a kernel call (kernels' "bound_ms"): the larger of the bytes
# it must move (each tensor argument read once, each output written once;
# of the velocity, K3+K4 reads only the values its particles' taps reach)
# over the H100's 3.35 TB/s and its f32 operations over 67 TFLOP/s (the
# published SXM peaks at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def _pass_ops(args, kw, outs):
    """K2's sharded pass: kk sweeps on the trapezoid of an (lx + 2h)-row
    slab, 7 operations a cell a sweep."""
    q, h, kk = args[0], args[3], args[4]
    plane = q.shape[1] * q.shape[2]
    lx = q.shape[0] - 2 * h
    return 7 * plane * sum(lx + 2 * (kk - s) for s in range(1, kk + 1))


# f32 operations a call needs, counted from each kernel's arithmetic (adds,
# multiplies, divisions, min/max; index and integer work not counted):
# K1 65 a component a cell (face velocity, clamped back-trace, 8 weighted
# taps); K2 7 a cell a sweep (5 adds, a multiply, an add); K3+K4 113 a
# particle (hat weights, 24 weighted taps, the move, the 3 products of the
# occupancy index); K5 4 a cell for the
# signed field and 8 a cell a blur pass; K6a 15, K6b 15 and K6c 9 a cell.
OPS = {
    "advect_all_cuda": lambda a, kw, o: 65 * o[0].numel(),
    "jacobi_sweeps_cuda": lambda a, kw, o: 7 * a[0].numel() * a[3],
    "jacobi_pass_cuda": _pass_ops,
    "particle_move_cuda": lambda a, kw, o: 113 * o[0].shape[0],
    "surface_fused_cuda": lambda a, kw, o: (4 + 8 * kw["steps"])
    * o[1].numel(),
    "classify_extrap_cuda": lambda a, kw, o: 15 * o[0].numel(),
    "forces_solids_div_cuda": lambda a, kw, o: 15 * o[1].numel(),
    "project_cuda": lambda a, kw, o: 3 * o[0].numel(),
}
for _name in ("advect_all", "surface_fused", "classify_extrap",
              "forces_solids_div", "project"):
    OPS[f"{_name}_halo_cuda"] = OPS[f"{_name}_cuda"]
OPS["particle_move_local_cuda"] = lambda a, kw, o: 110 * o[0].shape[0]


def tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(tensor_bytes(o) for o in obj.values())
    return 0


def velocity_tap_bytes(vel: torch.Tensor, pos: torch.Tensor, xb: int,
                       grid_size) -> int:
    """The velocity bytes K3+K4 must read for these particles: the distinct
    values among each particle's 24 taps (8 a component) at the kernel's
    edge-clamped indices, into `vel`'s rows [xb, xb + vel.shape[1]) of a
    grid of `grid_size`.  A non-finite coordinate counts as an edge cell."""
    rows, gy, gz = vel.shape[1:]
    ext, stride = (rows, gy, gz), (gy * gz, gz, 1)
    p = torch.nan_to_num(pos, nan=0.0, posinf=1e9, neginf=-1e9)
    own, oth = [], []
    for d in range(3):
        top = float(grid_size[d] - 1)
        jf = torch.clamp(torch.floor(p[:, d]), 0.0, top)
        base = jf.long()
        if d == 0:
            base = torch.clamp(base - xb, 0, rows - 1)
        o = (torch.floor(torch.clamp(p[:, d] - 0.5, 0.0, top)) - jf).long()
        own.append([torch.clamp(base + k, 0, ext[d] - 1) * stride[d]
                    for k in (0, 1)])
        oth.append([torch.clamp(base + o + k, 0, ext[d] - 1) * stride[d]
                    for k in (0, 1)])
    n = rows * gy * gz
    taps = []
    for c in range(3):
        a1, a2 = (1 if c == 0 else 0), (1 if c == 2 else 2)
        taps += [c * n + own[c][k0] + oth[a1][k1] + oth[a2][k2]
                 for k0 in (0, 1) for k1 in (0, 1) for k2 in (0, 1)]
    return vel.element_size() * torch.unique(torch.cat(taps)).numel()


def _move_bytes(name: str, args, outs) -> int:
    """K3+K4 and its local form: positions and flags read, outputs written,
    and the velocity values the taps reach."""
    vel, pos = args[0], args[1]
    xb, grid = (0, vel.shape[1:]) if name == "particle_move_cuda" else (
        args[4] - 1, args[5])
    return (tensor_bytes(args[1:]) + tensor_bytes(outs)
            + velocity_tap_bytes(vel, pos, xb, grid))


def bound(name: str, args, kw, outs) -> tuple:
    """(bound_ms, "bytes" or "operations") of one call from its inputs and
    outputs."""
    moved = (_move_bytes(name, args, outs) if name.startswith("particle_move")
             else tensor_bytes(args) + tensor_bytes(kw) + tensor_bytes(outs))
    byte_ms = moved / HBM_BYTES_PER_S * 1e3
    op_ms = OPS[name](args, kw, outs) / F32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Over the elements that differ: equal infinities and NaNs in both
    count as no error."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = (a.double() - b.double()).abs()[~same]
    return float(d.max()) if d.numel() else 0.0


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype and elements, a NaN matching a NaN in the same place."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def random_types(rng, n) -> np.ndarray:
    """A plausible cell-type field of n^3 cells (or of shape n): water blob,
    air shell, solid border."""
    from tpu_fluid_torch.core.types import CellType
    shape = (n,) * 3 if isinstance(n, int) else tuple(n)
    water = rng.random(shape) < 0.4
    t = np.where(water, CellType.WATER, CellType.INACTIVE).astype(np.uint8)
    t[0], t[-1], t[:, 0], t[:, -1] = (CellType.SOLID,) * 4
    t[:, :, 0], t[:, :, -1] = (CellType.SOLID,) * 2
    air = (t == CellType.INACTIVE) & (rng.random(shape) < 0.3)
    t[air] = CellType.AIR
    return t


def sparse_occupancy(rng, shape, pool: int) -> np.ndarray:
    """Detailed occupancy at `pool` times `shape`, about a third of the
    pooled cells occupied."""
    dense = 1 - (2 / 3) ** (1 / pool ** 3)
    return (rng.random(tuple(pool * n for n in shape)) < dense
            ).astype(np.uint8)


def grid_fused_cases(t, rng, cfg, shape=None, pools=None):
    """K6 cases at `shape` (the grid of `cfg`), with a solid box and an
    extra force added so that every branch of the kernels runs; the
    fountain and the extra-force cells are WATER so that their forces
    land.  K6a takes the detailed occupancy at each of `pools` (the
    scene's surface render resolution)."""
    from tpu_fluid_torch.kernels.grid_fused import (
        classify_extrap_cuda, classify_extrap_plain, forces_solids_div_cuda,
        forces_solids_div_plain, project_cuda, project_plain)
    shape = tuple(shape or cfg.grid_size)
    pools = pools or (cfg.surface_render_resolution,)
    gx, gy, gz = shape
    box = ((gx // 4, gy // 4, gz // 4), (gx // 2, gy // 3, gz // 2))
    force_cell = (gx // 3, gy // 2, gz // 3)
    if shape != tuple(cfg.grid_size):
        cfg = cfg.replace(grid_size=shape, fountain_position=None)
    cfg = cfg.replace(solid_boxes=(box,),
                      extra_forces=((force_cell, (40.0, 0.0, -25.0)),))
    old = t(rng.integers(0, 4, shape).astype(np.uint8))
    vel = t((rng.standard_normal((3,) + shape) * 3).astype(np.float32))
    types_np = random_types(rng, shape)
    fx, fy, fz = cfg.fountain
    types_np[fx, fy - 1:fy + 1, fz] = 2
    types_np[force_cell] = 2
    types = t(types_np)
    p = t((rng.standard_normal(shape) * 50).astype(np.float32))
    return [(classify_extrap_cuda, classify_extrap_plain,
             (t(sparse_occupancy(rng, shape, pool)), old, vel, cfg),
             {"pool": pool}) for pool in pools] + [
            (forces_solids_div_cuda, forces_solids_div_plain,
             (types, vel, cfg), {}),
            (project_cuda, project_plain, (types, p, vel, cfg), {})]


def kernel_cases(device, scenes):
    """(scene, kernel wrapper, plain version, args, kwargs) per kernel and
    scene, on numpy-seeded inputs at the shapes the main path gives; the
    K6 cases at the scenes whose config turns grid_fused on."""
    from tpu_fluid_torch.kernels.advect import (advect_all_cuda,
                                                advect_from_types_plain)
    from tpu_fluid_torch.kernels.jacobi import (jacobi_sweeps_cuda,
                                                jacobi_sweeps_plain)
    from tpu_fluid_torch.kernels.particle_move import (
        particle_move_cuda, particle_move_occupancy_plain)
    from tpu_fluid_torch.kernels.surface_fused import (surface_fused_cuda,
                                                       surface_fused_plain)
    from tpu_fluid_torch.stages.pressure import jacobi_fold
    from tpu_fluid_torch.stages.surface_fields import solid_parent_mask

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    cases = []
    for scene, cfg in scenes:
        rng = np.random.default_rng(SEED)
        n = cfg.grid_size[0]
        # K1: |v| * dt up to a few cells, so the R clamp is exercised, on a
        # cell field about two thirds of whose faces are advected
        vel = t((rng.standard_normal((3, n, n, n)) * 60).astype(np.float32))
        cases.append((scene, advect_all_cuda, advect_from_types_plain,
                      (vel, t(random_types(rng, n)),
                       cfg.advect_max_displacement, cfg.dt), {}))
        # K2: the folded inputs of a real solve on a plausible cell field
        types = t(random_types(rng, n))
        rhs = t((rng.standard_normal((n, n, n)) * 100).astype(np.float32))
        _, q0, code, c2 = jacobi_fold(types, rhs, cfg, cfg.air_pressure)
        cases.append((scene, jacobi_sweeps_cuda, jacobi_sweeps_plain,
                      (q0, code, c2, cfg.jacobi_iters - 1), {}))
        # K3+K4: positions around and just outside the grid, the extremes
        # first
        p = cfg.particle_count
        pvel = t((rng.standard_normal((3, n, n, n)) * 5).astype(np.float32))
        pos = rng.random((p, 3)) * (n + 2) - 1
        act = rng.random(p) < 0.9
        pos[:len(EXTREME_POSITIONS)] = EXTREME_POSITIONS
        act[:len(EXTREME_POSITIONS)] = True
        cases.append((scene, particle_move_cuda,
                      particle_move_occupancy_plain,
                      (pvel, t(pos.astype(np.float32)), t(act), cfg.dt,
                       cfg.surface_render_resolution), {}))
        # K5: detailed grid, solid-parent skip mask from a random cell field
        dsize = cfg.detailed_size
        occ = t((rng.random(dsize) < 0.3).astype(np.uint8))
        inertia = t(rng.integers(0, cfg.max_inertia + 1, dsize
                                 ).astype(np.uint8))
        f2 = t(rng.standard_normal(dsize).astype(np.float32))
        skip = solid_parent_mask(
            t(rng.integers(0, 4, cfg.grid_size).astype(np.uint8)), cfg
        ).to(torch.uint8)
        kw = dict(steps=cfg.float_density_diffuse_steps,
                  k=cfg.float_density_diffuse_coefficient,
                  inc_filled=cfg.inertia_increase_filled,
                  inc_neigh=cfg.inertia_increase_neighbour,
                  required_hits=cfg.inertia_required_neighbour_hits,
                  dec=cfg.inertia_decrease, max_inertia=cfg.max_inertia,
                  div_coef=cfg.float_density_division_coefficient)
        cases.append((scene, surface_fused_cuda, surface_fused_plain,
                      (occ, inertia, f2, skip), kw))
        if cfg.grid_fused:
            cases += [(scene,) + case
                      for case in grid_fused_cases(t, rng, cfg)]
    return cases


def scene_cases(device, cfg, steps: int = 2):
    """K1 and K3+K4 on the fields of `cfg`'s scene after `steps` steps:
    its velocity and cell types, its positions and active flags."""
    from tpu_fluid_torch import initial_state
    from tpu_fluid_torch.kernels.advect import (advect_all_cuda,
                                                advect_from_types_plain)
    from tpu_fluid_torch.kernels.particle_move import (
        particle_move_cuda, particle_move_occupancy_plain)
    state = run_steps(initial_state(cfg, device), cfg, steps)
    return [(advect_all_cuda, advect_from_types_plain,
             (state.velocity, state.cell_types, cfg.advect_max_displacement,
              cfg.dt), {}),
            (particle_move_cuda, particle_move_occupancy_plain,
             (state.velocity, state.positions, state.active, cfg.dt,
              cfg.surface_render_resolution), {})]


def nan_axes(device) -> None:
    """K3+K4 against its plain version on positions that are NaN on one,
    two and three axes: both move only the NaN coordinates, to NaN, and
    write the occupancy at detailed index 0 on the NaN axes, as the JAX
    package does on the CPU (XLA converts a NaN to 0); bitwise, a NaN
    matching a NaN."""
    from tpu_fluid_torch.kernels.particle_move import (
        particle_move_cuda, particle_move_occupancy_plain)
    rng = np.random.default_rng(SEED)
    vel = torch.from_numpy((rng.standard_normal((3, 8, 8, 8)) * 5).astype(
        np.float32)).to(device)
    nan = float("nan")
    pos = torch.tensor([[nan, 1.3, 2.6], [2.2, nan, 3.1], [4.4, 5.5, nan],
                        [nan, nan, 6.2], [nan, nan, nan], [3.3, 3.3, 3.3]],
                       device=device)
    act = torch.ones(len(pos), dtype=torch.bool, device=device)
    (want, want_occ), (got, got_occ) = (f(vel, pos, act, 0.01, 2) for f in (
        particle_move_occupancy_plain, particle_move_cuda))
    torch.cuda.synchronize()
    cells = ((0, 2, 5), (4, 0, 6), (8, 11, 0), (0, 0, 12), (0, 0, 0))
    written = [bool(got_occ[c]) for c in cells]
    print(f"[3 parity] NaN on one, two and three axes: moved positions "
          f"bitwise={same_bits(got, want)}, NaN where the input's="
          f"{torch.equal(torch.isnan(got), torch.isnan(pos))}, occupancy "
          f"bitwise={torch.equal(got_occ, want_occ)}, index-0 cells "
          f"written {written}", flush=True)
    check(same_bits(got, want) and torch.equal(got_occ, want_occ),
          "K3+K4 differs from its plain version on NaN positions")
    check(torch.equal(torch.isnan(got), torch.isnan(pos)),
          "a NaN coordinate moved another coordinate to NaN")
    check(all(written), "a NaN position's occupancy is not at index 0")


def non_finite_velocity(vel: np.ndarray, rng, device,
                        n: int = 12) -> torch.Tensor:
    """A copy of `vel` (3, X, Y, Z) with n scattered NaNs and infinities of
    both signs, one NaN on a corner (an edge-clamped value) and a +inf
    beside a -inf (a face average of inf - inf), on the card."""
    out = vel.copy()
    values = (np.nan, np.inf, -np.inf)
    for k in range(n):
        at = tuple(int(rng.integers(0, m)) for m in out.shape)
        out[at] = values[k % 3]
    out[1, 0, -1, 0] = np.nan
    mid = tuple(m // 2 for m in out.shape[1:])
    out[(0,) + mid] = np.inf
    out[(2,) + mid] = -np.inf
    out[2, mid[0], mid[1], mid[2] - 1] = np.inf
    return torch.from_numpy(out).to(device)


def odd_cases(device):
    """K1, K3+K4, K2, K5, K6a and K6b at odd non-cubic shapes: K2 on its
    one-block route (13, 22, 17) and its blocked route (37, 45, 29), 5
    sweeps (a remainder pass) and 199; K5 with 0, 1 and 4 blur passes, and
    int32 inertia, and with 12 (a second launch of blur passes only); K6a
    at pools 1, 2 and 3 (several y and z tiles at (37, 45, 29)); K1 at R =
    1, 2 and 3, on finite velocities and with NaNs and infinities."""
    from tpu_fluid_torch import FluidConfig
    from tpu_fluid_torch.kernels.advect import (advect_all_cuda,
                                                advect_from_types_plain)
    from tpu_fluid_torch.kernels.jacobi import (jacobi_sweeps_cuda,
                                                jacobi_sweeps_plain)
    from tpu_fluid_torch.kernels.particle_move import (
        particle_move_cuda, particle_move_occupancy_plain)
    from tpu_fluid_torch.kernels.surface_fused import (surface_fused_cuda,
                                                       surface_fused_plain)
    from tpu_fluid_torch.stages.pressure import jacobi_fold

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    cfg = FluidConfig()
    cases = []
    for shape in ODD_SHAPES:
        rng = np.random.default_rng(SEED + 20)
        types = np.where(rng.random(shape) < 0.4, 2, 1).astype(np.uint8)
        types[0], types[-1], types[:, 0], types[:, -1] = (3,) * 4
        types[:, :, 0], types[:, :, -1] = 3, 3
        rhs = (rng.standard_normal(shape) * 100).astype(np.float32)
        _, q0, code, c2 = jacobi_fold(t(types), t(rhs), cfg,
                                      cfg.air_pressure)
        for n in (5, 199):
            cases.append((f"{shape} n={n}", jacobi_sweeps_cuda,
                          jacobi_sweeps_plain, (q0, code, c2, n), {}))
        for steps, dtype, top in ((0, np.uint8, 100), (1, np.uint8, 100),
                                  (4, np.uint8, 100), (4, np.int32, 300),
                                  (12, np.uint8, 100)):
            kw = dict(steps=steps, k=cfg.float_density_diffuse_coefficient,
                      inc_filled=cfg.inertia_increase_filled,
                      inc_neigh=cfg.inertia_increase_neighbour,
                      required_hits=cfg.inertia_required_neighbour_hits,
                      dec=cfg.inertia_decrease, max_inertia=top,
                      div_coef=cfg.float_density_division_coefficient)
            fields = (t((rng.random(shape) < 0.3).astype(np.uint8)),
                      t(rng.integers(0, top + 1, shape).astype(dtype)),
                      t(rng.standard_normal(shape).astype(np.float32)),
                      t((rng.random(shape) < 0.2).astype(np.uint8)))
            cases.append((f"{shape} steps={steps} {np.dtype(dtype).name}",
                          surface_fused_cuda, surface_fused_plain, fields,
                          kw))
        for kernel, plain, args, kw in grid_fused_cases(
                t, rng, cfg, shape, pools=(1, 2, 3)):
            if kernel.__name__ != "project_cuda":
                cases.append((f"{shape} {kw}", kernel, plain, args, kw))
        vel_np = (rng.standard_normal((3,) + shape) * 60).astype(np.float32)
        vel, types = t(vel_np), t(random_types(rng, shape))
        for r in (1, 2, 3):
            cases.append((f"{shape} R={r}", advect_all_cuda,
                          advect_from_types_plain, (vel, types, r, 0.01), {}))
        bad = non_finite_velocity(vel_np, rng, device)
        for r in (1, 2, 3):
            cases.append((f"{shape} R={r} non-finite", advect_all_cuda,
                          advect_from_types_plain, (bad, types, r, 0.01), {}))
        pos = rng.random((20_000, 3)) * (np.array(shape) + 2) - 1
        pos[:len(EXTREME_POSITIONS)] = EXTREME_POSITIONS
        act = rng.random(len(pos)) < 0.9
        cases.append((f"{shape} res=3", particle_move_cuda,
                      particle_move_occupancy_plain,
                      (vel, t(pos.astype(np.float32)), t(act), 0.01, 3), {}))
    return cases


def expected_device_launches(kernel, args, kw) -> tuple:
    """(C launches one call of K2, K5 or K6 must make, the route) from the
    wrapper's plan."""
    from tpu_fluid_torch.kernels import build, tiling
    sms = build.sm_count(args[0].device.index)
    if kernel.__module__.endswith("grid_fused"):
        return 1, "one pass"
    if kernel.__name__ == "jacobi_sweeps_cuda":
        plan = tiling.jacobi_plan(args[0].shape, args[3], sms=sms)
        return (1 if plan.route == "whole" else len(plan.passes)), \
            f"{plan.route} k={max((p.levels for p in plan.passes), default=0)}"
    if kernel.__name__ == "jacobi_pass_cuda":
        plan = tiling.jacobi_plan(args[0].shape, args[4], halo=args[3],
                                  sms=sms)
        return len(plan.passes), f"pass k={args[4]}"
    steps = kw["steps"]
    h = steps + 1 if "halos" in kw else 0
    plan = tiling.surface_plan((args[0].shape[0] + 2 * h,) + args[0].shape[1:],
                               steps, halo=h, sms=sms)
    return len(plan), f"steps={steps}"


def device_launch_counter(kernel):
    """The C launch counter behind K2's, K5's and K6's wrappers, else
    None."""
    from tpu_fluid_torch.kernels import grid_fused, jacobi, surface_fused
    name = kernel.__name__
    if name.startswith("jacobi_"):
        return jacobi.device_launches
    if name.startswith("surface_fused"):
        return surface_fused.device_launches
    if kernel.__module__ == grid_fused.__name__:
        return grid_fused.device_launches
    return None


def run_case(label: str, kernel, plain, args, kw, reps: int) -> dict:
    """Hold one kernel call against its plain version bitwise; time both;
    compute the bound; for K2, K5 and K6, count the launches the call
    made."""
    name = kernel.__name__
    counter = device_launch_counter(kernel)
    before = counter() if counter else None
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    launched = counter() - before if counter else None
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    bitwise = all(same_bits(a, b) for a, b in zip(got, want))
    ms = time_ms(lambda: kernel(*args, **kw), reps=reps)
    plain_ms = time_ms(lambda: plain(*args, **kw), reps=3, warmup=1)
    bound_ms, bound_by = bound(name, args, kw, got)
    extra = ""
    if counter:
        want_n, route = expected_device_launches(kernel, args, kw)
        extra = f" launches={launched} ({route})"
        check(launched == want_n, f"{name} {label}: {launched} kernel "
                                  f"launches, the plan has {want_n}")
    print(f"[{label}] {name} shapes={[tuple(a.shape) for a in got]} "
          f"max_abs_err={err!r} bitwise={bitwise} (tolerance 0) "
          f"kernel_ms={ms!r} plain_ms={plain_ms!r} bound_ms={bound_ms!r} "
          f"({bound_by}) share={bound_ms / ms!r}{extra}", flush=True)
    check(bitwise, f"{name} {label} differs from its plain version (max "
                   f"abs err {err!r})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "launches": launched}


def phase_parity(device, scenes) -> dict:
    from tpu_fluid_torch.kernels.jacobi import jacobi_sweeps_cuda
    from tpu_fluid_torch.kernels.surface_fused import surface_fused_cuda
    results = {}
    for scene, kernel, plain, args, kw in kernel_cases(device, scenes):
        name = kernel.__name__
        r = run_case(f"3 parity {scene}", kernel, plain, args, kw, 20)
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], r["max_abs_err"])
        entry[scene] = r
    scene, cfg = scenes[-1]
    for kernel, plain, args, kw in scene_cases(device, cfg):
        r = run_case(f"3 parity {scene} scene after 2 steps", kernel, plain,
                     args, kw, 20)
        entry = results[kernel.__name__]
        entry["max_abs_err"] = max(entry["max_abs_err"], r["max_abs_err"])
        entry[f"{scene} scene"] = r
    torch.cuda.empty_cache()
    nan_axes(device)
    k2 = results["jacobi_sweeps_cuda"]
    check(k2["reference"]["launches"] == 1,
          "the one-block route did not solve 20^3 in one launch")
    check(all(199 / k2[s]["launches"] >= 2 for s in ("bench", "large")),
          "the blocked route ran fewer than 2 sweeps a launch")
    check(all(results["surface_fused_cuda"][s]["launches"] == 1
              for s, _ in scenes), "K5 took more than one launch")
    for label, kernel, plain, args, kw in odd_cases(device):
        r = run_case(f"3 parity odd {label}", kernel, plain, args, kw, 10)
        entry = results[kernel.__name__]
        entry["max_abs_err"] = max(entry["max_abs_err"], r["max_abs_err"])
    check(jacobi_sweeps_cuda.launches > 0 and surface_fused_cuda.launches > 0,
          "K2 or K5 never launched in phase 3")
    return results


def active_positions(state) -> torch.Tensor:
    return state.positions[state.active]


def check_invariants(state, cfg, ymax0: float, label: str) -> float:
    from tpu_fluid_torch.core.types import CellType
    n_active = int(state.active.sum())
    check(n_active == cfg.particle_count,
          f"{label}: {n_active} active particles, expected "
          f"{cfg.particle_count}")
    pos = active_positions(state)
    check(bool(torch.isfinite(state.positions).all())
          and bool(torch.isfinite(state.velocity).all()),
          f"{label}: non-finite positions or velocities")
    top = torch.tensor(cfg.grid_size, dtype=pos.dtype, device=pos.device)
    check(bool((pos >= 0).all()) and bool((pos <= top).all()),
          f"{label}: particles left the box")
    types = state.cell_types
    counts = {name: int((types == code).sum()) for name, code in
              (("water", CellType.WATER), ("air", CellType.AIR),
               ("solid", CellType.SOLID))}
    check(all(v > 0 for v in counts.values()),
          f"{label}: empty cell class {counts}")
    imin, imax = int(state.inertia.min()), int(state.inertia.max())
    check(0 <= imin and imax <= cfg.max_inertia,
          f"{label}: inertia outside [0, {cfg.max_inertia}]")
    ymax = float(pos[:, 1].max())
    check(ymax > ymax0, f"{label}: the blob did not fall (+y is down): "
                        f"max y {ymax0!r} -> {ymax!r}")
    print(f"[{label}] invariants ok: active={n_active} cells={counts} "
          f"inertia=[{imin}, {imax}] max_y {ymax0!r} -> {ymax!r}",
          flush=True)
    return ymax


def run_steps(state, cfg, n: int, scene=None):
    from tpu_fluid_torch import step
    for _ in range(n):
        state = step(state, cfg, scene)
    return state


def compare_states(a, b, label: str) -> None:
    """Integer fields equal; f32 fields equal or within STEP_TOLERANCES."""
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype.is_floating_point:
            err = max_abs_err(x, y)
            rtol, atol = STEP_TOLERANCES[name]
            ok = bool(torch.allclose(x, y, rtol=rtol, atol=atol))
            print(f"[{label}] {name}: bitwise={torch.equal(x, y)} "
                  f"max_abs_err={err!r} (rtol {rtol}, atol {atol})",
                  flush=True)
            check(ok, f"{label}: {name} outside tolerance ({err!r})")
        else:
            check(torch.equal(x, y), f"{label}: {name} differs")


def reset_launches(wrappers) -> None:
    for w in wrappers:
        w.launches = 0


def read_launches(wrappers) -> dict:
    return {w.__name__: w.launches for w in wrappers}


class PlainPasses:
    """Counts the calls of the plain passes that K1 (the condition masks)
    and K3+K4 (the occupancy scatter) took in, from construction until
    `take`, which puts the functions back."""

    def __init__(self):
        from tpu_fluid_torch.kernels import advect
        from tpu_fluid_torch.stages import particles, velocity
        self.calls = {"advect_conditions": 0, "detailed_occupancy": 0}
        self.saved = []
        for module, name in ((advect, "advect_conditions"),
                             (velocity, "advect_conditions"),
                             (particles, "detailed_occupancy")):
            fn = getattr(module, name)
            self.saved.append((module, name, fn))
            setattr(module, name, self._counted(fn, name))

    def _counted(self, fn, name):
        def counted(*args, **kw):
            self.calls[name] += 1
            return fn(*args, **kw)
        return counted

    def take(self) -> dict:
        for module, name, fn in self.saved:
            setattr(module, name, fn)
        return dict(self.calls)


# ------------------------------------------------------------ 8: sharded
def split_rows(ext: torch.Tensor, h: int):
    """An extended slab (h planes a side on dim ndim-3) -> (local, (left,
    right))."""
    ax = ext.ndim - 3
    lx = ext.shape[ax] - 2 * h
    return (ext.narrow(ax, h, lx).contiguous(),
            (ext.narrow(ax, 0, h).contiguous(),
             ext.narrow(ax, lx + h, h).contiguous()))


def type_rows(rng, lo: int, n: int, cfg) -> np.ndarray:
    """Cell types of the global rows [lo, lo + n): water, air, the solid
    border at global positions, INACTIVE (zero) past the domain."""
    from tpu_fluid_torch.core.types import CellType
    gx, gy, gz = cfg.grid_size
    t = np.where(rng.random((n, gy, gz)) < 0.4, CellType.WATER,
                 CellType.INACTIVE).astype(np.uint8)
    t[(t == CellType.INACTIVE) & (rng.random(t.shape) < 0.3)] = CellType.AIR
    x = np.arange(lo, lo + n)
    t[(x == 0) | (x == gx - 1)] = CellType.SOLID
    t[:, 0], t[:, -1], t[:, :, 0], t[:, :, -1] = (CellType.SOLID,) * 4
    t[(x < 0) | (x >= gx)] = CellType.INACTIVE
    return t


def halo_cases(device, cfg):
    """(wrapper, plain, args, kwargs, shard) for each halo-form kernel at
    the local-slab shapes of `cfg` split SHARDS ways, at PARITY_SHARDS, on
    numpy-seeded slabs whose halo planes past the domain are zero."""
    from tpu_fluid_torch.kernels import grid_fused as k6
    from tpu_fluid_torch.kernels.advect import (advect_all_halo_cuda,
                                                advect_from_types_halo_plain)
    from tpu_fluid_torch.kernels.jacobi import (SHARDED_K, fold_c2e,
                                                jacobi_pass_cuda,
                                                jacobi_pass_plain)
    from tpu_fluid_torch.kernels.surface_fused import (
        surface_fused_halo_cuda, surface_fused_halo_plain)
    from tpu_fluid_torch.stages.pressure import jacobi_fold
    from tpu_fluid_torch.stages.surface_fields import solid_parent_mask

    gx, gy, gz = cfg.grid_size
    lx = gx // SHARDS
    r = cfg.advect_max_displacement
    res = cfg.surface_render_resolution
    dsize = cfg.detailed_size
    h5 = cfg.float_density_diffuse_steps + 1
    box = ((gx // 4, gy // 4, gz // 4), (gx // 2, gy // 3, gz // 2))
    force_cell = (gx // 3, gy // 2, gz // 3)
    fcfg = cfg.replace(solid_boxes=(box,),
                       extra_forces=((force_cell, (40.0, 0.0, -25.0)),))
    kw5 = dict(steps=cfg.float_density_diffuse_steps,
               k=cfg.float_density_diffuse_coefficient,
               inc_filled=cfg.inertia_increase_filled,
               inc_neigh=cfg.inertia_increase_neighbour,
               required_hits=cfg.inertia_required_neighbour_hits,
               dec=cfg.inertia_decrease, max_inertia=cfg.max_inertia,
               div_coef=cfg.float_density_division_coefficient)
    cases = []
    for shard in PARITY_SHARDS:
        x0 = shard * lx
        rng = np.random.default_rng(SEED + shard)

        def rows(h, shape, make, dtype, lo_of=lambda h: x0 - h, extent=gx):
            """Global rows [x0 - h, x0 + lx + h) of a field, zero past the
            domain, on the card."""
            lo = lo_of(h)
            a = make((shape[0] + 2 * h,) + tuple(shape[1:])).astype(dtype)
            x = np.arange(lo, lo + a.shape[0])
            a[(x < 0) | (x >= extent)] = 0
            return torch.from_numpy(a).to(device)

        def vel_rows(h, scale):
            v = rng.standard_normal((3, lx + 2 * h, gy, gz)) * scale
            x = np.arange(x0 - h, x0 + lx + h)
            v[:, (x < 0) | (x >= gx)] = 0
            return torch.from_numpy(v.astype(np.float32)).to(device)

        def types_rows(h):
            return torch.from_numpy(type_rows(rng, x0 - h, lx + 2 * h,
                                              cfg)).to(device)

        # K1: |v| * dt up to a few cells, so the R clamp is exercised; the
        # types with one neighbour plane a side
        vel, vel_h = split_rows(vel_rows(r, 60), r)
        cases.append((advect_all_halo_cuda, advect_from_types_halo_plain,
                      (vel, types_rows(1), r, cfg.dt, vel_h, x0,
                       cfg.grid_size), {}, shard))
        # K2: one pass of SHARDED_K sweeps on the folded inputs of a real
        # solve on the slab extended by SHARDED_K planes a side
        k = SHARDED_K
        rhs = torch.from_numpy((rng.standard_normal((lx + 2 * k, gy, gz))
                                * 100).astype(np.float32)).to(device)
        _, q0, code, c2 = jacobi_fold(types_rows(k), rhs, cfg,
                                      cfg.air_pressure)
        ext = [q0, code, fold_c2e(q0, code, c2)]
        x = torch.arange(x0 - k, x0 + lx + k, device=device)
        outside = ((x < 0) | (x >= gx)).reshape(-1, 1, 1)
        ext = [torch.where(outside, torch.zeros_like(a), a) for a in ext]
        cases.append((jacobi_pass_cuda, jacobi_pass_plain,
                      tuple(ext) + (k, k), {}, shard))
        # K6, with the fountain and the force cell wet where they lie here
        occ, occ_h = split_rows(rows(2, (lx, gy, gz), lambda s: (
            rng.random(s) < 0.35), np.uint8), 2)
        old, old_h = split_rows(rows(2, (lx, gy, gz), lambda s: (
            rng.integers(0, 4, s)), np.uint8), 2)
        vel2, vel2_h = split_rows(vel_rows(2, 3), 2)
        cases.append((k6.classify_extrap_halo_cuda,
                      k6.classify_extrap_halo_plain, (occ, old, vel2, fcfg),
                      dict(halos=(occ_h, old_h, vel2_h), x0=x0,
                           global_gx=gx), shard))
        t_ext = types_rows(1)
        for cell in (cfg.fountain, force_cell):
            if x0 <= cell[0] < x0 + lx:
                t_ext[cell[0] - x0 + 1, cell[1] - 1:cell[1] + 1,
                      cell[2]] = 2
        types, types_h = split_rows(t_ext, 1)
        vel1, vel1_h = split_rows(vel_rows(1, 3), 1)
        p, p_h = split_rows(rows(1, (lx, gy, gz), lambda s: (
            rng.standard_normal(s) * 50), np.float32), 1)
        cases.append((k6.forces_solids_div_halo_cuda,
                      k6.forces_solids_div_halo_plain, (types, vel1, fcfg),
                      dict(halos=(types_h, vel1_h), x0=x0, global_gx=gx),
                      shard))
        cases.append((k6.project_halo_cuda, k6.project_halo_plain,
                      (types, p, vel1, fcfg),
                      dict(halos=(types_h, p_h, vel1_h), x0=x0,
                           global_gx=gx), shard))
        # K5 on the detailed slab, h = steps + 1 planes a side
        dlx = dsize[0] // SHARDS
        dshape = (dlx,) + tuple(dsize[1:])
        dlo = lambda h: shard * dlx - h                       # noqa: E731
        sim_lo = (shard * dlx - h5) // res
        sim_types = torch.from_numpy(type_rows(
            rng, sim_lo, -(-(dlx + 2 * h5) // res) + 1, cfg)).to(device)
        off = shard * dlx - h5 - sim_lo * res
        skip = solid_parent_mask(sim_types, cfg)[off:off + dlx + 2 * h5]
        fields = [
            rows(h5, dshape, lambda s: rng.random(s) < 0.3, np.uint8, dlo,
                 dsize[0]),
            rows(h5, dshape, lambda s: rng.integers(0, cfg.max_inertia + 1,
                                                    s), np.uint8, dlo,
                 dsize[0]),
            rows(h5, dshape, lambda s: rng.standard_normal(s), np.float32,
                 dlo, dsize[0]),
            skip.to(torch.uint8)]
        parts = [split_rows(a, h5) for a in fields]
        cases.append((surface_fused_halo_cuda, surface_fused_halo_plain,
                      tuple(a for a, _ in parts),
                      dict(halos=tuple(hh for _, hh in parts),
                           x0=shard * dlx, global_gx=dsize[0], **kw5),
                      shard))
    return cases


def phase_halo_parity(device, cfg) -> dict:
    results = {}
    for kernel, plain, args, kw, shard in halo_cases(device, cfg):
        name = kernel.__name__
        r = run_case(f"8 parity shard {shard}/{SHARDS}", kernel, plain, args,
                     kw, 10)
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], r["max_abs_err"])
        entry[shard] = r
    return results


def halo_wrappers():
    from tpu_fluid_torch.kernels import grid_fused as k6
    from tpu_fluid_torch.kernels.advect import advect_all_halo_cuda
    from tpu_fluid_torch.kernels.jacobi import jacobi_pass_cuda
    from tpu_fluid_torch.kernels.particle_move import particle_move_cuda
    from tpu_fluid_torch.kernels.surface_fused import surface_fused_halo_cuda
    return (advect_all_halo_cuda, jacobi_pass_cuda, surface_fused_halo_cuda,
            k6.classify_extrap_halo_cuda, k6.forces_solids_div_halo_cuda,
            k6.project_halo_cuda, particle_move_cuda)


def sharded_rank(rank, n, init_method, cfg, device):
    """One rank of phase 8: SHARDED_STEPS steps of its slab; rank 0 also
    runs the single-device steps and compares the gathered state.  All
    ranks share `device`."""
    import torch.distributed as dist
    from tpu_fluid_torch import initial_state
    from tpu_fluid_torch.kernels import build
    from tpu_fluid_torch.parallel.mesh import (gather_state, make_mesh,
                                               shard_state)
    from tpu_fluid_torch.parallel.spmd_step import spmd_multi_step
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        build.library()
        sync = torch.cuda.synchronize
    else:
        torch.set_num_threads(1)
        sync = lambda: None                                # noqa: E731
    mesh = make_mesh(n, rank, init_method, device=device, backend="gloo")
    state0 = initial_state(cfg, device)
    ymax0 = float(active_positions(state0)[:, 1].max())
    local = shard_state(state0, rank, n)
    if rank != 0:
        del state0
    wrappers = halo_wrappers()
    run = spmd_multi_step(cfg, mesh, SHARDED_STEPS)
    reset_launches(wrappers)
    k6_before = k6_device_launches(device)
    dist.barrier()
    sync()
    t0 = time.perf_counter()
    local = run(local)
    sync()
    dist.barrier()
    seconds = time.perf_counter() - t0
    launches = read_launches(wrappers)
    full = gather_state(local, mesh)
    out = {"launches": launches, "seconds": seconds,
           "k6_device": k6_device_launches(device) - k6_before}
    if rank == 0:
        check_invariants(full, cfg, ymax0, "8 sharded")
        ref = run_steps(state0, cfg, SHARDED_STEPS)
        sync()
        fields = {}
        for name in ref._fields:
            a, b = getattr(full, name), getattr(ref, name)
            same = a.dtype == b.dtype and a.shape == b.shape and \
                torch.equal(a, b)
            err = (max_abs_err(a, b) if a.dtype.is_floating_point
                   and a.shape == b.shape else None)
            fields[name] = (same, err)
        out["fields"] = fields
    return out


def k6_device_launches(device) -> int:
    """K6's C launch counter (0 off the card)."""
    from tpu_fluid_torch.kernels import grid_fused
    return grid_fused.device_launches() if device.type == "cuda" else 0


def check_k6_device(label: str, counted: int, launches: dict) -> None:
    """One C launch of K6 for each K6 wrapper call."""
    calls = sum(n for name, n in launches.items()
                if name.startswith(("classify_extrap", "forces_solids_div",
                                    "project")))
    check(counted == calls, f"{label}: K6's C counter says {counted} "
                            f"launches for {calls} wrapper calls")


def phase_sharded(cfg, card: str, device) -> dict:
    from tpu_fluid_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(sharded_rank, SHARDS, cfg, str(device),
                      timeout=RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    fields = ranks[0]["fields"]
    for name, (same, err) in fields.items():
        print(f"[8 sharded] {name}: bitwise={same} max_abs_err={err!r} "
              f"(tolerance 0)", flush=True)
    check(all(same for same, _ in fields.values()),
          f"{SHARDED_STEPS} sharded steps differ from {SHARDED_STEPS} "
          f"single-device steps: {fields}")
    seconds = max(r["seconds"] for r in ranks)
    print(f"[8 sharded] {SHARDS} ranks sharing one card over gloo "
          f"(host-staged transport, not a figure for the port): "
          f"{SHARDED_STEPS / seconds!r} steps/s at grid {cfg.grid_size} on "
          f"{card}; phase wall {wall!r} s, rank start-up included",
          flush=True)
    launches = {}
    for rank, r in enumerate(ranks):
        print(f"[8 launches] rank {rank}: {r['launches']}, K6 C counter "
              f"{r['k6_device']}", flush=True)
        check(all(v > 0 for v in r["launches"].values()),
              f"rank {rank}: a kernel of the sharded path never launched: "
              f"{r['launches']}")
        check_k6_device(f"8 rank {rank}", r["k6_device"], r["launches"])
        for name, count in r["launches"].items():
            launches[name] = launches.get(name, 0) + count
    return launches


# ------------------------------------------------------------- 9: domain
GRID_FIELDS = ("velocity", "cell_types", "inertia", "float_dens_1",
               "float_dens_2", "detailed_occ", "step")


def domain_scene(cfg):
    """`cfg` with domain-sharded particles and a force cell pushing across
    each of the SHARDS - 1 slab borders: -x at the first row of slab 1 and
    of the middle slab, +x at the last row of the slabs before the middle
    and the last border, inside the falling blob."""
    n = cfg.grid_size[0]
    y, z = int(0.4 * cfg.grid_size[1]), cfg.grid_size[2] // 8
    f = BORDER_FORCE
    forces = (((n // 4, y, z), (-f, 0.0, 0.0)),
              ((n // 2 - 1, y, z), (f, 0.0, 0.0)),
              ((n // 2, y + 2, z), (-f, 0.0, 0.0)),
              ((3 * n // 4 - 1, y, z), (f, 0.0, 0.0)))
    return cfg.replace(particle_sharding="domain", extra_forces=forces)


def local_move_cases(device, cfg, state0):
    """(shard, args) of K3+K4's local-slab form at the slabs of `cfg` split
    SHARDS ways, at PARITY_SHARDS: a numpy-seeded velocity slab with one
    edge-replicated plane a side; the shard's segment of
    `domain_shard_state(state0)` (its own particles, then inactive slots);
    and STRAGGLERS seeded particles, half within 3 rows past either slab
    end and half up to 1.5 cells past either domain end in x, over the box
    and 1.5 cells past it in y and z, a tenth of them inactive."""
    from tpu_fluid_torch.parallel.particles_domain import domain_shard_state
    gx, gy, gz = cfg.grid_size
    lx = gx // SHARDS
    cases = []
    for shard in PARITY_SHARDS:
        x0 = shard * lx
        rng = np.random.default_rng(SEED + 10 + shard)
        v = rng.standard_normal((3, lx + 2, gy, gz), dtype=np.float32) * 5
        if shard == 0:
            v[:, 0] = v[:, 1]
        if shard == SHARDS - 1:
            v[:, -1] = v[:, -2]
        seg = domain_shard_state(state0, shard, SHARDS, cfg)
        k = STRAGGLERS
        s = rng.random((k, 3)) * (np.array(cfg.grid_size) + 3.0) - 1.5
        low = rng.random(k) < 0.5
        near = np.where(low, x0 - 3 * rng.random(k),
                        x0 + lx + 3 * rng.random(k))
        past = np.where(low, -1.5 * rng.random(k), gx + 1.5 * rng.random(k))
        s[:, 0] = np.where(np.arange(k) % 2 == 0, near, past)
        pos = torch.cat([seg.positions,
                         torch.from_numpy(s.astype(np.float32)).to(device)])
        act = torch.cat([seg.active,
                         torch.from_numpy(rng.random(k) < 0.9).to(device)])
        cases.append((shard, (torch.from_numpy(v).to(device), pos, act,
                              cfg.dt, x0, cfg.grid_size)))
    return cases


def phase_local_parity(device, cfg, state0) -> dict:
    from tpu_fluid_torch.kernels.particle_move import (
        particle_move_local_cuda, particle_move_local_plain)
    results = {"max_abs_err": 0.0}
    for shard, args in local_move_cases(device, cfg, state0):
        r = run_case(f"9 parity shard {shard}/{SHARDS} vel_e="
                     f"{tuple(args[0].shape)} particles={args[1].shape[0]} "
                     f"(active {int(args[2].sum())})",
                     particle_move_local_cuda, particle_move_local_plain,
                     args, {}, 20)
        results["max_abs_err"] = max(results["max_abs_err"],
                                     r["max_abs_err"])
        results[shard] = r
    return results


class Transport:
    """Calls and host-clock seconds of the exchanges of a rank's step: each
    wrapped call runs between two device synchronizations, so that its time
    holds its own staging and waiting and no kernel queued before it."""

    def __init__(self, sync):
        self.sync = sync
        self.calls, self.seconds = {}, {}

    def wrap(self, module, name: str, label: str) -> None:
        fn = getattr(module, name)
        self.calls[label], self.seconds[label] = 0, 0.0

        def timed(*args, **kw):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.sync()
            self.calls[label] += 1
            self.seconds[label] += time.perf_counter() - t0
            return out
        setattr(module, name, timed)

    def take(self) -> dict:
        out = {label: (self.calls[label], self.seconds[label])
               for label in self.calls}
        for label in self.calls:
            self.calls[label], self.seconds[label] = 0, 0.0
        return out


def sorted_rows(pos: torch.Tensor) -> np.ndarray:
    p = pos.cpu().numpy()
    return p[np.lexsort((p[:, 2], p[:, 1], p[:, 0]))]


def domain_rank(rank, n, init_method, cfg, device):
    """One rank of phase 9: SHARDED_STEPS domain-sharded steps of its slab
    and its particles, each timed with its exchanges; rank 0 also runs the
    single-device steps and compares the gathered state.  All ranks share
    `device`."""
    import torch.distributed as dist
    from tpu_fluid_torch import initial_state
    from tpu_fluid_torch.kernels import build
    from tpu_fluid_torch.kernels.particle_move import particle_move_local_cuda
    from tpu_fluid_torch.parallel import halo, particles_domain
    from tpu_fluid_torch.parallel import spmd_step as spmd_module
    from tpu_fluid_torch.parallel.mesh import gather_state, make_mesh
    device = torch.device(device)
    torch.cuda.set_device(device)
    build.library()
    sync = torch.cuda.synchronize
    mesh = make_mesh(n, rank, init_method, device=device, backend="gloo")
    state0 = initial_state(cfg, device)
    ymax0 = float(active_positions(state0)[:, 1].max())
    local = particles_domain.domain_shard_state(state0, rank, n, cfg)
    if rank != 0:
        del state0
    slots = local.positions.shape[0]
    transport = Transport(sync)
    transport.wrap(halo, "ppermute_neighbours", "halo planes")
    transport.wrap(particles_domain, "ppermute_neighbours", "migration")
    transport.wrap(spmd_module, "psum", "drop psum")
    for name in ("all_gather_x", "psum_scatter_x"):
        transport.wrap(spmd_module, name, name)
    crossers = []
    migrate = spmd_module.migrate

    def counted_migrate(pos, active, x0, lx, m, mesh):
        cx = torch.floor(pos[:, 0])
        crossers.append(int((active & ((cx < x0) | (cx >= x0 + lx))).sum()))
        return migrate(pos, active, x0, lx, m, mesh)

    spmd_module.migrate = counted_migrate
    # the halo forms of phase 8, and the local-slab form in place of the
    # index path's particle_move_cuda
    wrappers = halo_wrappers()[:-1] + (particle_move_local_cuda,)
    step = spmd_module.spmd_step(cfg, mesh)
    reset_launches(wrappers)
    k6_before = k6_device_launches(device)
    dist.barrier()
    sync()
    steps = []
    for _ in range(SHARDED_STEPS):
        t0 = time.perf_counter()
        local = step(local)
        sync()
        steps.append((time.perf_counter() - t0, transport.take()))
    dist.barrier()
    launches = read_launches(wrappers)
    full = gather_state(local, mesh)
    out = {"launches": launches, "steps": steps, "crossers": crossers,
           "slots": slots,
           "k6_device": k6_device_launches(device) - k6_before,
           "capacity": particles_domain.migrate_capacity(slots, cfg)}
    if rank == 0:
        check_invariants(full, cfg, ymax0, "9 domain")
        ref = run_steps(state0, cfg, SHARDED_STEPS)
        sync()
        fields = {}
        for name in GRID_FIELDS:
            a, b = getattr(full, name), getattr(ref, name)
            same = a.dtype == b.dtype and a.shape == b.shape and \
                torch.equal(a, b)
            err = (max_abs_err(a, b) if a.dtype.is_floating_point
                   and a.shape == b.shape else None)
            fields[name] = (same, err)
        a = sorted_rows(active_positions(full))
        b = sorted_rows(active_positions(ref))
        fields["active positions, sorted"] = (
            a.shape == b.shape and np.array_equal(a, b),
            float(np.abs(a - b).max()) if a.shape == b.shape else None)
        out["fields"] = fields
        out["dropped"] = int(full.dropped)
    return out


def phase_domain(cfg, card: str, device) -> dict:
    from tpu_fluid_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(domain_rank, SHARDS, cfg, str(device),
                      timeout=RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    fields = ranks[0]["fields"]
    for name, (same, err) in fields.items():
        print(f"[9 domain] {name}: bitwise={same} max_abs_err={err!r} "
              f"(tolerance 0)", flush=True)
    check(all(same for same, _ in fields.values()),
          f"{SHARDED_STEPS} domain-sharded steps differ from "
          f"{SHARDED_STEPS} single-device steps: {fields}")
    check(ranks[0]["dropped"] == 0,
          f"domain sharding dropped {ranks[0]['dropped']} particles")
    crossers = [sum(r["crossers"][i] for r in ranks)
                for i in range(SHARDED_STEPS)]
    print(f"[9 domain] {ranks[0]['slots']} slots a rank, migration buffers "
          f"of {ranks[0]['capacity']} rows a direction; slab-border "
          f"crossers migrated a step: {crossers}", flush=True)
    check(sum(crossers) > 0, "no particle crossed a slab border: the "
                             "migration exchange moved nothing")
    seconds = sum(max(r["steps"][i][0] for r in ranks)
                  for i in range(SHARDED_STEPS))
    print(f"[9 domain] {SHARDS} ranks sharing one card over gloo "
          f"(host-staged transport, not a figure for the port): "
          f"{SHARDED_STEPS / seconds!r} steps/s at grid {cfg.grid_size} on "
          f"{card}; phase wall {wall!r} s, rank start-up included",
          flush=True)
    for i in range(SHARDED_STEPS):
        for rank, r in enumerate(ranks):
            step_s, split = r["steps"][i]
            check(split["all_gather_x"][0] == 0
                  and split["psum_scatter_x"][0] == 0,
                  f"rank {rank}: a volume collective ran in the domain "
                  f"step: {split}")
            parts = "; ".join(f"{label} {calls} calls {s!r} s"
                              for label, (calls, s) in split.items())
            rest = step_s - sum(s for _, s in split.values())
            print(f"[9 transport] step {i + 1} rank {rank}: {step_s!r} s; "
                  f"{parts}; the rest {rest!r} s", flush=True)
    launches = {}
    for rank, r in enumerate(ranks):
        print(f"[9 launches] rank {rank}: {r['launches']}, K6 C counter "
              f"{r['k6_device']}", flush=True)
        check(all(v > 0 for v in r["launches"].values()),
              f"rank {rank}: a kernel of the domain path never launched: "
              f"{r['launches']}")
        check_k6_device(f"9 rank {rank}", r["k6_device"], r["launches"])
        for name, count in r["launches"].items():
            launches[name] = launches.get(name, 0) + count
    return launches


def clone_state(state):
    return type(state)(*(t.clone() for t in state))


def step_ms(fn, state, reps: int) -> tuple:
    """(ms of each of `reps` calls state = fn(state), each between two CUDA
    events and synchronized, after one untimed call; the last state)."""
    state = fn(state)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(reps):
        start.record()
        state = fn(state)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times, state


def graph_scene(device, scene: str, cfg, wrappers, card: str) -> dict:
    """Phase 10 at one scene: from the state after 2 eager steps,
    GRAPH_STEPS eager steps against GRAPH_STEPS `jit_step` replays and
    against one `jit_multi_step(state, cfg, GRAPH_STEPS)`, then an eager
    step from the graph's buffers, every field bitwise; the kernel
    wrappers' counts over the captures; eager and graphed step times."""
    from statistics import median

    from tpu_fluid_torch import initial_state, jit_multi_step, jit_step, step
    from tpu_fluid_torch.solver import graph
    state0 = run_steps(initial_state(cfg, device), cfg, 2)
    torch.cuda.synchronize()
    first = len(graph.captures)
    reset_launches(wrappers)
    s = state0
    for _ in range(GRAPH_STEPS):
        s = jit_step(s, cfg)
    replayed = clone_state(s)
    multi = clone_state(jit_multi_step(state0, cfg, GRAPH_STEPS))
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    eager = run_steps(state0, cfg, GRAPH_STEPS)
    after, eager_after = step(s, cfg), step(eager, cfg)
    torch.cuda.synchronize()
    for label, got, want in (("jit_step", replayed, eager),
                             ("jit_multi_step", multi, eager),
                             ("eager step after replays", after,
                              eager_after)):
        same = {f: same_bits(g, w) for f, g, w in zip(want._fields, got,
                                                      want)}
        print(f"[10 graph {scene}] {label} against {GRAPH_STEPS} eager "
              f"steps{' + 1' if 'after' in label else ''}: bitwise "
              f"{all(same.values())} {same}", flush=True)
        check(all(same.values()), f"10 graph {scene}: {label} differs "
                                  f"from the eager step: {same}")
    for cap in graph.captures[first:]:
        print(f"[10 graph {scene}] capture of {cap['n_steps']} step(s): "
              f"warm-up step {cap['warmup_s']!r} s, capture "
              f"{cap['capture_s']!r} s, graph pool "
              f"{cap['pool_bytes'] / 2 ** 20!r} MiB", flush=True)
    print(f"[10 graph {scene}] wrapper launches in the warm-up steps and "
          f"captures: {launches}", flush=True)
    check(all(v > 0 for v in launches.values()),
          f"10 graph {scene}: a kernel of the path was not captured: "
          f"{launches}")
    del replayed, multi, after, eager_after, eager
    eager_times, _ = step_ms(lambda x: step(x, cfg), state0, GRAPH_TIMED)
    graph_times, _ = step_ms(lambda x: jit_step(x, cfg), state0,
                             GRAPH_TIMED)
    multi_times, _ = step_ms(lambda x: jit_multi_step(x, cfg, GRAPH_STEPS),
                             state0, GRAPH_TIMED)
    result = {"launches": launches, "eager_ms": median(eager_times),
              "graph_ms": median(graph_times),
              "multi_ms": median(multi_times) / GRAPH_STEPS}
    print(f"[10 graph {scene}] ms a step, median of {GRAPH_TIMED} after a "
          f"warm-up (CUDA events): eager {result['eager_ms']!r} "
          f"({1000 / result['eager_ms']!r} steps/s), jit_step "
          f"{result['graph_ms']!r} ({1000 / result['graph_ms']!r} steps/s), "
          f"jit_multi_step({GRAPH_STEPS}) {result['multi_ms']!r} "
          f"({1000 / result['multi_ms']!r} steps/s); each eager "
          f"{eager_times!r}, each jit_step {graph_times!r} on {card}",
          flush=True)
    if scene == "large":
        # the hand-over: the copy of the whole state the graph ends with
        dst = clone_state(state0)
        size = sum(t.numel() * t.element_size() for t in state0)
        result["handover_ms"] = time_ms(lambda: graph._load(dst, state0),
                                        reps=GRAPH_TIMED)
        print(f"[10 graph {scene}] state hand-over, a copy of "
              f"{size / 1e9!r} GB read and written once a replay: "
              f"{result['handover_ms']!r} ms (mean of {GRAPH_TIMED}, CUDA "
              f"events), {2 * size / result['handover_ms'] / 1e6!r} GB/s",
              flush=True)
        del dst
    del state0, s
    graph.clear_graphs()
    torch.cuda.empty_cache()
    return result


def phase_graph(device, scenes, wrappers, fused_wrappers, card: str,
                smi: str) -> dict:
    """Phase 10: the CUDA-graph step at each scene (`graph_scene`), then
    the port's bench (`tpu_fluid_torch.bench`) for a short window at
    128^3, whose JSON line it prints; returns the wrappers' counts over
    the captures."""
    from tpu_fluid_torch import bench
    launches = {}
    for scene, cfg in scenes:
        paths = wrappers + (fused_wrappers if cfg.grid_fused else ())
        counted = graph_scene(device, scene, cfg, paths, card)["launches"]
        for name, count in counted.items():
            launches[name] = launches.get(name, 0) + count
    _, sps, chunks = bench._run_once(128, 1_000_000, BENCH_WINDOW, 5)
    print(f"[10 graph bench] tpu_fluid_torch.bench at 128^3, {BENCH_WINDOW} "
          f"steps, per-chunk steps/s {chunks!r}", flush=True)
    print(json.dumps(bench.result_line(128, 1_000_000, sps, smi)),
          flush=True)
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ 11: physics
# the four options beyond the reference, at the bench scene's width
PHYSICS_STEPS = 5
PHYSICS_EVERY = 4
PHYSICS_TIMED = 8
VOLUME = dict(volume_correction=1.0, volume_correction_every=PHYSICS_EVERY,
              volume_target_density=4.0)
PHYSICS_SHARDED_GRID = 64
PHYSICS_SHARDED_PARTICLES = 250_000
# the kernels each configuration's single-device path must launch and
# must not: the level set skips K5, the red-black solver K2
PHYSICS_SKIPS = {"levelset": ("surface_fused_cuda",),
                 "redblack": ("jacobi_sweeps_cuda",)}


def physics_configs(bench_cfg):
    """(name, config, with scene fields) of (a)-(d) at the bench scene's
    grid: (a) volume correction every PHYSICS_EVERY steps toward a density
    off the initial one, so that the drift is not zero; (b) the level
    set; (c) the red-black solver; (d) the dam-break preset with a pillar,
    plus scene fields."""
    from tpu_fluid_torch import scenes
    n = bench_cfg.grid_size[0]
    return (("volume", bench_cfg.replace(**VOLUME), False),
            ("levelset", bench_cfg.replace(surface_method="levelset"), False),
            ("redblack", bench_cfg.replace(pressure_solver="redblack"),
             False),
            ("scene", scenes.dam_break_obstacle(
                n, particle_count=bench_cfg.particle_count), True))


def physics_scene(cfg, device):
    """Scene fields on `cfg`'s grid: a solid sphere near the floor (+y is
    down) where no particle starts, and a vortex force about the y axis
    through the domain's centre."""
    from tpu_fluid_torch import SceneFields, solid_sphere, vortex_force
    n = cfg.grid_size[0]
    return SceneFields(
        solid_sphere(cfg, (0.75 * n, 0.8 * n, 0.3 * n), n / 12,
                     device=device),
        vortex_force(cfg, (n / 2, n / 2), n / 2, device=device))


def graphed_ms(fn, reps: int = 10) -> float:
    """Device milliseconds a call of fn(): `reps` calls captured in one
    CUDA graph after a warm-up call on a side stream, one replay between
    CUDA events, so no host dispatch is counted."""
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fn()
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_calls(fn, state, reps: int, n_steps: int,
                warmup: int = 1) -> tuple:
    """([(step number at the call, ms)] of `reps` calls state = fn(state),
    each between two CUDA events and synchronized, after `warmup` untimed
    calls; the last state).  The step is read once, before the first timed
    call."""
    for _ in range(warmup):
        state = fn(state)
    torch.cuda.synchronize()
    at = int(state.step)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    calls = []
    for _ in range(reps):
        start.record()
        state = fn(state)
        end.record()
        end.synchronize()
        calls.append((at, start.elapsed_time(end)))
        at += n_steps
    return calls, state


def physics_parity(device, cfg, state, label: str) -> dict:
    """(a)'s kernels on their own inputs at this state: K2 on the volume
    solve's folded inputs (boundary 0, volume_jacobi_iters sweeps) and
    K3+K4 on the corrected move velocity, each bitwise against its plain
    version; then the corrected step's parts timed apart: the histogram,
    the volume potential (fold and K2), the drift."""
    from tpu_fluid_torch.kernels.jacobi import (jacobi_sweeps_cuda,
                                                jacobi_sweeps_plain)
    from tpu_fluid_torch.kernels.particle_move import (
        particle_move_cuda, particle_move_occupancy_plain)
    from tpu_fluid_torch.ops.scatter import particle_cell_histogram
    from tpu_fluid_torch.stages import volume
    from tpu_fluid_torch.stages.pressure import jacobi_fold
    types = state.cell_types
    counts = particle_cell_histogram(state.positions, state.active,
                                     cfg.grid_size)
    _, q0, code, c2 = jacobi_fold(
        types, volume.density_error(counts, types, cfg), cfg, 0.0)
    k2 = run_case(f"{label} volume solve", jacobi_sweeps_cuda,
                  jacobi_sweeps_plain, (q0, code, c2, cfg.volume_jacobi_iters),
                  {}, 20)
    move_vel = volume.corrected_move_velocity(
        state.velocity, state.positions, state.active, types, cfg)
    k34 = run_case(f"{label} vel + drift", particle_move_cuda,
                   particle_move_occupancy_plain,
                   (move_vel, state.positions, state.active, cfg.dt,
                    cfg.surface_render_resolution), {}, 20)
    parts = {
        "histogram": graphed_ms(lambda: particle_cell_histogram(
            state.positions, state.active, cfg.grid_size)),
        "volume_potential": graphed_ms(lambda: volume.volume_potential(
            counts, types, cfg)),
        "density_drift": graphed_ms(lambda: volume.density_drift(
            counts, types, cfg)),
        "corrected_move_velocity": graphed_ms(
            lambda: volume.corrected_move_velocity(
                state.velocity, state.positions, state.active, types, cfg))}
    print(f"[{label}] the correction's parts, device ms a call (10 calls "
          f"in one CUDA graph): {parts}; K2 alone on the volume solve "
          f"{k2['ms']!r}", flush=True)
    return {"k2": k2, "k34": k34, "parts": parts}


def levelset_parts(device, cfg, state, label: str) -> dict:
    """(b)'s plain level set against K5's surface stage on the same types
    and occupancy, ms a call."""
    from tpu_fluid_torch.stages import surface_fields
    from tpu_fluid_torch.surface.levelset import (chamfer_distance,
                                                  levelset_field)
    inertia_cfg = cfg.replace(surface_method="inertia")
    types, occ = state.cell_types, state.detailed_occ
    parts = {
        "chamfer_distance": graphed_ms(lambda: chamfer_distance(
            occ, cfg.levelset_sweeps_value), reps=3),
        "levelset_field": graphed_ms(lambda: levelset_field(types, occ, cfg),
                                     reps=3),
        "K5 stage (update_surface_fields)": graphed_ms(
            lambda: surface_fields.update_surface_fields(
                types, occ, state.inertia, state.float_dens_2,
                inertia_cfg))}
    print(f"[{label}] the level set against K5's stage at detailed grid "
          f"{cfg.detailed_size}, {cfg.levelset_sweeps_value} chamfer sweeps "
          f"and {cfg.levelset_smooth} smoothing passes, device ms a call "
          f"(calls in one CUDA graph): {parts}", flush=True)
    return parts


def physics_case(device, name, cfg, with_scene, wrappers, card) -> dict:
    """Phase 11 at one configuration: PHYSICS_STEPS eager steps from the
    initial state (invariants; for (a) K2's calls a step, two on the
    corrected steps 0 and 4), the same steps with pallas_mode="off",
    jit_step and jit_multi_step against the eager steps bitwise (from the
    state after 2 steps, and for (a) from the states at phases 0 and 1 of
    the cadence), the kernels launched, and eager and graphed ms a step."""
    from statistics import median

    from tpu_fluid_torch import initial_state, jit_multi_step, jit_step, step
    from tpu_fluid_torch.kernels import jacobi
    from tpu_fluid_torch.kernels.jacobi import jacobi_sweeps_cuda
    from tpu_fluid_torch.solver import graph
    label = f"11 physics {name}"
    scene = physics_scene(cfg, device) if with_scene else None
    state = initial_state(cfg, device)
    init = clone_state(state)
    ymax0 = float(active_positions(state)[:, 1].max())
    reset_launches(wrappers)
    states, k2_calls, k2_device = [], [], []
    for _ in range(PHYSICS_STEPS):
        calls, dev = jacobi_sweeps_cuda.launches, jacobi.device_launches()
        state = step(state, cfg, scene)
        torch.cuda.synchronize()
        k2_calls.append(jacobi_sweeps_cuda.launches - calls)
        k2_device.append(jacobi.device_launches() - dev)
        states.append(state)
    launches = read_launches(wrappers)
    check_invariants(state, cfg, ymax0, label)
    print(f"[{label}] wrapper launches in {PHYSICS_STEPS} eager steps: "
          f"{launches}; K2 calls a step {k2_calls}, K2 kernel launches a "
          f"step {k2_device}", flush=True)
    skips = PHYSICS_SKIPS.get(name, ())
    check(all((v == 0) == (k in skips) for k, v in launches.items()),
          f"{label}: the path's kernels {launches}, expected none of "
          f"{skips} and all others")
    if name == "volume":
        due = [k % PHYSICS_EVERY == 0 for k in range(PHYSICS_STEPS)]
        check(k2_calls == [2 if d else 1 for d in due],
              f"{label}: K2 calls a step {k2_calls}, the cadence corrects "
              f"steps {[k for k, d in enumerate(due) if d]}")
        check(all(k2_device[k] > k2_device[1] for k in range(PHYSICS_STEPS)
                  if due[k]), f"{label}: no volume-solve launches of K2 "
                              f"on a corrected step: {k2_device}")
    plain = run_steps(init, cfg.replace(pallas_mode="off"),
                            PHYSICS_STEPS, scene)
    compare_states(state, plain, f"{label} kernels vs off")
    del plain, init

    starts = ((3, 4) if name == "volume" else (1,))
    reset_launches(wrappers)
    first = len(graph.captures)
    for i in starts:
        s0 = states[i]
        at = int(s0.step)
        want = run_steps(s0, cfg, GRAPH_STEPS, scene)
        s = s0
        for _ in range(GRAPH_STEPS):
            s = jit_step(s, cfg, scene)
        multi = jit_multi_step(s0, cfg, GRAPH_STEPS, scene)
        torch.cuda.synchronize()
        for what, got in (("jit_step", s), ("jit_multi_step", multi)):
            same = {f: same_bits(g, w) for f, g, w in zip(want._fields, got,
                                                          want)}
            print(f"[{label}] {what} from step {at} (phase "
                  f"{at % PHYSICS_EVERY if name == 'volume' else '-'}) "
                  f"against {GRAPH_STEPS} eager steps: bitwise "
                  f"{all(same.values())} {same}", flush=True)
            check(all(same.values()), f"{label}: {what} from step {at} "
                                      f"differs from the eager steps")
        del want, s, multi
    graph_launches = read_launches(wrappers)
    check(all((v == 0) == (k in skips) for k, v in graph_launches.items()),
          f"{label}: the kernels captured {graph_launches}")
    for cap in graph.captures[first:]:
        print(f"[{label}] capture of {cap['n_steps']} step(s), phase "
              f"{cap['phase']}: warm-up step {cap['warmup_s']!r} s, capture "
              f"{cap['capture_s']!r} s, graph pool "
              f"{cap['pool_bytes'] / 2 ** 20!r} MiB", flush=True)
    pools = [cap["pool_bytes"] for cap in graph.captures[first:]]

    s0 = states[1]
    del states
    # every graph of the cadence captured before the timed calls
    warm = PHYSICS_EVERY if name == "volume" else 1
    eager_calls, _ = timed_calls(lambda x: step(x, cfg, scene), s0,
                                 PHYSICS_TIMED, 1)
    graph_calls, _ = timed_calls(lambda x: jit_step(x, cfg, scene), s0,
                                 PHYSICS_TIMED, 1, warm)
    multi_calls, _ = timed_calls(
        lambda x: jit_multi_step(x, cfg, GRAPH_STEPS, scene), s0,
        PHYSICS_TIMED, GRAPH_STEPS, warm)
    result = {"launches": launches, "graph_launches": graph_launches,
              "k2_device": k2_device, "pool_bytes": pools,
              "eager_ms": median(ms for _, ms in eager_calls),
              "graph_ms": median(ms for _, ms in graph_calls),
              "multi_ms": median(ms for _, ms in multi_calls) / GRAPH_STEPS}
    extra = ""
    if name == "volume":
        for key, calls in (("eager", eager_calls), ("graph", graph_calls)):
            for tag, want in (("corrected", True), ("uncorrected", False)):
                ms = [t for at, t in calls
                      if (at % PHYSICS_EVERY == 0) == want]
                result[f"{key}_{tag}_ms"] = median(ms)
        extra = (f"; corrected / uncorrected steps: eager "
                 f"{result['eager_corrected_ms']!r} / "
                 f"{result['eager_uncorrected_ms']!r}, jit_step "
                 f"{result['graph_corrected_ms']!r} / "
                 f"{result['graph_uncorrected_ms']!r}")
    print(f"[{label}] ms a step, medians of {PHYSICS_TIMED} after a "
          f"warm-up (CUDA events): eager {result['eager_ms']!r}, jit_step "
          f"{result['graph_ms']!r}, jit_multi_step({GRAPH_STEPS}) "
          f"{result['multi_ms']!r}{extra}; each eager {eager_calls!r}, each "
          f"jit_step {graph_calls!r} on {card}", flush=True)
    if name == "volume":
        result.update(physics_parity(device, cfg, s0, label))
    if name == "levelset":
        result["levelset_parts"] = levelset_parts(device, cfg, s0, label)
    del s0
    graph.clear_graphs()
    torch.cuda.empty_cache()
    return result


def physics_rank(rank, n, init_method, cfg, with_scene, device):
    """One rank of phase 11's sharded runs: SHARDED_STEPS steps of its
    slabs (and of its scene's); rank 0 also runs the single-device steps
    and compares the gathered state (under domain sharding the active
    positions as sorted sets).  All ranks share `device`."""
    import torch.distributed as dist
    from tpu_fluid_torch import initial_state
    from tpu_fluid_torch.kernels import build
    from tpu_fluid_torch.kernels.particle_move import particle_move_local_cuda
    from tpu_fluid_torch.parallel import particles_domain
    from tpu_fluid_torch.parallel.mesh import (gather_state, make_mesh,
                                               shard_scene, shard_state)
    from tpu_fluid_torch.parallel.spmd_step import spmd_multi_step
    device = torch.device(device)
    torch.cuda.set_device(device)
    build.library()
    mesh = make_mesh(n, rank, init_method, device=device, backend="gloo")
    state0 = initial_state(cfg, device)
    ymax0 = float(active_positions(state0)[:, 1].max())
    scene = physics_scene(cfg, device) if with_scene else None
    domain = cfg.particle_sharding == "domain"
    local = (particles_domain.domain_shard_state(state0, rank, n, cfg)
             if domain else shard_state(state0, rank, n))
    if rank != 0:
        del state0
    wrappers = halo_wrappers() + (particle_move_local_cuda,)
    run = spmd_multi_step(cfg, mesh, SHARDED_STEPS,
                          shard_scene(scene, rank, n))
    reset_launches(wrappers)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    local = run(local)
    torch.cuda.synchronize()
    dist.barrier()
    out = {"seconds": time.perf_counter() - t0,
           "launches": read_launches(wrappers)}
    full = gather_state(local, mesh)
    if rank == 0:
        check_invariants(full, cfg, ymax0, "11 physics sharded")
        ref = run_steps(state0, cfg, SHARDED_STEPS, scene)
        torch.cuda.synchronize()
        names = GRID_FIELDS if domain else ref._fields
        fields = {}
        for name in names:
            a, b = getattr(full, name), getattr(ref, name)
            err = (max_abs_err(a, b) if a.dtype.is_floating_point
                   and a.shape == b.shape else None)
            fields[name] = (same_bits(a, b), err)
        if domain:
            a = sorted_rows(active_positions(full))
            b = sorted_rows(active_positions(ref))
            fields["active positions, sorted"] = (
                a.shape == b.shape and np.array_equal(a, b),
                float(np.abs(a - b).max()) if a.shape == b.shape else None)
            fields["dropped"] = (int(full.dropped) == 0, None)
        out["fields"] = fields
    return out


def phase_physics_sharded(label: str, cfg, with_scene, expect, card,
                          device) -> dict:
    """Phase 11's sharded run of `cfg` on SHARDS ranks sharing the card:
    the gathered state against the single-device steps bitwise, and the
    kernels of `expect` launched on every rank."""
    from tpu_fluid_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(physics_rank, SHARDS, cfg, with_scene, str(device),
                      timeout=RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    fields = ranks[0]["fields"]
    for name, (same, err) in fields.items():
        print(f"[{label}] {name}: bitwise={same} max_abs_err={err!r} "
              f"(tolerance 0)", flush=True)
    check(all(same for same, _ in fields.values()),
          f"{label}: {SHARDED_STEPS} sharded steps differ from "
          f"{SHARDED_STEPS} single-device steps: {fields}")
    seconds = max(r["seconds"] for r in ranks)
    print(f"[{label}] {SHARDS} ranks sharing one card over gloo "
          f"(host-staged transport, not a figure for the port): "
          f"{SHARDED_STEPS / seconds!r} steps/s at grid {cfg.grid_size} on "
          f"{card}; phase wall {wall!r} s, rank start-up included",
          flush=True)
    launches = {}
    for rank, r in enumerate(ranks):
        print(f"[{label}] rank {rank} launches: {r['launches']}", flush=True)
        check(all(r["launches"][k] > 0 for k in expect),
              f"{label} rank {rank}: a kernel of {expect} never launched: "
              f"{r['launches']}")
        for name, count in r["launches"].items():
            launches[name] = launches.get(name, 0) + count
    return launches


def phase_physics(device, bench_cfg, wrappers, card) -> dict:
    """Phase 11: (a)-(d) at the bench scene's width (`physics_case`),
    then the sharded runs at PHYSICS_SHARDED_GRID^3 with
    PHYSICS_SHARDED_PARTICLES particles: (a)+(b)+(c) with (d)'s scene
    fields under index sharding, and (a) under domain sharding.  Returns
    the launches a wrapper made, by wrapper name."""
    from tpu_fluid_torch import FluidConfig
    results = {}
    launches = {}
    for name, cfg, with_scene in physics_configs(bench_cfg):
        r = physics_case(device, name, cfg, with_scene, wrappers, card)
        results[name] = r
        for counted in (r["launches"], r["graph_launches"]):
            for k, v in counted.items():
                launches[k] = launches.get(k, 0) + v
    small = FluidConfig.scaled_scene(
        PHYSICS_SHARDED_GRID, particle_count=PHYSICS_SHARDED_PARTICLES)
    together = small.replace(surface_method="levelset",
                             pressure_solver="redblack", **VOLUME)
    for key, count in phase_physics_sharded(
            "11 physics sharded index (a)+(b)+(c)+(d)", together, True,
            ("advect_all_halo_cuda", "particle_move_cuda"), card,
            device).items():
        launches[key] = launches.get(key, 0) + count
    for key, count in phase_physics_sharded(
            "11 physics sharded domain (a)",
            small.replace(particle_sharding="domain", **VOLUME), False,
            ("advect_all_halo_cuda", "jacobi_pass_cuda",
             "surface_fused_halo_cuda", "particle_move_local_cuda"), card,
            device).items():
        launches[key] = launches.get(key, 0) + count
    results["launches"] = launches
    return results


# ------------------------------------------------------------- 12: facade
# Simulation.run at the bench scene, and the card's mesh and frame against
# the CPU's at the reference scene
FACADE_STEPS = 10
FACADE_EVERY = 5
FACADE_SIZE = 1024
FACADE_COMPARE_SIZE = 512
FACADE_TIMED = 5
CHECKPOINT_TIMED = 3
FACADE_REF_STEPS = 5
# the CPU mesh against the card's: vertices in ULP, normals absolute
MESH_ULP = 2
MESH_NORMAL_ATOL = 1e-6
FRAME_SHARE = 0.999
CLI_TIMEOUT = 300


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in f32 units of the last place, a NaN
    matching a NaN."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    return int(torch.where(same, 0, d).max()) if d.numel() else 0


def median_ms(fn, reps: int, events: bool) -> tuple:
    """(median ms of `reps` calls after one untimed call, the last
    result): by CUDA events around each call where the work is on the
    card, else by the host's clock (the call returns host data)."""
    from statistics import median
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if events:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return median(times), out


def run_cli(args, cwd: str) -> str:
    """`python -m tpu_fluid_torch.cli` in a subprocess; raise unless it
    exits 0; its standard output."""
    proc = subprocess.run([sys.executable, "-m", "tpu_fluid_torch.cli",
                           *args], cwd=cwd, capture_output=True, text=True,
                          timeout=CLI_TIMEOUT)
    check(proc.returncode == 0, f"12 facade: the CLI {args} exited "
                                f"{proc.returncode}:\n{proc.stdout}\n"
                                f"{proc.stderr}")
    return proc.stdout


def facade_bench(device, cfg, wrappers, card: str, out: str) -> dict:
    """Simulation.run at `cfg` through every cadence, against FACADE_STEPS
    jit_step replays; timings of the facade's parts; the checkpoint read
    back and stepped."""
    import os

    from tpu_fluid_torch import Simulation, initial_state, jit_step
    from tpu_fluid_torch.io.checkpoint import (load_checkpoint,
                                               save_checkpoint)
    from tpu_fluid_torch.solver import graph
    graph.clear_graphs()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    sim = Simulation(cfg)
    check(sim.state.velocity.device == device,
          f"12 facade: Simulation(cfg) put the state on "
          f"{sim.state.velocity.device}")
    sim.run(FACADE_STEPS, frame_every=FACADE_EVERY, mesh_every=FACADE_EVERY,
            log_every=FACADE_EVERY, checkpoint_every=FACADE_STEPS,
            width=FACADE_SIZE, height=FACADE_SIZE, frame_dir=out,
            checkpoint_path=os.path.join(out, "checkpoint.npz"))
    sim.sync()
    run_s = time.perf_counter() - t0
    launches = read_launches(wrappers)
    print(f"[12 facade bench] Simulation(scaled_scene(128)).run("
          f"{FACADE_STEPS}, frame/mesh/log every {FACADE_EVERY}, checkpoint "
          f"every {FACADE_STEPS}, {FACADE_SIZE}^2): {run_s!r} s, "
          f"{FACADE_STEPS / run_s!r} steps/s including host work (the "
          f"state's set-up, the graph's capture, frames, meshes, the "
          f"checkpoint) on {card}; wrapper launches {launches}", flush=True)
    check(all(v > 0 for v in launches.values()),
          f"12 facade: a kernel of the path did not launch under "
          f"Simulation.run: {launches}")
    final = clone_state(sim.state)
    # the graph's own buffers are sim.state: clone before replaying it
    s = initial_state(cfg, device)
    for _ in range(FACADE_STEPS):
        s = jit_step(s, cfg)
    same = {f: same_bits(a, b) for f, a, b in zip(final._fields, final, s)}
    print(f"[12 facade bench] run against {FACADE_STEPS} jit_step replays: "
          f"bitwise {all(same.values())} {same}", flush=True)
    check(all(same.values()), f"12 facade: the run differs from the "
                              f"replays: {same}")
    names = [f"frame_{k:06d}.png" for k in (5, 10)] + \
        [f"mesh_{k:06d}.obj" for k in (5, 10)] + ["checkpoint.npz"]
    sizes = {n: os.path.getsize(os.path.join(out, n))
             if os.path.exists(os.path.join(out, n)) else 0 for n in names}
    print(f"[12 facade bench] files (bytes): {sizes}", flush=True)
    check(all(v > 0 for v in sizes.values()),
          f"12 facade: a file is missing or empty: {sizes}")

    sim.state = final
    mesh_ms, mesh = median_ms(sim.surface_mesh, FACADE_TIMED, True)
    splat_ms, img = median_ms(
        lambda: sim.render_frame(FACADE_SIZE, FACADE_SIZE), FACADE_TIMED,
        True)
    native_ms, nimg = median_ms(
        lambda: sim.render_frame(FACADE_SIZE, FACADE_SIZE, method="native"),
        FACADE_TIMED, False)
    triangles = int(mesh.count)
    check(triangles > 0 and tuple(img.shape) == (FACADE_SIZE,) * 2 + (3,)
          and bool((img != 0).any()) and bool((nimg != 0).any()),
          "12 facade: an empty mesh or frame")
    path = os.path.join(out, "again.npz")
    save_ms, _ = median_ms(lambda: save_checkpoint(path, final, cfg),
                           CHECKPOINT_TIMED, False)
    load_ms, (loaded, loaded_cfg) = median_ms(
        lambda: load_checkpoint(os.path.join(out, "checkpoint.npz")),
        CHECKPOINT_TIMED, False)
    mb = os.path.getsize(path) / 1e6
    raw = sum(t.numel() * t.element_size() for t in final) / 1e6
    print(f"[12 facade bench] medians of {FACADE_TIMED} after one call: "
          f"surface_mesh {mesh_ms!r} ms ({triangles} triangles, CUDA "
          f"events), splat render_frame {splat_ms!r} ms at {FACADE_SIZE}^2 "
          f"(mesh included, CUDA events), native render_frame "
          f"{native_ms!r} ms (host clock: mesh, copies and raster); "
          f"checkpoint save {save_ms / 1e3!r} s, load {load_ms / 1e3!r} s "
          f"(medians of {CHECKPOINT_TIMED}, host clock), "
          f"{mb!r} MB on disk for {raw!r} MB of state, on {card}",
          flush=True)
    check(loaded_cfg == cfg, "12 facade: the checkpoint's config differs")
    same = {f: same_bits(a, b) for f, a, b in zip(final._fields, loaded,
                                                  final)}
    check(all(same.values()), f"12 facade: the loaded checkpoint differs: "
                              f"{same}")
    a = clone_state(jit_step(loaded, cfg))
    b = clone_state(jit_step(clone_state(final), cfg))
    same = {f: same_bits(x, y) for f, x, y in zip(a._fields, a, b)}
    print(f"[12 facade bench] checkpoint loaded bitwise; one jit_step from "
          f"it against one from the saved state: bitwise "
          f"{all(same.values())}", flush=True)
    check(all(same.values()), f"12 facade: a step from the loaded state "
                              f"differs: {same}")
    del sim, final, s, loaded, a, b, mesh, img
    graph.clear_graphs()
    torch.cuda.empty_cache()
    return {"launches": launches, "steps_per_s": FACADE_STEPS / run_s,
            "mesh_ms": mesh_ms, "splat_ms": splat_ms,
            "native_ms": native_ms, "triangles": triangles,
            "save_s": save_ms / 1e3, "load_s": load_ms / 1e3, "mb": mb}


def facade_reference(device, cfg, wrappers, card: str) -> dict:
    """At `cfg` after FACADE_REF_STEPS engine steps: the card's mesh
    against the port's CPU mesh of the same field, and the card's splat
    frame against the CPU's at FACADE_COMPARE_SIZE^2."""
    from tpu_fluid_torch import Simulation
    from tpu_fluid_torch.render.splat import render_particles_and_surface
    from tpu_fluid_torch.solver import graph
    from tpu_fluid_torch.stages.surface_fields import surface_field
    from tpu_fluid_torch.surface.marching_cubes import extract_surface
    reset_launches(wrappers)
    sim = Simulation(cfg).step(FACADE_REF_STEPS).sync()
    launches = read_launches(wrappers)
    mesh = sim.surface_mesh()
    field = surface_field(sim.state.float_dens_1, sim.state.float_dens_2,
                          cfg).cpu()
    cpu_mesh = extract_surface(field, cfg)
    check(int(mesh.count) == int(cpu_mesh.count) and int(mesh.count) > 0
          and torch.equal(mesh.valid.cpu(), cpu_mesh.valid),
          f"12 facade reference: the card's mesh has {int(mesh.count)} "
          f"triangles, the CPU's {int(cpu_mesh.count)}, or their masks "
          f"differ")
    valid = cpu_mesh.valid
    ulp = ulp_diff(mesh.vertices.cpu()[valid], cpu_mesh.vertices[valid])
    nerr = max_abs_err(mesh.normals.cpu()[valid], cpu_mesh.normals[valid])
    print(f"[12 facade reference] mesh of reference_scene() after "
          f"{FACADE_REF_STEPS} steps: {int(mesh.count)} triangles on both; "
          f"vertices {ulp} ULP apart at most (tolerance {MESH_ULP}), normals "
          f"{nerr!r} (tolerance {MESH_NORMAL_ATOL})", flush=True)
    check(ulp <= MESH_ULP and nerr <= MESH_NORMAL_ATOL,
          "12 facade reference: the card's mesh is outside tolerance")
    size = FACADE_COMPARE_SIZE
    img = sim.render_frame(size, size).cpu()
    cpu_img = render_particles_and_surface(
        sim.state.positions.cpu(), sim.state.active.cpu(),
        cpu_mesh.vertices, cpu_mesh.normals, cpu_mesh.valid,
        sim.camera.mvp(), cfg, size, size)
    share = float((img == cpu_img).all(-1).double().mean())
    print(f"[12 facade reference] splat frame at {size}^2, card against "
          f"CPU: {share!r} of the pixels equal (at least {FRAME_SHARE})",
          flush=True)
    check(share >= FRAME_SHARE, f"12 facade reference: only {share!r} of "
                                f"the pixels equal")
    del sim, mesh, cpu_mesh, img, cpu_img, field
    graph.clear_graphs()
    torch.cuda.empty_cache()
    return {"launches": launches, "share": share, "ulp": ulp,
            "normal_err": nerr}


def phase_facade(device, ref_cfg, bench_cfg, wrappers, card: str) -> dict:
    """Phase 12: the engine's run at the bench scene (`facade_bench`), the
    card's mesh and frame against the CPU's at the reference scene
    (`facade_reference`), then the CLI and its resume in subprocesses.
    Returns the launches a wrapper made, by wrapper name."""
    import os
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as out:
        bench = facade_bench(device, bench_cfg, wrappers, card, out)
    ref = facade_reference(device, ref_cfg, wrappers, card)
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        run_cli(["--steps", "4", "--frame-every", "2", "--mesh-every", "2",
                 "--checkpoint-every", "4", "--out", out], root)
        t1 = time.perf_counter()
        said = run_cli(["--resume", os.path.join(out, "checkpoint.npz"),
                        "--steps", "2", "--out", out], root)
        t2 = time.perf_counter()
        files = sorted(os.listdir(out))
    print(f"[12 facade cli] python -m tpu_fluid_torch.cli --steps 4 "
          f"--frame-every 2 --mesh-every 2 --checkpoint-every 4: exit 0 in "
          f"{t1 - t0!r} s, files {files}; --resume --steps 2: exit 0 in "
          f"{t2 - t1!r} s, said {said.splitlines()[0]!r}", flush=True)
    check("at step 4" in said, f"12 facade cli: the resume did not print "
                               f"step 4: {said!r}")
    launches = dict(bench["launches"])
    for name, count in ref["launches"].items():
        launches[name] += count
    return {"launches": launches, "bench": bench, "reference": ref}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    card = f"{torch.cuda.get_device_name(0)} ({smi})"

    from tpu_fluid_torch import FluidConfig, initial_state
    from tpu_fluid_torch.kernels import build
    from tpu_fluid_torch.kernels.advect import advect_all_cuda
    from tpu_fluid_torch.kernels.grid_fused import (classify_extrap_cuda,
                                                    forces_solids_div_cuda,
                                                    project_cuda)
    from tpu_fluid_torch.kernels.jacobi import jacobi_sweeps_cuda
    from tpu_fluid_torch.kernels.particle_move import particle_move_cuda
    from tpu_fluid_torch.kernels.surface_fused import surface_fused_cuda
    wrappers = (advect_all_cuda, jacobi_sweeps_cuda, particle_move_cuda,
                surface_fused_cuda)
    fused_wrappers = (classify_extrap_cuda, forces_solids_div_cuda,
                      project_cuda)
    sources = {
        "advect_all_cuda": ("tpu_fluid_torch/csrc/advect.cu",
                            "tpu_fluid/kernels/advect.py:321, with the "
                            "condition masks "
                            "tpu_fluid/stages/velocity.py:160 (XLA) taken "
                            "in, "
                            "tpu_fluid/kernels/advect.py:244 "
                            "(advect_one_pallas, covered), "
                            "tpu_fluid/kernels/advect.py:369 "
                            "(advect_component_pallas, covered)"),
        "jacobi_sweeps_cuda": ("tpu_fluid_torch/csrc/jacobi.cu",
                               "tpu_fluid/kernels/jacobi.py:192, "
                               "tpu_fluid/kernels/jacobi.py:263 "
                               "(_one_pass, slab branch, covered)"),
        "particle_move_cuda": ("tpu_fluid_torch/csrc/particle_move.cu",
                               "tpu_fluid/kernels/pack_table.py:75, "
                               "tpu_fluid/kernels/pack_table.py:111, "
                               "tpu_fluid/kernels/particle_sample.py:77, "
                               "with stage 15 "
                               "tpu_fluid/stages/particles.py:25 "
                               "(detailed_occupancy, XLA) taken in"),
        "surface_fused_cuda": ("tpu_fluid_torch/csrc/surface_fused.cu",
                               "tpu_fluid/kernels/surface_fused.py:345, "
                               "tpu_fluid/kernels/surface_fused.py:266 "
                               "(surface_fused_2d, covered)"),
        "classify_extrap_cuda": ("tpu_fluid_torch/csrc/grid_fused.cu",
                                 "tpu_fluid/kernels/grid_fused.py:411 "
                                 "(body :143, pallas_call in _call :340), "
                                 "with stage 01 "
                                 "tpu_fluid/stages/particles.py:59 "
                                 "(occupancy_to_sim_grid, XLA) taken in"),
        "forces_solids_div_cuda": ("tpu_fluid_torch/csrc/grid_fused.cu",
                                   "tpu_fluid/kernels/grid_fused.py:443 "
                                   "(body :209, pallas_call in _call :340)"),
        "project_cuda": ("tpu_fluid_torch/csrc/grid_fused.cu",
                         "tpu_fluid/kernels/grid_fused.py:473 "
                         "(body :277, pallas_call in _call :340)"),
    }

    t0 = time.perf_counter()
    build.build()
    build.library()
    print(f"[2 build] {len(build.sources())} sources -> {build.LIBRARY.name} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    ref_cfg = FluidConfig.reference_scene()
    bench_cfg = FluidConfig.scaled_scene(128)
    large_cfg = FluidConfig.scaled_scene(256)
    check(large_cfg.grid_fused, "scaled_scene(256) must turn grid_fused on")
    parity = phase_parity(device, (("reference", ref_cfg),
                                   ("bench", bench_cfg),
                                   ("large", large_cfg)))

    # 4: reference scene through the public entry points
    state = initial_state(ref_cfg, device)
    ymax0 = float(active_positions(state)[:, 1].max())
    reset_launches(wrappers)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    state = run_steps(state, ref_cfg, REF_STEPS)
    end.record()
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    ref_sps = REF_STEPS / (start.elapsed_time(end) / 1000.0)
    print(f"[4 reference] {REF_STEPS} steps of reference_scene(): "
          f"{ref_sps!r} steps/s (first step included) on {card}",
          flush=True)
    check_invariants(state, ref_cfg, ymax0, "4 reference")
    with_kernels = run_steps(state, ref_cfg, COMPARE_STEPS)
    plain = run_steps(state, ref_cfg.replace(pallas_mode="off"),
                      COMPARE_STEPS)
    compare_states(with_kernels, plain, "4 kernels vs off")

    # 5: bench scene
    state = initial_state(bench_cfg, device)
    ymax0 = float(active_positions(state)[:, 1].max())
    reset_launches(wrappers)
    state = run_steps(state, bench_cfg, 1)
    start.record()
    state = run_steps(state, bench_cfg, BENCH_STEPS)
    end.record()
    torch.cuda.synchronize()
    for name, count in read_launches(wrappers).items():
        launches[name] += count
    bench_sps = BENCH_STEPS / (start.elapsed_time(end) / 1000.0)
    print(f"[5 bench] {BENCH_STEPS} timed steps of scaled_scene(128) after "
          f"1 warm-up: {bench_sps!r} steps/s on {card}", flush=True)
    check_invariants(state, bench_cfg, ymax0, "5 bench")

    # 6: every kernel of the path launched in phases 4 and 5
    print(f"[6 launches] phases 4-5: {launches}", flush=True)
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    del state, with_kernels, plain

    # 7: large scene, the grid_fused path of scaled_scene(256)
    state = initial_state(large_cfg, device)
    ymax0 = float(active_positions(state)[:, 1].max())
    plain_passes = PlainPasses()
    reset_launches(wrappers + fused_wrappers)
    k6_before = k6_device_launches(device)
    state = run_steps(state, large_cfg, 1)
    start.record()
    state = run_steps(state, large_cfg, LARGE_STEPS)
    end.record()
    torch.cuda.synchronize()
    large_launches = read_launches(wrappers + fused_wrappers)
    k6_device = k6_device_launches(device) - k6_before
    passes = plain_passes.take()
    print(f"[7 large] plain passes K1 and K3+K4 took in, calls in "
          f"{LARGE_STEPS + 1} steps: {passes}", flush=True)
    check(not any(passes.values()), f"a plain pass ran beside K1 or K3+K4: "
                                    f"{passes}")
    large_sps = LARGE_STEPS / (start.elapsed_time(end) / 1000.0)
    print(f"[7 large] {LARGE_STEPS} timed steps of scaled_scene(256) after "
          f"1 warm-up: {large_sps!r} steps/s on {card}", flush=True)
    check_invariants(state, large_cfg, ymax0, "7 large")
    print(f"[6 launches] phase 7: {large_launches}, K6 C counter "
          f"{k6_device}", flush=True)
    check(all(v > 0 for v in large_launches.values()),
          f"a kernel of the large path never launched: {large_launches}")
    check_k6_device("7 large", k6_device, large_launches)
    for name, count in large_launches.items():
        launches[name] = launches.get(name, 0) + count
    with_kernels = run_steps(state, large_cfg, LARGE_COMPARE_STEPS)
    plain = run_steps(state, large_cfg.replace(pallas_mode="off"),
                      LARGE_COMPARE_STEPS)
    compare_states(with_kernels, plain, "7 kernels vs off")
    del state, with_kernels, plain
    torch.cuda.empty_cache()

    # 8: the x-slab multi-device step at scaled_scene(256) on SHARDS ranks
    halo_parity = phase_halo_parity(device, large_cfg)
    torch.cuda.empty_cache()
    sharded_launches = phase_sharded(large_cfg, card, device)

    # 9: domain-sharded particles at scaled_scene(256) on SHARDS ranks
    domain_cfg = domain_scene(large_cfg)
    state0 = initial_state(domain_cfg, device)
    local_parity = phase_local_parity(device, domain_cfg, state0)
    del state0
    torch.cuda.empty_cache()
    domain_launches = phase_domain(domain_cfg, card, device)

    # 10: the CUDA-graph step (jit_step, jit_multi_step) at the three
    # scenes, and the bench
    graph_launches = phase_graph(device, (("reference", ref_cfg),
                                          ("bench", bench_cfg),
                                          ("large", large_cfg)),
                                 wrappers, fused_wrappers, card, smi)
    for name, count in graph_launches.items():
        launches[name] += count

    # 11: volume correction, the level set, the red-black solver and
    # scene fields at the bench scene's width, then sharded
    physics = phase_physics(device, bench_cfg, wrappers, card)
    for name, count in physics["launches"].items():
        if name in launches:
            launches[name] += count
        elif name == "particle_move_local_cuda":
            domain_launches[name] += count
        else:
            sharded_launches[name] = sharded_launches.get(name, 0) + count

    # 12: the facade (Simulation.run, the mesh and frame, checkpoints, the
    # CLI) at the bench and reference scenes
    facade = phase_facade(device, ref_cfg, bench_cfg, wrappers, card)
    for name, count in facade["launches"].items():
        launches[name] += count

    def entry(name, source, replaces, n, results, key):
        r = results[key]
        # no single PyTorch call computes any of these functions
        # (F.conv3d: an unmasked 6-neighbour sum; F.grid_sample: the
        # trilinear part of K1 and K3+K4 only), so library_ms is null
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": results["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None}

    kernels = [entry(w.__name__, *sources[w.__name__],
                     launches[w.__name__], parity[w.__name__], "large")
               for w in wrappers + fused_wrappers]
    kernels += [entry(name, source, replaces, sharded_launches[name],
                      halo_parity[name], 1)
                for name, (source, replaces) in HALO_SOURCES.items()]
    kernels.append(entry("particle_move_local_cuda", *LOCAL_SOURCE,
                         domain_launches["particle_move_local_cuda"],
                         local_parity, 1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
