#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each (more for the parity and scene phases):
  1 device    the card's name and power limit, as nvidia-smi gives them
  2 build     compile the CUDA kernels from tpu_fluid_torch/csrc
  3 parity    each kernel against its plain PyTorch version on the card, at
              the shapes of the three scenes (K6 at the large one only), on
              numpy-seeded inputs: every output must match bitwise
              (tolerance 0); times by CUDA events
  4 reference FluidConfig.reference_scene() (20^3, 1M particles), 20 steps,
              invariants; then 3 steps with the kernels and 3 with
              pallas_mode="off" from the same state must agree
  5 bench     FluidConfig.scaled_scene(128) (1M particles), 1 warm-up and
              10 timed steps, invariants, steps/s
  6 launches  every kernel ran during phases 4 and 5
  7 large     FluidConfig.scaled_scene(256) (1M particles, 512^3 detailed
              grid, grid_fused on), 1 warm-up and 5 timed steps,
              invariants, steps/s, and every kernel, K6 included, launched
              in it; then 2 steps with the kernels and 2 with
              pallas_mode="off" (the unfused stage path) must agree
The line before the last is a JSON object with the kernels' numbers (times
at the large scene); the last line is {"ok": true, "device": {...}}.  Any
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
# f32 tolerances of the kernel path against pallas_mode="off" where the two
# are not bitwise equal (tests/test_full_step_oracle.py)
STEP_TOLERANCES = {"velocity": (2e-4, 2e-5), "positions": (1e-4, 1e-5),
                   "float_dens_1": (1e-4, 1e-5),
                   "float_dens_2": (1e-4, 1e-5)}


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
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def random_types(rng, n: int) -> np.ndarray:
    """A plausible cell-type field: water blob, air shell, solid border."""
    from tpu_fluid_torch.core.types import CellType
    water = rng.random((n, n, n)) < 0.4
    t = np.where(water, CellType.WATER, CellType.INACTIVE).astype(np.uint8)
    t[0], t[-1], t[:, 0], t[:, -1] = (CellType.SOLID,) * 4
    t[:, :, 0], t[:, :, -1] = (CellType.SOLID,) * 2
    air = (t == CellType.INACTIVE) & (rng.random((n, n, n)) < 0.3)
    t[air] = CellType.AIR
    return t


def grid_fused_cases(t, rng, cfg):
    """K6 cases at the grid of `cfg`, with a solid box and an extra force
    added so that every branch of the kernels runs; the fountain and the
    extra-force cells are WATER so that their forces land."""
    from tpu_fluid_torch.kernels.grid_fused import (
        classify_extrap_cuda, classify_extrap_plain, forces_solids_div_cuda,
        forces_solids_div_plain, project_cuda, project_plain)
    n = cfg.grid_size[0]
    box = ((n // 4, n // 4, n // 4), (n // 2, n // 3, n // 2))
    force_cell = (n // 3, n // 2, n // 3)
    cfg = cfg.replace(solid_boxes=(box,),
                      extra_forces=((force_cell, (40.0, 0.0, -25.0)),))
    occ = t((rng.random((n, n, n)) < 0.35).astype(np.uint8))
    old = t(rng.integers(0, 4, (n, n, n)).astype(np.uint8))
    vel = t((rng.standard_normal((3, n, n, n)) * 3).astype(np.float32))
    types_np = random_types(rng, n)
    fx, fy, fz = cfg.fountain
    types_np[fx, fy - 1:fy + 1, fz] = 2
    types_np[force_cell] = 2
    types = t(types_np)
    p = t((rng.standard_normal((n, n, n)) * 50).astype(np.float32))
    return [(classify_extrap_cuda, classify_extrap_plain,
             (occ, old, vel, cfg), {}),
            (forces_solids_div_cuda, forces_solids_div_plain,
             (types, vel, cfg), {}),
            (project_cuda, project_plain, (types, p, vel, cfg), {})]


def kernel_cases(device, scenes):
    """(scene, kernel wrapper, plain version, args, kwargs) per kernel and
    scene, on numpy-seeded inputs at the shapes the main path gives; the
    K6 cases at the scenes whose config turns grid_fused on."""
    from tpu_fluid_torch.kernels.advect import (advect_all_cuda,
                                                advect_all_plain)
    from tpu_fluid_torch.kernels.jacobi import (jacobi_sweeps_cuda,
                                                jacobi_sweeps_plain)
    from tpu_fluid_torch.kernels.particle_move import (particle_move_cuda,
                                                       particle_move_plain)
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
        # K1: |v| * dt up to a few cells, so the R clamp is exercised
        vel = t((rng.standard_normal((3, n, n, n)) * 60).astype(np.float32))
        cond3 = t((rng.random((3, n, n, n)) < 0.6).astype(np.uint8))
        cases.append((scene, advect_all_cuda, advect_all_plain,
                      (vel, cond3, cfg.advect_max_displacement, cfg.dt), {}))
        # K2: the folded inputs of a real solve on a plausible cell field
        types = t(random_types(rng, n))
        rhs = t((rng.standard_normal((n, n, n)) * 100).astype(np.float32))
        _, q0, code, c2 = jacobi_fold(types, rhs, cfg, cfg.air_pressure)
        cases.append((scene, jacobi_sweeps_cuda, jacobi_sweeps_plain,
                      (q0, code, c2, cfg.jacobi_iters - 1), {}))
        # K3+K4: positions around and just outside the grid
        p = cfg.particle_count
        pvel = t((rng.standard_normal((3, n, n, n)) * 5).astype(np.float32))
        pos = t((rng.random((p, 3)) * (n + 2) - 1).astype(np.float32))
        act = t(rng.random(p) < 0.9)
        cases.append((scene, particle_move_cuda, particle_move_plain,
                      (pvel, pos, act, cfg.dt), {}))
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


def phase_parity(device, scenes) -> dict:
    results = {}
    for scene, kernel, plain, args, kw in kernel_cases(device, scenes):
        name = kernel.__name__
        got, want = kernel(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        bitwise = all(a.dtype == b.dtype and torch.equal(a, b)
                      for a, b in zip(got, want))
        ms = time_ms(lambda: kernel(*args, **kw), reps=20)
        plain_ms = time_ms(lambda: plain(*args, **kw), reps=3, warmup=1)
        print(f"[3 parity] {name} {scene} shapes="
              f"{[tuple(a.shape) for a in got]} max_abs_err={err!r} "
              f"bitwise={bitwise} (tolerance 0) kernel_ms={ms!r} "
              f"plain_ms={plain_ms!r}", flush=True)
        check(bitwise, f"{name} at the {scene} scene differs from its plain "
                       f"version (max abs err {err!r})")
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry[scene] = (ms, plain_ms)
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


def run_steps(state, cfg, n: int):
    from tpu_fluid_torch import step
    for _ in range(n):
        state = step(state, cfg)
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
                            "tpu_fluid/kernels/advect.py:321, "
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
                               "tpu_fluid/kernels/particle_sample.py:77"),
        "surface_fused_cuda": ("tpu_fluid_torch/csrc/surface_fused.cu",
                               "tpu_fluid/kernels/surface_fused.py:345, "
                               "tpu_fluid/kernels/surface_fused.py:266 "
                               "(surface_fused_2d, covered)"),
        "classify_extrap_cuda": ("tpu_fluid_torch/csrc/grid_fused.cu",
                                 "tpu_fluid/kernels/grid_fused.py:411 "
                                 "(body :143, pallas_call in _call :340)"),
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
    reset_launches(wrappers + fused_wrappers)
    state = run_steps(state, large_cfg, 1)
    start.record()
    state = run_steps(state, large_cfg, LARGE_STEPS)
    end.record()
    torch.cuda.synchronize()
    large_launches = read_launches(wrappers + fused_wrappers)
    large_sps = LARGE_STEPS / (start.elapsed_time(end) / 1000.0)
    print(f"[7 large] {LARGE_STEPS} timed steps of scaled_scene(256) after "
          f"1 warm-up: {large_sps!r} steps/s on {card}", flush=True)
    check_invariants(state, large_cfg, ymax0, "7 large")
    print(f"[6 launches] phase 7: {large_launches}", flush=True)
    check(all(v > 0 for v in large_launches.values()),
          f"a kernel of the large path never launched: {large_launches}")
    for name, count in large_launches.items():
        launches[name] = launches.get(name, 0) + count
    with_kernels = run_steps(state, large_cfg, LARGE_COMPARE_STEPS)
    plain = run_steps(state, large_cfg.replace(pallas_mode="off"),
                      LARGE_COMPARE_STEPS)
    compare_states(with_kernels, plain, "7 kernels vs off")

    kernels = []
    for w in wrappers + fused_wrappers:
        name = w.__name__
        source, replaces = sources[name]
        ms, plain_ms = parity[name]["large"]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": parity[name]["max_abs_err"],
                        "ms": ms, "plain_ms": plain_ms})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
