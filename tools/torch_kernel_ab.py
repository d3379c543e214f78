#!/usr/bin/env python3
"""Time the PyTorch port's redesigned kernels of one source tree on the
card, at the shapes `chip_smoke.py` checks them at, or split its
scaled_scene(256) step by stage.

    python3 tools/torch_kernel_ab.py [--tree DIR] [--label NAME]
                                     [--split | --steps | --sass]

`--tree` names the directory that holds the `tpu_fluid_torch` package to
time (default: this checkout), so that a parent commit unpacked with
`git archive` into a gitignored directory can be timed in the same call as
the change: run parent, change, change, parent, one process each.  Each
process builds that tree's kernels into the tree's own `build/`.

Kernels (the default): the inputs are `chip_smoke.py`'s own, made by its
`kernel_cases`, `scene_cases`, `halo_cases` and `local_move_cases` (this
checkout's script, that tree's package): K1 advects random +-60
velocities on a random cell field, and K3+K4 moves 1,000,000 random
positions (the extremes among them) and scatters their occupancy, at
20^3, 128^3 and 256^3, and both again on the velocity, cell types,
positions and active flags of `scaled_scene(256)` after 2 steps; K2f
folds a random cell field and divergence, and K2 solves the folded
system for 199 sweeps, at 20^3, 128^3 and 256^3 (K2f also on the large
scene's types and divergence after 2 steps); K5 runs 4 blur passes at the detailed grids 100^3, 256^3
and 512^3; K6a (stages 01-06) takes the 512^3 detailed occupancy at pool
2 and K6b (08-11) and K6c (13) their 256^3 fields; and at shard 1 of
`scaled_scene(256)` split 4 ways, K1's halo form runs on a 64 x 256^2 slab
with 2 velocity planes and 1 type plane a side, K2's sharded pass runs 8
sweeps on an 80 x 256^2 slab, K5's halo form runs on a 128 x 512^2 slab
with 5 halo planes a side, K6a's, K6b's and K6c's halo forms on 64 x 256^2
slabs with 2, 1 and 1, and K3+K4's local-slab form moves that slab's
particles and 20,000 stragglers.  Each line printed is one JSON object
with the tree's label, the kernel, the scene, the input shape, the mean ms
by CUDA events over `REPS` calls after two warm-up calls, the kernel
launches one call made (where the tree counts them) and a digest of the
output bytes, which must agree between trees: both are bitwise equal to
the same plain version.

`--split`: `SPLIT_STEPS` steps of scaled_scene(256) after one warm-up,
with CUDA events around every stage call of `solver/step.py` and the
kernels and plain passes inside stages 07 and 12 (stage functions the tree
does not have or call are absent from its lines).  One JSON line a stage: the
median and the per-step ms; then the step itself and the part of it that
no top-level stage covers.

`--steps`: the step's entry points at the three scenes (reference_scene,
scaled_scene(128) and (256)), each from the state after 2 eager steps: ms
a step of the eager `step`, `jit_step`, `jit_multi_step(state, cfg, 3)`
and, on a 1-rank mesh, `jit_spmd_step` (particles index-sharded below
256^3 and domain-sharded there, as the bench chooses); then the first
three at 128^3 under each option of `chip_smoke.physics_configs` (volume
correction every 4 steps, the level set, the red-black solver, the dam
break with scene fields).  Medians of `STEP_REPS` calls between CUDA
events after `STEP_WARMUP` untimed calls, which capture every graph a
lineage replays, the cadence's included (`chip_smoke.timed_calls`), with
every capture's graph pool.  One JSON line a scene or option.

`--sass`: compile each CUDA source of the tree with the build's flags and
print, a JSON line a kernel, its registers and spills (`nvcc -Xptxas -v`)
and its static SASS instruction count (`cuobjdump -sass`).

The first line is the card's name and power limit as nvidia-smi gives
them.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# calls timed a kernel: the 20^3 / 100^3 calls take tens of microseconds,
# so many calls average out the host's jitter
REPS = {"reference": 200, "bench": 20, "large": 8, "large shard 1/4": 10}
REPS["large scene"] = REPS["large"]
SCENE_KERNELS = ("advect_all_cuda", "jacobi_fold_cuda",
                 "jacobi_sweeps_cuda", "particle_move_cuda", "surface_fused_cuda",
                 "classify_extrap_cuda", "forces_solids_div_cuda",
                 "project_cuda")
HALO_KERNELS = ("advect_all_halo_cuda", "jacobi_pass_cuda",
                "surface_fused_halo_cuda", "classify_extrap_halo_cuda",
                "forces_solids_div_halo_cuda", "project_halo_cuda")
SPLIT_STEPS = 5
STEP_REPS = 15
STEP_WARMUP = 4
# (module, function, label, top level): the stage calls of
# solver/step.simulation_step on the fused path, and inside stages 07
# and 12 the kernel and the plain passes around it
SPLIT = (
    ("kernels.grid_fused", "classify_extrap_cuda", "K6a (01-06)", True),
    ("stages.velocity", "advect", "07 advect", True),
    ("stages.velocity", "advect_all_cuda", "07 K1", False),
    ("kernels.grid_fused", "forces_solids_div_cuda", "08-11 K6b", True),
    ("stages.pressure", "jacobi_solve", "12 pressure solve", True),
    ("stages.pressure", "jacobi_fold_cuda", "12 K2f", False),
    ("stages.pressure", "jacobi_sweeps_cuda", "12 K2", False),
    ("kernels.grid_fused", "project_cuda", "13 K6c", True),
    ("stages.particles", "move_and_scatter",
     "14-15 move and scatter (K3+K4)", True),
    ("stages.surface_fields", "update_surface_fields", "16-18 K5", True),
)


def digest(tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_kernels(label, chip_smoke, device) -> None:
    import torch
    from tpu_fluid_torch import FluidConfig, initial_state

    def report(scene, kernel, call_args, kw):
        counter = chip_smoke.device_launch_counter(kernel)

        def call():
            return kernel(*call_args, **kw)

        before = counter() if counter else None
        out = call()
        torch.cuda.synchronize()
        used = counter() - before if counter else None
        ms = chip_smoke.time_ms(call, reps=REPS[scene])
        print(json.dumps({"tree": label, "kernel": kernel.__name__,
                          "scene": scene, "shape": list(call_args[0].shape),
                          "ms": ms, "launches": used,
                          "digest": digest(out if isinstance(out, tuple)
                                           else (out,))}), flush=True)

    large = FluidConfig.scaled_scene(256)
    for scene, cfg in (("reference", FluidConfig.reference_scene()),
                       ("bench", FluidConfig.scaled_scene(128)),
                       ("large", large)):
        for _, kernel, _, call_args, kw in chip_smoke.kernel_cases(
                device, [(scene, cfg)]):
            if kernel.__name__ in SCENE_KERNELS:
                report(scene, kernel, call_args, kw)
        torch.cuda.empty_cache()
    for kernel, _, call_args, kw in chip_smoke.scene_cases(device, large):
        report("large scene", kernel, call_args, kw)
    torch.cuda.empty_cache()
    for kernel, _, call_args, kw, shard in chip_smoke.halo_cases(device,
                                                                  large):
        if shard == 1 and kernel.__name__ in HALO_KERNELS:
            report("large shard 1/4", kernel, call_args, kw)
    from tpu_fluid_torch.kernels.particle_move import (
        particle_move_local_cuda as local)
    domain = chip_smoke.domain_scene(large)
    for shard, call_args in chip_smoke.local_move_cases(
            device, domain, initial_state(domain, device)):
        if shard == 1:
            report("large shard 1/4", local, call_args, {})


def split_step(label, device) -> None:
    """Per-stage device time of the scaled_scene(256) step."""
    import torch
    from tpu_fluid_torch import FluidConfig, initial_state, step
    log = []

    def timed(fn, name):
        @functools.wraps(fn)  # the wrappers' launch counters come along
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            log.append((name, start, end))
            return out
        return call

    for module, name, stage, _ in SPLIT:
        mod = importlib.import_module(f"tpu_fluid_torch.{module}")
        if hasattr(mod, name):
            setattr(mod, name, timed(getattr(mod, name), stage))
    cfg = FluidConfig.scaled_scene(256)
    state = step(initial_state(cfg, device), cfg)
    torch.cuda.synchronize()
    per_step = []
    for _ in range(SPLIT_STEPS):
        log.clear()
        state = timed(step, "step")(state, cfg)
        torch.cuda.synchronize()
        ms = {}
        for name, start, end in log:
            ms[name] = ms.get(name, 0.0) + start.elapsed_time(end)
        per_step.append(ms)
    top = {stage for _, _, stage, is_top in SPLIT if is_top}
    for ms in per_step:
        ms["not in a stage"] = ms["step"] - sum(v for k, v in ms.items()
                                                 if k in top)
    stages = dict.fromkeys(s for _, _, s, _ in SPLIT)
    for name in list(stages) + ["step", "not in a stage"]:
        each = [ms[name] for ms in per_step if name in ms]
        if each:
            print(json.dumps({"tree": label, "split": name,
                              "median_ms": statistics.median(each),
                              "ms": each}), flush=True)


def time_steps(label, chip_smoke, device) -> None:
    """Eager, graphed and 1-rank graphed SPMD ms a step at the three
    scenes, and eager and graphed under each option at 128^3."""
    import torch
    from tpu_fluid_torch import (FluidConfig, initial_state, jit_multi_step,
                                 jit_step, step)
    from tpu_fluid_torch.parallel.mesh import make_mesh
    from tpu_fluid_torch.parallel.particles_domain import layout_state
    from tpu_fluid_torch.parallel.spmd_step import jit_spmd_step
    from tpu_fluid_torch.solver import graph
    mesh = make_mesh(1, device=device)
    bench = FluidConfig.scaled_scene(128)
    cases = [(scene, cfg, None, True) for scene, cfg in (
        ("reference", FluidConfig.reference_scene()), ("bench", bench),
        ("large", FluidConfig.scaled_scene(256)))]
    cases += [(name, cfg, chip_smoke.physics_scene(cfg, device)
               if with_scene else None, False)
              for name, cfg, with_scene in chip_smoke.physics_configs(bench)]
    for name, cfg, scene, spmd in cases:
        state0 = chip_smoke.run_steps(initial_state(cfg, device), cfg, 2,
                                      scene)
        first = len(graph.captures)
        row = {"tree": label, "scene": name}
        entries = [("eager", lambda x: step(x, cfg, scene), state0, 1),
                   ("jit_step", lambda x: jit_step(x, cfg, scene), state0,
                    1),
                   ("jit_multi_step(3)",
                    lambda x: jit_multi_step(x, cfg, 3, scene), state0, 3)]
        if spmd:
            scfg = cfg.replace(particle_sharding="domain"
                               if cfg.grid_size[0] >= 256 else "index")
            entries.append(("jit_spmd_step", jit_spmd_step(scfg, mesh),
                            layout_state(state0, 0, 1, scfg), 1))
        for what, fn, start, n in entries:
            calls, _ = chip_smoke.timed_calls(fn, start, STEP_REPS, n,
                                              STEP_WARMUP)
            each = [ms for _, ms in calls]
            row[what] = statistics.median(each) / n
            row[f"{what} each"] = each
            graph.clear_graphs()
            torch.cuda.empty_cache()
        row["pool_mib"] = [c["pool_bytes"] / 2 ** 20
                           for c in graph.captures[first:]]
        print(json.dumps(row), flush=True)
        del state0
        torch.cuda.empty_cache()


PTXAS_KERNEL = re.compile(
    r"Function properties for (\S+)\n\s+\d+ bytes stack frame, (\d+) "
    r"bytes spill stores, (\d+) bytes spill loads\n.*?Used (\d+) registers")
SASS_FUNCTION = re.compile(r"Function : (\S+)")
SASS_INSTRUCTION = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/", re.M)


def sass_counts(label) -> None:
    """Registers, spills and static SASS instructions of every kernel of
    the tree's CUDA sources."""
    from tpu_fluid_torch.kernels import build
    cuobjdump = str(Path(build.nvcc()).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        for src in build.sources():
            obj = str(Path(tmp) / f"{src.stem}.o")
            ptxas = subprocess.run(
                [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 str(src), "-o", obj], capture_output=True, text=True,
                check=True).stderr
            sass = subprocess.run([cuobjdump, "-sass", obj],
                                  capture_output=True, text=True,
                                  check=True).stdout
            parts = SASS_FUNCTION.split(sass)[1:]
            count = {name: len(SASS_INSTRUCTION.findall(body))
                     for name, body in zip(parts[::2], parts[1::2])}
            for name, st, ld, regs in PTXAS_KERNEL.findall(ptxas):
                print(json.dumps({"tree": label, "source": src.name,
                                  "kernel": name, "registers": int(regs),
                                  "spill_bytes": int(st) + int(ld),
                                  "sass_instructions": count.get(name)}),
                      flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="change")
    ap.add_argument("--split", action="store_true",
                    help="split the scaled_scene(256) step by stage")
    ap.add_argument("--sass", action="store_true",
                    help="registers and static SASS of each kernel")
    ap.add_argument("--steps", action="store_true",
                    help="eager and graphed ms a step at the three scenes")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    # the tree's package first, then this checkout's chip_smoke.py
    sys.path[:0] = [str(tree), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import tpu_fluid_torch
    from tpu_fluid_torch.kernels import build
    if Path(tpu_fluid_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {tpu_fluid_torch.__file__}, not the "
                           f"tree {tree}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build()
    device = torch.device("cuda", 0)
    if args.sass:
        sass_counts(args.label)
    elif args.split:
        split_step(args.label, device)
    elif args.steps:
        time_steps(args.label, chip_smoke, device)
    else:
        time_kernels(args.label, chip_smoke, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
