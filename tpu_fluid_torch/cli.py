"""Command-line interface (`tpu_fluid.cli`), on the card unless
`--device cpu` is given.

The reference has no CLI at all — every knob is a compile-time constant
(`simulation_constants.h`, SURVEY.md §5.6).  Here the whole FluidConfig is
scriptable: grid size, particle count, physics constants, solver iterations,
plus run-loop controls (steps, frame/mesh dumps, checkpoints, diagnostics).

    tpu-fluid-torch --grid 64 --steps 200 --frame-every 50 --out out/
    tpu-fluid-torch --config scene.json --steps 1000 --mesh-every 100
    tpu-fluid-torch --resume out/checkpoint.npz --steps 500
    python -m tpu_fluid_torch.cli --device cpu --grid 12 --steps 4

The flags are the JAX package's, and `--device` takes the place of
JAX_PLATFORMS.  The JAX package's XLA compile cache has no counterpart:
the CUDA kernels build once into `build/tpu_fluid_torch/`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-fluid-torch",
        description="MAC-grid fluid simulation (PyTorch port)")
    p.add_argument("--scene", type=str, default="fountain",
                   choices=("fountain", "dam_break", "drop",
                            "dam_break_obstacle"),
                   help="scene preset (reference has only 'fountain')")
    p.add_argument("--grid", type=int, default=None,
                   help="cubic grid size (uses the scaled reference scene); "
                        "omit for the exact 20^3 reference scene")
    p.add_argument("--particles", type=int, default=1_000_000)
    p.add_argument("--jacobi-iters", type=int, default=200)
    p.add_argument("--surface-resolution", type=int, default=None,
                   help="detailed cells per sim cell (reference: 5)")
    p.add_argument("--dt", type=float, default=None)
    p.add_argument("--config", type=str, default=None,
                   help="JSON file of FluidConfig field overrides")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="override any FluidConfig field, e.g. "
                        "--set gravity=9.81 --set jacobi_iters=100")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--out", type=str, default="out")
    p.add_argument("--frame-every", type=int, default=0,
                   help="dump a PNG frame every N steps")
    p.add_argument("--mesh-every", type=int, default=0,
                   help="dump the surface mesh (OBJ) every N steps")
    p.add_argument("--log-every", type=int, default=0,
                   help="print diagnostics every N steps")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", type=str, default=None,
                   help="resume from a checkpoint file")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--no-surface", action="store_true")
    p.add_argument("--no-particles", action="store_true")
    p.add_argument("--video", type=str, default=None, metavar="PATH",
                   help="collect rendered frames into a video — .mp4 "
                        "(OpenCV) or animated .gif by extension (the "
                        "reference's demo-video counterpart); "
                        "requires --frame-every")
    p.add_argument("--video-fps", type=int, default=25)
    p.add_argument("--camera-scale", type=float, default=1.0,
                   help="scale the default camera distance (1.0 = the "
                        "reference's close-up pose, main.cpp:128; >1 pulls "
                        "back and aims at the scene center — useful for "
                        "large grids)")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="start the live HTTP viewer on PORT: MJPEG stream "
                        "+ browser key controls (q/e pause/resume, r/f "
                        "surface, p particles, a/d orbit, w/s dolly) — the "
                        "reference's interactive window, headless; requires "
                        "--frame-every")
    p.add_argument("--serve-host", type=str, default="127.0.0.1",
                   help="live-viewer bind address; the default stays on "
                        "loopback because /key and /stream are "
                        "unauthenticated — pass 0.0.0.0 to expose on the "
                        "network deliberately")
    p.add_argument("--paused-render-interval", type=float, default=0.25,
                   help="seconds between re-rendered live-viewer frames "
                        "while paused; 0 = render as fast as possible "
                        "(the reference's paused behavior, main.cpp:163-177)")
    p.add_argument("--orbit-deg", type=float, default=0.0,
                   help="orbit the camera this many degrees around the "
                        "scene center between rendered frames")
    p.add_argument("--render-method", type=str, default="splat",
                   choices=("splat", "native"),
                   help="device splat renderer or exact host rasterizer")
    p.add_argument("--solid-npy", type=str, default=None,
                   help="(X,Y,Z) bool/uint8 .npy of dynamic solid cells "
                        "(core/scene_fields.SceneFields.solid)")
    p.add_argument("--force-npy", type=str, default=None,
                   help="(3,X,Y,Z) float32 .npy per-cell force field "
                        "(core/scene_fields.SceneFields.force)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the state (default: the card); "
                        "cpu runs the plain PyTorch versions of the "
                        "kernels")
    return p


def config_from_args(args):
    from tpu_fluid_torch.core.config import FluidConfig
    from tpu_fluid_torch.core.scenes import SCENES
    if args.scene != "fountain":
        cfg = SCENES[args.scene](args.grid or 20,
                                 particle_count=args.particles).replace(
            jacobi_iters=args.jacobi_iters)
        if args.surface_resolution:
            cfg = cfg.replace(
                surface_render_resolution=args.surface_resolution)
    elif args.grid:
        cfg = FluidConfig.scaled_scene(
            args.grid, particle_count=args.particles,
            jacobi_iters=args.jacobi_iters,
            surface_render_resolution=args.surface_resolution or 2)
    else:
        cfg = FluidConfig.reference_scene().replace(
            particle_count=args.particles, jacobi_iters=args.jacobi_iters)
        if args.surface_resolution:
            cfg = cfg.replace(
                surface_render_resolution=args.surface_resolution)
    if args.dt is not None:
        cfg = cfg.replace(dt=args.dt)
    overrides = {}
    if args.config:
        with open(args.config) as f:
            overrides.update(json.load(f))
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = v
    if overrides:
        from tpu_fluid_torch.core.config import deep_tuple

        fields = {f.name: f.type for f in dataclasses.fields(cfg)}
        clean = {}
        for k, v in overrides.items():
            if k not in fields:
                raise SystemExit(f"unknown config field: {k}")
            cur = getattr(cfg, k)
            if isinstance(v, str):
                try:
                    if isinstance(cur, bool):
                        if v.lower() not in ("1", "true", "yes",
                                             "0", "false", "no"):
                            raise ValueError(f"not a boolean: {v!r}")
                        v = v.lower() in ("1", "true", "yes")
                    elif isinstance(cur, int):
                        v = int(v)
                    elif isinstance(cur, float):
                        v = float(v)
                    elif cur is None:
                        # None-default fields may be tuples
                        # (fountain_position) or scalars (levelset_iso,
                        # volume_target_density, ...): accept JSON/comma
                        # lists, "none"/"null", or a bare number
                        if v.lower() in ("none", "null"):
                            v = None
                        elif v.startswith(("[", "(")):
                            v = deep_tuple(json.loads(v.replace("(", "[")
                                                      .replace(")", "]")))
                        elif "," in v:
                            v = deep_tuple(json.loads(f"[{v}]"))
                        else:
                            try:
                                v = int(v)
                            except ValueError:
                                v = float(v)
                    elif isinstance(cur, tuple):
                        # tuple-valued fields accept JSON ([12,18,12]) or
                        # bare comma lists (12,18,12); anything else is a
                        # parse-time error, not a later jit failure
                        if v.startswith(("[", "(")):
                            v = deep_tuple(json.loads(v.replace("(", "[")
                                                      .replace(")", "]")))
                        elif "," in v:
                            v = deep_tuple(json.loads(f"[{v}]"))
                        else:
                            raise ValueError(
                                f"field {k} is tuple-valued; pass JSON "
                                f"(e.g. [1,2,3]) or a comma list (1,2,3)")
                except ValueError as e:
                    raise SystemExit(f"bad value for --set {k}={v}: {e}")
            else:
                v = deep_tuple(v) if isinstance(v, list) else v
            clean[k] = v
        cfg = cfg.replace(**clean)
    return cfg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from tpu_fluid_torch.engine import Simulation

    if args.resume:
        sim = Simulation.load(args.resume, device=args.device)
        print(f"resumed from {args.resume} at step "
              f"{int(sim.state.step)}", flush=True)
    else:
        cfg = config_from_args(args)
        sim = Simulation(cfg=cfg, device=args.device)
        print(f"grid {cfg.grid_size} particles {cfg.particle_count} "
              f"detailed {cfg.detailed_size} jacobi {cfg.jacobi_iters}",
              flush=True)
    sim.render_surface = not args.no_surface
    sim.render_particles = not args.no_particles
    sim.paused_render_interval = args.paused_render_interval
    if args.camera_scale != 1.0:
        import numpy as np
        center = tuple(g / 2.0 for g in sim.cfg.grid_size)
        pos = tuple(np.asarray(sim.camera.position) * args.camera_scale)
        sim.camera = sim.camera.move(
            tuple(np.asarray(pos) - np.asarray(sim.camera.position))
        ).look_at_point(center)

    if args.solid_npy or args.force_npy:
        import numpy as np
        import torch

        from tpu_fluid_torch.core.scene_fields import SceneFields
        device = sim.state.velocity.device
        sim.scene = SceneFields(
            solid=(torch.from_numpy(np.load(args.solid_npy).astype(np.uint8))
                   .to(device) if args.solid_npy else None),
            force=(torch.from_numpy(np.load(args.force_npy)
                                    .astype(np.float32)).to(device)
                   if args.force_npy else None),
        ).validate(sim.cfg)

    os.makedirs(args.out, exist_ok=True)

    if args.video and not args.frame_every:
        raise SystemExit("--video requires --frame-every")
    if args.serve is not None and not args.frame_every:
        raise SystemExit("--serve requires --frame-every")

    t0 = time.time()
    sim.run(args.steps,
            frame_every=args.frame_every, frame_dir=args.out,
            width=args.width, height=args.height,
            log_every=args.log_every,
            checkpoint_every=args.checkpoint_every,
            checkpoint_path=os.path.join(args.out, "checkpoint.npz"),
            video_path=args.video, video_fps=args.video_fps,
            orbit_deg_per_frame=args.orbit_deg,
            render_method=args.render_method,
            serve_port=args.serve,
            serve_host=args.serve_host,
            mesh_every=args.mesh_every)
    sim.sync()                             # complete the work BEFORE timing
    dt = time.time() - t0
    print(f"{args.steps} steps in {dt:.2f}s "
          f"({args.steps / dt:.1f} steps/s incl. host work)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
