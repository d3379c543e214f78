"""High-level simulation engine (`tpu_fluid.engine`) — the user-facing
replacement for the reference's application layer (`main.cpp:26-218`).

The reference's main loop is: poll input -> record+submit sim command
buffer (unless paused) -> record+submit render pass -> present ->
fence-wait.  The engine is the same loop without a window: `run()`
advances the graphed step (`solver/graph.jit_step`, a CUDA-graph replay
on the card), renders headless frames at a chosen cadence, and exposes
pause/resume (Q/E in the reference, `main.cpp:163-166`), surface-render
and particle-render toggles (R/F), checkpointing, and per-step
diagnostics.

The state lives on the card unless `Simulation(cfg, device="cpu")` (or a
CPU state) is given.  On the card, `self.state` lives in one of the two
buffer sets the step graphs keep for this simulation's lineage: the next
`step()` consumes it, as JAX's donation does (its second step writes the
set it lies in), so clone it to keep it across a `step()`.  No other
simulation's steps write it.
Meshing and rendering run eagerly, outside the graph: their shapes depend
on the data.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.state import FluidState, initial_state
from tpu_fluid_torch.kernels import on_cuda
from tpu_fluid_torch.render.camera import Camera
from tpu_fluid_torch.render.export import to_host
from tpu_fluid_torch.solver.graph import jit_step
from tpu_fluid_torch.stages.surface_fields import surface_field
from tpu_fluid_torch.surface.marching_cubes import extract_surface
from tpu_fluid_torch.utils import profiling
from tpu_fluid_torch.utils.diagnostics import diagnostics, format_diagnostics


@dataclasses.dataclass
class Simulation:
    cfg: FluidConfig
    state: FluidState = None
    camera: Camera = None
    paused: bool = False              # Q/E in the reference
    render_particles: bool = True     # reference render toggles (R/F keys)
    render_surface: bool = True
    max_surface_cells: Optional[int] = None
    scene: "SceneFields" = None       # dynamic solids / force field
    dispatch_chunk: int = 5           # max steps between pending events
    max_pending: int = 1              # chunks left un-synced
    # Seconds between re-rendered frames while paused with a live viewer.
    # The reference renders paused frames at full rate (`main.cpp:163-177`);
    # the default throttles to 4 Hz.  Set 0.0 for the reference's
    # render-as-fast-as-possible behavior.
    paused_render_interval: float = 0.25
    device: str = "cuda"              # where a state made here lives

    def __post_init__(self):
        if self.state is None:
            self.state = initial_state(self.cfg, self.device)
        if self.camera is None:
            self.camera = Camera.for_scene(self.cfg.grid_size)
        if self.scene is not None:
            self.scene.validate(self.cfg)
        self._pending = []

    # ------------------------------------------------------------- stepping
    def step(self, n: int = 1) -> "Simulation":
        """Advance n frames.  No-op if paused — matching the reference,
        where pause skips the sim submit but keeps rendering
        (`main.cpp:163-177`).

        The steps are `jit_step` replays, queued on the card's stream in
        chunks of at most `dispatch_chunk`; after each chunk a CUDA event
        is recorded, and the host waits for all but the newest
        `max_pending` of them, so that it runs at most that many chunks
        ahead of the card."""
        self._step_counted(n)
        return self

    def _step_counted(self, n: int) -> int:
        """step(), returning how many steps actually ran.

        Pause is re-checked at every chunk boundary (not just entry): the
        live viewer flips `paused` from its server thread, so a caller
        that advanced its progress by the REQUESTED count would mark
        steps as simulated when a pause landed between its check and
        ours.  run() advances by this return value instead."""
        done = 0
        with profiling.span("step"):
            while done < n and not self.paused:
                k = min(self.dispatch_chunk, n - done)
                for _ in range(k):
                    self.state = jit_step(self.state, self.cfg, self.scene)
                done += k
                # every chunk, the final one included, records an event:
                # the next step() call queues at once, and the bound must
                # hold across calls too
                if on_cuda(self.state.step):
                    event = torch.cuda.Event()
                    event.record()
                    self._pending.append(event)
                self._drain(self.max_pending)
        return done

    def _drain(self, limit: int = 0) -> None:
        while len(self._pending) > limit:
            self._pending.pop(0).synchronize()

    def sync(self) -> "Simulation":
        """Block until all queued work is complete."""
        self._drain(0)
        if on_cuda(self.state.step):
            torch.cuda.synchronize(self.state.step.device)
        return self

    def pause(self):
        self.paused = True
        return self

    def resume(self):
        self.paused = False
        return self

    # ------------------------------------------------------------ rendering
    @torch.no_grad()
    def surface_mesh(self):
        """The marching-cubes mesh of the current surface field, on the
        state's device."""
        with profiling.span("surface_mesh"):
            return extract_surface(
                surface_field(self.state.float_dens_1,
                              self.state.float_dens_2, self.cfg),
                self.cfg, max_cells=self.max_surface_cells)

    @torch.no_grad()
    def render_frame(self, width: int = 1024, height: int = 1024,
                     method: str = "splat"):
        """Headless frame: (H, W, 3) uint8.

        method="splat": z-buffered splatting on the state's device, a
        tensor there.  method="native": host rasterization through the C++
        library (point sprites sized min(base/depth, max), true triangle
        raster), a numpy array; it copies positions and the mesh to the
        host first, and raises if the library does not build.
        """
        with profiling.span("render_frame"):
            return self._render_frame(width, height, method)

    def _render_frame(self, width: int, height: int, method: str):
        mesh = self.surface_mesh() if self.render_surface else None
        active = (self.state.active if self.render_particles
                  else self.state.active & False)
        if method == "native":
            from tpu_fluid_torch.render.raster import render_frame_native
            from tpu_fluid_torch.surface.marching_cubes import mesh_to_numpy
            tris, normals = mesh_to_numpy(mesh) if mesh else (None, None)
            return render_frame_native(
                self.state.positions.cpu().numpy(), active.cpu().numpy(),
                tris, normals, self.camera.mvp(), self.cfg, width, height)
        if method != "splat":
            raise ValueError(f"unknown render method {method!r}")
        from tpu_fluid_torch.render.splat import \
            render_particles_and_surface_jit
        return render_particles_and_surface_jit(
            self.state.positions, active,
            mesh.vertices if mesh else None,
            mesh.normals if mesh else None,
            mesh.valid if mesh else None,
            self.camera.mvp(), cfg=self.cfg, width=width, height=height)

    # ------------------------------------------------------------------- io
    def save(self, path: str):
        from tpu_fluid_torch.io.checkpoint import save_checkpoint
        save_checkpoint(path, self.state, self.cfg)
        return self

    @staticmethod
    def load(path: str, device="cuda") -> "Simulation":
        """A Simulation from a checkpoint, its state on `device` (the card
        unless the caller passes "cpu")."""
        from tpu_fluid_torch.io.checkpoint import load_checkpoint
        state, cfg = load_checkpoint(path, device=device)
        return Simulation(cfg=cfg, state=state, device=str(device))

    # ---------------------------------------------------------- diagnostics
    def diagnostics(self):
        return diagnostics(self.state, self.cfg)

    # ------------------------------------------------------------- run loop
    def run(self, n_steps: int, frame_every: int = 0,
            frame_dir: str = "out", width: int = 1024, height: int = 1024,
            log_every: int = 0, checkpoint_every: int = 0,
            checkpoint_path: str = "out/checkpoint.npz",
            on_frame: Optional[Callable] = None,
            video_path: Optional[str] = None, video_fps: int = 25,
            orbit_deg_per_frame: float = 0.0,
            save_frames: bool = True,
            render_method: str = "splat",
            mesh_every: int = 0, mesh_dir: Optional[str] = None,
            serve_port: Optional[int] = None,
            serve_host: str = "127.0.0.1"):
        """The headless main loop (also what the CLI drives).

        With `video_path`, every rendered frame is also collected into a
        video written at the end (.mp4 via OpenCV, or animated GIF by
        extension) — the headless counterpart of the reference's
        real-time window + demo video (`README.md:49-55`).
        `orbit_deg_per_frame` rotates the camera about the scene center
        between frames.  `mesh_every` dumps the marching-cubes surface as
        OBJ into `mesh_dir` (default `frame_dir`).  `serve_port` starts
        the live HTTP viewer (render/live.py): frames stream as MJPEG and
        browser keys drive pause/camera/toggles — the reference's
        interactive window (`main.cpp:152-166`), headless.  While paused,
        the loop keeps rendering (reference pause semantics) without
        stepping.
        """
        from tpu_fluid_torch.render.export import (write_obj, write_png,
                                                   write_video)
        center = tuple(g / 2.0 for g in self.cfg.grid_size)
        viewer = None
        if serve_port is not None:
            from tpu_fluid_torch.render.live import LiveViewer
            viewer = LiveViewer(self, port=serve_port,
                                host=serve_host).start()
            print(f"live viewer: http://localhost:{viewer.port}/",
                  flush=True)
        frames = []
        done = 0
        while done < n_steps:
            if self.paused:
                if viewer is None:
                    # Headless pause: nothing can ever unpause us (keys only
                    # arrive through the live viewer), so return with the
                    # remaining step budget UNCONSUMED — resume() and call
                    # run() again.
                    print(f"run(): paused with no live viewer — returning "
                          f"with {n_steps - done} steps unconsumed",
                          flush=True)
                    break
                import time as _time
                viewer.push(to_host(self.render_frame(width, height,
                                                    method=render_method)))
                if self.paused_render_interval > 0.0:
                    _time.sleep(self.paused_render_interval)
                continue
            chunk = n_steps - done
            for cadence in (frame_every, log_every, checkpoint_every,
                            mesh_every):
                if cadence:
                    chunk = min(chunk, cadence - (done % cadence) or cadence)
            done += self._step_counted(chunk)
            if log_every and done % log_every == 0:
                print(format_diagnostics(self.diagnostics()), flush=True)
            if frame_every and done % frame_every == 0:
                if orbit_deg_per_frame:
                    self.camera = self.camera.orbit(orbit_deg_per_frame,
                                                    center)
                img = to_host(self.render_frame(width, height,
                                              method=render_method))
                if viewer is not None:
                    viewer.push(img)
                if video_path:
                    frames.append(img)
                if save_frames:
                    path = os.path.join(frame_dir, f"frame_{done:06d}.png")
                    write_png(path, img)
                    if on_frame:
                        on_frame(path, img)
            if mesh_every and done % mesh_every == 0:
                from tpu_fluid_torch.surface.marching_cubes import \
                    mesh_to_numpy
                tris, normals = mesh_to_numpy(self.surface_mesh())
                path = os.path.join(mesh_dir or frame_dir,
                                    f"mesh_{done:06d}.obj")
                write_obj(path, tris, normals)
                print(f"wrote {path} ({len(tris)} triangles)", flush=True)
            if checkpoint_every and done % checkpoint_every == 0:
                self.save(checkpoint_path)
        if video_path and frames:
            write_video(video_path, frames, fps=video_fps)
            print(f"wrote {video_path} ({len(frames)} frames)", flush=True)
        return self
