"""The engine, diagnostics, live viewer and CLI of the PyTorch port
(`tpu_fluid_torch/engine.py`, `utils/diagnostics.py`, `render/live.py`,
`cli.py`) on the CPU: mirrors of tests/test_engine.py and
tests/test_live_viewer.py, `diagnostics` against the JAX package's (the
integer and max keys exact, the mean within 1e-6 relative), the engine's
steps against the port's `step` bitwise, `config_from_args` against the
JAX CLI's on the same argv, and the facade's entry points defaulting to
the card."""

import inspect
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from tpu_fluid_torch import FluidConfig, Simulation, initial_state, step
from tpu_fluid_torch import cli
from tpu_fluid_torch.core.state import state_to_numpy
from tpu_fluid_torch.render.live import LiveViewer
from tpu_fluid_torch.utils.diagnostics import (diagnostics,
                                               format_diagnostics)

torch.set_num_threads(2)

CFG = FluidConfig(
    grid_size=(12, 12, 12),
    particle_count=4000,
    particle_init_cube_resolution=(16, 16, 16),
    particle_init_cube_offset=(3.0, 1.5, 1.0),
    particle_init_cube_size=(6.0, 6.0, 1.5),
    surface_render_resolution=2,
    jacobi_iters=40,
)


def cpu_sim(cfg=CFG, **kw) -> Simulation:
    return Simulation(cfg=cfg, device="cpu", **kw)


def clone(state):
    return type(state)(*(t.clone() for t in state))


def assert_states_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.fixture(scope="module")
def sim():
    return cpu_sim().step(12)


# ------------------------------------------- mirrors of test_engine.py
def test_pause_resume(sim):
    s0 = int(sim.state.step)
    sim.pause().step(5)
    assert int(sim.state.step) == s0
    sim.resume().step(1)
    assert int(sim.state.step) == s0 + 1


def test_run_paused_headless_returns_budget_unconsumed(capsys):
    s = cpu_sim()
    s.pause()
    s.run(5, save_frames=False)
    assert int(s.state.step) == 0
    assert "unconsumed" in capsys.readouterr().out
    s.resume()
    s.run(2, save_frames=False)
    assert int(s.state.step) == 2


def test_run_pause_landing_mid_flight_does_not_burn_budget(capsys,
                                                           monkeypatch):
    import tpu_fluid_torch.engine as engine_mod

    s = cpu_sim()
    s.dispatch_chunk = 1
    real = engine_mod.jit_step

    def pausing_step(state, cfg, scene):
        out = real(state, cfg, scene)
        s.pause()
        return out

    monkeypatch.setattr(engine_mod, "jit_step", pausing_step)
    s.run(5, save_frames=False)
    assert int(s.state.step) == 1
    assert "4 steps unconsumed" in capsys.readouterr().out
    monkeypatch.setattr(engine_mod, "jit_step", real)
    s.resume()
    s.run(2, save_frames=False)
    assert int(s.state.step) == 3


def test_run_paused_with_viewer_keeps_rendering_without_stepping():
    s = cpu_sim()
    s.pause()
    done = threading.Event()

    def go():
        s.run(2, frame_every=1, save_frames=False, serve_port=0,
              width=64, height=64)
        done.set()

    t = threading.Thread(target=go, daemon=True)
    t.start()
    time.sleep(3.0)
    assert t.is_alive()
    assert int(s.state.step) == 0
    s.resume()
    assert done.wait(120)
    assert int(s.state.step) == 2


def test_paused_render_interval_is_configurable(monkeypatch):
    assert cpu_sim().paused_render_interval == 0.25
    s = cpu_sim()
    s.paused_render_interval = 0.07
    s.pause()
    sleeps = []
    real_sleep = time.sleep

    def recording_sleep(d):
        sleeps.append(d)
        real_sleep(min(d, 0.07))

    monkeypatch.setattr(time, "sleep", recording_sleep)
    done = threading.Event()

    def go():
        s.run(1, frame_every=1, save_frames=False, serve_port=0,
              width=32, height=32)
        done.set()

    t = threading.Thread(target=go, daemon=True)
    t.start()
    deadline = time.time() + 60
    while (not any(abs(d - 0.07) < 1e-9 for d in sleeps)
           and time.time() < deadline):
        real_sleep(0.05)
    assert any(abs(d - 0.07) < 1e-9 for d in sleeps)
    s.resume()
    assert done.wait(120)
    assert int(s.state.step) == 1


def test_diagnostics(sim):
    d = sim.diagnostics()
    assert d["particles_active"] == 4000
    assert d["cells_solid"] > 0 and d["cells_water"] > 0
    assert 0 <= d["inertia_max"] <= CFG.max_inertia
    assert d["pos_min"] > 0 and d["pos_max"] < 12


def test_checkpoint_roundtrip(tmp_path, sim):
    path = str(tmp_path / "ck.npz")
    sim.save(path)
    sim2 = Simulation.load(path, device="cpu")
    assert sim2.cfg == sim.cfg
    assert_states_equal(sim2.state, sim.state)
    # the resumed sim steps as the original (cloned: on the card the
    # graphed step overwrites the state it was given)
    a = sim2.step(2).state
    b = cpu_sim(state=clone(sim.state)).step(2).state
    assert_states_equal(a, b)


def test_surface_mesh(sim):
    mesh = sim.surface_mesh()
    n = int(mesh.count)
    assert n > 0
    tris = mesh.vertices.numpy()[mesh.valid.numpy()]
    assert len(tris) == n
    assert tris.min() >= 0.0 and tris.max() <= 12.0


def test_render_frame(sim):
    img = sim.render_frame(128, 128).numpy()
    assert img.shape == (128, 128, 3)
    assert img.dtype == np.uint8
    assert (img != 0).any()
    assert img.max() > 50


@pytest.mark.slow
def test_render_toggles(sim):
    sim.render_surface = False
    img_p = sim.render_frame(96, 96).numpy()
    sim.render_particles = False
    img_none = sim.render_frame(96, 96).numpy()
    sim.render_surface = True
    img_s = sim.render_frame(96, 96).numpy()
    sim.render_particles = True
    assert (img_none == 0).all()
    assert (img_p != img_s).any()


def test_obj_export(tmp_path, sim):
    from tpu_fluid_torch.render.export import write_obj
    from tpu_fluid_torch.surface.marching_cubes import mesh_to_numpy
    tris, normals = mesh_to_numpy(sim.surface_mesh())
    path = str(tmp_path / "m.obj")
    write_obj(path, tris, normals)
    text = open(path).read()
    assert text.count("\nf ") == len(tris)
    assert text.count("v ") >= 3 * len(tris)


def test_video_export(tmp_path):
    from tpu_fluid_torch.render.export import write_video
    frames = [np.full((48, 64, 3), i * 40, np.uint8) for i in range(5)]
    mp4 = str(tmp_path / "v.mp4")
    gif = str(tmp_path / "v.gif")
    write_video(mp4, frames, fps=10)
    write_video(gif, frames, fps=10)
    assert os.path.getsize(gif) > 100
    import cv2
    cap = cv2.VideoCapture(mp4)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == 64
    assert int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == 48
    cap.release()


@pytest.mark.slow
def test_cli_smoke(tmp_path):
    out = str(tmp_path / "out")
    rc = cli.main(["--device", "cpu", "--grid", "12", "--particles", "2000",
                   "--jacobi-iters", "20", "--steps", "6",
                   "--frame-every", "3", "--mesh-every", "6",
                   "--log-every", "3", "--checkpoint-every", "6",
                   "--width", "64", "--height", "64", "--out", out])
    assert rc == 0
    files = os.listdir(out)
    assert "frame_000003.png" in files and "frame_000006.png" in files
    assert "mesh_000006.obj" in files
    assert "checkpoint.npz" in files
    rc = cli.main(["--device", "cpu", "--resume",
                   os.path.join(out, "checkpoint.npz"), "--steps", "2",
                   "--out", out])
    assert rc == 0


def test_checkpoint_roundtrip_nested_config(tmp_path):
    cfg = CFG.replace(solid_boxes=(((2, 2, 2), (4, 4, 4)),),
                      extra_forces=(((6, 9, 6), (0.0, -100.0, 0.0)),))
    s = cpu_sim(cfg).step(2)
    path = str(tmp_path / "ck_nested.npz")
    s.save(path)
    sim2 = Simulation.load(path, device="cpu")
    assert sim2.cfg == cfg
    hash(sim2.cfg)
    sim2.step(2)
    assert int(sim2.state.step) == 4


def test_cli_set_rejects_bad_tuple_values():
    args = cli.build_parser().parse_args(
        ["--grid", "12", "--set", "fountain_position=nonsense"])
    with pytest.raises(SystemExit):
        cli.config_from_args(args)
    args = cli.build_parser().parse_args(
        ["--grid", "12", "--set", "fountain_position=1,2,3"])
    assert cli.config_from_args(args).fountain_position == (1, 2, 3)
    args = cli.build_parser().parse_args(
        ["--grid", "12", "--set", "solid_boxes=[[[2,2,2],[4,4,4]]]"])
    assert cli.config_from_args(args).solid_boxes == \
        (((2, 2, 2), (4, 4, 4)),)


def test_cli_set_none_default_scalar_fields():
    args = cli.build_parser().parse_args(
        ["--grid", "12", "--set", "levelset_iso=2.5",
         "--set", "levelset_sweeps=7",
         "--set", "volume_target_density=8.0"])
    cfg = cli.config_from_args(args)
    assert cfg.levelset_iso == 2.5
    assert cfg.levelset_sweeps == 7
    assert cfg.volume_target_density == 8.0
    args = cli.build_parser().parse_args(
        ["--grid", "12", "--set", "levelset_iso=none"])
    assert cli.config_from_args(args).levelset_iso is None


def test_cli_nested_config_overrides(tmp_path):
    out = str(tmp_path / "o")
    rc = cli.main(["--device", "cpu", "--grid", "12", "--particles",
                   "1000", "--jacobi-iters", "10", "--steps", "2",
                   "--out", out,
                   "--set", "solid_boxes=[[[4,4,4],[8,6,8]]]",
                   "--set", "extra_forces=[[[6,9,6],[0,-100,0]]]"])
    assert rc == 0


# -------------------------------------- mirrors of test_live_viewer.py
@pytest.fixture()
def viewer():
    cfg = FluidConfig.scaled_scene(8, particle_count=64, jacobi_iters=1)
    v = LiveViewer(cpu_sim(cfg), port=0).start()
    yield v
    v.stop()


def _get(v, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{v.port}{path}",
                                  timeout=10)


def test_page_and_state(viewer):
    assert b"/stream" in _get(viewer, "/").read()
    st = json.loads(_get(viewer, "/state").read())
    assert st == {"paused": False, "surface": True, "particles": True,
                  "frames": 0}


def test_keys_drive_simulation(viewer):
    sim = viewer.sim
    _get(viewer, "/key?k=q")
    assert sim.paused
    _get(viewer, "/key?k=e")
    assert not sim.paused
    _get(viewer, "/key?k=r")
    assert not sim.render_surface
    _get(viewer, "/key?k=f")
    assert sim.render_surface
    _get(viewer, "/key?k=p")
    assert not sim.render_particles
    pos0 = np.asarray(sim.camera.position)
    _get(viewer, "/key?k=a")
    assert not np.allclose(np.asarray(sim.camera.position), pos0)
    _get(viewer, "/key?k=w")
    c = np.asarray(sim.cfg.grid_size) / 2.0
    assert (np.linalg.norm(np.asarray(sim.camera.position) - c)
            < np.linalg.norm(pos0 - c) + 2.1)


def test_translation_keys(viewer):
    sim = viewer.sim
    pos0 = np.asarray(sim.camera.position, dtype=np.float64)
    dir0 = np.asarray(sim.camera.direction, dtype=np.float64)
    _get(viewer, "/key?k=ArrowRight")
    pos1 = np.asarray(sim.camera.position, dtype=np.float64)
    assert not np.allclose(pos1, pos0)
    np.testing.assert_allclose(np.asarray(sim.camera.direction), dir0)
    assert abs(np.dot(pos1 - pos0, dir0 / np.linalg.norm(dir0))) < 1e-9
    _get(viewer, "/key?k=ArrowLeft")
    np.testing.assert_allclose(np.asarray(sim.camera.position), pos0)
    _get(viewer, "/key?k=%20")
    assert np.asarray(sim.camera.position, dtype=np.float64)[1] < pos0[1]
    _get(viewer, "/key?k=Shift")
    np.testing.assert_allclose(np.asarray(sim.camera.position), pos0)


def test_binds_loopback_by_default():
    cfg = FluidConfig.scaled_scene(8, particle_count=64, jacobi_iters=1)
    v = LiveViewer(cpu_sim(cfg), port=0).start()
    try:
        assert v._server.server_address[0] == "127.0.0.1"
    finally:
        v.stop()


def test_stream_delivers_pushed_frame(viewer):
    img = np.zeros((16, 16, 3), np.uint8)
    img[4:12, 4:12] = 200
    resp = _get(viewer, "/stream")
    viewer.push(torch.from_numpy(img))
    head = resp.read(64)
    assert b"--frame" in head and b"image/jpeg" in head
    body = resp.read(512)
    assert b"\xff\xd8" in head + body


# --------------------------------------------------- against JAX, port
def test_diagnostics_match_jax(sim):
    """Integer and max keys exact (the max keys are f32 values that both
    packages read unrounded); the mean within 1e-6 relative (sums in
    another order)."""
    from tpu_fluid.core.config import FluidConfig as JaxConfig
    from tpu_fluid.utils.diagnostics import diagnostics as jax_diagnostics
    import jax.numpy as jnp
    from tpu_fluid.core.state import FluidState as JaxState
    arrays = state_to_numpy(sim.state)
    want = jax_diagnostics(JaxState(**{k: jnp.asarray(v)
                                       for k, v in arrays.items()}),
                           JaxConfig(**{f: getattr(CFG, f)
                                        for f in CFG.__dataclass_fields__}))
    got = diagnostics(sim.state, CFG)
    assert set(got) == set(want) and len(got) == 13
    for key in want:
        if key == "div_water_mean":
            assert got[key] == pytest.approx(want[key], rel=1e-6), key
        else:
            assert got[key] == want[key], key
    assert format_diagnostics(got) == format_diagnostics(want)


def test_engine_steps_equal_port_steps():
    """Simulation(cfg, device="cpu").step(n) equals n port steps
    bitwise, in chunks that do not divide n."""
    s = cpu_sim(dispatch_chunk=3).step(7)
    state = initial_state(CFG, device="cpu")
    for _ in range(7):
        state = step(state, CFG)
    assert_states_equal(s.state, state)
    assert s._pending == []          # no events on the CPU


ARGVS = {
    "reference": [],
    "grid": ["--grid", "24", "--particles", "5000", "--jacobi-iters", "30",
             "--surface-resolution", "3", "--dt", "0.02"],
    "scene": ["--scene", "dam_break_obstacle", "--grid", "32",
              "--particles", "8000"],
    "reference_resolution": ["--surface-resolution", "4"],
    "set": ["--grid", "16", "--set", "gravity=9.81", "--set",
            "surface_enabled=false", "--set", "fountain_position=3,4,5",
            "--set", "levelset_iso=1.5", "--set", "pressure_solver=redblack"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_config_from_args_equals_jax(name, tmp_path):
    import dataclasses
    from tpu_fluid import cli as jax_cli
    argv = list(ARGVS[name])
    if name == "set":
        path = tmp_path / "over.json"
        path.write_text(json.dumps({"solid_boxes": [[[2, 2, 2], [4, 4, 4]]],
                                    "jacobi_iters": 12}))
        argv += ["--config", str(path)]
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    hash(got)


def test_parser_has_jax_flags_and_device():
    from tpu_fluid import cli as jax_cli

    def flags(parser):
        return {o for a in parser._actions for o in a.option_strings}

    assert flags(cli.build_parser()) == \
        flags(jax_cli.build_parser()) | {"--device"}


def test_cli_cpu_run_writes_outputs(tmp_path, capsys):
    out = str(tmp_path / "run")
    rc = cli.main(["--device", "cpu", "--grid", "8", "--particles", "500",
                   "--jacobi-iters", "5", "--steps", "4", "--frame-every",
                   "2", "--mesh-every", "4", "--checkpoint-every", "4",
                   "--width", "32", "--height", "32", "--out", out])
    assert rc == 0
    files = set(os.listdir(out))
    assert {"frame_000002.png", "frame_000004.png", "mesh_000004.obj",
            "checkpoint.npz"} <= files
    rc = cli.main(["--device", "cpu", "--resume",
                   os.path.join(out, "checkpoint.npz"), "--steps", "2",
                   "--out", out])
    assert rc == 0
    assert "at step 4" in capsys.readouterr().out


def test_facade_entry_points_default_to_the_card():
    """Simulation, Simulation.load, load_checkpoint and the CLI's --device
    default to the card; with no card, a Simulation made without
    device="cpu" raises instead of falling back."""
    from tpu_fluid_torch.io.checkpoint import load_checkpoint
    assert Simulation.__dataclass_fields__["device"].default == "cuda"
    assert inspect.signature(Simulation.load).parameters[
        "device"].default == "cuda"
    assert inspect.signature(load_checkpoint).parameters[
        "device"].default == "cuda"
    assert cli.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            Simulation(cfg=CFG)
