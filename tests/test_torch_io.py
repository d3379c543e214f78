"""Checkpoints of the PyTorch port (`tpu_fluid_torch/io/checkpoint.py`)
against the JAX package's (`tpu_fluid/io/checkpoint.py`): either package
loads a file the other wrote, every field bitwise and the config equal;
an older file (no `dropped`, int32 inertia) loads; a nested config comes
back hashable; a loaded state steps as the state it was saved from."""

import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

from test_torch_step import KW
from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid.core.state import FluidState as JaxState
from tpu_fluid.io.checkpoint import load_checkpoint as jax_load
from tpu_fluid.io.checkpoint import save_checkpoint as jax_save
from tpu_fluid_torch import FluidConfig, initial_state, step
from tpu_fluid_torch.core.state import state_from_numpy, state_to_numpy
from tpu_fluid_torch.io.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(2)

CFG = FluidConfig(**{**KW, "jacobi_iters": 20})
NESTED = dict(solid_boxes=(((2, 2, 2), (4, 4, 4)),),
              extra_forces=(((6, 9, 6), (0.0, -100.0, 0.0)),))


def stepped_state(cfg, n=2):
    state = initial_state(cfg, device="cpu")
    for _ in range(n):
        state = step(state, cfg)
    return state


def jax_state(arrays: dict) -> JaxState:
    import jax.numpy as jnp
    return JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def assert_arrays_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def as_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("extra", [{}, NESTED, {"max_inertia": 300}],
                         ids=["default", "nested", "int32_inertia"])
def test_jax_checkpoint_loads_into_port(tmp_path, extra):
    cfg = CFG.replace(**extra)
    arrays = state_to_numpy(stepped_state(cfg))
    path = str(tmp_path / "jax.npz")
    jax_save(path, jax_state(arrays), JaxConfig(**as_dict(cfg)))
    state, got = load_checkpoint(path, device="cpu")
    assert got == cfg
    hash(got)
    assert state.velocity.device == torch.device("cpu")
    assert_arrays_equal(state_to_numpy(state), arrays)


@pytest.mark.parametrize("extra", [{}, NESTED, {"max_inertia": 300}],
                         ids=["default", "nested", "int32_inertia"])
def test_port_checkpoint_loads_into_jax(tmp_path, extra):
    cfg = CFG.replace(**extra)
    state = stepped_state(cfg)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, state, cfg)
    assert not (tmp_path / "port.npz.tmp.npz").exists()
    jstate, jcfg = jax_load(path)
    assert as_dict(jcfg) == as_dict(cfg)
    hash(jcfg)
    assert_arrays_equal({k: np.asarray(v) for k, v in
                         jstate._asdict().items()}, state_to_numpy(state))


def test_file_without_dropped_and_with_int32_inertia_loads(tmp_path):
    """A file from before `dropped` existed and before inertia narrowed to
    u8: `dropped` loads as 0, inertia as cfg.inertia_dtype, equal
    values."""
    arrays = state_to_numpy(stepped_state(CFG))
    old = {k: v for k, v in arrays.items() if k != "dropped"}
    old["inertia"] = old["inertia"].astype(np.int32)
    meta = json.dumps({"version": 1, "config": as_dict(CFG)})
    path = tmp_path / "old.npz"
    np.savez_compressed(path, __meta__=np.frombuffer(meta.encode(),
                                                     dtype=np.uint8), **old)
    state, cfg = load_checkpoint(str(path), device="cpu")
    assert cfg == CFG
    assert state.dropped.dtype == torch.int32 and state.dropped.shape == ()
    assert int(state.dropped) == 0
    assert state.inertia.dtype == torch.uint8
    assert_arrays_equal(state_to_numpy(state), arrays)


def test_unknown_version_raises(tmp_path):
    meta = json.dumps({"version": 2, "config": as_dict(CFG)})
    path = tmp_path / "v2.npz"
    np.savez_compressed(path, __meta__=np.frombuffer(meta.encode(),
                                                     dtype=np.uint8))
    with pytest.raises(ValueError, match="unknown checkpoint version"):
        load_checkpoint(str(path), device="cpu")


def test_nested_config_round_trips_hashable(tmp_path):
    cfg = CFG.replace(**NESTED)
    path = str(tmp_path / "nested.npz")
    save_checkpoint(path, stepped_state(cfg, 1), cfg)
    state, got = load_checkpoint(path, device="cpu")
    assert got == cfg and hash(got) == hash(cfg)
    assert isinstance(got.solid_boxes[0][0], tuple)
    step(state, got)                 # the config keys the step's caches


def test_loaded_state_steps_bitwise(tmp_path):
    """A loaded state steps bitwise as a port state made by
    `state_from_numpy` of the same arrays."""
    arrays = state_to_numpy(stepped_state(CFG))
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, state_from_numpy(arrays, device="cpu"), CFG)
    loaded, cfg = load_checkpoint(path, device="cpu")
    a, b = loaded, state_from_numpy(arrays, device="cpu")
    for _ in range(2):
        a, b = step(a, cfg), step(b, CFG)
    assert_arrays_equal(state_to_numpy(a), state_to_numpy(b))


def test_load_defaults_to_the_card(tmp_path):
    assert inspect.signature(load_checkpoint).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        path = str(tmp_path / "ck.npz")
        save_checkpoint(path, initial_state(CFG, device="cpu"), CFG)
        with pytest.raises((AssertionError, RuntimeError)):
            load_checkpoint(path)
