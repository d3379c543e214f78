"""Checkpoint / resume (`tpu_fluid.io.checkpoint`), in the JAX package's
npz format, so that either package loads a file the other wrote.

The file holds one array per `FluidState` field, named after the field,
and `__meta__`: the u8 bytes of the JSON `{"version": 1, "config":
dataclasses.asdict(cfg)}`.  The write goes to `path + ".tmp"` (numpy
appends ".npz") and then replaces `path`, so a reader never sees half a
file.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from tpu_fluid_torch.core.config import FluidConfig, deep_tuple
from tpu_fluid_torch.core.state import FluidState

_FORMAT_VERSION = 1
# the numpy dtype of each torch dtype `FluidConfig.inertia_dtype` names
_NUMPY_DTYPES = {torch.uint8: np.uint8, torch.int32: np.int32}


def save_checkpoint(path: str, state: FluidState, cfg: FluidConfig) -> None:
    """Write `state` and `cfg` to `path` (copies the state to the host)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {name: value.detach().cpu().numpy()
              for name, value in state._asdict().items()}
    meta = json.dumps({"version": _FORMAT_VERSION,
                       "config": dataclasses.asdict(cfg)})
    tmp = path + ".tmp"
    np.savez_compressed(tmp,
                        __meta__=np.frombuffer(meta.encode(), dtype=np.uint8),
                        **arrays)
    # numpy appends .npz to names without it
    written = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(written, path)


def load_checkpoint(path: str, device="cuda"):
    """Returns (state, cfg), the state's tensors on `device` (the card
    unless the caller passes "cpu")."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unknown checkpoint version {meta['version']}")
        # tuples come back as lists; restore them at every nesting level,
        # or a config with solid_boxes/extra_forces stays unhashable and
        # cannot key the step's graphs and caches
        cfg = FluidConfig(**{k: deep_tuple(v) if isinstance(v, list) else v
                             for k, v in meta["config"].items()})
        # fields added after a checkpoint was written load as their initial
        # value (`dropped` arrived after the format did)
        defaults = {"dropped": np.zeros((), np.int32)}
        # inertia was int32 before it narrowed to cfg.inertia_dtype; values
        # are clamped to max_inertia, so the cast is lossless
        casts = {"inertia": _NUMPY_DTYPES[cfg.inertia_dtype]}
        arrays = {}
        for name in FluidState._fields:
            if name not in data.files:
                arrays[name] = defaults[name]
            elif name in casts:
                arrays[name] = np.asarray(data[name]).astype(casts[name])
            else:
                arrays[name] = data[name]
    device = torch.device(device)
    return FluidState(**{
        name: torch.from_numpy(np.array(value, order="C")).to(device)
        for name, value in arrays.items()}), cfg
