"""Hand-written CUDA kernels for the hot stages, and the gate that picks
between a kernel and its plain PyTorch version.

`kernel_choice(cfg, device)` is the port's counterpart of the JAX package's
`pallas_choice`: it decides by the device the stage's tensors lie on, not by
a backend query.  Every kernel module holds the CUDA wrapper, the plain
version beside it, and a launch counter on the wrapper.
"""

from __future__ import annotations

import torch

# y*z plane above which the JAX package's fused grid kernels stay off
# (`tpu_fluid.kernels._FUSE_GRID_MAX_PLANE`): the TPU kernels hold whole
# planes in VMEM.  The CUDA kernels march 32x32 tiles and have no such
# limit, so it holds only where the plain versions stand in for JAX's.
_FUSE_GRID_MAX_PLANE = 98304


def kernel_choice(cfg, device: torch.device) -> bool:
    """True when a stage on tensors of `device` runs its CUDA kernel.

    pallas_mode "auto" picks the kernel exactly for CUDA tensors; "off" and
    "interpret" pick the plain version; "on" picks the kernel and raises for
    tensors that are not on a CUDA device."""
    mode = getattr(cfg, "pallas_mode", "auto")
    device = torch.device(device)
    if mode in ("off", "interpret"):
        return False
    if mode == "on":
        if device.type != "cuda":
            raise RuntimeError(
                f"pallas_mode='on' needs CUDA tensors, got {device}")
        return True
    if mode == "auto":
        return device.type == "cuda"
    raise ValueError(f"unknown pallas_mode {mode!r}")


def require(t: torch.Tensor, name: str, dtype, shape=None,
            device=None) -> None:
    """Raise unless `t` has the dtype, shape, device and contiguity a
    kernel wrapper takes."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def store(values, out):
    """`values`, a tensor or a tuple of them, each copied into its tensor
    of `out` where one is given (a None entry keeps its value): how a
    plain version, or a stage whose last op has no `out=`, honours the
    `out=` its caller gives.  Returns the tensors that hold the result."""
    if out is None:
        return values
    if not isinstance(values, tuple):
        return _store(values, out)
    if len(out) != len(values):
        raise ValueError(f"out: {len(out)} tensors for {len(values)} "
                         f"results")
    return tuple(v if o is None else _store(v, o)
                 for v, o in zip(values, out))


def _store(value: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    require(out, "out", value.dtype, value.shape, value.device)
    if out is not value:
        out.copy_(value)
    return out


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one (the wrapper then runs
    the plain version); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def fuse_grid_choice(cfg, device: torch.device, scene=None) -> bool:
    """The JAX package's gate for its fused grid kernels (stages 02-06,
    08-11 and 13), answer for answer: the kernels are in use ("on" and
    "interpret" always, "auto" for CUDA tensors where JAX's "auto" asks for
    a TPU), the config opts in, stage 09 is the no-op, no scene fields,
    and the y*z plane is at most `_FUSE_GRID_MAX_PLANE`, except where the
    CUDA kernels run ("on" and "auto" for CUDA tensors), which take any
    plane.  Where it is True the step runs K6 (`kernels/grid_fused.py`):
    the CUDA kernels where `kernel_choice` picks them, else their plain
    versions."""
    mode = getattr(cfg, "pallas_mode", "auto")
    on_card = torch.device(device).type == "cuda"
    if mode == "off":
        use = False
    elif mode in ("on", "interpret"):
        use = True
    else:
        use = on_card
    cuda_kernels = on_card and mode in ("on", "auto")
    return (use and cfg.grid_fused and cfg.reference_diffuse_noop
            and scene is None
            and (cuda_kernels or cfg.grid_size[1] * cfg.grid_size[2]
                 <= _FUSE_GRID_MAX_PLANE))
