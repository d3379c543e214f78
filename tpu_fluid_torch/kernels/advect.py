"""K1: stage-07 semi-Lagrangian advection of all three MAC components.

Replaces `tpu_fluid/kernels/advect.py:advect_all_pallas` (kernel
`_advect_all_kernel`, body `_advect_comps`); CUDA source
`csrc/advect.cu`.  The TPU kernel sums (2R+1)^3 masked terms over an
edge-replicated VMEM slab because Mosaic cannot gather; the card gathers,
so the kernel reads only the 8 taps that carry weight, in the same
ascending order, and agrees with the masked sum bitwise.  On the card it is
bound by the scattered 4-byte reads (about 20 per output), which the 50 MB
L2 absorbs at 128^3 (24 MB of velocity): one thread per output keeps the
reads of a warp on neighbouring z.

K1 also covers two TPU tiling variants of the same function, which differ
only in how they cut VMEM: `advect_one_pallas` (`advect.py:244`), which
JAX runs one component per call for y*z planes above 128^2 (tx = 2 at
256^3), and `advect_component_pallas` (`advect.py:369`), its fallback from
a precomputed displacement field.  K1 indexes with `long long` and has no
plane limit; tests/test_torch_kernels.py holds both variants against
`advect_all_plain` component by component.

`advect_all_plain` is the same function in plain PyTorch, in the masked-sum
order of `tpu_fluid.stages.velocity.advect_shift`.
"""

from __future__ import annotations

import torch

from tpu_fluid_torch.kernels import build, on_cuda, require
from tpu_fluid_torch.ops.packed_sampler import _edge_shift

_ARGTYPES = (build.POINTER, build.POINTER, build.POINTER, build.INT,
             build.INT, build.INT, build.INT, build.FLOAT, build.FLOAT,
             build.FLOAT, build.POINTER)


def face_center_velocity(vel: torch.Tensor, c: int) -> torch.Tensor:
    """Full velocity vector at every face centre of component c — the
    first, grid-aligned sample of `advect.comp:74-78`: component c is the
    stored value, each other component c' the 4-point average over
    {i_c-1, i_c} x {i_c', i_c'+1} with clamp-to-edge."""
    comps = []
    for cp in range(3):
        if cp == c:
            comps.append(vel[c])
            continue
        acc = torch.zeros_like(vel[cp])
        for dc in (-1, 0):
            for dcp in (0, 1):
                off = [0, 0, 0]
                off[c] = dc
                off[cp] = dcp
                acc = acc + _edge_shift(vel[cp], tuple(off))
        comps.append(0.25 * acc)
    return torch.stack(comps)


def _edge_pad(a: torch.Tensor, r: int) -> torch.Tensor:
    """Pad all three axes by r with edge replication."""
    for ax in range(3):
        n = a.shape[ax]
        idx = torch.clamp(torch.arange(-r, n + r, device=a.device), 0, n - 1)
        a = a.index_select(ax, idx)
    return a


def advect_all_plain(vel: torch.Tensor, cond3: torch.Tensor, r: int,
                     dt: float) -> torch.Tensor:
    """vel (3,X,Y,Z) f32, cond3 (3,X,Y,Z) u8 -> advected velocity: the
    backtraced point of component c at cell i is t = i - v_face*dt in
    texel space, the displacement clamped to [-R, R-1e-4] and the point to
    the grid, sampled as a hat-weighted sum over all |delta| <= R."""
    shape = tuple(vel.shape[1:])
    out = []
    for c in range(3):
        u = -face_center_velocity(vel, c) * dt
        u = torch.clamp(u, -r, r - 1e-4)
        axes = []
        for d in range(3):
            n = shape[d]
            i_d = torch.arange(n, dtype=vel.dtype, device=vel.device).reshape(
                tuple(-1 if k == d else 1 for k in range(3)))
            t_d = torch.clamp(i_d + u[d], 0.0, n - 1.0)
            u_d = t_d - i_d
            o_d = torch.floor(u_d)
            f_d = u_d - o_d
            axes.append([(o_d == delta) * (1.0 - f_d)
                         + (o_d == delta - 1) * f_d
                         for delta in range(-r, r + 1)])
        wx, wy, wz = axes
        padded = _edge_pad(vel[c], r)
        gx, gy, gz = shape
        acc = torch.zeros_like(vel[c])
        for ax, dxo in enumerate(range(-r, r + 1)):
            for ay, dyo in enumerate(range(-r, r + 1)):
                wxy = wx[ax] * wy[ay]
                for az, dzo in enumerate(range(-r, r + 1)):
                    sl = padded[r + dxo:r + dxo + gx,
                                r + dyo:r + dyo + gy,
                                r + dzo:r + dzo + gz]
                    acc = acc + (wxy * wz[az]) * sl
        out.append(torch.where(cond3[c] != 0, acc, vel[c]))
    return torch.stack(out)


def advect_all_cuda(vel: torch.Tensor, cond3: torch.Tensor, r: int,
                    dt: float) -> torch.Tensor:
    """K1 wrapper: the CUDA kernel for CUDA tensors, `advect_all_plain`
    for CPU tensors."""
    require(vel, "vel", torch.float32)
    if vel.ndim != 4 or vel.shape[0] != 3:
        raise ValueError(f"vel: shape {tuple(vel.shape)}, expected (3,X,Y,Z)")
    require(cond3, "cond3", torch.uint8, vel.shape, vel.device)
    if r < 1:
        raise ValueError(f"advect_max_displacement {r} must be >= 1")
    if not on_cuda(vel):
        return advect_all_plain(vel, cond3, r, dt)
    out = torch.empty_like(vel)
    _, gx, gy, gz = vel.shape
    with torch.cuda.device(vel.device):
        stream = torch.cuda.current_stream(vel.device).cuda_stream
        build.call("tf_advect_all", _ARGTYPES, vel.data_ptr(),
                   cond3.data_ptr(), out.data_ptr(), gx, gy, gz, r, dt,
                   float(-r), r - 1e-4, stream)
    advect_all_cuda.launches += 1
    return out


advect_all_cuda.launches = 0
