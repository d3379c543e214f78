"""K2: Jacobi pressure sweeps on the water-masked pressure.

Replaces `tpu_fluid/kernels/jacobi.py:_whole_grid_jacobi` (kernel
`_whole_grid_kernel`, reached by `jacobi_sweeps_pallas` for grids of up to
128^3 cells); CUDA source `csrc/jacobi.cu`.  One sweep is
q' = rd * (sum of the 6 zero-padded neighbours, x+1, x-1, y+1, y-1, z+1,
z-1) + c2e, with rd decoded from the u8 aii code and c2e = where(rd > 0,
c2, q0) folded once (`stages/pressure.poisson_solve` builds the inputs).
The TPU kernel holds the whole grid in VMEM for every sweep; the card has
no such memory, but at 128^3 both q buffers, c2e and the code (26 MB) stay
in the 50 MB L2, so each of the one-launch-per-sweep passes is L2-bound,
and at 20^3 the 199 launches themselves are the cost.

K2 also covers the slab branch of `jacobi_sweeps_pallas` (`_one_pass`,
`jacobi.py:263`), which JAX runs above 128^3 cells: k sweeps per pass over
x-slabs with k-row halos, summing in the same order as the whole-grid
kernel.  At 256^3 the working set (two q buffers and c2e at 67 MB each, the
code at 17 MB) no longer fits the L2, so each sweep streams it from HBM;
PERF.md has the time.  tests/test_torch_kernels.py holds the slab branch
against `jacobi_sweeps_plain`.

`jacobi_sweeps_plain` is the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from tpu_fluid_torch.kernels import build, on_cuda, require
from tpu_fluid_torch.ops.stencil import AXIS_MOVES, neighbor_sum

_ARGTYPES = (build.POINTER,) * 6 + (build.INT,) * 4 + (build.POINTER,)


def decode_rd(code: torch.Tensor) -> torch.Tensor:
    """u8 aii code -> f32 reciprocal diagonal: where(code > 0,
    1 / max(code, 1), 0), the integer widened before any arithmetic
    (`tpu_fluid/kernels/jacobi.py:_decode_rd`)."""
    codef = code.to(torch.int32).to(torch.float32)
    return torch.where(codef > 0,
                       torch.ones_like(codef) / torch.clamp(codef, min=1.0),
                       0.0)


def jacobi_sweeps_plain(q0: torch.Tensor, code: torch.Tensor,
                        c2: torch.Tensor, n_iters: int) -> torch.Tensor:
    rd = decode_rd(code)
    c2e = torch.where(rd > 0.0, c2, q0)
    q = q0
    for _ in range(n_iters):
        q = rd * neighbor_sum(q, moves=AXIS_MOVES) + c2e
    return q


def jacobi_sweeps_cuda(q0: torch.Tensor, code: torch.Tensor,
                       c2: torch.Tensor, n_iters: int) -> torch.Tensor:
    """K2 wrapper: n_iters sweeps by the CUDA kernel for CUDA tensors,
    `jacobi_sweeps_plain` for CPU tensors.  q0 and c2 are f32 (X,Y,Z), code
    the u8 aii code of the same shape."""
    require(q0, "q0", torch.float32)
    if q0.ndim != 3:
        raise ValueError(f"q0: shape {tuple(q0.shape)}, expected (X,Y,Z)")
    require(code, "code", torch.uint8, q0.shape, q0.device)
    require(c2, "c2", torch.float32, q0.shape, q0.device)
    if not on_cuda(q0):
        return jacobi_sweeps_plain(q0, code, c2, n_iters)
    c2e = torch.empty_like(q0)
    out = torch.empty_like(q0)
    tmp = torch.empty_like(q0)
    gx, gy, gz = q0.shape
    with torch.cuda.device(q0.device):
        stream = torch.cuda.current_stream(q0.device).cuda_stream
        build.call("tf_jacobi_sweeps", _ARGTYPES, q0.data_ptr(),
                   code.data_ptr(), c2.data_ptr(), c2e.data_ptr(),
                   out.data_ptr(), tmp.data_ptr(), gx, gy, gz, n_iters,
                   stream)
    jacobi_sweeps_cuda.launches += 1
    return out


jacobi_sweeps_cuda.launches = 0
