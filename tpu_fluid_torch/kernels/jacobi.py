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

The sharded form replaces `jacobi_sweeps_sharded` (`jacobi.py:367`, the
halo branch of `_one_pass` with `_halo_blocks` and `edges`) in the x-slab
multi-device step.  `jacobi_sweeps_sharded_cuda` runs ceil(n / k) passes:
each exchanges k boundary planes of q with the neighbours and runs
`jacobi_pass_cuda`, k sweeps of the same body on the (lx + 2k)-row slab;
code and c2e exchange their k planes once a solve.  The end shards' zero
planes carry code 0 and stay 0: the single-device zero pad.  The result is
bitwise independent of k, so k trades exchanges against ghost rows:
`SHARDED_K` = 8 gives 25 exchanges for the 199 sweeps of a solve and
(k - 1) / lx = 11% extra rows a sweep at lx = 64.  `jacobi_pass_plain` and
`jacobi_sweeps_sharded_plain` are the plain versions; with k = 1 the
latter exchanges one plane a sweep, as JAX's XLA-path sharded solve does
(`tpu_fluid/parallel/halo.py:jacobi_solve_halo`).
"""

from __future__ import annotations

import torch

from tpu_fluid_torch.kernels import build, on_cuda, require
from tpu_fluid_torch.ops.stencil import AXIS_MOVES, neighbor_sum
from tpu_fluid_torch.parallel.halo import halo_extend

_ARGTYPES = (build.POINTER,) * 6 + (build.INT,) * 4 + (build.POINTER,)
_PASS_ARGTYPES = (build.POINTER,) * 5 + (build.INT,) * 5 + (build.POINTER,)

# Sweeps per pass (and planes per exchange) of the sharded solve.
SHARDED_K = 8


def decode_rd(code: torch.Tensor) -> torch.Tensor:
    """u8 aii code -> f32 reciprocal diagonal: where(code > 0,
    1 / max(code, 1), 0), the integer widened before any arithmetic
    (`tpu_fluid/kernels/jacobi.py:_decode_rd`)."""
    codef = code.to(torch.int32).to(torch.float32)
    return torch.where(codef > 0,
                       torch.ones_like(codef) / torch.clamp(codef, min=1.0),
                       0.0)


def fold_c2e(q0: torch.Tensor, code: torch.Tensor,
             c2: torch.Tensor) -> torch.Tensor:
    """c2e = where(rd > 0, c2, q0): the constant a sweep adds, which holds
    the cells that do not update at q0."""
    return torch.where(code > 0, c2, q0)


def jacobi_sweeps_plain(q0: torch.Tensor, code: torch.Tensor,
                        c2: torch.Tensor, n_iters: int) -> torch.Tensor:
    rd = decode_rd(code)
    c2e = fold_c2e(q0, code, c2)
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


# ------------------------------------------------------------------ sharded
def jacobi_pass_plain(q: torch.Tensor, code: torch.Tensor, c2e: torch.Tensor,
                      h: int, kk: int) -> torch.Tensor:
    """kk <= h sweeps on an x-slab extended by h planes a side (q, code
    and c2e all (lx + 2h, Y, Z)); returns the (lx, Y, Z) interior."""
    rd = decode_rd(code)
    for _ in range(kk):
        q = rd * neighbor_sum(q, moves=AXIS_MOVES) + c2e
    return q[h:q.shape[0] - h]


def jacobi_pass_cuda(q: torch.Tensor, code: torch.Tensor, c2e: torch.Tensor,
                     h: int, kk: int) -> torch.Tensor:
    """K2 sharded-pass wrapper (arguments as `jacobi_pass_plain`): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  The result
    is a view of the interior rows of an extended buffer."""
    require(q, "q", torch.float32)
    if q.ndim != 3:
        raise ValueError(f"q: shape {tuple(q.shape)}, expected (X,Y,Z)")
    require(code, "code", torch.uint8, q.shape, q.device)
    require(c2e, "c2e", torch.float32, q.shape, q.device)
    if not 1 <= kk <= h or q.shape[0] <= 2 * h:
        raise ValueError(f"{kk} sweeps on a slab of {q.shape[0]} rows "
                         f"with {h}-plane halos")
    if not on_cuda(q):
        return jacobi_pass_plain(q, code, c2e, h, kk)
    out = torch.empty_like(q)
    tmp = torch.empty_like(q)
    nx, gy, gz = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.call("tf_jacobi_pass", _PASS_ARGTYPES, q.data_ptr(),
                   code.data_ptr(), c2e.data_ptr(), out.data_ptr(),
                   tmp.data_ptr(), nx, gy, gz, h, kk, stream)
    jacobi_pass_cuda.launches += 1
    return out[h:nx - h]


jacobi_pass_cuda.launches = 0


def _sweeps_sharded(one_pass, q0, code, c2, n_iters, mesh, k):
    k = min(SHARDED_K if k is None else k, q0.shape[0])
    code_e = halo_extend(code, k, mesh)
    c2e_e = halo_extend(fold_c2e(q0, code, c2), k, mesh)
    q = q0
    for done in range(0, n_iters, k):
        q = one_pass(halo_extend(q, k, mesh), code_e, c2e_e, k,
                     min(k, n_iters - done))
    return q


def jacobi_sweeps_sharded_plain(q0: torch.Tensor, code: torch.Tensor,
                                c2: torch.Tensor, n_iters: int, mesh,
                                k: int | None = None) -> torch.Tensor:
    """n_iters sweeps on this shard's (lx, Y, Z) slab of the folded inputs,
    k planes exchanged a pass (at most lx; `SHARDED_K` by default)."""
    return _sweeps_sharded(jacobi_pass_plain, q0, code, c2, n_iters, mesh, k)


def jacobi_sweeps_sharded_cuda(q0: torch.Tensor, code: torch.Tensor,
                               c2: torch.Tensor, n_iters: int, mesh,
                               k: int | None = None) -> torch.Tensor:
    """`jacobi_sweeps_sharded_plain` with each pass in `jacobi_pass_cuda`
    (the kernel for CUDA tensors)."""
    return _sweeps_sharded(jacobi_pass_cuda, q0, code, c2, n_iters, mesh, k)
