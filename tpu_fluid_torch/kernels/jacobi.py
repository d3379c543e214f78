"""K2: Jacobi pressure sweeps on the water-masked pressure.

Replaces `tpu_fluid/kernels/jacobi.py:_whole_grid_jacobi` (kernel
`_whole_grid_kernel`, reached by `jacobi_sweeps_pallas` for grids of up to
128^3 cells) and its slab branch `_one_pass` (`jacobi.py:263`, above
128^3); CUDA source `csrc/jacobi.cu`.  One sweep is
q' = rd * (sum of the 6 zero-padded neighbours, x+1, x-1, y+1, y-1, z+1,
z-1) + c2e, with rd decoded from the u8 aii code and c2e = where(rd > 0,
c2, q0) the constant a sweep adds.

K2f builds those inputs, (q0, code, c2e), from the cell types and the
divergence in one pass over the grid (`jacobi_fold_cuda`, CUDA source
`csrc/jacobi_fold.cu`).  It replaces no TPU kernel: the JAX package leaves
the fold to XLA.  `jacobi_fold_plain` is the same function in plain
PyTorch, from padded views of the types; the x-slab route runs either on
its slab extended by one halo plane of the types
(`stages/pressure.fold_slab`).

What bounds it: 7 flops a cell a sweep, against 13 bytes a cell a sweep
if each sweep streams q, c2e and the code through device memory.  Like
the TPU kernels, both routes keep the sweeps of a launch on chip
(`kernels/tiling.jacobi_plan` picks the route and the geometry):
- "whole": a grid that fits one block of 1024 threads (the 20^3 reference
  scene) runs all sweeps in one launch, the columns in registers and q in
  shared memory;
- "blocked": passes of `tiling.BLOCKED_K` sweeps (and a remainder pass),
  each one launch that marches 32 x 64-cell y-z tiles (32 x 32 threads,
  two z cells each) with K-cell halos along x, so a pass moves q, c2e and
  the code once for K sweeps; the whole solve is one C call.  It marches
  only the live boxes (`tiling.live_boxes`): a sweep leaves a cell with
  code 0 at c2e, bit for bit, so a box with no cell of code > 0 never
  changes.  Two launches a solve list the boxes on the device, with no
  host sync, and write c2e into the output and the other ping-pong buffer,
  from which the live boxes read their dead neighbours; each pass then
  runs one block an SM over the list.  What bounds it is the live boxes:
  in a scene of compact water a pass is one round of short boxes, and
  with every box live it costs no more rounds of planes than one block a
  box did.  A c2e, or a q0 where the code is > 0, past 2^100 or not
  finite, a -0.0 c2e where the code is 0, or 2^20 sweeps make every box
  live: the dense march (exact for K2f's inputs, whose q0 is c2e where
  the code is 0).  With
  tracing on (`utils/profiling`) a solve counts its live boxes on the
  device, `jacobi.live_boxes`, and all its boxes, `jacobi.boxes`.
tests/test_torch_tiling.py and tests/test_torch_live_boxes.py hold the
plans and the live list against the plain version on the CPU; on the card
both routes match `jacobi_sweeps_plain` bitwise.

`jacobi_sweeps_plain` is the same function in plain PyTorch.  Each
wrapper's launches are counted by its own C counter:
`tf_jacobi_launches` counts K2's, `tf_jacobi_fold_launches` K2f's.

The sharded form replaces `jacobi_sweeps_sharded` (`jacobi.py:367`, the
halo branch of `_one_pass` with `_halo_blocks` and `edges`) in the x-slab
multi-device step.  `jacobi_sweeps_sharded_cuda` runs ceil(n / k) passes:
each exchanges k boundary planes of q with the neighbours and runs
`jacobi_pass_cuda`, k sweeps of the same body on the (lx + 2k)-row slab,
now ceil(k / `tiling.BLOCKED_K`) blocked launches instead of k; code and
c2e exchange their k planes once a solve.  The end shards' zero planes carry
code 0 and stay 0: the single-device zero pad.  The result is bitwise
independent of k, so k trades exchanges against ghost rows: `SHARDED_K` =
8 gives 25 exchanges for the 199 sweeps of a solve.  `jacobi_pass_plain`
and `jacobi_sweeps_sharded_plain` are the plain versions; with k = 1 the
latter exchanges one plane a sweep, as JAX's XLA-path sharded solve does
(`tpu_fluid/parallel/halo.py:jacobi_solve_halo`).  With tracing on
(`utils/profiling`) each of its exchanges is a span, `exchange.solve`.
"""

from __future__ import annotations

import torch

from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.kernels import build, on_cuda, require, tiling
from tpu_fluid_torch.ops.stencil import AXIS_MOVES, neighbor_sum
from tpu_fluid_torch.parallel.halo import halo_extend
from tpu_fluid_torch.utils import profiling

_FOLD_ARGTYPES = ((build.POINTER,) * 2 + (build.FLOAT,) * 2
                  + (build.POINTER,) * 3 + (build.INT,) * 3
                  + (build.POINTER,))
_WHOLE_ARGTYPES = (build.POINTER,) * 4 + (build.INT,) * 5 + (build.POINTER,)
_MARCH_ARGTYPES = ((build.POINTER,) * 4 + (build.INT,) * 8
                   + (build.POINTER,))
_BLOCKED_ARGTYPES = ((build.POINTER,) * 6 + (build.INT,) * 7
                     + (build.POINTER,))
_LIVE_ARGTYPES = (build.POINTER,) * 6 + (build.INT,) * 5 + (build.POINTER,)

# Sweeps per pass (and planes per exchange) of the sharded solve.
SHARDED_K = 8


def jacobi_fold_plain(types: torch.Tensor, div: torch.Tensor,
                      scale: float, boundary_value: float) -> tuple:
    """(q0, code, c2e) of a solve from the u8 cell types and the f32
    divergence: with rhs = div * scale, aii the neighbours that are not
    SOLID and n_air those neither SOLID nor WATER (a neighbour outside the
    grid counts as neither), q0 = where(water, boundary_value, 0), code =
    the u8 aii where the cell is WATER with aii > 0 and 0 elsewhere, and
    c2e = where(code > 0, (n_air * boundary_value - rhs) / max(aii, 1),
    q0).  The neighbours are views of the types padded by one cell of
    INACTIVE; the counts are exact, so their order is free."""
    rhs = div * scale
    pad = torch.nn.functional.pad(types, (1,) * 6, value=CellType.INACTIVE)
    not_solid = pad != CellType.SOLID
    dry = not_solid & (pad != CellType.WATER)
    gx, gy, gz = types.shape
    aii = torch.zeros(types.shape, dtype=torch.uint8, device=types.device)
    n_air = torch.zeros_like(aii)
    for dx, dy, dz in AXIS_MOVES:
        view = (slice(1 + dx, 1 + dx + gx), slice(1 + dy, 1 + dy + gy),
                slice(1 + dz, 1 + dz + gz))
        aii += not_solid[view]
        n_air += dry[view]
    water = types == CellType.WATER
    code = torch.where(water & (aii > 0), aii, 0)
    q0 = torch.where(water, boundary_value, 0.0).to(torch.float32)
    c2 = (n_air.to(torch.float32) * boundary_value - rhs) / \
        torch.clamp(aii.to(torch.float32), min=1.0)
    return q0, code, torch.where(code > 0, c2, q0)


def fold_launches() -> int:
    """Kernels the C entry point of `csrc/jacobi_fold.cu` has launched."""
    return build.launches("tf_jacobi_fold_launches")


def jacobi_fold_cuda(types: torch.Tensor, div: torch.Tensor, scale: float,
                     boundary_value: float) -> tuple:
    """K2f wrapper: `jacobi_fold_plain` in one CUDA launch for CUDA
    tensors, the plain version for CPU tensors.  types is the u8 (X,Y,Z)
    cell types, div the f32 divergence of the same shape; scale and
    boundary_value are rounded to f32, as PyTorch's tensor-by-scalar ops
    round them."""
    require(types, "types", torch.uint8)
    if types.ndim != 3:
        raise ValueError(f"types: shape {tuple(types.shape)}, expected "
                         f"(X,Y,Z)")
    require(div, "div", torch.float32, types.shape, types.device)
    if not on_cuda(types):
        return jacobi_fold_plain(types, div, scale, boundary_value)
    with torch.cuda.device(types.device):
        q0 = torch.empty(types.shape, dtype=torch.float32,
                         device=types.device)
        code = torch.empty_like(types)
        c2e = torch.empty_like(q0)
        stream = torch.cuda.current_stream(types.device).cuda_stream
        build.call("tf_jacobi_fold", _FOLD_ARGTYPES, types.data_ptr(),
                   div.data_ptr(), scale, boundary_value, q0.data_ptr(),
                   code.data_ptr(), c2e.data_ptr(), *types.shape, stream)
    jacobi_fold_cuda.launches += 1
    return q0, code, c2e


jacobi_fold_cuda.launches = 0


def decode_rd(code: torch.Tensor) -> torch.Tensor:
    """u8 aii code -> f32 reciprocal diagonal: where(code > 0,
    1 / max(code, 1), 0), the integer widened before any arithmetic
    (`tpu_fluid/kernels/jacobi.py:_decode_rd`)."""
    codef = code.to(torch.int32).to(torch.float32)
    return torch.where(codef > 0,
                       torch.ones_like(codef) / torch.clamp(codef, min=1.0),
                       0.0)


def jacobi_sweeps_plain(q0: torch.Tensor, code: torch.Tensor,
                        c2e: torch.Tensor, n_iters: int) -> torch.Tensor:
    rd = decode_rd(code)
    q = q0
    for _ in range(n_iters):
        q = rd * neighbor_sum(q, moves=AXIS_MOVES) + c2e
    return q


def _march(p: tiling.Pass, q, code, c2e, out) -> None:
    """One blocked pass (`tiling.Pass`) on the current stream."""
    nx, gy, gz = p.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.call("tf_jacobi_march", _MARCH_ARGTYPES, q.data_ptr(),
               code.data_ptr(), c2e.data_ptr(), out.data_ptr(), nx, gy, gz,
               p.xs, p.xe, p.seg, p.out_x0, p.levels, stream)


def device_launches() -> int:
    """Kernels the C entry points of `csrc/jacobi.cu` have launched."""
    return build.launches("tf_jacobi_launches")


def jacobi_sweeps_cuda(q0: torch.Tensor, code: torch.Tensor,
                       c2e: torch.Tensor, n_iters: int) -> torch.Tensor:
    """K2 wrapper: n_iters sweeps by the CUDA kernels for CUDA tensors
    (the route of `tiling.jacobi_plan`), `jacobi_sweeps_plain` for CPU
    tensors.  q0 and c2e are f32 (X,Y,Z), code the u8 aii code of the
    same shape (K2f's outputs)."""
    require(q0, "q0", torch.float32)
    if q0.ndim != 3:
        raise ValueError(f"q0: shape {tuple(q0.shape)}, expected (X,Y,Z)")
    require(code, "code", torch.uint8, q0.shape, q0.device)
    require(c2e, "c2e", torch.float32, q0.shape, q0.device)
    if not on_cuda(q0):
        return jacobi_sweeps_plain(q0, code, c2e, n_iters)
    with torch.cuda.device(q0.device):
        plan = tiling.jacobi_plan(q0.shape, n_iters,
                                  sms=build.sm_count(q0.device.index))
        if plan.route == "copy":
            return q0.clone()
        out = torch.empty_like(q0)
        stream = torch.cuda.current_stream(q0.device).cuda_stream
        if plan.route == "whole":
            build.call("tf_jacobi_whole", _WHOLE_ARGTYPES, q0.data_ptr(),
                       code.data_ptr(), c2e.data_ptr(), out.data_ptr(),
                       *q0.shape, plan.parts, n_iters, stream)
        else:
            # the live list, then the passes of the plan over it, in one C
            # call: k sweeps each, then the remainder
            first = plan.passes[0]
            other = torch.empty_like(q0) if len(plan.passes) > 1 else out
            boxes = first.n_blocks
            scratch = _live_scratch(boxes, q0.device)
            build.call("tf_jacobi_blocked", _BLOCKED_ARGTYPES, q0.data_ptr(),
                       code.data_ptr(), c2e.data_ptr(), out.data_ptr(),
                       other.data_ptr(), scratch.data_ptr(), *q0.shape,
                       n_iters, first.levels, first.seg,
                       build.sm_count(q0.device.index), stream)
            if profiling.enabled():
                profiling.count_on_device("jacobi.live_boxes",
                                          scratch[boxes])
                profiling.count("jacobi.boxes", boxes)
    jacobi_sweeps_cuda.launches += 1
    return out


jacobi_sweeps_cuda.launches = 0


def _live_scratch(boxes: int, device) -> torch.Tensor:
    """The list kernels' scratch: the list, its count, the boxes' flags."""
    return torch.empty(2 * boxes + 1, dtype=torch.int32, device=device)


def live_boxes_cuda(q0: torch.Tensor, code: torch.Tensor, c2e: torch.Tensor,
                    n_iters: int) -> torch.Tensor:
    """The boxes that `jacobi_sweeps_cuda`'s listed passes march for these
    CUDA inputs, as the list kernels build them: an int32 tensor of box
    indices into the plan's `passes[0].blocks()`, in order
    (`tiling.live_boxes` is the plain rule)."""
    require(q0, "q0", torch.float32)
    require(code, "code", torch.uint8, q0.shape, q0.device)
    require(c2e, "c2e", torch.float32, q0.shape, q0.device)
    with torch.cuda.device(q0.device):
        plan = tiling.jacobi_plan(q0.shape, n_iters,
                                  sms=build.sm_count(q0.device.index))
        if not plan.listed:
            raise ValueError(f"{tuple(q0.shape)} with {n_iters} sweeps is "
                             f"not on the listed route")
        first = plan.passes[0]
        boxes = first.n_blocks
        scratch = _live_scratch(boxes, q0.device)
        stream = torch.cuda.current_stream(q0.device).cuda_stream
        build.call("tf_jacobi_live", _LIVE_ARGTYPES, q0.data_ptr(),
                   code.data_ptr(), c2e.data_ptr(), None, None,
                   scratch.data_ptr(), *q0.shape, first.seg, n_iters, stream)
        return scratch[:int(scratch[boxes])].clone()


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
    kernel for CUDA tensors, one blocked launch for each
    `tiling.BLOCKED_K` sweeps; the plain version for CPU tensors."""
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
    nx, gy, gz = q.shape
    with torch.cuda.device(q.device):
        plan = tiling.jacobi_plan(q.shape, kk, halo=h,
                                  sms=build.sm_count(q.device.index))
        src = q
        for p in plan.passes:
            rows = nx - 2 * h if p.out_x0 else nx
            dst = torch.empty((rows, gy, gz), dtype=q.dtype, device=q.device)
            _march(p, src, code, c2e, dst)
            src = dst
    jacobi_pass_cuda.launches += 1
    return src


jacobi_pass_cuda.launches = 0


def _sweeps_sharded(one_pass, q0, code, c2e, n_iters, mesh, k):
    k = min(SHARDED_K if k is None else k, q0.shape[0])
    with profiling.span("exchange.solve"):
        code_e = halo_extend(code, k, mesh)
        c2e_e = halo_extend(c2e, k, mesh)
    q = q0
    for done in range(0, n_iters, k):
        with profiling.span("exchange.solve"):
            q_e = halo_extend(q, k, mesh)
        q = one_pass(q_e, code_e, c2e_e, k, min(k, n_iters - done))
    return q


def jacobi_sweeps_sharded_plain(q0: torch.Tensor, code: torch.Tensor,
                                c2e: torch.Tensor, n_iters: int, mesh,
                                k: int | None = None) -> torch.Tensor:
    """n_iters sweeps on this shard's (lx, Y, Z) slab of the folded inputs,
    k planes exchanged a pass (at most lx; `SHARDED_K` by default)."""
    return _sweeps_sharded(jacobi_pass_plain, q0, code, c2e, n_iters, mesh,
                           k)


def jacobi_sweeps_sharded_cuda(q0: torch.Tensor, code: torch.Tensor,
                               c2e: torch.Tensor, n_iters: int, mesh,
                               k: int | None = None) -> torch.Tensor:
    """`jacobi_sweeps_sharded_plain` with each pass in `jacobi_pass_cuda`
    (the kernel for CUDA tensors)."""
    return _sweeps_sharded(jacobi_pass_cuda, q0, code, c2e, n_iters, mesh,
                           k)
