"""K2f, the pressure solve's fold in one pass (`kernels/jacobi.py`
`jacobi_fold_cuda`, `jacobi_fold_plain`; `csrc/jacobi_fold.cu`).

The plain version is held bitwise against the JAX package's fold, run op
by op outside jit: `jacobi_stats`, then `poisson_solve`'s kernel branch
(`tpu_fluid/stages/pressure.py`), then the c2e its sweeps make
(`tpu_fluid/kernels/jacobi.py`).  The cell types hold all four types,
solids on two faces and water on a third, so water touches the grid's
edge; div holds NaN, both infinities, -0.0, a subnormal and values that
overflow once scaled.  XLA:CPU flushes subnormals to zero, inputs and
results, so at a cell whose div is subnormal both sides are compared with
their subnormals and -0.0 read as +0.0.  A NaN matches a NaN in the same place;
every other value matches bit for bit, so -0.0 differs from 0.0.  On a
CUDA card the kernel is held against the plain version the same way
(marked `cuda`; skips without a card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid.stages import pressure as jpressure
from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.kernels import jacobi, kernel_choice
from tpu_fluid_torch.kernels.jacobi import (jacobi_fold_cuda,
                                            jacobi_fold_plain)
from tpu_fluid_torch.stages.pressure import jacobi_solve

torch.set_num_threads(2)
CFG = FluidConfig()
# (boundary_value, scale): the pressure solve's, and the volume solve's
BOUNDARIES = ((CFG.air_pressure,
               CFG.fluid_density * CFG.cell_width / CFG.dt), (0.0, 1.0))
# 20^3, an odd grid, a 1-row grid, a 1-column grid, and the grids whose
# blocked plans tests/test_torch_tiling.py emulates
SHAPES = [(20, 20, 20), (5, 7, 9), (1, 6, 9), (12, 1, 1), (25, 20, 20),
          (13, 33, 31), (37, 45, 29), (7, 9, 130)]
SPECIAL = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 3e38, -3e38,
                    1e-45], dtype=np.float32)


def fold_inputs(shape, seed):
    """u8 types with every type, SOLID on the low x and y faces, WATER on
    the high z face (each where the grid is more than one cell across);
    f32 div with the special values scattered in."""
    r = np.random.default_rng(seed)
    types = r.choice(np.array([CellType.INACTIVE, CellType.AIR,
                               CellType.WATER, CellType.SOLID], np.uint8),
                     size=shape, p=(0.2, 0.2, 0.45, 0.15))
    if shape[0] > 1:
        types[0] = CellType.SOLID
    if shape[1] > 1:
        types[:, 0] = CellType.SOLID
    if shape[2] > 1:
        types[:, :, -1] = CellType.WATER
    div = (r.standard_normal(shape) * 50).astype(np.float32)
    at = r.choice(div.size, size=min(div.size, 4 * len(SPECIAL)),
                  replace=False)
    div.reshape(-1)[at] = np.resize(SPECIAL, len(at))
    return torch.from_numpy(types), torch.from_numpy(div)


def chain(types, div, scale, boundary_value):
    """(q0, code, c2e) by the JAX package's chain of ops, each dispatched
    on its own, so that XLA fuses and contracts nothing."""
    t = jnp.asarray(types.numpy())
    rhs = jnp.asarray(div.numpy()).astype(jnp.float32) * scale
    water, aii, n_air = jpressure.jacobi_stats(t, JaxConfig())
    const = n_air * boundary_value - rhs
    code = jnp.where(water & (aii > 0), aii, 0.0).astype(jnp.uint8)
    c2 = const / jnp.maximum(aii, 1.0)
    q0 = jnp.where(water, jnp.full(t.shape, boundary_value, jnp.float32),
                   0.0)
    c2e = jnp.where(code.astype(jnp.int32) > 0, c2, q0)
    return tuple(torch.from_numpy(np.array(a)) for a in (q0, code, c2e))


def flushed(a, where):
    """a with its subnormals and -0.0 as +0.0 at the cells `where`."""
    tiny = torch.finfo(a.dtype).tiny
    return torch.where(where & (a.abs() < tiny), 0.0, a)


def same_bits(got, want) -> bool:
    """Equal dtype, shape and bits, a NaN matching a NaN."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if not got.dtype.is_floating_point:
        return torch.equal(got.cpu(), want.cpu())
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(got)
    return (torch.equal(nan, torch.isnan(want))
            and torch.equal(got[~nan].view(torch.int32),
                            want[~nan].view(torch.int32)))


@pytest.mark.parametrize("boundary", range(len(BOUNDARIES)))
@pytest.mark.parametrize("shape", SHAPES)
def test_fold_plain_equals_the_chain_bitwise(shape, boundary):
    boundary_value, scale = BOUNDARIES[boundary]
    types, div = fold_inputs(shape, sum(shape) + boundary)
    got = jacobi_fold_plain(types, div, scale, boundary_value)
    want = chain(types, div, scale, boundary_value)
    assert [g.dtype for g in got] == [torch.float32, torch.uint8,
                                      torch.float32]
    sub = (div != 0) & (div.abs() < torch.finfo(div.dtype).tiny)
    assert sub.any()
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            g, w = flushed(g, sub), flushed(w, sub)
        assert same_bits(g, w)
    # cells that update and cells that hold q0, special values among div
    code = got[1]
    assert (code > 0).any() and (code == 0).any()
    assert torch.isnan(div).any() and torch.isinf(div).any()


def test_fold_on_cpu_runs_plain_version_without_launch():
    types, div = fold_inputs((6, 7, 8), 3)
    before = jacobi_fold_cuda.launches
    got = jacobi_fold_cuda(types, div, 100.0, 1.0)
    for g, w in zip(got, jacobi_fold_plain(types, div, 100.0, 1.0)):
        assert same_bits(g, w)
    assert jacobi_fold_cuda.launches == before


def test_fold_rejects_bad_inputs():
    types, div = fold_inputs((4, 5, 6), 4)
    with pytest.raises(TypeError):
        jacobi_fold_cuda(types.to(torch.int32), div, 1.0, 1.0)
    with pytest.raises(TypeError):
        jacobi_fold_cuda(types, div.double(), 1.0, 1.0)
    with pytest.raises(ValueError):
        jacobi_fold_cuda(types, div[:3], 1.0, 1.0)
    with pytest.raises(ValueError):
        jacobi_fold_cuda(types[0], div[0], 1.0, 1.0)
    with pytest.raises(ValueError):
        jacobi_fold_cuda(types, div.transpose(0, 2).contiguous()
                         .transpose(0, 2), 1.0, 1.0)


# ------------------------------------------------------------------ on card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled and run "
                    "only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("boundary", range(len(BOUNDARIES)))
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_fold_matches_plain_bitwise(cuda_device, shape, boundary):
    """One launch by the wrapper's count and by the C counter, none by
    K2's; bitwise equal to the plain version on the card."""
    boundary_value, scale = BOUNDARIES[boundary]
    types, div = (a.to(cuda_device) for a in fold_inputs(shape, 5))
    calls, launched, k2 = (jacobi_fold_cuda.launches, jacobi.fold_launches(),
                           jacobi.device_launches())
    got = jacobi_fold_cuda(types, div, scale, boundary_value)
    torch.cuda.synchronize()
    assert jacobi_fold_cuda.launches == calls + 1
    assert jacobi.fold_launches() == launched + 1
    assert jacobi.device_launches() == k2
    want = jacobi_fold_plain(types, div, scale, boundary_value)
    for g, w in zip(got, want):
        assert g.device == cuda_device and same_bits(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(20, 20, 20), (37, 45, 29)])
def test_cuda_jacobi_solve_matches_plain_route(cuda_device, shape):
    """The solve through K2f and K2 against pallas_mode="off" bitwise: one
    K2f launch a solve."""
    types, div = (a.to(cuda_device) for a in fold_inputs(shape, 6))
    div = torch.nan_to_num(div, nan=0.0, posinf=1e3, neginf=-1e3)
    assert kernel_choice(CFG, cuda_device)
    calls = jacobi_fold_cuda.launches
    got = jacobi_solve(types, div, CFG)
    assert jacobi_fold_cuda.launches == calls + 1
    want = jacobi_solve(types, div, CFG.replace(pallas_mode="off"))
    assert same_bits(got, want)
