"""The port's timing harness (`tpu_fluid_torch/utils/profiling.py`) on the
CPU: chained calls, the documented stage groups of both step paths."""

import pytest
import torch

from tpu_fluid_torch import FluidConfig
from tpu_fluid_torch.utils import profiling

torch.set_num_threads(2)

CFG = FluidConfig(grid_size=(12, 12, 12), particle_count=2000,
                  particle_init_cube_resolution=(16, 16, 8),
                  particle_init_cube_offset=(3.0, 1.5, 1.0),
                  particle_init_cube_size=(6.0, 6.0, 1.5),
                  surface_render_resolution=2, jacobi_iters=20)
UNFUSED = ["01-03 pool and cell typing", "04+05 extrapolate", "07 advect",
           "08-10 forces/solids", "11 divergence", "12 jacobi x20",
           "13 project", "14+15 move and scatter", "16-18 surface fields",
           "TOTAL full step"]
FUSED = ["01-06 classify and extrapolate (K6a)", "07 advect",
         "08-11 forces, solids, divergence (K6b)", "12 jacobi x20",
         "13 project (K6c)", "14+15 move and scatter",
         "16-18 surface fields", "TOTAL full step"]


def test_time_chained_feeds_each_output_into_the_next_call():
    seen = []

    def f(x):
        seen.append(x)
        return x + 1

    ms = profiling.time_chained(f, torch.zeros(()), n=4)
    assert ms >= 0
    # one untimed call on x0, then x0, f(x0), f(f(x0)), ...
    assert [int(x) for x in seen] == [0, 0, 1, 2, 3]


@pytest.mark.parametrize("cfg,keys", [(CFG, UNFUSED),
                                      (CFG.replace(pallas_mode="interpret",
                                                   grid_fused=True), FUSED)])
def test_stage_breakdown_keys_and_times(cfg, keys):
    """The documented groups of each path ("interpret" turns the fused
    path on with the plain versions), each with a positive time."""
    bd = profiling.stage_breakdown(cfg, n=2, warm_steps=1, device="cpu")
    assert list(bd) == keys
    assert all(v > 0 for v in bd.values()), bd


def test_print_breakdown(capsys):
    profiling.print_breakdown(CFG, n=1, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("grid=(12, 12, 12)")
    assert len(out) == 1 + len(UNFUSED) and "TOTAL full step" in out[-1]
