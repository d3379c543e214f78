#!/usr/bin/env python3
"""Time the PyTorch port's K2 (Jacobi sweeps) and K5 (surface stages 16-18)
kernels of one source tree on the card, at the shapes `chip_smoke.py`
checks them at.

    python3 tools/torch_kernel_ab.py [--tree DIR] [--label NAME]

`--tree` names the directory that holds the `tpu_fluid_torch` package to
time (default: this checkout), so that a parent commit unpacked with
`git archive` into a gitignored directory can be timed in the same call as
the change: run parent, change, change, parent, one process each.  Each
process builds that tree's kernels into the tree's own `build/`.

The inputs are `chip_smoke.py`'s own, made by its `kernel_cases` and
`halo_cases` (this checkout's script, that tree's package): K2 solves the
folded system of a random cell field for 199 sweeps at 20^3, 128^3 and
256^3; K5 runs 4 blur passes at the detailed grids 100^3, 256^3 and 512^3;
and at shard 1 of `scaled_scene(256)` split 4 ways, K2's sharded pass runs
8 sweeps on an 80 x 256^2 slab and K5's halo form runs on a 128 x 512^2
slab with 5 halo planes a side.  Each line printed is one JSON object with
the tree's label, the kernel, the scene, the input shape, the mean ms by
CUDA events over `REPS` calls after two warm-up calls, the kernel launches
one call made (where the tree counts them) and a digest of the output
bytes, which must agree between trees: both are bitwise equal to the same
plain version.  The first line is the card's name and power limit as
nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# calls timed a kernel: the 20^3 / 100^3 calls take tens of microseconds,
# so many calls average out the host's jitter
REPS = {"reference": 200, "bench": 20, "large": 8, "large shard 1/4": 10}
SCENE_KERNELS = ("jacobi_sweeps_cuda", "surface_fused_cuda")
HALO_KERNELS = ("jacobi_pass_cuda", "surface_fused_halo_cuda")


def digest(tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    # the tree's package first, then this checkout's chip_smoke.py
    sys.path[:0] = [str(tree), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import tpu_fluid_torch
    from tpu_fluid_torch import FluidConfig
    from tpu_fluid_torch.kernels import build, jacobi, surface_fused
    if Path(tpu_fluid_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {tpu_fluid_torch.__file__}, not the "
                           f"tree {tree}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build()
    device = torch.device("cuda", 0)

    def report(scene, kernel, call_args, kw):
        module = jacobi if kernel.__name__.startswith("jacobi") \
            else surface_fused
        counter = getattr(module, "device_launches", None)
        before = counter() if counter else None
        out = kernel(*call_args, **kw)
        torch.cuda.synchronize()
        used = counter() - before if counter else None
        ms = chip_smoke.time_ms(lambda: kernel(*call_args, **kw),
                                reps=REPS[scene])
        print(json.dumps({"tree": args.label, "kernel": kernel.__name__,
                          "scene": scene, "shape": list(call_args[0].shape),
                          "ms": ms, "launches": used,
                          "digest": digest(out if isinstance(out, tuple)
                                           else (out,))}), flush=True)

    large = FluidConfig.scaled_scene(256)
    for scene, cfg in (("reference", FluidConfig.reference_scene()),
                       ("bench", FluidConfig.scaled_scene(128)),
                       ("large", large)):
        for _, kernel, _, call_args, kw in chip_smoke.kernel_cases(
                device, [(scene, cfg)]):
            if kernel.__name__ in SCENE_KERNELS:
                report(scene, kernel, call_args, kw)
        torch.cuda.empty_cache()
    for kernel, _, call_args, kw, shard in chip_smoke.halo_cases(device,
                                                                  large):
        if shard == 1 and kernel.__name__ in HALO_KERNELS:
            report("large shard 1/4", kernel, call_args, kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
