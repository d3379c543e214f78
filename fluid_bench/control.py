"""The readings that `check.LIMITS` are set from, at a cell's own size.

    python3 -m fluid_bench.control --workload <cell> --seconds 1 \
        --seeds <n> [<n> ...] [--control-seeds <k>]

For each seed, one short run of the cell (set-up and a window of
`--seconds`), then the check's numbers twice: for the program's samples
(the lower readings: sound runs of the program), and, on the first
`--control-seeds` seeds, for the control put in the program's place (the
reference in bfloat16, `check.control`; the upper readings).  One JSON
line a seed.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from fluid_bench.run import ROOT, use_cache_dirs


def readings(root, name: str, seed: int, seconds: float, control: bool,
             device="cuda") -> dict:
    import torch

    from fluid_bench import check, loop
    from fluid_bench.manifest import Manifest
    from tpu_fluid_torch.solver import graph

    cell = Manifest(root).cell(name)
    fields = cell.config["fields"]
    device = torch.device(device)
    window = loop.run(cell.traffic, fields, seed, seconds, False, device,
                      time.perf_counter())
    graph.clear_graphs()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "attempted": window.count,
           "program": check.judge(window.samples, fields, cell.traffic,
                                  device)}
    if control:
        out["control"] = check.judge(window.samples, fields, cell.traffic,
                                     device, substitute=check.control(fields))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, default=3)
    args = parser.parse_args(argv)
    use_cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("fluid_bench.control: no CUDA card", file=sys.stderr)
        return 2
    for i, seed in enumerate(args.seeds):
        r = readings(ROOT, args.workload, seed, args.seconds,
                     i < args.control_seeds)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
