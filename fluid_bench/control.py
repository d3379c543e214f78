"""The readings that `check.LIMITS` are set from, at a cell's own size.

    python3 -m fluid_bench.control --workload <cell> --seconds 1 \
        --seeds <n> [<n> ...] [--control-seeds <k>]

For each seed, one short run of the cell (set-up and a window of
`--seconds`), then the check's numbers twice: for the program's samples
(the lower readings: sound runs of the program), and, on the first
`--control-seeds` seeds, for the control put in the program's place (the
configuration's reference in bfloat16, `check.control`; the upper
readings).  A multi-card cell runs its ranks as a run does
(`fluid_bench/ranks.py`), each judging as there.  One JSON line a seed.
The benchmark's own runs never run the control.
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
    from fluid_bench.run import judged_by

    manifest = Manifest(root)
    cell = manifest.cell(name)
    fields = cell.config["fields"]
    reference = judged_by(manifest, cell)
    device = torch.device(device)
    if cell.chips > 1:
        return _rank_readings(root, name, seed, seconds, control, device)
    from tpu_fluid_torch.solver import graph
    window = loop.run(cell.traffic, fields, seed, seconds, False, device,
                      time.perf_counter(), root=root)
    graph.clear_graphs()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "attempted": window.count,
           "program": check.judge(window.samples, fields, cell.traffic,
                                  device, reference=reference)}
    if control:
        out["control"] = check.judge(
            window.samples, fields, cell.traffic, device,
            substitute=check.control(fields, reference),
            reference=reference)
    return out


def _rank_readings(root, name, seed, seconds, control, device) -> dict:
    """A multi-card cell's readings: each rank judges as in a run
    (`ranks.judge`), the control too where asked, merged as a run's."""
    from fluid_bench import check, ranks
    payloads = ranks.run(root, name, seed, seconds, False, device.type,
                         time.perf_counter(), control=control)
    out = {"seed": seed, "attempted": [p["attempted"] for p in payloads]}
    for side, key in (("program", "verdict"), ("control", "control")):
        if side == "program" or control:
            out[side] = check.merge_verdicts(
                [p[key] for p in payloads if p[key] is not None])
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
