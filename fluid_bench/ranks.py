"""One process a card for a cell with `"chips": n > 1`.

`run` spawns n rank processes (the spawn start method: a parent that has
touched CUDA cannot fork) and hands each its `Ranks`: its rank, the size,
a `FileStore` rendezvous (`file://`) in the run's temporary directory and
the backend, nccl on cards and gloo on the CPU.  Rank r runs on `cuda:<r>`.
This spawner is the harness's own: a change to the program's launcher does
not move the benchmark.

Each rank drives the cell's loop (`loop.run(..., ranks=)`), then judges its
samples in its own process, so no state crosses a pipe: with a `SHARDED`
reference every rank judges its own part with the group; with any other,
every rank gathers each sample whole (`parallel.mesh.gather_state`, which
holds for index-sharded particles only) and rank 0 judges them.  It reads
the cell's per-layer metrics from its own trace.  Then it sends back
numbers only (`payload`) and leaves at once, before any teardown: on the
card, an nccl group whose collectives a CUDA graph had captured never
finished `destroy_process_group`.  The parent waits `GRACE` seconds for
the ranks to exit and ends the rest.

A rank that raises, dies or has not answered `limit` seconds after the
spawn fails the run: every rank is ended and `run` raises `RankFailure`,
so the run exits non-zero with no result line.
The resource tracker that the spawn start method starts is left alone: it
ends once the parent and every rank it served have exited.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import sys
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from pathlib import Path

# seconds from the spawn to the last rank's answer: a run has 360 s
LIMIT = 330.0
# seconds the ranks have to exit once every rank has answered
GRACE = 5.0


class RankFailure(RuntimeError):
    """A rank raised, died or did not answer within its limit."""


@dataclasses.dataclass(frozen=True)
class Ranks:
    """A rank's place in a multi-card cell, which its loop makes the
    program's mesh from (`parallel.mesh.make_mesh(size, rank,
    init_method, device=..., backend=backend)`)."""
    rank: int
    size: int
    init_method: str
    backend: str


def run(root, name: str, seed: int, seconds: float, trace: bool,
        device_type: str, t0: float, limit: float | None = None,
        control: bool = False) -> list:
    """Every rank's payload in rank order, for one run of cell `name`,
    each answering within `limit` seconds (`LIMIT` where None)."""
    from fluid_bench.manifest import Manifest
    limit = LIMIT if limit is None else limit
    size = Manifest(root).cell(name).chips
    backend = "nccl" if device_type == "cuda" else "gloo"
    ctx = mp.get_context("spawn")
    procs, pending, out = [], {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        init_method = (Path(tmp) / "rendezvous").as_uri()
        try:
            for r in range(size):
                recv, send = ctx.Pipe(duplex=False)
                p = ctx.Process(
                    target=_rank_main, daemon=True,
                    args=(str(root), name, seed, seconds, trace, device_type,
                          t0, Ranks(r, size, init_method, backend), control,
                          send))
                p.start()
                send.close()
                procs.append(p)
                pending[recv] = r
            deadline = time.monotonic() + limit
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RankFailure(
                        f"ranks {sorted(pending.values())} did not answer "
                        f"within {limit} s")
                for conn in wait(list(pending), timeout=left):
                    rank = pending.pop(conn)
                    try:
                        ok, payload = conn.recv()
                    except EOFError:
                        procs[rank].join(GRACE)
                        raise RankFailure(
                            f"rank {rank} exited with code "
                            f"{procs[rank].exitcode} before answering"
                        ) from None
                    finally:
                        conn.close()
                    if not ok:
                        raise RankFailure(f"rank {rank} failed:\n{payload}")
                    out[rank] = payload
            end = time.monotonic() + GRACE
            for p in procs:
                p.join(max(0.0, end - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
            for conn in pending:
                conn.close()
    return [out[r] for r in range(size)]


def _rank_main(root, name, seed, seconds, trace, device_type, t0, ranks,
               control, conn) -> None:
    try:
        payload = rank_run(Path(root), name, seed, seconds, trace,
                           device_type, t0, ranks, control)
    except BaseException:
        conn.send((False, traceback.format_exc()))
        code = 1
    else:
        conn.send((True, payload))
        code = 0
    conn.close()
    # leave at once: no destroy_process_group, no interpreter teardown
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _gathered(state, mesh, device):
    from fluid_bench.loop import as_state
    from tpu_fluid_torch.parallel.mesh import gather_state
    if state is None:
        return None
    local = as_state({k: v.to(device) for k, v in state.items()})
    return gather_state(local, mesh)._asdict()


def judge(window, cell, fields, device, reference,
          control: bool = False) -> tuple:
    """(this rank's verdict, the control's where `control`): each its own
    part's with a `SHARDED` reference; rank 0's of the samples gathered
    whole with any other, (None, None) on the other ranks.  No rank leaves
    a collective behind it: a rank that left while a peer still waited on
    its part would hang that peer."""
    from fluid_bench import check
    from fluid_bench.loop import _sync
    mesh = window.mesh
    sharded = getattr(reference, "SHARDED", False)
    group = mesh.group if sharded else None
    samples = window.samples
    if not sharded:
        samples = [dict(s, input=_gathered(s["input"], mesh, device),
                        output=_gathered(s["output"], mesh, device))
                   for s in samples]
        _sync(device)
        if mesh.rank != 0:
            return None, None

    def verdict(substitute=None):
        return check.judge(samples, fields, cell.traffic, device,
                           substitute=substitute, reference=reference,
                           group=group)
    program = verdict()
    control_verdict = verdict(check.control(fields, reference, group)) \
        if control else None
    if sharded:
        # every rank past the last collective before any leaves
        import torch
        import torch.distributed as dist
        done = torch.ones(1, device=device)
        dist.all_reduce(done, group=group)
        done.item()
    return program, control_verdict


def rank_run(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device_type: str, t0: float, ranks: Ranks,
             control: bool = False) -> dict:
    """One rank's run of cell `name`: what it sends back, numbers only."""
    from fluid_bench import run as bench_run
    bench_run.use_bytecode_cache(root)
    import torch

    from fluid_bench import loop
    from fluid_bench.manifest import Manifest
    if device_type == "cuda":
        device = torch.device("cuda", ranks.rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    manifest = Manifest(root)
    cell = manifest.cell(name)
    fields = cell.config["fields"]
    reference = manifest.reference(cell.reference)
    window = loop.run(cell.traffic, fields, seed, seconds, trace, device,
                      t0, ranks=ranks, root=root)
    from tpu_fluid_torch.solver import graph
    graph.clear_graphs()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    verdict, control_verdict = judge(window, cell, fields, device,
                                     reference, control)
    window.samples = None
    payload = {
        "rank": ranks.rank, "kind": bench_run.card_name(device),
        "attempted": window.count,
        "seconds": window.seconds, "times": list(window.times),
        "setup_s": window.setup_s, "setup": list(window.setup),
        "memory_peak_bytes": window.memory_peak_bytes, "verdict": verdict,
        "per_layer": {}, "busy_s": None, "window_s": None,
        "breakdown": None, "control": control_verdict}
    if trace:
        run = bench_run.Run(window, fields, root)
        for m in cell.per_layer:
            value = manifest.reader(m["name"])(run)
            if value is not None:
                payload["per_layer"][m["name"]] = value
        if window.trace is not None and window.trace.device:
            payload["busy_s"] = window.trace.busy_seconds()
            payload["window_s"] = window.trace.seconds
            if ranks.rank == 0:
                payload["breakdown"] = window.trace.breakdown()
    payload["forbidden"] = bench_run.forbidden_modules()
    return payload
