"""Run one process per shard and collect what each returns.

`run_ranks(fn, n)` spawns n processes (spawn, never fork: a parent that
has touched CUDA cannot fork), calls fn(rank, n, init_method, *args) in
each, with `init_method` a fresh file rendezvous for `make_mesh`, and
returns the ranks' results in rank order.  A rank that raises, dies or
outlives the timeout fails the whole run: the others are killed and
RuntimeError (TimeoutError for the timeout) carries the first failure.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import tempfile
import time
import traceback
from pathlib import Path


def _rank_main(fn, rank, n_ranks, init_method, args, results):
    try:
        out = fn(rank, n_ranks, init_method, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put((rank, True, out))


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def run_ranks(fn, n_ranks: int, *args, timeout: float = 120.0,
              workdir=None) -> list:
    """fn's result on each of n_ranks spawned ranks, in rank order.  `fn`
    and `args` must pickle (a module-level function); the rendezvous file
    goes to `workdir`, or to a temporary directory."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        init_method = (Path(tmp) / "rendezvous").as_uri()
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n_ranks, init_method, args,
                                   results))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < n_ranks:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(n_ranks)) - set(out))} "
                        f"did not finish within {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with "
                                           f"code {procs[dead[0]].exitcode}")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                out[rank] = payload
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            _stop(procs)
    return [out[r] for r in range(n_ranks)]
