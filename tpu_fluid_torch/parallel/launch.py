"""Run one process per shard and collect what each returns.

`run_ranks(fn, n)` spawns n processes (spawn, never fork: a parent that
has touched CUDA cannot fork), calls fn(rank, n, init_method, *args) in
each, with `init_method` a fresh file rendezvous for `make_mesh`, and
returns the ranks' results in rank order.  A rank that raises, dies or
outlives the timeout fails the whole run: the others are killed and
RuntimeError (TimeoutError for the timeout) carries the first failure.

A run leaves no process behind.  Each rank answers through a pipe of its
own (no queue, so no semaphore for multiprocessing's resource tracker to
watch), and once the ranks are joined the tracker, a helper process that
spawning starts, is stopped and reaped: left alone it would outlive its
parent by a moment.  A rank that has answered leaves at once, without
destroying its process group or the interpreter's teardown: on the card,
an nccl group whose collectives a live CUDA graph had captured never
finished its destruction, and the run then waited for its timeout.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import tempfile
import time
import traceback
from multiprocessing import resource_tracker
from multiprocessing.connection import wait
from pathlib import Path


def _rank_main(fn, rank, n_ranks, init_method, args, conn):
    try:
        out = fn(rank, n_ranks, init_method, *args)
    except BaseException:
        conn.send((False, traceback.format_exc()))
        raise
    conn.send((True, out))
    conn.close()
    # leave at once, without destroy_process_group or the interpreter's
    # teardown: on an nccl group whose collectives a live CUDA graph had
    # captured, destroying the group never returned
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


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
        procs, pending = [], {}
        out = {}
        try:
            for r in range(n_ranks):
                recv, send = ctx.Pipe(duplex=False)
                p = ctx.Process(target=_rank_main, daemon=True,
                                args=(fn, r, n_ranks, init_method, args,
                                      send))
                p.start()
                send.close()
                procs.append(p)
                pending[recv] = r
            deadline = time.monotonic() + timeout
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(pending.values())} did not finish "
                        f"within {timeout} s")
                for conn in wait(list(pending), timeout=left):
                    rank = pending.pop(conn)
                    try:
                        ok, payload = conn.recv()
                    except EOFError:
                        procs[rank].join(10)
                        raise RuntimeError(
                            f"rank {rank} exited with code "
                            f"{procs[rank].exitcode}") from None
                    finally:
                        conn.close()
                    if not ok:
                        raise RuntimeError(f"rank {rank} failed:\n{payload}")
                    out[rank] = payload
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            _stop(procs)
            for conn in pending:
                conn.close()
            resource_tracker._resource_tracker._stop()
    return [out[r] for r in range(n_ranks)]
