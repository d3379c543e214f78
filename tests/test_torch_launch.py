"""`parallel/launch.run_ranks`: results in rank order, a failing rank's
traceback, and no process left behind, neither a rank nor multiprocessing's
resource tracker."""

from __future__ import annotations

import multiprocessing as mp
from multiprocessing import resource_tracker

import pytest

from tpu_fluid_torch.parallel.launch import run_ranks

SPAWN_TIMEOUT = 120.0


def _echo(rank, n, init_method, scale):
    return {"rank": rank, "n": n, "value": scale * rank,
            "rendezvous": init_method.startswith("file://")}


def _fail_on_one(rank, n, init_method):
    if rank == 1:
        raise ValueError("rank one refuses")
    return rank


def assert_nothing_left():
    assert mp.active_children() == []
    assert resource_tracker._resource_tracker._pid is None


def test_run_ranks_results_in_rank_order(tmp_path):
    out = run_ranks(_echo, 3, 10, timeout=SPAWN_TIMEOUT, workdir=tmp_path)
    assert out == [{"rank": r, "n": 3, "value": 10 * r, "rendezvous": True}
                   for r in range(3)]
    assert_nothing_left()


def test_run_ranks_raises_for_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed") as err:
        run_ranks(_fail_on_one, 2, timeout=SPAWN_TIMEOUT, workdir=tmp_path)
    assert "ValueError: rank one refuses" in str(err.value)
    assert_nothing_left()
