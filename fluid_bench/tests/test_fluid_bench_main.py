"""The command line: no result without a card or without the program, and
a whole run on the card (`cuda`)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from fluid_bench.tests.conftest import REPO


def _bare_checkout(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files only."""
    root = tmp_path / "bare"
    shutil.copytree(REPO / "fluid_bench", root / "fluid_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def _command(root, *extra):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    argv = [sys.executable] + bench["command"][1:] + [
        "--workload", "fountain-20.view", "--seed", str(2 ** 31 + 9),
        "--seconds", "1", "--trace", "0", *extra]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(argv, cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)


def test_no_result_in_a_checkout_without_the_program(tmp_path):
    out = _command(_bare_checkout(tmp_path))
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_no_result_without_a_card(monkeypatch, capsys):
    import torch

    from fluid_bench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "fountain-20.view", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert not capsys.readouterr().out.strip()


def test_an_unknown_cell_is_refused():
    from fluid_bench.manifest import Manifest
    with pytest.raises(KeyError):
        Manifest(REPO).cell("fountain-20.nothing")


@pytest.mark.cuda
def test_a_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs on the card only")
    out = _command(REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"frames_per_s", "frame_ms_p95",
                                    "setup_s"}
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("beside", [True, False],
                         ids=["bytecode_beside_torch", "none_beside_torch"])
def test_bytecode_goes_to_the_checkout_only_where_torch_has_none(
        monkeypatch, tmp_path, beside):
    from fluid_bench import run
    monkeypatch.setattr(sys, "pycache_prefix", None)
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    monkeypatch.setattr(run.os.path, "exists", lambda path: beside)
    run.use_bytecode_cache(tmp_path)
    if beside:
        assert sys.pycache_prefix is None and sys.dont_write_bytecode
    else:
        assert sys.pycache_prefix == str(tmp_path / ".bench_cache"
                                         / "pycache")
        assert not sys.dont_write_bytecode
