"""The benchmark's arithmetic on synthetic times."""

from __future__ import annotations

import pytest

from fluid_bench import stats
from fluid_bench.trace import Summary


def test_rate_is_over_the_whole_window():
    assert stats.rate(650, 10.0) == 65.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_is_over_every_sample_and_a_stall_moves_it():
    steps = [1.0] * 100
    assert stats.percentile(steps, 95) == 1.0
    stalled = [1.0] * 94 + [30.0] * 6
    assert stats.percentile(stalled, 95) > 1.0
    # numpy's linear interpolation between ranks
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile(list(range(101)), 95) == 95


def test_union_of_overlapping_intervals():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 10)]
    assert stats.union(spans) == [(0, 3), (5, 6), (8, 10)]
    assert stats.covered(spans, 0, 10) == 6
    assert stats.covered(spans, 1, 9) == 2 + 1 + 1
    assert stats.gaps(spans, 0, 10) == [(3, 5), (6, 8)]
    assert stats.idle_pct(spans, 0, 10) == pytest.approx(40.0)
    assert stats.idle_pct([(0, 10), (2, 3)], 0, 10) == 0.0


def _events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "fluid_bench.stretch",
           "ts": 100.0, "dur": 1000.0},
          {"ph": "X", "cat": "user_annotation", "name": "jit_step",
           "ts": 100.0, "dur": 50.0},
          {"ph": "X", "cat": "user_annotation", "name": "wait",
           "ts": 600.0, "dur": 400.0}]
    # two steps: a library kernel and a PyTorch kernel each, one copy
    for start in (150.0, 650.0):
        ev += [{"ph": "X", "cat": "kernel", "ts": start, "dur": 200.0,
                "name": "void (anonymous namespace)::jacobi_march_kernel"
                        "<8>(float const*, unsigned char const*)"},
               {"ph": "X", "cat": "kernel", "ts": start + 150.0, "dur": 100.0,
                "name": "void at::native::vectorized_elementwise_kernel<4>"}]
    ev.append({"ph": "X", "cat": "gpu_memcpy", "ts": 1000.0, "dur": 50.0,
               "name": "Memcpy DtoD"})
    ev.append({"ph": "X", "cat": "kernel", "ts": 5000.0, "dur": 10.0,
               "name": "outside the stretch"})
    return ev


def test_summary_of_a_trace():
    from fluid_bench.run import matcher
    s = Summary(_events(), steps=2)
    assert (s.start, s.end) == (100.0, 1100.0)
    # busy: [150, 400] + [650, 900] + [1000, 1050] = 550 of 1000 us
    assert s.busy_seconds() == pytest.approx(550e-6)
    assert s.idle_pct() == pytest.approx(45.0)
    lib = matcher(("jacobi_march_kernel",))
    assert s.kernel_ms_per_step(lib) == pytest.approx(0.2)
    # the kernel past the stretch's end is not counted
    assert s.kernel_ms_per_step(lambda n: not lib(n)) == pytest.approx(
        (100 + 100) * 1e-3 / 2)
    assert s.kernel_ms_per_step(lambda n: False) is None
    b = s.breakdown()
    assert b["device_ops"][0][0].startswith("(anonymous namespace)::jacobi")
    assert b["device_ops"][0][1] == pytest.approx(400e-6)
    gaps = dict((round(sec * 1e6), label) for label, sec in b["idle_gaps"])
    assert gaps[100] == "wait"      # [900, 1000] under the wait span
    assert gaps[250] == "host"      # [400, 650]: no span open
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_a_trace_without_its_stretch_is_refused():
    with pytest.raises(RuntimeError):
        Summary([e for e in _events() if e["name"] != "fluid_bench.stretch"],
                steps=2)
