"""The reduction of a profiler trace, on a hand-made Chrome trace, and the
seeded arrivals."""

import math

import pytest

from kbench.harness.devtrace import reduce_trace
from kbench.harness.layout import Layout


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_busy_idle_and_attribution():
    events = [
        _x("user_annotation", "kbench.window", 1000, 1000),
        _x("user_annotation", "kbench.layer.block_solver", 1100, 300),
        _x("user_annotation", "kbench.gemm#0", 1120, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 1130, 5, correlation=7),
        _x("cuda_driver", "cuLaunchKernel", 1300, 5, correlation=8),
        _x("cpu_op", "aten::copy_", 1500, 200),
        _x("kernel", "gemm_kernel", 1150, 100, tid=99, correlation=7),
        _x("kernel", "other_kernel", 1300, 100, tid=99, correlation=8),
        _x("gpu_memcpy", "Memcpy HtoD", 1800, 50, tid=99),
        # Outside the window: ignored.
        _x("kernel", "late_kernel", 2500, 10, tid=99),
    ]
    s = reduce_trace({"traceEvents": events})
    assert math.isclose(s.window_s, 1e-3)
    assert math.isclose(s.busy_s, 250e-6)
    assert s.kernels == 3
    assert math.isclose(s.gemm_s[0], 100e-6)
    assert math.isclose(s.layer_s["block_solver"], 200e-6)
    assert math.isclose(sum(s.idle_by_host.values()), 750e-6)
    # The gap 1400–1800 has its midpoint inside aten::copy_.
    assert math.isclose(s.idle_by_host["aten::copy_"], 400e-6)
    b = s.breakdown()
    assert b["device_ops"][0] == ["gemm_kernel", pytest.approx(100e-6)]
    assert len(b["idle_gaps"]) <= 10


def test_no_window_no_numbers():
    s = reduce_trace([_x("kernel", "k", 0, 10, correlation=1)])
    assert s.window_s == 0 and s.busy_s == 0


def test_poisson_offsets_fixed_count_and_seeded():
    poisson_offsets = Layout().module("arrivals", "poisson").offsets
    a = poisson_offsets(800.0, 2000, 2**31 + 5)
    assert len(a) == 2000 and a == sorted(a)
    assert a == poisson_offsets(800.0, 2000, 2**31 + 5)
    assert a != poisson_offsets(800.0, 2000, 2**31 + 6)
    assert abs(a[-1] - 2000 / 800.0) < 0.25
