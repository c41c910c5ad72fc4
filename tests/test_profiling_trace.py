"""Stage attribution of a GPU profiler trace (utils/profiling.py).

tests/data/gpu_trace_window12.json.gz holds the device-plane events of
24 steps of the windowed production program (window=12, N=317,080,
K=256) traced on an NVIDIA H100, plus the op_name map of the kernels
it names. Inside CUDA command buffers the kernels carry no scope path
(``hlo_op="command_buffer"``), so attribution goes through the kernel
names and, for library kernels, the preceding kernel of the graph."""

import gzip
import json
import pathlib

import pytest

from mcmc_ammsb.utils import profiling

FIXTURE = pathlib.Path(__file__).parent / "data" / "gpu_trace_window12.json.gz"


def _fixture():
    with gzip.open(FIXTURE, "rt") as f:
        return json.load(f)


def test_gpu_trace_attributes_window_stages():
    fx = _fixture()
    prof = profiling.reduce_trace({"traceEvents": fx["traceEvents"]},
                                  fx["hlo_op_scope_map"])
    assert prof["source"] == "hlo"
    total = prof["total_op_seconds"]
    assert total == pytest.approx(fx["expected"]["total_op_seconds"])
    assert sum(prof["stages"].values()) == pytest.approx(total)
    # one CUDA stream, no overlap: busy time equals the op-time sum
    assert prof["busy_seconds"] == pytest.approx(total)
    stages = prof["stages"]
    for name in ("window_body", "window_scatter", "window_correct",
                 "device_sampling", "neighbor_draws", "membership"):
        assert stages.get(name, 0) > 0, name
    # cuBLAS gemms of the window's one-hot selects land in window_body
    assert stages["window_body"] / total > 0.8
    assert stages.get("other", 0) / total < 0.02


def test_print_stage_profile_raises_when_nothing_is_attributed():
    fx = _fixture()
    prof = profiling.reduce_trace({"traceEvents": fx["traceEvents"]}, {})
    assert prof["source"] == "none"
    prof["steps"] = 24
    with pytest.raises(RuntimeError, match="attributable"):
        profiling.print_stage_profile(prof, log=lambda _: None)
