"""Smoke tests for utility modules (viz, profiling)."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from optical_flow_tpu.utils.profiling import (
    Timer,
    device_kernels,
    device_loop_time,
    device_seconds_from_trace,
    flow_roofline,
    stage_roofline,
)
from optical_flow_tpu.utils.viz import draw_arrows, draw_circle, flow_to_color


def test_flow_to_color_shapes_and_range():
    u = np.random.RandomState(0).randn(32, 48).astype(np.float32)
    v = np.random.RandomState(1).randn(32, 48).astype(np.float32)
    img = flow_to_color(u, v)
    assert img.shape == (32, 48, 3) and img.dtype == np.uint8
    # zero flow -> black
    z = flow_to_color(np.zeros((8, 8)), np.zeros((8, 8)), max_mag=1.0)
    assert z.max() == 0


def test_draw_circle_and_arrows():
    img = np.zeros((64, 64, 3), np.uint8)
    out = draw_circle(img, 32, 32, 10, color=(255, 0, 0))
    assert (out[:, :, 0] == 255).any()
    assert img.max() == 0  # input untouched
    pts = np.array([[10.0, 10.0], [50.0, 50.0]])
    flows = np.array([[5.0, 0.0], [-5.0, 2.0]])
    out2 = draw_arrows(img, pts, flows)
    assert (out2[:, :, 1] == 255).any()  # green for dx>0
    assert (out2[:, :, 0] == 255).any()  # red for dx<0


def test_timer_segments():
    t = Timer()
    with t.segment("a"):
        pass
    with t.segment("a"):
        pass
    with t.segment("b"):
        pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    rep = t.report()
    assert "a" in rep and "ms/call" in rep


def test_device_loop_time_runs():
    dt = device_loop_time(lambda x: x * 2.0, (jnp.ones((16, 16)),), iters=3)
    assert dt > 0


def test_flow_roofline_model():
    r = flow_roofline(1080, 1080, device_kind="NVIDIA H100 80GB HBM3")
    assert r["bound"] in ("memory", "compute")
    assert r["sol_us"] >= max(r["t_mem_us"], r["t_compute_us"]) - 1e-9
    assert r["sol_fps"] > 0
    # 16 B/px over 3.35 TB/s: the H100 level is memory-bound
    assert r["bound"] == "memory"
    assert abs(r["t_mem_us"] - 16 * 1080 * 1080 / 3.35e6) < 1e-6


# A profiler trace recorded on one H100 (700 W): three calls of a jitted
# `_fixture_fn` (a loop fusion and a reduce fusion each), host tracers off.
H100_TRACE = os.path.join(os.path.dirname(__file__), "data", "h100_trace")


def test_device_kernels_reads_the_gpu_trace():
    k = device_kernels(H100_TRACE, "_fixture_fn")
    assert [n for n, _ in k] == ["loop_add_fusion", "input_reduce_fusion"] * 3
    assert sum(d for _, d in k) == 1632 + 1632 + 1536 + 1600 + 1536 + 1600
    assert device_seconds_from_trace(H100_TRACE, "_fixture_fn", 3) == pytest.approx(9.536e-6)


def test_device_time_fails_loudly(tmp_path):
    with pytest.raises(RuntimeError, match="no device kernel"):
        device_kernels(H100_TRACE, "_not_in_the_trace")
    with pytest.raises(RuntimeError, match="fewer than"):
        device_seconds_from_trace(H100_TRACE, "_fixture_fn", 7)
    with pytest.raises(RuntimeError, match="no .xplane.pb"):
        device_kernels(str(tmp_path), "_fixture_fn")


def test_peaks_unknown_device_is_an_error():
    with pytest.raises(ValueError, match="no published peaks"):
        stage_roofline(1e6, 1e6, 10.0, device_kind="cpu")
    # 3.35 GB at 3.35 TB/s is 1 ms; measured 2 ms is half the roofline
    r = stage_roofline(3.35e9, 0.0, 2000.0, device_kind="NVIDIA H100 80GB HBM3")
    assert r["sol_hbm_us"] == pytest.approx(1000.0) and r["bound"] == "memory"
    assert r["pct_of_hbm_roofline"] == pytest.approx(50.0)
