"""The trace summary over synthetic events, and the roofline's
arithmetic."""

import pytest

from portbench import roofline, trace
from portbench.reference.tracer import Counts


def x(name, cat, ts, dur, **kw):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, **kw}


EVENTS = [
    x(trace.WINDOW, "user_annotation", 1000.0, 1000.0),
    x("cudaGraphLaunch", "cuda_runtime", 1000.0, 20.0),
    x("k1", "kernel", 1020.0, 300.0),
    x("k1", "kernel", 1400.0, 300.0),  # a 80 us gap before it
    x("copy", "gpu_memcpy", 1650.0, 100.0),  # overlaps the kernel
    x("cudaStreamSynchronize", "cuda_runtime", 1750.0, 200.0),
    x("k2", "kernel", 1960.0, 100.0),  # runs past the window's end
    x("before", "kernel", 0.0, 500.0),  # before the window
]


def test_busy_is_the_union_inside_the_window():
    s = trace.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(1e-3)
    # 1020-1320, 1400-1750, 1960-2000
    assert s["busy_s"] == pytest.approx((300 + 350 + 40) / 1e6)
    assert s["gap_s"] == pytest.approx(s["window_s"] - s["busy_s"])
    assert s["kernels"]["k1"] == [2, pytest.approx(600 / 1e6)]
    assert s["kernels"]["k2"] == [1, pytest.approx(40 / 1e6)]
    assert "before" not in s["kernels"]
    assert s["device_ops"][0][0] == "k1"


def test_gaps_are_labelled_by_the_innermost_host_activity():
    s = trace.summarize(EVENTS)
    labels = dict(s["idle_gaps"])
    # 1750-1960 under the synchronize; 1000-1020 under the graph launch;
    # 1320-1400 under nothing but the window: python
    assert labels["cudaStreamSynchronize"] == pytest.approx(210 / 1e6)
    assert labels["cudaGraphLaunch"] == pytest.approx(20 / 1e6)
    assert labels["python"] == pytest.approx(80 / 1e6)


def test_kernel_seconds_matches_parts():
    s = trace.summarize(EVENTS)
    assert trace.kernel_seconds(s, "k1", "k2") == pytest.approx(640 / 1e6)
    assert trace.kernel_seconds(s, "nothing") == 0.0


def test_forward_bound_counts_casts_and_boxes():
    c = Counts(casts=10, tri_boxes=7, hit_nodes=4)
    tables = roofline.table_bytes(n_tris=2, n_planes=1, n_spheres=0,
                                  n_mats=1, n_lights=1)
    assert tables == 4 * (18 + 6 + 5 + 7 + 1)
    ops = 2 * (10 * (roofline.OPS_CAST + roofline.OPS_PLANE)
               + 7 * roofline.OPS_TRI)
    nbytes = 100 * 13 * 4 + tables
    got = roofline.forward_bound_s(c, 2.0, 100, tables, 1, 0)
    assert got == pytest.approx(max(nbytes / roofline.PEAK_BYTES,
                                    ops / roofline.PEAK_F32))


def test_backward_bound_counts_hit_nodes_and_lights():
    c = Counts(casts=10, tri_boxes=7, hit_nodes=1000)
    got = roofline.backward_bound_s(c, 1.0, 10, 0, 4)
    ops = 1000 * (roofline.OPS_VJP_NODE + 4 * roofline.OPS_VJP_LIGHT)
    assert got == pytest.approx(ops / roofline.PEAK_F32)
