"""The port's profiling module (cutrace_tpu_torch.utils.profiling) against
the JAX package's: RenderTimings' numbers and text, timed_render, and a
torch.profiler trace summary."""

import pytest
import torch

from cutrace_tpu.scene.loader import load_scene
from cutrace_tpu.utils import profiling as JP
from cutrace_tpu_torch.render import renderer as TR
from cutrace_tpu_torch.utils import profiling as TP
from test_torch_host import port_scene

torch.set_num_threads(2)


@pytest.mark.parametrize("args", [
    (12.5, 40.25, 1920, 1080, 78),
    (0.0, 0.0, 0, 0, 0),
    (1234.56, 2000.0, 480, 270, 1),
])
def test_render_timings_match_jax(args):
    """Same fields, properties and text as the JAX package's."""
    ours, theirs = TP.RenderTimings(*args), JP.RenderTimings(*args)
    for name in ("render_ms", "total_ms", "width", "height",
                 "casts_per_pixel", "total_casts", "mcasts_per_s",
                 "primary_mrays_per_s"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert str(ours) == str(theirs)
    assert str(ours).startswith("Render time was ")


def _prepared(scenes_dir, accel):
    sc = load_scene(scenes_dir / "mirror.json")
    sc.camera.width, sc.camera.height = 24, 14
    return TR.prepare(port_scene(sc), accel=accel, device="cpu")


@pytest.mark.parametrize("accel", ["none", "fused"])
def test_timed_render_returns_render_images(scenes_dir, accel):
    """timed_render's images are render's, its timings name the frame's
    size and the JAX unit's casts a pixel, and its text is the CLI's
    line."""
    p = _prepared(scenes_dir, accel)
    (c, d, n), t = TP.timed_render(p, bounces=2)
    for a, b in zip((c, d, n), TR.render(p, bounces=2)):
        assert torch.equal(a, b)
    assert (t.width, t.height) == (24, 14)
    assert t.casts_per_pixel == TP.casts_per_pixel(p.soa, 2)
    assert 0.0 < t.render_ms <= t.total_ms
    assert "Render time was" in str(t)


def test_timed_render_prepares_a_scene(scenes_dir):
    sc = load_scene(scenes_dir / "triangle.json")
    sc.camera.width = sc.camera.height = 8
    (c, _, _), t = TP.timed_render(port_scene(sc), bounces=1, warmup=False,
                                   device="cpu")
    assert tuple(c.shape) == (8, 8, 3) and t.total_ms >= t.render_ms


def test_trace_summary_counts_launches_and_syncs():
    """perf_probe.trace_summary of a synthetic chrome trace: the device's
    busy time over the union of its activities, the idle share, graph
    and kernel launches and the synchronizing runtime calls."""
    from cutrace_tpu_torch import perf_probe

    def x(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": tid}

    events = [
        x("cuda_runtime", "cudaGraphLaunch", 0.0, 5.0),
        x("cuda_runtime", "cudaLaunchKernel", 6.0, 2.0),
        x("cuda_runtime", "cudaLaunchKernel", 9.0, 2.0),
        x("cuda_runtime", "cudaStreamSynchronize", 12.0, 1.0),
        x("cuda_runtime", "cudaDeviceSynchronize", 40.0, 1.0),
        x("kernel", "cluster_cast_kernel", 10.0, 10.0),
        x("kernel", "k", 15.0, 10.0),  # overlaps the first
        x("gpu_memcpy", "Memcpy DtoD", 30.0, 5.0),
        x("cpu_op", "aten::clone", 1.0, 4.0),
        x("cpu_op", "aten::copy_", 2.0, 1.0),  # nested in the clone
    ]
    s = perf_probe.trace_summary(events, [], wall_ms=0.05)
    assert s["device_busy_ms"] == pytest.approx(0.020)
    assert s["device_idle_share"] == pytest.approx(0.6)
    assert (s["gaps"], s["gaps_ms"]) == (1, pytest.approx(0.005))
    assert s["cudaGraphLaunch"] == 1 and s["cudaLaunchKernel"] == 2
    assert s["syncs"] == 2
    assert (s["host_ops"], s["host_ops_nested"]) == (1, 2)
    assert s["k4"] == [1, pytest.approx(0.010)]
