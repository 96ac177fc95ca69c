"""Timing, throughput units and profiling (counterpart of
cutrace_tpu.utils.profiling).

`RenderTimings` is the reference's render_ms / total_ms pair plus the JAX
package's derived cast throughput, so that Mcasts/s means what it means
there. `timed_render` times one warm frame: by CUDA events on the card,
by the host clock on the CPU. `device_trace` records a torch.profiler
trace (host ops, and the card's kernels and copies where there is a
card) as a chrome trace, and `summarize_trace` sums it by name.

For benchmarks: `event_ms` (CUDA events around many calls),
`sample_ms` (one time a call), `kernel_records` (a kernel's device time
a launch from a CUDA-only trace) and `spread` (median, the highest
percentile with ten samples beyond it, and the count).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import glob
import json
import os
import time

import torch


@dataclasses.dataclass
class RenderTimings:
    """Render timing + throughput (the reference's render_ms/total_ms pair,
    kernel.hpp:128-129, plus derived cast throughput)."""

    render_ms: float  # the timed frame
    total_ms: float  # incl. scene prep / host conversion
    width: int = 0
    height: int = 0
    casts_per_pixel: int = 0

    @property
    def total_casts(self) -> int:
        return self.width * self.height * self.casts_per_pixel

    @property
    def mcasts_per_s(self) -> float:
        return self.total_casts / max(self.render_ms, 1e-9) / 1e3

    @property
    def primary_mrays_per_s(self) -> float:
        return self.width * self.height / max(self.render_ms, 1e-9) / 1e3

    def __str__(self) -> str:
        return (
            f"Render time was {self.render_ms:.0f} ms; kernel time with "
            f"setup/teardown was {self.total_ms:.0f} ms "
            f"({self.mcasts_per_s:.1f} Mcasts/s)"
        )


def casts_per_pixel(soa, bounces: int) -> int:
    """Nearest-hit scene queries per pixel for the compiled bounce tree:
    nodes * (1 + n_lights * shadow_steps), where the node count follows
    the static branch pruning in render/shading.py. It counts the march's
    capacity, not the steps a run takes."""
    if soa.any_reflective and soa.any_transparent:
        nodes = 2 ** (bounces + 1) - 1
    elif soa.any_reflective or soa.any_transparent:
        nodes = bounces + 1
    else:
        nodes = 1
    return nodes * (1 + soa.n_lights * soa.shadow_steps)


def timed_render(prepared_or_scene, bounces: int = 5, fudge: float = 1e-3,
                 warmup: bool = True, device="cuda"):
    """render() with the reference's timing discipline: ((color, depth,
    normal), RenderTimings). The warm-up frame (kernel builds, and on the
    card the frame program's capture) is left out; then one frame is
    timed, by CUDA events on the card and by the host clock on the CPU.
    total_ms adds preparation (when handed a Scene, prepared on
    `device`) and the wait for the frame."""
    from cutrace_tpu_torch.render.renderer import (PreparedScene, prepare,
                                                   render)

    total_start = time.perf_counter()
    prepared = (prepared_or_scene
                if isinstance(prepared_or_scene, PreparedScene)
                else prepare(prepared_or_scene, device=device))
    prep_ms = (time.perf_counter() - total_start) * 1000.0
    on_card = prepared.soa.device.type == "cuda"
    if warmup:
        render(prepared, bounces=bounces, fudge=fudge)
        if on_card:
            torch.cuda.synchronize(prepared.soa.device)
    host_start = time.perf_counter()
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = render(prepared, bounces=bounces, fudge=fudge)
        end.record()
        end.synchronize()
        render_ms = start.elapsed_time(end)
    else:
        out = render(prepared, bounces=bounces, fudge=fudge)
        render_ms = (time.perf_counter() - host_start) * 1000.0
    soa = prepared.soa
    timings = RenderTimings(
        render_ms=render_ms,
        total_ms=prep_ms + (time.perf_counter() - host_start) * 1000.0,
        width=soa.width,
        height=soa.height,
        casts_per_pixel=casts_per_pixel(soa, bounces),
    )
    return out, timings


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler over the block: host ops, and the card's kernels,
    copies and memsets where a card is present. Yields log_dir; on exit
    the chrome trace is written there as trace_<ns>.json, for
    `summarize_trace(log_dir)`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps calls, by one pair of CUDA
    events around them all."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sample_ms(fn, n: int, device) -> list:
    """Milliseconds of each of n calls of fn(): CUDA events around each
    call on a CUDA `device`, the host clock on the CPU."""
    out = []
    for _ in range(n):
        if torch.device(device).type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def kernel_records(fn, kernel: str) -> list:
    """Device milliseconds of each record of a kernel whose name holds
    `kernel` in a CUDA-only torch.profiler trace of one fn() call, in
    launch order. Such a trace may drop a few records: it is a time, not
    a count of launches."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    hits = sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") == "kernel" and kernel in e["name"]),
                  key=lambda e: e["ts"])
    return [e["dur"] / 1e3 for e in hits]


def spread(samples) -> dict:
    """The median of `samples`, the highest percentile with at least ten
    samples beyond it ("p80" of 50 samples, the 40th smallest; none of
    ten or fewer: "percentile" is then None) and their count."""
    xs = sorted(samples)
    n = len(xs)
    out = {"median": (xs[(n - 1) // 2] + xs[n // 2]) / 2 if n else None}
    k = n - 10  # the k-th smallest has n - k = 10 samples beyond it
    if k >= 1:
        name = f"p{100 * k // n}"
        out.update({"percentile": name, name: xs[k - 1]})
    else:
        out["percentile"] = None
    out["n"] = n
    return out


# chrome-trace categories of the card's own activities
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize_trace(log_dir: str, top: int = 20):
    """Durations summed by name over the newest trace in log_dir: the
    card's activities (DEVICE_CATEGORIES) when the trace holds any, else
    the host's torch ops. Returns [(name, total_ms, count)] by total time,
    at most `top` of them."""
    paths = sorted(glob.glob(os.path.join(log_dir, "trace_*.json")),
                   key=os.path.getmtime)
    if not paths:
        return []
    with open(paths[-1]) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    chosen = device or [e for e in events if e.get("cat") == "cpu_op"]
    tot = collections.Counter()
    cnt = collections.Counter()
    for e in chosen:
        tot[e["name"]] += e["dur"]
        cnt[e["name"]] += 1
    return [(n, d / 1000.0, cnt[n]) for n, d in tot.most_common(top)]
