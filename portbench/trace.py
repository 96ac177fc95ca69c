"""The traced window and its summary.

`traced(loop)` runs loop() under torch.profiler (host and, where there is
a card, the card's activities through CUPTI) inside a range named
WINDOW, and returns the chrome trace's events. `summarize` reduces them
to what the per-layer readers take: the window's length, the device's
busy time (the union of its kernels, copies and memsets inside the
window), the device time of each kernel name, and the idle gaps labelled
by the innermost host activity running at their midpoint.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

WINDOW = "portbench.window"
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
HOST = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
        "python_function")
LABELLED_GAPS = 500  # the longest gaps get a host label
TOP = 10


def traced(loop):
    """(loop()'s result, the trace's events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = loop()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return out, events


def _union(spans):
    """Merged, sorted (start, end) of possibly overlapping spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def summarize(events) -> dict:
    """Seconds throughout: `window_s`, `busy_s`, `kernels` {name: [launch
    records, seconds]}, `device_ops` [[name, seconds]] (the TOP names by
    time), `idle_gaps` [[host activity, seconds]] (the TOP labels by the
    time of the longest gaps they held), `gap_s`."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") in HOST]
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
    else:
        w0 = min((float(e["ts"]) for e in xs), default=0.0)
        w1 = max((float(e["ts"]) + float(e["dur"]) for e in xs), default=0.0)
    kernels = {}
    spans = []
    for e in xs:
        if e.get("cat") not in DEVICE:
            continue
        a = max(w0, float(e["ts"]))
        b = min(w1, float(e["ts"]) + float(e["dur"]))
        if b <= a:
            continue
        spans.append((a, b))
        k = kernels.setdefault(e["name"], [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e6
    busy = _union(spans)
    busy_us = sum(b - a for a, b in busy)
    edges = [w0] + [x for s in busy for x in s] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in xs if e.get("cat") in HOST and e.get("name") != WINDOW]
    idle = {}
    if host:
        ts = np.array([float(e["ts"]) for e in host])
        end = ts + np.array([float(e["dur"]) for e in host])
        for a, b in gaps[:LABELLED_GAPS]:
            mid = (a + b) / 2
            cover = np.nonzero((ts <= mid) & (end >= mid))[0]
            label = ("python" if cover.size == 0 else
                     host[cover[np.argmin(end[cover] - ts[cover])]]["name"])
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "gap_s": sum(b - a for a, b in gaps) / 1e6,
        "kernels": kernels,
        "device_ops": [[name[:120], v[1]] for name, v in ops],
        "idle_gaps": sorted(([k[:120], v] for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:TOP],
    }


def kernel_seconds(summary: dict, *parts: str) -> float:
    """Device seconds of the kernels whose name holds any of `parts`."""
    return sum(v[1] for name, v in summary["kernels"].items()
               if any(p in name for p in parts))
