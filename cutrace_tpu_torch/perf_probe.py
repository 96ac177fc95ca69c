"""Frame-time breakdown of the fused path on one CUDA card.

    python -m cutrace_tpu_torch.perf_probe [--scenes bunny.json ...]
                                           [--plain bunny.json ...]

Run from the repository root. For each scene, at its authored size and
bounce depth 5, it prints the card's `nvidia-smi` name, power limit and
clocks, then one JSON line:

  wrapper_ms  fused_render_rays on the prepared tables (3 means of 10
              calls, CUDA events)
  render_ms   render(prepare(...)), what the CLI times (3 means of 10)
  kernel_ms, device_ms, htod_ms, device_ops
              from torch.profiler over 5 renders, per render: the fused
              kernel's device time, all device ops' time, host-to-device
              copies, and the number of device ops
  idle_share  1 - device_ms / (the mean event time of those 5 renders)
  plain_ms    (scenes named by --plain) the plain version's time, twice,
              around one more wrapper_ms mean

and the profiler's top device ops. The numbers are per render in ms.

    python -m cutrace_tpu_torch.perf_probe --scenes --pallas-trace [PATH]

traces one warm `--accel pallas` bunny 1920x1080 b5 render (the CLI's
frame) with torch.profiler, host and device, and prints what it spent
where (`trace_summary`): the wall time, the device's busy time (the union
of its kernels, copies and memsets) and idle share, the gaps between
device activities, the runtime calls, the torch ops called and their
self time, and the kernels by device time, with the culling cast's (K4)
launches and device time. PATH (gzipped JSON) keeps the chrome trace.

    python -m cutrace_tpu_torch.perf_probe --scenes --step-trace [PATH]

traces one warm training step over all 19 parameter groups (`grad_step`:
loss mean((c - 0.9 c0)^2), capturable Adam) the same way, once as a
replay of the step program and once op by op (program=False), on bunny
1920x1080 b5 "fused" and bunny 480x270 b5 "pallas", and prints the four
summaries, each with its graph and kernel launches and synchronizing
runtime calls (the trace's own closing synchronize among them). PATH
keeps the replayed bunny 1080p step's chrome trace.

    python -m cutrace_tpu_torch.perf_probe --scenes --k4-records N

traces N warm `--accel pallas` bunny 1920x1080 b5 frames one by one with
a CUDA-only torch.profiler, N replays of the chunk program and N frames of
the eager loop (`render_eager`) in turns, and prints one JSON line with
the number of K4 kernel records each trace holds and their device time:
how far a trace's count of a frame's launches can be trusted.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import pathlib
import subprocess
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from cutrace_tpu_torch import load_scene
from cutrace_tpu_torch.diff.grad import extract_params, render_image_flat
from cutrace_tpu_torch.ops import _build, fused, pallas_cast
from cutrace_tpu_torch.parallel.train import make_train_step
from cutrace_tpu_torch.render.renderer import (block_rays, prepare, render,
                                               render_eager)
from cutrace_tpu_torch.utils.profiling import event_ms, kernel_records

SCENES = ("bunny.json", "mirror.json", "sphere_plane.json")
BOUNCES = 5
PROFILED = 5


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def probe(path: pathlib.Path, plain: bool) -> dict:
    prepared = prepare(load_scene(path), accel="fused", device="cuda",
                       bounces=BOUNCES)
    soa, accel = prepared.soa, prepared.accel
    o, d, _ = block_rays(soa)

    def wrapper():
        return fused.fused_render_rays(soa, accel, o, d, 1e-3, BOUNCES,
                                       tables=prepared.tables)

    def frame():
        return render(prepared, bounces=BOUNCES)

    wrapper()
    frame()
    torch.cuda.synchronize()
    rec = {
        "scene": path.name, "width": soa.width, "height": soa.height,
        "bounces": BOUNCES, "clusters": int(accel.order.shape[0]),
        "wrapper_ms": [event_ms(wrapper, 10) for _ in range(3)],
        "render_ms": [event_ms(frame, 10) for _ in range(3)],
    }
    wall = event_ms(frame, PROFILED)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            frame()
        torch.cuda.synchronize()
    ops = prof.key_averages()
    dev = [e for e in ops if e.self_device_time_total > 0]

    def per_frame_ms(events):
        return sum(e.self_device_time_total for e in events) / PROFILED / 1e3

    rec.update(
        kernel_ms=per_frame_ms(e for e in dev
                               if "fused_forward" in e.key),
        device_ms=per_frame_ms(dev),
        htod_ms=per_frame_ms(e for e in dev if "HtoD" in e.key),
        device_ops=sum(e.count for e in dev) / PROFILED,
        render_event_ms=wall,
    )
    rec["idle_share"] = 1.0 - rec["device_ms"] / wall
    if plain:
        def plain_fn():
            return fused.fused_render_rays_plain(soa, accel, o, d, 1e-3,
                                                 BOUNCES)
        first = event_ms(plain_fn, 1)
        rec["wrapper_ms"].append(event_ms(wrapper, 10))
        rec["plain_ms"] = [first, event_ms(plain_fn, 1)]
    print(json.dumps(rec), flush=True)
    print(ops.table(sort_by="self_device_time_total", row_limit=10),
          flush=True)
    return rec


def _device_intervals(events):
    """Sorted (start, end) µs of the device activities of a chrome trace:
    kernels, copies and memsets."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in (
                      "kernel", "gpu_memcpy", "gpu_memset"))


def trace_summary(events, key_averages, wall_ms):
    """What one traced frame spent where: the device's busy time (the
    union of its activities) and idle share over the traced wall time,
    the gaps between device activities, kernel launches and copies by the
    host, host ops by count and self time, and the device time of the
    kernels by name."""
    spans = _device_intervals(events)
    busy, gaps, end = 0.0, [], None
    for a, b in spans:
        if end is not None and a > end:
            gaps.append(a - end)
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    runtime = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cuda_runtime":
            runtime[e["name"]] = runtime.get(e["name"], 0) + 1
    kernels = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            k = kernels.setdefault(e["name"][:60], [0, 0.0])
            k[0] += 1
            k[1] += e["dur"]
    ops = sorted(((a.key, a.count, a.self_cpu_time_total)
                  for a in key_averages), key=lambda x: -x[2])
    # torch ops the Python code called: cpu_op events not nested in
    # another one of their thread
    top, ends = 0, {}
    for e in sorted((e for e in events if e.get("ph") == "X"
                     and e.get("cat") == "cpu_op"), key=lambda e: e["ts"]):
        if e["ts"] >= ends.get(e["tid"], -1.0):
            top += 1
            ends[e["tid"]] = e["ts"] + e["dur"]
    big_gaps = [g for g in gaps if g > 50.0]
    launches = {name: runtime.get(name, 0)
                for name in ("cudaGraphLaunch", "cudaLaunchKernel")}
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
        "device_activities": len(spans),
        "gaps": len(gaps), "gaps_ms": sum(gaps) / 1e3,
        "gaps_over_50us": len(big_gaps),
        "gaps_over_50us_ms": sum(big_gaps) / 1e3,
        "largest_gap_ms": max(gaps, default=0.0) / 1e3,
        "runtime_calls": dict(sorted(runtime.items(),
                                     key=lambda kv: -kv[1])[:8]),
        **launches,
        "syncs": sum(n for k, n in runtime.items() if "Synchronize" in k),
        "host_ops": top,
        "host_ops_nested": sum(1 for e in events if e.get("ph") == "X"
                               and e.get("cat") == "cpu_op"),
        "top_host_ops": [(k, c, round(t / 1e3, 3)) for k, c, t in ops[:12]],
        "top_kernels": sorted(
            ([k, n, round(t / 1e3, 3)] for k, (n, t) in kernels.items()),
            key=lambda x: -x[2])[:10],
        "k4": [sum(n for k, (n, _) in kernels.items()
                   if "cluster_cast" in k),
               sum(t for k, (_, t) in kernels.items()
                   if "cluster_cast" in k) / 1e3],
    }


def traced(fn, out_path=None) -> dict:
    """trace_summary of torch.profiler (host and device) over fn() and a
    closing synchronize; out_path (gzipped JSON) keeps the chrome
    trace."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        if out_path is not None:
            out_path.parent.mkdir(parents=True, exist_ok=True)
            with open(path, "rb") as f, gzip.open(out_path, "wb") as g:
                g.write(f.read())
    return trace_summary(events, prof.key_averages(), wall_ms)


def _bunny(accel):
    return prepare(load_scene(pathlib.Path.cwd() / "scenes" / "bunny.json"),
                   accel=accel, device="cuda")


def pallas_trace(out_path=None) -> dict:
    """torch.profiler (host and device) over one warm --accel pallas bunny
    1920x1080 b5 render: where the composable path's time goes."""
    prepared = _bunny("pallas")
    render(prepared, bounces=BOUNCES)
    torch.cuda.synchronize()
    summary = traced(lambda: render(prepared, bounces=BOUNCES), out_path)
    print(json.dumps({"pallas_trace": summary}), flush=True)
    return summary


def grad_step(prepared, bounces: int = BOUNCES, program: bool = True,
              lr: float = 0.0):
    """A training step over all 19 parameter groups of a prepared scene,
    loss mean((c - 0.9 c0)^2) with c0 the scene's render (chip_smoke.py
    grad's), through make_train_step with Adam (eps 1e-8; capturable on
    the card, as fit builds it): (step() -> loss, params). At lr 0 the
    update's arithmetic runs in full and leaves the parameters as they
    are, so every call differentiates at the same point."""
    soa, accel = prepared.soa, prepared.accel
    with torch.no_grad():
        c0, _, _ = render_image_flat(soa, bounces, 1e-3, accel)
    target = 0.9 * c0
    params = {k: v.detach().clone().requires_grad_()
              for k, v in extract_params(soa).items()}
    opt = torch.optim.Adam(list(params.values()), lr=lr, eps=1e-8,
                           capturable=soa.device.type == "cuda")
    step = make_train_step(opt, bounces, accel=accel, program=program)
    return (lambda: step(params, soa, target)), params


def step_trace(out_path=None) -> dict:
    """torch.profiler over one warm training step (grad_step), a replay
    of the step program and the op-by-op step: bunny 1920x1080 b5
    "fused" (K1 with codes, K2) and bunny 480x270 b5 "pallas" (K4 under
    autograd)."""
    small = load_scene(pathlib.Path.cwd() / "scenes" / "bunny.json")
    small.camera.width, small.camera.height = 480, 270
    cases = {"fused_1080p": _bunny("fused"),
             "pallas_480x270": prepare(small, accel="pallas",
                                       device="cuda")}
    rec = {}
    for name, prepared in cases.items():
        rec[name] = {}
        for key, program in (("program", True), ("eager", False)):
            step, _ = grad_step(prepared, program=program)
            for _ in range(3):  # eager, capture and replay, replay
                step()
            torch.cuda.synchronize()
            keep = out_path if program and name == "fused_1080p" else None
            rec[name][key] = traced(step, keep)
            del step
    print(json.dumps({"step_trace": rec}), flush=True)
    return rec


def _k4_records(fn):
    """(K4 kernel records, their device ms) in a CUDA-only trace of fn()."""
    durs = kernel_records(fn, "cluster_cast")
    return len(durs), sum(durs)


def k4_records(frames: int) -> dict:
    """K4's records in traces of `frames` warm pallas frames, replayed and
    eager in turns, beside the launch counters of one frame of each."""
    prepared = _bunny("pallas")
    runs = {"program": lambda: render(prepared, bounces=BOUNCES),
            "eager": lambda: render_eager(prepared, bounces=BOUNCES)}
    rec = {}
    for key, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        before = pallas_cast.LAUNCHES
        fn()
        torch.cuda.synchronize()
        rec[key] = {"counted": pallas_cast.LAUNCHES - before,
                    "records": [], "ms": []}
    for _ in range(frames):
        for key, fn in runs.items():
            n, ms = _k4_records(fn)
            rec[key]["records"].append(n)
            rec[key]["ms"].append(ms)
    print(json.dumps({"k4_records": rec}), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cutrace_tpu_torch.perf_probe")
    ap.add_argument("--scenes", nargs="*", default=list(SCENES))
    ap.add_argument("--plain", nargs="*", default=[],
                    help="scenes whose plain version is timed too")
    ap.add_argument("--pallas-trace", nargs="?", type=pathlib.Path,
                    const=False, default=None, metavar="PATH",
                    help="trace one --accel pallas bunny frame; PATH "
                         "keeps the chrome trace (gzipped JSON)")
    ap.add_argument("--step-trace", nargs="?", type=pathlib.Path,
                    const=False, default=None, metavar="PATH",
                    help="trace replayed and op-by-op training steps "
                         "(bunny 1080p b5 fused, 480x270 b5 pallas); PATH "
                         "keeps the replayed 1080p step's chrome trace "
                         "(gzipped JSON)")
    ap.add_argument("--k4-records", type=int, default=0, metavar="N",
                    help="count K4's records in N traced pallas frames, "
                         "replayed and eager")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("perf_probe needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    root = pathlib.Path.cwd() / "scenes"
    for name in args.scenes:
        print("smi", _smi(), flush=True)
        probe(root / name, name in args.plain)
    if args.pallas_trace is not None:
        print("smi", _smi(), flush=True)
        pallas_trace(args.pallas_trace or None)
    if args.step_trace is not None:
        print("smi", _smi(), flush=True)
        step_trace(args.step_trace or None)
    if args.k4_records:
        print("smi", _smi(), flush=True)
        k4_records(args.k4_records)
    print("smi", _smi(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
