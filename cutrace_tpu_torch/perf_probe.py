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
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from cutrace_tpu_torch import load_scene
from cutrace_tpu_torch.ops import _build, fused
from cutrace_tpu_torch.render.renderer import block_rays, prepare, render

SCENES = ("bunny.json", "mirror.json", "sphere_plane.json")
BOUNCES = 5
PROFILED = 5


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _event_ms(fn, reps):
    """Mean milliseconds of fn() over reps calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
        "wrapper_ms": [_event_ms(wrapper, 10) for _ in range(3)],
        "render_ms": [_event_ms(frame, 10) for _ in range(3)],
    }
    wall = _event_ms(frame, PROFILED)
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
        first = _event_ms(plain_fn, 1)
        rec["wrapper_ms"].append(_event_ms(wrapper, 10))
        rec["plain_ms"] = [first, _event_ms(plain_fn, 1)]
    print(json.dumps(rec), flush=True)
    print(ops.table(sort_by="self_device_time_total", row_limit=10),
          flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cutrace_tpu_torch.perf_probe")
    ap.add_argument("--scenes", nargs="+", default=list(SCENES))
    ap.add_argument("--plain", nargs="*", default=[],
                    help="scenes whose plain version is timed too")
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
    print("smi", _smi(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
