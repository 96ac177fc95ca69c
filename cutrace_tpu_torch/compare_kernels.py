"""Time the kernels (K1, K2, K3, K4) of several checkouts of this
repository on one CUDA card, in turns.

    python -m cutrace_tpu_torch.compare_kernels ROOT [ROOT ...]
        [--labels NAME ...] [--order I ...] [--cases NAME ...]

Run from the repository root. Each ROOT is a checkout of the repository,
for instance an older commit unpacked with `git archive` into a directory
that .gitignore lists. For each index in --order (by default the roots,
then the roots in reverse: parent, change, change, parent), a subprocess
started in that root builds its kernels and times them by CUDA events
(mean of 10 calls after a warm-up) on each case:

  bunny       scenes/bunny.json at its authored 1920x1080, b5: K1, the
              `fused_render_rays` call
  bunny/256k  the bunny's mesh subdivided 4 times, 960x540 b5 (K3)
  bunny/1M    subdivided 5 times, 960x540 b5 (K3)
  vjp/bunny   K2 on bunny 1920x1080 b5, codes from that checkout's own
              forward, numpy-seeded color, depth and normal cotangents
  vjp/256k    K2 on the 256k bunny at 160x90 b5 (global-memory sums)
  cast/bunny  K4 on one 65,536-ray chunk of bunny 1920x1080 b5 primary
              rays (a chunk of the `--accel pallas` frame's primary cast)
  cast/frame  K4 summed over one `--accel pallas` bunny 1920x1080 b5
              render (`render`), with its launch count
  render/fused   `render` of bunny 1920x1080 b5 prepared "fused" (the
              CLI's frame), CUDA events, mean of 10
  render/pallas  the same prepared "pallas" (the `--accel pallas`
              frame), mean of 2

K1 and K3 are timed by CUDA events around `fused_render_rays`, the
frames by CUDA events around `render`. K2 and K4
are timed as the device time of their kernels alone, read from a
torch.profiler trace (the kernels whose names hold `replay_vjp_kernel` or
`cluster_cast_kernel`): CUDA events around a launch would add the host's
launch latency whenever the card waits on the host, as it does between
the composable path's launches. It calls only what every checkout since
the culling cast (K4) has: `load_scene`, `bigscene.subdivided_bunny`,
`prepare`, `block_rays`, `render`, `ops.fused.fused_render_rays`,
`ops.replay_vjp.backward_tables` and `vjp_tables`, and
`ops.pallas_cast.cast_clusters`.
Each run prints one JSON line with the card's `nvidia-smi` name and power
limit; the last line is a JSON summary of every case's times per label.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

# name: (what is timed, subdivision levels, width, height), bounces 5
CASES = {"bunny": ("forward", 0, 1920, 1080),
         "bunny/256k": ("forward", 4, 960, 540),
         "bunny/1M": ("forward", 5, 960, 540),
         "vjp/bunny": ("vjp", 0, 1920, 1080),
         "vjp/256k": ("vjp", 4, 160, 90),
         "cast/bunny": ("cast", 0, 1920, 1080),
         "cast/frame": ("frame", 0, 1920, 1080),
         "render/fused": ("render", 0, 1920, 1080),
         "render/pallas": ("render_pallas", 0, 1920, 1080)}

# what a run does in its root: build, prepare each case, time its kernel
_CHILD = r"""
import json, os, subprocess, sys, tempfile
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
from cutrace_tpu_torch import bigscene, load_scene
from cutrace_tpu_torch.ops import fused
from cutrace_tpu_torch.ops import pallas_cast as pc
from cutrace_tpu_torch.ops import replay_vjp as rv
from cutrace_tpu_torch.render.renderer import block_rays, prepare, render

def event_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps

# device ms a call of the kernels whose names hold `kernel`, and their
# launches a call, from a profiler trace of reps calls
def device_ms(fn, reps, kernel):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    durs = [e["dur"] for e in events if e.get("ph") == "X"
            and e.get("cat") == "kernel" and kernel in e["name"]]
    return sum(durs) / 1e3 / reps, len(durs) / reps

torch.backends.cuda.matmul.allow_tf32 = False
out = {}
for name, (what, levels, w, h) in json.loads(sys.argv[1]).items():
    if levels == 0:
        sc = load_scene("scenes/bunny.json")
        sc.camera.width, sc.camera.height = w, h
    else:
        sc, _ = bigscene.subdivided_bunny(levels, w, h)
    culls = what in ("cast", "frame", "render_pallas")
    p = prepare(sc, accel="pallas" if culls else "fused", device="cuda",
                bounces=5)
    o, d, _ = block_rays(p.soa)
    if what == "forward":
        fn = lambda: fused.fused_render_rays(p.soa, p.accel, o, d, 1e-3, 5,
                                             tables=p.tables)
    elif what == "vjp":
        *_, codes = fused.fused_render_rays(p.soa, p.accel, o, d, 1e-3, 5,
                                            emit_topo=True, tables=p.tables)
        rng = np.random.default_rng(0)
        r = o.shape[0]
        cot = tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                    .cuda() for s in ((r, 3), (r,), (r, 3)))
        tabs = rv.backward_tables(p.soa)
        fn = lambda: rv.vjp_tables(p.soa, *tabs, o, d, codes, cot, 1e-3, 5)
    elif what in ("frame", "render", "render_pallas"):
        fn = lambda: render(p, bounces=5)
    else:
        oc = (o - p.soa.scene_center)[:65536].contiguous()
        dc = d[:65536].contiguous()
        md = torch.full((oc.shape[0],), 1e-3, device="cuda")
        fn = lambda: pc.cast_clusters(p.tables, oc, dc, md)
    fn()
    torch.cuda.synchronize()
    rec = {"clusters": int(p.accel.order.shape[0]),
           "cluster_size": int(p.accel.order.shape[1])}
    if what in ("forward", "render"):
        rec["ms"] = event_ms(fn, 10)
    elif what == "render_pallas":
        rec["ms"] = event_ms(fn, 2)
    else:
        kernel = "replay_vjp" if what == "vjp" else "cluster_cast"
        rec["ms"], rec["launches"] = device_ms(
            fn, 2 if what == "frame" else 10, kernel + "_kernel")
    out[name] = rec
    del p, o, d, fn
    torch.cuda.empty_cache()
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip().splitlines()[0]
print(json.dumps({"card": smi, "cases": out}))
"""


def run(root: pathlib.Path, cases: dict, timeout: float) -> dict:
    """One run of the timing code in `root`; its JSON line as a dict."""
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(cases)], cwd=root,
        capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"timing run in {root} failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cutrace_tpu_torch.compare_kernels")
    ap.add_argument("roots", nargs="+", type=pathlib.Path)
    ap.add_argument("--labels", nargs="*")
    ap.add_argument("--order", nargs="*", type=int)
    ap.add_argument("--cases", nargs="*", choices=list(CASES),
                    default=list(CASES))
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    labels = args.labels or [str(r) for r in args.roots]
    if len(labels) != len(args.roots):
        ap.error("one label per root")
    order = args.order
    if order is None:
        order = list(range(len(args.roots)))
        order += order[::-1]
    cases = {k: CASES[k] for k in args.cases}
    summary = {label: {k: [] for k in cases} for label in labels}
    for i in order:
        rec = run(args.roots[i], cases, args.timeout)
        rec["label"] = labels[i]
        print(json.dumps(rec), flush=True)
        for k, v in rec["cases"].items():
            summary[labels[i]][k].append(v["ms"])
    print(json.dumps({"ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
