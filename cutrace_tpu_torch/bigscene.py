"""Steady-state frame time of big scenes: the subdivided bunny (counterpart
of benchmarks/bigscene.py and examples/big_scene.py).

    python -m cutrace_tpu_torch.bigscene [--levels 4] [--width 960]
        [--height 540] [--bounces 5] [--iters 3] [--out frame_big.jpg]
        [--device cuda]

Midpoint-subdivides scenes/bunny.json's mesh `levels` times (1000 * 4^levels
triangles; the surface is unchanged), prepares it with accel="auto" (the
fused kernels on the card: K3 past 32 clusters) and renders it: once to
build and warm up, then `iters` timed frames. It prints one JSON line:

  triangles, size, bounces, clusters (M), cluster_size (C)
  prepare_s     host seconds of prepare(): upload, median split, tables
  first_call_s  seconds of the first render (kernel build included)
  frame_s       the fastest timed frame: CUDA events on the card, the
                host clock with --device cpu (the plain version)
  mcasts_per_s  width * height * casts_per_pixel / frame_s / 1e6
  device, card  the device and, on the card, nvidia-smi's name and power
                limit

--device cpu runs the plain version: keep it to tiny sizes (--levels 1
--width 16 --height 9 --bounces 1).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import torch

from cutrace_tpu_torch.scene.loader import load_scene
from cutrace_tpu_torch.scene.mesh_io import subdivide
from cutrace_tpu_torch.scene.soa import resolve_device
from cutrace_tpu_torch.utils.profiling import casts_per_pixel

BUNNY = pathlib.Path(__file__).resolve().parents[1] / "scenes" / "bunny.json"


def card_name():
    """nvidia-smi's "name, power.limit" line for the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def subdivided_bunny(levels: int, width: int, height: int):
    """scenes/bunny.json at width x height with its mesh subdivided
    `levels` times; returns (scene, triangle count)."""
    sc = load_scene(str(BUNNY))
    sc.camera.width, sc.camera.height = width, height
    n_tris = 0
    for ob in sc.objects:
        if type(ob).__name__ == "Mesh":
            ob.vertices = subdivide(ob.vertices, levels)
            n_tris += ob.vertices.shape[0]
    return sc, n_tris


def _frame_s(fn, device):
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def run(levels=4, width=960, height=540, bounces=5, iters=3,
        device="cuda"):
    """Prepare and time the subdivided bunny; returns (row, prepared,
    last frame)."""
    from cutrace_tpu_torch.render.renderer import prepare, render

    device = resolve_device(device)
    sc, n_tris = subdivided_bunny(levels, width, height)
    t0 = time.perf_counter()
    prepared = prepare(sc, accel="auto", device=device, bounces=bounces)
    if device.type == "cuda":
        torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0

    def frame():
        return render(prepared, bounces=bounces)

    t0 = time.perf_counter()
    out = frame()
    if device.type == "cuda":
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        out, dt = _frame_s(frame, device)
        times.append(dt)
    frame_s = min(times)
    total_casts = width * height * casts_per_pixel(prepared.soa, bounces)
    accel = prepared.accel
    row = {
        "triangles": int(n_tris),
        "size": f"{width}x{height}",
        "bounces": bounces,
        "clusters": None if accel is None else int(accel.order.shape[0]),
        "cluster_size": None if accel is None else int(accel.order.shape[1]),
        "frame_s": frame_s,
        "mcasts_per_s": total_casts / frame_s / 1e6,
        "first_call_s": first_s,
        "prepare_s": prepare_s,
        "device": device.type,
        "card": card_name() if device.type == "cuda" else None,
    }
    return row, prepared, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cutrace_tpu_torch.bigscene")
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the frame as a JPEG")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    row, _, (color, _, _) = run(args.levels, args.width, args.height,
                                args.bounces, args.iters, args.device)
    if args.out:
        from cutrace_tpu_torch.io import images

        images.write_colorized(args.out, color.cpu().numpy())
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
