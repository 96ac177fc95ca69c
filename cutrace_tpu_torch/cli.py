"""Command-line renderer (counterpart of cutrace_tpu.cli).

`python -m cutrace_tpu_torch <scene.json>` keeps the reference CLI's
contract:

  no argument          -> usage on stderr, exit 255
  scene fails to load  -> full schema dump, exit 254
  success              -> scene dump, render with bounces=5 / fudge=1e-3,
                          timing line, and frame.jpg / depth_map.jpg /
                          normal_map.jpg in the output directory

Flags beyond the reference (all optional):
  --out DIR        output directory (default: the working directory)
  --bounces N      bounce depth (default 5)
  --width W        override the scene camera's width after loading
  --height H       override the scene camera's height after loading
  --strict         reject legacy schema aliases (e.g. "model",
                   "position"): such a scene fails to load with the
                   schema dump and exit 254
  --device DEV     cuda or cpu (default: cuda; without a card the run
                   fails unless --device cpu is given)
  --accel KIND     auto, none, clusters, pallas or fused (default auto:
                   the fused kernels on cuda, the composable torch path
                   on cpu); see render.renderer.prepare

With CUTRACE_TRACE=1 in the environment the run is traced
(utils.tracing) and, at exit, prints the trace's snapshot as one JSON
line on standard error: the set-up spans (scene.load, prepare and its
parts, kernels.load, program.build), the frame's spans and phases, and
the counters.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from cutrace_tpu_torch.io import images
from cutrace_tpu_torch.scene import schema as S
from cutrace_tpu_torch.scene import types as T
from cutrace_tpu_torch.scene.loader import load_file
from cutrace_tpu_torch.scene.soa import resolve_device
from cutrace_tpu_torch.utils import tracing


def dump_scene(scene: T.Scene, file=sys.stdout) -> None:
    """Scene summary in the reference's dump_scene_kernel format
    (kernel.hpp:150-166): per element, its type index within its kind's
    schema list (the gpu_variant type index in the reference)."""
    obj_kind = {T.Triangle: 0, T.Mesh: 1, T.Plane: 2, T.Sphere: 3}
    light_kind = {T.Sun: 0, T.PointLight: 1}

    print(f" -> Have {len(scene.objects):<4} objects:", file=file)
    for i, o in enumerate(scene.objects):
        print(
            f"  -> Object   #{i:<4} has type #{obj_kind[type(o)]:<2}",
            file=file,
        )
    print(f" -> Have {len(scene.lights):<4} lights:", file=file)
    for i, l in enumerate(scene.lights):
        print(
            f"  -> Light    #{i:<4} has type #{light_kind[type(l)]:<2}",
            file=file,
        )
    print(f" -> Have {len(scene.materials):<4} materials:", file=file)
    for i, _ in enumerate(scene.materials):
        print(f"  -> Material #{i:<4} has type #0 ", file=file)


def main(argv=None) -> int:
    try:
        return _main(argv)
    finally:
        if tracing.FROM_ENV:
            print(json.dumps(tracing.snapshot()), file=sys.stderr)


def _main(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="cutrace_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("scene", nargs="?", help="scene JSON file")
    parser.add_argument("--out", default=".", help="output directory")
    parser.add_argument("--bounces", type=int, default=5)
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--strict", action="store_true",
                        help="reject legacy schema aliases")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--accel", default="auto",
                        choices=("auto", "none", "clusters", "pallas",
                                 "fused"))
    args = parser.parse_args(argv)

    if args.scene is None:
        print(f"Usage: {parser.prog} <scene file>", file=sys.stderr)
        return 255

    result = load_file(args.scene, compat=not args.strict)
    if not result.ok:
        S.dump_schema(file=sys.stdout)
        return 254

    scene = result.scene
    if args.width:
        scene.camera.width = args.width
    if args.height:
        scene.camera.height = args.height
    dump_scene(scene)

    try:
        device = resolve_device(args.device)
    except RuntimeError:
        print("error: no CUDA device is available; pass --device cpu to "
              "run on the CPU", file=sys.stderr)
        return 1
    # geometry needs full float32 products on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from cutrace_tpu_torch.render.renderer import prepare, render
    from cutrace_tpu_torch.utils.profiling import timed_render

    total_start = time.perf_counter()
    prepared = prepare(scene, accel=args.accel, device=device,
                       bounces=args.bounces)
    # warm-up: builds the kernels on first use, fills the caches and, on
    # the card, captures the frame's program; the timed render below (a
    # replay) is the one reported
    warm_start = time.perf_counter()
    render(prepared, bounces=args.bounces, fudge=1e-3)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    warm_ms = (time.perf_counter() - warm_start) * 1000.0
    (color, depth, normal), timings = timed_render(
        prepared, args.bounces, fudge=1e-3, warmup=False)
    color, depth, normal = (x.cpu().numpy() for x in (color, depth, normal))
    total_ms = (time.perf_counter() - total_start) * 1000.0 - warm_ms
    print(f"Warm-up time was {warm_ms:.0f} ms (excluded below).")
    print(
        f"Render time was {timings.render_ms:.0f} ms; kernel time with "
        f"setup/teardown was {total_ms:.0f} ms."
    )

    out = args.out.rstrip("/") or "."
    os.makedirs(out, exist_ok=True)
    images.write_depth_map(f"{out}/depth_map.jpg", depth,
                           images.max_finite_depth(depth))
    images.write_normal_map(f"{out}/normal_map.jpg", normal)
    images.write_colorized(f"{out}/frame.jpg", color)
    return 0


if __name__ == "__main__":
    sys.exit(main())
