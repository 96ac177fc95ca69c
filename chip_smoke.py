"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
drives the port's main path once and fails (non-zero exit, no result
line) if any phase fails:

  1. probe   torch / CUDA versions, the card's name and power limit, nvcc
  2. build   compile the fused forward kernel from
             cutrace_tpu_torch/ops/csrc/ for sm_90a (seconds taken)
  3. parity  the kernel against its plain PyTorch version, same rays on
             the same card: triangle 20x20 b5, bunny / mirror /
             sphere_plane 480x270 b5. Gate (tests/test_fused.py
             _compare): np.isclose(atol=2e-4), no mismatch off the
             reference image's discontinuities, at most 5 % of edge pixels
  4. timing  bunny 1920x1080 b5 frame through the kernel and through the
             plain version, CUDA events, in turns plain, kernel, plain;
             the first call of each is held to the parity gate at that
             size too
  5. main    `python -m cutrace_tpu_torch scenes/bunny.json` (cli.main) at
             1920x1080 b5: three non-empty JPEGs, the kernel's launch
             count grew, and a library render of the same scene is finite
  6. result  a JSON line of per-kernel numbers, then the contract line
             {"ok": true, "device": {...}}

`max_abs_err` is the largest |kernel - plain| over color and normal off
the discontinuity mask, across the four parity scenes and bunny at
1920x1080. Nothing here imports jax.
"""

import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
from contextlib import redirect_stdout

import numpy as np
import torch

ATOL = 2e-4
EDGE_BUDGET = 0.05
PARITY = (
    ("triangle.json", 20, 20, 5),
    ("bunny.json", 480, 270, 5),
    ("mirror.json", 480, 270, 5),
    ("sphere_plane.json", 480, 270, 5),
)
MAIN_SCENE = "bunny.json"  # authored at 1920x1080; the CLI renders b5


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def discontinuity_mask(ref_img, thr=1e-3, dilate=1):
    """Pixels adjacent to a local jump in the reference image (the same
    mask as tests/test_device_renderer.py discontinuity_mask)."""
    v = ref_img if ref_img.ndim == 2 else np.linalg.norm(ref_img, axis=-1)
    v = np.nan_to_num(v, posinf=1e9, neginf=-1e9)
    g = np.zeros(v.shape, bool)
    dx = np.abs(np.diff(v, axis=1)) > thr
    dy = np.abs(np.diff(v, axis=0)) > thr
    g[:, 1:] |= dx
    g[:, :-1] |= dx
    g[1:, :] |= dy
    g[:-1, :] |= dy
    for _ in range(dilate):
        g2 = g.copy()
        g2[1:, :] |= g[:-1, :]
        g2[:-1, :] |= g[1:, :]
        g2[:, 1:] |= g[:, :-1]
        g2[:, :-1] |= g[:, 1:]
        g = g2
    return g


def gate(base, out):
    """Per-buffer (off-edge mismatches, edge mismatches, edge pixels,
    off-edge max |error|) under the _compare gate; `base` is the plain
    version's (color, depth, normal) images."""
    stats = {}
    for name, a, b in zip(("color", "depth", "normal"), base, out):
        ok = np.isclose(a, b, atol=ATOL) | (np.isinf(a) & np.isinf(b))
        bad = ~ok.reshape(a.shape[0], a.shape[1], -1).all(-1)
        edges = discontinuity_mask(a)
        off = ~edges
        both = np.isfinite(a) & np.isfinite(b)
        with np.errstate(invalid="ignore"):
            err = np.where(both, np.abs(a - b), 0.0)
        err = err.reshape(a.shape[0], a.shape[1], -1).max(-1)
        stats[name] = (int((bad & off).sum()), int((bad & edges).sum()),
                       int(edges.sum()), float(err[off].max(initial=0.0)))
    return stats


def check_parity(label, soa, inverse, kern, plain, to_image):
    """Hold the kernel's (color, depth, normal) rays against the plain
    version's under the gate; print one line and return the largest
    off-edge |error| over color and normal."""
    kern, plain = (
        [x.cpu().numpy() for x in to_image(soa, inverse, *r)]
        for r in (kern, plain))
    stats = gate(plain, kern)
    phase("parity", label + " " + " ".join(
        f"{k}: off-edge {s[0]} edge {s[1]}/{s[2]} maxerr {s[3]:.2e}"
        for k, s in stats.items()))
    for k, (off, on, n_edges, _) in stats.items():
        if off:
            raise AssertionError(f"{label} {k}: {off} mismatches off "
                                 f"discontinuities")
        if on > EDGE_BUDGET * max(n_edges, 1):
            raise AssertionError(f"{label} {k}: {on}/{n_edges} edge pixels "
                                 f"mismatch")
    return max(stats["color"][3], stats["normal"][3])


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 1
    root = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from cutrace_tpu_torch import cli, load_scene
    from cutrace_tpu_torch.ops import _build, fused
    from cutrace_tpu_torch.render.renderer import (to_image, block_rays,
                                                   prepare, render)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    scenes = root / "scenes"

    # 1. probe
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    phase("probe", f"python {sys.version.split()[0]} torch {torch.__version__}"
          f" cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" count {torch.cuda.device_count()}")
    phase("probe", "nvcc " + nvcc.stdout.strip().splitlines()[-1])
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.load_library()
    phase("build", f"{lib_path.relative_to(root)} built in "
          f"{time.perf_counter() - t0:.1f} s")

    # 3. parity: kernel vs plain version, same rays on the same card
    max_err = 0.0
    for name, w, h, bounces in PARITY:
        scene = load_scene(scenes / name)
        scene.camera.width, scene.camera.height = w, h
        prepared = prepare(scene, accel="fused", device=dev, bounces=bounces)
        soa, accel = prepared.soa, prepared.accel
        o, d, inverse = block_rays(soa)
        kern = fused.fused_render_rays(soa, accel, o, d, 1e-3, bounces,
                                       tables=prepared.tables)
        torch.cuda.synchronize()
        plain = fused.fused_render_rays_plain(soa, accel, o, d, 1e-3, bounces)
        max_err = max(max_err, check_parity(
            f"{name} {w}x{h} b{bounces} M={accel.order.shape[0]}", soa,
            inverse, kern, plain, to_image))

    # 4. timing at the main path's shapes; the first calls are also held
    # to the parity gate at that size
    scene = load_scene(scenes / MAIN_SCENE)
    prepared = prepare(scene, accel="fused", device=dev, bounces=5)
    soa, accel = prepared.soa, prepared.accel
    o, d, inverse = block_rays(soa)
    kernel_fn = lambda: fused.fused_render_rays(  # noqa: E731
        soa, accel, o, d, 1e-3, 5, tables=prepared.tables)
    plain_fn = lambda: fused.fused_render_rays_plain(soa, accel, o, d, 1e-3, 5)  # noqa: E731
    kern = kernel_fn()
    torch.cuda.synchronize()
    plain = plain_fn()
    max_err = max(max_err, check_parity(
        f"{MAIN_SCENE} {soa.width}x{soa.height} b5 M={accel.order.shape[0]}",
        soa, inverse, kern, plain, to_image))
    del kern, plain
    plain_ms = [cuda_ms(plain_fn, 1)]
    kernel_ms = cuda_ms(kernel_fn, 10)
    plain_ms.append(cuda_ms(plain_fn, 1))
    phase("timing", f"{MAIN_SCENE} {soa.width}x{soa.height} b5 M="
          f"{accel.order.shape[0]}: kernel {kernel_ms:.3f} ms, plain "
          f"{plain_ms[0]:.3f} / {plain_ms[1]:.3f} ms ({smi})")

    # 5. the main path through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        fused.LAUNCHES = 0
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = cli.main([str(scenes / MAIN_SCENE), "--out", tmp])
        launches = fused.LAUNCHES
        text = buf.getvalue()
        print(text, end="")
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        for jpg in ("frame.jpg", "depth_map.jpg", "normal_map.jpg"):
            size = os.path.getsize(os.path.join(tmp, jpg))
            if size == 0:
                raise AssertionError(f"{jpg} is empty")
    if launches < 1:
        raise AssertionError("the CLI run never launched the fused kernel")
    render_line = next(ln for ln in text.splitlines()
                       if ln.startswith("Render time was"))
    color, depth, normal = render(prepared, bounces=5)
    if tuple(color.shape) != (1080, 1920, 3) or not bool(
            torch.isfinite(color).all()):
        raise AssertionError("bunny 1080p color is not a finite (1080, "
                             "1920, 3) image")
    phase("main", f"cli bunny.json 1920x1080 b5: {render_line!r}; kernel "
          f"launches {launches}; hit pixels "
          f"{int(torch.isfinite(depth).sum())}")

    print(json.dumps({"kernels": [{
        "name": "fused_forward",
        "route": "cuda",
        "source": "cutrace_tpu_torch/ops/csrc/fused_forward.cu",
        "replaces": "cutrace_tpu/ops/fused.py:1734",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": min(plain_ms),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
