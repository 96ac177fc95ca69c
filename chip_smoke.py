"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--skip PHASE ...]

Run from the repository root on a machine with a CUDA card and nvcc. It
drives the port's main paths once and fails (non-zero exit, no result
line) if any phase fails:

  1. probe   torch / CUDA versions, the card's name and power limit, nvcc
  2. build   compile every kernel under cutrace_tpu_torch/ops/csrc/ for
             sm_90a, one nvcc per source, all started together
  3. parity  the forward kernel against its plain PyTorch version, same
             rays on the same card: triangle 20x20 b5, bunny / mirror /
             sphere_plane 480x270 b5. Gate (tests/test_fused.py
             _compare): np.isclose(atol=2e-4), no mismatch off the
             reference image's discontinuities, at most 5 % of edge pixels
  4. timing  bunny 1920x1080 b5 frame through the kernel and through the
             plain version, CUDA events, in turns plain, kernel, plain;
             the first call of each is held to the parity gate at that
             size too
  5. main    `python -m cutrace_tpu_torch scenes/bunny.json` (cli.main) at
             1920x1080 b5: three non-empty JPEGs, the forward kernel's
             launch count grew, and a library render is finite
  6. topo    the forward kernel with topology codes, on the parity scenes
             and bunny 1920x1080 b5: color, depth and normal bit-identical
             to the kernel without codes; the plain replay of the kernel's
             codes reproduces the kernel per ray (color and normal within
             1e-5, depth within 1e-4: tests/test_replay.py:51-54) off the
             edge mask below, at most 5 % of the edge pixels over; the
             kernel's codes equal the plain emitter's, no ray differing
             off the edge mask (the color image's discontinuities and the
             pixels next to a change of any code row), at most 5 % of the
             edge pixels
  7. vjp     the replay backward kernel against torch autograd of the plain
             replay (in ray chunks), on the same scenes, the kernel's
             codes and numpy-seeded cotangents (depth cotangents zero on
             misses): every non-camera parameter group, d_o and d_d under
             isclose(rtol=2e-3, atol=2e-3 * scale)
             (tests/test_replay_vjp.py:71-78)
  8. grad    one full gradient step, loss = mean((c - 0.9 c0)^2) over all
             19 parameter groups, on bunny 1920x1080 b5: finite gradients,
             both kernels launched; s/step by CUDA events (mean of 3 after
             a warm-up) and its parts; sphere_plane 1920x1080 b5 too
  9. train   fit on bunny 1920x1080 b5, mat_color perturbed by seeded
             noise, lr 5e-2, 5 steps: finite falling losses, a checkpoint
             saved, and a resumed fit continuing from it
 10. result  a JSON line of per-kernel numbers, then the contract line
             {"ok": true, "device": {...}}

Each main path (the CLI render, the gradient step, fit) runs with every
kernel's launch count set to 0 just before it and read just after; the
counts of the result line come from those runs. `--skip` leaves phases out
while developing; the result line is printed only when nothing was
skipped. Nothing here imports jax.
"""

import argparse
import dataclasses
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
REPLAY_TOL = {"color": 1e-5, "depth": 1e-4, "normal": 1e-5}
VJP_RTOL = 2e-3
PARITY = (
    ("triangle.json", 20, 20, 5),
    ("bunny.json", 480, 270, 5),
    ("mirror.json", 480, 270, 5),
    ("sphere_plane.json", 480, 270, 5),
)
MAIN_SCENE = "bunny.json"  # authored at 1920x1080; the CLI renders b5
PHASES = ("parity", "timing", "main", "topo", "vjp", "grad", "train")
PLAIN_CHUNK = 262144  # rays per plain-replay chunk on the card
# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM bytes/s,
# float32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# Float operations per unit of work, counted from the CUDA sources (a
# multiply and an add count two): the forward kernel's triangle slot test
# (tri_t), AABB slab test, plane and sphere tests, per-cast setup; the
# replay backward's per live hit node, per (node, light) and per counted
# march step, forward and reverse sweeps together.
OPS_TRI_SLOT, OPS_SLAB, OPS_PLANE, OPS_SPHERE, OPS_CAST = 38, 24, 12, 30, 20
OPS_VJP_NODE, OPS_VJP_LIGHT, OPS_VJP_STEP = 310, 180, 60


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


def code_edges(codes_img, dilate=1):
    """Pixels next to a change of any topology code row between
    neighbours, in an (H, W, K) code image: where a winner, an occlusion
    flag or a march occluder changes, float rounding may flip it."""
    g = np.zeros(codes_img.shape[:2], bool)
    dx = (np.diff(codes_img, axis=1) != 0).any(-1)
    dy = (np.diff(codes_img, axis=0) != 0).any(-1)
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


def reset_launches(fused, rv):
    fused.LAUNCHES = fused.TOPO_LAUNCHES = rv.LAUNCHES = 0


def read_launches(fused, rv):
    return {"fused_forward": fused.LAUNCHES,
            "fused_forward_topo": fused.TOPO_LAUNCHES,
            "replay_vjp": rv.LAUNCHES}


def forward_bound(soa, accel, tables, n_rays, tally, code_rows):
    """(bound ms, what bounds it) of one forward launch: the bytes it must
    move (rays, tables, outputs, codes) at the card's memory rate against
    the float operations of this run's casts and slab-admitted cluster
    visits (`tally`) at its float32 rate."""
    m, c = accel.order.shape
    table_bytes = sum(getattr(tables, f).numel() * 4 for f in (
        "tri", "aabb", "plane", "sphere", "mat", "lights", "ambient"))
    nbytes = n_rays * (8 + 7 + code_rows) * 4 + table_bytes
    casts, visits = (int(x) for x in tally.tolist())
    ops = (visits * c * OPS_TRI_SLOT
           + casts * (m * OPS_SLAB + soa.n_planes * OPS_PLANE
                      + soa.n_spheres * OPS_SPHERE + OPS_CAST))
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def vjp_bound(soa, codes, bounces):
    """(bound ms, what bounds it) of one replay-backward launch: rays,
    codes, cotangents, table and their cotangents at the memory rate,
    against the float operations of this run's live hit nodes, their
    lights and the counted march steps at the float32 rate."""
    from cutrace_tpu_torch.ops import replay as rp

    r, k = codes.shape
    _, nodes = rp.topo_layout(bounces, soa.any_reflective,
                              soa.any_transparent, soa.n_lights,
                              soa.shadow_steps)
    cast_rows = [cr for _, cr, _ in nodes]
    hit_nodes = int((codes[:, cast_rows] >= 0).sum())
    steps = 0
    if soa.any_transparent:
        march = torch.ones(k, dtype=torch.bool, device=codes.device)
        march[cast_rows] = False
        steps = int((codes[:, march] >= 0).sum())
    n_tab = (soa.tri_p1.shape[0] + soa.pl_point.shape[0]
             + soa.sp_center.shape[0])
    nbytes = r * (8 + k + 8 + 8) * 4 + 2 * n_tab * 17 * 4
    ops = (hit_nodes * (OPS_VJP_NODE + soa.n_lights * OPS_VJP_LIGHT)
           + steps * OPS_VJP_STEP)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def rays_to_pixels(soa, inverse, per_ray):
    """(R, ...) per-ray values in block order -> (H, W, ...) numpy."""
    n = soa.width * soa.height
    x = per_ray[inverse][:n].cpu().numpy()
    return x.reshape(soa.height, soa.width, *x.shape[1:])


def plain_replay(rp, soa, o, d, codes, bounces):
    with torch.no_grad():
        outs = [rp.replay_render_rays(soa, o[s:s + PLAIN_CHUNK],
                                      d[s:s + PLAIN_CHUNK],
                                      codes[s:s + PLAIN_CHUNK], 1e-3, bounces)
                for s in range(0, o.shape[0], PLAIN_CHUNK)]
    return tuple(torch.cat(x) for x in zip(*outs))


def chunked_plain_vjp(rv):
    """The plain table-level VJP in ray chunks: table, light and ambient
    cotangents summed over chunks, ray cotangents concatenated."""
    def vjp(soa, table, lights, ambient, o, d, codes, cot, fudge, bounces):
        parts = []
        for s in range(0, o.shape[0], PLAIN_CHUNK):
            sl = slice(s, s + PLAIN_CHUNK)
            parts.append(rv.replay_vjp_plain(
                soa, table, lights, ambient, o[sl], d[sl], codes[sl],
                tuple(c[sl] for c in cot), fudge, bounces))
        return (sum(p[0] for p in parts), sum(p[1] for p in parts),
                sum(p[2] for p in parts), torch.cat([p[3] for p in parts]),
                torch.cat([p[4] for p in parts]))
    return vjp


def run_topo(label, prepared, bounces, fused, rp, rec):
    """The topo phase on one scene: returns (codes, o, d, max replay
    error) and, at 1080p, records kernel and plain times in `rec`."""
    from cutrace_tpu_torch.render.renderer import block_rays

    soa, accel, tables = prepared.soa, prepared.accel, prepared.tables
    o, d, inverse = block_rays(soa)
    base = fused.fused_render_rays(soa, accel, o, d, 1e-3, bounces,
                                   tables=tables)
    *topo, codes = fused.fused_render_rays(soa, accel, o, d, 1e-3, bounces,
                                           emit_topo=True, tables=tables)
    torch.cuda.synchronize()
    for name, a, b in zip(("color", "depth", "normal"), base, topo):
        if not torch.equal(a, b):
            raise AssertionError(f"{label} {name}: emit_topo changed the "
                                 f"forward's bits")
    rep = plain_replay(rp, soa, o, d, codes, bounces)
    t0 = time.perf_counter()
    plain_codes = fused.emit_topo_plain(soa, accel, o, d, 1e-3, bounces)
    torch.cuda.synchronize()
    emit_s = time.perf_counter() - t0
    # knife edges: the plain color image's discontinuities, and the pixels
    # next to a change of any code row in the plain emitter's codes (a
    # deep node's flipped winner may move the color by less than the
    # color mask's threshold)
    edges = (discontinuity_mask(rays_to_pixels(soa, inverse, base[0]))
             | code_edges(rays_to_pixels(soa, inverse, plain_codes)))
    n_edges = int(edges.sum())
    errs, over = {}, np.zeros(edges.shape, bool)
    for name, a, b in zip(("color", "depth", "normal"), topo, rep):
        if not torch.equal(torch.isinf(a), torch.isinf(b)):
            raise AssertionError(f"{label} {name}: replay misses differ")
        both = torch.isfinite(a) & torch.isfinite(b)
        err = torch.where(both, (a - b).abs(), 0.0)
        err = rays_to_pixels(soa, inverse, err.reshape(err.shape[0], -1)
                             .max(1).values)
        errs[name] = (float(err[~edges].max(initial=0.0)),
                      float(err.max(initial=0.0)))
        over |= err > REPLAY_TOL[name]
    phase("topo", f"{label} rows {codes.shape[1]}: bits identical; replay "
          f"max err off-edge / all: " + " ".join(
              f"{k} {v[0]:.2e} / {v[1]:.2e}" for k, v in errs.items())
          + f"; rays over the tolerance: off-edge {int((over & ~edges).sum())}"
          f" edge {int((over & edges).sum())}/{n_edges}")
    # A knife-edge ray (a near-tangent sphere hit, a grazing reflection)
    # amplifies rounding by the inverse of its discriminant; such rays sit
    # on the edge mask, which gets the forward gate's 5 % edge budget.
    if (over & ~edges).any() or (over & edges).sum() > EDGE_BUDGET * max(
            n_edges, 1):
        raise AssertionError(f"{label}: the replay of the kernel's codes "
                             f"misses the kernel's values")
    differ = rays_to_pixels(soa, inverse, (plain_codes != codes).any(1))
    off, on = int((differ & ~edges).sum()), int((differ & edges).sum())
    phase("topo", f"{label}: codes vs plain emitter: off-edge {off} edge "
          f"{on}/{n_edges} rays differ (emitter {emit_s:.1f} s)")
    if off or on > EDGE_BUDGET * max(n_edges, 1):
        raise AssertionError(f"{label}: the kernel's codes differ from the "
                             f"plain emitter's")
    if rec is not None:
        topo_fn = lambda: fused.fused_render_rays(  # noqa: E731
            soa, accel, o, d, 1e-3, bounces, emit_topo=True, tables=tables)
        rec["topo_ms"] = cuda_ms(topo_fn, 10)
        rec["notopo_ms"] = cuda_ms(lambda: fused.fused_render_rays(
            soa, accel, o, d, 1e-3, bounces, tables=tables), 10)
        # the plain version: the plain forward (timed in phase timing, else
        # here) and the plain emitter (timed above)
        if "plain_ms" not in rec:
            rec["plain_ms"] = cuda_ms(lambda: fused.fused_render_rays_plain(
                soa, accel, o, d, 1e-3, bounces), 1)
        rec["topo_plain_ms"] = rec["plain_ms"] + emit_s * 1e3
        tally = torch.zeros(2, dtype=torch.int64, device=o.device)
        fused._fused_forward_cuda(soa, tables, o, d, 1e-3, bounces,
                                  emit_topo=True, tally=tally)
        rec["topo_bound"] = forward_bound(soa, accel, tables, o.shape[0],
                                          tally, codes.shape[1])
        phase("topo", f"{label}: kernel with codes {rec['topo_ms']:.3f} ms, "
              f"without {rec['notopo_ms']:.3f} ms, plain forward + emitter "
              f"{rec['topo_plain_ms']:.0f} ms; casts {int(tally[0])} "
              f"cluster visits {int(tally[1])}; bound "
              f"{rec['topo_bound'][0]:.3f} ms ({rec['topo_bound'][1]})")
    return codes, o, d, max(errs["color"][0], errs["normal"][0])


def run_vjp(label, soa, o, d, codes, bounces, rp, rv, seed, rec):
    """The vjp phase on one scene: the kernel against the chunked plain
    version at the scene leaves. Returns the largest relative error."""
    r = o.shape[0]
    rng = np.random.default_rng(seed)
    cot = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(o.device)
           for s in ((r, 3), (r,), (r, 3))]
    plain = chunked_plain_vjp(rv)
    _, dep, _ = plain_replay(rp, soa, o, d, codes, bounces)
    cot[1] = torch.where(torch.isfinite(dep), cot[1], 0.0)
    cot = tuple(cot)
    got = rv.replay_vjp(soa, o, d, codes, cot, 1e-3, bounces)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = rv.replay_vjp(soa, o, d, codes, cot, 1e-3, bounces,
                         tables_vjp=plain)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    worst = 0.0
    pairs = [(f, got[0][f], want[0][f]) for f in rv.TABLE_FIELDS]
    pairs += [("o", got[1], want[1]), ("d", got[2], want[2])]
    for name, a, b in pairs:
        a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            raise AssertionError(f"{label} {name}: not finite")
        scale = max(np.abs(a).max(), np.abs(b).max(), 1e-12)
        ok = np.isclose(a, b, rtol=VJP_RTOL, atol=VJP_RTOL * scale)
        if not ok.all():
            raise AssertionError(
                f"{label} {name}: {(~ok).sum()}/{a.size} mismatch, max "
                f"|diff| {np.abs(a - b).max():.3e} at scale {scale:.3e}")
        worst = max(worst, float(np.abs(a - b).max() / scale))
    phase("vjp", f"{label}: 15 groups + d_o, d_d within the gate; max "
          f"relative error {worst:.2e}")
    if rec is not None:
        tables = rv.backward_tables(soa)
        kern = lambda: rv.vjp_tables(soa, *tables, o, d, codes, cot,  # noqa: E731
                                     1e-3, bounces)
        kern()
        rec["vjp_ms"] = cuda_ms(kern, 10)
        rec["vjp_plain_ms"] = plain_ms
        rec["vjp_bound"] = vjp_bound(soa, codes, bounces)
        phase("vjp", f"{label}: kernel {rec['vjp_ms']:.3f} ms, plain "
              f"{plain_ms:.0f} ms; bound {rec['vjp_bound'][0]:.3f} ms "
              f"({rec['vjp_bound'][1]})")
    return worst


def grad_step_fn(prepared, bounces, tgrad):
    """A full gradient step over all 19 groups on the prepared scene:
    returns (step, params); step() returns the loss."""
    soa, accel = prepared.soa, prepared.accel
    with torch.no_grad():
        c0, _, _ = tgrad.render_image_flat(soa, bounces, 1e-3, accel)
    target = 0.9 * c0
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tgrad.extract_params(soa).items()}

    def step():
        for p in params.values():
            p.grad = None
        loss = tgrad.render_loss(params, soa, target, bounces, 1e-3, accel)
        loss.backward()
        return loss

    return step, params


def grad_parts(prepared, bounces, fused, rv, tgrad):
    """CUDA-event milliseconds of a gradient step's parts, run one after
    another as the step runs them: camera rays, the kernels' tables, the
    forward with codes, the replay backward, and routing the cotangents to
    the leaves (tables and camera)."""
    from cutrace_tpu_torch.render.renderer import camera_rays

    soa, accel = prepared.soa, prepared.accel
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tgrad.extract_params(soa).items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    s = tgrad.with_params(soa, params)
    n = s.width * s.height
    idx = torch.arange(n, device=s.device)
    o, d = camera_rays(s, idx % s.width, idx // s.width)
    ev[1].record()
    kt = fused.kernel_tables(s, accel)
    ins = rv.backward_tables(s)
    ev[2].record()
    c, dep, nrm, codes = fused._fused_forward_cuda(
        s, kt, o.detach(), d.detach(), 1e-3, bounces, emit_topo=True)
    ev[3].record()
    g_c = torch.randn_like(c)
    grads = rv.vjp_tables(s, *(x.detach() for x in ins), o.detach(),
                          d.detach(), codes, (g_c, None, None), 1e-3,
                          bounces)
    ev[4].record()
    torch.autograd.grad((*ins, o, d), list(params.values()), grads,
                        allow_unused=True)
    ev[5].record()
    ev[5].synchronize()
    names = ("camera", "tables", "forward_topo", "replay_vjp", "routing")
    return {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(names)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--skip", nargs="*", default=[], choices=PHASES)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 1
    root = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from cutrace_tpu_torch import cli, load_scene
    from cutrace_tpu_torch.diff import checkpoint as ckpt
    from cutrace_tpu_torch.diff import grad as tgrad
    from cutrace_tpu_torch.ops import _build, fused
    from cutrace_tpu_torch.ops import replay as rp
    from cutrace_tpu_torch.ops import replay_vjp as rv
    from cutrace_tpu_torch.parallel.train import fit
    from cutrace_tpu_torch.render.renderer import (to_image, block_rays,
                                                   prepare, render)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    scenes = root / "scenes"
    skip = set(args.skip)
    rec = {}

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

    # 2. build: every kernel, one nvcc each, started together
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    for name in libs:
        _build.load_library(name)
    phase("build", " ".join(str(p.relative_to(root)) for p in libs.values())
          + f" built in {time.perf_counter() - t0:.1f} s")

    # 3. parity: kernel vs plain version, same rays on the same card
    max_err = 0.0
    prepared_small = {}
    for name, w, h, bounces in PARITY:
        scene = load_scene(scenes / name)
        scene.camera.width, scene.camera.height = w, h
        prepared = prepare(scene, accel="fused", device=dev, bounces=bounces)
        prepared_small[name] = (prepared, bounces)
        if "parity" in skip:
            continue
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
    main_prepared = prepare(scene, accel="fused", device=dev, bounces=5)
    soa, accel = main_prepared.soa, main_prepared.accel
    o, d, inverse = block_rays(soa)
    if "timing" not in skip:
        kernel_fn = lambda: fused.fused_render_rays(  # noqa: E731
            soa, accel, o, d, 1e-3, 5, tables=main_prepared.tables)
        plain_fn = lambda: fused.fused_render_rays_plain(  # noqa: E731
            soa, accel, o, d, 1e-3, 5)
        kern = kernel_fn()
        torch.cuda.synchronize()
        plain = plain_fn()
        max_err = max(max_err, check_parity(
            f"{MAIN_SCENE} {soa.width}x{soa.height} b5 "
            f"M={accel.order.shape[0]}", soa, inverse, kern, plain, to_image))
        del kern, plain
        plain_ms = [cuda_ms(plain_fn, 1)]
        rec["kernel_ms"] = cuda_ms(kernel_fn, 10)
        plain_ms.append(cuda_ms(plain_fn, 1))
        rec["plain_ms"] = min(plain_ms)
        tally = torch.zeros(2, dtype=torch.int64, device=dev)
        fused._fused_forward_cuda(soa, main_prepared.tables, o, d, 1e-3, 5,
                                  tally=tally)
        rec["bound"] = forward_bound(soa, accel, main_prepared.tables,
                                     o.shape[0], tally, 0)
        phase("timing", f"{MAIN_SCENE} {soa.width}x{soa.height} b5 M="
              f"{accel.order.shape[0]}: kernel {rec['kernel_ms']:.3f} ms, "
              f"plain {plain_ms[0]:.3f} / {plain_ms[1]:.3f} ms; casts "
              f"{int(tally[0])} cluster visits {int(tally[1])}; bound "
              f"{rec['bound'][0]:.3f} ms ({rec['bound'][1]}) ({smi})")

    # 5. the main path through the CLI
    launches = {}
    if "main" not in skip:
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches(fused, rv)
            buf = io.StringIO()
            with redirect_stdout(buf):
                rc = cli.main([str(scenes / MAIN_SCENE), "--out", tmp])
            launches["cli"] = read_launches(fused, rv)
            text = buf.getvalue()
            print(text, end="")
            if rc != 0:
                raise AssertionError(f"cli.main returned {rc}")
            for jpg in ("frame.jpg", "depth_map.jpg", "normal_map.jpg"):
                size = os.path.getsize(os.path.join(tmp, jpg))
                if size == 0:
                    raise AssertionError(f"{jpg} is empty")
        if launches["cli"]["fused_forward"] < 1:
            raise AssertionError("the CLI run never launched the fused "
                                 "kernel")
        render_line = next(ln for ln in text.splitlines()
                           if ln.startswith("Render time was"))
        color, depth, normal = render(main_prepared, bounces=5)
        if tuple(color.shape) != (1080, 1920, 3) or not bool(
                torch.isfinite(color).all()):
            raise AssertionError("bunny 1080p color is not a finite (1080, "
                                 "1920, 3) image")
        phase("main", f"cli bunny.json 1920x1080 b5: {render_line!r}; "
              f"launches {launches['cli']}; hit pixels "
              f"{int(torch.isfinite(depth).sum())}")

    # 6. topo and 7. vjp: the parity scenes, then bunny at 1080p
    topo_err = vjp_err = 0.0
    cases = [(f"{n} {p.soa.width}x{p.soa.height} b{b}", p, b, None)
             for n, (p, b) in prepared_small.items()]
    cases.append((f"{MAIN_SCENE} 1920x1080 b5", main_prepared, 5, rec))
    for seed, (label, prepared, bounces, r) in enumerate(cases):
        if "topo" in skip and "vjp" in skip:
            break
        codes, o_, d_, err = run_topo(label, prepared, bounces, fused, rp, r)
        topo_err = max(topo_err, err)
        if "vjp" not in skip:
            vjp_err = max(vjp_err, run_vjp(label, prepared.soa, o_, d_, codes,
                                           bounces, rp, rv, seed, r))
        del codes, o_, d_

    # 8. grad: the gradient step over all 19 groups at 1080p
    if "grad" not in skip:
        step, params = grad_step_fn(main_prepared, 5, tgrad)
        reset_launches(fused, rv)
        loss = step().detach()
        torch.cuda.synchronize()
        launches["grad"] = read_launches(fused, rv)
        if len(params) != 19:
            raise AssertionError(f"{len(params)} parameter groups, not 19")
        for k, p in params.items():
            if p.grad is None or not bool(torch.isfinite(p.grad).all()):
                raise AssertionError(f"grad[{k}] missing or not finite")
        if (launches["grad"]["fused_forward_topo"] < 1
                or launches["grad"]["replay_vjp"] < 1):
            raise AssertionError(f"the gradient step missed a kernel: "
                                 f"{launches['grad']}")
        rec["step_ms"] = cuda_ms(step, 3)
        parts = grad_parts(main_prepared, 5, fused, rv, tgrad)
        rec["parts"] = parts
        phase("grad", f"{MAIN_SCENE} 1920x1080 b5: loss {loss.item():.6f}, "
              f"19 groups finite, launches {launches['grad']}; "
              f"{rec['step_ms'] / 1e3:.4f} s/step (mean of 3 after a "
              f"warm-up); parts ms " + json.dumps(
                  {k: round(v, 3) for k, v in parts.items()}) + f" ({smi})")
        del step, params
        sp = load_scene(scenes / "sphere_plane.json")
        sp_prepared = prepare(sp, accel="fused", device=dev, bounces=5)
        sp_step, sp_params = grad_step_fn(sp_prepared, 5, tgrad)
        sp_step()
        torch.cuda.synchronize()
        for k, p in sp_params.items():
            if p.grad is None or not bool(torch.isfinite(p.grad).all()):
                raise AssertionError(f"sphere_plane grad[{k}] not finite")
        rec["sp_step_ms"] = cuda_ms(sp_step, 3)
        rec["sp_parts"] = grad_parts(sp_prepared, 5, fused, rv, tgrad)
        phase("grad", f"sphere_plane.json 1920x1080 b5 (63 nodes, "
              f"{rp.replay_rows(sp_prepared.soa, 5)} topo rows): "
              f"{rec['sp_step_ms'] / 1e3:.4f} s/step (mean of 3 after a "
              f"warm-up); parts ms " + json.dumps(
                  {k: round(v, 3) for k, v in rec["sp_parts"].items()})
              + f" ({smi})")
        del sp_step, sp_params, sp_prepared

    # 9. train: fit from a perturbed mat_color, then resume
    if "train" not in skip:
        with torch.no_grad():
            target, _, _ = tgrad.render_image_flat(soa, 5, 1e-3, accel)
        rng = np.random.default_rng(7)
        color = soa.mat_color.cpu().numpy()
        start = np.clip(color + rng.normal(0.0, 0.15, color.shape), 0.0,
                        1.0).astype(np.float32)
        start_soa = dataclasses.replace(
            soa, mat_color=torch.from_numpy(start).to(dev))
        kw = dict(lr=5e-2, bounces=5, param_filter=("mat_color",),
                  checkpoint_every=2, accel=accel, device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches(fused, rv)
            t0 = time.perf_counter()
            params, losses = fit(start_soa, target, steps=5,
                                 checkpoint_dir=tmp, **kw)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches["train"] = read_launches(fused, rv)
            if len(losses) != 5 or not np.isfinite(losses).all():
                raise AssertionError(f"fit losses {losses}")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"fit loss did not fall: {losses}")
            if ckpt.latest_step(tmp) != 4:
                raise AssertionError("fit saved no checkpoint at step 4")
            _, more = fit(start_soa, target, steps=7, checkpoint_dir=tmp,
                          **kw)
            if len(more) != 2 or not np.isfinite(more).all():
                raise AssertionError(f"resumed fit losses {more}")
            if not more[0] < losses[0]:
                raise AssertionError(f"resumed fit did not continue: {more}")
            if ckpt.latest_step(tmp) != 6:
                raise AssertionError("resumed fit saved no step 6")
        if (launches["train"]["fused_forward_topo"] < 5
                or launches["train"]["replay_vjp"] < 5):
            raise AssertionError(f"fit missed a kernel: {launches['train']}")
        phase("train", f"{MAIN_SCENE} 1920x1080 b5 fit mat_color 5 steps in "
              f"{fit_s:.2f} s: losses " + " ".join(f"{x:.6f}" for x in losses)
              + f"; resumed at step 5: " + " ".join(f"{x:.6f}" for x in more)
              + f"; launches {launches['train']}")

    if skip:
        phase("result", f"phases skipped ({' '.join(sorted(skip))}): no "
              f"result line")
        return 0
    common = {"route": "cuda", "library_ms": None}
    kernels = [
        {"name": "fused_forward",
         "source": "cutrace_tpu_torch/ops/csrc/fused_forward.cu",
         "replaces": "cutrace_tpu/ops/fused.py:1734",
         "launches": launches["cli"]["fused_forward"],
         "max_abs_err": max_err, "ms": rec["kernel_ms"],
         "plain_ms": rec["plain_ms"], "bound_ms": rec["bound"][0],
         "bound_by": rec["bound"][1], **common},
        {"name": "fused_forward_topo",
         "source": "cutrace_tpu_torch/ops/csrc/fused_forward.cu",
         "replaces": "cutrace_tpu/ops/fused.py:1734",
         "launches": launches["train"]["fused_forward_topo"],
         "max_abs_err": topo_err, "ms": rec["topo_ms"],
         "plain_ms": rec["topo_plain_ms"], "bound_ms": rec["topo_bound"][0],
         "bound_by": rec["topo_bound"][1], **common},
        {"name": "replay_vjp",
         "source": "cutrace_tpu_torch/ops/csrc/replay_vjp.cu",
         "replaces": "cutrace_tpu/ops/replay_vjp.py:204",
         "launches": launches["train"]["replay_vjp"],
         "max_abs_err": vjp_err, "ms": rec["vjp_ms"],
         "plain_ms": rec["vjp_plain_ms"], "bound_ms": rec["vjp_bound"][0],
         "bound_by": rec["vjp_bound"][1], **common},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels, "grad_step_s": rec["step_ms"] / 1e3,
                      "grad_step_parts_ms": rec["parts"],
                      "sphere_plane_grad_step_s": rec["sp_step_ms"] / 1e3,
                      "sphere_plane_grad_step_parts_ms": rec["sp_parts"]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
