"""The port's benchmark: frames, big scenes, training steps, the
inverse-rendering example and the kernels on one CUDA card (counterpart
of bench.py and benchmarks/frames.py).

    python -m cutrace_tpu_torch.bench [--reps 50] [--size WxH]
        [--bounces 5] [--levels 5] [--only GROUP ...] [--device cuda]

Run from anywhere; the scenes are the repository's. It prints one JSON
object a line, each as soon as it is measured, in this order (groups for
--only in brackets):

  probe        [probe]     torch and CUDA versions, the kernels' build
                           seconds (ops._build.build_all)
  frame/mirror_1080p_b5, frame/sphere_plane_1080p_b5       [frames]
               the frame program (`render`) at 1920x1080 b5: frame ms,
               first_call_s (warm-up, capture and the first replay),
               mcasts_per_s, peak_mb
  frame/bunny_1080p_b5_pallas  [pallas]  the same through the culling
               cast (accel="pallas", K4), at most 20 samples
  bigscene/<n>k_960x540_b5     [bigscene]  the subdivided bunny at 16k,
               64k, 256k and 1M triangles (--levels 2 to 5): prepare_s,
               first_call_s, frame ms (at most 10 samples), mcasts_per_s
  bunny_1080p_grad_step, sphere_plane_1080p_grad_step,
  step/bunny_256k_960x540_b5   [steps]  one training step over all 19
               parameter groups as a step program (perf_probe.grad_step:
               capturable Adam at lr 0, loss mean((c - 0.9 c0)^2), as
               bench.py's): s/step, the backward route that ran ("k2":
               the replay backward; "composable": autograd of the
               composable pipeline), first_calls_ms (eager; capture and
               replay; replay), peak_mb
  fit/inverse_rendering_example  [fit]  wall seconds of
               inverse_rendering.run() at the example's settings (5
               samples), each fit's first and last loss, the eye's error
  kernel/K1, kernel/K1_topo, kernel/K2, kernel/K3, kernel/K4  [kernels]
               ms a launch: K1 (bunny 1080p b5, without and with codes)
               and K3 (256k 960x540 b5) by CUDA events, one pair a launch,
               10 launches; K2 (bunny 1080p b5) by the device time of its
               two kernels in a CUDA-only trace of each of 10 calls; K4 as
               the mean of its records in a trace of one replayed pallas
               frame. bound_ms and bound_by (utils.roofline, from this
               run's inputs: the work these rays need) and share =
               bound_ms / ms
  bunny_1080p_ray_casts  [headline]  the bunny 1080p b5 frame program
               (K1's shared-memory instance) in Mcasts/s, last

Every line holds `metric`, `value`, `unit`, the samples' `median`, the
highest percentile with at least ten samples beyond it (`percentile`
names it, e.g. "p80" of 50 samples; None for ten or fewer) and its
value, `n`, `sample_unit`, `correct`, `backend` ("cuda" or "cpu"),
`card` (nvidia-smi's "name, power.limit"; None on the CPU) and `seconds`
(the line's own phase). Timed calls are warm and run with tracing off;
each frame and step line then traces one more call
(perf_probe.trace_summary) for `device_busy_ms` and `idle_share`.
Mcasts/s is width * height * casts_per_pixel / the median frame, and
casts_per_pixel counts the march's capacity (every shadow step of every
node), not the casts a run takes.

`correct`: a frame equals render_eager's (the same frame op by op) bit
for bit and its color is finite; bunny, mirror and sphere_plane at
480x270 b5 pass the forward gate (utils.gates) against the plain
version; a step's gradients equal an op-by-op step's from the same
state bit for bit and are finite, and the route's kernels launched; both
fits' losses fall; the K1 and K3 outputs equal their frames', K1 with
codes equals K1 without, K2 launched once a call, K4 launched as often
as the pallas frame counts. The run exits 1 after printing a line whose
check failed; a failure of a phase raises.

The card by default: without one it stops. `--device cpu` runs the
plain versions on the CPU (keep it tiny: --size 16x9 --bounces 1
--levels 1 --reps 2); every kernel time is then "not measured".
`--size` and `--bounces` set every line's image size and depth but the
example's fit; the names stay those of the full settings, and each line
holds its `size` and `bounces`.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

SCENES = pathlib.Path(__file__).resolve().parents[1] / "scenes"
GROUPS = ("probe", "frames", "pallas", "bigscene", "steps", "fit",
          "kernels", "headline")
FRAME_SIZE = (1920, 1080)
BIG_SIZE = (960, 540)
GATE_SIZE = (480, 270)  # the forward gate's frames
PALLAS_REPS, BIG_REPS, FIT_REPS, KERNEL_REPS = 20, 10, 5, 10
STEP_LEVELS = 4  # the 256k bunny's step and K3's line
NOT_MEASURED = "not measured"


def _size(text):
    w, h = text.lower().split("x")
    return int(w), int(h)


def _bits_equal(a, b) -> bool:
    """Same shape and the same bits (NaNs included)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _frames_equal(a, b) -> bool:
    return all(_bits_equal(x, y) for x, y in zip(a, b))


def _finite_frame(frame) -> bool:
    color, depth, normal = frame
    return bool(torch.isfinite(color).all() and not depth.isnan().any()
                and not normal.isnan().any())


def _triangles(n: int) -> str:
    return f"{n // 1000}k" if n < 10**6 else f"{n // 10**6}M"


class Bench:
    """The run's settings and its output: `line` prints one line."""

    def __init__(self, args, fit_steps):
        from cutrace_tpu_torch.scene.soa import resolve_device

        self.dev = resolve_device(args.device)
        self.cuda = self.dev.type == "cuda"
        self.reps, self.bounces = args.reps, args.bounces
        self.size = args.size
        self.levels = args.levels
        self.fit_steps = fit_steps
        self.failed = []
        self.card = None
        if self.cuda:
            from cutrace_tpu_torch.bigscene import card_name

            self.card = card_name()

    def frame_size(self, default=FRAME_SIZE):
        return self.size or default

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def line(self, metric, value, unit, correct, t0, samples=None,
             sample_unit="ms", **extra):
        """Print one line; `samples` (None: not measured) give median,
        percentile and n."""
        from cutrace_tpu_torch.utils.profiling import spread

        if samples is None:
            stats = {"median": NOT_MEASURED, "percentile": None, "n": 0}
        else:
            stats = spread(samples)
        row = {"metric": metric, "value": value, "unit": unit, **stats,
               "sample_unit": sample_unit, "correct": bool(correct),
               "backend": self.dev.type, "card": self.card, **extra,
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        if not correct:
            self.failed.append(metric)

    def peak_start(self):
        """Start a peak-memory window: the memory allocated now."""
        if not self.cuda:
            return None
        self.sync()
        torch.cuda.reset_peak_memory_stats(self.dev)
        return torch.cuda.memory_allocated(self.dev)

    def peak_mb(self, base):
        if base is None:
            return NOT_MEASURED
        return (torch.cuda.max_memory_allocated(self.dev) - base) / 2**20

    def trace(self, fn) -> dict:
        """device_busy_ms and idle_share of one traced call of fn() (host
        and device, torch.profiler)."""
        if not self.cuda:
            return {"device_busy_ms": NOT_MEASURED,
                    "idle_share": NOT_MEASURED}
        from cutrace_tpu_torch.perf_probe import traced

        s = traced(fn)
        return {"device_busy_ms": s["device_busy_ms"],
                "idle_share": s["device_idle_share"],
                "traced_wall_ms": s["wall_ms"]}


def load(name, size, device, accel="fused", bounces=5):
    """scenes/<name>.json at `size`, prepared on `device`."""
    from cutrace_tpu_torch import load_scene
    from cutrace_tpu_torch.render.renderer import prepare

    sc = load_scene(str(SCENES / f"{name}.json"))
    sc.camera.width, sc.camera.height = size
    return prepare(sc, accel=accel, device=device, bounces=bounces)


def gate_frame(b, name) -> dict:
    """The frame program of scenes/<name>.json at 480x270 (or --size),
    --bounces, against the plain version's images under the forward
    gate."""
    from cutrace_tpu_torch.ops import fused
    from cutrace_tpu_torch.render.renderer import block_rays, render, to_image
    from cutrace_tpu_torch.utils import gates

    p = load(name, b.frame_size(GATE_SIZE), b.dev, bounces=b.bounces)
    frame = render(p, bounces=b.bounces)
    o, d, inverse = block_rays(p.soa)
    plain = fused.fused_render_rays_plain(p.soa, p.accel, o, d, 1e-3,
                                          b.bounces)
    stats = gates.gate([x.cpu().numpy()
                        for x in to_image(p.soa, inverse, *plain)],
                       [x.cpu().numpy() for x in frame])
    return {"passes": gates.passes(stats),
            "size": "x".join(map(str, b.frame_size(GATE_SIZE))),
            **{k: {"off_edge": v[0], "edge": v[1], "edge_pixels": v[2]}
               for k, v in stats.items()}}


def frame_run(b, prepared, reps):
    """Time a frame program: (fields of its line, its correctness)."""
    from cutrace_tpu_torch.render.renderer import render, render_eager
    from cutrace_tpu_torch.utils.profiling import casts_per_pixel, sample_ms

    def frame():
        return render(prepared, bounces=b.bounces)

    base = b.peak_start()
    t0 = time.perf_counter()
    out = frame()
    b.sync()
    first_s = time.perf_counter() - t0
    samples = sample_ms(frame, reps, b.dev)
    peak = b.peak_mb(base)
    out = frame()
    eager = render_eager(prepared, bounces=b.bounces)
    same = _frames_equal(out, eager)
    finite = _finite_frame(out)
    soa = prepared.soa
    cpp = casts_per_pixel(soa, b.bounces)
    median = float(np.median(samples))
    fields = {"size": f"{soa.width}x{soa.height}", "bounces": b.bounces,
              "frame_ms": median, "first_call_s": first_s,
              "casts_per_pixel": cpp,
              "mcasts_per_s": soa.width * soa.height * cpp / median / 1e3,
              "peak_mb": peak, "equals_render_eager": same,
              "finite": finite, **b.trace(frame)}
    return samples, fields, same and finite


def frames(b):
    """b. the mirror and sphere_plane frames."""
    for name in ("mirror", "sphere_plane"):
        t0 = time.perf_counter()
        p = load(name, b.frame_size(), b.dev, bounces=b.bounces)
        samples, fields, ok = frame_run(b, p, b.reps)
        gate = gate_frame(b, name)
        b.line(f"frame/{name}_1080p_b5", fields["frame_ms"], "ms",
               ok and gate["passes"], t0, samples, gate=gate, **fields)
        del p
        _free(b)


def pallas(b):
    """c. the bunny frame through the culling cast."""
    from cutrace_tpu_torch.ops import pallas_cast as pc
    from cutrace_tpu_torch.render.renderer import render

    t0 = time.perf_counter()
    p = load("bunny", b.frame_size(), b.dev, accel="pallas",
             bounces=b.bounces)
    samples, fields, ok = frame_run(b, p, min(b.reps, PALLAS_REPS))
    before = pc.LAUNCHES
    render(p, bounces=b.bounces)
    b.sync()
    b.line("frame/bunny_1080p_b5_pallas", fields["frame_ms"], "ms", ok, t0,
           samples, k4_launches=pc.LAUNCHES - before, **fields)
    del p
    _free(b)


def big_levels(b):
    return list(range(2, b.levels + 1)) if b.levels >= 2 else [b.levels]


def bigscene(b):
    """d. the subdivided bunny, one line a level."""
    from cutrace_tpu_torch.bigscene import subdivided_bunny
    from cutrace_tpu_torch.render.renderer import prepare

    for level in big_levels(b):
        t0 = time.perf_counter()
        sc, n_tris = subdivided_bunny(level, *b.frame_size(BIG_SIZE))
        t1 = time.perf_counter()
        p = prepare(sc, accel="auto", device=b.dev, bounces=b.bounces)
        b.sync()
        prepare_s = time.perf_counter() - t1
        samples, fields, ok = frame_run(b, p, min(b.reps, BIG_REPS))
        m, c = p.accel.order.shape if p.accel is not None else (None, None)
        b.line(f"bigscene/{_triangles(n_tris)}_960x540_b5",
               fields["frame_ms"], "ms", ok, t0, samples, triangles=n_tris,
               clusters=m, cluster_size=c, prepare_s=prepare_s, **fields)
        del p
        _free(b)


def _counts():
    from cutrace_tpu_torch.render.renderer import _launch_counters

    return {f"{m.__name__.rsplit('.', 1)[1]}.{n}": getattr(m, n)
            for m, n in _launch_counters()}


def _grown(before, after):
    return {k: after[k] - v for k, v in before.items() if after[k] != v}


def step_line(b, metric, prepared, t0):
    """One 19-group step program on `prepared` against the op-by-op step."""
    from cutrace_tpu_torch import perf_probe
    from cutrace_tpu_torch.ops import fused
    from cutrace_tpu_torch.ops import replay_vjp as rv
    from cutrace_tpu_torch.utils.profiling import casts_per_pixel, sample_ms

    soa, accel = prepared.soa, prepared.accel
    n = soa.width * soa.height
    route = ("k2" if fused.replay_supported(soa, accel, b.bounces, n_rays=n)
             and rv.replay_vjp_supported(soa, b.bounces) else "composable")
    prog, prog_params = perf_probe.grad_step(prepared, b.bounces,
                                             program=True)
    eager, eager_params = perf_probe.grad_step(prepared, b.bounces,
                                               program=False)
    base = b.peak_start()
    first = []
    for _ in range(3):  # eager; capture and replay; replay
        t1 = time.perf_counter()
        prog()
        b.sync()
        first.append((time.perf_counter() - t1) * 1e3)
    samples = [x / 1e3 for x in sample_ms(prog, b.reps, b.dev)]
    peak = b.peak_mb(base)
    before = _counts()
    prog()
    b.sync()
    launches = _grown(before, _counts())
    eager()
    b.sync()
    grads = {k: (p.grad, eager_params[k].grad)
             for k, p in prog_params.items()}
    equal = all((g is None) == (e is None) and (g is None
                                                or _bits_equal(g, e))
                for g, e in grads.values())
    finite = all(g is None or bool(torch.isfinite(g).all())
                 for g, _ in grads.values())
    forward = ("fused.TOPO_LAUNCHES", "fused.BIG_TOPO_LAUNCHES",
               "fused.GLOBAL_TOPO_LAUNCHES")
    if b.cuda and route == "k2":
        ran = (launches.get("replay_vjp.LAUNCHES", 0) >= 1
               and any(launches.get(k, 0) >= 1 for k in forward))
    elif b.cuda:
        ran = launches.get("replay_vjp.LAUNCHES", 0) == 0 and bool(launches)
    else:
        ran = True  # the plain versions: no kernel to count
    median = float(np.median(samples))
    cpp = casts_per_pixel(soa, b.bounces)
    b.line(metric, median, "s/step", equal and finite and ran, t0, samples,
           "s", size=f"{soa.width}x{soa.height}", bounces=b.bounces,
           backward=route, groups=len(prog_params),
           mcasts_per_s=n * cpp / median / 1e6, first_calls_ms=first,
           peak_mb=peak, launches=launches, grads_bit_equal=equal,
           finite=finite, **b.trace(prog))


def steps(b):
    """e. the step programs."""
    from cutrace_tpu_torch.bigscene import subdivided_bunny
    from cutrace_tpu_torch.render.renderer import prepare

    for name in ("bunny", "sphere_plane"):
        t0 = time.perf_counter()
        p = load(name, b.frame_size(), b.dev, bounces=b.bounces)
        step_line(b, f"{name}_1080p_grad_step", p, t0)
        del p
        _free(b)
    t0 = time.perf_counter()
    sc, _ = subdivided_bunny(min(STEP_LEVELS, b.levels),
                             *b.frame_size(BIG_SIZE))
    p = prepare(sc, accel="fused", device=b.dev, bounces=b.bounces)
    step_line(b, "step/bunny_256k_960x540_b5", p, t0)
    del p
    _free(b)


def fit(b):
    """f. the inverse-rendering example, run() at its own settings."""
    from cutrace_tpu_torch import inverse_rendering as ir

    t0 = time.perf_counter()
    w, h = b.size or (64, 36)
    colors, camera = b.fit_steps
    samples, out = [], None
    for _ in range(min(b.reps, FIT_REPS)):
        t1 = time.perf_counter()
        out = ir.run(steps=colors, width=w, height=h, device=b.dev,
                     camera_steps=camera)
        samples.append(time.perf_counter() - t1)
    losses, cam = out["losses"], out["camera_losses"]
    falls = losses[-1] < losses[0] and cam[-1] < cam[0]
    b.line("fit/inverse_rendering_example", float(np.median(samples)), "s",
           falls, t0, samples, "s", size=f"{w}x{h}", steps=[colors, camera],
           color_loss=[losses[0], losses[-1]],
           camera_loss=[cam[0], cam[-1]],
           eye_error=out["eye_error"].tolist())
    _free(b)


def _kernel_line(b, name, t0, samples, bound, correct, value=None,
                 **extra):
    """One kernel line: ms a launch (the median of `samples`, or `value`)
    beside its bound; every time "not measured" on the CPU."""
    if not b.cuda:
        b.line(f"kernel/{name}", NOT_MEASURED, "ms", correct, t0,
               bound_ms=bound[0] if bound else NOT_MEASURED,
               bound_by=bound[1] if bound else NOT_MEASURED,
               share=NOT_MEASURED, **extra)
        return
    ms = float(np.median(samples)) if value is None else value
    b.line(f"kernel/{name}", ms, "ms", correct, t0, samples,
           bound_ms=bound[0], bound_by=bound[1], share=bound[0] / ms,
           **extra)


def _forward_lines(b, prepared, names):
    """K1 (or K3) on the frame's rays, without and with codes: returns
    the codes and rays for K2."""
    from cutrace_tpu_torch.ops import fused
    from cutrace_tpu_torch.render.renderer import block_rays, render, to_image
    from cutrace_tpu_torch.utils.profiling import sample_ms
    from cutrace_tpu_torch.utils.roofline import forward_bound, tally_of

    soa, accel, tables = prepared.soa, prepared.accel, prepared.tables
    o, d, inverse = block_rays(soa)
    frame = render(prepared, bounces=b.bounces)
    base = codes = None
    for name, topo in zip(names, (False, True)):
        t0 = time.perf_counter()

        def fn():
            return fused.fused_render_rays(soa, accel, o, d, 1e-3, b.bounces,
                                           emit_topo=topo, tables=tables)

        out = fn()
        b.sync()
        if topo:
            *out, codes = out
            correct = _frames_equal(out, base)
            check = "color, depth and normal equal K1's without codes"
        else:
            base = out
            correct = _frames_equal(to_image(soa, inverse, *out), frame)
            check = "equals the frame program's images"
        extra = {}
        samples = bound = None
        if b.cuda:
            instance = fused.k1_instance(soa, tables)
            extra["instance"] = {fused._K1_SHARED: "K1, shared memory",
                                 fused._K1_GLOBAL: "K1, global memory",
                                 fused._K3: "K3, ordered tree walk"}[instance]
            samples = sample_ms(fn, KERNEL_REPS, b.dev)
            tally = tally_of(lambda t: fused._fused_forward_cuda(
                soa, tables, o, d, 1e-3, b.bounces, emit_topo=topo, tally=t),
                b.dev)
            bound = forward_bound(soa, accel, tables, o.shape[0], tally,
                                  codes.shape[1] if topo else 0)["bound"]
        _kernel_line(b, name, t0, samples, bound, correct,
                     size=f"{soa.width}x{soa.height}", bounces=b.bounces,
                     triangles=int(soa.tri_p1.shape[0]), check=check,
                     **extra)
    return o, d, codes


def _k2_line(b, prepared, o, d, codes):
    from cutrace_tpu_torch.ops import replay_vjp as rv
    from cutrace_tpu_torch.utils.profiling import kernel_records
    from cutrace_tpu_torch.utils.roofline import vjp_bound

    t0 = time.perf_counter()
    soa = prepared.soa
    r = o.shape[0]
    rng = np.random.default_rng(0)
    cot = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
           .to(b.dev) for s in ((r, 3), (r,), (r, 3))]
    cot[1] = torch.where(codes[:, 0] >= 0, cot[1], 0.0)  # misses: no depth
    tabs = rv.backward_tables(soa)

    def fn():
        return rv.vjp_tables(soa, *tabs, o, d, codes, tuple(cot), 1e-3,
                             b.bounces)

    before = rv.LAUNCHES
    out = fn()
    b.sync()
    finite = all(bool(torch.isfinite(x).all()) for x in out)
    samples = None
    if b.cuda:
        samples = [sum(kernel_records(fn, "replay_vjp"))
                   for _ in range(KERNEL_REPS)]
    launched = rv.LAUNCHES - before
    ran = launched == (1 + KERNEL_REPS if b.cuda else 0)
    _kernel_line(b, "K2", t0, samples, vjp_bound(soa, codes, b.bounces),
                 finite and ran and (not b.cuda or min(samples) > 0),
                 size=f"{soa.width}x{soa.height}", bounces=b.bounces,
                 launches=launched, finite=finite,
                 shared_from=rv.vjp_instance(soa, b.bounces).shared_from)


def _k4_line(b):
    """K4: its launches in one replayed pallas frame, their device time
    from a trace of it, their bound from tallies of the same frame op by
    op."""
    from cutrace_tpu_torch.ops import pallas_cast as pc
    from cutrace_tpu_torch.render.renderer import render, render_eager
    from cutrace_tpu_torch.utils.profiling import kernel_records
    from cutrace_tpu_torch.utils.roofline import cast_bound

    t0 = time.perf_counter()
    p = load("bunny", b.frame_size(), b.dev, accel="pallas",
             bounces=b.bounces)
    frame = render(p, bounces=b.bounces)  # warm-up and capture
    b.sync()
    before = pc.LAUNCHES
    frame = render(p, bounces=b.bounces)
    b.sync()
    launches = pc.LAUNCHES - before
    cast = pc.cast_clusters
    tallies = []

    def tallied(tables, o, d, min_dist, tally=None):
        t = torch.zeros(pc.TALLY_COUNTS, dtype=torch.int64, device=o.device)
        tallies.append((tables, o.shape[0], t))
        return cast(tables, o, d, min_dist, t)

    pc.cast_clusters = tallied
    try:
        eager = render_eager(p, bounces=b.bounces)
    finally:
        pc.cast_clusters = cast
    b.sync()
    same = _frames_equal(frame, eager)
    if not b.cuda:
        _kernel_line(b, "K4", t0, None, None, same, launches=launches,
                     check="the pallas frame equals render_eager's")
        return
    records = kernel_records(lambda: render(p, bounces=b.bounces),
                             "cluster_cast_kernel")
    full = all(int(t[0]) == r for _, r, t in tallies)
    bounds = [cast_bound(tabs, r, t)["bound"] for tabs, r, t in tallies]
    by_ops = sum(x[1] == "operations" for x in bounds)
    bound = (sum(x[0] for x in bounds) / len(bounds),
             "operations" if 2 * by_ops >= len(bounds) else "bytes")
    correct = (same and full and launches == len(tallies) > 0
               and 0 < len(records) <= launches)
    _kernel_line(b, "K4", t0, records, bound, correct,
                 value=sum(records) / len(records),
                 size=f"{p.soa.width}x{p.soa.height}", bounces=b.bounces,
                 launches=launches, traced_records=len(records),
                 frame_device_ms=sum(records) / len(records) * launches,
                 value_is="the mean K4 record of the traced frame")


def kernels(b):
    """g. K1, K1 with codes, K2, K3, K4."""
    from cutrace_tpu_torch.bigscene import subdivided_bunny
    from cutrace_tpu_torch.render.renderer import prepare

    p = load("bunny", b.frame_size(), b.dev, bounces=b.bounces)
    o, d, codes = _forward_lines(b, p, ("K1", "K1_topo"))
    _k2_line(b, p, o, d, codes)
    del p, o, d, codes
    _free(b)
    sc, _ = subdivided_bunny(min(STEP_LEVELS, b.levels),
                             *b.frame_size(BIG_SIZE))
    p = prepare(sc, accel="fused", device=b.dev, bounces=b.bounces)
    _forward_lines(b, p, ("K3",))
    del p
    _free(b)
    _k4_line(b)
    _free(b)


def headline(b):
    """h. the bunny 1080p b5 frame in Mcasts/s, last."""
    from cutrace_tpu_torch.ops import fused

    t0 = time.perf_counter()
    p = load("bunny", b.frame_size(), b.dev, bounces=b.bounces)
    samples, fields, ok = frame_run(b, p, b.reps)
    gate = gate_frame(b, "bunny")
    if b.cuda:
        shared = fused.k1_instance(p.soa, p.tables) == fused._K1_SHARED
        fields["instance"] = "K1, shared memory" if shared else "other"
        ok = ok and shared
    b.line("bunny_1080p_ray_casts", fields["mcasts_per_s"], "Mcasts/s",
           ok and gate["passes"], t0, samples, gate=gate, **fields)


def probe(b):
    """a. versions, the card, and the kernels' build."""
    t0 = time.perf_counter()
    build_s = None
    if b.cuda:
        from cutrace_tpu_torch.ops import _build

        _build.build_all()
        build_s = time.perf_counter() - t0
    b.line("probe", NOT_MEASURED if build_s is None else build_s, "s", True,
           t0, None if build_s is None else [build_s], "s",
           python=sys.version.split()[0], torch=torch.__version__,
           cuda=torch.version.cuda,
           device=torch.cuda.get_device_name(b.dev) if b.cuda else "cpu",
           build_s=NOT_MEASURED if build_s is None else build_s)


def _free(b):
    import gc

    gc.collect()
    if b.cuda:
        torch.cuda.empty_cache()


RUNS = {"probe": probe, "frames": frames, "pallas": pallas,
        "bigscene": bigscene, "steps": steps, "fit": fit,
        "kernels": kernels, "headline": headline}


def main(argv=None, fit_steps=(150, 250)) -> int:
    """Run the groups in order; 1 if a line's check failed. `fit_steps`:
    the example's color and camera steps (the tests shrink them)."""
    ap = argparse.ArgumentParser(prog="python -m cutrace_tpu_torch.bench")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reps", type=int, default=50,
                    help="timed samples a frame and step line (default 50: "
                         "the median and p80)")
    ap.add_argument("--size", type=_size, default=None, metavar="WxH",
                    help="every image's size (default: each line's own)")
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--levels", type=int, default=5,
                    help="the largest subdivision of the bigscene lines "
                         "(5: 1M triangles); the 256k step and K3 take at "
                         "most 4")
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=GROUPS,
                    help="the groups of lines to run, in their order")
    args = ap.parse_args(argv)
    try:
        b = Bench(args, fit_steps)
    except RuntimeError as e:
        raise SystemExit(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for group in GROUPS:
        if group in args.only:
            RUNS[group](b)
    if b.failed:
        print(f"bench: checks failed on {', '.join(b.failed)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
