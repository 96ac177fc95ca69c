"""A closed loop of frames on one device: the program's prepare() once,
then render(prepared) frame after frame, each synchronised on the device
before the next is issued. One frame of the window, drawn by the seed, is
compared with the reference's frame (every pixel, or the configuration's
`check_pixels` drawn by the seed)."""

from __future__ import annotations

import time

from portbench import check, harness, inputs, roofline, trace
from portbench.reference import frame as rf
from portbench.reference.tracer import Counts, Tracer
from portbench.window import Window


def run(ctx: harness.Context) -> dict:
    from cutrace_tpu_torch.render.renderer import (drop_programs, prepare,
                                                   render)

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    bounces = cfg["bounces"]
    scene = inputs.program_scene(cfg, mix, ctx.seed)
    harness.reset_peak(dev)
    t = time.perf_counter()
    prepared = prepare(scene, accel=cfg["accel"], device=dev,
                       bounces=bounces)
    harness.sync(dev)
    prepare_s = time.perf_counter() - t

    def frame():
        out = render(prepared, bounces=bounces, device=dev)
        harness.sync(dev)
        return out

    t = time.perf_counter()
    for _ in range(harness.WARMUP):
        frame()
    warmup_s = time.perf_counter() - t
    setup_s = time.perf_counter() - ctx.t0
    win = Window(ctx.window_seconds, ctx.seed)
    events = None
    if ctx.trace:
        _, events = trace.traced(lambda: win.run(frame))
    else:
        win.run(frame)
    peak = harness.peak_bytes(dev)
    kept = harness.flat_frame(win.kept)
    win.kept = None
    del prepared
    drop_programs()
    harness.free(dev)

    t = time.perf_counter()
    data = inputs.reference_scene(cfg, mix, ctx.seed)
    tracer = Tracer(data, dev)
    params = tracer.params()
    n = data.width * data.height
    pixels = harness.sample_pixels(n, ctx.reference_pixels("check_pixels"), ctx.seed,
                                   2, dev)
    ref = [x.cpu() for x in rf.render(tracer, params, pixels, bounces,
                                      ctx.block)]
    idx = pixels.cpu()
    numbers = check.frame_numbers([x[idx] for x in kept], ref)
    out = {"e2e": {"frame_ms": win.mean_ms(), "frame_p95_ms": win.p95_ms(),
                   "setup_s": setup_s},
           "attempted": len(win.latencies), "failed": 0,
           "memory_peak_bytes": peak, "numbers": numbers,
           "check_s": time.perf_counter() - t,
           "setup_parts": {"prepare_s": prepare_s, "warmup_s": warmup_s}}
    if events is not None:
        counts = Counts()
        sample = harness.sample_pixels(n, ctx.reference_pixels("count_pixels"),
                                       ctx.seed, 3, dev)
        rf.render(tracer, params, sample, bounces, ctx.block, counts)
        sizes = harness.scene_sizes(data)
        summary = trace.summarize(events)
        summary.update(
            kind="render", requests=len(win.latencies), prepare_s=prepare_s,
            bounds={"forward": roofline.forward_bound_s(
                counts, n / sample.numel(), n,
                roofline.table_bytes(**sizes), sizes["n_planes"],
                sizes["n_spheres"])})
        out["summary"] = summary
    return out
