"""A closed loop of frames over a (tiles, prims) mesh of devices, one
process a device: the program's prepare() and prepare_sharded() once,
then render_sharded(scene, mesh) frame after frame, each synchronised on
every rank before the next is issued. Rank 0 times the frames; every
`stop_every` frames it tells the ranks over a gloo group whether the
window is over, so all ranks render the same frames. Rank 0's image of a
frame drawn by the seed (every rank holds the whole image) is compared
with the reference's frame.

`run` starts the ranks (python -m portbench.rank, rendezvous on a free
localhost port) and returns rank 0's result; each rank runs `rank_main`.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

from portbench import check, harness, inputs, trace
from portbench.reference import frame as rf
from portbench.reference.tracer import Tracer
from portbench.window import Window

JOIN_S = 1100  # a first run builds the kernels in every rank


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(ctx: harness.Context, device: str = "cuda", seeds=None) -> dict:
    """Rank 0's result of the run; with `seeds` (calibration) a list of
    results, one a seed, each with a window of ctx.seconds."""
    world = ctx.mix["tiles"] * ctx.mix["prims"]
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for rank in range(world):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE=str(world),
                       RANK=str(rank), LOCAL_RANK=str(rank))
            args = {"workload": ctx.workload, "cfg": ctx.cfg,
                    "mix": ctx.mix, "seeds": seeds or [ctx.seed],
                    "seconds": ctx.seconds, "trace": ctx.trace,
                    "t0_wall": ctx.t0_wall, "device": device,
                    "out": os.path.join(tmp, "rank0.json")}
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.rank", json.dumps(args)],
                env=env))
        try:
            deadline = time.monotonic() + JOIN_S
            for p in procs:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
                if rc != 0:
                    raise RuntimeError(f"a rank exited with {rc}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        with open(os.path.join(tmp, "rank0.json")) as f:
            outs = json.load(f)
    return outs if seeds else outs[0]


def _window(ctx, sharded, mesh, ctl, dev):
    """Set-up's warm-up, the window and what each rank read in it:
    (Window, events or None)."""
    import torch.distributed as dist
    from cutrace_tpu_torch.parallel.sharding import render_sharded

    bounces = ctx.cfg["bounces"]

    def frame():
        out = render_sharded(sharded, mesh, bounces=bounces)
        harness.sync(dev)
        return out

    for _ in range(harness.WARMUP):
        frame()
    dist.barrier(group=ctl)
    win = Window(ctx.window_seconds, ctx.seed)
    every = ctx.mix["stop_every"]

    def stop(elapsed):
        if len(win.latencies) % every:
            return False
        flag = torch.tensor([int(elapsed >= ctx.window_seconds)])
        dist.broadcast(flag, 0, group=ctl)
        return bool(flag.item())

    if ctx.trace:
        _, events = trace.traced(lambda: win.run(frame, stop))
        return win, events
    win.run(frame, stop)
    return win, None


def rank_main(args: dict) -> None:
    import torch.distributed as dist
    from cutrace_tpu_torch.parallel import multihost
    from cutrace_tpu_torch.parallel.sharding import (make_mesh,
                                                     prepare_sharded)
    from cutrace_tpu_torch.render.renderer import drop_programs, prepare

    from portbench.run import loaded_forbidden

    rank = int(os.environ["RANK"])
    dev = (torch.device("cuda", int(os.environ["LOCAL_RANK"]))
           if args["device"] == "cuda" else torch.device("cpu"))
    multihost.initialize(device=dev)
    results = []
    for seed in args["seeds"]:
        ctx = harness.Context(
            workload=args["workload"], cfg=args["cfg"], mix=args["mix"],
            seed=seed, seconds=args["seconds"], trace=args["trace"],
            device=dev, t0=time.perf_counter(), t0_wall=args["t0_wall"])
        mix = ctx.mix
        if not results:
            mesh = make_mesh(mix["tiles"], mix["prims"], device=dev)
            ctl = dist.new_group(backend="gloo")
        scene = inputs.program_scene(ctx.cfg, mix, seed)
        harness.reset_peak(dev)
        t = time.perf_counter()
        sharded = prepare_sharded(
            prepare(scene, accel=ctx.cfg["accel"], device=dev,
                    bounces=ctx.cfg["bounces"]), mesh)
        harness.sync(dev)
        prepare_s = time.perf_counter() - t
        win, events = _window(ctx, sharded, mesh, ctl, dev)
        # the wall clock at the window's start, less the parent's start
        setup_s = time.time() - (time.perf_counter() - win.start) \
            - ctx.t0_wall
        mine = {"peak": harness.peak_bytes(dev), "prepare_s": prepare_s,
                "forbidden": loaded_forbidden()}
        if events is not None:
            mine["summary"] = dict(trace.summarize(events),
                                   requests=len(win.latencies))
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine, group=ctl)
        kept = harness.flat_frame(win.kept) if rank == 0 else None
        win.kept = None
        del sharded
        drop_programs()
        results.append((ctx, win, setup_s, ranks, kept))
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    dist.barrier(group=ctl)
    dist.destroy_process_group()
    if rank != 0:
        return
    harness.free(dev)
    outs = [_result(*r, kind) for r in results]
    with open(args["out"], "w") as f:
        json.dump(outs, f)


def _result(ctx, win, setup_s, ranks, kept, kind) -> dict:
    """Rank 0's result of one window, its frame checked."""
    cfg, dev = ctx.cfg, ctx.device
    t = time.perf_counter()
    data = inputs.reference_scene(cfg, ctx.mix, ctx.seed)
    tracer = Tracer(data, dev)
    n = data.width * data.height
    pixels = harness.sample_pixels(n, ctx.reference_pixels("check_pixels"),
                                   ctx.seed, 2, dev)
    ref = [x.cpu() for x in rf.render(tracer, tracer.params(), pixels,
                                      cfg["bounces"], ctx.block)]
    idx = pixels.cpu()
    out = {"e2e": {"frame_ms": win.mean_ms(), "frame_p95_ms": win.p95_ms(),
                   "setup_s": setup_s},
           "attempted": len(win.latencies), "failed": 0,
           "memory_peak_bytes": max(r["peak"] for r in ranks),
           "numbers": check.frame_numbers([x[idx] for x in kept], ref),
           "forbidden": sorted({m for r in ranks for m in r["forbidden"]}),
           "device_kind": kind, "check_s": time.perf_counter() - t}
    if "summary" in ranks[0]:
        per = [r["summary"] for r in ranks]
        out["summary"] = dict(
            per[0], kind="render_sharded", ranks=per,
            prepare_s=max(r["prepare_s"] for r in ranks),
            busy_s_mean=sum(s["busy_s"] for s in per) / len(per))
    return out
