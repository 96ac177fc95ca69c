"""Readings that the check's limits are set from (not run by the
benchmark's own runs):

    python -m portbench.calibrate --workload <name> --seeds <n> ...
        [--control-seeds <n> ...] [--seconds 0.5] [--out FILE]

For each of --seeds, one run of the cell's program with a short window
(all seeds in one process; a multi-device cell in one set of ranks), and
its compared numbers. For each of --control-seeds, the control: the
reference in float32 with TF32 products (reference.tracer's `tf32`) put
in the program's place, against the reference; for a fit also the fault
of half of the image left out of the loss (the mean taken over the
rest), put in the program's place. One JSON line each, on standard
output and appended to --out.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import check, harness, inputs
from portbench.reference import frame as rf
from portbench.loops.train import make_target
from portbench.reference.tracer import Tracer
from portbench.run import ROOT, benchmark, load_module


def _emit(row, out):
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def control_frame(ctx) -> dict:
    data = inputs.reference_scene(ctx.cfg, ctx.mix, ctx.seed)
    n = data.width * data.height
    pixels = harness.sample_pixels(n, ctx.reference_pixels("check_pixels"),
                                   ctx.seed, 2, ctx.device)
    b = ctx.cfg["bounces"]
    sides = []
    for kw in ({}, {"dtype": torch.float32, "tf32": True}):
        tr = Tracer(data, ctx.device, **kw)
        sides.append([x.cpu() for x in rf.render(tr, tr.params(), pixels, b,
                                                 ctx.block)])
    return {"control": check.frame_numbers(sides[1], sides[0])}


def control_fit(ctx) -> dict:
    data = inputs.reference_scene(ctx.cfg, ctx.mix, ctx.seed)
    n = data.width * data.height
    b, groups, lr = ctx.cfg["bounces"], list(ctx.mix["train"]), ctx.mix["lr"]
    target = make_target(ctx, data)
    tr = Tracer(data, ctx.device)

    def steps(tracer, rows=0):
        losses, grads, change = rf.fit_steps(
            tracer, tracer.params(), target, b, ctx.block, groups, lr, 3,
            n=rows)
        return {"losses": losses,
                "grads": {k: v.cpu() for k, v in grads.items()},
                "change": {k: v.cpu() for k, v in change.items()}}

    ref = steps(tr)
    ctrl = steps(Tracer(data, ctx.device, dtype=torch.float32, tf32=True))
    half = steps(tr, n // 2)
    return {"control": check.fit_numbers(ctrl, ref),
            "half_batch": check.fit_numbers(half, ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    wl = next(w for w in benchmark()["workloads"]
              if w["name"] == args.workload)

    def context(seed):
        return harness.Context(
            workload=wl, cfg=inputs.read_json("configs", wl["config"]),
            mix=inputs.read_json("mixes", wl["traffic"]), seed=seed,
            seconds=args.seconds, trace=False,
            device=torch.device("cuda", 0), t0=time.perf_counter(),
            t0_wall=time.time())

    if args.seeds:
        ctx = context(args.seeds[0])
        loop = load_module(ROOT / "loops" / f"{ctx.mix['loop']}.py")
        if wl["chips"] > 1:
            outs = loop.run(ctx, seeds=args.seeds)
        else:
            outs = (loop.run(context(s)) for s in args.seeds)
        for seed, out in zip(args.seeds, outs):
            _emit({"workload": wl["name"], "seed": seed, "side": "program",
                   **{k: out.get(k) for k in ("numbers", "e2e", "attempted",
                                              "check_s", "detail")}},
                  args.out)
    for seed in args.control_seeds:
        ctx = context(seed)
        fn = control_fit if ctx.mix["loop"] == "train" else control_frame
        t = time.perf_counter()
        for side, numbers in fn(ctx).items():
            _emit({"workload": wl["name"], "seed": seed, "side": side,
                   "numbers": numbers, "seconds": time.perf_counter() - t},
                  args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
