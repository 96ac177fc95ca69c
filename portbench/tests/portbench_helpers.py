"""Tiny cells on the CPU: a workload's configuration and mix at a size
the plain versions render in seconds."""

import time

import torch

from portbench import harness, inputs
from portbench.run import ROOT, benchmark, load_module

SEED = 2**31 + 99  # a seed past 32 bits


# a cell whose files are here, for a later BENCHMARK.json entry
FOUR_CARDS = {"name": "bunny_1080p.render_4gpu", "config": "bunny_1080p",
              "traffic": "render_4gpu", "chips": 4}


def tiny_context(workload: str, width=24, height=14, seconds=0.3,
                 trace=False, seed=SEED, **mix):
    wl = FOUR_CARDS if workload == FOUR_CARDS["name"] else next(
        w for w in benchmark()["workloads"] if w["name"] == workload)
    cfg = inputs.read_json("configs", wl["config"])
    cfg.update(width=width, height=height, subdivide=min(
        cfg.get("subdivide", 0), 1))
    cfg["reference"] = {"block": 2048, "check_pixels": 0,
                        "count_pixels": 64}
    m = dict(inputs.read_json("mixes", wl["traffic"]), stop_every=1, **mix)
    return harness.Context(workload=wl, cfg=cfg, mix=m, seed=seed,
                           seconds=seconds, trace=trace,
                           device=torch.device("cpu"),
                           t0=time.perf_counter(), t0_wall=time.time())


def loop_of(ctx):
    return load_module(ROOT / "loops" / f"{ctx.mix['loop']}.py")


def run_tiny(ctx):
    """The loop's result on the CPU (a multi-device loop over gloo)."""
    loop = loop_of(ctx)
    if ctx.workload["chips"] > 1:
        return loop.run(ctx, device="cpu")
    return loop.run(ctx)


def limits(workload):
    return inputs.read_json("checks", workload)
