"""Scaling efficiency: ray casts per second against the number of cards
(counterpart of benchmarks/scaling.py).

    python -m cutrace_tpu_torch.scaling [--scene scenes/bunny.json]
        [--width 960] [--height 540] [--bounces 3] [--reps 20]
        [--devices N] [--device cpu] [--artifact PATH]

For each mesh size n of 1, 2, 4, ... up to N (N added when it is not a
power of two), one subprocess runs

    python -m torch.distributed.run --standalone --nproc_per_node n \\
        -m cutrace_tpu_torch.parallel.multihost SCENE --accel fused ...

on the (n, 1) tiles mesh: the frame split into n contiguous runs of
pixels, each rank rendering its run through the fused kernels as one
captured program with the image's all-gather inside (over NCCL, one rank
a card). Rank 0's JSON line gives each rank's program frames one at a
time (CUDA events); a sample is the largest of the ranks' k-th frames,
since the gather ties them frame by frame, and each rank's kernel
launches over those frames. A subprocess that runs past DEADLINE_S
seconds is stopped with its ranks, and it or a non-zero exit fails the
sweep.

One JSON line a mesh size (`line`: metric, value, unit, median,
percentile, n, sample_unit, correct, backend, card, seconds), metric
`scaling/<scene>_<W>x<H>_b<B>/devices<n>` in Mcasts/s = W * H *
casts_per_pixel / the median sample, with
  efficiency_vs_linear  Mcasts_n / (n * Mcasts_1)
  work                  each rank's forward-kernel tally of its run
                        (multihost `work`: casts, admitted cluster
                        visits, slab tests, needed visits, sub-box
                        tests and groups scanned)
  work_invariance       the admitted visits of one rank at n = 1 / their
                        sum over the n ranks (1.0: splitting the image
                        adds no work; the counterpart of the JAX module's
                        compiled-FLOPs invariance)
  balance               mean / max of the ranks' admitted visits: what
                        the contiguous runs cost at this size (the
                        slowest rank sets the frame)
  pixels_differ         pixels in which the mesh's image differs from one
                        rank's render (must be 0)
  sample_launches       each rank's kernel launches over its sampled
                        frames, keyed "module.COUNTER" (multihost; on the
                        card K1, "fused.LAUNCHES", once a frame; none on
                        the CPU)
  frame_launches        rank 0's launches in one program frame and in one
                        eager frame
and last `scaling/<scene>_<W>x<H>_b<B>/efficiency`, the efficiency at N,
as the JAX module's summary. `correct` is false, and the run exits 1,
if any mesh's image differs from one rank's render in any pixel.

The card by default, one rank a card; without a card it raises.
`--device cpu` runs the same sweep over gloo ranks on the CPU (the
plain versions; --devices defaults to 2 there), which shows the
mechanics only: the ranks share the host's cores, and `work` is "not
measured".
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

import numpy as np

from cutrace_tpu_torch.utils.subprocs import (failure_text, run_tree,
                                              stop_on_sigterm)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NOT_MEASURED = "not measured"
DEADLINE_S = 600  # one mesh size's subprocess, its start and build included


def mesh_sizes(n: int) -> list:
    """1, 2, 4, ... up to n, and n itself if it is not a power of two."""
    sizes, k = [], 1
    while k <= n:
        sizes.append(k)
        k *= 2
    if sizes[-1] != n:
        sizes.append(n)
    return sizes


def run_mesh(args, n: int, deadline: float = DEADLINE_S) -> dict:
    """Rank 0's multihost line of the (n, 1) "fused" tiles mesh, from one
    torchrun subprocess; raises if it runs past `deadline` seconds (it and
    its ranks stopped) or exits non-zero."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), "-m",
           "cutrace_tpu_torch.parallel.multihost", str(args.scene),
           "--accel", "fused", "--width", str(args.width), "--height",
           str(args.height), "--bounces", str(args.bounces), "--reps",
           str(args.reps)]
    if args.device == "cpu":
        cmd += ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    try:
        rc, out, err = run_tree(cmd, ROOT, env, deadline)
    except TimeoutError as e:
        raise RuntimeError(f"the {n}-rank mesh ran past {deadline} s, "
                           f"stopped with its ranks") from e
    if rc != 0:
        raise RuntimeError(f"the {n}-rank mesh exited {rc}:\n"
                           f"{failure_text(err)}")
    for line in reversed(out.splitlines()):
        if line.startswith("{"):
            row = json.loads(line)
            if row.get("mesh") == [n, 1]:
                return row
    raise RuntimeError(f"the {n}-rank mesh printed no line:\n{out[-4000:]}")


def mesh_fields(row: dict, n: int, cpp: int, first=None) -> dict:
    """A mesh size's fields from its multihost line: the samples (the
    largest of the ranks' k-th frames), Mcasts/s, and against `first`
    (the fields of n = 1; None for n = 1 itself) the efficiency and the
    work's invariance and balance."""
    samples = [max(frames) for frames in zip(*row["frame_samples_ms"])]
    median = float(np.median(samples))
    mcasts = row["width"] * row["height"] * cpp / median / 1e3
    work = row["work"]
    visits = None if work == NOT_MEASURED else [w["visits"] for w in work]
    base = first or {"mcasts_per_s": mcasts, "visits": visits}
    measured = visits is not None and base["visits"] is not None
    return {
        "samples": samples, "devices": n, "mesh": row["mesh"],
        "size": f"{row['width']}x{row['height']}",
        "bounces": row["bounces"], "accel": row["accel"],
        "casts_per_pixel": cpp, "frame_ms": median, "mcasts_per_s": mcasts,
        "efficiency_vs_linear": mcasts / (n * base["mcasts_per_s"]),
        "visits": visits, "work": work,
        "work_invariance": (sum(base["visits"]) / sum(visits) if measured
                            else NOT_MEASURED),
        "balance": (float(np.mean(visits)) / max(visits) if measured
                    else NOT_MEASURED),
        "pixels_differ": row["pixels_differ"],
        "sample_launches": row["sample_launches"],
        "frame_launches": row["frame_launches"],
        "rank_frame_ms": row["frame_ms"], "programs": row["programs"],
        "one_rank_ms": row["one_rank_ms"], "backend_group": row["backend"]}


def line(failed, backend, card, metric, value, unit, correct, t0,
         samples=None, **extra):
    """Print one JSON line: `metric`, `value`, `unit`, the spread of
    `samples` (utils.profiling.spread; "not measured" without them), their
    unit (ms), `correct`, `backend`, `card`, the extras and the seconds
    since `t0`. A failed line's metric is appended to `failed`."""
    from cutrace_tpu_torch.utils.profiling import spread

    stats = (spread(samples) if samples is not None
             else {"median": NOT_MEASURED, "percentile": None, "n": 0})
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      **stats, "sample_unit": "ms", "correct": bool(correct),
                      "backend": backend, "card": card, **extra,
                      "seconds": time.perf_counter() - t0}), flush=True)
    if not correct:
        failed.append(metric)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cutrace_tpu_torch.scaling")
    ap.add_argument("--scene", default=str(ROOT / "scenes" / "bunny.json"))
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20,
                    help="timed program frames a rank (default 20)")
    ap.add_argument("--devices", type=int, default=None,
                    help="the largest mesh (default: every card; 2 on "
                         "the CPU)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--artifact", default=None,
                    help="write the lines as one JSON document here")
    args = ap.parse_args(argv)
    stop_on_sigterm()  # a deadline above the sweep stops its torchrun too
    import torch

    from cutrace_tpu_torch.bigscene import card_name
    from cutrace_tpu_torch.scene.loader import load_scene
    from cutrace_tpu_torch.scene.soa import resolve_device, scene_to_soa
    from cutrace_tpu_torch.utils.profiling import casts_per_pixel

    backend = resolve_device(args.device).type
    cuda = backend == "cuda"
    card = card_name() if cuda else None
    failed = []
    cards = torch.cuda.device_count() if cuda else 0
    n_max = args.devices or (cards if cuda else 2)
    if cuda and n_max > cards:
        raise ValueError(f"--devices {n_max}: {cards} cards present")
    if cuda:  # once here, so that no rank runs nvcc
        from cutrace_tpu_torch.ops import _build

        _build.build_all()
    sc = load_scene(args.scene)
    sc.camera.width, sc.camera.height = args.width, args.height
    cpp = casts_per_pixel(scene_to_soa(sc, device="cpu"), args.bounces)
    tag = (f"scaling/{pathlib.Path(args.scene).stem}_{args.width}x"
           f"{args.height}_b{args.bounces}")
    rows, first = [], None
    t_sweep = time.perf_counter()
    for n in mesh_sizes(n_max):
        t0 = time.perf_counter()
        fields = mesh_fields(run_mesh(args, n), n, cpp, first)
        first = first or dict(fields)
        samples = fields.pop("samples")
        fields.pop("visits")
        line(failed, backend, card, f"{tag}/devices{n}",
             fields["mcasts_per_s"], "Mcasts/s", fields["pixels_differ"] == 0,
             t0, samples, **fields)
        rows.append(dict(fields, metric=f"{tag}/devices{n}",
                         samples_ms=samples))
    last = rows[-1]
    line(failed, backend, card, f"{tag}/efficiency",
         last["efficiency_vs_linear"], "fraction of linear", not failed,
         t_sweep, devices=last["devices"],
         speedup=last["mcasts_per_s"] / rows[0]["mcasts_per_s"],
         work_invariance=last["work_invariance"], balance=last["balance"])
    if args.artifact:
        pathlib.Path(args.artifact).write_text(json.dumps({
            "config": {"scene": pathlib.Path(args.scene).name,
                       "width": args.width, "height": args.height,
                       "bounces": args.bounces, "reps": args.reps},
            "card": card, "backend": backend, "rows": rows},
            indent=1) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
