"""Time the fused forward kernels (K1, K3) of several checkouts of this
repository on one CUDA card, in turns.

    python -m cutrace_tpu_torch.compare_kernels ROOT [ROOT ...]
        [--labels NAME ...] [--order I ...] [--cases NAME ...]

Run from the repository root. Each ROOT is a checkout of the repository,
for instance an older commit unpacked with `git archive` into a directory
that .gitignore lists. For each index in --order (by default the roots,
then the roots in reverse: parent, change, change, parent), a subprocess
started in that root builds its kernels and times its `fused_render_rays`
on the prepared tables, by CUDA events (mean of 10 launches after a
warm-up), on each case:

  bunny       scenes/bunny.json at its authored 1920x1080, b5 (K1)
  bunny/256k  the bunny's mesh subdivided 4 times, 960x540 b5 (K3)
  bunny/1M    subdivided 5 times, 960x540 b5 (K3)

It calls only what every checkout since the big-scene kernel (K3) has:
`load_scene`, `bigscene.subdivided_bunny`, `prepare`, `block_rays` and
`ops.fused.fused_render_rays`. Each run prints one JSON line with the
card's `nvidia-smi` name and power limit; the last line is a JSON summary
of every case's times per label.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

CASES = {"bunny": (0, 1920, 1080), "bunny/256k": (4, 960, 540),
         "bunny/1M": (5, 960, 540)}

# what a run does in its root: build, prepare each case, time the forward
_CHILD = r"""
import json, subprocess, sys
import torch
sys.path.insert(0, ".")
from cutrace_tpu_torch import bigscene, load_scene
from cutrace_tpu_torch.ops import fused
from cutrace_tpu_torch.render.renderer import block_rays, prepare

def event_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps

torch.backends.cuda.matmul.allow_tf32 = False
out = {}
for name, (levels, w, h) in json.loads(sys.argv[1]).items():
    if levels == 0:
        sc = load_scene("scenes/bunny.json")
    else:
        sc, _ = bigscene.subdivided_bunny(levels, w, h)
    p = prepare(sc, accel="fused", device="cuda", bounces=5)
    o, d, _ = block_rays(p.soa)
    fn = lambda: fused.fused_render_rays(p.soa, p.accel, o, d, 1e-3, 5,
                                         tables=p.tables)
    fn()
    torch.cuda.synchronize()
    out[name] = {"ms": event_ms(fn, 10),
                 "clusters": int(p.accel.order.shape[0]),
                 "cluster_size": int(p.accel.order.shape[1])}
    del p, o, d, fn
    torch.cuda.empty_cache()
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip().splitlines()[0]
print(json.dumps({"card": smi, "cases": out}))
"""


def run(root: pathlib.Path, cases: dict, timeout: float) -> dict:
    """One run of the timing code in `root`; its JSON line as a dict."""
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(cases)], cwd=root,
        capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"timing run in {root} failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cutrace_tpu_torch.compare_kernels")
    ap.add_argument("roots", nargs="+", type=pathlib.Path)
    ap.add_argument("--labels", nargs="*")
    ap.add_argument("--order", nargs="*", type=int)
    ap.add_argument("--cases", nargs="*", choices=list(CASES),
                    default=list(CASES))
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    labels = args.labels or [str(r) for r in args.roots]
    if len(labels) != len(args.roots):
        ap.error("one label per root")
    order = args.order
    if order is None:
        order = list(range(len(args.roots)))
        order += order[::-1]
    cases = {k: CASES[k] for k in args.cases}
    summary = {label: {k: [] for k in cases} for label in labels}
    for i in order:
        rec = run(args.roots[i], cases, args.timeout)
        rec["label"] = labels[i]
        print(json.dumps(rec), flush=True)
        for k, v in rec["cases"].items():
            summary[labels[i]][k].append(v["ms"])
    print(json.dumps({"ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
