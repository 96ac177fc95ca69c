"""The multi-card fit's bits under several NCCL algorithms, across
checkouts of this repository, in turns.

    python -m cutrace_tpu_torch.compare_fits ROOT [ROOT ...]
        [--labels NAME ...] [--nproc 4]
        [--algos allreduce:ring allreduce:tree] [--out build/compare_fits]
        -- SCENE [multihost arguments, --steps N among them]

Run from the repository root. Each ROOT is a checkout of the repository,
for instance an older commit unpacked with `git archive` into a directory
that .gitignore lists. For each setting in --algos (NCCL_ALGO; "default"
leaves it unset; a plain "Tree" stops every all-gather, which has no
tree, so the defaults set the all-reduce's algorithm alone) the roots run
in turn, in order for the first setting and reversed for the next
(parent, change, change, parent for two), each as one `torchrun --standalone --nproc_per_node NPROC` of that checkout's
`cutrace_tpu_torch.parallel.multihost` with the arguments after `--`.
Inside each rank, that checkout's `parallel.train.fit` is wrapped to keep
every fit's final parameters and losses, and `make_train_step` to time
each step (CUDA events around the call on the card, the host clock on
the CPU); rank 0 writes them under --out. Only what every checkout since
the step programs has is called: `multihost.main`, `train.fit` and
`train.make_train_step`.

Each run prints one JSON line: the root's label, the algorithm, the
multihost line's mesh, fit losses, `fit_differ` and digest (where the
checkout has them), whether the step ran as a program, the pixels that
differ from one rank's render and the frame means, the SHA-256 of its
first program fit's parameters (multihost.params_sha256 of this
checkout), and the step times of its fits (a program fit's first call is
eager, its second captures; the rest are replays). The last line is a
summary per label: the loss and parameter elements of the first program
fit that differ between its first run and each later one (in float32
bits; "allreduce:ring/allreduce:tree#1"), and the median replayed step
of each program fit, run by run in the order of --algos (a setting may
come twice: "--algos default default" times the roots in turns).
chip_smoke.py's `scaling` phase runs compare() over its own checkout on
two or more cards.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

import numpy as np

from cutrace_tpu_torch.scaling import DEADLINE_S
from cutrace_tpu_torch.utils.subprocs import failure_text, run_tree

# Runs in each rank of a torchrun started in ROOT: ROOT's package, fit and
# make_train_step wrapped, its multihost.main; rank 0 writes OUT.json
# (every fit's losses, every step's ms) and OUT.npz (every fit's
# parameters).
_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
from cutrace_tpu_torch.parallel import multihost, train

out, argv = sys.argv[1], sys.argv[2:]
fits, steps = [], []
fit, make = train.fit, train.make_train_step


def kept_fit(*a, **k):
    params, losses = fit(*a, **k)
    fits.append((bool(k.get("program", True)),
                 {n: v.detach().cpu().numpy() for n, v in params.items()},
                 list(losses)))
    return params, losses


def timed_make(*a, **k):
    step = make(*a, **k)
    times = []
    steps.append({"program": bool(k.get("program", True)), "ms": times})

    def timed(params, *rest):
        if next(iter(params.values())).is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(params, *rest)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            loss = step(params, *rest)
            times.append((time.perf_counter() - t0) * 1e3)
        return loss

    return timed


train.fit, train.make_train_step = kept_fit, timed_make
rc = multihost.main(argv)
if int(os.environ.get("RANK", "0")) == 0:
    np.savez(out + ".npz", **{f"{i}/{n}": v for i, (_, p, _) in
                              enumerate(fits) for n, v in p.items()})
    with open(out + ".json", "w") as f:
        json.dump({"fits": [{"program": p, "losses": l}
                            for p, _, l in fits], "steps": steps}, f)
sys.exit(rc)
"""


def _build(root: pathlib.Path, timeout: float):
    """Build the root's kernels once, so that no rank runs nvcc."""
    subprocess.run([sys.executable, "-c",
                    "import sys; sys.path.insert(0, '.'); "
                    "from cutrace_tpu_torch.ops import _build; "
                    "_build.build_all()"],
                   cwd=root, check=True, timeout=timeout)


def run(root: pathlib.Path, algo: str, nproc: int, out: pathlib.Path,
        mh_args: list, timeout: float) -> dict:
    """One torchrun of the root's multihost under NCCL_ALGO=algo: the
    multihost line, and what its rank 0 kept."""
    env = dict(os.environ, PYTHONPATH=str(root))
    env.pop("NCCL_ALGO", None)
    if algo != "default":
        env["NCCL_ALGO"] = algo
    rc, stdout, stderr = run_tree(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), "--no-python", sys.executable,
         "-c", _CHILD, str(out), *mh_args], root, env, timeout)
    with open(f"{out}.err", "w") as f:
        f.write(stderr)
    if rc != 0:
        raise RuntimeError(f"{root} under NCCL_ALGO={algo} exited {rc} "
                           f"(standard error in {out}.err):\n"
                           f"{failure_text(stderr)}")
    line = json.loads(next(ln for ln in reversed(stdout.splitlines())
                           if ln.startswith("{")))
    with open(f"{out}.json") as f:
        kept = json.load(f)
    return {"line": line, "kept": kept, "params": dict(np.load(f"{out}.npz"))}


def _program_fit(result) -> int:
    """The index of the run's first program fit."""
    return next(i for i, f in enumerate(result["kept"]["fits"])
                if f["program"])


def _fit_params(result, i) -> dict:
    prefix = f"{i}/"
    return {k[len(prefix):]: v for k, v in result["params"].items()
            if k.startswith(prefix)}


def compare(roots, labels, algos, nproc: int, out: pathlib.Path,
            mh_args: list, timeout: float, emit=None):
    """Each root under each NCCL_ALGO setting in turn (main's order):
    (every run's line as main prints it, the summary per label). `emit`
    is called with each run's line as it is measured."""
    from cutrace_tpu_torch.parallel.multihost import (elements_differ,
                                                      params_sha256)

    import torch

    out.mkdir(parents=True, exist_ok=True)
    if "cpu" not in mh_args:
        for root in roots:
            _build(root, timeout)
    runs = {label: [] for label in labels}  # (algo, result) in turn
    lines = []
    for a, algo in enumerate(algos):
        order = list(zip(roots, labels))
        for root, label in (order if a % 2 == 0 else order[::-1]):
            res = run(root, algo, nproc, out.resolve() / "{}_{}_{}".format(
                label, a, "".join(c if c.isalnum() else "-" for c in algo)),
                mh_args, timeout)
            runs[label].append((algo, res))
            params = _fit_params(res, _program_fit(res))
            row = res["line"]
            lines.append({
                "label": label, "algo": algo, "mesh": row["mesh"],
                "fit_losses": row.get("fit_losses"),
                "fit_eager_losses": row.get("fit_eager_losses"),
                "fit_differ": row.get("fit_differ"),
                "fit_params_sha256": row.get("fit_params_sha256"),
                "params_sha256": params_sha256(
                    {k: torch.from_numpy(v) for k, v in params.items()}),
                "step_program": row.get("step_program"),
                "pixels_differ": row["pixels_differ"],
                "frame_ms": row["frame_ms"],
                "steps_ms": res["kept"]["steps"]})
            if emit:
                emit(lines[-1])
    summary = {}
    for label, done in runs.items():
        (first, base), *rest = done
        i = _program_fit(base)
        want = _fit_params(base, i)
        want_losses = base["kept"]["fits"][i]["losses"]
        differ = {}
        for a, (algo, res) in enumerate(rest, 1):
            j = _program_fit(res)
            got = _fit_params(res, j)
            differ[f"{first}/{algo}#{a}"] = {
                "losses": elements_differ(
                    want_losses, res["kept"]["fits"][j]["losses"]),
                "params": sum(elements_differ(want[k], got[k])
                              for k in want),
                "param_elements": sum(v.size for v in want.values())}
        summary[label] = {"differ": differ, "replayed_step_ms": [
            [float(np.median(s["ms"][2:])) for s in res["kept"]["steps"]
             if s["program"] and len(s["ms"]) > 2] for _, res in done]}
    return lines, summary


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ours, mh_args = (argv[:argv.index("--")], argv[argv.index("--") + 1:]) \
        if "--" in argv else (argv, [])
    ap = argparse.ArgumentParser(prog="python -m cutrace_tpu_torch."
                                      "compare_fits")
    ap.add_argument("roots", nargs="+", type=pathlib.Path)
    ap.add_argument("--labels", nargs="*")
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--algos", nargs="+",
                    default=["allreduce:ring", "allreduce:tree"])
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("build/compare_fits"))
    args = ap.parse_args(ours)
    _, summary = compare(
        [r.resolve() for r in args.roots],
        args.labels or [str(r) for r in args.roots], args.algos,
        args.nproc, args.out, mh_args, DEADLINE_S,
        emit=lambda line: print(json.dumps(line), flush=True))
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
