"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell is looked up by name in
BENCHMARK.json; its configuration, traffic mix and per-layer metrics are
found by name under portbench/: configs/<config>.json, mixes/<traffic>.json
(whose `loop` names loops/<loop>.py), metrics/<metric>.py (each with
read(summary) -> a number or None) and checks/<workload>.json (each
compared number's limit).

The run loads the program (cutrace_tpu_torch) and the scene, warms up
the cell's own program, measures a closed loop of requests for --seconds
(with --trace 1 a traced window of at most the mix's `trace_seconds`),
then checks a request of the window against the plain reference. The
last line on standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), device, with --trace 1 breakdown, and last `check`:
each compared number with its limit, which also end standard error.

Without a CUDA card, or with fewer cards than the cell asks for, the run
exits 2 and prints no result; if jax, jaxlib, flax or cutrace_tpu is
loaded once the window has closed, it exits 3.
"""

from __future__ import annotations

import time

T0, T0_WALL = time.perf_counter(), time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cutrace_tpu")


def load_module(path: pathlib.Path):
    """A module from its file, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench._" + path.parent.name + "_" + path.stem.replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(ROOT.parent / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, name: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries that the cell reports: those
    that list it, or list no cells (for a per-layer metric, where the cell
    reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if kind == "end_to_end":
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moves
                             else [])]


def loaded_forbidden() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_info(out: dict, chips: int) -> dict:
    """The result's device: a loop that ran on other processes' cards
    names the card (`device_kind`)."""
    import torch

    kind = out.get("device_kind") or torch.cuda.get_device_name(0)
    return {"platform": "gpu", "kind": kind, "count": chips,
            "memory_peak_bytes": int(out["memory_peak_bytes"])}


def result_line(bench: dict, wl: dict, out: dict, device: dict,
                limits: dict, trace: bool):
    """(the result's JSON object, the check's rows)."""
    from portbench import check

    correct, rows = check.judge(out["numbers"], limits)
    metrics = {}
    if trace:
        s = out["summary"]
        for m in cell_metrics(bench, wl["name"], "per_layer"):
            value = load_module(ROOT / "metrics" / f"{m['name']}.py").read(s)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = dict(device, busy_s=s.get("busy_s_mean", s["busy_s"]),
                      window_s=s["window_s"])
    else:
        for m in cell_metrics(bench, wl["name"], "end_to_end"):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = {"device_ops": out["summary"]["device_ops"],
                             "idle_gaps": out["summary"]["idle_gaps"]}
    line["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return line, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = benchmark()
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"{wl['name']} needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    from portbench import harness, inputs

    torch.backends.cuda.matmul.allow_tf32 = False  # float32, TF32 off
    ctx = harness.Context(
        workload=wl, cfg=inputs.read_json("configs", wl["config"]),
        mix=inputs.read_json("mixes", wl["traffic"]), seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace),
        device=torch.device("cuda", 0), t0=T0, t0_wall=T0_WALL)
    loop = load_module(ROOT / "loops" / f"{ctx.mix['loop']}.py")
    out = loop.run(ctx)
    bad = loaded_forbidden() + out.get("forbidden", [])
    if bad:
        print(f"loaded in the run: {bad}", file=sys.stderr)
        return 3
    limits = inputs.read_json("checks", wl["name"])
    device = device_info(out, wl["chips"])
    line, rows = result_line(bench, wl, out, device, limits, ctx.trace)
    print(f"set-up parts: {out.get('setup_parts')}; the reference's "
          f"check took {out['check_s']!r} s after the window",
          file=sys.stderr)
    for k, v, lim in rows:
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
