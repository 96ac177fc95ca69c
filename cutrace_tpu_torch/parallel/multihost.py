"""Process-group entry points (counterpart of cutrace_tpu.parallel.multihost).

Every process calls `initialize()`, loads the same scene (the loader is
deterministic, so every rank holds the same arrays), builds the mesh over
all ranks and renders its tile; the image is assembled on every rank
(sharding.gather_image). Nothing here brings in a rank-dependent value:
tile assignment is a function of the rank alone and the shard combine is a
(t, order) minimum, so the image is bit-identical to one process's.

Run as a module under torchrun it renders a scene over every rank and
rank 0 prints one JSON line (every rank's frame time and the time it took
to prepare its shard, one rank's render of the same frame, the pixels in
which they differ):

    torchrun --nproc_per_node 4 -m cutrace_tpu_torch.parallel.multihost \
        scenes/bunny.json [--prims 2] [--accel pallas] [--device cpu] \
        [--steps N]

one rank a card over NCCL, or with --device cpu over gloo. With --steps
it then fits the scene's material colors, perturbed by seeded noise, to
that image over the mesh (train.fit(mesh=...)): on an NCCL tiles-only
mesh through the step program (one captured CUDA graph a step, its
all-reduce inside), elsewhere op by op; the line adds the fit's losses
and its wall seconds (its setup included).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from cutrace_tpu_torch.parallel import sharding as sh
from cutrace_tpu_torch.parallel.sharding import gather_image  # noqa: F401


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> None:
    """torch.distributed.init_process_group for this process.

    Without arguments the group comes from torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT); otherwise `coordinator_address`
    ("host:port" of rank 0), `num_processes` and `process_id` give it.
    `device` is sharding.rank_device's (this rank's card, or "cpu"); the
    card becomes the current CUDA device. `backend` defaults to NCCL on
    the card and gloo on the CPU."""
    dev = sh.rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev  # the rank's card, for NCCL's setup
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init, **kwargs)


def global_mesh(n_prims: int = 1, device=None) -> sh.Mesh:
    """The (tiles, prims) mesh over every rank of the group."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % n_prims:
        raise ValueError(f"{n} ranks do not split into {n_prims} prims")
    return sh.make_mesh(n // n_prims, n_prims, device=device)


def render_multihost(scene_or_soa, mesh: sh.Mesh, bounces: int = 5,
                     fudge: float = 1e-3):
    """render_sharded of a Scene (flattened on the mesh's device), a
    SceneArrays or a PreparedScene: the whole image on every rank."""
    from cutrace_tpu_torch.render.renderer import PreparedScene
    from cutrace_tpu_torch.scene.soa import SceneArrays, scene_to_soa

    scene = scene_or_soa
    if not isinstance(scene, (SceneArrays, PreparedScene)):
        scene = scene_to_soa(scene, device=mesh.device)
    return sh.render_sharded(scene, mesh, bounces=bounces, fudge=fudge)


def _frame_ms(fn, reps: int, device) -> float:
    """Mean milliseconds of fn() over reps runs: CUDA events on the card,
    the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _fit_rows(prepared, image, mesh: sh.Mesh, args) -> dict:
    """fit(mesh=...) of mat_color, perturbed by default_rng(7) noise, to
    `image` for args.steps Adam steps (lr 5e-2): its losses, seconds, and
    whether its steps ran as the step program."""
    from cutrace_tpu_torch.parallel import train

    soa = prepared.soa
    color = soa.mat_color.cpu().numpy()
    noise = np.random.default_rng(7).normal(0.0, 0.15, color.shape)
    start = dataclasses.replace(soa, mat_color=torch.from_numpy(
        np.clip(color + noise, 0.0, 1.0).astype(np.float32)).to(soa.device))
    sh.barrier(mesh)
    t0 = time.perf_counter()
    _, losses = train.fit(start, image, steps=args.steps, lr=5e-2,
                          bounces=args.bounces, param_filter=("mat_color",),
                          accel=args.accel, mesh=mesh)
    return {"fit_losses": losses, "fit_s": time.perf_counter() - t0,
            "step_program": train.step_is_captured(mesh.device, mesh)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torchrun ... -m cutrace_tpu_torch.parallel.multihost",
        description="Render a scene over every rank of a torchrun group; "
                    "rank 0 prints one JSON line.")
    ap.add_argument("scene")
    ap.add_argument("--prims", type=int, default=1,
                    help="ranks a triangle shard row (default 1: tiles "
                         "only)")
    ap.add_argument("--accel", default="fused",
                    choices=("none", "clusters", "pallas", "fused"))
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--width", type=int)
    ap.add_argument("--height", type=int)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed frames after one warm-up")
    ap.add_argument("--device", default=None,
                    help="cpu for gloo on the CPU (default: the rank's "
                         "card, NCCL)")
    ap.add_argument("--steps", type=int, default=0,
                    help="Adam steps of a mat_color fit to the rendered "
                         "image over the mesh (default 0: none)")
    args = ap.parse_args(argv)
    from cutrace_tpu_torch.render.renderer import prepare, render
    from cutrace_tpu_torch.scene.loader import load_scene

    initialize(device=args.device)
    try:
        mesh = global_mesh(args.prims, device=args.device)
        sc = load_scene(args.scene)
        if args.width:
            sc.camera.width = args.width
        if args.height:
            sc.camera.height = args.height
        prepared = prepare(sc, accel=args.accel, device=mesh.device,
                           bounces=args.bounces)
        # timed warm: the first call also makes the NCCL communicators
        sharded = sh.prepare_sharded(prepared, mesh)
        t0 = time.perf_counter()
        sharded = sh.prepare_sharded(prepared, mesh)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        prepare_ms = (time.perf_counter() - t0) * 1e3

        def frame():
            return sh.render_sharded(sharded, mesh, bounces=args.bounces)

        image = frame()
        sh.barrier(mesh)
        ms = _frame_ms(frame, args.reps, mesh.device)
        every = sh._all_gather(torch.tensor([ms, prepare_ms],
                                            device=mesh.device), mesh.group)
        trained = _fit_rows(prepared, image[0], mesh, args) if args.steps \
            else {}
        if dist.get_rank() == 0:
            one = render(prepared, bounces=args.bounces)
            one_ms = _frame_ms(lambda: render(prepared, bounces=args.bounces),
                               args.reps, mesh.device)
            differ = 0
            for a, b in zip(image, one):
                same = (a == b) | (torch.isinf(a) & torch.isinf(b))
                differ += int((~same.reshape(a.shape[0], a.shape[1], -1)
                               .all(-1)).sum())
            dev = mesh.device
            print(json.dumps({
                "mesh": [mesh.n_tiles, mesh.n_prims],
                "scene": args.scene, "width": sc.camera.width,
                "height": sc.camera.height, "bounces": args.bounces,
                "accel": args.accel, "backend": dist.get_backend(),
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                "frame_ms": every[:, 0].tolist(), "one_rank_ms": one_ms,
                "prepare_sharded_ms": every[:, 1].tolist(),
                "reps": args.reps, "pixels_differ": differ, **trained}),
                flush=True)
        sh.barrier(mesh)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
