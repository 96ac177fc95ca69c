"""Process-group entry points (counterpart of cutrace_tpu.parallel.multihost).

Every process calls `initialize()`, loads the same scene (the loader is
deterministic, so every rank holds the same arrays), builds the mesh over
all ranks and renders its tile; the image is assembled on every rank
(sharding.gather_image). Nothing here brings in a rank-dependent value:
tile assignment is a function of the rank alone and the shard combine is a
(t, order) minimum, so the image is bit-identical to one process's.

Run as a module under torchrun it renders a scene over every rank and
rank 0 prints one JSON line: every rank's frame time as the program
(render_sharded) and op by op (render_sharded_eager), timed in turns in
the same run (`frame_ms`, `eager_ms`: means of --reps), every rank's
program frames one at a time (`frame_samples_ms`: --reps samples a rank,
one CUDA-event pair a frame), every rank's kernel launches over those
frames (`sample_launches`), every rank's forward-kernel tally of its
run (`work`: the counts of TALLY_KEYS; "not measured" on the CPU or
off the fused tiles route), the programs captured, the time it took to
prepare its shard, one rank's render of the same frame, and the pixels
in which they differ:

    torchrun --nproc_per_node 4 -m cutrace_tpu_torch.parallel.multihost \
        scenes/bunny.json [--prims 2] [--accel pallas] [--device cpu] \
        [--steps N] [--subdivide LEVELS]

one rank a card over NCCL, or with --device cpu over gloo (where both
run op by op). With --steps it then fits the scene's material colors,
perturbed by seeded noise, to that image over the mesh
(train.fit(mesh=...)): over NCCL through the step program (one captured
CUDA graph a step, its collectives inside), over gloo op by op, four
times from the same start in turns: op by op (program=False), program,
program, op by op. The line adds the fits' losses, wall seconds (their
setup included) and kernel launches, `fit_differ` (the losses and
parameter elements that differ between the two program fits and between
the two op-by-op fits) and `fit_params_sha256` (params_sha256 of the
program fit's parameters: equal digests from runs under different
NCCL_ALGO settings show that the gradient sum's order is the code's,
not the backend's). --subdivide splits every triangle of the scene's
meshes into four, LEVELS times (the big scenes of
cutrace_tpu_torch.bigscene: bunny.json at 4 levels holds 256k
triangles, at 5 levels 1M). cutrace_tpu_torch.scaling runs it once a
mesh size.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from cutrace_tpu_torch.parallel import sharding as sh
from cutrace_tpu_torch.parallel.sharding import gather_image  # noqa: F401
from cutrace_tpu_torch.utils.profiling import sample_ms

NOT_MEASURED = "not measured"
# a forward-kernel tally's counts (utils.roofline.tally_of)
TALLY_KEYS = ("casts", "visits", "slabs", "needed", "sub_slabs", "groups",
              "root_skips")


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


def _launches(fn):
    """(fn(), the kernel launches it made): every wrapper's launch count
    set to 0 just before it (a program adds its capture's on every
    replay), those above 0 after it, keyed "module.COUNTER"."""
    from cutrace_tpu_torch.render import renderer

    counters = renderer._launch_counters()
    for m, n in counters:
        setattr(m, n, 0)
    out = fn()
    return out, {f"{m.__name__.rsplit('.', 1)[-1]}.{n}": getattr(m, n)
                 for m, n in counters if getattr(m, n)}


def _every_rank(launches: dict, mesh: sh.Mesh) -> list:
    """Every rank's launch counts (_launches), gathered over the mesh's
    group, in rank order."""
    from cutrace_tpu_torch.render import renderer

    names = [f"{m.__name__.rsplit('.', 1)[-1]}.{n}"
             for m, n in renderer._launch_counters()]
    rows = sh._all_gather(torch.tensor(
        [launches.get(k, 0) for k in names], device=mesh.device), mesh.group)
    return [{k: c for k, c in zip(names, row) if c} for row in rows.tolist()]


def _pixels_differ(a, b) -> int:
    """Pixels in which two (color, depth, normal) frames differ in any
    value (+inf equal to +inf)."""
    differ = 0
    for x, y in zip(a, b):
        same = (x == y) | (torch.isinf(x) & torch.isinf(y))
        differ += int((~same.reshape(x.shape[0], x.shape[1], -1)
                       .all(-1)).sum())
    return differ


def elements_differ(a, b) -> int:
    """Elements in which two float32 tensors, arrays or lists of floats
    differ in any bit (other dtypes: in value)."""
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def params_sha256(params) -> str:
    """SHA-256 of a dict of tensors: each key, dtype, shape and bytes, in
    key order; equal digests from separate processes mean equal bits."""
    h = hashlib.sha256()
    for k in sorted(params):
        v = params[k].detach().cpu().contiguous()
        h.update(f"{k} {v.dtype} {tuple(v.shape)}".encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()


def _fit_rows(prepared, image, mesh: sh.Mesh, args) -> dict:
    """fit(mesh=...) of mat_color, perturbed by default_rng(7) noise, to
    `image` for args.steps Adam steps (lr 5e-2), from the same start four
    times in turns: op by op, through the step program where
    step_is_captured, the program again, op by op (the first fit also
    pays each process's first-use costs). Returns the first program fit's
    and the first op-by-op fit's losses, every fit's seconds, the kernel
    launches, whether the program ran, the elements (losses and
    parameters) that differ between the two program fits and between the
    two op-by-op fits, and a SHA-256 of the program fit's parameters
    (params_sha256), which separate runs compare."""
    from cutrace_tpu_torch.parallel import train

    soa = prepared.soa
    color = soa.mat_color.cpu().numpy()
    noise = np.random.default_rng(7).normal(0.0, 0.15, color.shape)
    start = dataclasses.replace(soa, mat_color=torch.from_numpy(
        np.clip(color + noise, 0.0, 1.0).astype(np.float32)).to(soa.device))
    fits = {True: [], False: []}
    out = {"step_program": train.step_is_captured(mesh.device, mesh),
           "fit_program_s": [], "fit_eager_s": []}
    for program in (False, True, True, False):
        sh.barrier(mesh)
        t0 = time.perf_counter()
        (params, losses), counts = _launches(lambda: train.fit(
            start, image, steps=args.steps, lr=5e-2, bounces=args.bounces,
            param_filter=("mat_color",), accel=args.accel, mesh=mesh,
            program=program))
        seconds = time.perf_counter() - t0
        fits[program].append((params, losses))
        out[f"fit{'_program' if program else '_eager'}_s"].append(seconds)
        out[f"fit{'' if program else '_eager'}_launches"] = counts
    params, losses = fits[True][0]
    out.update(fit_losses=losses, fit_eager_losses=fits[False][0][1],
               fit_s=out["fit_program_s"][0],
               fit_params_sha256=params_sha256(params))
    out["fit_differ"] = {
        kind: {"losses": elements_differ(a[1], b[1]),
               "params": sum(elements_differ(a[0][k], b[0][k])
                          for k in a[0])}
        for kind, (a, b) in (("program", fits[True]),
                             ("eager", fits[False]))}
    return out


def _rank_work(sharded: sh.ShardedScene, bounces: int):
    """This rank's forward-kernel tally (utils.roofline.tally_of: casts,
    admitted cluster visits, slab tests, needed visits, sub-box tests,
    groups scanned and root skips) over its run of one eager frame, the
    same launch render_sharded makes; None off the card or off the fused
    tiles route."""
    from cutrace_tpu_torch.ops import fused
    from cutrace_tpu_torch.render import renderer
    from cutrace_tpu_torch.utils.roofline import tally_of

    soa, mesh = sharded.soa, sharded.mesh
    if (mesh.device.type != "cuda" or mesh.n_prims > 1
            or sharded.tables is None
            or not fused.fused_supported(soa, sharded.accel, bounces)):
        return None
    run = sh.tile_run(soa, mesh)
    bo = renderer.block_order_tensors(soa.width, soa.height,
                                      run * mesh.n_tiles, mesh.device)
    o, d = sh.tile_rays(sharded, bo, run)
    return tally_of(lambda t: fused._fused_forward_cuda(
        soa, sharded.tables, o, d, 1e-3, bounces, tally=t), mesh.device)


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
    ap.add_argument("--subdivide", type=int, default=0, metavar="LEVELS",
                    help="split every mesh triangle into four LEVELS times "
                         "(default 0: the scene as loaded)")
    args = ap.parse_args(argv)
    from cutrace_tpu_torch.scene.mesh_io import subdivide
    from cutrace_tpu_torch.render import renderer
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
        for ob in sc.objects:
            if args.subdivide and type(ob).__name__ == "Mesh":
                ob.vertices = subdivide(ob.vertices, args.subdivide)
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

        def eager():
            return sh.render_sharded_eager(sharded, mesh,
                                           bounces=args.bounces)

        captures = renderer.CAPTURES
        image = frame()
        eager_image = eager()
        sh.barrier(mesh)
        # in turns, program and eager, within this run: frames on several
        # cards vary between runs
        ms = {"program": [], "eager": []}
        for kind, fn in (("program", frame), ("eager", eager),
                         ("eager", eager), ("program", frame)):
            ms[kind].append(_frame_ms(fn, args.reps, mesh.device))
        programs = renderer.CAPTURES - captures
        launches = {"program": _launches(frame)[1],
                    "eager": _launches(eager)[1]}
        # each program frame alone, one CUDA-event pair a frame, and the
        # launches those frames made, every rank's
        samples, sampled = _launches(
            lambda: sample_ms(frame, args.reps, mesh.device))
        sample_launches = _every_rank(sampled, mesh)
        every = sh._all_gather(torch.tensor(
            [np.mean(ms["program"]), np.mean(ms["eager"]), prepare_ms]
            + samples, dtype=torch.float64, device=mesh.device), mesh.group)
        tally = _rank_work(sharded, args.bounces)
        work = NOT_MEASURED if tally is None else [
            dict(zip(TALLY_KEYS, row)) for row in
            sh._all_gather(tally, mesh.group).tolist()]
        trained = _fit_rows(prepared, image[0], mesh, args) if args.steps \
            else {}
        if dist.get_rank() == 0:
            one = render(prepared, bounces=args.bounces)
            one_ms = _frame_ms(lambda: render(prepared, bounces=args.bounces),
                               args.reps, mesh.device)
            differ, eager_differ = (_pixels_differ(image, x)
                                    for x in (one, eager_image))
            dev = mesh.device
            print(json.dumps({
                "mesh": [mesh.n_tiles, mesh.n_prims],
                "scene": args.scene, "width": sc.camera.width,
                "height": sc.camera.height, "bounces": args.bounces,
                "triangles": int(prepared.soa.tri_p1.shape[0]),
                "accel": args.accel, "backend": dist.get_backend(),
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                "frame_ms": every[:, 0].tolist(),
                "eager_ms": every[:, 1].tolist(),
                "frame_samples_ms": every[:, 3:].tolist(),
                "sample_launches": sample_launches, "work": work,
                "programs": programs,
                "turns_ms": ms, "frame_launches": launches,
                "one_rank_ms": one_ms,
                "prepare_sharded_ms": every[:, 2].tolist(),
                "reps": args.reps, "pixels_differ": differ,
                "eager_pixels_differ": eager_differ, **trained}),
                flush=True)
        sh.barrier(mesh)
    finally:
        # the programs' graphs hold NCCL collectives: free them first
        renderer.drop_programs()
        gc.collect()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
