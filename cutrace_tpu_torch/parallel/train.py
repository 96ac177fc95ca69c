"""The inverse-rendering training loop (counterpart of
cutrace_tpu.parallel.train).

Scene parameters are optimized with torch.optim.Adam (eps 1e-8, the same
update as optax.adam) against an image loss. With a "fused" partition the
forward emits topology codes and the backward replays them: on the card
through the hand-written kernels, on the CPU through their plain
versions.

With a parallel.sharding.Mesh the loss is split over its ranks: each tile
rank renders its run of pixels and takes its part of the global mean, and
the gradients are summed over the tiles group in tile-rank order
(sharding.all_reduce_sum), so every rank applies the same update, with
the same bits in every run; with PRIM_AXIS > 1 each rank holds and
updates its triangle shard.

Where the JAX package jits the whole step (`make_train_step`), the port
captures it on a CUDA device as one CUDA graph and replays it step after
step (make_train_step's `program`), over an NCCL mesh too, prim shards
included; the same step op by op is its plain version, and what runs on
the CPU and over gloo.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from cutrace_tpu_torch.diff.grad import (extract_params, render_loss,
                                         with_params)
from cutrace_tpu_torch.parallel import sharding as sh
from cutrace_tpu_torch.render import renderer
from cutrace_tpu_torch.scene.soa import SceneArrays, resolve_device, soa_to
from cutrace_tpu_torch.utils import tracing

# Step programs started anew since import because a step function was
# handed other params, soa or target objects than its program's.
REKEYS = 0


def sharded_loss(params, soa, mesh, target_flat, bounces: int,
                 fudge: float = 1e-3, accel=None):
    """This rank's part of the mean squared error between the render and
    `target_flat` ((H*W, 3), the whole target): the sum over the pixels of
    its tile, a contiguous scanline run, divided by 3·H·W, so the tile
    ranks' parts add up to the global mean. `soa` and `params` are the
    scene as the rank holds it (sharding.shard_scene, its triangle shard);
    `accel` is its partition (for PRIM_AXIS > 1 its own shard's, local
    orders). On a tiles-only mesh a "fused" partition runs the fused
    kernels with the replay backward (ops.fused.fused_render_rays)."""
    s = with_params(soa, params)
    n = s.width * s.height
    run = sh.tile_run(s, mesh)
    start = mesh.tile * run
    idx = torch.arange(start, start + run, device=s.device)
    color, _, _ = sh.render_pixels_sharded(s, mesh, idx, bounces, fudge,
                                           accel)
    k = max(0, min(run, n - start))  # pixels past the image are padding
    diff = color[:k] - target_flat.reshape(-1, 3)[idx[:k]]
    loss = (diff ** 2).sum() / (3 * n)
    tracing.mark("loss")
    return loss


def _all_reduce_grads(params, loss, mesh):
    """Sum the gradients of the trainable parameters and the loss over the
    tiles group, as one flat buffer in tile-rank order
    (sharding.all_reduce_sum: one all-gather, then the adds), so every
    rank and every run gets the same bits; returns the global loss."""
    live = [p for p in params.values() if p.requires_grad]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in live]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.detach().reshape(1)])
    flat = sh.all_reduce_sum(flat, mesh.tiles_group)
    at = 0
    for p in live:
        p.grad = flat[at:at + p.numel()].view_as(p).clone()
        at += p.numel()
    return flat[-1]


def _optimizer_device(optimizer) -> torch.device:
    """The device of the optimizer's parameters."""
    return next(p.device for g in optimizer.param_groups
                for p in g["params"])


def step_is_captured(device, mesh=None) -> bool:
    """Does make_train_step run its step on `device` over `mesh` as a
    captured program? On a CUDA device without a mesh, or over a mesh
    whose process groups are all NCCL's (sharding.mesh_captures): the
    tiles group's gradient sum and, with PRIM_AXIS > 1, every cast's
    all-gathers over the prims group are captured with the step. Not on
    the CPU; not over gloo, whose collectives of CUDA tensors go through
    the host, a synchronization that no capture holds."""
    if not renderer.GRAPHS.captures(device):
        return False
    return mesh is None or sh.mesh_captures(mesh)


def make_train_step(optimizer: torch.optim.Optimizer, bounces: int = 2,
                    fudge: float = 1e-3,
                    param_filter: Optional[Tuple[str, ...]] = None,
                    accel=None, mesh=None, program: bool = True) -> Callable:
    """An Adam (or any optimizer) step over scene parameters.

    Returns step(params, soa, target) -> loss, a device scalar; `params`
    (the tensors `optimizer` holds) are updated in place. `param_filter`
    restricts which parameter groups are updated; the others keep their
    values, as zero gradients leave them under Adam. `accel` (an
    ops.bvh.Accel) routes the render through the fused kernels; the
    partition stays fixed across steps, which is correct for any vertex
    positions, merely less tight as geometry drifts. With a `mesh`
    (parallel.sharding) `soa`, `params` and `accel` are the rank's own
    (sharded_loss), the gradients are summed over the tiles group in
    rank order before the update, and the loss returned is the global
    one.

    With `program` (the default), where step_is_captured, the step runs
    as one captured CUDA graph (the counterpart of the JAX package's
    jitted step): camera rays, the kernels' tables, the forward with
    codes, the backward, the routing of the cotangents to the leaves, the
    mesh's collectives (the prims group's all-gathers of every cast, the
    tiles group's gather and ordered sum) and the optimizer's update. For
    one set of (params, soa, target) objects, keyed on their identity
    (the graph reads them by address), the first call runs the step
    eagerly on a side stream (kernels built, caches filled, the
    optimizer's state made), the second captures it and replays it once,
    and every later call replays it: each call applies exactly one
    update. Other objects start a new program, from an eager call. The
    loss of a replay is a copy of the graph's. After capture the
    parameters' `.grad` are the graph's tensors; the optimizer's state
    must not be replaced (load_state_dict) under a program. The optimizer
    on a CUDA device must be built with capturable=True, or this raises;
    a failure to capture or replay raises. Without `program`, and
    elsewhere, the step runs op by op, its plain version.

    While tracing is on (utils.tracing) a call of the program's step is
    the request span `step`: `step.key` (the identity check),
    `program.replay`, `step.copy_out`. The step's marks end the phases
    rays, tables, pack, forward (the forward kernel), loss, cotangents,
    backward (the replay backward's kernels), routing (the rest of
    autograd), with a mesh reduce (the gradient sum), and optimizer."""
    device = _optimizer_device(optimizer)
    captured = program and step_is_captured(device, mesh)
    if captured and device.type == "cuda" and not all(
            g.get("capturable", False) for g in optimizer.param_groups):
        raise ValueError(
            "a step program on the card needs an optimizer built with "
            "capturable=True (torch.optim.Adam(..., capturable=True)); "
            "pass program=False to run the step op by op")

    def eager(params, soa, target):
        optimizer.zero_grad(set_to_none=True)
        if mesh is None:
            loss = render_loss(params, soa, target, bounces, fudge, accel)
            loss.backward()
            tracing.mark("routing")
        else:
            loss = sharded_loss(params, soa, mesh, target, bounces, fudge,
                                accel)
            loss.backward()
            tracing.mark("routing")
            loss = _all_reduce_grads(params, loss, mesh)
            tracing.mark("reduce")
        if param_filter is not None:
            for k, v in params.items():
                if k not in param_filter:
                    v.grad = None
        optimizer.step()
        tracing.mark("optimizer")
        return loss.detach()

    if not captured:
        return eager
    held = {}  # "key": the objects of the program's calls; "program"

    def step(params, soa, target):
        global REKEYS
        with tracing.request("step"):
            with tracing.span("step.key"):
                key = (params, soa, target, *params.values())
                old = held.get("key", ())
                same = len(old) == len(key) and all(
                    a is b for a, b in zip(old, key))
            if not same:
                if old:
                    REKEYS += 1
                held.clear()
                held["key"] = key
                with tracing.setup_span("program.build"), \
                        tracing.setup_span("program.warm"):
                    return renderer.GRAPHS.warm(
                        lambda: eager(params, soa, target), device)
            prog = held.get("program")
            if prog is None:
                prog = held["program"] = renderer._Program(
                    "step", lambda: (eager(params, soa, target),), None,
                    (key, optimizer), device, warm=False)
            prog.replay()
            with tracing.span("step.copy_out"):
                return prog.outputs[0].clone()

    return step


def _map_tri_state(opt_state, trainable, fn):
    """The optimizer state dict with fn applied to the per-row state
    tensors of the triangle parameters (a new dict; the optimizer's own
    state is not touched)."""
    state = dict(opt_state, state=dict(opt_state["state"]))
    for i, k in enumerate(trainable):
        if k in sh._TRI_FIELDS and i in state["state"]:
            state["state"][i] = {
                name: fn(v) if torch.is_tensor(v) and v.dim() > 0 else v
                for name, v in state["state"][i].items()}
    return state


def _save_checkpoint(path, params, opt, trainable, mesh, n_tris, step):
    """Save a checkpoint of the whole parameters: on a mesh the triangle
    shards (and their optimizer state) are gathered, the lowest rank
    writes, and every rank waits for it at a barrier."""
    from cutrace_tpu_torch.diff import checkpoint as ckpt

    state = opt.state_dict()
    if mesh is not None:
        def whole(x):
            return sh.unshard_rows(x, mesh, n_tris)

        params = {k: whole(v.detach()) if k in sh._TRI_FIELDS else v
                  for k, v in params.items()}
        state = _map_tri_state(state, trainable, whole)
    if mesh is None or (mesh.tile, mesh.prim) == (0, 0):
        ckpt.save_checkpoint(path, params, state, step)
    if mesh is not None:
        sh.barrier(mesh)


def fit(
    soa: SceneArrays,
    target,
    steps: int = 100,
    lr: float = 5e-2,
    bounces: int = 2,
    param_filter: Optional[Tuple[str, ...]] = None,
    verbose: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 50,
    accel="auto",
    camera: str = "raw",
    device="cuda",
    mesh=None,
    program: bool = True,
):
    """Optimize scene parameters to match a target image. Returns (params,
    losses). With `checkpoint_dir`, parameters, optimizer state and step
    are saved every `checkpoint_every` steps and at the last step, and
    training resumes from the newest checkpoint there.

    `accel`: "none" (the composable pipeline under autograd), "fused"
    (the fused forward with the replay backward), "auto" ("fused" on the
    card, "none" on the CPU), or a prebuilt ops.bvh.Accel. `camera`: "raw"
    or "look_at" (diff.camera), as in diff.grad.extract_params. `device`:
    the card unless the caller passes "cpu"; the scene moves there.

    `mesh` (parallel.sharding.make_mesh) trains over its ranks, on its
    device: pixels split over the tiles, the triangle buffer over the
    prims (a partition built per shard), the gradients summed in rank
    order over the tiles group (make_train_step). Every rank calls fit
    with the same arguments and gets the same losses and the whole
    parameters (the triangle shards gathered, the padding dropped); a
    checkpoint holds the whole parameters, written by the lowest rank,
    and every rank resumes from it.

    `program`: train through make_train_step's step program where
    step_is_captured (the card, without a mesh or over an NCCL mesh): the
    first step eager, the second captured and replayed, the
    rest replays, one update each; False runs every step op by op. On a
    CUDA device Adam is built with capturable=True either way (its step
    count on the device), so both run the same arithmetic. A restore
    happens before the first step; a checkpoint between steps reads the
    live tensors. The program is dropped before fit returns."""
    from cutrace_tpu_torch.diff import checkpoint as ckpt
    from cutrace_tpu_torch.render.renderer import prepare

    dev = resolve_device(device) if mesh is None else mesh.device
    if soa.device != dev:
        soa = soa_to(soa, dev)
    sharded = mesh is not None and mesh.n_prims > 1
    if isinstance(accel, str):
        if accel == "auto":
            accel = "fused" if dev.type == "cuda" else "none"
        if accel == "none":
            accel = None
        elif not sharded:
            accel = prepare(soa, accel=accel, bounces=bounces).accel
    if sharded and accel is not None:
        kind = accel if isinstance(accel, str) else accel.kind
        accel = sh.shard_accel(soa, mesh, kind)
    n_tris = soa.tri_p1.shape[0]
    if mesh is not None:
        soa = sh.shard_scene(soa, mesh)
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=dev).reshape(-1, 3)
    params = {k: v.detach().clone()
              for k, v in extract_params(soa, camera=camera).items()}
    trainable = [k for k in params
                 if param_filter is None or k in param_filter]
    for k in trainable:
        params[k].requires_grad_()
    opt = torch.optim.Adam([params[k] for k in trainable], lr=lr, eps=1e-8,
                           capturable=dev.type == "cuda")
    start = 0
    if checkpoint_dir is not None:
        restored = ckpt.restore_checkpoint(checkpoint_dir, params)
        if restored is not None:
            saved, opt_state, last = restored
            if mesh is not None:
                saved = {k: sh.shard_padded(v.to(dev), mesh,
                                            sh._PAD_ROWS[k])
                         if k in sh._TRI_FIELDS else v
                         for k, v in saved.items()}
                opt_state = _map_tri_state(
                    opt_state, trainable,
                    lambda x: sh.shard_padded(x, mesh, 0.0))
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(saved[k])
            opt.load_state_dict(opt_state)
            start = last + 1
            if verbose:
                print(f"resumed from step {last}")
    step = make_train_step(opt, bounces, param_filter=param_filter,
                           accel=accel, mesh=mesh, program=program)
    # losses stay device scalars during the loop: a per-step readback
    # would wait for every step's kernels; they are fetched once at the end
    losses = []
    for i in range(start, steps):
        losses.append(step(params, soa, target))
        if verbose and i % 10 == 0:
            print(f"step {i}: loss {float(losses[-1]):.6f}")
        if checkpoint_dir is not None and (
                (i + 1) % checkpoint_every == 0 or i == steps - 1):
            _save_checkpoint(checkpoint_dir, params, opt, trainable, mesh,
                             n_tris, i)
    del step  # the step program and its graph's memory
    out = {k: v.detach() for k, v in params.items()}
    if mesh is not None:
        out = {k: sh.unshard_rows(v, mesh, n_tris) if k in sh._TRI_FIELDS
               else v for k, v in out.items()}
    return out, (torch.stack(losses).cpu().tolist() if losses else [])
