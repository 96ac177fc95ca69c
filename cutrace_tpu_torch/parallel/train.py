"""The inverse-rendering training loop on one device (counterpart of
cutrace_tpu.parallel.train).

Scene parameters are optimized with torch.optim.Adam (eps 1e-8, the same
update as optax.adam) against an image loss. With a "fused" partition the
forward emits topology codes and the backward replays them: on the card
through the hand-written kernels, on the CPU through their plain
versions. Image-tile data parallelism over several devices is ROADMAP
item A.12.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from cutrace_tpu_torch.diff.grad import extract_params, render_loss
from cutrace_tpu_torch.scene.soa import SceneArrays, resolve_device, soa_to


def make_train_step(optimizer: torch.optim.Optimizer, bounces: int = 2,
                    fudge: float = 1e-3,
                    param_filter: Optional[Tuple[str, ...]] = None,
                    accel=None) -> Callable:
    """An Adam (or any optimizer) step over scene parameters.

    Returns step(params, soa, target) -> loss, a device scalar; `params`
    (the tensors `optimizer` holds) are updated in place. `param_filter`
    restricts which parameter groups are updated; the others keep their
    values, as zero gradients leave them under Adam. `accel` (an
    ops.bvh.Accel) routes the render through the fused kernels; the
    partition stays fixed across steps, which is correct for any vertex
    positions, merely less tight as geometry drifts."""

    def step(params, soa, target):
        optimizer.zero_grad(set_to_none=True)
        loss = render_loss(params, soa, target, bounces, fudge, accel)
        loss.backward()
        if param_filter is not None:
            for k, v in params.items():
                if k not in param_filter:
                    v.grad = None
        optimizer.step()
        return loss.detach()

    return step


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
):
    """Optimize scene parameters to match a target image. Returns (params,
    losses). With `checkpoint_dir`, parameters, optimizer state and step
    are saved every `checkpoint_every` steps and at the last step, and
    training resumes from the newest checkpoint there.

    `accel`: "none" (the composable pipeline under autograd), "fused"
    (the fused forward with the replay backward), "auto" ("fused" on the
    card, "none" on the CPU), or a prebuilt ops.bvh.Accel. `camera`: "raw"
    or "look_at" (diff.camera), as in diff.grad.extract_params. `device`:
    the card unless the caller passes "cpu"; the scene moves there."""
    from cutrace_tpu_torch.diff import checkpoint as ckpt
    from cutrace_tpu_torch.render.renderer import prepare

    dev = resolve_device(device)
    if soa.device != dev:
        soa = soa_to(soa, dev)
    if isinstance(accel, str):
        if accel == "auto":
            accel = "fused" if dev.type == "cuda" else "none"
        accel = (None if accel == "none"
                 else prepare(soa, accel=accel, bounces=bounces).accel)
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=dev).reshape(-1, 3)
    params = {k: v.detach().clone()
              for k, v in extract_params(soa, camera=camera).items()}
    trainable = [k for k in params
                 if param_filter is None or k in param_filter]
    for k in trainable:
        params[k].requires_grad_()
    opt = torch.optim.Adam([params[k] for k in trainable], lr=lr, eps=1e-8)
    start = 0
    if checkpoint_dir is not None:
        restored = ckpt.restore_checkpoint(checkpoint_dir, params)
        if restored is not None:
            saved, opt_state, last = restored
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(saved[k])
            opt.load_state_dict(opt_state)
            start = last + 1
            if verbose:
                print(f"resumed from step {last}")
    step = make_train_step(opt, bounces, param_filter=param_filter,
                           accel=accel)
    # losses stay device scalars during the loop: a per-step readback
    # would wait for every step's kernels; they are fetched once at the end
    losses = []
    for i in range(start, steps):
        losses.append(step(params, soa, target))
        if verbose and i % 10 == 0:
            print(f"step {i}: loss {float(losses[-1]):.6f}")
        if checkpoint_dir is not None and (
                (i + 1) % checkpoint_every == 0 or i == steps - 1):
            ckpt.save_checkpoint(checkpoint_dir, params, opt.state_dict(), i)
    out = {k: v.detach() for k, v in params.items()}
    return out, (torch.stack(losses).cpu().tolist() if losses else [])
