"""The reference's frames, losses and fit steps, computed in blocks of
pixels so that any frame fits in memory."""

from __future__ import annotations

import torch

from portbench.reference.tracer import Counts, Tracer

BETAS = (0.9, 0.999)


def pixel_xy(tracer: Tracer, pixels):
    """(px, py) of flat scanline pixel indices."""
    return pixels % tracer.width, pixels // tracer.width


@torch.no_grad()
def render(tracer: Tracer, params, pixels, bounces: int, block: int,
           counts: Counts = None):
    """(color (R, 3), depth (R,), normal (R, 3)) of the flat pixel indices
    `pixels`, in the tracer's dtype, on its device."""
    outs = []
    for s in range(0, pixels.shape[0], block):
        px, py = pixel_xy(tracer, pixels[s:s + block])
        outs.append(tracer.trace(params, px, py, bounces, counts=counts))
    return tuple(torch.cat(x) for x in zip(*outs))


def loss_and_grads(tracer: Tracer, params, target, bounces: int,
                   block: int, groups, n: int = 0):
    """mean((color - target)^2) over the image's first `n` pixels (0: all
    of them; target: (H·W, 3) scanline order) and its gradient with
    respect to each of `groups`."""
    n = n or tracer.width * tracer.height
    leaves = {k: v.detach().clone().requires_grad_(k in groups)
              for k, v in params.items()}
    total = 0.0
    grads = {k: torch.zeros_like(leaves[k]) for k in groups}
    for s in range(0, n, block):
        pixels = torch.arange(s, min(n, s + block), device=tracer.device)
        px, py = pixel_xy(tracer, pixels)
        color, _, _ = tracer.trace(leaves, px, py, bounces)
        part = ((color - target[pixels].to(color.dtype)) ** 2).sum() \
            / (3 * n)
        got = torch.autograd.grad(part, [leaves[k] for k in groups],
                                  allow_unused=True)
        for k, g in zip(groups, got):
            if g is not None:
                grads[k] += g
        total += float(part.detach())
    return total, grads


def fit_steps(tracer: Tracer, params, target, bounces: int, block: int,
              groups, lr: float, steps: int, eps: float = 1e-8, n: int = 0):
    """`steps` Adam steps (torch's update: bias-corrected moments, eps
    outside the root) on `groups`, from `params`, the loss over the first
    `n` pixels (0: all). Returns (losses before each step, the first
    step's gradients, each group's change after the steps)."""
    b1, b2 = BETAS
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(p[k]) for k in groups}
    v = {k: torch.zeros_like(p[k]) for k in groups}
    losses, first = [], None
    for i in range(1, steps + 1):
        loss, g = loss_and_grads(tracer, p, target, bounces, block, groups,
                                 n)
        losses.append(loss)
        if first is None:
            first = g
        for k in groups:
            m[k] = b1 * m[k] + (1 - b1) * g[k]
            v[k] = b2 * v[k] + (1 - b2) * g[k] ** 2
            denom = (v[k] / (1 - b2 ** i)).sqrt() + eps
            p[k] = p[k] - lr / (1 - b1 ** i) * m[k] / denom
    change = {k: p[k] - params[k].detach() for k in groups}
    return losses, first, change
