"""Gradients of the renderer with respect to scene parameters (counterpart
of cutrace_tpu.diff.grad).

The discrete decisions of the pipeline (which primitive is hit, shadow
occluder sets, bounce spawn masks) carry no gradient: gradients flow
through the surface math at fixed topology (intersection t, normals,
shading), not through visibility changes. torch autograd takes the place
of jax.value_and_grad.

`extract_params` / `with_params` split a SceneArrays into its continuous,
differentiable leaves and everything else, so gradients can be taken with
respect to a plain dict of tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from cutrace_tpu_torch.render.renderer import camera_rays, render_rays
from cutrace_tpu_torch.scene.soa import SceneArrays
from cutrace_tpu_torch.utils import tracing

# Continuous scene parameters. Integer index buffers, validity masks and
# static metadata stay fixed (changing them is a topology change).
DIFFERENTIABLE_FIELDS = (
    "tri_p1",
    "tri_p2",
    "tri_p3",
    "pl_point",
    "pl_normal",
    "sp_center",
    "sp_radius",
    "mat_color",
    "mat_specular",
    "mat_reflect",
    "mat_phong",
    "mat_transparency",
    "light_vec",
    "light_color",
    "cam_eye",
    "cam_forward",
    "cam_right",
    "cam_up",
    "ambient",
)

_LOOK_AT_KEYS = ("cam_eye", "cam_target", "cam_up_hint", "cam_scales")


def extract_params(soa: SceneArrays,
                   camera: str = "raw") -> Dict[str, torch.Tensor]:
    """The differentiable leaves of a scene, as a flat dict.

    camera="raw" keeps the authored basis vectors as independent
    parameters; camera="look_at" replaces cam_forward/right/up with the
    orthonormal-by-construction look-at parameters (diff.camera), for
    optimizing the camera itself."""
    params = {f: getattr(soa, f) for f in DIFFERENTIABLE_FIELDS}
    if camera == "look_at":
        from cutrace_tpu_torch.diff.camera import camera_to_look_at

        for f in ("cam_forward", "cam_right", "cam_up"):
            del params[f]
        params.update(camera_to_look_at(soa))
    elif camera != "raw":
        raise ValueError(f"camera must be 'raw' or 'look_at': {camera!r}")
    return params


def with_params(soa: SceneArrays,
                params: Dict[str, torch.Tensor]) -> SceneArrays:
    """A scene with its differentiable leaves replaced. Accepts either
    camera parameterization (raw basis fields, or the look-at keys of
    extract_params(camera="look_at"), all of them or none)."""
    if any(k in params for k in _LOOK_AT_KEYS[1:]):
        from cutrace_tpu_torch.diff.camera import apply_look_at

        missing = [k for k in _LOOK_AT_KEYS if k not in params]
        if missing:
            raise ValueError(
                "look-at camera params are all-or-nothing: got "
                f"{sorted(k for k in _LOOK_AT_KEYS if k in params)}, "
                f"missing {missing} (use extract_params(camera='look_at'))")
        soa = apply_look_at(soa, {k: params[k] for k in _LOOK_AT_KEYS})
        params = {k: v for k, v in params.items() if k not in _LOOK_AT_KEYS}
    return dataclasses.replace(soa, **params)


def render_image_flat(soa: SceneArrays, bounces: int, fudge, accel=None):
    """Render all pixels in one batch, in scanline order: (color (N,3),
    depth (N,), normal (N,3)). With a "fused" `accel` (an ops.bvh.Accel)
    inside the kernels' scope it runs ops.fused.fused_render_rays, whose
    backward replays topology codes (the kernels on the card, their plain
    versions on the CPU). Otherwise it runs the composable pipeline with
    the partition's triangle query (ops.bvh.candidates_fn: the culling
    cast for "pallas" and for "fused" past the kernels' 63 nodes, the dense
    cast for "clusters", brute force without `accel`), differentiated by
    autograd."""
    from cutrace_tpu_torch.ops import bvh, fused

    n = soa.width * soa.height
    idx = torch.arange(n, device=soa.device)
    o, d = camera_rays(soa, idx % soa.width, idx // soa.width)
    tracing.mark("rays")
    if fused.fused_supported(soa, accel, bounces):
        # marks its own phases, the forward kernel's last
        return fused.fused_render_rays(soa, accel, o, d, fudge, bounces)
    out = render_rays(soa, o, d, bounces, fudge, bvh.candidates_fn(accel))
    tracing.mark("forward")
    return out


def render_loss(params: Dict[str, torch.Tensor], soa: SceneArrays, target,
                bounces: int = 2, fudge: float = 1e-3,
                accel=None) -> torch.Tensor:
    """Mean squared error between the rendered color image and `target`
    ((H*W, 3) or (H, W, 3))."""
    color, _, _ = render_image_flat(with_params(soa, params), bounces,
                                    fudge, accel)
    loss = torch.mean((color - target.reshape(-1, 3)) ** 2)
    tracing.mark("loss")
    return loss


def grad_render_loss(soa, target, bounces: int = 2, fudge: float = 1e-3,
                     accel=None):
    """(loss, grads dict) with respect to all differentiable scene
    parameters; groups that receive no gradient get zeros."""
    params = {k: v.detach().clone().requires_grad_()
              for k, v in extract_params(soa).items()}
    loss = render_loss(params, soa, target, bounces, fudge, accel)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(params.items(), grads)}
