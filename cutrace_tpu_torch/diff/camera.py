"""Look-at camera parameterization for optimization (counterpart of
cutrace_tpu.diff.camera).

The scene schema authors the camera as raw basis vectors (eye, forward,
right, up), and those raw fields are the parity-preserving differentiable
parameters of diff.grad. Optimizing them independently denormalizes and
skews the basis, so camera recovery drifts into sheared projections. This
module gives the optimization-friendly view: the camera as (eye, target,
up hint, per-axis scales), with the orthonormal basis rebuilt from them
on every call:

    fwd   = normalize(target - eye)         * scale_f
    right = normalize(cross(fwd, up_hint))  * scale_r
    up    = cross(unit right, unit fwd)     * scale_u

It round-trips exactly for orthogonal authored bases of either handedness.
"""

from __future__ import annotations

import dataclasses

import torch


def _norm(v):
    return v / torch.sqrt(torch.sum(v * v))


def look_at_basis(eye, target, up_hint, scales):
    """(forward, right, up) raw basis vectors from look-at parameters.

    scales: (3,) [|forward|, ±|right|, |up|], the authored basis
    magnitudes. scales[1] carries the authored handedness as its sign:
    +|right| for the reference convention right = +cross(forward, up),
    -|right| for a left-handed authored basis (camera_to_look_at detects
    it). The rebuilt up is cross(unit right, fwd) with the UNSIGNED right,
    which reproduces the authored up in both cases."""
    fwd = _norm(target - eye)
    right = _norm(torch.linalg.cross(fwd, _norm(up_hint)))
    up = torch.linalg.cross(right, fwd)  # unit: right ⊥ fwd, both unit
    return fwd * scales[0], right * scales[1], up * scales[2]


def camera_to_look_at(soa):
    """Look-at parameters reproducing this scene's camera (dict with keys
    cam_eye, cam_target, cam_up_hint, cam_scales); the sign of
    dot(cross(forward, up), right) is carried in cam_scales[1]."""
    f, r, u = soa.cam_forward, soa.cam_right, soa.cam_up
    hand = torch.where(torch.sum(torch.linalg.cross(f, u) * r) < 0, -1.0, 1.0)
    scales = torch.stack([
        torch.sqrt(torch.sum(f * f)),
        hand * torch.sqrt(torch.sum(r * r)),
        torch.sqrt(torch.sum(u * u)),
    ])
    return {
        "cam_eye": soa.cam_eye,
        # unit-distance target: the parameterization is scale-free in
        # |target - eye|, so take the best-conditioned representative
        "cam_target": soa.cam_eye + f / scales[0],
        "cam_up_hint": u / scales[2],
        "cam_scales": scales,
    }


def apply_look_at(soa, cam_params):
    """The scene with its raw camera basis rebuilt from look-at parameters
    (differentiable)."""
    fwd, right, up = look_at_basis(
        cam_params["cam_eye"], cam_params["cam_target"],
        cam_params["cam_up_hint"], cam_params["cam_scales"])
    return dataclasses.replace(soa, cam_eye=cam_params["cam_eye"],
                               cam_forward=fwd, cam_right=right, cam_up=up)
