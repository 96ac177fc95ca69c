"""Phong shading, the shadow march and the bounce tree (counterpart of
cutrace_tpu.render.shading).

The reference's per-pixel recursion becomes a wavefront over tree LEVELS:
one batched cast and shade per level over all of that level's nodes, with
path weights carrying the reference's exact blend coefficients (see
`ray_color`). Branches that the scene's materials can never spawn are
pruned. The unbounded shadow march becomes `soa.shadow_steps` masked
steps, which is exact for scenes whose transparency the step count covers.
"""

from __future__ import annotations

import math

import torch

from cutrace_tpu_torch.ops import intersect as I

_EPS = 1e-6  # material activity threshold
_UNIT_Z: dict = {}  # device -> (3,) float32 [0, 0, 1]


def _unit_z(device):
    """The +z unit vector on `device`, made once per device (the normal
    that stands in for a miss's)."""
    z = _UNIT_Z.get(device)
    if z is None:
        z = _UNIT_Z[device] = torch.tensor([0.0, 0.0, 1.0],
                                           dtype=torch.float32, device=device)
    return z


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _normalize(a):
    return a / _norm(a)[..., None]


def _reflect(incoming, normal):
    return incoming - 2.0 * _dot(normal, incoming)[..., None] * normal


def shadow_intensity(soa, o, d, max_dist, tri_candidates=None):
    """Masked shadow march: accumulate (1 - transparency) per occluder from
    min_dist = last_hit + 1e-3 until opacity >= 1 or the march passes the
    light. Returns (R,) intensity in [0, 1]."""
    r = o.shape[0]
    intensity = torch.zeros(r, dtype=torch.float32, device=o.device)
    last_hit = torch.zeros_like(intensity)
    active = torch.ones(r, dtype=torch.bool, device=o.device)
    for _ in range(soa.shadow_steps):
        hit = I.ray_cast(soa, o, d, last_hit + 1e-3, tri_candidates,
                         need_attrs=False)
        ok = active & hit.hit & (hit.t < max_dist)
        transp = soa.mat_transparency[hit.mat]
        intensity = intensity + torch.where(ok, 1.0 - transp, 0.0)
        last_hit = torch.where(ok, hit.t, last_hit)
        active = ok & (intensity < 1.0)
    return torch.where(intensity >= 1.0, 1.0, intensity)


def light_direction_to(soa, i, point):
    """Direction and distance from `point` to light slot i: a sun gives its
    negated direction at infinite distance, a point light the normalized
    direction and the Euclidean distance."""
    vec = soa.light_vec[i]
    is_sun = soa.light_kind[i] == 0
    diff = vec[None, :] - point
    dist = _norm(diff)
    direction = torch.where(is_sun, -vec[None, :], diff / dist[:, None])
    distance = torch.where(is_sun, math.inf, dist)
    return direction, distance


def phong(soa, d, hit: I.HitRecord, tri_candidates=None):
    """Phong shading with shadows for a batch of hits:

        final = ambient·diffuse
              + Σ_lights (1-shadow)·(max(0,n·l)·diffuse·c + max(0,n·h)^p·spec·c)

    with specular = mat.specular · mat.color and h the half vector. max is
    CUDA's fmaxf: NaN gives 0. Returns (R,3), meaningful only where
    hit.hit (the caller masks)."""
    diffuse = soa.mat_color[hit.mat]
    spec_f = soa.mat_specular[hit.mat]
    phong_e = soa.mat_phong[hit.mat]
    specular = spec_f[:, None] * diffuse

    nrm = torch.where(hit.hit[:, None], hit.normal, _unit_z(d.device))
    nn = _normalize(nrm)
    minus_dn = -_normalize(d)

    final = soa.ambient * diffuse
    if soa.n_lights == 0:
        return final

    # all lights' shadow rays march in one batched cast per step
    r = hit.point.shape[0]
    sdirs, light_dists = [], []
    for i in range(soa.n_lights):
        direction, distance = light_direction_to(soa, i, hit.point)
        sdirs.append(_normalize(direction))
        light_dists.append(distance * _norm(direction))
    shadow_all = shadow_intensity(
        soa,
        hit.point.repeat(soa.n_lights, 1),
        torch.cat(sdirs, dim=0),
        torch.cat(light_dists, dim=0),
        tri_candidates,
    ).reshape(soa.n_lights, r)

    for i in range(soa.n_lights):
        sdir = sdirs[i]
        color = soa.light_color[i][None, :]
        shadow = shadow_all[i]
        lit = shadow < 1.0
        fdd = _dot(nn, sdir)
        fd = torch.where(fdd > 0.0, fdd, 0.0)
        hvec = _normalize(minus_dn + sdir)
        bdd = _dot(nn, hvec)
        base = torch.where(bdd > 0.0, bdd, 0.0)
        backfacing = base <= 0.0
        fs = torch.where(
            backfacing, 0.0, torch.where(backfacing, 1.0, base) ** phong_e
        )
        contrib = fd[:, None] * (diffuse * color) + fs[:, None] * (specular * color)
        final = final + torch.where(
            lit[:, None], (1.0 - shadow)[:, None] * contrib, 0.0
        )
    return final


def ray_color(soa, o, d, min_t, bounces: int, tri_candidates=None):
    """Bounce color, evaluated one tree LEVEL at a time. Returns (R,3).

    The reference recursion

        rgb = phong
        if reflecting:  rgb += r * C(reflected)
        if transparent: rgb  = (1-f) * rgb + f * C(straight)

    is affine in both children, so

        color = Σ_nodes  w(node) · (1-f(node)) · phong(node)
        w(root) = 1;  w(refl-child) = w·(1-f)·r;  w(straight-child) = w·f

    (a leaf contributes w·phong). All nodes of one depth share one cast
    over an (n_nodes·R) ray batch."""
    return _ray_color(soa, o, d, min_t, bounces, tri_candidates)[0]


def _ray_color(soa, o, d, min_t, bounces: int, tri_candidates=None):
    """ray_color and the level-0 HitRecord: the cast of (o, d) at min_t
    with need_uv=False, which is the primary cast of render_rays."""
    r = o.shape[0]
    min_t = I.min_dist_rows(min_t, r, o.device)

    color = torch.zeros((r, 3), dtype=torch.float32, device=o.device)
    os_, ds_ = o, d
    ws = torch.ones(r, dtype=torch.float32, device=o.device)
    primary = None

    for level in range(bounces + 1):
        n_nodes = os_.shape[0] // r
        mt = min_t.repeat(n_nodes)
        hit = I.ray_cast(soa, os_, ds_, mt, tri_candidates, need_uv=False)
        if primary is None:
            primary = hit
        ph = torch.where(
            hit.hit[:, None], phong(soa, ds_, hit, tri_candidates), 0.0
        )

        last = level == bounces or not (soa.any_reflective or soa.any_transparent)
        if last:
            contrib = ws[:, None] * ph
            color = color + contrib.reshape(n_nodes, r, 3).sum(dim=0)
            break

        tr = soa.mat_transparency[hit.mat]
        if soa.any_transparent:
            f = torch.where(hit.hit & (tr >= _EPS), tr, 0.0)
        else:
            f = torch.zeros_like(ws)
        contrib = (ws * (1.0 - f))[:, None] * ph
        color = color + contrib.reshape(n_nodes, r, 3).sum(dim=0)

        t_safe = torch.where(hit.hit, hit.t, 1.0)
        child_o = os_ + t_safe[:, None] * ds_
        next_o, next_d, next_w = [], [], []
        if soa.any_reflective:
            nrm = torch.where(hit.hit[:, None], hit.normal,
                              _unit_z(o.device))
            refl_d = _reflect(_normalize(ds_), _normalize(nrm))
            refl = soa.mat_reflect[hit.mat]
            rr = torch.where(hit.hit & (refl >= _EPS), refl, 0.0)
            next_o.append(child_o)
            next_d.append(refl_d)
            next_w.append(ws * (1.0 - f) * rr)
        if soa.any_transparent:
            next_o.append(child_o)
            next_d.append(ds_)
            next_w.append(ws * f)
        os_ = torch.cat(next_o, dim=0)
        ds_ = torch.cat(next_d, dim=0)
        ws = torch.cat(next_w, dim=0)

    return color, primary


def ray_color_recursive(soa, o, d, min_t, bounces: int, tri_candidates=None):
    """The reference recursion written out, one ray_cast per tree NODE
    (counterpart of cutrace_tpu.render.shading.ray_color_recursive): the
    cross-check of ray_color's wavefront, which is the production path
    (a 2^bounces times shorter op sequence)."""
    hit = I.ray_cast(soa, o, d, min_t, tri_candidates, need_uv=False)
    rgb = torch.where(hit.hit[:, None], phong(soa, d, hit, tri_candidates),
                      0.0)

    if bounces > 0 and (soa.any_reflective or soa.any_transparent):
        t_safe = torch.where(hit.hit, hit.t, 1.0)
        child_o = o + t_safe[:, None] * d

        if soa.any_reflective:
            nrm = torch.where(hit.hit[:, None], hit.normal,
                              _unit_z(o.device))
            refl_d = _reflect(_normalize(d), _normalize(nrm))
            child = ray_color_recursive(soa, child_o, refl_d, min_t,
                                        bounces - 1, tri_candidates)
            refl = soa.mat_reflect[hit.mat]
            mask = hit.hit & (refl >= _EPS)
            rgb = rgb + torch.where(mask, refl, 0.0)[:, None] * child

        if soa.any_transparent:
            child = ray_color_recursive(soa, child_o, d, min_t, bounces - 1,
                                        tri_candidates)
            tr = soa.mat_transparency[hit.mat]
            f = torch.where(hit.hit & (tr >= _EPS), tr, 0.0)[:, None]
            rgb = (1.0 - f) * rgb + f * child

    return rgb
