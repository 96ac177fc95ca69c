"""Topology-replay rendering: the cast-free differentiable backward
(counterpart of cutrace_tpu.ops.replay).

Fixed-topology gradients never differentiate WHICH primitive a ray hits,
only the continuous surface math at the winners, and the fused forward
already finds every winner. With `emit_topo` the fused forward returns, per
ray, topology codes:
  * one winner code per bounce-tree node: the hit primitive as an int
    (original flat triangle index; T + plane index; T + P + sphere index;
    -1 = miss; T, P, S are the padded leaf lengths), and
  * per (node, light): an occlusion flag (opaque scenes) or one occluder
    code per shadow-march step (transparent scenes),
and `replay_render_rays` recomputes color, depth and normal from them as a
composition of gathers and elementwise shading math: no ray casts.
Differentiating it with torch autograd gives the fixed-topology gradients
of the composable pipeline, and is the plain version of the replay
backward kernel (ops.replay_vjp, csrc/replay_vjp.cu).

Semantics mirror the fused kernel (which mirrors the reference's
shading.hpp:22-154): unflipped pre-normalized triangle normals, raw
authored plane normals, sphere t parametric in the NORMALIZED direction,
fmaxf NaN->0 phong terms, straight-through transparency, reflection-then-
transparency depth-first order. Every guard of the JAX replay is kept, so
autograd stays NaN-free on misses and degenerate rows.
"""

from __future__ import annotations

import torch

from cutrace_tpu_torch.render.shading import _unit_z

_EPS = 1e-6  # material activity threshold (default_schema.hpp:334-335)


def topo_layout(bounces, any_refl, any_transp, n_lights, shadow_steps):
    """Static topo-row assignment for the depth-first bounce tree.

    Enumerates nodes in the fused kernel's order (reflection child first,
    then transparency). Returns (rows_total, nodes): nodes[k] = (level,
    cast_row, shadow_base), where the node's cast winner code lives at row
    cast_row and its per-light shadow topology at rows [shadow_base +
    li * per_light, ...) with per_light = 1 flag row (opaque) or
    shadow_steps code rows."""
    per_light = 1 if not any_transp else shadow_steps
    state = [0]
    nodes = []

    def rec(level):
        cast_row = state[0]
        state[0] += 1
        shadow_base = state[0]
        state[0] += n_lights * per_light
        nodes.append((level, cast_row, shadow_base))
        if level == bounces or not (any_refl or any_transp):
            return
        if any_refl:
            rec(level + 1)
        if any_transp:
            rec(level + 1)

    rec(0)
    return state[0], nodes


def replay_rows(soa, bounces: int) -> int:
    """Topo rows the fused kernel emits for this scene config."""
    return topo_layout(bounces, soa.any_reflective, soa.any_transparent,
                       soa.n_lights, soa.shadow_steps)[0]


# Replay scope: at most this many topo rows, and a code buffer (rows x rays
# x 4 B) of at most REPLAY_MAX_CODE_BYTES. sphere_plane 1080p b5 needs 441
# rows x 2.07M rays = 3.66 GB, inside the budget.
REPLAY_MAX_ROWS = 512
REPLAY_MAX_CODE_BYTES = 4 * 1024 * 1024 * 1024


def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(a):
    return a / torch.sqrt(_dot(a, a))[..., None]


# packed-row column layout (see _packed_table)
_PK_A = slice(0, 3)     # tri p1 | plane point | sphere center
_PK_B = slice(3, 6)     # tri p2 | plane normal | (radius, 0, 0)
_PK_C = slice(6, 9)     # tri p3 | 0 | 0
_PK_COL = slice(10, 13)  # material diffuse color
_PK_SPEC = 13
_PK_REFL = 14
_PK_PHONG = 15
_PK_TRANSP = 16
_PK_W = 17


class _MaterialRows(torch.autograd.Function):
    """The rows of the (M, 7) material columns that (N,) material indices
    pick, whose backward sums the rows of each material in a fixed order:
    the cotangents masked by a one-hot of the indices, (N, M, 7), summed
    over N by one torch reduction, which keeps its order from run to run.
    index_select's own backward, index_add_, adds with atomics on the card
    (every triangle of a mesh shares one material), so its sums, and every
    gradient downstream, changed bits from run to run; advanced indexing's
    sorts the (N,) indices and walks each run of duplicates in one warp."""

    @staticmethod
    def forward(ctx, mats, idx):
        ctx.save_for_backward(idx)
        ctx.n_mats = mats.shape[0]
        return torch.index_select(mats, 0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        mats = torch.arange(ctx.n_mats, device=idx.device)
        one_hot = (idx[:, None] == mats)[:, :, None]
        return torch.where(one_hot, g[:, None, :], 0.0).sum(0), None


def _packed_table(soa):
    """(T+P+S, 17) packed per-primitive rows: geometry plus the winner's
    material parameters, so the replay needs one row gather per (node,
    ray). Built from the live leaves, so it is differentiable (gradients
    flow through the concatenation back to every geometry and material
    leaf) and never stale. The material columns' gradients are summed in
    a fixed order (_MaterialRows)."""
    def matcols(mat_idx):
        mats = torch.cat([
            soa.mat_color,
            soa.mat_specular[:, None],
            soa.mat_reflect[:, None],
            soa.mat_phong[:, None],
            soa.mat_transparency[:, None],
        ], dim=1)
        return _MaterialRows.apply(mats, mat_idx.to(torch.int64))  # (N, 7)

    t = soa.tri_p1.shape[0]
    p = soa.pl_point.shape[0]
    s = soa.sp_center.shape[0]
    f32 = dict(dtype=torch.float32, device=soa.tri_p1.device)
    tri = torch.cat(
        [soa.tri_p1, soa.tri_p2, soa.tri_p3,
         torch.zeros((t, 1), **f32), matcols(soa.tri_mat)], dim=1)
    pl = torch.cat(
        [soa.pl_point, soa.pl_normal, torch.zeros((p, 4), **f32),
         matcols(soa.pl_mat)], dim=1)
    sp = torch.cat(
        [soa.sp_center, soa.sp_radius[:, None], torch.zeros((s, 6), **f32),
         matcols(soa.sp_mat)], dim=1)
    return torch.cat([tri, pl, sp], dim=0)


def hit_from_code(soa, o, d, code, mind, o0, table=None):
    """Differentiable hit re-derivation at a FIXED winner primitive.

    o, d: (R,3); code: (R,) int (see module docstring); mind: (R,) f32
    strict lower t bound (sphere root choice only; all other validity is
    topology and is not re-checked). Returns (hit, t, normal, is_sphere,
    mrow): t = +inf on a miss, normal raw per kind (triangles
    pre-normalized, planes as authored, spheres normalized), mrow = the
    winner's packed row ((R, 17), material parameters at the _PK_*
    columns), everything NaN-free on misses. `table` is the _packed_table
    (built here if absent; pass it in loops)."""
    t_cnt = soa.tri_p1.shape[0]
    p_cnt = soa.pl_point.shape[0]
    s_cnt = soa.sp_center.shape[0]
    if table is None:
        table = _packed_table(soa)
    code = code.to(torch.int64)
    hit = code >= 0
    is_tri = hit & (code < t_cnt)
    is_pl = hit & (code >= t_cnt) & (code < t_cnt + p_cnt)
    is_sp = hit & (code >= t_cnt + p_cnt)

    oc = o - o0
    row = table[code.clamp(0, t_cnt + p_cnt + s_cnt - 1)]  # one gather
    a_ = row[:, _PK_A] - o0
    bv = row[:, _PK_B]
    cv = row[:, _PK_C]

    # triangles (default_schema.hpp:57-78), on the single gathered winner
    p1, p3 = a_, cv - o0
    p2 = bv - o0
    a = p2 - p1
    b = p2 - p3
    n = torch.linalg.cross(a, b)
    alpha = _dot(d, n)
    inv = 1.0 / torch.where(alpha == 0.0, 1.0, alpha)
    t_tri = (_dot(p2, n) - _dot(oc, n)) * inv
    # unflipped, pre-normalized shading normal (default_schema.hpp:72).
    # The zero-length guard sits INSIDE the sqrt: every ray evaluates every
    # kind-branch on the same gathered row, and a plane or sphere row read
    # as a degenerate triangle would otherwise send sqrt(0)'s NaN
    # cotangent through the masked-off branch (where() kills primals, not
    # a branch's own NaN gradients).
    ncr = -torch.linalg.cross(p2 - p3, p1 - p3)
    nl2 = _dot(ncr, ncr)
    nl = torch.sqrt(torch.where(nl2 == 0.0, 1.0, nl2))
    n_tri = ncr / torch.where(nl2 == 0.0, 1.0, nl)[:, None]

    # planes (default_schema.hpp:189-201): A = point, B = raw normal
    pn = bv
    kp = _dot(a_, pn)
    denom = _dot(d, pn)
    t_pl = (kp - _dot(oc, pn)) / torch.where(denom == 0.0, 1.0, denom)

    # spheres (default_schema.hpp:226-251): t parametric in the NORMALIZED
    # direction; root choice per the reference's validity rule (both-roots
    # min, else whichever clears mind). A = center, B[0] = radius.
    dn = _normalize(d)
    c = a_
    r2 = row[:, 3] ** 2
    dec = _dot(dn, c) - _dot(dn, oc)
    ec2 = _dot(oc, oc) - 2.0 * _dot(oc, c) + _dot(c, c)
    sub = dec * dec - (ec2 - r2)
    missed = sub <= 0.0
    sq = torch.sqrt(torch.where(missed, 1.0, sub))
    t0 = dec - sq
    t1 = dec + sq
    v0 = ~missed & torch.isfinite(t0) & (t0 > mind)
    v1 = ~missed & torch.isfinite(t1) & (t1 > mind)
    t_sp = torch.where(
        v0 & v1, torch.minimum(t0, t1),
        torch.where(v0, t0, torch.where(v1, t1, 1.0)),
    )
    pt_sp = oc + t_sp[:, None] * dn
    nsp = pt_sp - c
    nil2 = _dot(nsp, nsp)
    nil = torch.sqrt(torch.where(nil2 == 0.0, 1.0, nil2))
    n_sp = nsp / torch.where(nil2 == 0.0, 1.0, nil)[:, None]

    t = torch.where(is_tri, t_tri,
                    torch.where(is_pl, t_pl,
                                torch.where(is_sp, t_sp, 1.0)))
    t = torch.where(hit, t, torch.inf)
    normal = torch.where(
        is_tri[:, None], n_tri,
        torch.where(is_pl[:, None], pn,
                    torch.where(is_sp[:, None], n_sp, 0.0)),
    )
    return hit, t, normal, is_sp, row


def _safe_len(v2):
    """sqrt(v2) with a FINITE derivative at v2 == 0: sqrt's derivative is
    0.5/sqrt(0) = inf, and inf * (even a zero cotangent) = NaN, so the
    guard sits INSIDE the sqrt and the outer where restores the value.
    Reachable: hv = md + sdir == 0 when a light's direction coincides with
    the ray; diff == 0 when a light sits on the shading point."""
    z = v2 == 0.0
    return torch.where(z, 0.0, torch.sqrt(torch.where(z, 1.0, v2)))


def _phong_lights(soa, hit, point, nn, nd, mrow, codes, shadow_base,
                  per_light, o0, table):
    """Per-light Phong accumulation with replayed shadow topology
    (shading.hpp:64-99 + 22-45). nn: unit shading normal (miss -> +z); nd:
    unit ray direction; mrow: the winner's packed row. Returns the full
    phong sum including ambient."""
    diffuse = mrow[:, _PK_COL]
    spec = mrow[:, _PK_SPEC][:, None] * diffuse
    phong_e = mrow[:, _PK_PHONG]
    final = soa.ambient * diffuse
    md = -nd

    for li in range(soa.n_lights):
        vec = soa.light_vec[li]
        is_sun = soa.light_kind[li] == 0
        diff = vec[None, :] - point
        dist = _safe_len(_dot(diff, diff))
        dsafe = torch.where(dist == 0.0, 1.0, dist)
        direction = torch.where(is_sun, -vec[None, :], diff / dsafe[:, None])
        distance = torch.where(is_sun, torch.inf, dist)
        dl = _safe_len(_dot(direction, direction))
        light_dist = distance * dl  # shading.hpp:80
        dls = torch.where(dl == 0.0, 1.0, dl)
        sdir = direction / dls[:, None]

        if per_light == 1:
            # opaque scene: stored any-hit occlusion flag; sh in {0, 1}
            # carries no gradient
            sh = codes[:, shadow_base + li].to(torch.float32)
            sh = torch.where(hit, sh, 0.0)
        else:
            # transparent scene: replay the march from per-step occluder
            # codes; sh is differentiable in the occluders' transparency
            sh = torch.zeros_like(light_dist)
            last = torch.zeros_like(light_dist)
            act = hit
            for si in range(per_light):
                ccode = codes[:, shadow_base + li * per_light + si]
                shit, st, _, _, srow = hit_from_code(
                    soa, point, sdir, ccode, last + 1e-3, o0, table)
                transp = srow[:, _PK_TRANSP]
                okm = act & shit & torch.isfinite(st) & (st < light_dist)
                sh = sh + torch.where(okm, 1.0 - transp, 0.0)
                last = torch.where(okm, st, last)
                act = okm & (sh < 1.0)
            sh = torch.where(sh >= 1.0, 1.0, sh)
        lit = sh < 1.0

        # max(0, x) with fmaxf NaN->0 semantics (shading.hpp:86-88)
        fdd = _dot(nn, sdir)
        fd = torch.where(fdd > 0.0, fdd, 0.0)
        hv = md + sdir
        hl = _safe_len(_dot(hv, hv))
        bdd = _dot(nn, hv) / torch.where(hl == 0.0, 1.0, hl)
        base = torch.where(bdd > 0.0, bdd, 0.0)
        backf = base <= 0.0
        fs = torch.where(backf, 0.0,
                         torch.where(backf, 1.0, base) ** phong_e)
        wgt = torch.where(lit, 1.0 - sh, 0.0)
        contrib = fd[:, None] * diffuse + fs[:, None] * spec
        final = final + wgt[:, None] * contrib * soa.light_color[li][None, :]
    return final


def replay_render_rays(soa, o, d, codes, fudge, bounces: int, table=None):
    """Render (color (R,3), depth (R,), normal (R,3)) from topology codes,
    with zero casts.

    codes: (R, K) int as laid out by topo_layout and emitted by the fused
    forward. Mirrors the fused kernel's depth-first tree walk; value parity
    with the kernel is exact up to float association, and torch autograd of
    this function IS the fixed-topology backward. `table` overrides the
    packed table built from `soa` (same layout, world coordinates)."""
    o0 = soa.scene_center.detach()
    r = o.shape[0]
    per_light = 1 if not soa.any_transparent else soa.shadow_steps
    _, nodes = topo_layout(bounces, soa.any_reflective,
                           soa.any_transparent, soa.n_lights,
                           soa.shadow_steps)
    it = iter(nodes)
    if table is None:
        table = _packed_table(soa)

    color = [torch.zeros((r, 3), dtype=torch.float32, device=o.device)]
    depth_normal = [None, None]
    fudge_v = torch.full((r,), float(fudge), dtype=torch.float32,
                         device=o.device)
    unit_z = _unit_z(o.device)

    def do_node(level, o3, d3, w, mind, root):
        _, cast_row, shadow_base = next(it)
        hit, t, rnorm, is_sp, mrow = hit_from_code(
            soa, o3, d3, codes[:, cast_row], mind, o0, table)
        t_safe = torch.where(hit, t, 1.0)
        nd = _normalize(d3)
        # sphere hit points use the normalized direction
        # (default_schema.hpp:245); the others the raw one
        point = o3 + t_safe[:, None] * torch.where(is_sp[:, None], nd, d3)
        if root:
            depth_normal[0] = t  # +inf on a miss
            depth_normal[1] = torch.where(hit[:, None], rnorm, 0.0)
        nrm = torch.where(hit[:, None], rnorm, unit_z[None, :])
        # |nrm| == 0 guard: a code that names the zero-area padded
        # triangle must not send NaN through an unguarded normalize
        nn_l2 = _dot(nrm, nrm)
        nn = nrm / torch.sqrt(torch.where(nn_l2 == 0.0, 1.0, nn_l2))[:, None]
        ph = _phong_lights(soa, hit, point, nn, nd, mrow, codes,
                           shadow_base, per_light, o0, table)
        ph = torch.where(hit[:, None], ph, 0.0)

        if level == bounces or not (soa.any_reflective
                                    or soa.any_transparent):
            color[0] = color[0] + w[:, None] * ph
            return
        if soa.any_transparent:
            tr = mrow[:, _PK_TRANSP]
            f = torch.where(hit & (tr >= _EPS), tr, 0.0)
        else:
            f = torch.zeros_like(w)
        weff = w * (1.0 - f)
        color[0] = color[0] + weff[:, None] * ph
        child_o = o3 + t_safe[:, None] * d3  # raw d (shading.hpp:131,144)
        if soa.any_reflective:
            refl = mrow[:, _PK_REFL]
            rr = torch.where(hit & (refl >= _EPS), refl, 0.0)
            rd = nd - 2.0 * _dot(nd, nn)[:, None] * nn
            do_node(level + 1, child_o, rd, weff * rr, fudge_v, False)
        if soa.any_transparent:
            do_node(level + 1, child_o, d3, w * f, fudge_v, False)

    do_node(0, o, d, torch.ones((r,), dtype=torch.float32, device=o.device),
            fudge_v, True)
    return color[0], depth_normal[0], depth_normal[1]

