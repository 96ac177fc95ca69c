"""Vectorized nearest-hit ray cast (counterpart of cutrace_tpu.ops.intersect).

Each primitive kind is intersected for a whole ray batch at once. The
per-(ray, triangle) Cramer determinants are rewritten as ray-by-primitive
products (scalar-triple-product identities, a = p2-p1, b = p2-p3):

    det[a, b, d]       = d . n           with n  = (p2-p1) x (p2-p3)
    det[p2-o, b, d]    = d . (p2 x b) - (d x o) . b
    det[a, p2-o, d]    = (d x o) . a - d . (p2 x a)
    det[a, b, p2-o]    = p2 . n - o . n

so every term is an (R,3) @ (3,T) product plus elementwise work. All
positions are first shifted by the scene's recentering origin `o0`, which
keeps the near-cancelling terms small (the reference subtracts positions
before any product).

Selection parity: each kind picks its first minimal primitive by (t, key)
and kinds combine by (t, scene object index), which reproduces the
reference's scene-order scan. All math is float32; a TF32 matmul would
lose about three decimal digits of ray geometry, so casts refuse to run on
CUDA while `torch.backends.cuda.matmul.allow_tf32` is set.
"""

from __future__ import annotations

import dataclasses
import math

import torch

INF = math.inf
_BIG_I32 = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class HitRecord:
    """Per-ray nearest-hit data."""

    hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,) f32, +inf on miss
    obj: torch.Tensor  # (R,) i64 scene object index (n_objects on miss)
    mat: torch.Tensor  # (R,) i64 material index (0 on miss)
    # (R,) i64 winner primitive as a topology code (ops.replay): original
    # flat triangle index, T + plane index, T + P + sphere index (T, P the
    # padded leaf lengths), -1 on a miss
    prim: torch.Tensor
    point: torch.Tensor  # (R,3) f32
    normal: torch.Tensor  # (R,3) f32, zeros on miss
    uv: torch.Tensor  # (R,2) f32


def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(a):
    return a / torch.sqrt(_dot(a, a))[..., None]


def _mm(rays, prims):
    """(R,3) x (T,3) -> (R,T) float32 contraction."""
    if rays.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is set: TF32 products "
            "lose ray-geometry precision; set it to False"
        )
    return rays @ prims.T


def _first_min(t, order):
    """Index of the minimal t along the last axis; ties go to the smallest
    `order` value (then to the first occurrence)."""
    tmin = t.min(dim=-1, keepdim=True).values
    key = torch.where(t == tmin, order, _BIG_I32)
    return torch.argmin(key, dim=-1)


def _take(t, idx):
    return torch.gather(t, 1, idx[:, None])[:, 0]


def _o0(soa, o0):
    return soa.scene_center if o0 is None else o0


# --- triangles --------------------------------------------------------------


def cast_triangles(soa, o, d, min_dist, o0=None):
    """Nearest triangle hit per ray: (t (R,), idx (R,)) with t = +inf on a
    miss. `soa` needs tri_p1/p2/p3, tri_obj (tie-break key), tri_valid and
    scene_center."""
    o0 = _o0(soa, o0)
    o = o - o0
    p1, p2, p3 = soa.tri_p1 - o0, soa.tri_p2 - o0, soa.tri_p3 - o0
    a = p2 - p1
    b = p2 - p3
    n = torch.linalg.cross(a, b)
    u_beta = torch.linalg.cross(p2, b)
    u_gamma = torch.linalg.cross(p2, a)
    k = _dot(p2, n)

    w = torch.linalg.cross(d, o)
    alpha = _mm(d, n)
    beta_n = _mm(d, u_beta) - _mm(w, b)
    gamma_n = _mm(w, a) - _mm(d, u_gamma)
    t_n = k[None, :] - _mm(o, n)

    degenerate = alpha == 0.0
    inv = 1.0 / torch.where(degenerate, 1.0, alpha)
    beta = beta_n * inv
    gamma = gamma_n * inv
    t = t_n * inv

    valid = (
        ~degenerate
        & (beta >= 0.0)
        & (gamma >= 0.0)
        & (beta + gamma <= 1.0)
        & torch.isfinite(t)
        & (t > min_dist[:, None])
        & soa.tri_valid[None, :]
    )
    t = torch.where(valid, t, INF)
    idx = _first_min(t, soa.tri_obj[None, :].to(torch.int64))
    return _take(t, idx), idx


@dataclasses.dataclass(frozen=True)
class TriCandidate:
    """Per-ray best-triangle candidate carrying the winner's own geometry,
    so hit attributes need no further gather into the scene buffers."""

    t: torch.Tensor  # (R,) f32, +inf on miss
    obj: torch.Tensor  # (R,) scene object index
    order: torch.Tensor  # (R,) global flat triangle index (tie-break key)
    mat: torch.Tensor  # (R,)
    is_mesh: torch.Tensor  # (R,) bool
    p1: torch.Tensor  # (R,3) f32
    p2: torch.Tensor  # (R,3) f32
    p3: torch.Tensor  # (R,3) f32


def local_tri_candidates(soa, o, d, min_dist, o0=None):
    """Brute-force best triangle over the whole triangle buffer."""
    t, idx = cast_triangles(soa, o, d, min_dist, o0)
    return TriCandidate(
        t=t,
        obj=soa.tri_obj[idx].to(torch.int64),
        order=idx,
        mat=soa.tri_mat[idx].to(torch.int64),
        is_mesh=soa.tri_mesh[idx] >= 0,
        p1=soa.tri_p1[idx],
        p2=soa.tri_p2[idx],
        p3=soa.tri_p3[idx],
    )


def triangle_attrs_from_verts(p1, p2, p3, is_mesh, o, d, t, need_uv=True):
    """Hit attributes from explicit corners: normal = -(p2-p3) x (p1-p3),
    normalized and never flipped toward the ray (the reference's normal
    map); mesh triangles overwrite uv with (hit.x, hit.y)."""
    point = o + t[:, None] * d
    normal = _normalize(-torch.linalg.cross(p2 - p3, p1 - p3))
    if not need_uv:
        return point, normal, point[:, :2]
    p2p1 = p2 - p1
    p3p1 = p3 - p1
    xp1 = point - p1
    u = torch.abs(_dot(xp1, p2p1)) / _dot(p2p1, p2p1)
    v = torch.abs(_dot(xp1, p3p1)) / _dot(p3p1, p3p1)
    uv = torch.stack([u, v], dim=-1)
    uv = torch.where(is_mesh[:, None], point[:, :2], uv)
    return point, normal, uv


# --- planes -----------------------------------------------------------------


def cast_planes(soa, o, d, min_dist, o0=None):
    """Point+normal plane intersect, recentered about o0. Plane counts are
    tiny, so the (R,P) products are broadcast elementwise sums."""
    o0 = _o0(soa, o0)
    o = o - o0
    n = soa.pl_normal
    k = _dot(soa.pl_point - o0, n)
    denom = (d[:, None, :] * n[None, :, :]).sum(-1)
    parallel = denom == 0.0
    on = (o[:, None, :] * n[None, :, :]).sum(-1)
    t = (k[None, :] - on) / torch.where(parallel, 1.0, denom)
    valid = (
        ~parallel
        & torch.isfinite(t)
        & (t > min_dist[:, None])
        & soa.pl_valid[None, :]
    )
    t = torch.where(valid, t, INF)
    idx = _first_min(t, soa.pl_obj[None, :].to(torch.int64))
    return _take(t, idx), idx


def plane_hit_attrs(soa, o, d, t, idx, need_uv=True):
    """Plane hit attributes; the normal is the authored (unnormalized)
    plane normal; uv is NaN when the normal is parallel to z, as in the
    reference."""
    n = soa.pl_normal[idx]
    point_on = soa.pl_point[idx]
    point = o + t[:, None] * d
    if not need_uv:
        return point, n, point[:, :2]
    ax1 = torch.stack([n[:, 1], -n[:, 0], torch.zeros_like(n[:, 0])], dim=-1)
    n1 = torch.sqrt(_dot(ax1, ax1))
    degenerate = n1 == 0.0
    ax1 = torch.where(
        degenerate[:, None],
        math.nan,
        ax1 / torch.where(degenerate, 1.0, n1)[:, None],
    )
    ax2 = torch.linalg.cross(n, ax1)
    mod = point_on - point
    uv = torch.stack([_dot(ax1, mod), _dot(ax2, mod)], dim=-1)
    return point, n, uv


# --- spheres ----------------------------------------------------------------


def cast_spheres(soa, o, d, min_dist, o0=None):
    """Quadratic sphere intersect with both roots; t is parametric in the
    NORMALIZED direction (a reference quirk). An exact tangent (sub == 0)
    counts as a miss."""
    o0 = _o0(soa, o0)
    dn = _normalize(d)
    o = o - o0
    c = soa.sp_center - o0
    r2 = soa.sp_radius**2
    dnc = (dn[:, None, :] * c[None, :, :]).sum(-1)
    dec = dnc - _dot(dn, o)[:, None]
    oc = (o[:, None, :] * c[None, :, :]).sum(-1)
    ec2 = _dot(o, o)[:, None] - 2.0 * oc + _dot(c, c)[None, :]
    sub = dec * dec - (ec2 - r2[None, :])
    missed = sub <= 0.0
    sq = torch.sqrt(torch.where(missed, 1.0, sub))
    t0 = dec - sq
    t1 = dec + sq
    v0 = ~missed & torch.isfinite(t0) & (t0 > min_dist[:, None])
    v1 = ~missed & torch.isfinite(t1) & (t1 > min_dist[:, None])
    t = torch.where(
        v0 & v1, torch.minimum(t0, t1),
        torch.where(v0, t0, torch.where(v1, t1, INF)),
    )
    valid = (v0 | v1) & soa.sp_valid[None, :]
    t = torch.where(valid, t, INF)
    idx = _first_min(t, soa.sp_obj[None, :].to(torch.int64))
    return _take(t, idx), idx


def sphere_hit_attrs(soa, o, d, t, idx, need_uv=True):
    """Sphere hit attributes; spherical uv."""
    dn = _normalize(d)
    c = soa.sp_center[idx]
    point = o + t[:, None] * dn
    normal = _normalize(point - c)
    if not need_uv:
        return point, normal, point[:, :2]
    u = 0.5 + torch.atan2(normal[:, 2], normal[:, 0]) / (2.0 * math.pi)
    y = normal[:, 1]
    pole = torch.abs(y) >= 1.0
    v_safe = torch.asin(torch.clamp(y, -0.999999, 0.999999)) / math.pi
    v = 0.5 + torch.where(pole, torch.sign(y) * 0.5, v_safe)
    return point, normal, torch.stack([u, v], dim=-1)


# --- combined nearest-hit query --------------------------------------------


def ray_cast(soa, o, d, min_dist, tri_candidates=None, need_attrs=True,
             need_uv=True) -> HitRecord:
    """Nearest hit over all primitive kinds.

    o, d: (R,3) f32; min_dist: scalar or (R,) strict lower bound on t.
    Misses get t=+inf, normal=0, obj=n_objects. `tri_candidates(soa, o, d,
    min_dist, o0) -> TriCandidate` overrides the brute-force triangle query
    (ops.bvh.candidates_fn). `need_attrs=False` skips point/normal/uv."""
    r = o.shape[0]
    min_dist = torch.as_tensor(min_dist, dtype=torch.float32,
                               device=o.device).expand(r)
    o0 = soa.scene_center

    if tri_candidates is None:
        tri_candidates = local_tri_candidates
    tri = tri_candidates(soa, o, d, min_dist, o0)
    t_pl, i_pl = cast_planes(soa, o, d, min_dist, o0)
    t_sp, i_sp = cast_spheres(soa, o, d, min_dist, o0)

    ts = torch.stack([tri.t, t_pl, t_sp], dim=-1)
    objs = torch.stack(
        [tri.obj, soa.pl_obj[i_pl].to(torch.int64),
         soa.sp_obj[i_sp].to(torch.int64)], dim=-1)
    kind = _first_min(ts, objs)  # 0=tri 1=plane 2=sphere
    t = _take(ts, kind)
    hit = torch.isfinite(t)

    def pick(a, b, c):
        k = kind.reshape(kind.shape + (1,) * (a.dim() - 1))
        return torch.where(k == 0, a, torch.where(k == 1, b, c))

    mat = pick(tri.mat, soa.pl_mat[i_pl].to(torch.int64),
               soa.sp_mat[i_sp].to(torch.int64))
    obj = _take(objs, kind)
    obj = torch.where(hit, obj, soa.n_objects)
    mat = torch.where(hit, mat, 0)
    t_cnt, p_cnt = soa.tri_p1.shape[0], soa.pl_point.shape[0]
    prim = pick(tri.order.to(torch.int64), t_cnt + i_pl, t_cnt + p_cnt + i_sp)
    prim = torch.where(hit, prim, -1)

    if not need_attrs:
        zero3 = torch.zeros_like(o)
        return HitRecord(hit=hit, t=t, obj=obj, mat=mat, prim=prim,
                         point=zero3, normal=zero3,
                         uv=torch.zeros_like(o[:, :2]))

    t_safe = torch.where(hit, t, 1.0)
    p_tri, n_tri, uv_tri = triangle_attrs_from_verts(
        tri.p1, tri.p2, tri.p3, tri.is_mesh, o, d, t_safe, need_uv
    )
    p_pl, n_pl, uv_pl = plane_hit_attrs(soa, o, d, t_safe, i_pl, need_uv)
    p_sp, n_sp, uv_sp = sphere_hit_attrs(soa, o, d, t_safe, i_sp, need_uv)

    point = pick(p_tri, p_pl, p_sp)
    normal = pick(n_tri, n_pl, n_sp)
    uv = pick(uv_tri, uv_pl, uv_sp)
    hit3 = hit[:, None]
    return HitRecord(
        hit=hit,
        t=t,
        obj=obj,
        mat=mat,
        prim=prim,
        point=torch.where(hit3, point, 0.0),
        normal=torch.where(hit3, normal, 0.0),
        uv=torch.where(hit3, uv, 0.0),
    )
