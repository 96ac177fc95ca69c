"""The plain reference: a brute-force Whitted tracer in PyTorch, with its
gradients taken by autograd.

It follows the upstream cutrace's semantics (camera.hpp, ray_cast.hpp,
shading in kernel.hpp), written independently of the program under test:

- A pixel (x, y) shoots d = normalize(((x/w - 0.5)·w/h)·right + (0.5 -
  y/h)·up + forward) from the eye; the basis is look_at's.
- A cast takes the nearest hit past min_t over every object, ties going
  to the earlier object in the scene file (and, in a mesh, the earlier
  triangle). Triangles are tested by Moeller-Trumbore, planes and spheres
  by their equations (a sphere's t is along the normalized direction).
- A hit's color is Phong: ambient·diffuse + Σ lights (1 - shadow)·(max(0,
  n·l)·diffuse·c + max(0, n·h)^phong·specular·diffuse·c); a light with
  shadow 1 adds nothing. The shadow marches from the hit point toward the
  light from min 1e-3 past the last occluder, adding (1 - transparency)
  of each occluder nearer than the light, until it reaches 1.
- The bounce tree: rgb = phong; a reflecting hit (reflect >= 1e-6) adds
  reflect·C(reflected ray); a transparent one (transparency >= 1e-6) blends
  (1 - f)·rgb + f·C(straight-on ray); `bounces` levels below the primary
  cast. Depth is the primary hit's t (inf on a miss) and normal its
  surface normal (a triangle's normalized (p2 - p1) x (p3 - p1), a plane's
  as authored, 0 on a miss).

Which object a ray hits is found without gradients (the search); the hit's
t, point and normal are then computed again from the parameters, so
gradients flow through the surface and shading math at fixed topology.
The search tests a triangle only where the ray enters the box of its
chunk (triangles grouped by a Morton order of their centroids), which
changes no answer. With `tf32` every factor of the casts' products is
first rounded to TF32's 10-bit mantissa: the control, a float32 program
with TF32 products.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference.loader import SceneData

EPS = 1e-6  # material activity threshold
SHADOW_MIN = 1e-3  # the shadow march's step past an occluder
MAX_MARCH = 64
BIG = 2**62
# elements a batch of (ray, triangle) tests or box tests may hold
TEST_BUDGET = 1 << 24

def round_tf32(x):
    """float32 x rounded to nearest (ties to even) on a 10-bit mantissa."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(a):
    return a / torch.sqrt(_dot(a, a))[..., None]


def _morton(points: np.ndarray) -> np.ndarray:
    lo, hi = points.min(0), points.max(0)
    q = ((points - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.int64)
    key = np.zeros(len(points), np.int64)
    for bit in range(10):
        for axis in range(3):
            key |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return key


@dataclasses.dataclass
class Counts:
    """What the casts of a trace needed: rays cast (nearest-hit and shadow
    march steps), triangles whose own box the cast's segment enters before
    its hit (or before the light), tree nodes that hit."""

    casts: int = 0
    tri_boxes: int = 0
    hit_nodes: int = 0


class Tracer:
    """A scene on a device in `dtype`, its parameters and its fixed parts.
    `params()` gives fresh leaves, named as the port's differentiable
    groups; `trace` renders rays with any such dict."""

    def __init__(self, data: SceneData, device, dtype=torch.float64,
                 tf32: bool = False, chunk: int = 0):
        self.device, self.dtype, self.tf32 = torch.device(device), dtype, tf32
        self.data = data
        dev = self.device

        def i64(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=dev)

        self.tri_obj, self.tri_mat = i64(data.tri_obj), i64(data.tri_mat)
        self.pl_obj, self.pl_mat = i64(data.pl_obj), i64(data.pl_mat)
        self.sp_obj, self.sp_mat = i64(data.sp_obj), i64(data.sp_mat)
        self.light_sun = torch.as_tensor(data.light_sun, device=dev)
        self.width, self.height = data.width, data.height
        self.any_reflective = bool((data.mat_reflect >= EPS).any())
        self.any_transparent = bool((data.mat_transparency >= EPS).any())
        n = len(data.tris)
        self.n_tris = n
        self.chunk = chunk or (64 if n < 16384 else 256)
        q = max(1, -(-n // self.chunk))
        order = (np.argsort(_morton(data.tris.mean(1)), kind="stable")
                 if n else np.zeros(0, np.int64))
        members = np.full(q * self.chunk, -1, np.int64)
        members[:n] = order
        self.members = i64(members.reshape(q, self.chunk))

    # --- parameters -----------------------------------------------------

    def params(self):
        """The scene's continuous leaves in `dtype` (camera basis by
        look_at, computed in `dtype` from the authored float32 values)."""
        d = self.data
        dev, dt = self.device, self.dtype

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=dev
                                   ).to(dt)

        eye, look, up = t(d.eye), t(d.look), t(d.up)
        forward = _normalize(look - eye)
        right = _normalize(torch.linalg.cross(forward, up))
        true_up = _normalize(torch.linalg.cross(right, forward))
        return {
            "tri_p1": t(d.tris[:, 0]).reshape(-1, 3),
            "tri_p2": t(d.tris[:, 1]).reshape(-1, 3),
            "tri_p3": t(d.tris[:, 2]).reshape(-1, 3),
            "pl_point": t(d.pl_point).reshape(-1, 3),
            "pl_normal": t(d.pl_normal).reshape(-1, 3),
            "sp_center": t(d.sp_center).reshape(-1, 3),
            "sp_radius": t(d.sp_radius).reshape(-1),
            "mat_color": t(d.mat_color), "mat_specular": t(d.mat_specular),
            "mat_reflect": t(d.mat_reflect), "mat_phong": t(d.mat_phong),
            "mat_transparency": t(d.mat_transparency),
            "light_vec": t(d.light_point), "light_color": t(d.light_color),
            "cam_eye": eye, "cam_forward": forward, "cam_right": right,
            "cam_up": true_up, "ambient": t(d.ambient),
        }

    def q(self, x):
        """A product's factor: as is, or rounded to TF32 (the control)."""
        if not self.tf32:
            return x
        return round_tf32(x.to(torch.float32)).to(x.dtype)

    # --- the search (no gradients) ----------------------------------------

    def _tri_search(self, geo, o, d, min_t, t_end=None):
        """Nearest triangle (t, index) of each ray; with `t_end` instead
        the number of triangles whose own box the segment [min_t, t_end]
        enters (chunk boxes first, then the triangles' own)."""
        r = o.shape[0]
        best_t = torch.full((r,), math.inf, dtype=o.dtype, device=o.device)
        best_i = torch.full((r,), BIG, dtype=torch.int64, device=o.device)
        boxes = torch.zeros(r, dtype=torch.int64, device=o.device)
        if self.n_tris == 0 or r == 0:
            return (boxes if t_end is not None else (best_t, best_i))
        p1c, e1c, e2c, lo_t, hi_t, lo_c, hi_c, live = geo
        qn, c = p1c.shape[:2]
        hi_seg = (torch.full_like(min_t, math.inf) if t_end is None
                  else t_end)
        step = max(1, TEST_BUDGET // max(1, qn * 3))
        pairs_r, pairs_c = [], []
        for s in range(0, r, step):
            enter = _slab(o[s:s + step, None], d[s:s + step, None], lo_c,
                          hi_c, min_t[s:s + step, None],
                          hi_seg[s:s + step, None])
            pr, pc = enter.nonzero(as_tuple=True)
            pairs_r.append(pr + s)
            pairs_c.append(pc)
        pr, pc = torch.cat(pairs_r), torch.cat(pairs_c)
        pb = max(1, TEST_BUDGET // (c * 3))
        for s in range(0, pr.shape[0], pb):
            rr, cc = pr[s:s + pb], pc[s:s + pb]
            oo, dd, mt = o[rr, None], d[rr, None], min_t[rr, None]
            if t_end is not None:
                inside = _slab(oo, dd, lo_t[cc], hi_t[cc], mt,
                               t_end[rr, None]) & live[cc]
                boxes.index_add_(0, rr, inside.sum(1))
                continue
            t = self._mt(oo, dd, p1c[cc], e1c[cc], e2c[cc], mt) \
                .masked_fill(~live[cc], math.inf)
            tmin = t.min(1).values
            idx = torch.where((t == tmin[:, None]) & torch.isfinite(t),
                              self.members[cc], BIG).min(1).values
            new_t = best_t.scatter_reduce(0, rr, tmin, "amin")
            cand = torch.where(tmin == new_t[rr], idx, BIG)
            new_i = torch.full_like(best_i, BIG).scatter_reduce(
                0, rr, cand, "amin")
            best_i = torch.where(best_t == new_t,
                                 torch.minimum(best_i, new_i), new_i)
            best_t = new_t
        return boxes if t_end is not None else (best_t, best_i)

    def _mt(self, o, d, p1, e1, e2, min_t):
        """Moeller-Trumbore t of rays against triangles, inf where missed."""
        q = self.q
        pvec = torch.linalg.cross(q(d), q(e2), dim=-1)
        det = _dot(q(e1), q(pvec))
        tvec = o - p1
        u = _dot(q(tvec), q(pvec)) / det
        qvec = torch.linalg.cross(q(tvec), q(e1), dim=-1)
        v = _dot(q(d), q(qvec)) / det
        t = _dot(q(e2), q(qvec)) / det
        ok = ((det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
              & torch.isfinite(t) & (t > min_t))
        return torch.where(ok, t, math.inf)

    def _geometry(self, p):
        """Per-chunk corners and edges, the triangles' boxes and the
        chunks' boxes (widened by a hair, so rounding loses no hit)."""
        if self.n_tris == 0:
            return None
        m = self.members
        live = m >= 0
        safe = m.clamp(min=0)
        p1, p2, p3 = (p[k].detach()[safe] for k in ("tri_p1", "tri_p2",
                                                    "tri_p3"))
        corners = torch.stack([p1, p2, p3], 2)  # (Q, C, 3, 3)
        lo_t, hi_t = corners.min(2).values, corners.max(2).values
        pad = 1e-6 * (hi_t - lo_t).abs().amax(-1, keepdim=True) + 1e-9
        lo_t, hi_t = lo_t - pad, hi_t + pad
        big = torch.tensor(math.inf, dtype=lo_t.dtype, device=lo_t.device)
        lo_c = torch.where(live[..., None], lo_t, big).min(1).values
        hi_c = torch.where(live[..., None], hi_t, -big).max(1).values
        return p1, p2 - p1, p3 - p1, lo_t, hi_t, lo_c, hi_c, live

    def _search(self, p, geo, o, d, min_t):
        """(t, kind, index) of each ray's nearest hit: kind 0 triangle, 1
        plane, 2 sphere, -1 a miss."""
        q = self.q
        o, d = o.detach(), d.detach()
        t_tri, i_tri = self._tri_search(geo, o, d, min_t)
        obj_tri = torch.full_like(i_tri, BIG)
        if self.n_tris:
            obj_tri = torch.where(i_tri < BIG, self.tri_obj[
                i_tri.clamp(0, self.n_tris - 1)], BIG)
        ts, objs, idxs = [t_tri], [obj_tri], [i_tri]
        n = p["pl_normal"].detach()
        if n.shape[0]:
            pt = p["pl_point"].detach()
            denom = q(d) @ q(n).T
            num = _dot(q(pt), q(n))[None] - q(o) @ q(n).T
            t = num / denom
            ok = (denom != 0) & torch.isfinite(t) & (t > min_t[:, None])
            t = torch.where(ok, t, math.inf)
            ts_, ix = _first_min(t, self.pl_obj)
            ts.append(ts_), idxs.append(ix), objs.append(self.pl_obj[ix])
        c = p["sp_center"].detach()
        if c.shape[0]:
            t0, t1, ok0, ok1 = self._sphere_roots(o, d, c,
                                                  p["sp_radius"].detach(),
                                                  min_t[:, None])
            t = torch.where(ok0 & ok1, torch.minimum(t0, t1),
                            torch.where(ok0, t0, torch.where(ok1, t1,
                                                             math.inf)))
            ts_, ix = _first_min(t, self.sp_obj)
            ts.append(ts_), idxs.append(ix), objs.append(self.sp_obj[ix])
        while len(ts) < 3:
            ts.append(torch.full_like(t_tri, math.inf))
            objs.append(torch.full_like(obj_tri, BIG))
            idxs.append(torch.zeros_like(i_tri))
        tt, oo = torch.stack(ts, 1), torch.stack(objs, 1)
        kind = _first_min(tt, oo)[1]
        t = tt.gather(1, kind[:, None])[:, 0]
        idx = torch.stack(idxs, 1).gather(1, kind[:, None])[:, 0]
        hit = torch.isfinite(t)
        return t, torch.where(hit, kind, -1), torch.where(hit, idx, 0)

    def _sphere_roots(self, o, d, c, r, min_t):
        q = self.q
        dn = _normalize(d)
        oc = c[None] - o[:, None]
        dec = _dot(q(dn[:, None]), q(oc))
        sub = dec * dec - (_dot(q(oc), q(oc)) - r[None] ** 2)
        missed = sub <= 0
        sq = torch.sqrt(torch.where(missed, 1.0, sub))
        t0, t1 = dec - sq, dec + sq
        ok0 = ~missed & torch.isfinite(t0) & (t0 > min_t)
        ok1 = ~missed & torch.isfinite(t1) & (t1 > min_t)
        return t0, t1, ok0, ok1

    # --- the hit, again, with gradients -----------------------------------

    def _hit(self, p, o, d, kind, idx, min_t):
        """t, point, normal and material of each ray's hit (kind, idx),
        as functions of the parameters and the rays; rays that miss get
        t inf, point 0, normal 0, material 0."""
        q = self.q
        r = o.shape[0]
        t = torch.full((r,), math.inf, dtype=o.dtype, device=o.device)
        point = torch.zeros_like(o)
        normal = torch.zeros_like(o)
        mat = torch.zeros(r, dtype=torch.int64, device=o.device)
        for k in (0, 1, 2):
            sel = (kind == k).nonzero(as_tuple=True)[0]
            if sel.numel() == 0:
                continue
            oo, dd, ii = o[sel], d[sel], idx[sel]
            if k == 0:
                p1, p2, p3 = (p[n][ii] for n in ("tri_p1", "tri_p2",
                                                 "tri_p3"))
                n = torch.linalg.cross(q(p2 - p1), q(p3 - p1), dim=-1)
                tk = _dot(q(p1 - oo), q(n)) / _dot(q(dd), q(n))
                pk = oo + tk[:, None] * dd
                nk = _normalize(n)
                mk = self.tri_mat[ii]
            elif k == 1:
                n, pt = p["pl_normal"][ii], p["pl_point"][ii]
                tk = _dot(q(pt - oo), q(n)) / _dot(q(dd), q(n))
                pk = oo + tk[:, None] * dd
                nk = n
                mk = self.pl_mat[ii]
            else:
                c, rad = p["sp_center"][ii], p["sp_radius"][ii]
                dn = _normalize(dd)
                oc = c - oo
                dec = _dot(q(dn), q(oc))
                sub = dec * dec - (_dot(q(oc), q(oc)) - rad ** 2)
                sq = torch.sqrt(sub)
                t0 = dec - sq
                first = (t0 > min_t[sel]) & torch.isfinite(t0)
                tk = torch.where(first, t0, dec + sq)
                pk = oo + tk[:, None] * dn
                nk = _normalize(pk - c)
                mk = self.sp_mat[ii]
            t = t.index_put((sel,), tk)
            point = point.index_put((sel,), pk)
            normal = normal.index_put((sel,), nk)
            mat = mat.index_put((sel,), mk)
        return t, point, normal, mat

    def _occluder_mat(self, kind, idx):
        mats = torch.zeros_like(idx)
        for k, table in ((0, self.tri_mat), (1, self.pl_mat),
                         (2, self.sp_mat)):
            sel = kind == k
            if sel.any():
                mats = torch.where(sel, table[idx.clamp(
                    max=max(0, table.shape[0] - 1))], mats)
        return mats

    # --- shading ----------------------------------------------------------

    def _shadow(self, p, geo, point, sdir, max_dist, counts):
        """The shadow march's intensity in [0, 1] of each (point, light)
        ray."""
        r = point.shape[0]
        inten = torch.zeros(r, dtype=point.dtype, device=point.device)
        last = torch.zeros(r, dtype=point.dtype, device=point.device)
        active = torch.ones(r, dtype=torch.bool, device=point.device)
        o, d = point.detach(), sdir.detach()
        md = max_dist.detach()
        for _ in range(MAX_MARCH):
            rows = active.nonzero(as_tuple=True)[0]
            if rows.numel() == 0:
                break
            mt = last[rows] + SHADOW_MIN
            t, kind, idx = self._search(p, geo, o[rows], d[rows], mt)
            ok = torch.isfinite(t) & (t < md[rows])
            if counts is not None:
                counts.casts += int(rows.numel())
                end = torch.where(ok, t, md[rows])
                counts.tri_boxes += int(self._tri_search(
                    geo, o[rows], d[rows], mt, end).sum())
            tr = p["mat_transparency"][self._occluder_mat(kind, idx)]
            add = torch.zeros_like(inten).index_put(
                (rows,), torch.where(ok, 1.0 - tr, 0.0))
            inten = inten + add
            last = last.index_put((rows,), torch.where(ok, t, last[rows]))
            active = active.index_put((rows,), ok) & (inten.detach() < 1.0)
        return torch.where(inten >= 1.0, torch.ones_like(inten), inten)

    def _phong(self, p, geo, d, point, normal, mat, counts):
        diffuse = p["mat_color"][mat]
        specular = p["mat_specular"][mat][:, None] * diffuse
        expo = p["mat_phong"][mat]
        nn = _normalize(normal)
        minus_dn = -_normalize(d)
        final = p["ambient"] * diffuse
        n_l = p["light_vec"].shape[0]
        if n_l == 0:
            return final
        r = point.shape[0]
        vec = p["light_vec"]
        sun = self.light_sun
        diff = vec[:, None] - point[None]  # (L, R, 3)
        dist = torch.sqrt(_dot(diff, diff))
        direction = torch.where(sun[:, None, None],
                                -vec[:, None].expand_as(diff),
                                diff / dist[..., None])
        norm_dir = torch.sqrt(_dot(direction, direction))
        distance = torch.where(sun[:, None], math.inf, dist)
        sdir = direction / norm_dir[..., None]
        shadow = self._shadow(p, geo, point.repeat(n_l, 1),
                              sdir.reshape(-1, 3),
                              (distance * norm_dir).reshape(-1),
                              counts).reshape(n_l, r)
        for i in range(n_l):
            s = sdir[i]
            color = p["light_color"][i]
            fdd = _dot(nn, s)
            fd = torch.where(fdd > 0, fdd, torch.zeros_like(fdd))
            h = _normalize(minus_dn + s)
            bdd = _dot(nn, h)
            base = torch.where(bdd > 0, bdd, torch.zeros_like(bdd))
            lit_base = torch.where(base > 0, base, torch.ones_like(base))
            fs = torch.where(base > 0, lit_base ** expo,
                             torch.zeros_like(base))
            contrib = (fd[:, None] * diffuse * color
                       + fs[:, None] * specular * color)
            keep = shadow[i] < 1.0
            final = final + torch.where(keep[:, None],
                                        (1.0 - shadow[i])[:, None] * contrib,
                                        torch.zeros_like(contrib))
        return final

    # --- rays -------------------------------------------------------------

    def camera_rays(self, p, px, py):
        dt = self.dtype
        w, h = float(self.width), float(self.height)
        x = (px.to(dt) / w - 0.5) * (w / h)
        y = 0.5 - py.to(dt) / h
        d = (x[:, None] * p["cam_right"] + y[:, None] * p["cam_up"]
             + p["cam_forward"])
        d = _normalize(d)
        return p["cam_eye"].expand_as(d), d

    def trace(self, p, px, py, bounces: int, fudge: float = 1e-3,
              counts: Counts = None):
        """(color (R, 3), depth (R,), normal (R, 3)) of the pixels (px,
        py) with parameters `p`; `counts` adds up what the casts needed."""
        geo = self._geometry(p)
        o, d = self.camera_rays(p, px, py)
        r = o.shape[0]
        color = torch.zeros((r, 3), dtype=o.dtype, device=o.device)
        pix = torch.arange(r, device=o.device)
        w = torch.ones(r, dtype=o.dtype, device=o.device)
        depth = normal0 = None
        spawn = self.any_reflective or self.any_transparent
        for level in range(bounces + 1):
            mt = torch.full((o.shape[0],), fudge, dtype=o.dtype,
                            device=o.device)
            t_s, kind, idx = self._search(p, geo, o, d, mt)
            hit = kind >= 0
            if counts is not None:
                counts.casts += int(o.shape[0])
                counts.hit_nodes += int(hit.sum())
                counts.tri_boxes += int(self._tri_search(
                    geo, o.detach(), d.detach(), mt, t_s).sum())
            t, point, nrm, mat = self._hit(p, o, d, kind, idx, mt)
            if level == 0:
                depth, normal0 = t, nrm
            rows = hit.nonzero(as_tuple=True)[0]
            ph = self._phong(p, geo, d[rows], point[rows], nrm[rows],
                             mat[rows], counts)
            last = level == bounces or not spawn
            f = torch.zeros_like(w)
            if self.any_transparent:
                tr = p["mat_transparency"][mat]
                f = torch.where(hit & (tr >= EPS), tr, torch.zeros_like(tr))
            keep = w[rows] if last else (w * (1.0 - f))[rows]
            color = color.index_add(0, pix[rows], keep[:, None] * ph)
            if last:
                break
            origin = o[rows] + t[rows, None] * d[rows]
            nxt = []
            if self.any_reflective:
                rf = p["mat_reflect"][mat[rows]]
                wr = (w * (1.0 - f))[rows] * torch.where(
                    rf >= EPS, rf, torch.zeros_like(rf))
                dr = _normalize(d[rows])
                nr = _normalize(nrm[rows])
                refl = dr - 2.0 * _dot(nr, dr)[:, None] * nr
                nxt.append((origin, refl, wr, pix[rows]))
            if self.any_transparent:
                nxt.append((origin, d[rows], (w * f)[rows], pix[rows]))
            if not nxt:
                break
            o, d, w, pix = (torch.cat(x) for x in zip(*nxt))
            live = (w.detach() != 0).nonzero(as_tuple=True)[0]
            o, d, w, pix = o[live], d[live], w[live], pix[live]
            if o.shape[0] == 0:
                break
        return color, depth, normal0


def _slab(o, d, lo, hi, t_lo, t_hi):
    """Does the segment o + t·d, t in [t_lo, t_hi], enter the box [lo, hi]?
    Broadcast over leading axes; an undefined slab (0·inf) admits."""
    inv = 1.0 / d
    a, b = (lo - o) * inv, (hi - o) * inv
    near = torch.where(torch.isnan(a) | torch.isnan(b), -math.inf,
                       torch.minimum(a, b)).amax(-1)
    far = torch.where(torch.isnan(a) | torch.isnan(b), math.inf,
                      torch.maximum(a, b)).amin(-1)
    near = torch.maximum(near, t_lo)
    far = torch.minimum(far, t_hi)
    return far >= near


def _first_min(t, key):
    """(smallest t, its column) of each row; ties to the smallest key."""
    tmin = t.min(-1, keepdim=True).values
    k = torch.where(t == tmin, key.expand_as(t), BIG)
    col = k.argmin(-1)
    return t.gather(-1, col[..., None])[..., 0], col
