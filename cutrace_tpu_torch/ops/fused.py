"""The whole pixel pipeline in one kernel (counterpart of
cutrace_tpu.ops.fused, forward only).

`fused_render_rays` runs primary cast -> per bounce-tree node: nearest hit,
Phong with per-light shadow queries, reflection/transparency children ->
color, depth and normal, for every ray of a batch. On a CUDA tensor it
launches the hand-written Hopper kernel in `csrc/fused_forward.cu`; on a
CPU tensor it runs `fused_render_rays_plain`, the composable torch pipeline
(ops.intersect.ray_cast + render.shading.ray_color) over the same cluster
partition. The plain version is also what the kernel is checked against on
the card.

The kernel reads the tables `kernel_tables` builds: the rows of the JAX
package's `_tables` and `_light_table` that the kernel needs (per-slot
triangle constants of the recentered intersection identities, shading
normals, object and material indices, plane/sphere rows, material rows and
light rows), all positions shifted by the scene center. They depend on the
scene and its partition only, so `prepare` builds them once per scene.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from cutrace_tpu_torch.ops import bvh
from cutrace_tpu_torch.render.renderer import default_chunk, render_rays

# Partitions of at most this many clusters are in the kernel's scope (the
# JAX lanes kernel's bound); bigger scenes are ROADMAP item A.10.
LANES_MAX_M = 32
# Bounce-tree nodes in the kernel's scope (a two-branch tree at bounce
# depth 5); deeper trees are ROADMAP item A.10.
MAX_NODES = 63
# Kernel launches of `fused_render_rays` on CUDA tensors since import, or
# since a caller last reset it.
LAUNCHES = 0

# Row layouts of the kernel's tables. csrc/fused_forward.cu reads the same
# offsets (its T_* and P_* constants).
# per-slot rows of the (M, C, 24) triangle table; row 23 is zero
_TRI_NAMES = (
    "n0", "n1", "n2", "ub0", "ub1", "ub2", "ug0", "ug1", "ug2",
    "a0", "a1", "a2", "b0", "b1", "b2", "k", "order", "valid",
    "snx", "sny", "snz", "obj", "mat",
)
_TRI_ROWS = 24
# (P or S, 12) plane and sphere rows: object index, plane normal, sphere
# center, K (planes: dot(point - o0, normal); spheres: radius^2), valid,
# material index, 2 zero rows
_PS_OBJ, _PS_N, _PS_C, _PS_K, _PS_VALID, _PS_MAT = 0, 1, 4, 7, 8, 9
_PS_ROWS = 12
# (M, 8) cluster boxes: bmin xyz, bmax xyz, 0, 0
_AABB_ROWS = 8


def n_wave_nodes(bounces, any_refl, any_transp):
    """Bounce-tree nodes after pruning the branches no material spawns."""
    if any_refl and any_transp:
        return 2 ** (bounces + 1) - 1
    if any_refl or any_transp:
        return bounces + 1
    return 1


def check_scope(soa, accel, bounces):
    """Raise NotImplementedError for what the kernel does not cover: more
    than LANES_MAX_M clusters or a bounce tree of more than MAX_NODES."""
    m = accel.order.shape[0]
    if m > LANES_MAX_M:
        raise NotImplementedError(
            f"{m} clusters: the fused kernel covers at most {LANES_MAX_M}; "
            f"bigger partitions are ROADMAP item A.10 (big-scene kernel K3)")
    nodes = n_wave_nodes(bounces, soa.any_reflective, soa.any_transparent)
    if nodes > MAX_NODES:
        raise NotImplementedError(
            f"a {nodes}-node bounce tree: the fused kernel covers at most "
            f"{MAX_NODES} nodes; deeper trees are ROADMAP item A.10")


# --------------------------------------------------------------------------
# tables
# --------------------------------------------------------------------------


def _cluster_constants(c: bvh.TriClusters, o0):
    """Per-triangle intersection constants recentered by o0: dict of
    (M, C) tensors (cutrace_tpu.ops.pallas_cast._cluster_constants)."""
    p1 = c.p1 - o0
    p2 = c.p2 - o0
    p3 = c.p3 - o0
    a = p2 - p1
    b = p2 - p3
    n = torch.linalg.cross(a, b)
    ub = torch.linalg.cross(p2, b)
    ug = torch.linalg.cross(p2, a)
    k = (p2 * n).sum(-1)
    out = {}
    for name, arr in (("n", n), ("ub", ub), ("ug", ug), ("a", a), ("b", b)):
        for ax in range(3):
            out[f"{name}{ax}"] = arr[..., ax]
    out["k"] = k
    out["order"] = c.order.to(torch.int32)
    out["valid"] = c.valid.to(torch.float32)
    return out


@dataclasses.dataclass(frozen=True)
class KernelTables:
    """The kernel's scene operands: contiguous float32 tensors on the
    scene's device, positions recentered by the scene center."""

    tri: torch.Tensor  # (M, C, _TRI_ROWS) per-slot rows
    aabb: torch.Tensor  # (M, _AABB_ROWS)
    plane: torch.Tensor  # (P, _PS_ROWS)
    sphere: torch.Tensor  # (S, _PS_ROWS)
    mat: torch.Tensor  # (n_mats, 8): color rgb, spec, refl, phong, transp, 0
    lights: torch.Tensor  # (L, 8), see _light_table
    ambient: torch.Tensor  # (1,)


@torch.no_grad()
def _light_table(soa, o0):
    """(L, 8) rows [kind, vx, vy, vz, cr, cg, cb, 0]; point-light positions
    recentered by o0, sun directions as authored."""
    kind = soa.light_kind.to(torch.float32)[:, None]
    is_sun = (soa.light_kind == 0)[:, None]
    vec = torch.where(is_sun, soa.light_vec, soa.light_vec - o0)
    pad = torch.zeros_like(kind)
    return torch.cat([kind, vec, soa.light_color, pad], dim=1)


@torch.no_grad()
def kernel_tables(soa, accel) -> KernelTables:
    """The kernel's tables for a scene and its cluster partition (the
    counterpart of cutrace_tpu.ops.fused._tables and _light_table, holding
    only the rows the kernel reads)."""
    o0 = soa.scene_center
    dev = o0.device
    f32 = torch.float32
    clusters = bvh.clusters_from_accel(soa, accel)
    rows = _cluster_constants(clusters, o0)
    sn = -torch.linalg.cross(clusters.p2 - clusters.p3,
                             clusters.p1 - clusters.p3)
    sn = sn / torch.sqrt((sn * sn).sum(-1, keepdim=True))
    rows.update(snx=sn[..., 0], sny=sn[..., 1], snz=sn[..., 2],
                obj=clusters.obj, mat=clusters.mat)
    m, c = clusters.valid.shape
    tri = torch.zeros((m, c, _TRI_ROWS), dtype=f32, device=dev)
    tri[..., :len(_TRI_NAMES)] = torch.stack(
        [rows[k].to(f32) for k in _TRI_NAMES], dim=-1)

    aabb = torch.zeros((m, _AABB_ROWS), dtype=f32, device=dev)
    aabb[:, 0:3] = clusters.bmin - o0
    aabb[:, 3:6] = clusters.bmax - o0

    def prim_rows(obj, normal, center, k, valid, mat):
        out = torch.zeros((obj.shape[0], _PS_ROWS), dtype=f32, device=dev)
        out[:, _PS_OBJ] = obj.to(f32)
        out[:, _PS_N:_PS_N + 3] = normal
        out[:, _PS_C:_PS_C + 3] = center
        out[:, _PS_K] = k
        out[:, _PS_VALID] = valid.to(f32)
        out[:, _PS_MAT] = mat.to(f32)
        return out

    pln = soa.pl_normal
    plane = prim_rows(soa.pl_obj, pln, torch.zeros_like(pln),
                      ((soa.pl_point - o0) * pln).sum(-1), soa.pl_valid,
                      soa.pl_mat)
    spc = soa.sp_center - o0
    sphere = prim_rows(soa.sp_obj, torch.zeros_like(spc), spc,
                       soa.sp_radius * soa.sp_radius, soa.sp_valid,
                       soa.sp_mat)

    mc = soa.mat_color
    mat = torch.stack([
        mc[:, 0], mc[:, 1], mc[:, 2],
        soa.mat_specular, soa.mat_reflect,
        soa.mat_phong, soa.mat_transparency,
        torch.zeros_like(soa.mat_specular),
    ], dim=1)
    return KernelTables(
        tri=tri, aabb=aabb, plane=plane, sphere=sphere, mat=mat,
        lights=_light_table(soa, o0).contiguous(),
        ambient=soa.ambient.reshape(1).to(f32).contiguous(),
    )


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------


@torch.no_grad()
def fused_render_rays_plain(soa, accel, o, d, fudge, bounces: int):
    """The plain PyTorch version of the fused kernel: the composable
    pipeline (primary ray_cast for depth/normal, ray_color for color) with
    the dense cast over `accel`'s clusters, in ray chunks. Returns
    (color (R,3), depth (R,), normal (R,3))."""
    tc = bvh.candidates_fn(accel)
    chunk = default_chunk(soa, bounces)
    outs = [
        render_rays(soa, o[s:s + chunk], d[s:s + chunk], bounces, fudge, tc)
        for s in range(0, o.shape[0], chunk)
    ]
    return tuple(torch.cat(x) for x in zip(*outs))


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------


_BLOCK = 128  # threads per block; rays are padded to a multiple of it


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check_rays(o, d, device):
    """The caller's rays must be float32 (R, 3) tensors on the tables'
    device."""
    r = o.shape[0]
    for name, t in (("o", o), ("d", d)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (r, 3)
                or t.device != device):
            raise ValueError(f"{name}: expected float32 ({r}, 3) on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


@torch.no_grad()
def _fused_forward_cuda(soa, tables: KernelTables, o, d, fudge, bounces):
    from cutrace_tpu_torch.ops import _build

    global LAUNCHES
    dev = tables.tri.device
    _check_rays(o, d, dev)
    r = o.shape[0]
    m, c = tables.tri.shape[:2]
    r_pad = -(-r // _BLOCK) * _BLOCK
    # rays: [o - o0, d, min_dist, 0]; padding rays get min_dist = +inf, so
    # they can never hit anything
    rays = torch.zeros((r_pad, 8), dtype=torch.float32, device=dev)
    rays[:r, 0:3] = o - soa.scene_center
    rays[:r, 3:6] = d
    rays[:r, 6] = fudge
    rays[r:, 3:6] = 1.0
    rays[r:, 6] = math.inf
    out = torch.empty((r_pad, 7), dtype=torch.float32, device=dev)

    lib = _build.load_library()
    rc = lib.cutrace_fused_forward(
        _ptr(rays), _ptr(tables.tri), _ptr(tables.aabb), _ptr(tables.plane),
        _ptr(tables.sphere), _ptr(tables.mat), _ptr(tables.lights),
        _ptr(tables.ambient), _ptr(out),
        r_pad, m, c, soa.n_planes, soa.n_spheres, soa.n_lights,
        tables.mat.shape[0], bounces, soa.shadow_steps,
        int(soa.any_reflective), int(soa.any_transparent), float(fudge),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"fused forward kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return out[:r, 0:3], out[:r, 3], out[:r, 4:7]


def fused_render_rays(soa, accel, o, d, fudge, bounces: int,
                      emit_topo: bool = False, tables=None):
    """Fused render of explicit rays: (color (R,3), depth (R,),
    normal (R,3)).

    CUDA tensors launch the kernel (raising if it cannot) on `tables`, the
    scene's KernelTables (built here when None); CPU tensors run the plain
    version. Topology codes for the backward (`emit_topo`) are ROADMAP
    item A.7 and raise here."""
    if emit_topo:
        raise NotImplementedError(
            "topology codes (emit_topo) are ROADMAP item A.7 (replay "
            "backward)")
    check_scope(soa, accel, bounces)
    if o.is_cuda:
        if tables is None:
            tables = kernel_tables(soa, accel)
        return _fused_forward_cuda(soa, tables, o, d, fudge, bounces)
    if o.device.type != "cpu":
        raise ValueError(f"unsupported device {o.device}")
    return fused_render_rays_plain(soa, accel, o, d, fudge, bounces)
