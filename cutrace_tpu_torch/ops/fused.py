"""The whole pixel pipeline in one kernel (counterpart of
cutrace_tpu.ops.fused).

`fused_render_rays` runs primary cast -> per bounce-tree node: nearest hit,
Phong with per-light shadow queries, reflection/transparency children ->
color, depth and normal, for every ray of a batch. On a CUDA tensor it
launches the hand-written Hopper kernel in `csrc/fused_forward.cu`: K1,
its flat-cull instances, for partitions of at most LANES_MAX_M clusters
(the shared-memory instance when the partition's tables fit in a block's
shared memory, else the global-memory one: `k1_instance` decides before
the launch), and K3, its ordered-tree-walk instance, for bigger ones. On
a CPU tensor it
runs `fused_render_rays_plain`, the composable torch pipeline
(ops.intersect.ray_cast + render.shading.ray_color) with the dense cast
over the same cluster partition. The plain version is also what the
kernels are checked against on the card.

With `emit_topo` the forward also returns the topology codes of
ops.replay (the kernels write them themselves; `emit_topo_plain` is their
plain version). When a gradient is asked for, `fused_render_rays` is a
torch.autograd.Function. Within the replay's budgets its forward emits the
codes and its backward is the replay backward (ops.replay_vjp: the kernel
in `csrc/replay_vjp.cu` on CUDA tensors, torch autograd of the replay on
CPU tensors). Past them its forward emits no codes and its backward
re-runs the composable pipeline with the culling cast (ops.pallas_cast) in
ray chunks and differentiates it.

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
import functools
import math

import torch

from cutrace_tpu_torch.ops import bvh
from cutrace_tpu_torch.ops import intersect as I
from cutrace_tpu_torch.ops import pallas_cast as pc
from cutrace_tpu_torch.ops import replay as rp
from cutrace_tpu_torch.ops import replay_vjp as rv
from cutrace_tpu_torch.render import shading as sh
from cutrace_tpu_torch.render.renderer import default_chunk, render_rays
from cutrace_tpu_torch.utils import tracing

# Partitions of at most this many clusters run K1 (the JAX lanes kernel's
# bound); bigger ones run K3. The culling cast (K4) splits its flat loop
# from its tree walk at the same count.
LANES_MAX_M = pc.FLAT_MAX_M
# Bounce-tree nodes in the kernels' scope (a two-branch tree at bounce
# depth 5); render and the gradient take the composable culling cast past
# it.
MAX_NODES = 63
# Kernel launches on CUDA tensors since import, or since a caller last
# reset them, without and with topology codes: K1's shared-memory
# instance, K1's global-memory instance, K3.
LAUNCHES = 0
TOPO_LAUNCHES = 0
GLOBAL_LAUNCHES = 0
GLOBAL_TOPO_LAUNCHES = 0
BIG_LAUNCHES = 0
BIG_TOPO_LAUNCHES = 0

# Row layouts of the kernels' tables besides ops.pallas_cast's triangle
# table and boxes. csrc/cast.cuh reads the same offsets (its P_*
# constants).
# (P or S, 12) plane and sphere rows: object index, plane normal, sphere
# center, K (planes: dot(point - o0, normal); spheres: radius^2), valid,
# material index, 2 zero rows
_PS_OBJ, _PS_N, _PS_C, _PS_K, _PS_VALID, _PS_MAT = 0, 1, 4, 7, 8, 9
_PS_ROWS = 12


def n_wave_nodes(bounces, any_refl, any_transp):
    """Bounce-tree nodes after pruning the branches no material spawns."""
    if any_refl and any_transp:
        return 2 ** (bounces + 1) - 1
    if any_refl or any_transp:
        return bounces + 1
    return 1


def tree_in_scope(soa, bounces: int) -> bool:
    """Is the scene's bounce tree at most MAX_NODES nodes?"""
    return n_wave_nodes(bounces, soa.any_reflective,
                        soa.any_transparent) <= MAX_NODES


def fused_supported(soa, accel, bounces: int) -> bool:
    """Do the fused kernels render this call: a "fused" partition (of any
    size) and a bounce tree in their scope?"""
    return (accel is not None and accel.kind == "fused"
            and tree_in_scope(soa, bounces))


def check_scope(soa, accel, bounces):
    """Raise NotImplementedError for a bounce tree of more than MAX_NODES
    nodes, which the kernels do not cover."""
    if not tree_in_scope(soa, bounces):
        nodes = n_wave_nodes(bounces, soa.any_reflective, soa.any_transparent)
        raise NotImplementedError(
            f"a {nodes}-node bounce tree: the fused kernels cover at most "
            f"{MAX_NODES} nodes; render and the gradient take the "
            f"composable culling cast past it")


# --------------------------------------------------------------------------
# tables
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelTables(pc.ClusterTables):
    """The kernels' scene operands: the partition's ClusterTables (slot
    rows, cluster, tree and group boxes) and the rows below,
    contiguous float32 tensors on the scene's device, positions
    recentered by the scene center."""

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
    """The kernels' tables for a scene and its cluster partition (the
    counterpart of cutrace_tpu.ops.fused._tables and _light_table, holding
    only the rows the kernels read; the tree boxes take the place of its
    supercluster rows `aabb2`). The tree and the group boxes, which K1
    and K3 test, are built here from the live leaves on every call, as
    the rest."""
    o0 = soa.scene_center
    dev = o0.device
    f32 = torch.float32
    cl = pc.cluster_tables(soa, accel, sub=True)

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
        **vars(cl), plane=plane, sphere=sphere, mat=mat,
        lights=_light_table(soa, o0).contiguous(),
        ambient=soa.ambient.reshape(1).to(f32).contiguous(),
    )


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------


@torch.no_grad()
def fused_render_rays_plain(soa, accel, o, d, fudge, bounces: int):
    """The plain PyTorch version of the fused kernels: the composable
    pipeline (primary ray_cast for depth/normal, ray_color for color) with
    the dense cast over `accel`'s clusters, in ray chunks whose (rays x
    slots) products stay near 2^26 elements. Returns (color (R,3), depth
    (R,), normal (R,3))."""
    tc = bvh.dense_candidates_fn(accel)
    chunk = max(1, min(default_chunk(soa, bounces),
                       (1 << 26) // _slots(soa, accel)))
    outs = [
        render_rays(soa, o[s:s + chunk], d[s:s + chunk], bounces, fudge, tc)
        for s in range(0, o.shape[0], chunk)
    ]
    return tuple(torch.cat(x) for x in zip(*outs))


@torch.no_grad()
def emit_topo_plain(soa, accel, o, d, fudge, bounces: int):
    """The plain version of the kernel's topology codes: (R, K) int32 in
    ops.replay.topo_layout order, from the composable casts over `accel`'s
    clusters, walked depth first node by node for all rays. Entries the
    replay never reads hold -1 (opaque flag rows 0): nodes of weight 0 and
    their subtrees, the shadow rows of missed nodes, and march steps from
    the first one that does not count."""
    _, nodes = rp.topo_layout(bounces, soa.any_reflective,
                              soa.any_transparent, soa.n_lights,
                              soa.shadow_steps)
    # one node's casts at a time: a chunk's (rays x slots) products stay
    # near 2^26 elements
    chunk = max(1, (1 << 26) // _slots(soa, accel))
    return torch.cat([
        _emit_chunk(soa, accel, o[s:s + chunk], d[s:s + chunk], fudge,
                    bounces, nodes)
        for s in range(0, o.shape[0], chunk)])


def _slots(soa, accel):
    """Primitives a dense cast tests per ray: cluster slots, planes and
    spheres."""
    return (accel.order.numel() + soa.pl_point.shape[0]
            + soa.sp_center.shape[0])


def _emit_chunk(soa, accel, o, d, fudge, bounces, nodes):
    r = o.shape[0]
    tc = bvh.dense_candidates_fn(accel)
    opaque = not soa.any_transparent
    codes = _code_fill(soa, bounces, o.device).expand(r, -1).clone()
    it = iter(nodes)
    unit_z = sh._unit_z(o.device)

    def node(level, o3, d3, w, alive):
        _, cast_row, shadow_base = next(it)
        hit = I.ray_cast(soa, o3, d3, fudge, tc, need_uv=False)
        live = alive & hit.hit
        codes[:, cast_row] = torch.where(alive, hit.prim, -1).to(torch.int32)
        for li in range(soa.n_lights):
            direction, distance = sh.light_direction_to(soa, li, hit.point)
            sdir = sh._normalize(direction)
            light_dist = distance * sh._norm(direction)
            if opaque:
                occ = I.ray_cast(soa, hit.point, sdir, 1e-3, tc,
                                 need_attrs=False)
                flag = occ.hit & (occ.t < light_dist)
                codes[:, shadow_base + li] = (live & flag).to(torch.int32)
                continue
            shadow = torch.zeros_like(light_dist)
            last = torch.zeros_like(light_dist)
            act = live
            for si in range(soa.shadow_steps):
                step = I.ray_cast(soa, hit.point, sdir, last + 1e-3, tc,
                                  need_attrs=False)
                okm = act & step.hit & (step.t < light_dist)
                col = shadow_base + li * soa.shadow_steps + si
                codes[:, col] = torch.where(okm, step.prim, -1).to(
                    torch.int32)
                shadow = shadow + torch.where(
                    okm, 1.0 - soa.mat_transparency[step.mat], 0.0)
                last = torch.where(okm, step.t, last)
                act = okm & (shadow < 1.0)
        if level == bounces or not (soa.any_reflective
                                    or soa.any_transparent):
            return
        tr = soa.mat_transparency[hit.mat]
        f = (torch.where(hit.hit & (tr >= sh._EPS), tr, 0.0)
             if soa.any_transparent else torch.zeros_like(w))
        weff = w * (1.0 - f)
        child_o = o3 + torch.where(hit.hit, hit.t, 1.0)[:, None] * d3
        if soa.any_reflective:
            nrm = torch.where(hit.hit[:, None], hit.normal, unit_z)
            rd = sh._reflect(sh._normalize(d3), sh._normalize(nrm))
            refl = soa.mat_reflect[hit.mat]
            w_r = weff * torch.where(hit.hit & (refl >= sh._EPS), refl, 0.0)
            node(level + 1, child_o, rd, w_r, alive & (w_r != 0.0))
        if soa.any_transparent:
            node(level + 1, child_o, d3, w * f, alive & (w * f != 0.0))

    node(0, o, d, torch.ones((r,), dtype=torch.float32, device=o.device),
         torch.ones((r,), dtype=torch.bool, device=o.device))
    return codes


def replay_supported(soa, accel, bounces: int, n_rays: int = 0) -> bool:
    """Can the backward replay topology codes for this call: a partition
    (of any size) and a tree inside the kernels' scope, at most
    REPLAY_MAX_ROWS topo rows, and a code buffer of at most
    REPLAY_MAX_CODE_BYTES for `n_rays`?"""
    if accel is None or not tree_in_scope(soa, bounces):
        return False
    rows = rp.replay_rows(soa, bounces)
    if rows > rp.REPLAY_MAX_ROWS:
        return False
    return rows * max(n_rays, 1) * 4 <= rp.REPLAY_MAX_CODE_BYTES


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------


_BLOCK = 128  # threads per block; rays are padded to a multiple of it
# The kernel's instances (csrc/fused_forward.cu kInstance*).
_K1_GLOBAL, _K1_SHARED, _K3 = 0, 1, 2
# floats per material and light row (csrc/fused_forward.cu kMatRows,
# kLightRows)
_MAT_ROWS = _LIGHT_ROWS = 8
# the card's shared-memory limit per block (bytes), per device index
_SHARED_LIMIT: dict = {}


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def k1_shared_bytes(soa, tables: KernelTables) -> int:
    """Bytes of shared memory K1's shared-memory instance takes per block:
    the staged slot rows, cluster and group boxes and rows of the scene's
    planes, spheres, materials and lights, and the root box it folds from
    the cluster boxes (csrc/fused_forward.cu shared_floats)."""
    return 4 * (tables.tri.numel() + tables.aabb.numel()
                + tables.sub.numel() + pc._AABB_ROWS
                + (soa.n_planes + soa.n_spheres) * _PS_ROWS
                + tables.mat.shape[0] * _MAT_ROWS
                + soa.n_lights * _LIGHT_ROWS)


def shared_limit(device) -> int:
    """The largest dynamic shared memory a block may opt in to on the
    current CUDA device, from the kernel library (cudaDevAttrMaxShared
    MemoryPerBlockOptin: 232,448 bytes on an H100), kept per index of
    `device`."""
    from cutrace_tpu_torch.ops import _build

    index = torch.device(device).index or 0
    if index not in _SHARED_LIMIT:
        out = ctypes.c_int(0)
        rc = _build.load_library("fused_forward").cutrace_shared_limit(
            ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"shared-memory limit query failed: CUDA "
                               f"error {rc}")
        _SHARED_LIMIT[index] = out.value
    return _SHARED_LIMIT[index]


def k1_instance(soa, tables: KernelTables) -> int:
    """Which instance runs a partition, decided before the launch: K3
    past LANES_MAX_M clusters; else K1's shared-memory instance when its
    tables fit in a block's shared memory on the tables' card, K1's
    global-memory instance when they do not. Neither gives way to the
    other after a failed launch."""
    if tables.tri.shape[0] > LANES_MAX_M:
        return _K3
    if k1_shared_bytes(soa, tables) <= shared_limit(tables.tri.device):
        return _K1_SHARED
    return _K1_GLOBAL


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


def _code_fill(soa, bounces, device):
    """(K,) int32 pre-fill of the code buffer's rows: -1, and 0 in opaque
    scenes' occlusion-flag rows. Made once per layout and device, and
    shared: callers copy it."""
    return _code_fill_on(bounces, soa.any_reflective, soa.any_transparent,
                         soa.n_lights, soa.shadow_steps, torch.device(device))


@functools.lru_cache(maxsize=16)
def _code_fill_on(bounces, any_refl, any_transp, n_lights, shadow_steps,
                  device):
    rows, nodes = rp.topo_layout(bounces, any_refl, any_transp, n_lights,
                                 shadow_steps)
    fill = torch.full((rows,), -1, dtype=torch.int32)
    if not any_transp:
        for _, cast_row, shadow_base in nodes:
            fill[shadow_base:cast_row + 1 + n_lights] = 0
    return fill.to(device)


@torch.no_grad()
def _fused_forward_cuda(soa, tables: KernelTables, o, d, fudge, bounces,
                        emit_topo=False, tally=None):
    """Launch the kernel's instance `k1_instance` picks: K1 (shared or
    global memory) for at most LANES_MAX_M clusters, K3 (with the tables'
    tree) past that, each with the tables' group boxes. With `emit_topo`
    it also returns the codes as an (R, K) view of its (K, R_pad) buffer;
    `tally`, a zeroed (pc.TALLY_COUNTS,) int64 CUDA tensor, receives the
    casts, admitted cluster visits, slab tests, the cluster visits the
    casts need whatever the traversal (csrc/cast.cuh needed_visits), the
    sub-box tests, the groups scanned and K1's root skips (K1 counts in a
    second kernel of its instance, the same cull). Marks (utils.tracing) just
    before and after the launch end the phases `pack` (the rays packed,
    the codes filled) and `forward` (the kernel)."""
    from cutrace_tpu_torch.ops import _build

    global LAUNCHES, TOPO_LAUNCHES, GLOBAL_LAUNCHES, GLOBAL_TOPO_LAUNCHES
    global BIG_LAUNCHES, BIG_TOPO_LAUNCHES
    dev = tables.tri.device
    _check_rays(o, d, dev)
    r = o.shape[0]
    m, c = tables.tri.shape[:2]
    instance = k1_instance(soa, tables)
    for f in ("tri", "aabb", "sub", "plane", "sphere", "mat", "lights",
              "tree"):
        if getattr(tables, f).data_ptr() % 16:
            raise ValueError(f"tables.{f}: the kernel reads 16-byte rows; "
                             f"the tensor must start on a 16-byte boundary")
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
    codes = None
    if emit_topo:
        codes = _code_fill(soa, bounces, dev)[:, None].expand(
            -1, r_pad).contiguous()
    if tally is not None and (tally.dtype != torch.int64
                              or tuple(tally.shape) != (pc.TALLY_COUNTS,)
                              or tally.device != dev):
        raise ValueError(f"tally: expected a ({pc.TALLY_COUNTS},) int64 "
                         f"tensor on the card")

    # the shared-memory instance's work counter
    next_chunk = torch.zeros((1,), dtype=torch.int32, device=dev)
    lib = _build.load_library("fused_forward")
    tracing.mark("pack")
    rc = lib.cutrace_fused_forward(
        _ptr(rays), _ptr(tables.tri), _ptr(tables.aabb), _ptr(tables.plane),
        _ptr(tables.sphere), _ptr(tables.mat), _ptr(tables.lights),
        _ptr(tables.ambient), _ptr(out),
        r_pad, m, c, soa.n_planes, soa.n_spheres, soa.n_lights,
        tables.mat.shape[0], bounces, soa.shadow_steps,
        int(soa.any_reflective), int(soa.any_transparent), float(fudge),
        None if codes is None else _ptr(codes), soa.tri_p1.shape[0],
        soa.pl_point.shape[0], None if tally is None else _ptr(tally),
        _ptr(tables.tree) if instance == _K3 else None,
        tables.tree.shape[0] // 2, instance,
        _ptr(next_chunk) if instance == _K1_SHARED else None,
        _ptr(tables.sub),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"fused forward kernel launch failed: CUDA "
                           f"error {rc}")
    tracing.mark("forward")
    if codes is None:
        if instance == _K3:
            BIG_LAUNCHES += 1
        elif instance == _K1_SHARED:
            LAUNCHES += 1
        else:
            GLOBAL_LAUNCHES += 1
        return out[:r, 0:3], out[:r, 3], out[:r, 4:7]
    if instance == _K3:
        BIG_TOPO_LAUNCHES += 1
    elif instance == _K1_SHARED:
        TOPO_LAUNCHES += 1
    else:
        GLOBAL_TOPO_LAUNCHES += 1
    return out[:r, 0:3], out[:r, 3], out[:r, 4:7], codes[:, :r].T


@torch.no_grad()
def _forward(soa, accel, o, d, fudge, bounces, tables):
    """(color, depth, normal): the kernel on CUDA tensors (tables built
    here when None), the plain version on CPU tensors; either ends the
    phases `pack` and `forward`."""
    if o.is_cuda:
        if tables is None:
            tables = kernel_tables(soa, accel)
        return _fused_forward_cuda(soa, tables, o, d, fudge, bounces)
    if o.device.type != "cpu":
        raise ValueError(f"unsupported device {o.device}")
    tracing.mark("pack")
    out = fused_render_rays_plain(soa, accel, o, d, fudge, bounces)
    tracing.mark("forward")
    return out


@torch.no_grad()
def _forward_topo(soa, accel, o, d, fudge, bounces, tables):
    """(color, depth, normal, codes (R, K)): the kernel on CUDA tensors,
    the plain version and the plain emitter on CPU tensors; either ends
    the phases `tables` (built here when None), `pack` and `forward`."""
    if not replay_supported(soa, accel, bounces, n_rays=o.shape[0]):
        rows = rp.replay_rows(soa, bounces)
        raise NotImplementedError(
            f"topology codes for {o.shape[0]} rays at bounce depth "
            f"{bounces}: {rows} rows and {rows * o.shape[0] * 4} code bytes "
            f"against the replay's limits of {rp.REPLAY_MAX_ROWS} rows and "
            f"{rp.REPLAY_MAX_CODE_BYTES} bytes; a fit past them takes the "
            f"composable backward (fused_render_rays under autograd)")
    if o.is_cuda:
        if tables is None:
            tables = kernel_tables(soa, accel)
        tracing.mark("tables")
        return _fused_forward_cuda(soa, tables, o, d, fudge, bounces,
                                   emit_topo=True)
    if o.device.type != "cpu":
        raise ValueError(f"unsupported device {o.device}")
    tracing.mark("tables")
    tracing.mark("pack")
    out = (*fused_render_rays_plain(soa, accel, o, d, fudge, bounces),
           emit_topo_plain(soa, accel, o, d, fudge, bounces))
    tracing.mark("forward")
    return out


class _FusedRender(torch.autograd.Function):
    """The fused render with the replay backward. Differentiable inputs:
    the recentered packed table (N, 17), the light table (L, 8), ambient
    (1,), o and d: what the backward consumes. The forward emits the
    topology codes and saves them; the backward turns output cotangents
    into cotangents of those inputs (ops.replay_vjp.vjp_tables)."""

    @staticmethod
    def forward(ctx, table, lights, ambient, o, d, soa, accel, tables,
                fudge, bounces):
        *outs, codes = _forward_topo(soa, accel, o.detach(), d.detach(),
                                     fudge, bounces, tables)
        ctx.save_for_backward(table, lights, ambient, o, d, codes)
        ctx.soa, ctx.fudge, ctx.bounces = soa, fudge, bounces
        # the kernel's outputs are column views of one buffer: hand out
        # tensors of their own
        return tuple(x.contiguous() for x in outs)

    @staticmethod
    def backward(ctx, g_c, g_dep, g_n):
        table, lights, ambient, o, d, codes = ctx.saved_tensors
        grads = rv.vjp_tables(ctx.soa, table, lights, ambient, o, d, codes,
                              (g_c, g_dep, g_n), ctx.fudge, ctx.bounces)
        return (*grads, None, None, None, None, None)


def composable_rays(soa, accel, o, d, fudge, bounces: int):
    """The composable pipeline (render_rays) with the culling cast over
    `accel` (K4 on CUDA tensors), in ray chunks, each under
    torch.utils.checkpoint: a backward keeps only the chunks' inputs and
    recomputes one chunk's forward at a time. Chunks of 65536 rays, or
    max(4096, 65536 >> bounces) in two-branch trees, as the JAX package's
    composable backward takes them."""
    from torch.utils.checkpoint import checkpoint

    two_branch = soa.any_reflective and soa.any_transparent
    chunk = max(4096, 65536 >> bounces) if two_branch else 65536
    tc = bvh.candidates_fn(accel)

    def run(oo, dd):
        return render_rays(soa, oo, dd, bounces, fudge, tc)

    # the renderer draws no random numbers, so the recompute needs no RNG
    # state saved and restored (which no CUDA-graph capture holds)
    outs = [checkpoint(run, o[s:s + chunk], d[s:s + chunk],
                       use_reentrant=False, preserve_rng_state=False)
            for s in range(0, o.shape[0], chunk)]
    return tuple(torch.cat(x) for x in zip(*outs))


class _FusedRenderComposable(torch.autograd.Function):
    """The fused render past the replay's budgets. Differentiable inputs:
    o, d and the scene leaves of ops.replay_vjp.TABLE_FIELDS. The forward
    runs the kernel without codes; the backward differentiates
    `composable_rays` over the same partition at the saved inputs."""

    @staticmethod
    def forward(ctx, o, d, soa, accel, fudge, bounces, *leaves):
        outs = _forward(soa, accel, o.detach(), d.detach(), fudge, bounces,
                        None)
        ctx.save_for_backward(o, d, *leaves)
        ctx.soa, ctx.accel, ctx.fudge, ctx.bounces = soa, accel, fudge, bounces
        return tuple(x.contiguous() for x in outs)

    @staticmethod
    def backward(ctx, g_c, g_dep, g_n):
        o, d, *leaves = ctx.saved_tensors
        cot = rv._zeros_for_none((g_c, g_dep, g_n), o)
        with torch.enable_grad():
            ins = [x.detach().requires_grad_() for x in (o, d, *leaves)]
            soa = dataclasses.replace(
                ctx.soa, **dict(zip(rv.TABLE_FIELDS, ins[2:])))
            outs = composable_rays(soa, ctx.accel, ins[0], ins[1], ctx.fudge,
                                   ctx.bounces)
            grads = torch.autograd.grad(outs, ins, cot, allow_unused=True)
        return (grads[0], grads[1], None, None, None, None, *grads[2:])


def fused_render_rays(soa, accel, o, d, fudge, bounces: int,
                      emit_topo: bool = False, tables=None):
    """Fused render of explicit rays: (color (R,3), depth (R,),
    normal (R,3)), plus the (R, K) int32 topology codes with `emit_topo`.

    CUDA tensors launch the kernel (raising if it cannot) on `tables`, the
    scene's KernelTables (built here when None); CPU tensors run the plain
    version. When autograd asks for a gradient of the scene leaves or the
    rays, the call runs as an autograd Function: within the replay's
    budgets (replay_supported, replay_vjp.replay_vjp_supported) the forward
    emits codes and the backward replays them; past them the backward
    differentiates the composable pipeline with the culling cast. Its
    kernel tables are built here from the live leaves on every call, so
    pass no `tables` while training."""
    check_scope(soa, accel, bounces)
    if emit_topo:
        return _forward_topo(soa, accel, o, d, fudge, bounces, tables)
    leaves = [getattr(soa, f) for f in rv.TABLE_FIELDS]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (o, d, *leaves)):
        if (replay_supported(soa, accel, bounces, n_rays=o.shape[0])
                and rv.replay_vjp_supported(soa, bounces)):
            return _FusedRender.apply(*rv.backward_tables(soa), o, d, soa,
                                      accel, tables, float(fudge), bounces)
        return _FusedRenderComposable.apply(o, d, soa, accel, float(fudge),
                                            bounces, *leaves)
    return _forward(soa, accel, o, d, fudge, bounces, tables)
