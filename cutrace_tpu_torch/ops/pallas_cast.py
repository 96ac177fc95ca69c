"""The cluster-culled nearest-triangle query (counterpart of
cutrace_tpu.ops.pallas_cast).

`cast_clusters` returns, per ray, the (t, original index) nearest triangle
with t > min_dist over a cluster partition: on CUDA tensors through the
hand-written Hopper kernel in `csrc/cluster_cast.cu` (K4), whose warps walk
the clusters together, each ray culling against its own best t (the flat
loop over at most FLAT_MAX_M clusters, the ordered walk over the cluster
tree past that: `k4_instance` decides before the launch); on CPU tensors
through `cast_clusters_plain`, the dense cast over every slot. Ties go to
the smallest original index, as the reference's scan order does.

`pallas_candidates` is the ray_cast triangle query built on it: the kernel
picks only the winner (no gradient), then the winner's vertices are
gathered from the live `tri_*` leaves and t is re-derived with plain torch
ops, so autograd reaches the vertices with no custom backward.

Both read the per-slot rows `cluster_tables` builds from the scene and its
partition (the (M, C, 24) triangle table of the fused kernels, whose first
18 rows are the cast constants of `_cluster_constants`, the cluster boxes
and the widened tree boxes of ops.bvh.tree_boxes, which K3 and K4 walk,
and for the fused kernels the widened boxes of each cluster's groups of
32 slots, ops.bvh.sub_boxes, which K1 and K3 test), all positions
recentered by the scene center.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from cutrace_tpu_torch.ops import bvh
from cutrace_tpu_torch.ops import intersect as I

# Kernel launches on CUDA tensors since import, or since a caller last
# reset it.
LAUNCHES = 0
# Partitions of at most this many clusters take the kernel's flat loop,
# bigger ones its tree walk; the fused kernels split K1 from K3 here too
# (ops.fused.LANES_MAX_M).
FLAT_MAX_M = 32
# The kernel's instances (csrc/cluster_cast.cu kInstance*).
_K4_FLAT, _K4_TREE = 0, 1
# Counts of a kernel tally (csrc/cast.cuh Tally, kTallyCounts): casts,
# admitted cluster visits, slab tests (root, cluster and tree boxes),
# needed visits, sub-box slab tests and groups whose slots were tested
# (these two K1's and K3's alone), and casts that failed the root box test
# (K1's alone).
TALLY_COUNTS = 7

_BIG = 2**30
# per-slot rows of the (M, C, _TRI_ROWS) triangle table; row 23 is zero.
# csrc/cast.cuh reads the same offsets (its T_* constants).
_TRI_NAMES = (
    "n0", "n1", "n2", "ub0", "ub1", "ub2", "ug0", "ug1", "ug2",
    "a0", "a1", "a2", "b0", "b1", "b2", "k", "order", "valid",
    "snx", "sny", "snz", "obj", "mat",
)
_TRI_ROWS = 24
# the rows the query reads
_CONST_NAMES = _TRI_NAMES[:18]
# (M, 8) cluster boxes and (2L, 8) tree boxes: bmin xyz, bmax xyz, 0, 0
_AABB_ROWS = 8
# (rays x slots) elements per batch of the plain version
_PLAIN_ELEMS = 1 << 22


def _cluster_constants(c: bvh.TriClusters, o0):
    """Per-triangle intersection constants recentered by o0: dict of
    (M, C) tensors."""
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
class ClusterTables:
    """A partition's rows for the cluster loops: contiguous float32 tensors
    on the scene's device, positions recentered by the scene center."""

    tri: torch.Tensor  # (M, C, _TRI_ROWS) per-slot rows
    aabb: torch.Tensor  # (M, _AABB_ROWS) cluster boxes
    tree: torch.Tensor  # (2 * bvh.tree_leaves(M), _AABB_ROWS) widened tree
    # (M, ceil(C / bvh.SUB_GROUP), _AABB_ROWS) widened group boxes of the
    # fused kernels' tables, else None
    sub: torch.Tensor | None = dataclasses.field(default=None, kw_only=True)


@torch.no_grad()
def cluster_tables(soa, accel, sub: bool = False) -> ClusterTables:
    """The partition's slot rows and boxes, gathered from the live scene
    tensors. The slots of each cluster follow `accel.slots` when it has
    them (compact groups; every row keeps its original index). With `sub`
    (the fused kernels' tables) each group of bvh.SUB_GROUP slots gets a
    box, widened as the tree is."""
    o0 = soa.scene_center
    f32 = torch.float32
    if accel.slots is not None:
        order, valid = accel.table_rows
        accel = dataclasses.replace(accel, order=order, valid=valid,
                                    slots=None)
    clusters = bvh.clusters_from_accel(soa, accel)
    rows = _cluster_constants(clusters, o0)
    sn = -torch.linalg.cross(clusters.p2 - clusters.p3,
                             clusters.p1 - clusters.p3)
    sn = sn / torch.sqrt((sn * sn).sum(-1, keepdim=True))
    rows.update(snx=sn[..., 0], sny=sn[..., 1], snz=sn[..., 2],
                obj=clusters.obj, mat=clusters.mat)
    m, c = clusters.valid.shape
    tri = torch.zeros((m, c, _TRI_ROWS), dtype=f32, device=o0.device)
    tri[..., :len(_TRI_NAMES)] = torch.stack(
        [rows[k].to(f32) for k in _TRI_NAMES], dim=-1)
    bmin, bmax = clusters.bmin - o0, clusters.bmax - o0
    aabb = torch.zeros((m, _AABB_ROWS), dtype=f32, device=o0.device)
    aabb[:, 0:3] = bmin
    aabb[:, 3:6] = bmax
    live = clusters.valid.any(dim=1)
    tree = bvh.tree_boxes(bmin, bmax, live)
    boxes = None
    if sub:
        v3 = clusters.valid[..., None]
        corners = torch.stack([clusters.p1, clusters.p2, clusters.p3])
        boxes = bvh.sub_boxes(torch.where(v3, corners.amin(dim=0), math.inf),
                              torch.where(v3, corners.amax(dim=0), -math.inf),
                              o0, bvh.widening(tree))
    return ClusterTables(tri=tri, aabb=aabb, tree=bvh.widen_tree(tree),
                         sub=boxes)


@torch.no_grad()
def cast_clusters_plain(tables, o, d, min_dist):
    """The plain version of the kernel: the dense cast over every slot of
    `tables` (a ClusterTables, such as ops.fused.KernelTables), with the JAX
    kernel's arithmetic, in ray batches of about 2^22 (ray, slot) pairs.
    o is recentered (o - o0). Returns (t (R,), order (R,) int32)."""
    tri = tables.tri.reshape(-1, _TRI_ROWS)
    col = {name: tri[:, i][None, :] for i, name in enumerate(_CONST_NAMES)}
    order = col["order"].to(torch.int32)
    chunk = max(1, _PLAIN_ELEMS // tri.shape[0])
    ts, orders = [], []
    for s in range(0, o.shape[0], chunk):
        ox, oy, oz = (o[s:s + chunk, i:i + 1] for i in range(3))
        dx, dy, dz = (d[s:s + chunk, i:i + 1] for i in range(3))
        md = min_dist[s:s + chunk, None]
        wx = dy * oz - dz * oy
        wy = dz * ox - dx * oz
        wz = dx * oy - dy * ox
        alpha = dx * col["n0"] + dy * col["n1"] + dz * col["n2"]
        beta_n = (dx * col["ub0"] + dy * col["ub1"] + dz * col["ub2"]
                  - (wx * col["b0"] + wy * col["b1"] + wz * col["b2"]))
        gamma_n = (wx * col["a0"] + wy * col["a1"] + wz * col["a2"]
                   - (dx * col["ug0"] + dy * col["ug1"] + dz * col["ug2"]))
        t_n = col["k"] - (ox * col["n0"] + oy * col["n1"] + oz * col["n2"])
        degenerate = alpha == 0.0
        inv = 1.0 / torch.where(degenerate, 1.0, alpha)
        beta = beta_n * inv
        gamma = gamma_n * inv
        t = t_n * inv
        valid = (~degenerate & (beta >= 0.0) & (gamma >= 0.0)
                 & (beta + gamma <= 1.0) & torch.isfinite(t) & (t > md)
                 & (col["valid"] > 0.0))
        t = torch.where(valid, t, torch.inf)
        tmin = t.min(dim=1, keepdim=True).values
        key = torch.where(t == tmin, order, _BIG).min(dim=1).values
        tmin = tmin[:, 0]
        ts.append(tmin)
        orders.append(torch.where(torch.isfinite(tmin), key, _BIG))
    if not ts:
        return (torch.empty((0,), dtype=torch.float32, device=o.device),
                torch.empty((0,), dtype=torch.int32, device=o.device))
    return torch.cat(ts), torch.cat(orders).to(torch.int32)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def k4_instance(tables) -> int:
    """Which instance runs a partition, decided before the launch: the
    flat loop over at most FLAT_MAX_M clusters, the tree walk past it."""
    return _K4_TREE if tables.tri.shape[0] > FLAT_MAX_M else _K4_FLAT


@torch.no_grad()
def _cast_clusters_cuda(tables, o, d, min_dist, tally=None):
    """Launch the kernel; `tally`, a zeroed (TALLY_COUNTS,) int64 CUDA
    tensor, receives the casts, admitted cluster visits, slab tests and
    the cluster visits the casts need (those whose box the ray enters by
    its winner's t); its sub-box counts stay 0."""
    from cutrace_tpu_torch.ops import _build

    global LAUNCHES
    dev = tables.tri.device
    r = o.shape[0]
    for name, t, shape in (("o", o, (r, 3)), ("d", d, (r, 3)),
                           ("min_dist", min_dist, (r,))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != dev):
            raise ValueError(f"{name}: expected float32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if tally is not None and (tally.dtype != torch.int64
                              or tuple(tally.shape) != (TALLY_COUNTS,)
                              or tally.device != dev):
        raise ValueError(f"tally: expected a ({TALLY_COUNTS},) int64 tensor "
                         f"on the card")
    for f in ("tri", "aabb", "tree"):
        if getattr(tables, f).data_ptr() % 16:
            raise ValueError(f"tables.{f}: the kernel reads 16-byte rows; "
                             f"the tensor must start on a 16-byte boundary")
    m, c = tables.tri.shape[:2]
    instance = k4_instance(tables)
    rays = torch.zeros((r, 8), dtype=torch.float32, device=dev)
    rays[:, 0:3] = o
    rays[:, 3:6] = d
    rays[:, 6] = min_dist
    t_out = torch.empty((r,), dtype=torch.float32, device=dev)
    ord_out = torch.empty((r,), dtype=torch.int32, device=dev)
    lib = _build.load_library("cluster_cast")
    rc = lib.cutrace_cluster_cast(
        _ptr(rays), _ptr(tables.tri), _ptr(tables.aabb), _ptr(tables.tree),
        _ptr(t_out), _ptr(ord_out), r, m, c, tables.tree.shape[0] // 2,
        instance, None if tally is None else _ptr(tally),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"cluster cast kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return t_out, ord_out


def cast_clusters(tables, o, d, min_dist, tally=None):
    """Per ray, the (t, original index) nearest triangle with t > min_dist
    over the partition of `tables`: (t (R,), order (R,) int32), t = +inf
    and order = 2^30 on a miss. o is recentered (o - o0); min_dist is (R,).
    CUDA tensors launch the kernel, CPU tensors run the plain version."""
    if o.is_cuda:
        return _cast_clusters_cuda(tables, o, d, min_dist, tally)
    if o.device.type != "cpu":
        raise ValueError(f"unsupported device {o.device}")
    return cast_clusters_plain(tables, o, d, min_dist)


def pallas_candidates(soa, accel, o, d, min_dist, o0, tables=None,
                      order_base=0):
    """ray_cast triangle query backed by the culling cast over `accel`.
    `tables` (the partition's ClusterTables, or KernelTables) are built
    from the live leaves when None. The kernel picks only the winner's
    original index; its vertices are then gathered from soa.tri_p1/p2/p3
    and t re-derived differentiably, so gradients reach the vertices as in
    the brute-force path. The kernel returns shard-local orders;
    `order_base` (a triangle shard's first global index) is added after
    the launch, the miss sentinel kept."""
    if tables is None:
        tables = cluster_tables(soa, accel)
    with torch.no_grad():
        _, order = cast_clusters(tables, (o - o0).detach(), d.detach(),
                                 min_dist.detach())
    miss = order >= _BIG
    tcount = soa.tri_p1.shape[0]
    safe = torch.where(miss, 0, order).to(torch.int64).clamp(0, tcount - 1)
    p1, p2, p3 = soa.tri_p1[safe], soa.tri_p2[safe], soa.tri_p3[safe]
    op = o - o0
    a = (p2 - o0) - (p1 - o0)
    b = (p2 - o0) - (p3 - o0)
    n = torch.linalg.cross(a, b)
    alpha = (d * n).sum(-1)
    t_n = (((p2 - o0) - op) * n).sum(-1)
    t = t_n / torch.where(alpha == 0.0, 1.0, alpha)
    t = torch.where(miss | (alpha == 0.0), torch.inf, t)
    i64 = torch.int64
    return I.TriCandidate(
        t=t,
        obj=torch.where(miss, _BIG, soa.tri_obj[safe].to(i64)),
        order=bvh._offset_order(torch.where(miss, _BIG, order.to(i64)),
                                order_base),
        mat=torch.where(miss, 0, soa.tri_mat[safe].to(i64)),
        is_mesh=(soa.tri_mesh[safe] >= 0) & ~miss,
        p1=p1,
        p2=p2,
        p3=p3,
    )


def culling_provider(accel, tables=None, order_base=0):
    """A ray_cast `tri_candidates` callable over `accel` through
    pallas_candidates (`order_base` as there). Without `tables` it builds
    them from the live leaves of the scene it is handed, once per scene
    object: one render hands every cast the same scene."""
    cache = {}

    def provider(soa, o, d, min_dist, o0):
        tabs = tables
        if tabs is None:
            if cache.get("soa") is not soa:
                cache.update(soa=soa, tables=cluster_tables(soa, accel))
            tabs = cache["tables"]
        return pallas_candidates(soa, accel, o, d, min_dist, o0, tabs,
                                 order_base)

    return provider
