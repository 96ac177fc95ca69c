"""Triangle clustering: host-side partition + live geometry (counterpart of
cutrace_tpu.ops.bvh).

build (host): recursively median-split triangle centroids along the widest
axis until at most `cluster_size` triangles remain; each leaf is one
cluster, padded to the uniform size. The native median split
(cutrace_tpu_torch.native.build_clusters) is used when it is built, with the
numpy recursion as the fallback; both give the same stable order.

The `Accel` stores only the PARTITION (which original triangle sits in
which cluster slot). Cluster geometry, AABBs and per-triangle constants are
gathered from the live scene tensors at render time
(`clusters_from_accel`), so an Accel can never render stale geometry.
`order` carries every triangle's original flat index, so nearest-hit ties
keep the reference's scan-order winner.

The cull kernels (csrc/cast.cuh) walk big partitions through a
hierarchy. Clusters are median-split leaves in tree order, so consecutive
clusters are spatially compact and their union box is tight: `tree_boxes`
builds a complete binary tree of such unions (the ordered walk of K3 and
of K4 past 32 clusters), widened by `widen_tree`. Below the clusters, K1
and K3 test a box per group of SUB_GROUP consecutive slots
(`sub_boxes`); a "fused" partition carries, in `Accel.slots`, the order
of each cluster's slots that makes those groups compact (`group_slots`:
the median split carried on down to groups), which only the kernels'
tables follow.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from cutrace_tpu_torch.ops import intersect as I
from cutrace_tpu_torch.scene.soa import resolve_device

CLUSTER_SIZE = 64
# Children per node of the cluster tree K3 walks (csrc/cast.cuh
# kTreeArity). Binary: the median split is binary, so the unions of
# sibling clusters are its own boxes; the walk orders two children with
# one compare, and its stack needs one slot per level (11 at 2048
# clusters).
TREE_ARITY = 2
# The tree's boxes are widened outward by this share of the scene's extent
# (the live clusters' union box, its longest side), so the ordered walk
# cannot cull a cluster whose triangle t rounds to before the cluster's
# own box entry (csrc/cast.cuh): float32 rounding of t and of a slab entry
# is about 1e-7 of the distances involved; 1e-4 covers grazing hits to a
# cosine of about 1e-3, and widens a 256k-triangle cluster (about 1/32 of
# the extent) by 0.3 %.
TREE_MARGIN = 1e-4
# Slots under one box of the level below the clusters (csrc/cast.cuh
# kSubSlots): a warp's 32 lanes test a group's slots in one step.
SUB_GROUP = 32
KINDS = ("clusters", "pallas", "fused")

_FAR = 1.0e8
_BIG = 2**30

# sentinel triangle for padding slots (matches scene/soa.py)
_SENT = ((_FAR, 0.0, 0.0), (_FAR, 64.0, 0.0), (_FAR, 0.0, 64.0))
_SENT_ON: dict = {}  # device -> _SENT as a (3, 3) float32 tensor


def _sentinel(device):
    """_SENT on `device`, made once per device: a dense cast gathers
    cluster geometry on every call, and a warm one copies nothing from the
    host."""
    sent = _SENT_ON.get(device)
    if sent is None:
        sent = _SENT_ON[device] = torch.tensor(_SENT, dtype=torch.float32,
                                               device=device)
    return sent


@dataclasses.dataclass(frozen=True)
class Accel:
    """Geometry-free cluster partition. `order[m, c]` is the original flat
    triangle index in slot c of cluster m (2**30 on padding slots);
    `valid` masks live slots. `kind` selects the triangle query of the
    composable path (`candidates_fn`): "clusters" the dense cast with no
    culling, "pallas" and "fused" the culling cast (K4); a "fused"
    partition also drives the fused kernels. `slots`, made with a
    "fused" partition, orders each cluster's slots for the kernels'
    tables (group_slots): row j of cluster m holds slot slots[m, j]; None
    keeps `order`'s slots."""

    order: torch.Tensor  # (M, C) i32
    valid: torch.Tensor  # (M, C) bool
    kind: str = "fused"
    slots: torch.Tensor | None = None  # (M, C) i64

    @functools.cached_property
    def table_rows(self):
        """(order, valid) of the kernels' table rows: each cluster's slots
        in the order `slots` gives them (`order`'s own without). Made once
        per Accel, as the partition is fixed: a training step's tables
        reuse them."""
        if self.slots is None:
            return self.order, self.valid
        return (self.order.gather(-1, self.slots),
                self.valid.gather(-1, self.slots))


def build_partition(centroids: np.ndarray, cluster_size: int):
    """Median-split leaf lists over triangle centroids (host). Returns a
    list of int arrays (original indices per cluster)."""
    from cutrace_tpu_torch import native

    nat = (
        native.build_clusters(centroids, cluster_size)
        if native.available()
        else None
    )
    if nat is not None:
        perm, starts, counts = nat
        return [perm[s : s + k] for s, k in zip(starts, counts)]

    leaves = []

    def split(idx):
        if len(idx) <= cluster_size:
            leaves.append(idx)
            return
        c = centroids[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = len(idx) // 2
        split(idx[order[:half]])
        split(idx[order[half:]])

    split(np.arange(len(centroids)))
    return leaves


def group_slots(centroids, valid):
    """(M, C) int64: each cluster's slots reordered so that every run of
    SUB_GROUP consecutive slots is spatially compact, from the (M, C, 3)
    float32 slot centroids and (M, C) valid mask, on their device:
    build_partition's median split carried on inside each cluster, a
    level at a time over every cluster at once, down to groups of
    SUB_GROUP (each run of slots sorted, stably, along the widest axis of
    its valid centroids, then split in halves; the slots padded to a power
    of two of groups). Invalid slots sort last, so they end a cluster."""
    m, c = valid.shape
    width = SUB_GROUP << max(-(-c // SUB_GROUP) - 1, 0).bit_length()
    pad = width - c
    pts = torch.nn.functional.pad(centroids, (0, 0, 0, pad))
    ok = torch.nn.functional.pad(valid, (0, pad))
    perm = torch.arange(width, device=valid.device).repeat(m, 1)
    run = width
    while run > SUB_GROUP:
        idx = perm.reshape(m, width // run, run)
        p = pts.gather(1, perm[..., None].expand(-1, -1, 3)).reshape(
            m, width // run, run, 3)
        v = ok.gather(1, perm).reshape(m, width // run, run)
        lo = torch.where(v[..., None], p, math.inf).amin(dim=2)
        hi = torch.where(v[..., None], p, -math.inf).amax(dim=2)
        axis = (hi - lo).argmax(dim=-1)[..., None, None]
        key = torch.where(
            v, p.gather(3, axis.expand(-1, -1, run, 1))[..., 0], math.inf)
        order = torch.sort(key, dim=2, stable=True).indices
        perm = idx.gather(2, order).reshape(m, width)
        run //= 2
    return perm[:, :c]


def accel_from_numpy(order, valid, device="cuda", kind="fused") -> Accel:
    """An Accel on `device` (the card unless the caller asks for the CPU)
    from numpy partition arrays (e.g. the JAX package's Accel leaves read
    back with np.asarray, and its kind)."""
    if kind not in KINDS:
        raise ValueError(f"unknown accel kind {kind!r}")
    dev = resolve_device(device)
    return Accel(
        order=torch.from_numpy(np.asarray(order, np.int32).copy()).to(dev),
        valid=torch.from_numpy(np.asarray(valid, bool).copy()).to(dev),
        kind=kind,
    )


def build_accel(soa, cluster_size: int = CLUSTER_SIZE,
                host_tris=None, kind: str = "fused",
                min_clusters: int = 0) -> Accel:
    """Partition the scene's triangles into an Accel on the scene's device.
    `host_tris` is an optional numpy `(p1, p2, p3, valid)` tuple
    (scene.soa.host_triangle_soup) that skips reading the triangles back
    from the device. `min_clusters` pads the cluster axis with empty
    clusters, so the partitions of equal triangle shards share one M
    (parallel.sharding.build_sharded_accel). A "fused" partition (K1's
    and K3's group boxes) also gets the order of each cluster's slots
    into compact groups for the kernels' tables (group_slots)."""
    if host_tris is not None:
        p1, p2, p3, valid = (np.asarray(a) for a in host_tris)
    else:
        p1, p2, p3, valid = (
            t.cpu().numpy()
            for t in (soa.tri_p1, soa.tri_p2, soa.tri_p3, soa.tri_valid)
        )
    centroids = (p1 + p2 + p3) / 3.0
    leaves = build_partition(centroids, cluster_size)
    m = max(len(leaves), min_clusters, 1)
    order = np.full((m, cluster_size), _BIG, np.int32)
    vmask = np.zeros((m, cluster_size), bool)
    for mi, idx in enumerate(leaves):
        order[mi, :len(idx)] = idx
        vmask[mi, :len(idx)] = valid[idx]
    accel = accel_from_numpy(order, vmask, soa.device, kind)
    if kind != "fused" or not len(centroids):
        return accel
    slot_cent = np.asarray(centroids, np.float32)[
        np.minimum(order, len(centroids) - 1)]
    slots = group_slots(torch.from_numpy(slot_cent), torch.from_numpy(vmask))
    return dataclasses.replace(accel, slots=slots.to(accel.order.device))


@dataclasses.dataclass(frozen=True)
class TriClusters:
    """Clustered triangle buffers: (M, C, ...) with per-cluster AABBs."""

    p1: torch.Tensor  # (M, C, 3) f32
    p2: torch.Tensor  # (M, C, 3) f32
    p3: torch.Tensor  # (M, C, 3) f32
    mat: torch.Tensor  # (M, C) i64
    obj: torch.Tensor  # (M, C) i64
    order: torch.Tensor  # (M, C) i64 original flat triangle index
    is_mesh: torch.Tensor  # (M, C) bool
    valid: torch.Tensor  # (M, C) bool
    bmin: torch.Tensor  # (M, 3) f32
    bmax: torch.Tensor  # (M, 3) f32


def clusters_from_accel(soa, accel: Accel) -> TriClusters:
    """Gather live cluster geometry from the scene tensors. Padding slots
    get the far-away sentinel triangle; an empty cluster gets a far-away
    point AABB that no ray hits."""
    t = soa.tri_p1.shape[0]
    idx = accel.order.to(torch.int64).clamp(0, t - 1)
    valid = accel.valid & soa.tri_valid[idx]
    v3 = valid[..., None]
    sent = _sentinel(idx.device)
    p1 = torch.where(v3, soa.tri_p1[idx], sent[0])
    p2 = torch.where(v3, soa.tri_p2[idx], sent[1])
    p3 = torch.where(v3, soa.tri_p3[idx], sent[2])

    pts_min = torch.minimum(torch.minimum(p1, p2), p3)
    pts_max = torch.maximum(torch.maximum(p1, p2), p3)
    bmin = torch.where(v3, pts_min, math.inf).amin(dim=1)
    bmax = torch.where(v3, pts_max, -math.inf).amax(dim=1)
    bmin = torch.where(torch.isfinite(bmin), bmin, _FAR)
    bmax = torch.where(torch.isfinite(bmax), bmax, _FAR)

    return TriClusters(
        p1=p1,
        p2=p2,
        p3=p3,
        mat=torch.where(valid, soa.tri_mat[idx].to(torch.int64), 0),
        obj=torch.where(valid, soa.tri_obj[idx].to(torch.int64), _BIG),
        order=torch.where(valid, accel.order.to(torch.int64), _BIG),
        is_mesh=valid & (soa.tri_mesh[idx] >= 0),
        valid=valid,
        bmin=bmin,
        bmax=bmax,
    )


def build_clusters(soa, cluster_size: int = CLUSTER_SIZE) -> TriClusters:
    """The host partition and the geometry gather in one call."""
    return clusters_from_accel(soa, build_accel(soa, cluster_size))


def tree_leaves(m: int) -> int:
    """Leaves of the complete binary tree over m clusters: the power of
    two at least m."""
    return 1 << max(m - 1, 0).bit_length()


def tree_boxes(bmin, bmax, live):
    """(2L, 8) rows [bmin xyz, bmax xyz, 0, 0] of a complete binary tree
    over the M clusters, L = tree_leaves(M), in heap order: row 1 is the
    root, node n's children are rows 2n and 2n + 1, rows L..L+M-1 are the
    (M, 3) cluster boxes; row 0 is unused (zero). Each node is the union
    of its children, built bottom up by pairs of consecutive clusters.
    Empty clusters (`live` False) and the padding leaves past M stay out
    of the unions; a node without a live cluster sits at the never-hit
    _FAR point, as an empty cluster does."""
    m = bmin.shape[0]
    pad = tree_leaves(m) - m
    live3 = torch.nn.functional.pad(live, (0, pad))[:, None]
    lo = torch.where(live3, torch.nn.functional.pad(bmin, (0, 0, 0, pad)),
                     math.inf)
    hi = torch.where(live3, torch.nn.functional.pad(bmax, (0, 0, 0, pad)),
                     -math.inf)
    los, his = [lo], [hi]
    while lo.shape[0] > 1:
        lo = lo.reshape(-1, TREE_ARITY, 3).amin(dim=1)
        hi = hi.reshape(-1, TREE_ARITY, 3).amax(dim=1)
        los.append(lo)
        his.append(hi)
    lo = torch.cat(los[::-1])
    hi = torch.cat(his[::-1])
    rows = torch.zeros((lo.shape[0] + 1, 8), dtype=torch.float32,
                       device=bmin.device)
    rows[1:, 0:3] = torch.where(torch.isfinite(lo), lo, _FAR)
    rows[1:, 3:6] = torch.where(torch.isfinite(hi), hi, _FAR)
    return rows


def widening(rows, margin: float = TREE_MARGIN):
    """How far `widen_tree` moves every face of `tree_boxes` rows outward:
    `margin` times the root box's longest side (0 when no cluster is
    live), a 0-d tensor."""
    root = rows[1]
    extent = (root[3:6] - root[0:3]).amax()
    return margin * extent


def widen_tree(rows, margin: float = TREE_MARGIN):
    """`tree_boxes` rows with every node widened outward by `widening`."""
    delta = widening(rows, margin)
    out = rows.clone()
    out[1:, 0:3] -= delta
    out[1:, 3:6] += delta
    return out


def sub_boxes(lo, hi, o0, delta):
    """(M, G, 8) rows [bmin xyz, bmax xyz, 0, 0] of each cluster's groups
    of SUB_GROUP consecutive slots, G = ceil(C / SUB_GROUP): the union of
    the (M, C, 3) corner boxes lo..hi of the group's valid slots (+inf
    and -inf at the others), recentered by o0 and widened outward by
    `delta` (the tree's `widening`). A group without a valid slot sits at
    the never-hit _FAR point, as an empty cluster does."""
    m, c, _ = lo.shape
    g = -(-c // SUB_GROUP)
    if g * SUB_GROUP != c:
        pad = (0, 0, 0, g * SUB_GROUP - c)
        lo = torch.nn.functional.pad(lo, pad, value=math.inf)
        hi = torch.nn.functional.pad(hi, pad, value=-math.inf)
    lo = lo.reshape(m, g, SUB_GROUP, 3).amin(dim=2) - o0 - delta
    hi = hi.reshape(m, g, SUB_GROUP, 3).amax(dim=2) - o0 + delta
    return torch.cat([torch.nan_to_num(lo, posinf=_FAR),
                      torch.nan_to_num(hi, neginf=_FAR),
                      lo.new_zeros((m, g, 2))], dim=-1)


def slab_entry(bmin, bmax, o, d):
    """AABB slab interval, (R,3) rays x (M,3) boxes -> ((R,M) tmin,
    (R,M) tmax), tmin clamped at 0. The box is hit iff tmin <= tmax, and
    tmin then bounds the t of any hit inside from below. NaN (0 * inf)
    takes the reference's fminf/fmaxf meaning. The cull kernels run the
    same test per ray themselves (csrc/cast.cuh slab); the tests hold the
    two-level cull's premise with this one."""
    inv = 1.0 / d
    t1 = (bmin[None, :, :] - o[:, None, :]) * inv[:, None, :]
    t2 = (bmax[None, :, :] - o[:, None, :]) * inv[:, None, :]
    lo = torch.fmin(t1, t2)
    hi = torch.fmax(t1, t2)
    tmin = torch.where(torch.isnan(lo), 0.0, lo).amax(dim=-1)
    tmax = torch.where(torch.isnan(hi), math.inf, hi).amin(dim=-1)
    return torch.clamp(tmin, min=0.0), tmax


def slab_test(bmin, bmax, o, d):
    """(R,3) rays x (M,3) boxes -> (R,M) bool hit mask (see slab_entry)."""
    tmin, tmax = slab_entry(bmin, bmax, o, d)
    return tmin <= tmax


@dataclasses.dataclass(frozen=True)
class _FlatView:
    """Clustered buffers flattened to one (M*C) triangle SoA whose
    `tri_obj` is the ORIGINAL flat index, so cast_triangles' tie-break
    reproduces scene order despite the cluster permutation."""

    tri_p1: torch.Tensor
    tri_p2: torch.Tensor
    tri_p3: torch.Tensor
    tri_obj: torch.Tensor
    tri_valid: torch.Tensor
    scene_center: torch.Tensor


def _offset_order(order, order_base):
    """Offset live order keys by a shard's base, keeping the miss sentinel
    at _BIG."""
    if isinstance(order_base, int) and order_base == 0:
        return order
    return torch.where(order >= _BIG, _BIG, order + order_base)


def cluster_candidates(soa, accel: Accel, o, d, min_dist, o0, order_base=0):
    """Dense masked cast over the clustered buffers, with no culling: the
    plain reference for the fused kernel, restricted to the same
    partition. `order_base` offsets the winner's order key (a triangle
    shard's first global index)."""
    clusters = clusters_from_accel(soa, accel)
    m, c = clusters.mat.shape
    flat = _FlatView(
        tri_p1=clusters.p1.reshape(m * c, 3),
        tri_p2=clusters.p2.reshape(m * c, 3),
        tri_p3=clusters.p3.reshape(m * c, 3),
        tri_obj=clusters.order.reshape(m * c),
        tri_valid=clusters.valid.reshape(m * c),
        scene_center=soa.scene_center,
    )
    t, idx = I.cast_triangles(flat, o, d, min_dist, o0)
    return I.TriCandidate(
        t=t,
        obj=clusters.obj.reshape(m * c)[idx],
        order=_offset_order(clusters.order.reshape(m * c)[idx], order_base),
        mat=clusters.mat.reshape(m * c)[idx],
        is_mesh=clusters.is_mesh.reshape(m * c)[idx],
        p1=flat.tri_p1[idx],
        p2=flat.tri_p2[idx],
        p3=flat.tri_p3[idx],
    )


def dense_candidates_fn(accel, order_base=0):
    """A ray_cast `tri_candidates` callable running the dense cast over
    `accel`'s clusters whatever its kind: the plain versions' query
    (`order_base` as cluster_candidates')."""

    def provider(soa, o, d, min_dist, o0):
        return cluster_candidates(soa, accel, o, d, min_dist, o0, order_base)

    return provider


def candidates_fn(accel, tables=None, order_base=0):
    """A ray_cast `tri_candidates` callable bound to `accel` (None -> None,
    the brute-force scan): the dense cast for a "clusters" partition, the
    culling cast (ops.pallas_cast.culling_provider, K4 on CUDA tensors)
    for "pallas" and "fused" ones. `tables`, the scene's cached
    ops.pallas_cast.ClusterTables, serves casts that need no gradient;
    `order_base` offsets the winners' order keys (a triangle shard's
    first global index)."""
    if accel is None:
        return None
    if accel.kind == "clusters":
        return dense_candidates_fn(accel, order_base)
    if accel.kind not in KINDS:
        raise ValueError(f"unknown accel kind {accel.kind!r}")
    from cutrace_tpu_torch.ops.pallas_cast import culling_provider

    return culling_provider(accel, tables, order_base)


def accel_candidates(soa, accel: Accel, o, d, min_dist, o0, order_base=0):
    """The triangle query of an Accel for one cast: candidates_fn's
    provider, called once."""
    return candidates_fn(accel, order_base=order_base)(soa, o, d, min_dist,
                                                       o0)
