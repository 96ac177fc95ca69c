"""The least time the card could take for a kernel's work: bytes at the
memory rate against float operations at the float32 rate.

A bound is max(bytes / PEAK_BYTES, operations / PEAK_F32) for the work of
one launch: every input read once and every output written once, and the
operations these inputs need (counted from the CUDA sources, per unit of
work the kernel's tally or the topology codes count). A kernel's share of
its bound is bound / measured time. Used by chip_smoke.py, and by
cutrace_tpu_torch.parallel.multihost for `tally_of`.
"""

from __future__ import annotations

import torch

from cutrace_tpu_torch.ops.bvh import SUB_GROUP
from cutrace_tpu_torch.ops.pallas_cast import TALLY_COUNTS

# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM bytes/s,
# float32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# Float operations per unit of work, counted from the CUDA sources (a
# multiply and an add count two): the forward kernel's triangle slot test
# (tri_t), AABB slab test, plane and sphere tests, per-cast setup; the
# replay backward's per live hit node, per (node, light) and per counted
# march step, forward and reverse sweeps together.
OPS_TRI_SLOT, OPS_SLAB, OPS_PLANE, OPS_SPHERE, OPS_CAST = 38, 24, 12, 30, 20
OPS_VJP_NODE, OPS_VJP_LIGHT, OPS_VJP_STEP = 310, 180, 60


def bound(nbytes, ops):
    """(bound ms, what bounds it: "bytes" or "operations") of `nbytes`
    moved and `ops` float32 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def forward_bound(soa, accel, tables, n_rays, tally, code_rows):
    """Two (bound ms, what bounds it) of one forward launch: the bytes it
    must move (rays, scene tables, outputs, codes) at the card's memory
    rate against float operations at its float32 rate. "bound": the
    operations these inputs need whatever the traversal: per cast, its
    plane and sphere tests and C slot tests for each cluster it needs
    (the tally's needed visits: clusters entered by the final winner's t,
    or before the light). "bound_admitted": the kernel's own work, its
    slab tests, its sub-box tests and the slots it tested (SUB_GROUP a
    group scanned), and the group boxes and a tree walk's tree boxes
    among the bytes, which a better cull lowers."""
    m, c = accel.order.shape
    names = ["tri", "aabb", "plane", "sphere", "mat", "lights", "ambient"]
    table_bytes = sum(getattr(tables, f).numel() * 4 for f in names)
    nbytes = n_rays * (8 + 7 + code_rows) * 4 + table_bytes
    casts, _, slabs, needed, sub_slabs, groups, _ = (
        int(x) for x in tally.tolist())
    per_cast = (soa.n_planes * OPS_PLANE + soa.n_spheres * OPS_SPHERE
                + OPS_CAST)
    walk_bytes = (tables.sub.numel()
                  + (tables.tree.numel() if m > 32 else 0)) * 4
    return {"bound": bound(nbytes, needed * c * OPS_TRI_SLOT
                           + casts * per_cast),
            "bound_admitted": bound(
                nbytes + walk_bytes,
                groups * SUB_GROUP * OPS_TRI_SLOT
                + (slabs + sub_slabs) * OPS_SLAB + casts * per_cast)}


def cast_bound(tables, n_rays, tally):
    """Two (bound ms, what bounds it) of one culling-cast launch: rays in,
    t and order out and the 18 cast rows of the slot table plus the
    cluster boxes, against the float operations of the cluster visits
    the casts need ("bound"), or ("bound_admitted") of the kernel's own
    slab tests and admitted visits (the tree boxes of a tree walk among
    the bytes)."""
    m, c = tables.tri.shape[:2]
    nbytes = n_rays * (8 + 2) * 4 + m * c * 18 * 4 + tables.aabb.numel() * 4
    casts, visits, slabs, needed = (int(x) for x in tally.tolist()[:4])
    return {"bound": bound(nbytes, needed * c * OPS_TRI_SLOT
                           + casts * OPS_CAST),
            "bound_admitted": bound(
                nbytes + (tables.tree.numel() * 4 if m > 32 else 0),
                visits * c * OPS_TRI_SLOT + slabs * OPS_SLAB
                + casts * OPS_CAST)}


def vjp_bound(soa, codes, bounces):
    """(bound ms, what bounds it) of one replay-backward launch: rays,
    codes, cotangents, table and their cotangents at the memory rate,
    against the float operations of this run's live hit nodes, their
    lights and the counted march steps at the float32 rate."""
    from cutrace_tpu_torch.ops import replay as rp

    r, k = codes.shape
    _, nodes = rp.topo_layout(bounces, soa.any_reflective,
                              soa.any_transparent, soa.n_lights,
                              soa.shadow_steps)
    cast_rows = [cr for _, cr, _ in nodes]
    hit_nodes = int((codes[:, cast_rows] >= 0).sum())
    steps = 0
    if soa.any_transparent:
        march = torch.ones(k, dtype=torch.bool, device=codes.device)
        march[cast_rows] = False
        steps = int((codes[:, march] >= 0).sum())
    n_tab = (soa.tri_p1.shape[0] + soa.pl_point.shape[0]
             + soa.sp_center.shape[0])
    nbytes = r * (8 + k + 8 + 8) * 4 + 2 * n_tab * 17 * 4
    ops = (hit_nodes * (OPS_VJP_NODE + soa.n_lights * OPS_VJP_LIGHT)
           + steps * OPS_VJP_STEP)
    return bound(nbytes, ops)


def tally_of(fn, device="cuda"):
    """Run fn(tally) on a zeroed (TALLY_COUNTS,) int64 tally on `device`
    (a kernel wrapper's `tally=`: casts, admitted visits, slab tests,
    needed visits, sub-box tests, groups scanned, root skips); return it
    once the card is done."""
    tally = torch.zeros(TALLY_COUNTS, dtype=torch.int64, device=device)
    fn(tally)
    if tally.is_cuda:
        torch.cuda.synchronize(tally.device)
    return tally
