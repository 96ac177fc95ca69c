"""The least time the card could take for a frame's or a step's work, from
the work the reference counts: a frozen table of the card's peaks and of
the float operations of each test.

A bound is max(bytes / PEAK_BYTES, operations / PEAK_F32). Bytes are
counted once each: rays in, images (or their cotangents) out, the scene's
tables read once. Operations are counted per cast the frame's rays need
(Counts of portbench.reference.tracer on a seeded sample of pixels, scaled
to the frame): its plane and sphere tests and its set-up, and one
triangle test for each triangle whose own box the cast's segment enters
before its hit. The replay backward counts the same reference's tree
nodes that hit and their lights. So the bound reads the same work
whatever implements it; a kernel's share of it is bound / its time.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at 700 W: HBM bytes/s, float32 FLOP/s
# outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# Float operations of one test (a multiply and an add count two): a
# triangle test, a plane test, a sphere test, a cast's set-up; the replay
# backward's per hit node and per (node, light), forward and reverse
# sweeps together.
OPS_TRI, OPS_PLANE, OPS_SPHERE, OPS_CAST = 38, 12, 30, 20
OPS_VJP_NODE, OPS_VJP_LIGHT = 310, 180
F32 = 4


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32)


def table_bytes(n_tris: int, n_planes: int, n_spheres: int, n_mats: int,
                n_lights: int) -> int:
    """The scene's tables, once: corners, plane point and normal, sphere
    center and radius, five material and seven light numbers."""
    return F32 * (9 * n_tris + 6 * n_planes + 4 * n_spheres + 5 * n_mats
                  + 7 * n_lights + 1)


def forward_bound_s(counts, scale: float, n_rays: int, tables: int,
                    n_planes: int, n_spheres: int) -> float:
    """A frame's forward: rays in (origin, direction), color, depth and
    normal out, the tables once, against the casts the reference counted
    on its sample (times `scale`, the frame's pixels over the sample's)."""
    ops = scale * (counts.casts * (OPS_CAST + n_planes * OPS_PLANE
                                   + n_spheres * OPS_SPHERE)
                   + counts.tri_boxes * OPS_TRI)
    return bound_s(n_rays * 13 * F32 + tables, ops)


def backward_bound_s(counts, scale: float, n_rays: int, tables: int,
                     n_lights: int) -> float:
    """The replay backward: rays and the color's cotangent in, the rays'
    cotangents out, the tables read and their cotangents written, against
    the hit nodes and their lights the reference counted."""
    ops = scale * counts.hit_nodes * (OPS_VJP_NODE + n_lights * OPS_VJP_LIGHT)
    return bound_s(n_rays * 15 * F32 + 2 * tables, ops)
