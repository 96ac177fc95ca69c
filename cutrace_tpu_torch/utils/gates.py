"""The forward gate: a kernel's images against its plain version's (the
gate of tests/test_fused.py _compare), on the host in numpy.

Two (H, W[, 3]) images agree where isclose(atol=ATOL) holds (misses on
both sides agree). A mismatch is allowed only on the reference image's
discontinuities (`discontinuity_mask`, the mask of
tests/test_device_renderer.py), and on at most EDGE_BUDGET of those
pixels (EDGE_BUDGET_SUBDIVIDED for subdivided meshes): float rounding may
flip a knife-edge winner there. Used by chip_smoke.py.
"""

from __future__ import annotations

import numpy as np

ATOL = 2e-4
EDGE_BUDGET = 0.05
# a subdivided mesh against its own K1/plain render, or across subdivision:
# tests/test_fused.py:173-188's edge budget
EDGE_BUDGET_SUBDIVIDED = 0.10


def dilate(g, n):
    """An (H, W) mask grown n times by its 4-neighbours."""
    for _ in range(n):
        g2 = g.copy()
        g2[1:, :] |= g[:-1, :]
        g2[:-1, :] |= g[1:, :]
        g2[:, 1:] |= g[:, :-1]
        g2[:, :-1] |= g[:, 1:]
        g = g2
    return g


def discontinuity_mask(ref_img, thr=1e-3):
    """Pixels adjacent to a local jump in the reference image (the same
    mask as tests/test_device_renderer.py discontinuity_mask)."""
    v = ref_img if ref_img.ndim == 2 else np.linalg.norm(ref_img, axis=-1)
    v = np.nan_to_num(v, posinf=1e9, neginf=-1e9)
    g = np.zeros(v.shape, bool)
    dx = np.abs(np.diff(v, axis=1)) > thr
    dy = np.abs(np.diff(v, axis=0)) > thr
    g[:, 1:] |= dx
    g[:, :-1] |= dx
    g[1:, :] |= dy
    g[:-1, :] |= dy
    return dilate(g, 1)


def code_edges(codes_img):
    """Pixels next to a change of any topology code row between
    neighbours, in an (H, W, K) code image: where a winner, an occlusion
    flag or a march occluder changes, float rounding may flip it."""
    g = np.zeros(codes_img.shape[:2], bool)
    dx = (np.diff(codes_img, axis=1) != 0).any(-1)
    dy = (np.diff(codes_img, axis=0) != 0).any(-1)
    g[:, 1:] |= dx
    g[:, :-1] |= dx
    g[1:, :] |= dy
    g[:-1, :] |= dy
    return dilate(g, 1)


def mismatch(a, b):
    """(H, W) pixels of two (H, W[, 3]) images outside isclose(atol=ATOL)
    (misses on both sides agree)."""
    ok = np.isclose(a, b, atol=ATOL) | (np.isinf(a) & np.isinf(b))
    return ~ok.reshape(a.shape[0], a.shape[1], -1).all(-1)


def gate(base, out, extra_edges=None):
    """Per-buffer (off-edge mismatches, edge mismatches, edge pixels,
    off-edge max |error|) under the _compare gate; `base` is the plain
    version's (color, depth, normal) images; `extra_edges` joins the
    discontinuity mask."""
    stats = {}
    for name, a, b in zip(("color", "depth", "normal"), base, out):
        bad = mismatch(a, b)
        edges = discontinuity_mask(a)
        if extra_edges is not None:
            edges = edges | extra_edges
        off = ~edges
        both = np.isfinite(a) & np.isfinite(b)
        with np.errstate(invalid="ignore"):
            err = np.where(both, np.abs(a - b), 0.0)
        err = err.reshape(a.shape[0], a.shape[1], -1).max(-1)
        stats[name] = (int((bad & off).sum()), int((bad & edges).sum()),
                       int(edges.sum()), float(err[off].max(initial=0.0)))
    return stats


def passes(stats, edge_budget=EDGE_BUDGET):
    """Does a `gate` result pass: no mismatch off the edges and at most
    `edge_budget` of the edge pixels over, in every buffer?"""
    return all(off == 0 and on <= edge_budget * max(n_edges, 1)
               for off, on, n_edges, _ in stats.values())
