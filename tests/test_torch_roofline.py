"""The roofline bounds and the forward gate (cutrace_tpu_torch.utils.
roofline, utils.gates): chip_smoke.py takes them from the package, and
each bound is the formula written out here on CPU tables and a hand-made
tally."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from cutrace_tpu_torch.bigscene import subdivided_bunny
from cutrace_tpu_torch.ops import fused as tfused
from cutrace_tpu_torch.ops import pallas_cast as tpc
from cutrace_tpu_torch.ops import replay as treplay
from cutrace_tpu_torch.render.renderer import block_rays, prepare
from cutrace_tpu_torch.scene.loader import load_scene
from cutrace_tpu_torch.utils import gates, roofline

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12  # H100 SXM: HBM bytes/s, f32 FLOP/s


def _chip_smoke():
    """chip_smoke.py imported as a module (its main not run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ms(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _prepared(name, w, h, levels=0):
    if levels:
        sc, _ = subdivided_bunny(levels, w, h)
    else:
        sc = load_scene(str(REPO / "scenes" / name))
        sc.camera.width, sc.camera.height = w, h
    return prepare(sc, accel="fused", device="cpu")


@pytest.mark.parametrize("module, names", [
    (roofline, ("forward_bound", "cast_bound", "vjp_bound", "tally_of")),
    (gates, ("gate", "discontinuity_mask", "code_edges", "mismatch",
             "dilate", "ATOL", "EDGE_BUDGET", "EDGE_BUDGET_SUBDIVIDED"))])
def test_chip_smoke_takes_the_package_helpers(module, names):
    """chip_smoke.py holds no copy of the bounds, the card's peaks or the
    gate: its names are the package's own objects."""
    smoke = _chip_smoke()
    for name in names:
        assert getattr(smoke, name) is getattr(module, name), name
    for name in ("PEAK_BYTES", "PEAK_F32", "OPS_TRI_SLOT", "_bound"):
        assert not hasattr(smoke, name), name
    assert roofline.PEAK_BYTES == PEAK_BYTES
    assert roofline.PEAK_F32 == PEAK_F32


@pytest.mark.parametrize("levels, code_rows", [(0, 0), (0, 7), (2, 0)])
def test_forward_bound_is_its_formula(levels, code_rows):
    """One forward launch's two bounds on CPU tables (the bunny, C=64
    M=16, whose group boxes count among the admitted bytes; the 16k
    bunny, C=256 M=64, whose tree and group boxes do) and a hand-made
    tally: bytes of rays, outputs, codes and the seven tables; operations
    of the needed cluster visits' slot tests, or of the slots tested (32
    a group scanned in K1's and K3's sub-box visits), the slab tests (K1's
    root box tests among them) and sub-box tests and each cast's planes,
    spheres and set-up; K1's root skips add nothing."""
    p = _prepared("bunny.json", 16, 9, levels)
    soa, accel = p.soa, p.accel
    tables = tfused.kernel_tables(soa, accel)
    m, c = accel.order.shape
    casts, visits, slabs, needed = 1200, 5300, 9100, 2100
    sub_slabs, groups = (42400, 9000) if levels else (10600, 6100)
    root_skips = 0 if levels else 700
    tally = torch.tensor([casts, visits, slabs, needed, sub_slabs, groups,
                          root_skips])
    n_rays = 144
    got = roofline.forward_bound(soa, accel, tables, n_rays, tally,
                                 code_rows)
    table_bytes = 4 * sum(getattr(tables, k).numel() for k in (
        "tri", "aabb", "plane", "sphere", "mat", "lights", "ambient"))
    nbytes = n_rays * (8 + 7 + code_rows) * 4 + table_bytes
    per_cast = soa.n_planes * 12 + soa.n_spheres * 30 + 20
    assert (m > 32) == bool(levels)
    assert tables.sub.shape == (m, c // 32, 8)
    walk = (tables.tree.numel() * 4 if levels else 0) + tables.sub.numel() * 4
    slots = groups * 32
    assert got["bound"] == _ms(nbytes, needed * c * 38 + casts * per_cast)
    assert got["bound_admitted"] == _ms(
        nbytes + walk,
        slots * 38 + (slabs + sub_slabs) * 24 + casts * per_cast)


@pytest.mark.parametrize("levels", [0, 2])
def test_cast_bound_is_its_formula(levels):
    """One culling-cast launch's bounds: rays in, t and order out, the 18
    cast rows of every slot and the cluster boxes (and the tree boxes
    past 32 clusters, admitted), against the slot tests of the needed or
    admitted visits, the slab tests and each cast's set-up."""
    p = _prepared("bunny.json", 16, 9, levels)
    tables = tpc.cluster_tables(p.soa, p.accel)
    m, c = tables.tri.shape[:2]
    casts, visits, slabs, needed = 65536, 90000, 300000, 70000
    tally = torch.tensor([casts, visits, slabs, needed])
    got = roofline.cast_bound(tables, 65536, tally)
    nbytes = 65536 * 10 * 4 + m * c * 18 * 4 + tables.aabb.numel() * 4
    tree = tables.tree.numel() * 4 if m > 32 else 0
    assert got["bound"] == _ms(nbytes, needed * c * 38 + casts * 20)
    assert got["bound_admitted"] == _ms(
        nbytes + tree, visits * c * 38 + slabs * 24 + casts * 20)


@pytest.mark.parametrize("name", ["bunny.json", "sphere_plane.json"])
def test_vjp_bound_on_cpu_codes(name):
    """The replay backward's bound from the plain emitter's codes at
    16x9 b5: bytes of rays, codes, cotangents in and out and the table
    and its cotangent; operations of the live hit nodes (code >= 0 in a
    node's cast row), their lights and, in a transparent scene, the
    counted march steps (code >= 0 in a march row)."""
    p = _prepared(name, 16, 9)
    soa = p.soa
    o, d, _ = block_rays(soa)
    *_, codes = tfused.fused_render_rays(soa, p.accel, o, d, 1e-3, 5,
                                         emit_topo=True)
    r, k = codes.shape
    assert k == treplay.replay_rows(soa, 5)
    _, nodes = treplay.topo_layout(5, soa.any_reflective,
                                   soa.any_transparent, soa.n_lights,
                                   soa.shadow_steps)
    cast_rows = [row for _, row, _ in nodes]
    live = codes.numpy() >= 0
    hits = int(live[:, cast_rows].sum())
    march = np.delete(live, cast_rows, axis=1)
    steps = int(march.sum()) if soa.any_transparent else 0
    assert hits > 0
    assert (steps > 0) == (name == "sphere_plane.json")
    n_tab = (soa.tri_p1.shape[0] + soa.pl_point.shape[0]
             + soa.sp_center.shape[0])
    want = _ms(r * (8 + k + 8 + 8) * 4 + 2 * n_tab * 17 * 4,
               hits * (310 + soa.n_lights * 180) + steps * 60)
    assert roofline.vjp_bound(soa, codes, 5) == want


def test_tally_of_hands_over_a_zeroed_tally():
    seen = []

    def fill(t):
        seen.append(t.clone())
        t += torch.tensor([7, 6, 5, 4, 3, 2, 1])

    got = roofline.tally_of(fill, device="cpu")
    assert seen[0].dtype == torch.int64 and not seen[0].any()
    assert tuple(seen[0].shape) == (tpc.TALLY_COUNTS,) == (7,)
    assert got.tolist() == [7, 6, 5, 4, 3, 2, 1]


def _images(step=True):
    """(color, depth, normal) 16x16: smooth ramps, with a jump between
    columns 7 and 8 when `step`."""
    x = np.linspace(0.0, 0.01, 16, dtype=np.float32)[None, :].repeat(16, 0)
    if step:
        x = x + (np.arange(16) >= 8)[None, :].astype(np.float32)
    color = np.stack([x, 0.5 * x, 0.25 * x], -1)
    return color, x + 1.0, np.stack([x, x, x], -1)


def test_gate_passes_identical_images():
    base = _images()
    stats = gates.gate(base, [a.copy() for a in base])
    assert gates.passes(stats)
    for off, on, n_edges, err in stats.values():
        assert (off, on, err) == (0, 0, 0.0) and n_edges > 0


def test_gate_fails_off_the_discontinuities():
    """A pixel changed in the smooth part of the image fails the gate;
    the same change on the jump's edge is within the edge budget."""
    base = _images()
    off_edge = [a.copy() for a in base]
    off_edge[0][3, 2] += 0.01
    stats = gates.gate(base, off_edge)
    assert stats["color"][0] == 1 and not gates.passes(stats)
    assert stats["color"][3] == pytest.approx(0.01, rel=1e-4)
    on_edge = [a.copy() for a in base]
    on_edge[0][3, 8] += 0.01
    stats = gates.gate(base, on_edge)
    assert stats["color"][:2] == (0, 1) and gates.passes(stats)
    assert not gates.passes(stats, edge_budget=0.0)
