"""Port parity for big scenes (more than 32 clusters, the K3 path):
cutrace_tpu_torch's partition policy, its fused plain version and its
plain topology emitter against the JAX package's big-scene kernel
(`cutrace_tpu/ops/fused.py:_make_kernel`), run in interpret mode as
tests/test_fused.py runs it.

The CUDA kernel K3 runs only on the card; chip_smoke.py holds it against
the plain version there. Gates: tests/test_fused.py's _compare (np.isclose
atol 2e-4, no mismatch off discontinuities, at most 10 % of edge pixels
for the subdivided mesh as its own test allows), codes equal on the
entries the replay reads (test_torch_replay.canonical_codes)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutrace_tpu.ops import bvh as jbvh
from cutrace_tpu.ops.fused import _fused_forward
from cutrace_tpu.render import renderer as JR
from cutrace_tpu.scene.loader import load_scene
from cutrace_tpu.scene.mesh_io import subdivide
from cutrace_tpu.scene.soa import scene_to_soa as jax_soa
from cutrace_tpu_torch import bigscene
from cutrace_tpu_torch.ops import bvh as tbvh
from cutrace_tpu_torch.ops import fused as tfused
from cutrace_tpu_torch.render import renderer as TR
from cutrace_tpu_torch.scene.soa import scene_to_soa
from test_fused import _compare
from test_torch_host import port_scene
from test_torch_replay import canonical_codes

torch.set_num_threads(2)

FUDGE = 1e-3


def _bunny(scenes_dir, levels, w, h):
    sc = load_scene(scenes_dir / "bunny.json")
    sc.camera.width, sc.camera.height = w, h
    for ob in sc.objects:
        if type(ob).__name__ == "Mesh":
            ob.vertices = subdivide(ob.vertices, levels)
    return sc


@pytest.mark.parametrize("levels,shape", [(0, (16, 64)), (2, (64, 256)),
                                          (3, (256, 256))])
def test_prepare_policy_matches_jax(scenes_dir, levels, shape):
    """The port's "fused" partition equals the JAX package's: the same
    cluster size and the same median split, slot for slot."""
    sc = _bunny(scenes_dir, levels, 8, 8)
    want = JR.prepare(jax_soa(sc), accel="fused").accel
    got = TR.prepare(port_scene(sc), accel="fused", device="cpu").accel
    assert tuple(got.order.shape) == shape
    assert np.array_equal(got.order.numpy(), np.asarray(want.order))
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))


def test_group_boxes_match_jax_superclusters(scenes_dir):
    """With no empty cluster, the group boxes are the JAX kernel's
    32-cluster supercluster rows (`aabb2`)."""
    from cutrace_tpu.ops import fused as jfused

    sc = _bunny(scenes_dir, 2, 8, 8)
    js = jax_soa(sc)
    ja = jbvh.build_accel(js, 64, kind="fused", interpret=True)
    _, _, aabb2, _, _, _, _ = jfused._tables(js, ja, js.scene_center)
    ts = scene_to_soa(port_scene(sc), device="cpu")
    kt = tfused.kernel_tables(ts, tbvh.accel_from_numpy(
        np.asarray(ja.order), np.asarray(ja.valid)))
    assert kt.groups.shape == (8, 8)
    assert np.array_equal(kt.groups[:, :6].numpy(), np.asarray(aabb2)[:6].T)
    assert not kt.groups[:, 6:].any()


def test_group_boxes_skip_empty_clusters():
    """Empty clusters stay out of the union; an all-empty group sits at
    the never-hit sentinel."""
    bmin = torch.tensor([[0.0, 0, 0], [1e8, 1e8, 1e8], [2.0, -1, 0]])
    bmax = torch.tensor([[1.0, 1, 1], [1e8, 1e8, 1e8], [3.0, 0, 1]])
    rows = tbvh.group_boxes(bmin, bmax, torch.tensor([True, False, True]))
    assert rows.tolist() == [[0.0, -1.0, 0.0, 3.0, 1.0, 1.0, 0.0, 0.0]]
    empty = tbvh.group_boxes(bmin[1:2], bmax[1:2], torch.tensor([False]))
    assert empty[0, :6].tolist() == [1e8] * 6


def test_group_entry_never_after_member_entry(scenes_dir):
    """The two-level cull's premise, with bvh.slab_entry (the plain form
    of the kernels' slab test) on the 16k bunny's partition: a ray that
    enters a live cluster's box enters its group's box, no later. So the
    group test drops only clusters the member test drops too."""
    ts = scene_to_soa(port_scene(_bunny(scenes_dir, 2, 8, 8)), device="cpu")
    kt = tfused.kernel_tables(ts, tbvh.build_accel(ts, 256))
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.normal(0.0, 1.0, (4096, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(4096, 3)).astype(np.float32))
    d[:64, 0] = 0.0  # axis-parallel rays: 0 * inf bounds
    m_lo, m_hi = tbvh.slab_entry(kt.aabb[:, 0:3], kt.aabb[:, 3:6], o, d)
    g_lo, g_hi = tbvh.slab_entry(kt.groups[:, 0:3], kt.groups[:, 3:6], o, d)
    group = torch.arange(kt.aabb.shape[0]) // tbvh.GROUP
    member_hit = m_lo <= m_hi
    assert member_hit.sum() > 1000
    assert (g_lo[:, group] <= g_hi[:, group])[member_hit].all()
    assert (g_lo[:, group] <= m_lo)[member_hit].all()


def test_big_plain_matches_jax_fused(scenes_dir):
    """The 16k bunny (C=256, M=64) at 32x18 b1: the port's prepare +
    render (K3's plain version here) against JAX's (interpret K3)."""
    sc = _bunny(scenes_dir, 2, 32, 18)
    base = JR.render(JR.prepare(jax_soa(sc), accel="fused"), bounces=1)
    prepared = TR.prepare(port_scene(sc), accel="fused", device="cpu")
    assert prepared.accel.order.shape[0] > tfused.LANES_MAX_M
    out = TR.render(prepared, bounces=1)
    _compare([np.asarray(x) for x in base], [x.numpy() for x in out],
             atol=2e-4, edge_budget=0.10)


def test_big_codes_match_jax(scenes_dir):
    """The plain emitter over an M > 32 partition (bunny at cluster size
    8, M=125) writes JAX's big-scene kernel codes (its packed flag columns
    unpacked) on every entry the replay reads."""
    sc = load_scene(scenes_dir / "bunny.json")
    sc.camera.width, sc.camera.height = 16, 9
    js = jax_soa(sc)
    ja = jbvh.build_accel(js, 8, kind="fused", interpret=True)
    assert ja.order.shape[0] > tfused.LANES_MAX_M
    idx = jnp.arange(16 * 9, dtype=jnp.int32)
    jo, jd = JR.camera_rays(js, idx % 16, idx // 16)
    *_, want = _fused_forward(js, ja, jo, jd, FUDGE, 2, emit_topo=True)
    ts = scene_to_soa(port_scene(sc), device="cpu")
    accel = tbvh.accel_from_numpy(np.asarray(ja.order), np.asarray(ja.valid))
    o, d = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd))
    got = tfused.emit_topo_plain(ts, accel, o, d, FUDGE, 2)
    want = canonical_codes(ts, o, d, torch.from_numpy(np.array(want)),
                           FUDGE, 2)
    assert torch.equal(got, want)


def test_plain_chunks_are_bounded(scenes_dir, monkeypatch):
    """The plain versions keep rays x (slots + planes + spheres) near
    2^26 per batch, and bunny keeps the batches it had (16384 rays for
    the forward, 2^26 // 1030 for the emitter: 1024 slots, 5 planes and
    the padding sphere)."""
    seen = []

    def stub(soa, o, *args):
        seen.append(o.shape[0])
        r = o.shape[0]
        return torch.zeros((r, 3)), torch.zeros((r,)), torch.zeros((r, 3))

    monkeypatch.setattr(tfused, "render_rays", stub)
    monkeypatch.setattr(tfused, "_emit_chunk", lambda soa, accel, o, *a: (
        seen.append(o.shape[0]), torch.zeros((o.shape[0], 1)))[1])
    ts = scene_to_soa(port_scene(_bunny(scenes_dir, 0, 8, 4)), device="cpu")
    rays = torch.zeros((70000, 3))
    bunny = tbvh.build_accel(ts, 64)
    big = tbvh.accel_from_numpy(np.full((65536, 64), 2**30, np.int32),
                                np.zeros((65536, 64), bool))
    tfused.fused_render_rays_plain(ts, bunny, rays, rays, FUDGE, 5)
    assert seen == [16384] * 4 + [4464]
    seen.clear()
    tfused.emit_topo_plain(ts, bunny, rays, rays, FUDGE, 5)
    assert seen == [65154, 4846]
    seen.clear()
    tfused.fused_render_rays_plain(ts, big, rays[:32], rays[:32], FUDGE, 5)
    assert seen == [15, 15, 2]  # 2^26 // (65536 * 64 + 5) = 15
    seen.clear()
    tfused.emit_topo_plain(ts, big, rays[:32], rays[:32], FUDGE, 5)
    assert seen == [15, 15, 2]


def test_bigscene_cli_on_the_cpu(capsys):
    """python -m cutrace_tpu_torch.bigscene at a tiny size on the CPU
    prints its JSON row; casts follow utils.profiling.casts_per_pixel."""
    assert bigscene.main(["--levels", "1", "--width", "8", "--height", "4",
                          "--bounces", "1", "--iters", "1", "--device",
                          "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["triangles"] == 4000 and row["size"] == "8x4"
    assert row["device"] == "cpu" and row["card"] is None
    for key in ("frame_s", "mcasts_per_s", "first_call_s", "prepare_s"):
        assert row[key] > 0, key
    # bunny: a 6-node chain at b5 would be 6 * (1 + 4); at b1, 2 * 5
    assert row["mcasts_per_s"] == pytest.approx(
        8 * 4 * 10 / row["frame_s"] / 1e6)
