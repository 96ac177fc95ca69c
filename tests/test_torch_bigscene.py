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


def _live(accel):
    return accel.valid.to(torch.bool).any(dim=1)


def test_group_boxes_match_jax_superclusters(scenes_dir):
    """With no empty cluster, the unwidened tree level whose nodes cover
    32 clusters each is the JAX kernel's 32-cluster supercluster rows
    (`aabb2`): the tree takes the place of the port's group boxes."""
    from cutrace_tpu.ops import fused as jfused

    sc = _bunny(scenes_dir, 2, 8, 8)
    js = jax_soa(sc)
    ja = jbvh.build_accel(js, 64, kind="fused", interpret=True)
    _, _, aabb2, _, _, _, _ = jfused._tables(js, ja, js.scene_center)
    ts = scene_to_soa(port_scene(sc), device="cpu")
    accel = tbvh.accel_from_numpy(np.asarray(ja.order), np.asarray(ja.valid),
                                  device="cpu")
    kt = tfused.kernel_tables(ts, accel)
    assert kt.aabb.shape[0] == 256 and _live(accel).all()
    tree = tbvh.tree_boxes(kt.aabb[:, 0:3], kt.aabb[:, 3:6], _live(accel))
    leaves = tree.shape[0] // 2
    level = tree[leaves // 32:2 * leaves // 32]
    assert level.shape == (8, 8)
    assert np.array_equal(level[:, :6].numpy(), np.asarray(aabb2)[:6].T)
    assert not level[:, 6:].any()


def test_group_boxes_skip_empty_clusters():
    """Empty clusters stay out of a 32-cluster node's union; a node whose
    32 clusters are all empty sits at the never-hit sentinel."""
    rng = np.random.default_rng(5)
    bmin = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))
    bmax = bmin + torch.from_numpy(rng.uniform(0.1, 1.0, (64, 3))
                                   .astype(np.float32))
    live = torch.zeros(64, dtype=torch.bool)
    live[[0, 5, 31]] = True
    bmin[~live] = 1e8
    bmax[~live] = 1e8
    rows = tbvh.tree_boxes(bmin, bmax, live)
    assert rows.shape == (128, 8)
    want = torch.cat([bmin[live].amin(dim=0), bmax[live].amax(dim=0)])
    assert torch.equal(rows[2, :6], want)
    assert rows[3, :6].tolist() == [1e8] * 6
    assert torch.equal(rows[1, :6], want)


def test_group_entry_never_after_member_entry(scenes_dir):
    """The tree walk's premise, with bvh.slab_entry (the plain form of the
    kernels' slab test) on the 16k bunny's partition: a ray that enters a
    live cluster's unwidened box enters every node above it on the
    kernels' widened tree (its own leaf too), no later; axis-parallel
    rays (0 * inf bounds) included. So a node the walk drops holds no
    cluster the needed-visit count includes."""
    ts = scene_to_soa(port_scene(_bunny(scenes_dir, 2, 8, 8)), device="cpu")
    kt = tfused.kernel_tables(ts, tbvh.build_accel(ts, 256))
    m = kt.aabb.shape[0]
    leaves = kt.tree.shape[0] // 2
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.normal(0.0, 1.0, (4096, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(4096, 3)).astype(np.float32))
    d[:64, 0] = 0.0  # axis-parallel rays: 0 * inf bounds
    m_lo, m_hi = tbvh.slab_entry(kt.aabb[:, 0:3], kt.aabb[:, 3:6], o, d)
    n_lo, n_hi = tbvh.slab_entry(kt.tree[:, 0:3], kt.tree[:, 3:6], o, d)
    member_hit = m_lo <= m_hi
    assert member_hit.sum() > 1000 and member_hit[:64].any()
    node = torch.arange(m) + leaves
    while (node > 0).all():
        assert (n_lo[:, node] <= n_hi[:, node])[member_hit].all()
        assert (n_lo[:, node] <= m_lo)[member_hit].all()
        node = node // tbvh.TREE_ARITY


def _numpy_tree(bmin, bmax, live):
    """The tree of ops.bvh.tree_boxes, by a numpy bottom-up union: (2L, 6)
    node boxes in heap order (row 0 unused), empty clusters left out."""
    m = bmin.shape[0]
    leaves = 1
    while leaves < m:
        leaves *= 2
    lo = np.full((2 * leaves, 3), np.inf, np.float32)
    hi = np.full((2 * leaves, 3), -np.inf, np.float32)
    lo[leaves:leaves + m][live] = bmin[live]
    hi[leaves:leaves + m][live] = bmax[live]
    for node in range(leaves - 1, 0, -1):
        lo[node] = np.minimum(lo[2 * node], lo[2 * node + 1])
        hi[node] = np.maximum(hi[2 * node], hi[2 * node + 1])
    box = np.concatenate([lo, hi], axis=1)
    box[~np.isfinite(box)] = 1e8
    box[0] = 0.0
    return box


@pytest.mark.parametrize("levels", [2, 3])
def test_tree_boxes_match_numpy_union(scenes_dir, levels):
    """On the 16k (M=64) and 64k (M=256) partitions, the tree of the
    port's kernel tables is the numpy bottom-up union of the JAX
    package's cluster boxes (recentered), widened by TREE_MARGIN of the
    root's longest side."""
    sc = _bunny(scenes_dir, levels, 8, 8)
    js = jax_soa(sc)
    ja = jbvh.build_accel(js, 256, kind="fused", interpret=True)
    jc = jbvh.clusters_from_accel(js, ja)
    o0 = np.asarray(js.scene_center)
    bmin, bmax = np.asarray(jc.bmin) - o0, np.asarray(jc.bmax) - o0
    live = np.asarray(jc.valid).any(axis=1)
    want = _numpy_tree(bmin, bmax, live)
    m = bmin.shape[0]
    assert m == 4 ** (levels + 1) and want.shape == (2 * m, 6)

    got = tbvh.tree_boxes(torch.from_numpy(bmin), torch.from_numpy(bmax),
                          torch.from_numpy(live))
    assert np.array_equal(got[:, :6].numpy(), want)
    assert not got[:, 6:].any()

    ts = scene_to_soa(port_scene(sc), device="cpu")
    kt = tfused.kernel_tables(ts, tbvh.accel_from_numpy(
        np.asarray(ja.order), np.asarray(ja.valid), device="cpu"))
    delta = tbvh.TREE_MARGIN * (want[1, 3:6] - want[1, 0:3]).max()
    assert delta > 0
    np.testing.assert_allclose(kt.tree[1:, 0:3].numpy(),
                               want[1:, 0:3] - delta, rtol=1e-6, atol=0)
    np.testing.assert_allclose(kt.tree[1:, 3:6].numpy(),
                               want[1:, 3:6] + delta, rtol=1e-6, atol=0)
    # the leaves are the kernels' cluster boxes, widened
    np.testing.assert_allclose(kt.tree[m:, 0:6].numpy(),
                               kt.aabb[:, 0:6].numpy()
                               + np.float32(delta) * np.array(
                                   [-1, -1, -1, 1, 1, 1], np.float32),
                               rtol=1e-6, atol=0)


def test_tree_nodes_hold_their_children(scenes_dir):
    """Every node box of the 16k bunny's widened tree holds both of its
    children's boxes, and every leaf holds its cluster's unwidened box."""
    ts = scene_to_soa(port_scene(_bunny(scenes_dir, 2, 8, 8)), device="cpu")
    kt = tfused.kernel_tables(ts, tbvh.build_accel(ts, 256))
    tree = kt.tree.numpy()
    leaves = tree.shape[0] // 2
    assert leaves == tbvh.tree_leaves(kt.aabb.shape[0]) == 64
    for child in range(2, 2 * leaves):
        parent = child // tbvh.TREE_ARITY
        assert (tree[parent, 0:3] <= tree[child, 0:3]).all(), child
        assert (tree[parent, 3:6] >= tree[child, 3:6]).all(), child
    aabb = kt.aabb.numpy()
    assert (tree[leaves:, 0:3] < aabb[:, 0:3]).all()
    assert (tree[leaves:, 3:6] > aabb[:, 3:6]).all()


def test_tree_boxes_skip_empty_clusters():
    """Empty clusters and the padding leaves stay out of the unions; a
    node without a live cluster sits at the never-hit sentinel; widening
    moves the sentinel by nothing when no cluster is live."""
    bmin = torch.tensor([[0.0, 0, 0], [1e8, 1e8, 1e8], [2.0, -1, 0]])
    bmax = torch.tensor([[1.0, 1, 1], [1e8, 1e8, 1e8], [3.0, 0, 1]])
    rows = tbvh.tree_boxes(bmin, bmax, torch.tensor([True, False, True]))
    far = [1e8] * 6
    assert rows.shape == (8, 8) and not rows[0].any()
    assert rows[1, :6].tolist() == [0.0, -1.0, 0.0, 3.0, 1.0, 1.0]
    assert rows[2, :6].tolist() == [0.0, 0.0, 0.0, 1.0, 1.0, 1.0]
    assert rows[3, :6].tolist() == [2.0, -1.0, 0.0, 3.0, 0.0, 1.0]
    assert rows[5, :6].tolist() == far and rows[7, :6].tolist() == far
    empty = tbvh.widen_tree(tbvh.tree_boxes(bmin[1:2], bmax[1:2],
                                            torch.tensor([False])))
    assert empty.shape == (2, 8) and empty[1, :6].tolist() == far


def _slab_np(box, o, inv):
    """csrc/cast.cuh slab in float32 numpy: (R, 8) boxes, (R, 3) rays."""
    with np.errstate(invalid="ignore"):
        t1 = (box[:, 0:3] - o) * inv
        t2 = (box[:, 3:6] - o) * inv
    nan = np.isnan(t1) | np.isnan(t2)
    lo = np.where(nan, np.float32(0), np.minimum(t1, t2))
    hi = np.where(nan, np.float32(np.inf), np.maximum(t1, t2))
    entry = np.maximum(lo.max(axis=1), np.float32(0))
    return entry <= hi.min(axis=1), entry


def _visit_np(tri, mi, o, d, mind):
    """csrc/cast.cuh visit_nearest in float32 numpy for rays that visit
    cluster mi: the cluster's (t, key) winner per ray (+inf, 2^30 where
    no slot is hit)."""
    s = tri[mi]  # (C, 24)
    col = [s[:, k][None, :] for k in range(24)]
    dx, dy, dz = (d[:, a:a + 1] for a in range(3))
    ox, oy, oz = (o[:, a:a + 1] for a in range(3))
    wx, wy, wz = dy * oz - dz * oy, dz * ox - dx * oz, dx * oy - dy * ox
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        alpha = dx * col[0] + dy * col[1] + dz * col[2]
        beta_n = ((dx * col[3] + dy * col[4] + dz * col[5])
                  - (wx * col[12] + wy * col[13] + wz * col[14]))
        gamma_n = ((wx * col[9] + wy * col[10] + wz * col[11])
                   - (dx * col[6] + dy * col[7] + dz * col[8]))
        t_n = col[15] - (ox * col[0] + oy * col[1] + oz * col[2])
        inv = np.float32(1) / alpha
        beta, gamma, t = beta_n * inv, gamma_n * inv, t_n * inv
    ok = ((col[17] > 0) & (alpha != 0) & (beta >= 0) & (gamma >= 0)
          & (beta + gamma <= 1) & np.isfinite(t) & (t > mind))
    t = np.where(ok, t, np.float32(np.inf))
    key = np.broadcast_to(col[16], t.shape)
    tmin = t.min(axis=1)
    kmin = np.where(t == tmin[:, None], key, np.float32(2**30)).min(axis=1)
    return tmin, np.where(np.isfinite(tmin), kmin, np.float32(2**30))


def _merge(best_t, best_k, rows, t, k):
    better = (t < best_t[rows]) | ((t == best_t[rows]) & (k < best_k[rows]))
    best_t[rows] = np.where(better, t, best_t[rows])
    best_k[rows] = np.where(better, k, best_k[rows])


def _flat_loop_np(kt, o, d, mind):
    """K1's flat loop (index order, cull against each ray's best t)."""
    tri, aabb = kt.tri.numpy(), kt.aabb.numpy()
    r = o.shape[0]
    with np.errstate(divide="ignore"):
        inv = np.float32(1) / d
    best_t = np.full(r, np.inf, np.float32)
    best_k = np.full(r, 2**30, np.float32)
    for mi in range(aabb.shape[0]):
        hit, entry = _slab_np(np.broadcast_to(aabb[mi], (r, 8)), o, inv)
        rows = np.nonzero(hit & (entry <= best_t))[0]
        if rows.size:
            _merge(best_t, best_k, rows,
                   *_visit_np(tri, mi, o[rows], d[rows], mind))
    return best_t, best_k


def _tree_walk_np(kt, o, d, mind, warp=32):
    """K3's ordered walk (csrc/cast.cuh walk_tree) for warps of `warp`
    consecutive rays, all warps at once: a warp enters a node when any of
    its lanes admits it, the child most lanes enter first goes first and
    the other is deferred on the warp's stack with each lane's entry (NaN
    where the lane did not admit it); a lane tests a cluster's slots only
    if it admitted the cluster. Returns (t, key, slab tests per ray)."""
    tri, tree = kt.tri.numpy(), kt.tree.numpy()
    m, leaves = tri.shape[0], tree.shape[0] // 2
    r = o.shape[0]
    n_w = r // warp
    with np.errstate(divide="ignore"):
        inv = np.float32(1) / d
    best_t = np.full(r, np.inf, np.float32)
    best_k = np.full(r, 2**30, np.float32)
    slabs = np.ones(r, np.int64)
    stack_node = np.zeros((n_w, 32), np.int64)
    stack_entry = np.zeros((n_w, 32, warp), np.float32)
    sp = np.zeros(n_w, np.int64)
    hit, entry = _slab_np(np.broadcast_to(tree[1], (r, 8)), o, inv)
    mine = (hit & (entry <= best_t)).reshape(n_w, warp)
    active = mine.any(axis=1)
    node = np.ones(n_w, np.int64)

    def lanes(ws):  # the rays of warps ws, (len(ws), warp)
        return ws[:, None] * warp + np.arange(warp)[None, :]

    while active.any():
        ws = np.nonzero(active)[0]
        pop = np.zeros(n_w, bool)
        at_leaf = ws[node[ws] >= leaves]
        pop[at_leaf] = True
        rays = lanes(at_leaf)[mine[at_leaf]]
        mi_of = np.repeat(node[at_leaf] - leaves, warp).reshape(-1, warp)
        mi_of = mi_of[mine[at_leaf]]
        for mi in np.unique(mi_of):
            if mi < m:
                sel = rays[mi_of == mi]
                _merge(best_t, best_k, sel,
                       *_visit_np(tri, mi, o[sel], d[sel], mind))
        inner = ws[node[ws] < leaves]
        c0 = 2 * node[inner]
        rows = lanes(inner).reshape(-1)
        c0r = np.repeat(c0, warp)
        h0, e0 = _slab_np(tree[c0r], o[rows], inv[rows])
        h1, e1 = _slab_np(tree[c0r + 1], o[rows], inv[rows])
        act = mine[inner].reshape(-1)
        slabs[rows[act]] += 2
        h0 &= act & (e0 <= best_t[rows])
        h1 &= act & (e1 <= best_t[rows])
        h0, h1 = h0.reshape(-1, warp), h1.reshape(-1, warp)
        e0, e1 = e0.reshape(-1, warp), e1.reshape(-1, warp)
        any0, any1 = h0.any(axis=1), h1.any(axis=1)
        pref0 = h0 & (~h1 | (e0 <= e1))
        pref1 = h1 & ~pref0
        first0 = np.where(any0 & any1,
                          pref0.sum(axis=1) >= pref1.sum(axis=1), any0)
        both = any0 & any1
        b = inner[both]
        h_far = np.where(first0[both, None], h1[both], h0[both])
        e_far = np.where(first0[both, None], e1[both], e0[both])
        stack_node[b, sp[b]] = np.where(first0[both], c0[both] + 1, c0[both])
        stack_entry[b, sp[b]] = np.where(h_far, e_far, np.float32(np.nan))
        sp[b] += 1
        go = any0 | any1
        node[inner[go]] = np.where(first0[go], c0[go], c0[go] + 1)
        mine[inner[go]] = np.where(first0[go, None], h0[go], h1[go])
        pop[inner[~go]] = True
        # pop the latest deferred node some lane still admits
        popping = np.nonzero(pop)[0]
        while popping.size:
            empty = sp[popping] == 0
            active[popping[empty]] = False
            popping = popping[~empty]
            sp[popping] -= 1
            e = stack_entry[popping, sp[popping]]
            with np.errstate(invalid="ignore"):
                adm = e <= best_t[lanes(popping)]
            mine[popping] = adm
            ok = adm.any(axis=1)
            node[popping[ok]] = stack_node[popping[ok], sp[popping[ok]]]
            popping = popping[~ok]
    return best_t, best_k, slabs


def test_ordered_walk_finds_the_flat_winners(scenes_dir):
    """A float32 numpy emulation of K3's ordered walk over the 16k bunny's
    widened tree (M=64, C=256), by warps of 32 rays, gives K1's flat
    loop's (t, key) winners on 65,536 seeded rays aimed at the mesh
    (neighbouring rays aimed at neighbouring points, as a warp's pixels
    are), and tests far fewer boxes than the flat loop's M a cast."""
    ts = scene_to_soa(port_scene(_bunny(scenes_dir, 2, 8, 8)), device="cpu")
    kt = tfused.kernel_tables(ts, tbvh.build_accel(ts, 256))
    root = kt.tree[1].numpy()
    lo, hi = root[0:3], root[3:6]
    rng = np.random.default_rng(17)
    n = 65536
    center, extent = (lo + hi) / 2, (hi - lo).max()
    # a warp's 32 rays start near one point and aim near one target
    base_o = center + rng.normal(0.0, 0.8, (n // 32, 3)) * extent
    base_t = lo + rng.random((n // 32, 3)) * (hi - lo)
    o = (np.repeat(base_o, 32, axis=0)
         + rng.normal(0.0, 0.01, (n, 3)) * extent).astype(np.float32)
    target = (np.repeat(base_t, 32, axis=0)
              + rng.normal(0.0, 0.01, (n, 3)) * extent)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:256, 1] = 0.0  # axis-parallel rays: 0 * inf slab bounds
    mind = np.float32(1e-3)
    flat_t, flat_k = _flat_loop_np(kt, o, d, mind)
    walk_t, walk_k, slabs = _tree_walk_np(kt, o, d, mind)
    assert np.isfinite(flat_t).sum() > n // 4
    assert np.array_equal(walk_k, flat_k)
    assert np.array_equal(walk_t, flat_t)
    assert slabs.mean() < kt.aabb.shape[0] / 2


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
    accel = tbvh.accel_from_numpy(np.asarray(ja.order), np.asarray(ja.valid),
                                  device="cpu")
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
                                np.zeros((65536, 64), bool), device="cpu")
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
