"""Which instance of the replay backward (K2) and of the culling cast
(K4) runs, decided on the host before the launch, and the host side of
their wrappers: which table rows K2 sums in shared memory and its block
size (`ops.replay_vjp.vjp_instance`), the flat loop or the tree walk for K4
(`ops.pallas_cast.k4_instance`), the code buffer's no-copy contract, the
arguments that reach each launch (stand-in libraries), the constants the
CUDA sources share with the wrappers, and the resource query.

The kernels run only on the card (chip_smoke.py holds them against their
plain versions there). Two premises of K2's design are held here by
emulating its warp-level steps in Python: the grouped sums of
`scatter_row` equal one add per lane, and the kernel's stack of
pending child cotangents hands each node the children the old per-node
arrays did."""

import dataclasses
import random
import re

import numpy as np
import pytest
import torch

from cutrace_tpu_torch import bigscene
from cutrace_tpu_torch.ops import _build
from cutrace_tpu_torch.ops import bvh as tbvh
from cutrace_tpu_torch.ops import fused as tfused
from cutrace_tpu_torch.ops import pallas_cast as tpc
from cutrace_tpu_torch.ops import replay as treplay
from cutrace_tpu_torch.ops import replay_vjp as tvjp
from cutrace_tpu_torch.render import renderer as TR
from cutrace_tpu_torch.scene.loader import load_scene
from cutrace_tpu_torch.scene.soa import scene_to_soa
from test_torch_replay import FUDGE, _case, _no_lights_scene

torch.set_num_threads(2)


def _soa(scenes_dir, name, w=8, h=4):
    sc = load_scene(scenes_dir / name)
    sc.camera.width, sc.camera.height = w, h
    return scene_to_soa(sc, device="cpu")


def _rows(soa):
    return (soa.tri_p1.shape[0] + soa.pl_point.shape[0]
            + soa.sp_center.shape[0])


def _sum_bytes(rows):
    """Shared bytes of `rows` table rows' exact sums: 17 sums of six int64
    words each."""
    return 8 * 17 * 6 * rows


def _column_bytes(soa):
    return 4 * (6 * soa.n_lights + 1) * 256


# the five bundled scenes at bounce depth 5: (tree nodes, sums)
BUNDLED = [
    ("triangle.json", 1, "shared"),
    ("bunny.json", 6, "global"),
    ("bunny_small.json", 6, "global"),
    ("mirror.json", 6, "global"),
    ("sphere_plane.json", 63, "shared"),
]


@pytest.mark.parametrize("name,nodes,sums", BUNDLED)
def test_vjp_instance_bundled_scenes(scenes_dir, name, nodes, sums):
    """Every bundled scene at b5, from the 1-node chain to sphere_plane's
    63-node two-branch tree, 256 threads a block: every table row's exact
    sums in shared memory where they fit (triangle, sphere_plane), else
    the planes' and spheres' rows, the meshes' triangles in global
    memory."""
    soa = _soa(scenes_dir, name)
    inst = tvjp.vjp_instance(soa, 5)
    assert (inst.nodes, inst.sums, inst.block) == (nodes, sums, 256)
    lo = 0 if sums == "shared" else soa.tri_p1.shape[0]
    assert inst.shared_from == lo
    assert inst.shared_bytes == (_column_bytes(soa)
                                 + _sum_bytes(_rows(soa) - lo))
    assert inst.shared_bytes <= tvjp.SHARED_SUMS_MAX
    if name == "bunny.json":
        # 5 planes and a padding sphere row and 4 lights' columns
        assert inst.shared_bytes == 4 * 25 * 256 + 816 * 6 == 30496


def test_vjp_instance_256k_global_sums(scenes_dir):
    """At the 256k bunny's table size the (N, 17) sums no longer fit a
    block's share: the triangles' rows are summed in global memory,
    shared memory holds the light columns and the planes' and spheres'
    rows; past SHARED_SUMS_MAX even those go to global memory."""
    soa = _soa(scenes_dir, "bunny.json")
    big = dataclasses.replace(soa, tri_p1=torch.empty((256000, 3)))
    inst = tvjp.vjp_instance(big, 5)
    assert (inst.nodes, inst.sums) == (6, "global")
    assert inst.shared_from == 256000
    assert inst.shared_bytes == _column_bytes(soa) + _sum_bytes(6) == 30496
    many = dataclasses.replace(big, sp_center=torch.empty((200, 3)))
    inst = tvjp.vjp_instance(many, 5)
    assert inst.shared_from == _rows(many)
    assert inst.shared_bytes == _column_bytes(soa) == 25600


def test_vjp_instance_zero_lights(tmp_path):
    """A scene without lights: one shared column (ambient) a thread."""
    soa = scene_to_soa(load_scene(_no_lights_scene(tmp_path)), device="cpu")
    assert soa.n_lights == 0
    inst = tvjp.vjp_instance(soa, 5)
    assert (inst.nodes, inst.sums) == (6, "shared")
    assert inst.shared_bytes == 4 * 256 + _sum_bytes(_rows(soa))


def test_vjp_instance_long_chain(scenes_dir):
    """The kernel takes any shape up to 63 nodes: a mirror chain at b7 (8
    nodes) and at b62 (63 nodes) run; b63 (64 nodes) raises."""
    soa = _soa(scenes_dir, "mirror.json")
    assert tvjp.vjp_instance(soa, 7).nodes == 8
    assert tvjp.vjp_instance(soa, 62).nodes == 63
    with pytest.raises(NotImplementedError, match="63 tree nodes"):
        tvjp.vjp_instance(soa, 63)


@pytest.mark.parametrize("case", ["9 lights", "127 nodes"])
def test_vjp_instance_raises_past_scope(scenes_dir, case):
    """Past 8 lights or 63 nodes no instance covers the tree: it raises,
    and nothing falls back to the plain version."""
    soa = _soa(scenes_dir, "sphere_plane.json")
    bounces = 5
    if case == "9 lights":
        soa = dataclasses.replace(soa, n_lights=9)
    else:
        bounces = 6
    with pytest.raises(NotImplementedError, match="at most 8 lights"):
        tvjp.vjp_instance(soa, bounces)


def _fake_vjp_library(monkeypatch, rc=0):
    calls = []

    class FakeLib:
        def cutrace_replay_vjp(self, *args):
            calls.append(args)
            return rc

    monkeypatch.setattr(_build, "load_library", lambda name: FakeLib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    return calls


@pytest.mark.parametrize("name,bounces", [("bunny.json", 2),
                                          ("sphere_plane.json", 2)])
def test_vjp_wrapper_launch_contract(scenes_dir, monkeypatch, name,
                                     bounces):
    """The K2 wrapper's host side with a stand-in library: the launch gets
    vjp_instance's first shared row, rays padded to a multiple of
    128, a zeroed accumulator of the table's and the light rows' exact
    sums; LAUNCHES counts successful launches only and a CUDA error code
    raises."""
    case = _case(scenes_dir, name, 8, 4, bounces)
    calls = _fake_vjp_library(monkeypatch)
    made, acc_of = [], tvjp._acc
    monkeypatch.setattr(tvjp, "_acc", lambda *a: made.append(
        acc_of(*a)) or made[-1])
    table, lights, ambient = tvjp.backward_tables(case.soa)
    codes = case.port_codes()
    before = tvjp.LAUNCHES
    tvjp._replay_vjp_cuda(case.soa, table, lights, ambient, case.o, case.d,
                          codes, (None, None, None), FUDGE, bounces)
    assert tvjp.LAUNCHES == before + 1
    inst = tvjp.vjp_instance(case.soa, bounces)
    args = calls[0]
    n_rays, n_pad = args[9], args[10]
    assert (n_rays, n_pad) == (32, 128)
    assert args[12] == table.shape[0] and args[15] == case.soa.n_lights
    assert args[21] == inst.shared_from == (
        case.soa.tri_p1.shape[0] if name == "bunny.json" else 0)
    n_el = table.shape[0] * 17 + case.soa.n_lights * 8 + 8
    acc = made[0]
    assert acc.dtype == torch.int64 and not acc.any()
    assert acc.numel() == n_el * 6 + -(-(4 * n_el + table.shape[0]) // 8)
    assert inst.nodes == (3 if name == "bunny.json" else 7)
    monkeypatch.setattr(_build, "load_library", lambda name: type(
        "L", (), {"cutrace_replay_vjp": lambda self, *a: 700})())
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tvjp._replay_vjp_cuda(case.soa, table, lights, ambient, case.o,
                              case.d, codes, (None, None, None), FUDGE,
                              bounces)
    assert tvjp.LAUNCHES == before + 1


def test_codes_by_row_takes_the_forward_buffer():
    """The fused forward pads rays to a multiple of 128 (fused._BLOCK),
    not of K2's 256-thread block: its (K, n_pad) code buffer, handed over
    as the (R, K) view, is taken as it is (same storage, no copy); a
    contiguous (R, K) tensor is copied into a buffer padded to 128 with
    -1."""
    assert tfused._BLOCK == tvjp._PAD == 128
    k, r, n_pad = 7, 300, 384
    assert n_pad % tvjp._BLOCK
    buf = torch.arange(k * n_pad, dtype=torch.int32).reshape(k, n_pad)
    view = buf.T[:r]
    got, pad = tvjp._codes_by_row(view)
    assert pad == n_pad and got.data_ptr() == buf.data_ptr()
    assert torch.equal(got, buf)
    dense = view.contiguous()
    got, pad = tvjp._codes_by_row(dense)
    assert pad == 384 and got.data_ptr() != dense.data_ptr()
    assert torch.equal(got[:, :r], dense.T)
    assert bool((got[:, r:] == -1).all())


def test_codes_by_row_takes_the_wrappers_own_codes(scenes_dir, monkeypatch):
    """The codes the forward wrapper returns (its (R, K) view of the
    (K, R_pad) buffer) reach K2 without a copy."""
    class FakeLib:
        def cutrace_fused_forward(self, *args):
            return 0

        def cutrace_shared_limit(self, out):
            out._obj.value = 232448
            return 0

    monkeypatch.setattr(_build, "load_library", lambda name: FakeLib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(tfused, "_SHARED_LIMIT", {})
    soa = _soa(scenes_dir, "bunny.json", 10, 7)
    tables = tfused.kernel_tables(soa, TR.prepare(soa, accel="fused").accel)
    o, d, _ = TR.block_rays(soa)
    *_, codes = tfused._fused_forward_cuda(soa, tables, o, d, 1e-3, 5,
                                           emit_topo=True)
    got, n_pad = tvjp._codes_by_row(codes)
    assert n_pad == 128 and got.data_ptr() == codes.data_ptr()


@pytest.mark.parametrize("m,want", [(16, tpc._K4_FLAT), (32, tpc._K4_FLAT),
                                    (33, tpc._K4_TREE),
                                    (1024, tpc._K4_TREE)])
def test_k4_instance_by_cluster_count(m, want):
    """K4 takes the flat loop up to 32 clusters (bunny's M=16), the tree
    walk past it (the 256k bunny's M=1024), the same split as the fused
    kernels' K1 and K3."""
    assert tpc.FLAT_MAX_M == tfused.LANES_MAX_M == 32
    leaves = tbvh.tree_leaves(m)
    tables = tpc.ClusterTables(tri=torch.zeros((m, 1, 24)),
                               aabb=torch.zeros((m, 8)),
                               tree=torch.zeros((2 * leaves, 8)))
    assert tpc.k4_instance(tables) == want


@pytest.mark.parametrize("levels,want", [(0, tpc._K4_FLAT),
                                         (2, tpc._K4_TREE)])
def test_k4_wrapper_passes_the_tree(scenes_dir, monkeypatch, levels, want):
    """The K4 wrapper with a stand-in library: bunny (M=16) launches the
    flat instance, the 16k bunny (M=64) the tree instance, each with the
    partition's tree boxes and leaf count."""
    calls = []

    class FakeLib:
        def cutrace_cluster_cast(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "load_library", lambda name: FakeLib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    if levels:
        sc, _ = bigscene.subdivided_bunny(levels, 8, 4)
    else:
        sc = load_scene(scenes_dir / "bunny.json")
    soa = scene_to_soa(sc, device="cpu")
    accel = tbvh.build_accel(soa, 64 if levels == 0 else 256, kind="pallas")
    tables = tpc.cluster_tables(soa, accel)
    o = torch.zeros((5, 3))
    tpc._cast_clusters_cuda(tables, o, o, torch.full((5,), 1e-3))
    args = calls[0]
    m = tables.tri.shape[0]
    assert args[3].value == tables.tree.data_ptr()
    assert args[6:11] == (5, m, tables.tri.shape[1],
                          tables.tree.shape[0] // 2, want)
    assert tables.tree.shape[0] // 2 == tbvh.tree_leaves(m) >= m


def test_kernel_attributes_query(monkeypatch):
    """_build.kernel_attributes reads the four resources a library's
    query fills in, per instance, and raises on a CUDA error code."""
    seen = []

    class FakeLib:
        def cutrace_cluster_cast_attributes(self, instance, out):
            seen.append(instance)
            for i, v in enumerate((64, 256, 0, 128)):
                out[i] = v
            return 0 if instance in (tpc._K4_FLAT, tpc._K4_TREE) else 1

        def cutrace_replay_vjp_attributes(self, out):
            for i, v in enumerate((119, 2752, 0, 256)):
                out[i] = v
            return 0

    monkeypatch.setattr(_build, "load_library", lambda name: FakeLib())
    got = _build.kernel_attributes("cluster_cast", tpc._K4_TREE)
    assert got == {"registers": 64, "local_bytes": 256,
                   "static_shared_bytes": 0, "max_threads": 128}
    assert seen == [tpc._K4_TREE]
    assert _build.kernel_attributes("replay_vjp")["local_bytes"] == 2752
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _build.kernel_attributes("cluster_cast", 7)
    assert set(_build.ATTRIBUTES) == set(_build.SOURCES)
    for name, fn in _build.ATTRIBUTES.items():
        assert fn in _build.SIGNATURES[name]


def test_instance_constants_match_sources():
    """The constants the wrappers share with the CUDA sources: K2's block,
    padding and scope; K4's instance numbers; every library exports its
    resource query."""
    src = _build.SOURCES["replay_vjp"].read_text()
    consts = dict((k, int(v)) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src))
    assert consts["kBlock"] == tvjp._BLOCK
    assert consts["kPad"] == tvjp._PAD
    assert consts["kMaxLights"] == tvjp.MAX_LIGHTS
    assert consts["kMaxNodes"] == tvjp.MAX_NODES
    assert consts["kWords"] == tvjp._WORDS
    assert consts["kGridExp"] == tvjp._GRID_EXP
    assert "constexpr long long kMaxTerms = 1ll << 30;" in src
    assert tvjp.MAX_TERMS == 1 << 30
    assert "kInstance" not in src  # one kernel for every tree shape
    cast = _build.SOURCES["cluster_cast"].read_text()
    inst = dict(re.findall(r"\b(kInstance\w+) = (\d+)", cast))
    assert inst == {"kInstanceFlat": str(tpc._K4_FLAT),
                    "kInstanceTree": str(tpc._K4_TREE)}
    for name, fn in _build.ATTRIBUTES.items():
        assert f'extern "C" int {fn}(' in _build.SOURCES[name].read_text()


def _scatter_rounds(codes, g):
    """csrc/replay_vjp.cu scatter_row for one warp, in Python: each lane's
    value after the rounds, and which lanes lead their code's group."""
    lanes = range(32)
    peers = [sum(1 << j for j in lanes if codes[j] == codes[lane])
             for lane in lanes]
    rank = [bin(peers[lane] & ((1 << lane) - 1)).count("1") for lane in lanes]
    leader = [r == 0 for r in rank]
    above = [peers[lane] & ~((2 << lane) - 1) & 0xFFFFFFFF for lane in lanes]
    x = list(g)
    rounds = 0
    while any(above):
        nxt = [(a & -a).bit_length() - 1 for a in above]
        src = [n if n >= 0 else lane for lane, n in enumerate(nxt)]
        got = [x[s] for s in src]
        x = [x[lane] + (got[lane] if nxt[lane] >= 0 else 0.0)
             for lane in lanes]
        keep = sum(1 << lane for lane in lanes if rank[lane] % 2 == 0)
        above = [a & keep for a in above]
        rank = [r >> 1 for r in rank]
        rounds += 1
    return x, leader, rounds


@pytest.mark.parametrize("spread", ["one wall", "few", "all distinct"])
def test_scatter_groups_sum_like_one_add_a_lane(spread):
    """K2's grouped table sums: the leader of each code's group holds the
    group's sum after log2 of the largest group's size rounds, so one
    add a group equals one add a lane."""
    rng = random.Random(5)
    for _ in range(300):
        if spread == "one wall":
            codes = [7] * 32
        elif spread == "few":
            codes = [rng.choice([-1, 3, 5, 9]) for _ in range(32)]
        else:
            codes = rng.sample(range(-1, 100), 32)
        g = [rng.uniform(-1.0, 1.0) for _ in range(32)]
        x, leader, rounds = _scatter_rounds(codes, g)
        want = {}
        for c, v in zip(codes, g):
            want[c] = want.get(c, 0.0) + v
        got = {codes[lane]: x[lane] for lane in range(32) if leader[lane]}
        assert set(got) == set(want)
        for c in want:
            assert abs(got[c] - want[c]) < 1e-9
        biggest = max(codes.count(c) for c in set(codes))
        assert rounds == (biggest - 1).bit_length()


def _subtree(bounces, level, refl, transp):
    depth = bounces - level + 1
    if refl and transp:
        return 2 ** depth - 1
    return depth if (refl or transp) else 1


def _children_two_ways(bounces, refl, transp, rng):
    """Which finished children each hit node receives, by the per-node
    `done` bits the kernel used to keep and by the tree instance's pending
    stack over the live nodes in reverse preorder; and the stack's
    depth."""
    def leaf(level):
        return level == bounces or not (refl or transp)

    n = _subtree(bounces, 0, refl, transp)
    hit = {k: rng.random() < 0.8 for k in range(n)}
    w_r = {k: rng.random() < 0.8 for k in range(n)}
    w_t = {k: rng.random() < 0.7 for k in range(n)}
    live, parked = [], []
    node, level, w = 0, 0, True
    while True:  # the forward sweep's walk, weights as nonzero flags
        descend = False
        if node == 0 or w:
            live.append((node, level))
            if not leaf(level):
                wr, wt = hit[node] and w_r[node], hit[node] and w_t[node]
                if refl:
                    if transp:
                        parked.append((level + 1, node + 1 + _subtree(
                            bounces, level + 1, refl, transp), wt))
                    w = wr
                else:
                    w = wt
                level, node, descend = level + 1, node + 1, True
        if not descend:
            if not parked:
                break
            level, node, w = parked.pop()
    levels = dict(live)
    done, old = set(), {}
    for k in range(n - 1, -1, -1):
        if k in levels and hit[k]:
            lv = levels[k]
            kr = k + 1
            kt = k + 1 + (_subtree(bounces, lv + 1, refl, transp) if refl
                          else 0)
            old[k] = (not leaf(lv) and refl and kr in done,
                      not leaf(lv) and transp and kt in done)
            done.add(k)
    stack, new, depth = [], {}, 0
    for k, lv in reversed(live):
        if not hit[k]:
            continue
        kr = k + 1
        kt = k + 1 + (_subtree(bounces, lv + 1, refl, transp) if refl
                      else 0)
        has_r = bool(not leaf(lv) and refl and stack and stack[-1] == kr)
        if has_r:
            stack.pop()
        has_t = bool(not leaf(lv) and transp and stack and stack[-1] == kt)
        if has_t:
            stack.pop()
        new[k] = (has_r, has_t)
        stack.append(k)
        depth = max(depth, len(stack))
    root = bool(stack) and stack[-1] == 0
    return old, new, root, 0 in done, len(stack), depth


@pytest.mark.parametrize("shape", ["two-branch", "reflective chain",
                                   "transparent chain"])
def test_pending_stack_hands_each_node_its_children(shape):
    """K2: popping the live nodes in reverse preorder, a
    node's finished children are on top of the pending stack (reflection
    child first), exactly the children the per-node arrays gave it; the
    root's cotangent is the one entry left, and the stack never holds
    more than its 8 (kCotStack) entries."""
    refl, transp = {"two-branch": (True, True),
                    "reflective chain": (True, False),
                    "transparent chain": (False, True)}[shape]
    rng = random.Random(11)
    deepest = 0
    for trial in range(400):
        bounces = rng.randint(0, 5 if shape == "two-branch" else 62)
        old, new, root, root_done, left, depth = _children_two_ways(
            bounces, refl, transp, rng)
        assert new == old
        assert root == root_done and left == int(root)
        deepest = max(deepest, depth)
    assert deepest <= 8


def test_vjp_scope_follows_topo_layout(scenes_dir):
    """vjp_instance's node count is the replay's topo layout's, and the
    code rows the kernel checks (nodes x node rows) are its rows."""
    for name in ("bunny.json", "sphere_plane.json", "mirror.json"):
        soa = _soa(scenes_dir, name)
        rows, nodes = treplay.topo_layout(5, soa.any_reflective,
                                          soa.any_transparent, soa.n_lights,
                                          soa.shadow_steps)
        node_rows = 1 + soa.n_lights * (soa.shadow_steps
                                        if soa.any_transparent else 1)
        inst = tvjp.vjp_instance(soa, 5)
        assert inst.nodes == len(nodes) and rows == inst.nodes * node_rows
        assert np.all(np.diff([cr for _, cr, _ in nodes]) == node_rows)


@pytest.mark.parametrize("n_rays", [1, 127, 65536, 262144 + 5])
def test_k4_lanes_take_every_ray_once(n_rays):
    """K4's ray-to-lane map (csrc/cluster_cast.cu: lane l of warp w takes
    ray l * n_warps + w, blocks of 128 threads) gives every ray of the
    launch to exactly one lane, and each warp rays spread over the whole
    launch: no warp holds two rays closer than n_warps apart."""
    src = _build.SOURCES["cluster_cast"].read_text()
    assert "(int)(threadIdx.x & 31) * n_warps + blockIdx.x * (kBlock / 32) +" \
        in src
    block = 128
    grid = -(-n_rays // block)
    n_warps = grid * block // 32
    t = np.arange(grid * block)
    lane, warp = t % 32, t // 32
    ray = lane * n_warps + warp
    assert sorted(ray.tolist()) == list(range(grid * block))
    active = ray < n_rays
    assert np.array_equal(np.sort(ray[active]), np.arange(n_rays))
    assert (np.diff(ray.reshape(-1, 32), axis=1) == n_warps).all()
