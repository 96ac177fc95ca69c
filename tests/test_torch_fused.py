"""Port parity: cutrace_tpu_torch.ops.fused (tables, the kernel's plain
version, scope) against the JAX package.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against the plain version there. Here the plain version (what
fused_render_rays runs for CPU tensors) is held against the port's
composable path and against the JAX fused kernel in interpret mode, with
tests/test_fused.py's _compare gate (np.isclose atol 2e-4, no mismatch off
discontinuities, at most 5 % of edge pixels)."""

import re

import numpy as np
import pytest
import torch

from cutrace_tpu.ops import bvh as jbvh
from cutrace_tpu.ops import fused as jfused
from cutrace_tpu.render import renderer as JR
from cutrace_tpu.scene.loader import load_scene
from cutrace_tpu.scene.soa import scene_to_soa as jax_soa
from cutrace_tpu_torch.ops import _build
from cutrace_tpu_torch.ops import bvh as tbvh
from cutrace_tpu_torch.ops import fused as tfused
from cutrace_tpu_torch.ops import pallas_cast as tpc
from cutrace_tpu_torch.render import renderer as TR
from cutrace_tpu_torch.scene.soa import scene_to_soa
from test_fused import _compare
from test_torch_host import port_scene

torch.set_num_threads(2)


def torch_soa(sc):
    return scene_to_soa(port_scene(sc), device="cpu")


def _scene(scenes_dir, name, w, h):
    sc = load_scene(scenes_dir / name)
    sc.camera.width, sc.camera.height = w, h
    return sc


@pytest.mark.parametrize("scene", ["bunny.json", "sphere_plane.json"])
def test_tables_match_jax(scenes_dir, scene):
    """Every row the kernel reads equals its row in the JAX package's
    _tables and _light_table."""
    sc = _scene(scenes_dir, scene, 16, 9)
    js = jax_soa(sc)
    ja = jbvh.build_accel(js, 64, kind="fused", interpret=True)
    jt, jaabb, _, _, jplane, jsphere, jmat = jfused._tables(
        js, ja, js.scene_center)
    jlights = jfused._light_table(js, js.scene_center)

    ts = torch_soa(sc)
    kt = tfused.kernel_tables(ts, tbvh.build_accel(ts, 64))
    for k in ("tri", "aabb", "plane", "sphere", "mat", "lights", "ambient"):
        t = getattr(kt, k)
        assert t.dtype == torch.float32 and t.is_contiguous(), k

    names = tpc._TRI_NAMES
    for i, name in enumerate(names):
        got, want = kt.tri[..., i].numpy(), np.asarray(jt[name], np.float32)
        if name in ("snx", "sny", "snz"):
            # unit normals: XLA fuses the normalization differently, so
            # they may sit one float32 ulp apart
            np.testing.assert_allclose(got, want, rtol=0, atol=2.5e-7,
                                       err_msg=name)
        else:
            assert np.array_equal(got, want), name
    assert not kt.tri[..., len(names):].any()

    assert np.array_equal(kt.aabb[:, :6].numpy(), np.asarray(jaabb)[:6].T)
    assert not kt.aabb[:, 6:].any()
    ps_rows = (
        (tfused._PS_OBJ, jfused._A_OBJ),
        *((tfused._PS_N + a, jfused._A_NX + a) for a in range(3)),
        *((tfused._PS_C + a, jfused._A_CX + a) for a in range(3)),
        (tfused._PS_K, jfused._ROW_KP),
        (tfused._PS_VALID, jfused._ROW_VALID),
        (tfused._PS_MAT, jfused._ROW_MAT),
    )
    for kind, got, want in (("plane", kt.plane, jplane),
                            ("sphere", kt.sphere, jsphere)):
        got, want = got.numpy(), np.asarray(want)
        for col, row in ps_rows:
            assert np.array_equal(got[:, col], want[row]), (kind, col)
    assert np.array_equal(kt.mat[:, :7].numpy(), np.asarray(jmat)[:7].T)
    assert np.array_equal(kt.lights.numpy(), np.asarray(jlights))
    assert kt.ambient.item() == float(np.asarray(js.ambient))


@pytest.mark.parametrize(
    "scene,bounces",
    [
        ("triangle.json", 5),
        ("bunny.json", 3),
        ("mirror.json", 3),
        ("sphere_plane.json", 3),
    ],
)
def test_plain_matches_composable(scenes_dir, scene, bounces):
    """fused_render_rays on CPU tensors (the kernel's plain version, over
    the cluster partition) against the brute-force composable path."""
    soa = torch_soa(_scene(scenes_dir, scene, 32, 18))
    prepared = TR.prepare(soa, accel="fused")
    o, d, inverse = TR.block_rays(soa)
    fused_img = TR.to_image(soa, inverse, *tfused.fused_render_rays(
        soa, prepared.accel, o, d, 1e-3, bounces))
    base = TR.render(soa, bounces=bounces)
    _compare([x.numpy() for x in base], [x.numpy() for x in fused_img],
             atol=2e-4)


@pytest.mark.parametrize(
    "scene,bounces",
    [("triangle.json", 5), ("bunny.json", 3)],
)
def test_slice_matches_jax_fused_kernel(scenes_dir, scene, bounces):
    """The slice end to end (prepare "fused" + render) against the JAX
    fused kernel, run in interpret mode as tests/test_fused.py runs it."""
    sc = _scene(scenes_dir, scene, 48, 27)
    base = JR.render(JR.prepare(jax_soa(sc), accel="fused"), bounces=bounces)
    out = TR.render(TR.prepare(torch_soa(sc), accel="fused"),
                    bounces=bounces)
    _compare([np.asarray(x) for x in base], [x.numpy() for x in out],
             atol=2e-4)


def _subdivided(scenes_dir, levels, w, h):
    """bunny.json at w x h with its mesh subdivided `levels` times."""
    from cutrace_tpu.scene.mesh_io import subdivide

    sc = _scene(scenes_dir, "bunny.json", w, h)
    for ob in sc.objects:
        if type(ob).__name__ == "Mesh":
            ob.vertices = subdivide(ob.vertices, levels)
    return sc


def test_prepare_policy(scenes_dir):
    """The JAX package's cluster-size policy: C=64 for bunny (M=16, K1),
    C=256 for the 16k bunny (M=64, K3); "clusters" and "pallas" take
    bvh.CLUSTER_SIZE and keep their kind."""
    soa = torch_soa(_scene(scenes_dir, "bunny.json", 8, 8))
    assert TR.prepare(soa).accel is None  # "auto" on the CPU
    accel = TR.prepare(soa, accel="fused").accel
    assert tuple(accel.order.shape) == (16, 64)  # C=64, M=16
    assert accel.kind == "fused"
    big = TR.prepare(port_scene(_subdivided(scenes_dir, 2, 8, 8)),
                     accel="fused", device="cpu").accel
    assert tuple(big.order.shape) == (64, 256)  # C=256, M=64
    for kind in ("pallas", "clusters"):
        acc = TR.prepare(soa, accel=kind).accel
        assert acc.kind == kind and acc.order.shape[1] == tbvh.CLUSTER_SIZE
    with pytest.raises(ValueError, match="unknown accel"):
        TR.prepare(soa, accel="bvh")


def test_scope_is_enforced(scenes_dir):
    """Partitions past 32 clusters render (K3's plain version here); a
    127-node tree is prepared and rendered through the composable culling
    cast, while the fused kernels, called directly, still refuse it."""
    prepared = TR.prepare(port_scene(_subdivided(scenes_dir, 2, 8, 8)),
                          accel="fused", device="cpu")
    assert prepared.accel.order.shape[0] > tfused.LANES_MAX_M
    color, depth, _ = TR.render(prepared, bounces=1)
    assert tuple(color.shape) == (8, 8, 3) and torch.isfinite(depth).any()

    soa = torch_soa(_scene(scenes_dir, "sphere_plane.json", 4, 4))
    deep = TR.prepare(soa, accel="fused", bounces=6)
    assert not tfused.fused_supported(soa, deep.accel, 6)
    assert tfused.fused_supported(soa, deep.accel, 5)
    color, _, _ = TR.render(deep, bounces=6)
    assert torch.isfinite(color).all()
    o, d, _ = TR.block_rays(soa)
    with pytest.raises(NotImplementedError, match="127-node"):
        tfused.fused_render_rays(soa, deep.accel, o, d, 1e-3, 6)
    # topology codes are in scope: on CPU tensors the plain emitter
    # answers, shaped as the replay's layout
    *_, codes = tfused.fused_render_rays(soa, deep.accel, o, d, 1e-3, 2,
                                         emit_topo=True)
    assert tuple(codes.shape) == (16, 49) and codes.dtype == torch.int32
    # a partition of 33 empty clusters renders nothing but the planes
    wide = tbvh.accel_from_numpy(np.full((33, 64), 2**30, np.int32),
                                 np.zeros((33, 64), bool), device="cpu")
    c1, d1, _ = tfused.fused_render_rays(soa, wide, o, d, 1e-3, 1)
    c2, d2, _ = tfused.fused_render_rays(soa, deep.accel, o, d, 1e-3, 1)
    assert torch.equal(d1, d2) and torch.equal(c1, c2)


def test_kernel_row_layout_matches_source():
    """The (M, C, 24) triangle rows the wrapper packs are the rows the
    CUDA sources read (their T_* constants, in the shared header), and
    the cluster tree the walks read is ops.bvh's."""
    src = "\n".join(p.read_text() for p in (
        _build.SOURCES["fused_forward"],
        *_build.included_headers(_build.SOURCES["fused_forward"])))
    consts = dict(
        (k, int(v)) for k, v in re.findall(r"\b(T_[A-Z]+) = (\d+)", src))
    names = tpc._TRI_NAMES
    assert consts == {
        "T_N": names.index("n0"), "T_UB": names.index("ub0"),
        "T_UG": names.index("ug0"), "T_A": names.index("a0"),
        "T_B": names.index("b0"), "T_K": names.index("k"),
        "T_ORDER": names.index("order"), "T_VALID": names.index("valid"),
        "T_SN": names.index("snx"), "T_OBJ": names.index("obj"),
        "T_MAT": names.index("mat"),
    }
    assert f"kTriRows = {tpc._TRI_ROWS};" in src
    plane_rows = dict(
        (k, int(v)) for k, v in re.findall(r"\b(P_[A-Z]+) = (\d+)", src))
    assert plane_rows == {
        "P_OBJ": tfused._PS_OBJ, "P_N": tfused._PS_N, "P_C": tfused._PS_C,
        "P_K": tfused._PS_K, "P_VALID": tfused._PS_VALID,
        "P_MAT": tfused._PS_MAT,
    }
    assert f"kPsRows = {tfused._PS_ROWS};" in src
    assert f"kAabbRows = {tpc._AABB_ROWS};" in src
    assert "kGroup" not in src and not hasattr(tbvh, "GROUP")
    # the tree K3 walks is ops.bvh's
    assert f"kTreeArity = {tbvh.TREE_ARITY};" in src
    assert f"kTreeStack = 32;" in src
    # a slot test reads whole float4s: rows 0-15 (n, ub, ug, a, b, k) and
    # 16-19 (order, valid, snx, sny); a slot row is a whole number of
    # 16-byte vectors, so every row of a table starts on one
    read = int(re.search(r"kSlotRead = (\d+);", src).group(1))
    assert read == 20 and read % 4 == 0
    assert consts["T_K"] == 15 and consts["T_ORDER"] // 4 == 4
    assert consts["T_VALID"] // 4 == 4 and consts["T_VALID"] < read
    assert (tpc._TRI_ROWS * 4) % 16 == 0 and (tpc._AABB_ROWS * 4) % 16 == 0
    # the instances and the rows K1's shared-memory instance stages
    inst = dict((k, int(v)) for k, v in re.findall(
        r"\b(kInstance\w+) = (\d+)", src))
    assert inst == {"kInstanceK1Global": tfused._K1_GLOBAL,
                    "kInstanceK1Shared": tfused._K1_SHARED,
                    "kInstanceK3": tfused._K3}
    assert f"kMatRows = {tfused._MAT_ROWS};" in src
    assert f"kLightRows = {tfused._LIGHT_ROWS};" in src
    for name in ("fused_forward", "cluster_cast"):
        assert [p.name for p in _build.included_headers(
            _build.SOURCES[name])] == ["cast.cuh", "attributes.cuh"]
    # every library's resource query is the shared header's
    assert [p.name for p in _build.included_headers(
        _build.SOURCES["replay_vjp"])] == ["attributes.cuh"]


def test_build_needs_nvcc(tmp_path, monkeypatch):
    """Without nvcc the build raises; with CUDA_HOME it finds bin/nvcc."""
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "missing")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "nvcc").write_text("")
    assert _build.nvcc_path() == str(tmp_path / "bin" / "nvcc")


def test_library_path_follows_the_source(tmp_path):
    a = tmp_path / "k.cu"
    a.write_text("// one")
    first = _build.library_path(a)
    a.write_text("// two")
    assert _build.library_path(a) != first
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"


def test_library_path_follows_included_headers(tmp_path):
    """A header the source includes, and one that header includes, are
    part of the build key; a header it does not include is not."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n// kernel')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"')
    (tmp_path / "b.cuh").write_text("// one")
    (tmp_path / "c.cuh").write_text("// one")
    src = tmp_path / "k.cu"
    assert [p.name for p in _build.included_headers(src)] == ["a.cuh",
                                                              "b.cuh"]
    first = _build.library_path(src)
    (tmp_path / "c.cuh").write_text("// two")
    assert _build.library_path(src) == first
    (tmp_path / "b.cuh").write_text("// two")
    assert _build.library_path(src) != first


class FakeLib:
    """A stand-in for the kernel library: records each launch's arguments
    and answers the shared-memory limit query with `limit`."""

    def __init__(self, limit=232448):
        self.rc, self.limit, self.calls = 0, limit, []

    def cutrace_fused_forward(self, *args):
        self.calls.append(args)
        return self.rc

    def cutrace_shared_limit(self, out):
        out._obj.value = self.limit
        return 0


def _fake_library(monkeypatch, limit=232448):
    lib = FakeLib(limit)
    monkeypatch.setattr(_build, "load_library",
                        lambda name="fused_forward": lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(tfused, "_SHARED_LIMIT", {})
    return lib


def test_wrapper_launch_contract(scenes_dir, monkeypatch):
    """The CUDA wrapper's host side, with a stand-in library: the launch
    gets the partition's sizes and the instance the size rule picks (K1's
    shared-memory instance for bunny, no tree), each instance's counter
    counts its successful launches only, K3 gets the tree boxes, a CUDA
    error code raises, and rays of the wrong type raise before any
    launch."""
    lib = _fake_library(monkeypatch)
    calls = lib.calls
    soa = torch_soa(_scene(scenes_dir, "bunny.json", 10, 7))
    tables = tfused.kernel_tables(soa, TR.prepare(soa, accel="fused").accel)
    o, d, _ = TR.block_rays(soa)
    before = tfused.LAUNCHES
    big_before = tfused.BIG_LAUNCHES
    global_before = tfused.GLOBAL_LAUNCHES
    color, depth, normal = tfused._fused_forward_cuda(soa, tables, o, d,
                                                      1e-3, 5)
    assert tfused.LAUNCHES == before + 1
    assert tfused.BIG_LAUNCHES == big_before
    assert tfused.GLOBAL_LAUNCHES == global_before
    assert tuple(color.shape) == (70, 3) and tuple(depth.shape) == (70,)
    ints = calls[0][9:20]
    # n_rays (padded to the block), M, C, planes, spheres, lights, mats,
    # bounces, shadow steps, any_refl, any_transp
    assert ints == (128, 16, 64, 5, 0, 4, 6, 5, 1, 1, 0)
    # no code buffer or tally; T and P, the padded triangle and plane
    # leaf lengths; no tree: K1's flat cull, its shared-memory instance
    assert calls[0][21] is None and calls[0][22:24] == (1000, 5)
    assert calls[0][24] is None and calls[0][25] is None
    # the shared-memory instance gets its work counter
    assert calls[0][26:28] == (16, tfused._K1_SHARED)
    assert calls[0][28] is not None
    topo_before = tfused.TOPO_LAUNCHES
    *_, codes = tfused._fused_forward_cuda(soa, tables, o, d, 1e-3, 5,
                                           emit_topo=True)
    assert tfused.TOPO_LAUNCHES == topo_before + 1
    assert tuple(codes.shape) == (70, 30) and codes.dtype == torch.int32
    # the pre-fill: -1 in cast rows, 0 in the opaque flag rows
    assert (codes[:, 0::5] == -1).all() and (codes[:, 1:5] == 0).all()
    assert calls[1][21] is not None
    calls.pop()
    # past 32 clusters the same entry point runs K3 with the tree boxes:
    # M = 125 clusters, 128 leaves
    wide = tbvh.build_accel(soa, 8)
    big_tables = tfused.kernel_tables(soa, wide)
    assert big_tables.tree.shape == (256, 8)
    tfused._fused_forward_cuda(soa, big_tables, o, d, 1e-3, 5)
    assert tfused.BIG_LAUNCHES == big_before + 1
    assert calls[-1][10:12] == (wide.order.shape[0], 8)
    assert calls[-1][25].value == big_tables.tree.data_ptr()
    assert calls[-1][26:28] == (128, tfused._K3) and calls[-1][28] is None
    calls.pop()
    lib.rc = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tfused._fused_forward_cuda(soa, tables, o, d, 1e-3, 5)
    with pytest.raises(ValueError, match="float32"):
        tfused._fused_forward_cuda(soa, tables, o.double(), d, 1e-3, 5)
    assert tfused.LAUNCHES == before + 1 and len(calls) == 2


@pytest.mark.parametrize("case", ["bunny", "bunny 4k", "bunny, small card"])
def test_k1_size_rule(scenes_dir, monkeypatch, case):
    """K1's instance is picked before the launch from the partition's
    staged bytes and the card's shared-memory limit: bunny (M=16, C=64,
    99 KB) fits an H100 block and runs the shared-memory instance
    (LAUNCHES); the 4k bunny (C=128, M=32, 393 KB), or bunny on a card
    whose limit is below its bytes, runs the global-memory instance
    (GLOBAL_LAUNCHES). A failed launch raises and counts nothing."""
    limit = 99000 if case == "bunny, small card" else 232448
    lib = _fake_library(monkeypatch, limit)
    if case == "bunny 4k":
        soa = TR.prepare(port_scene(_subdivided(scenes_dir, 1, 8, 4)),
                         accel="fused", device="cpu")
        soa, accel = soa.soa, soa.accel
        assert tuple(accel.order.shape) == (32, 128)
    else:
        soa = torch_soa(_scene(scenes_dir, "bunny.json", 8, 4))
        accel = TR.prepare(soa, accel="fused").accel
    tables = tfused.kernel_tables(soa, accel)
    m, c = accel.order.shape
    staged = tfused.k1_shared_bytes(soa, tables)
    assert staged == 4 * (m * c * 24 + m * 8 + (5 + 0) * 12
                          + tables.mat.shape[0] * 8 + 4 * 8)
    want = (tfused._K1_SHARED if case == "bunny" else tfused._K1_GLOBAL)
    assert (staged <= limit) == (want == tfused._K1_SHARED)
    assert tfused.k1_instance(soa, tables) == want
    o, d, _ = TR.block_rays(soa)
    counts = (tfused.LAUNCHES, tfused.GLOBAL_LAUNCHES, tfused.TOPO_LAUNCHES,
              tfused.GLOBAL_TOPO_LAUNCHES)
    tfused._fused_forward_cuda(soa, tables, o, d, 1e-3, 5)
    tfused._fused_forward_cuda(soa, tables, o, d, 1e-3, 5, emit_topo=True)
    assert [a[27] for a in lib.calls] == [want, want]
    shared = want == tfused._K1_SHARED
    assert (tfused.LAUNCHES, tfused.GLOBAL_LAUNCHES, tfused.TOPO_LAUNCHES,
            tfused.GLOBAL_TOPO_LAUNCHES) == (
        counts[0] + shared, counts[1] + (not shared),
        counts[2] + shared, counts[3] + (not shared))
    lib.rc = 1
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        tfused._fused_forward_cuda(soa, tables, o, d, 1e-3, 5)
    assert len(lib.calls) == 3 and lib.calls[-1][27] == want
    assert tfused.LAUNCHES + tfused.GLOBAL_LAUNCHES == (
        counts[0] + counts[1] + 1)
