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

    names = tfused._TRI_NAMES
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


def test_prepare_policy(scenes_dir):
    soa = torch_soa(_scene(scenes_dir, "bunny.json", 8, 8))
    assert TR.prepare(soa).accel is None  # "auto" on the CPU
    accel = TR.prepare(soa, accel="fused").accel
    assert tuple(accel.order.shape) == (16, 64)  # C=64, M=16
    with pytest.raises(ValueError):
        TR.prepare(soa, accel="pallas")


def test_scope_is_enforced(scenes_dir):
    """What the kernel does not cover raises NotImplementedError naming
    the ROADMAP item; it never falls back silently."""
    from cutrace_tpu.scene.mesh_io import subdivide

    sc = _scene(scenes_dir, "bunny.json", 8, 8)
    for ob in sc.objects:
        if type(ob).__name__ == "Mesh":
            ob.vertices = subdivide(ob.vertices, 2)  # 16k triangles
    with pytest.raises(NotImplementedError, match="A.10"):
        TR.prepare(port_scene(sc), accel="fused", device="cpu")

    soa = torch_soa(_scene(scenes_dir, "sphere_plane.json", 4, 4))
    with pytest.raises(NotImplementedError, match="127-node"):
        TR.prepare(soa, accel="fused", bounces=6)
    prepared = TR.prepare(soa, accel="fused", bounces=5)
    o, d, _ = TR.block_rays(soa)
    with pytest.raises(NotImplementedError, match="A.10"):
        tfused.fused_render_rays(soa, prepared.accel, o, d, 1e-3, 6)
    # topology codes are in scope now (ROADMAP A.7 done): on CPU tensors
    # the plain emitter answers, shaped as the replay's layout
    *_, codes = tfused.fused_render_rays(soa, prepared.accel, o, d, 1e-3, 2,
                                         emit_topo=True)
    assert tuple(codes.shape) == (16, 49) and codes.dtype == torch.int32
    wide = tbvh.accel_from_numpy(np.zeros((33, 64), np.int32),
                                 np.zeros((33, 64), bool))
    with pytest.raises(NotImplementedError, match="33 clusters"):
        tfused.fused_render_rays(soa, wide, o, d, 1e-3, 1)


def test_kernel_row_layout_matches_source():
    """The (M, C, 24) triangle rows the wrapper packs are the rows the
    CUDA source reads (its T_* constants)."""
    src = _build.SOURCES["fused_forward"].read_text()
    consts = dict(
        (k, int(v)) for k, v in re.findall(r"\b(T_[A-Z]+) = (\d+)", src))
    names = tfused._TRI_NAMES
    assert consts == {
        "T_N": names.index("n0"), "T_UB": names.index("ub0"),
        "T_UG": names.index("ug0"), "T_A": names.index("a0"),
        "T_B": names.index("b0"), "T_K": names.index("k"),
        "T_ORDER": names.index("order"), "T_VALID": names.index("valid"),
        "T_SN": names.index("snx"), "T_OBJ": names.index("obj"),
        "T_MAT": names.index("mat"),
    }
    assert f"kTriRows = {tfused._TRI_ROWS};" in src
    plane_rows = dict(
        (k, int(v)) for k, v in re.findall(r"\b(P_[A-Z]+) = (\d+)", src))
    assert plane_rows == {
        "P_OBJ": tfused._PS_OBJ, "P_N": tfused._PS_N, "P_C": tfused._PS_C,
        "P_K": tfused._PS_K, "P_VALID": tfused._PS_VALID,
        "P_MAT": tfused._PS_MAT,
    }
    assert f"kPsRows = {tfused._PS_ROWS};" in src
    assert f"kAabbRows = {tfused._AABB_ROWS};" in src


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


def test_wrapper_launch_contract(scenes_dir, monkeypatch):
    """The CUDA wrapper's host side, with a stand-in library: the launch
    gets the partition's sizes, LAUNCHES counts successful launches only,
    a CUDA error code raises, and rays of the wrong type raise before any
    launch."""
    calls = []

    class FakeLib:
        rc = 0

        def cutrace_fused_forward(self, *args):
            calls.append(args)
            return self.rc

    lib = FakeLib()
    monkeypatch.setattr(_build, "load_library",
                        lambda name="fused_forward": lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    soa = torch_soa(_scene(scenes_dir, "bunny.json", 10, 7))
    tables = tfused.kernel_tables(soa, TR.prepare(soa, accel="fused").accel)
    o, d, _ = TR.block_rays(soa)
    before = tfused.LAUNCHES
    color, depth, normal = tfused._fused_forward_cuda(soa, tables, o, d,
                                                      1e-3, 5)
    assert tfused.LAUNCHES == before + 1
    assert tuple(color.shape) == (70, 3) and tuple(depth.shape) == (70,)
    ints = calls[0][9:20]
    # n_rays (padded to the block), M, C, planes, spheres, lights, mats,
    # bounces, shadow steps, any_refl, any_transp
    assert ints == (128, 16, 64, 5, 0, 4, 6, 5, 1, 1, 0)
    # no code buffer or tally; T and P, the padded triangle and plane
    # leaf lengths
    assert calls[0][21] is None and calls[0][22:24] == (1000, 5)
    assert calls[0][24] is None
    topo_before = tfused.TOPO_LAUNCHES
    *_, codes = tfused._fused_forward_cuda(soa, tables, o, d, 1e-3, 5,
                                           emit_topo=True)
    assert tfused.TOPO_LAUNCHES == topo_before + 1
    assert tuple(codes.shape) == (70, 30) and codes.dtype == torch.int32
    # the pre-fill: -1 in cast rows, 0 in the opaque flag rows
    assert (codes[:, 0::5] == -1).all() and (codes[:, 1:5] == 0).all()
    assert calls[1][21] is not None
    calls.pop()
    lib.rc = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tfused._fused_forward_cuda(soa, tables, o, d, 1e-3, 5)
    with pytest.raises(ValueError, match="float32"):
        tfused._fused_forward_cuda(soa, tables, o.double(), d, 1e-3, 5)
    assert tfused.LAUNCHES == before + 1 and len(calls) == 2
