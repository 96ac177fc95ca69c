"""Port parity: the composable torch renderer (render.shading +
render.renderer, accel="none") against the JAX composable renderer and the
float64 golden renderer.

Gates: against JAX, tests/test_fused.py's _compare (np.isclose atol 2e-4,
no mismatch off the reference image's discontinuities, at most 5 % of the
edge pixels); against cpuref, tests/test_device_renderer.py's 1e-3 gate."""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from cutrace_tpu.render import cpuref
from cutrace_tpu.render import renderer as JR
from cutrace_tpu.scene.loader import load_scene
from cutrace_tpu.scene.soa import scene_to_soa as jax_soa
from cutrace_tpu_torch.render import renderer as TR
from cutrace_tpu_torch.render import shading as TS
from cutrace_tpu_torch.scene.soa import scene_to_soa
from test_device_renderer import assert_image_close
from test_fused import _compare
from test_torch_host import port_scene

torch.set_num_threads(2)


def torch_soa(sc):
    return scene_to_soa(port_scene(sc), device="cpu")


def _scene(scenes_dir, name, w, h):
    sc = load_scene(scenes_dir / name)
    sc.camera.width, sc.camera.height = w, h
    return sc


@pytest.mark.parametrize(
    "scene,w,h,bounces",
    [
        ("triangle.json", 20, 20, 5),
        ("bunny.json", 48, 27, 3),
        ("mirror.json", 48, 27, 3),
        ("sphere_plane.json", 48, 27, 3),
    ],
)
def test_render_matches_jax(scenes_dir, scene, w, h, bounces):
    sc = _scene(scenes_dir, scene, w, h)
    base = JR.render(JR.prepare(jax_soa(sc), accel="none"), bounces=bounces)
    out = TR.render(TR.prepare(torch_soa(sc), accel="none"), bounces=bounces)
    assert [tuple(x.shape) for x in out] == [(h, w, 3), (h, w), (h, w, 3)]
    _compare([np.asarray(x) for x in base], [x.numpy() for x in out],
             atol=2e-4)


def test_render_matches_cpuref(scenes_dir):
    sc = _scene(scenes_dir, "bunny.json", 32, 18)
    c_ref, d_ref, n_ref = cpuref.render_cpu(sc, bounces=2)
    c, d, n = (x.numpy() for x in TR.render(port_scene(sc), bounces=2,
                                               device="cpu"))
    assert_image_close(c, c_ref, "color")
    assert_image_close(d, d_ref, "depth")
    assert_image_close(n, n_ref, "normal")


def test_render_chunking_is_invisible(scenes_dir):
    """Per-ray results do not depend on how rays are batched."""
    soa = torch_soa(_scene(scenes_dir, "mirror.json", 24, 14))
    whole = TR.render(soa, bounces=2)
    chunked = TR.render(soa, bounces=2, chunk=40)
    for a, b in zip(whole, chunked):
        assert torch.allclose(a, b, atol=1e-6, equal_nan=True)


def test_block_order_is_a_permutation():
    order, inverse = TR._block_order(50, 20, 1024)
    assert sorted(order.tolist()) == list(range(1024))
    assert np.array_equal(order[inverse], np.arange(1024))
    # the first 32x16 block comes first
    first = order[:32 * 16]
    assert set((first % 50).tolist()) == set(range(32))
    assert set((first // 50).tolist()) == set(range(16))


def test_ray_color_matches_recursion(scenes_dir):
    """The level-wavefront ray_color equals the reference recursion
    (rgb = phong; += r * C(refl); = (1-f) rgb + f C(straight)) written out
    per node, on sphere_plane's two-branch tree."""
    soa = torch_soa(_scene(scenes_dir, "sphere_plane.json", 16, 9))
    idx = torch.arange(16 * 9)
    o, d = TR.camera_rays(soa, idx % 16, idx // 16)

    def recursive(o, d, bounces):
        from cutrace_tpu_torch.ops import intersect as TI

        hit = TI.ray_cast(soa, o, d, 1e-3, need_uv=False)
        rgb = torch.where(hit.hit[:, None], TS.phong(soa, d, hit), 0.0)
        if bounces == 0:
            return rgb
        t_safe = torch.where(hit.hit, hit.t, 1.0)
        child_o = o + t_safe[:, None] * d
        unit_z = torch.tensor([0.0, 0.0, 1.0])
        nrm = torch.where(hit.hit[:, None], hit.normal, unit_z)
        refl_d = TS._reflect(TS._normalize(d), TS._normalize(nrm))
        refl = soa.mat_reflect[hit.mat]
        r = torch.where(hit.hit & (refl >= 1e-6), refl, 0.0)[:, None]
        rgb = rgb + r * recursive(child_o, refl_d, bounces - 1)
        tr = soa.mat_transparency[hit.mat]
        f = torch.where(hit.hit & (tr >= 1e-6), tr, 0.0)[:, None]
        return (1.0 - f) * rgb + f * recursive(child_o, d, bounces - 1)

    wave = TS.ray_color(soa, o, d, 1e-3, 2)
    assert torch.allclose(wave, recursive(o, d, 2), atol=1e-5)


GLUE_SCENES = ["triangle.json", "bunny.json", "mirror.json",
               "sphere_plane.json"]


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("accel", ["none", "clusters", "pallas"])
@pytest.mark.parametrize("scene", GLUE_SCENES)
def test_render_rays_casts_the_primary_once(scenes_dir, scene, accel):
    """render_rays takes depth and normal from the bounce tree's level-0
    hit: bit-identical to the two-cast formula (a primary ray_cast, then
    ray_color casting the same rays again), at 48x27 b3."""
    from cutrace_tpu_torch.ops import bvh as TB
    from cutrace_tpu_torch.ops import intersect as TI

    p = TR.prepare(torch_soa(_scene(scenes_dir, scene, 48, 27)), accel=accel)
    soa = p.soa
    tc = TB.candidates_fn(p.accel, p.tables)
    o, d, _ = TR.block_rays(soa)
    primary = TI.ray_cast(soa, o, d, 1e-3, tc, need_uv=False)
    color = TS.ray_color(soa, o, d, 1e-3, 3, tc)
    got = TR.render_rays(soa, o, d, 3, 1e-3, tc)
    for a, b in zip(got, (color, primary.t, primary.normal)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("w,h", [(1920, 1080), (480, 270)])
def test_camera_rays_match_jax(scenes_dir, w, h):
    """The port's pinhole rays equal JAX's bit for bit on sampled pixels
    (the corners and 4096 seeded ones): w, h and the aspect ratio are
    float32 as in the JAX package."""
    sc = _scene(scenes_dir, "bunny.json", w, h)
    rng = np.random.default_rng(w)
    px = np.concatenate([[0, w - 1, 0, w - 1], rng.integers(0, w, 4096)])
    py = np.concatenate([[0, 0, h - 1, h - 1], rng.integers(0, h, 4096)])
    jo, jd = JR.camera_rays(jax_soa(sc), px, py)
    to, td = TR.camera_rays(torch_soa(sc), torch.from_numpy(px),
                            torch.from_numpy(py))
    assert np.array_equal(np.asarray(jo), to.numpy())
    assert np.array_equal(np.asarray(jd), td.numpy())
    # float32 pixel coordinates (the block order's) give the same rays
    fo, fd = TR.camera_rays(torch_soa(sc), torch.from_numpy(px).float(),
                            torch.from_numpy(py).float())
    assert torch.equal(fd, td) and torch.equal(fo, to)


def test_block_order_tensors_are_uploaded_once():
    """block_order_tensors hands out the same tensors for a key, holding
    _block_order's order and inverse and the visited pixels' float32
    coordinates."""
    a = TR.block_order_tensors(50, 20, 1024, "cpu")
    b = TR.block_order_tensors(50, 20, 1024, torch.device("cpu"))
    assert all(x is y for x, y in zip(a, b))
    order, inverse = TR._block_order(50, 20, 1024)
    assert np.array_equal(a.order.numpy(), order)
    assert np.array_equal(a.inverse.numpy(), inverse)
    assert a.pxy.dtype == torch.float32 and tuple(a.pxy.shape) == (2, 1024)
    assert np.array_equal(a.px.numpy(), (order % 50).astype(np.float32))
    assert np.array_equal(a.py.numpy(), (order // 50).astype(np.float32))
    assert TR.block_order_tensors(50, 20, 1000, "cpu").order is not a.order


def _no_host_tensors(monkeypatch):
    """Make torch.tensor, torch.as_tensor and torch.from_numpy raise: on a
    card each is a copy from the host, which no CUDA-graph capture
    holds."""
    def refuse(*args, **kwargs):
        raise AssertionError("a tensor made from host data in a warm chunk")

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)


def chunk_is_capturable(monkeypatch, prepared, bounces):
    """Run one composable chunk twice, the second time with host tensors
    refused; both give the same rows."""
    from cutrace_tpu_torch.ops import bvh as TB

    soa = prepared.soa
    tc = TB.candidates_fn(prepared.accel, prepared.tables)
    bo = TR.block_order_tensors(soa.width, soa.height,
                                soa.width * soa.height, soa.device)
    xy = bo.pxy[:, :64].clone()
    warm = TR._chunk(soa, xy, bounces, 1e-3, tc)
    with monkeypatch.context() as mp:
        _no_host_tensors(mp)
        again = TR._chunk(soa, xy, bounces, 1e-3, tc)
    assert torch.equal(_bits(warm), _bits(again))


@pytest.mark.parametrize("accel", ["none", "clusters"])
@pytest.mark.parametrize("scene", ["mirror.json", "sphere_plane.json"])
def test_warm_chunk_makes_no_host_tensor(scenes_dir, monkeypatch, scene,
                                         accel):
    """The composable chunk (camera rays, primary cast, bounce tree,
    shading, shadow march) creates no tensor from host data once warm:
    the CPU's stand-in for "capturable as a CUDA graph"."""
    p = TR.prepare(torch_soa(_scene(scenes_dir, scene, 16, 9)), accel=accel)
    chunk_is_capturable(monkeypatch, p, 3)


def test_render_eager_is_render_on_the_cpu(scenes_dir):
    """On the CPU render runs the eager loop: render_eager gives the same
    bits, fused and composable."""
    sc = _scene(scenes_dir, "mirror.json", 24, 14)
    for accel in ("fused", "pallas", "none"):
        p = TR.prepare(torch_soa(sc), accel=accel)
        for a, b in zip(TR.render(p, bounces=2), TR.render_eager(p, 2)):
            assert torch.equal(_bits(a), _bits(b))


@pytest.fixture
def program_cache(monkeypatch):
    monkeypatch.setattr(TR, "_PROGRAMS", collections.OrderedDict())
    monkeypatch.setattr(TR, "_OWNERS", {})
    return TR._PROGRAMS


def test_programs_are_cached_by_identity(scenes_dir, program_cache):
    """A program is found again for the same scene object and key, never
    for an equal-valued copy; it goes with its scene, and the least
    recently used goes past PROGRAM_CACHE_SIZE."""
    import gc

    soa = torch_soa(_scene(scenes_dir, "triangle.json", 8, 8))
    builds = []

    def build():
        builds.append(object())
        return builds[-1]

    first = TR._program(soa, ("padded", 2, 1e-3, 64), build)
    assert TR._program(soa, ("padded", 2, 1e-3, 64), build) is first
    twin = dataclasses.replace(soa)
    assert TR._program(twin, ("padded", 2, 1e-3, 64), build) is not first
    assert TR._program(soa, ("padded", 3, 1e-3, 64), build) is not first
    assert len(builds) == 3 and len(program_cache) == 3
    del twin
    gc.collect()
    assert len(program_cache) == 2
    others = [dataclasses.replace(soa)
              for _ in range(TR.PROGRAM_CACHE_SIZE)]
    for o in others:
        TR._program(o, ("fused", 2, 1e-3), build)
    assert len(program_cache) == TR.PROGRAM_CACHE_SIZE
    assert first not in program_cache.values()
    del others, o, soa
    gc.collect()
    assert not program_cache


@pytest.mark.parametrize("scene,bounces", [("mirror.json", 3),
                                           ("sphere_plane.json", 3)])
def test_ray_color_recursive_matches_jax(scenes_dir, scene, bounces):
    """The reference recursion written out per node (ray_color_recursive)
    against the JAX package's and against the port's wavefront ray_color,
    on a mirror chain and a two-branch tree with transparency, at b3."""
    from cutrace_tpu.render import shading as JS

    sc = _scene(scenes_dir, scene, 16, 9)
    js, ts = jax_soa(sc), torch_soa(sc)
    idx = np.arange(16 * 9)
    jo, jd = JR.camera_rays(js, idx % 16, idx // 16)
    o, d = TR.camera_rays(ts, torch.from_numpy(idx % 16),
                          torch.from_numpy(idx // 16))
    got = TS.ray_color_recursive(ts, o, d, 1e-3, bounces).numpy()
    want = np.asarray(JS.ray_color_recursive(js, jo, jd, 1e-3, bounces))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    np.testing.assert_allclose(got, TS.ray_color(ts, o, d, 1e-3,
                                                 bounces).numpy(),
                               atol=2e-4, rtol=0)
