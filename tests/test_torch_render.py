"""Port parity: the composable torch renderer (render.shading +
render.renderer, accel="none") against the JAX composable renderer and the
float64 golden renderer.

Gates: against JAX, tests/test_fused.py's _compare (np.isclose atol 2e-4,
no mismatch off the reference image's discontinuities, at most 5 % of the
edge pixels); against cpuref, tests/test_device_renderer.py's 1e-3 gate."""

import numpy as np
import pytest
import torch

from cutrace_tpu.render import cpuref
from cutrace_tpu.render import renderer as JR
from cutrace_tpu.scene.loader import load_scene
from cutrace_tpu.scene.soa import scene_to_soa as jax_soa
from cutrace_tpu_torch.render import renderer as TR
from cutrace_tpu_torch.render import shading as TS
from cutrace_tpu_torch.scene.soa import scene_to_soa as torch_soa
from test_device_renderer import assert_image_close
from test_fused import _compare

torch.set_num_threads(2)


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
    c, d, n = (x.numpy() for x in TR.render(sc, bounces=2))
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
