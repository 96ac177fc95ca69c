"""Port parity: cutrace_tpu_torch.ops.intersect.ray_cast against the JAX
ray_cast on 4096 seeded rays per scene.

Winners (hit, obj, mat) must agree wherever the JAX nearest hit is at
least 1e-5 nearer than the next surface along the ray: closer calls are
knife edges that float32 rounding may resolve either way. t, point and
normal agree to rtol 1e-5, atol 1e-5 on those rays (the two packages sum
the same products in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutrace_tpu.ops import intersect as JI
from cutrace_tpu.scene.loader import load_scene
from cutrace_tpu.scene.soa import scene_to_soa as jax_soa
from cutrace_tpu_torch.ops import intersect as TI
from cutrace_tpu_torch.scene.soa import scene_to_soa
from test_torch_host import port_scene

torch.set_num_threads(2)


def torch_soa(sc):
    return scene_to_soa(port_scene(sc), device="cpu")

N_RAYS = 4096
GAP = 1e-5
SCENES = ["triangle.json", "bunny.json", "bunny_small.json", "mirror.json",
          "sphere_plane.json"]


def _rays(sc, seed):
    """Half camera rays from around the eye, half rays from random points
    of the scene's bounding box in random directions."""
    rng = np.random.default_rng(seed)
    eye = np.asarray(sc.camera.eye, np.float32)
    fwd, right, up = sc.camera.basis()
    n = N_RAYS // 2
    sx, sy = rng.uniform(-1.0, 1.0, (2, n, 1)).astype(np.float32)
    d_cam = fwd[None] + sx * right[None] + sy * up[None]
    o_cam = eye[None] + rng.normal(0.0, 0.05, (n, 3))
    soa = jax_soa(sc)
    pts = np.concatenate([np.asarray(soa.tri_p1)[np.asarray(soa.tri_valid)],
                          np.asarray(soa.sp_center)[np.asarray(soa.sp_valid)],
                          eye[None]])
    lo, hi = pts.min(0), pts.max(0)
    o_box = rng.uniform(lo - 0.1, hi + 0.1, (n, 3))
    d_box = rng.normal(size=(n, 3))
    o = np.concatenate([o_cam, o_box]).astype(np.float32)
    d = np.concatenate([d_cam, d_box]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("scene", SCENES)
def test_ray_cast_matches_jax(scenes_dir, scene):
    sc = load_scene(scenes_dir / scene)
    o, d = _rays(sc, seed=SCENES.index(scene))
    js = jax_soa(sc)
    ref = JI.ray_cast(js, jnp.asarray(o), jnp.asarray(d), 1e-3)
    t_ref = np.asarray(ref.t)
    # the next surface along each ray, for the knife-edge filter
    second = JI.ray_cast(js, jnp.asarray(o), jnp.asarray(d),
                         jnp.where(jnp.isfinite(ref.t), ref.t, 1e-3),
                         need_attrs=False)
    with np.errstate(invalid="ignore"):
        gap = np.where(np.isfinite(t_ref), np.asarray(second.t) - t_ref,
                       np.inf)
    clear = gap > GAP

    out = TI.ray_cast(torch_soa(sc), torch.from_numpy(o),
                      torch.from_numpy(d), 1e-3)
    hit = out.hit.numpy()
    assert clear.mean() > 0.95
    assert np.asarray(ref.hit).any()
    for name in ("hit", "obj", "mat"):
        got = getattr(out, name).numpy()
        want = np.asarray(getattr(ref, name))
        assert np.array_equal(got[clear], want[clear]), name
    both = clear & hit
    for name in ("t", "point", "normal"):
        got = getattr(out, name).numpy()[both]
        want = np.asarray(getattr(ref, name))[both]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert np.isinf(out.t.numpy()[clear & ~hit]).all()
    # uv: NaN where a plane's normal is parallel to z, as in the reference
    np.testing.assert_allclose(out.uv.numpy()[both],
                               np.asarray(ref.uv)[both], rtol=1e-4,
                               atol=1e-4, err_msg="uv")


@pytest.mark.parametrize("scene", ["bunny.json", "sphere_plane.json"])
def test_ray_cast_without_attrs(scenes_dir, scene):
    """need_attrs=False (the shadow-march query) keeps the winner."""
    sc = load_scene(scenes_dir / scene)
    o, d = _rays(sc, seed=7)
    soa = torch_soa(sc)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    full = TI.ray_cast(soa, o, d, 1e-3)
    bare = TI.ray_cast(soa, o, d, 1e-3, need_attrs=False)
    for name in ("hit", "t", "obj", "mat"):
        assert torch.equal(getattr(full, name), getattr(bare, name)), name

