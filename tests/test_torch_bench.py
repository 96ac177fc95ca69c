"""The port's command-line tools on the CPU: the inverse-rendering
example (cutrace_tpu_torch.inverse_rendering) at a tiny size, its two fits
against the JAX package's fit with the example's arguments; the example
and the big-scene timer refusing to run without a card; and the spread
(utils.profiling.spread) that the scaling sweep's lines carry."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutrace_tpu.diff.camera import apply_look_at, camera_to_look_at
from cutrace_tpu.diff.grad import render_image_flat
from cutrace_tpu.parallel import make_mesh
from cutrace_tpu.parallel.train import fit as jax_fit
from cutrace_tpu.scene.loader import load_scene
from cutrace_tpu.scene.soa import scene_to_soa as jax_soa
from cutrace_tpu_torch import bigscene
from cutrace_tpu_torch import inverse_rendering as ir
from cutrace_tpu_torch.utils.profiling import spread

torch.set_num_threads(2)


@pytest.mark.parametrize("entry", [ir.main, bigscene.main],
                         ids=["inverse_rendering", "bigscene"])
def test_tools_need_the_card(entry, monkeypatch):
    """Without a card and without --device cpu they stop; they never run
    on the CPU by themselves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="device='cpu'"):
        entry([])


@pytest.mark.parametrize("n, name, k", [(50, "p80", 40), (20, "p50", 10),
                                        (11, "p9", 1), (10, None, 0),
                                        (3, None, 0)])
def test_spread_names_the_highest_percentile_with_ten_beyond(n, name, k):
    samples = list(np.random.default_rng(n).permutation(n) + 1.0)
    got = spread(samples)
    assert got["n"] == n and got["percentile"] == name
    assert got["median"] == pytest.approx(np.median(samples))
    if name is not None:
        assert got[name] == k
        assert sum(x > got[name] for x in samples) == 10


def _jax_example(scenes_dir, w, h, steps, camera_steps):
    """examples/inverse_rendering.py's two fits through the JAX package on
    a one-device CPU mesh."""
    import jax

    sc = load_scene(scenes_dir / "sphere_plane.json")
    sc.camera.width, sc.camera.height = w, h
    soa = jax_soa(sc)
    target, _, _ = render_image_flat(soa, 2, 1e-3)
    corrupt = dataclasses.replace(soa,
                                  mat_color=jnp.full_like(soa.mat_color, 0.5))
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    params, losses = jax_fit(corrupt, target, mesh, steps=steps, lr=5e-2,
                             bounces=2, param_filter=("mat_color",))
    true_cam = camera_to_look_at(soa)
    shaken = apply_look_at(soa, dict(
        true_cam,
        cam_eye=true_cam["cam_eye"] + jnp.asarray([0.08, -0.05, 0.06])))
    target_b1, _, _ = render_image_flat(soa, 1, 1e-3)
    cam_params, cam_losses = jax_fit(shaken, target_b1, mesh,
                                     steps=camera_steps, lr=4e-3, bounces=1,
                                     param_filter=("cam_eye",),
                                     camera="look_at")
    return params, losses, cam_params, cam_losses, true_cam


def test_example_matches_jax(scenes_dir):
    """inverse_rendering.run on the CPU (16x9, 3 color steps and 3 camera
    steps) against the JAX package's fit with the example's arguments:
    the losses of both fits within rtol 1e-4 and falling, the recovered
    colors and eye allclose, the eye's error from the true eye."""
    got = ir.run(device="cpu", width=16, height=9, steps=3, camera_steps=3)
    params, losses, cam_params, cam_losses, true_cam = _jax_example(
        scenes_dir, 16, 9, 3, 3)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(got["camera_losses"], cam_losses, rtol=1e-4)
    for ours in (got["losses"], got["camera_losses"]):
        assert len(ours) == 3 and ours[-1] < ours[0]
    np.testing.assert_allclose(got["params"]["mat_color"],
                               np.asarray(params["mat_color"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["camera_params"]["cam_eye"],
                               np.asarray(cam_params["cam_eye"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["true_eye"],
                               np.asarray(true_cam["cam_eye"]), rtol=1e-6)
    np.testing.assert_allclose(
        got["eye_error"],
        np.abs(got["camera_params"]["cam_eye"] - got["true_eye"]))
