"""Port parity: the training surface's gradients (cutrace_tpu_torch.diff)
against the JAX package.

The port's end-to-end gradient runs fused_render_rays as its autograd
Function on the CPU: the plain forward with the plain topology emitter,
then the plain replay backward. It is held against jax.grad of JAX's
render_loss (the composable pipeline) on the configurations of
tests/test_gradients.py, with tests/test_replay.py:89-94's gate: relative
error below 2e-4 per parameter group."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutrace_tpu.diff import camera as jcam
from cutrace_tpu.diff import grad as jgrad
from cutrace_tpu.scene.loader import load_scene
from cutrace_tpu.scene.soa import scene_to_soa as jax_soa
from cutrace_tpu_torch.diff import camera as tcam
from cutrace_tpu_torch.diff import grad as tgrad
from cutrace_tpu_torch.ops import bvh as tbvh
from cutrace_tpu_torch.ops import fused as tfused
from cutrace_tpu_torch.render import renderer as TR
from cutrace_tpu_torch.scene import soa as tsoa
from test_torch_host import port_scene

torch.set_num_threads(2)


def _pair(scenes_dir, name, w, h):
    sc = load_scene(scenes_dir / name)
    sc.camera.width, sc.camera.height = w, h
    return jax_soa(sc), tsoa.scene_to_soa(port_scene(sc), device="cpu")


@pytest.mark.parametrize("name,w,h,bounces", [
    ("triangle.json", 12, 12, 1),
    ("triangle.json", 16, 9, 2),
    ("sphere_plane.json", 16, 9, 2),
    ("mirror.json", 16, 9, 2),
])
def test_grad_matches_jax(scenes_dir, name, w, h, bounces):
    js, ts = _pair(scenes_dir, name, w, h)
    color, _, _ = jgrad.render_image_flat(js, bounces, 1e-3)
    target = 0.5 * np.asarray(color) + 0.1
    _, want = jgrad.grad_render_loss(js, jnp.asarray(target), bounces)
    accel = TR.prepare(ts, accel="fused").accel
    before = tfused.LAUNCHES
    loss, got = tgrad.grad_render_loss(ts, torch.from_numpy(target),
                                       bounces, accel=accel)
    assert tfused.LAUNCHES == before  # CPU tensors: plain versions only
    assert np.isfinite(loss.item())
    assert set(got) == set(tgrad.DIFFERENTIABLE_FIELDS)
    for k in tgrad.DIFFERENTIABLE_FIELDS:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert np.isfinite(a).all(), k
        scale = max(np.abs(b).max(), 1e-6)
        err = np.abs(a - b).max() / scale
        assert err < 2e-4, f"{name} b{bounces} {k}: rel err {err:.3e}"


def test_function_matches_composable_autograd(scenes_dir):
    """The autograd Function (topology replay backward) and autograd of
    the port's composable pipeline give the same gradients, depth and
    normal outputs included."""
    _, ts = _pair(scenes_dir, "bunny.json", 24, 12)
    accel = TR.prepare(ts, accel="fused").accel
    params = {k: v.clone().requires_grad_()
              for k, v in tgrad.extract_params(ts).items()}

    def loss(acc):
        c, dep, nrm = tgrad.render_image_flat(tgrad.with_params(ts, params),
                                              2, 1e-3, acc)
        fin = torch.isfinite(dep)
        return (torch.mean(c) + torch.mean(torch.where(fin, dep, 0.0))
                + torch.mean(nrm))

    ga = torch.autograd.grad(loss(accel), list(params.values()))
    gb = torch.autograd.grad(loss(None), list(params.values()))
    for k, a, b in zip(params, ga, gb):
        scale = max(b.abs().max().item(), 1e-6)
        err = (a - b).abs().max().item() / scale
        assert err < 2e-4, f"{k}: rel err {err:.3e}"


def test_params_round_trip_jax(scenes_dir):
    """params_from_numpy of JAX's extract_params equals the port's
    extract_params, key by key and bit for bit, in both camera views."""
    js, ts = _pair(scenes_dir, "bunny.json", 16, 9)
    for camera in ("raw", "look_at"):
        jp = jgrad.extract_params(js, camera=camera)
        got = tsoa.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                     device="cpu")
        want = tgrad.extract_params(ts, camera=camera)
        assert list(got) == list(want)
        for k in want:
            if camera == "look_at" and k != "cam_eye":
                # rebuilt in float32 by two frameworks: an ulp apart
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                           rtol=1e-6, atol=1e-7, err_msg=k)
            else:
                assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="raw"):
        tgrad.extract_params(ts, camera="orbit")


@pytest.mark.parametrize("name", ["bunny.json", "sphere_plane.json",
                                  "mirror.json", "triangle.json"])
def test_look_at_round_trip(scenes_dir, name):
    """apply_look_at(camera_to_look_at(soa)) reproduces the authored
    basis, and matches the JAX package's look_at_basis."""
    js, ts = _pair(scenes_dir, name, 16, 9)
    rt = tcam.apply_look_at(ts, tcam.camera_to_look_at(ts))
    for f in ("cam_eye", "cam_forward", "cam_right", "cam_up"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   getattr(ts, f).numpy(), atol=1e-5,
                                   err_msg=f)
    la = jcam.camera_to_look_at(js)
    want = jcam.look_at_basis(*(la[k] for k in ("cam_eye", "cam_target",
                                                "cam_up_hint", "cam_scales")))
    got = tcam.look_at_basis(*(torch.from_numpy(np.array(la[k])) for k in
                               ("cam_eye", "cam_target", "cam_up_hint",
                                "cam_scales")))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_look_at_left_handed_and_partial(scenes_dir):
    """A left-handed authored basis round-trips (the sign rides in
    cam_scales[1]); a partial look-at dict raises naming what is
    missing."""
    _, ts = _pair(scenes_dir, "bunny.json", 16, 9)
    lh = dataclasses.replace(ts, cam_right=-ts.cam_right)
    la = tcam.camera_to_look_at(lh)
    assert la["cam_scales"][1].item() < 0
    rt = tcam.apply_look_at(lh, la)
    for f in ("cam_eye", "cam_forward", "cam_right", "cam_up"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   getattr(lh, f).numpy(), atol=1e-5)
    params = tgrad.extract_params(ts, camera="look_at")
    del params["cam_up_hint"], params["cam_scales"]
    with pytest.raises(ValueError, match="cam_up_hint.*cam_scales"):
        tgrad.with_params(ts, params)


def test_look_at_gradient_reaches_the_eye(scenes_dir):
    """Gradients through the look-at view reach eye and target."""
    _, ts = _pair(scenes_dir, "bunny.json", 16, 9)
    params = {k: v.clone().requires_grad_()
              for k, v in tgrad.extract_params(ts, camera="look_at").items()}
    target = torch.zeros((16 * 9, 3))
    loss = tgrad.render_loss(params, ts, target, 1,
                             accel=TR.prepare(ts, accel="fused").accel)
    loss.backward()
    for k in ("cam_eye", "cam_target", "cam_scales"):
        assert torch.isfinite(params[k].grad).all(), k
    assert params["cam_eye"].grad.abs().sum() > 0


def test_emit_topo_past_budget_raises(scenes_dir):
    """Asking for codes past the replay's budgets raises, naming the
    limit and the composable backward, instead of falling back."""
    _, ts = _pair(scenes_dir, "sphere_plane.json", 4, 4)
    accel = tbvh.accel_from_numpy(np.full((1, 64), 2**30, np.int32),
                                  np.zeros((1, 64), bool), device="cpu")
    o, d, _ = TR.block_rays(ts)
    import cutrace_tpu_torch.ops.replay as rp

    old = rp.REPLAY_MAX_CODE_BYTES
    rp.REPLAY_MAX_CODE_BYTES = 1
    try:
        with pytest.raises(NotImplementedError,
                           match="limits of .* composable backward"):
            tfused.fused_render_rays(ts, accel, o, d, 1e-3, 2,
                                     emit_topo=True)
    finally:
        rp.REPLAY_MAX_CODE_BYTES = old
