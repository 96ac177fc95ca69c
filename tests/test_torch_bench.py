"""The port's bench (cutrace_tpu_torch.bench) and inverse-rendering
example (cutrace_tpu_torch.inverse_rendering) on the CPU at tiny sizes:
the bench's lines, their order, fields and checks, and the example's two
fits against the JAX package's fit with the example's arguments."""

import dataclasses
import json

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
from cutrace_tpu_torch import bench
from cutrace_tpu_torch import inverse_rendering as ir
from cutrace_tpu_torch.utils.profiling import casts_per_pixel, spread

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--size", "16x9", "--bounces", "1", "--reps",
        "2", "--levels", "1"]
# the lines of a --levels 1 run, in order; the names of the full run but
# for the one bigscene level (4k)
LINES = ("probe", "frame/mirror_1080p_b5", "frame/sphere_plane_1080p_b5",
         "frame/bunny_1080p_b5_pallas", "bigscene/4k_960x540_b5",
         "bunny_1080p_grad_step", "sphere_plane_1080p_grad_step",
         "step/bunny_256k_960x540_b5", "fit/inverse_rendering_example",
         "kernel/K1", "kernel/K1_topo", "kernel/K2", "kernel/K3",
         "kernel/K4", "bunny_1080p_ray_casts")
FIELDS = ("metric", "value", "unit", "median", "percentile", "n",
          "correct", "backend", "card", "seconds")


def _lines(capsys):
    out = capsys.readouterr().out
    return [json.loads(ln) for ln in out.splitlines() if ln.strip()]


def test_bench_lines_on_the_cpu(capsys):
    """Every line of the bench, in order and parseable, each with its
    fields, on the CPU and passing its check; kernel times "not
    measured"; Mcasts/s the pixels' casts over the median frame; the
    headline last."""
    assert bench.main(TINY, fit_steps=(2, 2)) == 0
    rows = _lines(capsys)
    assert tuple(r["metric"] for r in rows) == LINES
    for r in rows:
        assert set(FIELDS) <= set(r), r["metric"]
        assert r["backend"] == "cpu" and r["card"] is None, r["metric"]
        assert r["correct"] is True, r
        assert r["seconds"] > 0
    by = {r["metric"]: r for r in rows}
    for name in LINES:
        if name.startswith("kernel/"):
            r = by[name]
            assert r["value"] == r["median"] == r["share"] == "not measured"
            assert r["n"] == 0
    # K2's bound needs no card: it is read off the codes
    assert by["kernel/K2"]["bound_ms"] > 0
    assert by["probe"]["value"] == "not measured"
    for name in ("frame/mirror_1080p_b5", "frame/sphere_plane_1080p_b5",
                 "frame/bunny_1080p_b5_pallas", "bigscene/4k_960x540_b5",
                 "bunny_1080p_ray_casts"):
        r = by[name]
        assert r["n"] == 2 and r["percentile"] is None
        assert r["size"] == "16x9" and r["bounces"] == 1
        assert r["mcasts_per_s"] == pytest.approx(
            16 * 9 * r["casts_per_pixel"] / r["median"] / 1e3)
        assert r["equals_render_eager"] and r["finite"]
    head = rows[-1]
    assert head["unit"] == "Mcasts/s" and head["sample_unit"] == "ms"
    assert head["value"] == head["mcasts_per_s"]
    assert head["gate"]["passes"]
    for name in ("bunny_1080p_grad_step", "sphere_plane_1080p_grad_step",
                 "step/bunny_256k_960x540_b5"):
        r = by[name]
        assert r["unit"] == "s/step" and r["backward"] == "k2"
        assert r["groups"] == 19 and r["grads_bit_equal"] and r["finite"]
        assert len(r["first_calls_ms"]) == 3
    fit = by["fit/inverse_rendering_example"]
    assert fit["steps"] == [2, 2] and fit["n"] == 2
    assert fit["color_loss"][1] < fit["color_loss"][0]
    assert fit["camera_loss"][1] < fit["camera_loss"][0]


def test_bench_exits_1_after_a_failed_check(capsys, monkeypatch):
    """A line whose check fails is printed with correct false, and the
    run goes on to exit 1."""
    monkeypatch.setattr(bench, "_frames_equal", lambda a, b: False)
    assert bench.main(TINY + ["--only", "probe", "frames"]) == 1
    rows = _lines(capsys)
    assert [r["correct"] for r in rows] == [True, False, False]


@pytest.mark.parametrize("entry", [bench.main, ir.main])
def test_bench_and_example_need_the_card(entry, monkeypatch):
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
