"""Port parity: cutrace_tpu_torch.parallel.train.fit and diff.checkpoint
against the JAX package.

Three Adam steps of the port's fit (the fused Function's plain versions on
the CPU) and of JAX's fit on a one-tile mesh (the composable pipeline)
must give allclose parameters: the same fixed-topology gradients and the
same Adam update (eps 1e-8 in both)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cutrace_tpu.parallel import make_mesh
from cutrace_tpu.parallel import train as jtrain
from cutrace_tpu.scene.loader import load_scene
from cutrace_tpu.scene.soa import scene_to_soa as jax_soa
from cutrace_tpu_torch.diff import checkpoint as tckpt
from cutrace_tpu_torch.diff import grad as tgrad
from cutrace_tpu_torch.parallel import train as ttrain
from cutrace_tpu_torch.scene import soa as tsoa
from test_torch_host import port_scene

torch.set_num_threads(2)


def _setup(scenes_dir, name="bunny.json", w=16, h=9, bounces=1):
    """(JAX soa, port soa, target): the target is the scene's render, and
    both soas start from the same numpy-seeded perturbation of
    mat_color."""
    sc = load_scene(scenes_dir / name)
    sc.camera.width, sc.camera.height = w, h
    js = jax_soa(sc)
    ts = tsoa.scene_to_soa(port_scene(sc), device="cpu")
    with torch.no_grad():
        target, _, _ = tgrad.render_image_flat(ts, bounces, 1e-3)
    rng = np.random.default_rng(0)
    color = np.asarray(js.mat_color)
    start = np.clip(color + rng.normal(0.0, 0.1, color.shape), 0.0, 1.0)
    start = start.astype(np.float32)
    js = dataclasses.replace(js, mat_color=jax.numpy.asarray(start))
    ts = dataclasses.replace(ts, mat_color=torch.from_numpy(start))
    return js, ts, target.numpy()


def test_fit_matches_jax(scenes_dir):
    js, ts, target = _setup(scenes_dir)
    kw = dict(steps=3, lr=5e-2, bounces=1, param_filter=("mat_color",))
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    jparams, jlosses = jtrain.fit(js, target, mesh, accel="none", **kw)
    tparams, tlosses = ttrain.fit(ts, torch.from_numpy(target),
                                  accel="fused", device="cpu", **kw)
    assert len(tlosses) == 3 and all(np.isfinite(tlosses))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
    assert set(tparams) == set(jparams)
    for k in tparams:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # groups outside the filter keep their values
    assert torch.equal(tparams["tri_p1"], ts.tri_p1)


def test_checkpoint_round_trip(tmp_path):
    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": torch.tensor(0.5)}
    opt = torch.optim.Adam([p.clone().requires_grad_()
                            for p in params.values()], lr=1e-2)
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    assert tckpt.restore_checkpoint(str(tmp_path / "none"), params) is None
    for step in (3, 7):
        tckpt.save_checkpoint(str(tmp_path / "ck"), params,
                              opt.state_dict(), step)
    (tmp_path / "ck" / "step_x.pt").write_text("")
    assert tckpt.latest_step(str(tmp_path / "ck")) == 7
    rp, rs, step = tckpt.restore_checkpoint(str(tmp_path / "ck"), params)
    assert step == 7
    for k in params:
        assert torch.equal(rp[k], params[k])
    assert rs["param_groups"][0]["lr"] == 1e-2
    _, _, step3 = tckpt.restore_checkpoint(str(tmp_path / "ck"), params,
                                           step=3)
    assert step3 == 3


def test_fit_resume(scenes_dir, tmp_path):
    """fit with a checkpoint directory resumes instead of restarting: a
    second call after all steps runs none, and a longer run continues from
    the saved step with the saved optimizer state."""
    _, ts, target = _setup(scenes_dir, "triangle.json", 12, 12)
    kw = dict(lr=5e-2, bounces=1, param_filter=("mat_color",),
              checkpoint_dir=str(tmp_path / "fitck"), checkpoint_every=2,
              accel="fused", device="cpu")
    target = torch.from_numpy(target)
    _, losses1 = ttrain.fit(ts, target, steps=3, **kw)
    assert len(losses1) == 3
    assert tckpt.latest_step(kw["checkpoint_dir"]) == 2
    _, losses2 = ttrain.fit(ts, target, steps=3, **kw)
    assert losses2 == []
    p5, losses5 = ttrain.fit(ts, target, steps=5, **kw)
    assert len(losses5) == 2
    ref, ref_losses = ttrain.fit(ts, target, steps=5,
                                 **{**kw, "checkpoint_dir": None})
    np.testing.assert_allclose(losses5, ref_losses[3:], rtol=1e-6)
    assert torch.allclose(p5["mat_color"], ref["mat_color"], atol=1e-7)


def test_fit_defaults_to_the_card(scenes_dir, monkeypatch):
    _, ts, target = _setup(scenes_dir, "triangle.json", 4, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.fit(ts, torch.from_numpy(target), steps=1)


def test_train_step_filter(scenes_dir):
    """make_train_step with a filter updates only the named groups, and
    its loss is render_loss's."""
    _, ts, target = _setup(scenes_dir, "triangle.json", 8, 8)
    target = torch.from_numpy(target)
    params = {k: v.clone().requires_grad_()
              for k, v in tgrad.extract_params(ts).items()}
    opt = torch.optim.Adam(list(params.values()), lr=1e-2)
    step = ttrain.make_train_step(opt, bounces=1,
                                  param_filter=("mat_color", "ambient"))
    want = tgrad.render_loss(params, ts, target, 1).item()
    before = {k: v.detach().clone() for k, v in params.items()}
    loss = step(params, ts, target)
    assert loss.item() == pytest.approx(want, rel=1e-6)
    for k, v in params.items():
        changed = not torch.equal(v.detach(), before[k])
        assert changed == (k in ("mat_color", "ambient")), k
