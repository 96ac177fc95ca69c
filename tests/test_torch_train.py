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
from torch_stand_in import StandInGraphs

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


# --- the step program --------------------------------------------------------


@pytest.fixture
def stand_in(monkeypatch):
    from cutrace_tpu_torch.render import renderer

    graphs = StandInGraphs()
    monkeypatch.setattr(renderer, "GRAPHS", graphs)
    return graphs


def _bits(x):
    return x.contiguous().view(torch.int32)


def test_fit_program_equals_eager_bit_for_bit(scenes_dir, stand_in):
    """fit through the step program (the stand-in graph on the CPU) takes
    the same updates as the op-by-op fit, bit for bit: the first step is
    the eager call, the second is captured and replayed once, the rest
    replayed, with no second update at the capture and no loss aliased
    to the graph's."""
    _, ts, target = _setup(scenes_dir, "mirror.json", 16, 9, bounces=2)
    kw = dict(steps=5, lr=5e-2, bounces=2, param_filter=("mat_color",),
              accel="fused", device="cpu")
    target = torch.from_numpy(target)
    p_eager, l_eager = ttrain.fit(ts, target, program=False, **kw)
    assert stand_in.log == []
    p_prog, l_prog = ttrain.fit(ts, target, **kw)
    assert stand_in.log == ["eager", "capture"] + ["replay"] * 4
    assert len(set(l_prog)) == 5
    assert np.array_equal(np.float32(l_prog).view(np.int32),
                          np.float32(l_eager).view(np.int32))
    for k in p_eager:
        assert torch.equal(_bits(p_prog[k]), _bits(p_eager[k])), k


def test_step_program_new_objects_new_program(scenes_dir, stand_in):
    """A step object called with a second set of parameters starts a new
    program from an eager call; every call applies exactly one update
    (the op-by-op step on copies gives the same bits after each call)."""
    from cutrace_tpu_torch.render import renderer

    _, ts, target = _setup(scenes_dir, "triangle.json", 8, 8)
    target = torch.from_numpy(target)

    def params_pair():
        base = tgrad.extract_params(ts)
        return [{k: v.detach().clone().requires_grad_()
                 for k, v in base.items()} for _ in range(2)]

    def step_of(pair, program):
        opt = torch.optim.Adam([{"params": list(p.values())} for p in pair],
                               lr=1e-2, eps=1e-8)
        return ttrain.make_train_step(opt, bounces=1, accel=None,
                                      param_filter=("mat_color", "ambient"),
                                      program=program)

    prog_pair, ref_pair = params_pair(), params_pair()
    prog, ref = step_of(prog_pair, True), step_of(ref_pair, False)
    captures = renderer.CAPTURES
    for i, which in enumerate((0, 0, 0, 1, 1, 1, 0)):
        before = {k: v.detach().clone() for k, v in prog_pair[which].items()}
        got = prog(prog_pair[which], ts, target)
        want = ref(ref_pair[which], ts, target)
        assert torch.equal(_bits(got), _bits(want)), i
        for k, v in prog_pair[which].items():
            assert torch.equal(_bits(v.detach()),
                               _bits(ref_pair[which][k].detach())), (i, k)
            assert (torch.equal(v.detach(), before[k])
                    == (k not in ("mat_color", "ambient"))), (i, k)
    assert stand_in.log == (["eager", "capture", "replay", "replay"]
                            + ["eager", "capture", "replay", "replay"]
                            + ["eager"])
    assert renderer.CAPTURES == captures + 2


def test_step_program_rule_on_the_cpu_and_a_mocked_card(scenes_dir,
                                                        monkeypatch):
    """On the CPU make_train_step(program=True) runs op by op (nothing
    captured, the same bits as program=False); on a mocked CUDA device a
    non-capturable optimizer is refused when a program is asked for."""
    from cutrace_tpu_torch.render import renderer

    _, ts, target = _setup(scenes_dir, "triangle.json", 8, 8)
    target = torch.from_numpy(target)
    out = []
    for program in (True, False):
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in tgrad.extract_params(ts).items()}
        opt = torch.optim.Adam(list(params.values()), lr=1e-2)
        step = ttrain.make_train_step(opt, bounces=1, program=program)
        captures = renderer.CAPTURES
        out.append([_bits(step(params, ts, target)) for _ in range(2)]
                   + [_bits(params["mat_color"].detach())])
        assert renderer.CAPTURES == captures
    assert all(torch.equal(a, b) for a, b in zip(*out))

    monkeypatch.setattr(ttrain, "_optimizer_device",
                        lambda opt: torch.device("cuda"))
    params = [torch.zeros(3, requires_grad=True)]
    with pytest.raises(ValueError, match="capturable=True"):
        ttrain.make_train_step(torch.optim.Adam(params, lr=1e-2))
    ttrain.make_train_step(torch.optim.Adam(params, lr=1e-2), program=False)
    ttrain.make_train_step(torch.optim.Adam(params, lr=1e-2,
                                            capturable=True))


@pytest.mark.parametrize("camera,accel", [
    ("raw", "fused"), ("raw", "pallas"), ("raw", "none"),
    ("look_at", "fused")])
@pytest.mark.parametrize("scene", ["bunny.json", "mirror.json"])
def test_warm_step_makes_no_host_tensor(scenes_dir, monkeypatch, scene,
                                        camera, accel):
    """A warm training step (camera rays, the kernels' tables, the forward
    with codes and the replay backward through their plain versions, the
    composable culling or brute-force pipeline under autograd, the look-at
    camera, the cotangents' routing and Adam's update) makes no tensor
    from host data: the CPU's stand-in for "capturable as a CUDA graph"."""
    from cutrace_tpu_torch.render.renderer import prepare
    from test_torch_render import _no_host_tensors

    _, ts, target = _setup(scenes_dir, scene, 16, 9, bounces=2)
    target = torch.from_numpy(target)
    acc = prepare(ts, accel=accel).accel
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tgrad.extract_params(ts, camera=camera).items()}
    opt = torch.optim.Adam(list(params.values()), lr=1e-2, eps=1e-8)
    step = ttrain.make_train_step(opt, bounces=2, accel=acc)
    warm = step(params, ts, target)
    with monkeypatch.context() as mp:
        _no_host_tensors(mp)
        again = step(params, ts, target)
    assert torch.isfinite(warm) and torch.isfinite(again)
