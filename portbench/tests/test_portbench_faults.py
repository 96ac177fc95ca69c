"""The harness driven through a whole run on the CPU, past its look for a
card, with the timed path broken underneath: `correct` comes out false
for each fault the cell can have."""

import pytest
import torch

from portbench import check
from portbench_helpers import limits, run_tiny, tiny_context


def correct(workload, ctx):
    ok, _ = check.judge(run_tiny(ctx)["numbers"], limits(workload))
    return ok


def _broken_render(monkeypatch, fault):
    from cutrace_tpu_torch.render import renderer

    real = renderer.render

    def render(*args, **kwargs):
        color, depth, normal = real(*args, **kwargs)
        if fault == "half_batch":  # the second half of the pixels not rendered
            n = color.shape[0] // 2
            color, depth, normal = (x.clone() for x in (color, depth, normal))
            color[n:], depth[n:], normal[n:] = 0.0, 0.0, 0.0
        else:  # an answer altered where it is produced
            color = color * 1.01
        return color, depth, normal

    monkeypatch.setattr(renderer, "render", render)


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
@pytest.mark.parametrize("workload", ["bunny_1080p.render",
                                      "bunny_256k.render"])
def test_render_faults_are_not_correct(monkeypatch, workload, fault):
    ctx = tiny_context(workload, width=32, height=18)
    assert correct(workload, ctx)
    _broken_render(monkeypatch, fault)
    assert not correct(workload, tiny_context(workload, width=32, height=18))


def test_fit_step_that_leaves_its_state_is_not_correct(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    assert not correct("bunny_1080p.train",
                       tiny_context("bunny_1080p.train", 16, 9))


def test_fit_on_half_the_batch_is_not_correct(monkeypatch):
    from cutrace_tpu_torch.diff.grad import render_image_flat, with_params
    from cutrace_tpu_torch.parallel import train

    def half_loss(params, soa, target, bounces=2, fudge=1e-3, accel=None):
        color, _, _ = render_image_flat(with_params(soa, params), bounces,
                                        fudge, accel)
        n = color.shape[0] // 2
        return torch.mean((color[:n] - target.reshape(-1, 3)[:n]) ** 2)

    monkeypatch.setattr(train, "render_loss", half_loss)
    assert not correct("bunny_1080p.train",
                       tiny_context("bunny_1080p.train", 16, 9))


GATHER_LEFT_OUT = '''
from cutrace_tpu_torch.parallel import sharding


def gather_image(local, mesh):
    """The exchange between ranks left out: each rank's rows stand for
    every rank's."""
    import torch
    return torch.cat([local] * mesh.n_tiles)


sharding.gather_image = gather_image
'''


@pytest.mark.parametrize("fault", [None, "exchange"])
def test_four_ranks_and_the_exchange_left_out(monkeypatch, tmp_path, fault):
    import os

    if fault:
        (tmp_path / "sitecustomize.py").write_text(GATHER_LEFT_OUT)
        monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
            [str(tmp_path), os.environ.get("PYTHONPATH", "")]))
    workload = "bunny_1080p.render_4gpu"
    ctx = tiny_context(workload, width=16, height=9, seconds=0.1)
    out = run_tiny(ctx)
    assert out["forbidden"] == [] and out["attempted"] >= 1
    ok, _ = check.judge(out["numbers"], limits(workload))
    assert ok == (fault is None)
