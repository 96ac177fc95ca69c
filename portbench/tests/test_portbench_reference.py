"""The reference against the port's CPU plain path at a tiny size, and the
control (the reference in float32 with TF32 products) against the
limits."""

import json

import pytest
import torch

from portbench import check, inputs
from portbench.calibrate import control_fit, control_frame
from portbench.reference import frame as rf
from portbench.reference.tracer import Counts, Tracer, round_tf32
from portbench_helpers import limits, run_tiny, tiny_context


@pytest.mark.parametrize("workload", ["bunny_1080p.render",
                                      "bunny_256k.render"])
def test_render_agrees_with_the_port(workload):
    ctx = tiny_context(workload, width=32, height=18)
    out = run_tiny(ctx)
    ok, rows = check.judge(out["numbers"], limits(workload))
    assert ok, rows
    assert out["numbers"]["pixels_off_pct"] == 0.0
    assert out["numbers"]["color_gap_median"] < 1e-6
    assert out["attempted"] >= 1 and out["e2e"]["frame_ms"] > 0


def test_fit_agrees_with_the_port():
    ctx = tiny_context("bunny_1080p.train", width=16, height=9)
    out = run_tiny(ctx)
    ok, rows = check.judge(out["numbers"], limits("bunny_1080p.train"))
    assert ok, rows
    assert out["numbers"]["loss_gap"] < 1e-4


@pytest.mark.parametrize("workload", ["bunny_1080p.render",
                                      "bunny_256k.render"])
def test_control_is_not_correct(workload):
    ctx = tiny_context(workload, width=48, height=27)
    ok, rows = check.judge(control_frame(ctx)["control"], limits(workload))
    assert not ok, rows


def test_fit_control_and_half_batch_are_not_correct():
    ctx = tiny_context("bunny_1080p.train", width=24, height=14)
    readings = control_fit(ctx)
    for side in ("control", "half_batch"):
        ok, rows = check.judge(readings[side], limits("bunny_1080p.train"))
        assert not ok, (side, rows)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.14159265],
                     dtype=torch.float32)
    y = round_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0  # a tie to even
    assert y[2] == 1.0 + 2**-9  # rounds up to the next 2^-10
    assert abs(float(y[3]) + 3.14159265) < 2**-9


TRIANGLE = {
    "camera": {"eye": [0, 0, -5], "up": [0, 1, 0], "look": [0, 0, 0],
               "width": 20, "height": 20, "ambient": 0.01},
    "materials": [{"type": "solid", "color": [0.7, 0.2, 0.7]}],
    "lights": [{"type": "sun", "direction": [1, 1, 1],
                "color": [1, 1, 1]}],
    "objects": [{"type": "triangle", "material": 0, "p1": [-1, -1, 0],
                 "p2": [1, -1, 0], "p3": [0, 1, 0]}],
}


def test_counts_on_one_triangle(tmp_path):
    """A triangle facing the camera, lit by a sun: each primary ray that
    hits it enters its box and casts one shadow ray."""
    path = tmp_path / "triangle.json"
    path.write_text(json.dumps(TRIANGLE))
    data = inputs.reference_scene(
        {"scene": str(path), "width": 20, "height": 20}, {}, 0)
    tr = Tracer(data, "cpu")
    counts = Counts()
    color, depth, _ = rf.render(tr, tr.params(), torch.arange(400), 0, 400,
                                counts)
    hits = int(torch.isfinite(depth).sum())
    assert 0 < hits < 400
    assert counts.hit_nodes == hits
    assert counts.casts == 400 + hits
    assert counts.tri_boxes >= hits
