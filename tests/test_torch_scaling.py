"""The port's scaling sweep (cutrace_tpu_torch.scaling, the counterpart of
benchmarks/scaling.py) on the CPU: two gloo meshes of bunny 16x9 b1 in
torchrun subprocesses, one line a mesh size in scaling.line's format,
and the rules that turn multihost's lines into them."""

import json
import pathlib
import subprocess
import sys
import time
import types

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
ARGS = ("--device", "cpu", "--devices", "2", "--width", "16", "--height",
        "9", "--bounces", "1", "--reps", "2")
TAG = "scaling/bunny_16x9_b1"
# the fields of a line (cutrace_tpu_torch.scaling.line)
LINE_FIELDS = ("metric", "value", "unit", "median", "percentile", "n",
               "sample_unit", "correct", "backend", "card", "seconds")
SWEEP_TIMEOUT = 300


@pytest.fixture(scope="module")
def lines():
    proc = subprocess.run(
        [sys.executable, "-m", "cutrace_tpu_torch.scaling", *ARGS],
        cwd=REPO, capture_output=True, text=True, timeout=SWEEP_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]


def test_scaling_cpu_lines(lines):
    """Two mesh lines and the efficiency line, every field of a line
    present, on the CPU, correct, no pixel off one rank's render, the
    kernels' work not measured."""
    assert [r["metric"] for r in lines] == [
        f"{TAG}/devices1", f"{TAG}/devices2", f"{TAG}/efficiency"]
    for r in lines:
        assert all(k in r for k in LINE_FIELDS), r
        assert r["backend"] == "cpu" and r["card"] is None
        assert r["correct"] is True
    for n, r in enumerate(lines[:2], 1):
        assert r["devices"] == n and r["mesh"] == [n, 1]
        assert r["unit"] == "Mcasts/s" and r["n"] == 2
        assert r["pixels_differ"] == 0 and r["backend_group"] == "gloo"
        assert r["work"] == "not measured"
        assert r["work_invariance"] == r["balance"] == "not measured"
        # the plain versions launch no kernel
        assert r["sample_launches"] == [{}] * n
        assert r["frame_launches"] == {"program": {}, "eager": {}}
    assert lines[0]["efficiency_vs_linear"] == 1.0


def test_scaling_casts_per_pixel_matches_jax(lines, scenes_dir):
    """casts_per_pixel equals the JAX package's for the same scene and
    depth."""
    from cutrace_tpu.scene.loader import load_scene
    from cutrace_tpu.scene.soa import scene_to_soa
    from cutrace_tpu.utils.profiling import casts_per_pixel

    sc = load_scene(scenes_dir / "bunny.json")
    sc.camera.width, sc.camera.height = 16, 9
    want = casts_per_pixel(scene_to_soa(sc), 1)
    assert [r["casts_per_pixel"] for r in lines[:2]] == [want, want]


def test_scaling_rates_from_the_lines_own_medians(lines):
    """Mcasts/s = W * H * casts_per_pixel / the line's median; efficiency
    = Mcasts_n / (n * Mcasts_1); the last line holds the efficiency at
    N."""
    for r in lines[:2]:
        want = 16 * 9 * r["casts_per_pixel"] / r["median"] / 1e3
        assert r["value"] == pytest.approx(want, rel=1e-12)
        assert r["value"] == r["mcasts_per_s"]
    one, two, eff = lines
    assert two["efficiency_vs_linear"] == pytest.approx(
        two["value"] / (2 * one["value"]), rel=1e-12)
    assert eff["value"] == two["efficiency_vs_linear"]
    assert eff["devices"] == 2


def test_scaling_raises_without_a_card(monkeypatch):
    """Without a card and without --device cpu the sweep raises: nothing
    falls back to the CPU."""
    from cutrace_tpu_torch import scaling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling.main([])


@pytest.mark.parametrize("n,want", [(1, [1]), (2, [1, 2]), (3, [1, 2, 3]),
                                    (4, [1, 2, 4]), (6, [1, 2, 4, 6]),
                                    (8, [1, 2, 4, 8])])
def test_mesh_sizes(n, want):
    """1, 2, 4, ... and N itself, as benchmarks/scaling.py sweeps."""
    from cutrace_tpu_torch.scaling import mesh_sizes

    assert mesh_sizes(n) == want


def _row(n, samples, visits, differ=0):
    work = ("not measured" if visits is None else
            [{"casts": 10, "visits": v, "slabs": 2 * v, "needed": v}
             for v in visits])
    return {"mesh": [n, 1], "width": 16, "height": 9, "bounces": 1,
            "accel": "fused", "frame_samples_ms": samples, "work": work,
            "pixels_differ": differ, "frame_ms": [1.0] * n, "programs": 1,
            "one_rank_ms": 1.0, "backend": "nccl",
            "sample_launches": [{"fused.LAUNCHES": len(samples[0])}] * n,
            "frame_launches": {"program": {"fused.LAUNCHES": 1},
                               "eager": {"fused.LAUNCHES": 1}}}


def test_mesh_fields_from_work_tallies():
    """A sample is the largest of the ranks' k-th frames; the work's
    invariance is one rank's admitted visits over the ranks' sum, its
    balance their mean over their max."""
    from cutrace_tpu_torch.scaling import mesh_fields

    one = mesh_fields(_row(1, [[4.0, 2.0, 3.0]], [1000]), 1, 10)
    assert one["samples"] == [4.0, 2.0, 3.0] and one["frame_ms"] == 3.0
    assert one["work_invariance"] == 1.0 and one["balance"] == 1.0
    two = mesh_fields(_row(2, [[1.0, 2.5, 1.0], [2.0, 1.0, 1.5]],
                           [600, 500]), 2, 10, one)
    assert two["samples"] == [2.0, 2.5, 1.5] and two["frame_ms"] == 2.0
    assert two["mcasts_per_s"] == pytest.approx(16 * 9 * 10 / 2.0 / 1e3)
    assert two["efficiency_vs_linear"] == pytest.approx(3.0 / (2 * 2.0))
    assert two["work_invariance"] == pytest.approx(1000 / 1100)
    assert two["balance"] == pytest.approx(550 / 600)
    assert two["sample_launches"] == [{"fused.LAUNCHES": 3}] * 2
    assert two["frame_launches"]["program"] == {"fused.LAUNCHES": 1}
    cpu = mesh_fields(_row(2, [[1.0], [1.0]], None), 2, 10)
    assert cpu["work_invariance"] == cpu["balance"] == "not measured"


def test_run_mesh_past_its_deadline_raises():
    """A mesh's subprocess that runs past its deadline is stopped with its
    ranks (torchrun passes SIGTERM on to them), and the sweep raises at
    once."""
    from cutrace_tpu_torch.scaling import run_mesh

    args = types.SimpleNamespace(
        scene=str(REPO / "scenes" / "bunny.json"), width=16, height=9,
        bounces=1, reps=2, device="cpu")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="ran past"):
        run_mesh(args, 2, deadline=5.0)
    assert time.monotonic() - t0 < 5.0 + 30


def test_deadline_above_the_sweep_stops_its_ranks(tmp_path):
    """A deadline on the sweep's own process (as chip_smoke.py sets one)
    stops the sweep, its torchrun and every rank: no process of the run
    is left."""
    from cutrace_tpu_torch.utils.subprocs import run_tree

    scene = tmp_path / "scene_d3adl1ne.json"  # a name only this run uses
    scene.write_text((REPO / "scenes" / "sphere_plane.json").read_text())
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_tree([sys.executable, "-m", "cutrace_tpu_torch.scaling",
                  "--scene", str(scene), "--device", "cpu", "--devices",
                  "2", "--width", "640", "--height", "360", "--reps",
                  "50"], REPO, timeout=15.0)
    assert time.monotonic() - t0 < 15.0 + 30
    left = subprocess.run(["pgrep", "-f", scene.name], capture_output=True,
                          text=True).stdout.split()
    assert left == [], left
