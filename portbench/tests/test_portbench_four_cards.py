"""The four-card cell, bunny_1080p.render_4gpu, on the CPU: its
configuration is upstream's frame on a (4, 1) tiles mesh, its files are
found by name, its traffic keeps upstream's camera at every seed, a
four-rank run over gloo reads correct and its fault does not, and the
readers it lists read a sharded summary."""

import os

import numpy as np
import pytest

from portbench import check, inputs
from portbench.run import ROOT, benchmark, cell_metrics, load_module
from portbench_helpers import SEED, limits, run_tiny, tiny_context
from test_portbench_faults import GATHER_LEFT_OUT

BENCH = benchmark()
CELL = "bunny_1080p.render_4gpu"
WL = next(w for w in BENCH["workloads"] if w["name"] == CELL)
READERS = ("prepare_s", "idle_share.render", "gather_ms.render",
           "skew_ms.render")
MIX = inputs.read_json("mixes", WL["traffic"])
SEEDS = [0, 7, 2**31 - 1, SEED, 2**40 + 12345]


def test_the_cell_is_upstreams_frame_on_four_cards():
    assert (WL["config"], WL["traffic"], WL["chips"]) == \
        ("bunny_1080p_tiles4", "render_4gpu_fixed_eye", 4)
    cfg = inputs.read_json("configs", WL["config"])
    one = inputs.read_json("configs", "bunny_1080p")
    assert (cfg["width"], cfg["height"], cfg["bounces"]) == (1920, 1080, 5)
    # the one-card configuration but for its source and the cards
    mine = {k: v for k, v in cfg.items()
            if k not in ("source", "cards", "mesh")}
    assert mine == {k: v for k, v in one.items() if k != "source"}
    assert cfg["source"] != one["source"]
    assert cfg["cards"] == WL["chips"] == MIX["tiles"] * MIX["prims"]
    assert cfg["mesh"] == {"tiles": MIX["tiles"], "prims": MIX["prims"]}
    assert MIX["loop"] == "render_sharded_store"
    assert (MIX["tiles"], MIX["prims"]) == (4, 1)
    assert MIX["stop_every"] == 64


@pytest.mark.parametrize("seed", SEEDS)
def test_every_seed_keeps_the_eye_and_moves_the_lights(seed):
    eye, lights = inputs.offsets(MIX, seed, 4)
    assert np.all(eye == 0)
    assert np.any(lights != 0)
    assert np.all(np.abs(lights) <= MIX["light_jitter"])


@pytest.mark.parametrize("seed", SEEDS[-2:])
def test_both_sides_hold_upstreams_camera(seed):
    from cutrace_tpu_torch import load_scene
    from portbench.reference.loader import load

    cfg = inputs.read_json("configs", WL["config"])
    path = inputs.scene_file(cfg)
    prog = inputs.program_scene(cfg, MIX, seed)
    ref = inputs.reference_scene(cfg, MIX, seed)
    assert np.array_equal(prog.camera.eye, load_scene(path).camera.eye)
    assert np.array_equal(ref.eye, load(path).eye)
    assert np.array_equal(ref.eye, prog.camera.eye)


@pytest.mark.parametrize("fault", [None, "exchange"])
def test_four_ranks_of_the_fixed_eye_mix(monkeypatch, tmp_path, fault):
    if fault:
        (tmp_path / "sitecustomize.py").write_text(GATHER_LEFT_OUT)
        monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
            [str(tmp_path), os.environ.get("PYTHONPATH", "")]))
    mix = {k: v for k, v in MIX.items() if k != "stop_every"}
    ctx = tiny_context(CELL, width=16, height=9, seconds=0.1, **mix)
    out = run_tiny(ctx)
    assert out["forbidden"] == [] and out["attempted"] >= 1
    ok, _ = check.judge(out["numbers"], limits(CELL))
    assert ok == (fault is None)


def _rank(k1_s, gather_s, requests, busy_s=0.9):
    return {"kind": "render", "requests": requests, "window_s": 1.0,
            "busy_s": busy_s,
            "kernels": {"fused_forward_shared_kernel<float>": [requests, k1_s],
                        "ncclDevKernel_AllGather_RING_LL": [requests,
                                                            gather_s]}}


def _sharded(ranks):
    return dict(ranks[0], kind="render_sharded", ranks=ranks, prepare_s=0.5)


def test_skew_is_the_slowest_rank_less_the_mean():
    skew = load_module(ROOT / "metrics" / "skew_ms.render.py")
    ranks = [_rank(k1, 0.1, 100) for k1 in (0.30, 0.34, 0.38, 0.30)]
    # ms a frame: 3.0, 3.4, 3.8, 3.0; mean 3.3
    assert skew.read(_sharded(ranks)) == pytest.approx(0.5)
    assert skew.read(_sharded([_rank(0.3, 0.1, 100)] * 4)) == \
        pytest.approx(0.0)
    assert skew.read(dict(_rank(0.3, 0.1, 100))) is None
    ranks[2] = _rank(0.0, 0.0, 0)
    assert skew.read(_sharded(ranks)) is None


def test_the_cells_files_are_found_by_name():
    for path in (f"configs/{WL['config']}.json",
                 f"mixes/{WL['traffic']}.json", f"checks/{CELL}.json",
                 f"loops/{MIX['loop']}.py",
                 *(f"metrics/{name}.py" for name in READERS)):
        assert (ROOT / path).is_file(), path


def test_every_reader_of_the_cell_reads_a_sharded_summary():
    listed = {m["name"] for m in cell_metrics(BENCH, CELL, "per_layer")}
    assert listed == set(READERS)
    assert [m["name"] for m in cell_metrics(BENCH, CELL, "end_to_end")] \
        == ["frame_ms", "setup_s"]
    s = _sharded([_rank(k1, 0.08, 100, busy) for k1, busy in
                  ((0.30, 0.95), (0.34, 0.96), (0.38, 0.97), (0.30, 0.94))])
    for name in READERS:
        value = load_module(ROOT / "metrics" / f"{name}.py").read(s)
        assert isinstance(value, float) and value >= 0, name


def test_four_card_cells_fit_the_share_and_span_their_chips():
    cells = BENCH["workloads"]
    four = [w for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
    for w in cells:
        mix = inputs.read_json("mixes", w["traffic"])
        world = mix["tiles"] * mix["prims"] if "tiles" in mix else 1
        assert world == w["chips"], w["name"]


@pytest.mark.parametrize("cores,world", [(range(32), 4), (range(8), 4),
                                         ({0, 2, 5, 7, 9}, 4),
                                         (range(3), 4)])
def test_each_rank_gets_cores_of_its_own(cores, world):
    shares = load_module(ROOT / "loops" / f"{MIX['loop']}.py").core_shares(
        cores, world)
    assert len(shares) == world
    if len(set(cores)) < world:
        assert all(s == set(cores) for s in shares)
        return
    assert set().union(*shares) == set(cores)
    assert sum(map(len, shares)) == len(set(cores))
    assert min(map(len, shares)) >= len(set(cores)) // world
