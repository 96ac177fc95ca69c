"""The port's tracing (cutrace_tpu_torch.utils.tracing): spans, their
parents, requests and self time, the profiler's names for them, the
counters, the bounded buffer, and the phase marks of the frame and step
programs under the stand-in graphs (host-clock stamps on the CPU).

The file imports nothing of jax, so its `cuda` test runs on a card
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_tracing.py
"""

import collections
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from cutrace_tpu_torch import load_scene
from cutrace_tpu_torch.diff import grad as tgrad
from cutrace_tpu_torch.parallel import train as ttrain
from cutrace_tpu_torch.render import renderer
from cutrace_tpu_torch.utils import tracing
from torch_stand_in import StandInGraphs

REPO = pathlib.Path(__file__).resolve().parent.parent
FRAME = ["rays", "pack", "forward", "unpermute", "copy_out"]
STEP = ["rays", "tables", "pack", "forward", "loss", "cotangents",
        "backward", "routing", "optimizer"]

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def fresh_trace():
    tracing.reset()
    tracing.disable()
    yield
    tracing.reset()
    tracing.disable()


@pytest.fixture
def stand_in(monkeypatch):
    graphs = StandInGraphs()
    monkeypatch.setattr(renderer, "GRAPHS", graphs)
    monkeypatch.setattr(renderer, "_PROGRAMS", collections.OrderedDict())
    monkeypatch.setattr(renderer, "_OWNERS", {})
    return graphs


def _prepared(name="mirror.json", w=16, h=9, accel="fused"):
    sc = load_scene(str(REPO / "scenes" / name))
    sc.camera.width, sc.camera.height = w, h
    return renderer.prepare(sc, accel=accel, device="cpu")


def _spans(split="on"):
    return tracing.snapshot()["spans"][split]


def test_off_records_nothing_and_never_enters_record_function(
        monkeypatch, stand_in):
    """Off, a hot span is the shared no-op; a render through the program
    records no hot span, reads no mark and never opens a profiler range
    (record_function or the fast range)."""
    def refuse(*args, **kwargs):
        raise AssertionError("profiler range opened with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing, "_RANGE", refuse)
    assert not tracing.on()
    assert tracing.span("render.dispatch") is tracing._NOOP
    assert tracing.request("render") is tracing._NOOP
    p = _prepared()
    for _ in range(3):
        renderer.render(p, bounces=2)
    snap = tracing.snapshot()
    assert snap["spans"]["on"] == {}
    assert set(snap["spans"]["off"]) == {
        "scene.load", "prepare", "prepare.soa", "prepare.accel",
        "program.build", "program.warm", "program.capture"}
    assert snap["phases"] == {} and snap["replays"] == {}


def test_spans_nest_with_parents_requests_and_self_time():
    """A span's parent is the span open around it, a request span starts
    a new request id that its children share, and a span's self time is
    its duration less its children's."""
    tracing.enable()
    with tracing.setup_span("outside"):
        pass
    for _ in range(2):
        with tracing.request("req"):
            with tracing.span("a"):
                time.sleep(0.002)
                with tracing.span("b"):
                    time.sleep(0.003)
            with tracing.span("c"):
                pass
    rows = {}
    for name, t0, t1, sid, parent, req, was_on in tracing._trace.spans:
        rows.setdefault(name, []).append((sid, parent, req, was_on))
        assert t1 >= t0
    (out_id, out_parent, out_req, _), = rows["outside"]
    assert out_parent is None and out_req is None
    reqs = [r[0] for r in rows["req"]]
    assert [r[2] for r in rows["req"]] == [1, 2]
    for i in range(2):
        assert rows["a"][i][1] == reqs[i] and rows["c"][i][1] == reqs[i]
        assert rows["b"][i][1] == rows["a"][i][0]
        assert {rows[n][i][2] for n in "abc"} == {i + 1}
    assert all(r[3] for rs in rows.values() for r in rs)
    s = _spans()
    assert s["req"]["count"] == 2 and s["b"]["count"] == 2
    assert s["b"]["self_ms"] == s["b"]["total_ms"] >= 6.0
    assert s["a"]["self_ms"] == pytest.approx(
        s["a"]["total_ms"] - s["b"]["total_ms"])
    assert s["req"]["self_ms"] == pytest.approx(
        s["req"]["total_ms"] - s["a"]["total_ms"] - s["c"]["total_ms"])
    assert 4.0 <= s["a"]["self_ms"] < s["a"]["total_ms"]
    assert tracing.snapshot()["spans"]["off"] == {}


def test_profiler_turns_tracing_on_and_names_the_spans(tmp_path):
    """Tracing is on while a torch.profiler records, off after; the spans
    it saw are host ranges of the profiler's trace (user annotations, or
    cpu_op events from the fast range), each once a render."""
    from torch.profiler import ProfilerActivity, profile

    p = _prepared(accel="none")
    assert not tracing.on()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.on()
        renderer.render(p, bounces=1)
    assert not tracing.on()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = collections.Counter(
        e["name"] for e in events
        if e.get("cat") in ("user_annotation", "cpu_op"))
    assert names["render"] == names["render.dispatch"] == 1
    assert _spans()["render"]["count"] == 1


def _phase_sum(snap, program, phases):
    got = snap["phases"][program]
    return sum(got[k]["total_ms"] for k in phases)


def test_frame_marks_give_the_phases_in_order(monkeypatch, stand_in):
    """Traced replays of the fused frame's program (stand-in graph), every
    one read, give rays, pack, forward, unpermute and copy_out once a
    frame, in that order; together they cover the replay and lie inside
    each frame's span."""
    monkeypatch.setattr(tracing, "READ_EVERY", 1)
    p = _prepared("bunny.json", 32, 18)
    for _ in range(2):  # the build, then a replay of the capture's run
        renderer.render(p, bounces=2)
    tracing.enable()
    for _ in range(3):
        renderer.render(p, bounces=2)
    snap = tracing.snapshot()
    assert list(snap["phases"]) == ["frame"]
    assert list(snap["phases"]["frame"]) == FRAME
    assert all(v["count"] == 3 and v["total_ms"] >= 0
               for v in snap["phases"]["frame"].values())
    assert snap["replays"] == {"frame": {"read": 3, "lost": 0}}
    on = snap["spans"]["on"]
    assert on["render"]["count"] == on["program.replay"]["count"] == 3
    assert on["render.copy_out"]["count"] == 3
    total = _phase_sum(snap, "frame", FRAME)
    assert total <= on["render"]["total_ms"]
    assert total >= 0.95 * on["program.replay"]["total_ms"]
    assert stand_in.log == ["eager", "capture"] + ["replay"] * 5


def test_step_marks_give_the_phases_in_order(monkeypatch, stand_in):
    """Traced replays of the step program (stand-in graph, the fused
    forward's and replay backward's plain versions), every one read, give
    the nine phases in order; together they cover the replay."""
    monkeypatch.setattr(tracing, "READ_EVERY", 1)
    p = _prepared("mirror.json", 16, 9)
    with torch.no_grad():
        target, _, _ = tgrad.render_image_flat(p.soa, 2, 1e-3)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tgrad.extract_params(p.soa).items()}
    opt = torch.optim.Adam(list(params.values()), lr=1e-2, eps=1e-8)
    step = ttrain.make_train_step(opt, 2, param_filter=("mat_color",),
                                  accel=p.accel)
    for _ in range(2):  # eager, then the capture and its replay
        step(params, p.soa, target)
    tracing.enable()
    for _ in range(3):
        step(params, p.soa, target)
    snap = tracing.snapshot()
    assert list(snap["phases"]["step"]) == STEP
    assert all(v["count"] == 3 for v in snap["phases"]["step"].values())
    on = snap["spans"]["on"]
    assert on["step"]["count"] == on["step.key"]["count"] == 3
    assert on["program.replay"]["count"] == on["step.copy_out"]["count"] == 3
    total = _phase_sum(snap, "step", STEP)
    assert 0.95 * on["program.replay"]["total_ms"] <= total
    assert total <= on["program.replay"]["total_ms"]
    off = snap["spans"]["off"]
    assert off["program.build"]["count"] == 2
    assert off["program.warm"]["count"] == off["program.capture"]["count"] \
        == 1
    assert stand_in.log == ["eager", "capture"] + ["replay"] * 4


def test_traced_replays_are_read_one_in_read_every(monkeypatch, stand_in):
    """Of the traced replays, the first and then every READ_EVERY-th is
    read; only those take the eager copy_out mark. Untraced replays
    count for nothing."""
    monkeypatch.setattr(tracing, "READ_EVERY", 3)
    p = _prepared("bunny.json", 16, 9)
    for _ in range(3):  # the build, then two untraced replays
        renderer.render(p, bounces=1)
    tracing.enable()
    for _ in range(7):
        renderer.render(p, bounces=1)
    snap = tracing.snapshot()
    assert snap["replays"] == {"frame": {"read": 3, "lost": 0}}
    assert all(v["count"] == 3 for v in snap["phases"]["frame"].values())
    assert list(snap["phases"]["frame"]) == FRAME
    assert snap["spans"]["on"]["program.replay"]["count"] == 7


def test_counters_captures_misses_evictions_and_rekeys(stand_in):
    """A second render of a scene adds no capture and no miss; scenes past
    PROGRAM_CACHE_SIZE evict; a step handed a new target object re-keys;
    the kernel wrappers' counters are read where they live."""
    def counters():
        return tracing.snapshot()["counters"]

    before = counters()
    p = _prepared("triangle.json", 8, 8)
    renderer.render(p, bounces=1)
    renderer.render(p, bounces=1)
    after = counters()
    assert after["renderer.CAPTURES"] - before["renderer.CAPTURES"] == 1
    assert after["renderer.PROGRAM_MISSES"] - \
        before["renderer.PROGRAM_MISSES"] == 1
    others = [dataclasses.replace(p)
              for _ in range(renderer.PROGRAM_CACHE_SIZE)]
    for o in others:
        renderer.render(o, bounces=1)
    last = counters()
    assert last["renderer.PROGRAM_EVICTIONS"] - \
        before["renderer.PROGRAM_EVICTIONS"] == 1
    assert last["renderer.CAPTURES"] - before["renderer.CAPTURES"] == 5
    from cutrace_tpu_torch.ops import fused

    assert last["fused.LAUNCHES"] == fused.LAUNCHES

    params = {k: v.detach().clone().requires_grad_()
              for k, v in tgrad.extract_params(p.soa).items()}
    target = torch.zeros(64, 3)
    opt = torch.optim.Adam(list(params.values()), lr=1e-2, eps=1e-8)
    step = ttrain.make_train_step(opt, 1, param_filter=("mat_color",))
    rekeys = counters()["train.REKEYS"]
    for t in (target, target, target, target.clone()):
        step(params, p.soa, t)
    assert counters()["train.REKEYS"] - rekeys == 1


def test_span_buffer_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 5)
    tracing.enable()
    for _ in range(8):
        with tracing.span("x"):
            pass
    snap = tracing.snapshot()
    assert snap["spans"]["all"]["x"]["count"] == 5
    assert snap["dropped"] == 3


def test_marks_outside_a_program_do_nothing():
    """A frame rendered op by op records no phase, traced or not."""
    tracing.enable()
    renderer.render(_prepared(), bounces=1)
    assert tracing.snapshot()["phases"] == {}


def test_cli_prints_the_snapshot_with_cutrace_trace(tmp_path):
    """CUTRACE_TRACE=1: the CLI's last line on standard error is the
    snapshot, set-up spans and counters included."""
    env = dict(os.environ, CUTRACE_TRACE="1")
    proc = subprocess.run(
        [sys.executable, "-m", "cutrace_tpu_torch",
         str(REPO / "scenes" / "triangle.json"), "--device", "cpu",
         "--width", "16", "--height", "9", "--out", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    snap = json.loads(proc.stderr.strip().splitlines()[-1])
    assert snap["on"] is True
    assert {"scene.load", "prepare", "prepare.soa", "render",
            "render.dispatch"} <= set(snap["spans"]["all"])
    assert snap["spans"]["all"]["render"]["count"] == 2
    assert "renderer.CAPTURES" in snap["counters"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_marks_time_a_kernel_inside_a_captured_graph(card):
    """Two marks around a kernel of known length, captured into a CUDA
    graph as event-record nodes, read that length over traced replays;
    an untraced replay reads nothing."""
    x = torch.zeros(1 << 16, device=card)
    marks = tracing.Marks("probe", card)

    def body():
        x.add_(1)
        tracing.mark("add")
        torch.cuda._sleep(1 << 21)
        tracing.mark("sleep")
        return x

    run = marks.wrap(body)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(1 << 21)
    b.record()
    torch.cuda.synchronize(card)
    eager_ms = a.elapsed_time(b)

    def replay():
        marks.before_replay()
        graph.replay()
        marks.after_replay()
        torch.cuda.synchronize(card)

    replay()
    assert tracing.snapshot()["phases"] == {}
    tracing.enable()
    for _ in range(4 * tracing.READ_EVERY):
        replay()
    snap = tracing.snapshot()
    sleep = snap["phases"]["probe"]["sleep"]
    assert sleep["count"] == 4
    assert sleep["total_ms"] / 4 == pytest.approx(eager_ms, rel=0.2)
    assert snap["phases"]["probe"]["add"]["total_ms"] > 0
    assert snap["replays"]["probe"] == {"read": 4, "lost": 0}
