"""The readers of the program's own trace (portbench.program_trace and the
metrics that use it): over a faked snapshot, without the program's
tracing module, and over tiny traced cells on the CPU whose programs run
under stand-in graphs."""

import sys

import pytest
import torch

from portbench.run import ROOT, benchmark, cell_metrics, load_module
from portbench_helpers import run_tiny, tiny_context

NEW = ["rays_ms.render", "unpermute_ms.render", "rays_ms.train",
       "tables_ms.train", "routing_ms.train", "adam_ms.train", "build_s"]


def reader(name):
    return load_module(ROOT / "metrics" / f"{name}.py").read


def phases(**ms):
    return {k: {"count": 4, "total_ms": 4 * v} for k, v in ms.items()}


SNAPSHOT = {
    "on": False,
    "spans": {
        "all": {"program.build": {"count": 2, "total_ms": 3000.0,
                                  "self_ms": 10.0},
                "render": {"count": 6, "total_ms": 6.0, "self_ms": 1.0}},
        "on": {"render": {"count": 4, "total_ms": 2.0, "self_ms": 1.0},
               "step": {"count": 5, "total_ms": 10.0, "self_ms": 2.0}},
        "off": {}},
    "dropped": 0,
    "counters": {},
    "phases": {"frame": phases(rays=0.25, pack=0.2, forward=12.0,
                               unpermute=0.5, copy_out=0.125),
               "step": phases(rays=0.5, tables=0.75, pack=0.4, forward=12.0,
                              loss=0.1, cotangents=0.3, backward=3.0,
                              routing=0.375, optimizer=0.25)},
    "replays": {},
}
WANT = {"render": {"rays_ms.render": 0.25, "unpermute_ms.render": 0.625,
                   "build_s": 3.0},
        "train": {"rays_ms.train": 0.5, "tables_ms.train": 0.75,
                  "routing_ms.train": 0.375, "adam_ms.train": 0.25,
                  "build_s": 3.0}}


def test_readers_over_a_faked_snapshot(monkeypatch):
    from cutrace_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "snapshot", lambda: SNAPSHOT)
    for kind, want in WANT.items():
        for name in NEW:
            got = reader(name)({"kind": kind})
            if name in want:
                assert got == pytest.approx(want[name]), name
            else:
                assert got is None, name


def test_readers_without_the_programs_tracing_give_none(monkeypatch):
    """A checkout whose program has no tracing module reads nothing and
    raises nothing."""
    monkeypatch.setitem(sys.modules, "cutrace_tpu_torch.utils.tracing", None)
    for kind in ("render", "train"):
        for name in NEW:
            assert reader(name)({"kind": kind}) is None


class StandInGraph:
    """A captured program on the CPU: replay reruns the function."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs, self.fresh = fn, outputs, True

    def replay(self):
        if self.fresh:
            self.fresh = False
            return
        new = self.fn()
        if torch.is_tensor(new):
            self.outputs.copy_(new)
            return
        for out, x in zip(self.outputs, new):
            out.copy_(x)


class StandInGraphs:
    def captures(self, device):
        return True

    def warm(self, fn, device):
        return fn()

    def capture(self, fn, device):
        outputs = fn()
        return StandInGraph(fn, outputs), outputs


@pytest.mark.parametrize("workload", ["bunny_1080p.render",
                                      "bunny_1080p.train"])
def test_traced_tiny_cell_reads_every_new_metric(monkeypatch, workload):
    """A traced tiny cell whose programs run under stand-in graphs gives
    every new metric listed for it a positive number."""
    from cutrace_tpu_torch.render import renderer
    from cutrace_tpu_torch.utils import tracing

    monkeypatch.setattr(renderer, "GRAPHS", StandInGraphs())
    tracing.reset()
    out = run_tiny(tiny_context(workload, 16, 9, trace=True))
    s = out["summary"]
    names = [m["name"] for m in cell_metrics(benchmark(), workload,
                                             "per_layer")
             if m["name"] in NEW]
    assert len(names) == (3 if workload.endswith("render") else 5)
    for name in names:
        got = reader(name)(s)
        assert got is not None and got > 0, name
    tracing.reset()
