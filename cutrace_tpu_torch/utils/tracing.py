"""Spans, counters and device phase marks of the port.

Spans. `span(name)` is a host range on `time.perf_counter_ns`: its name,
start and end, the span open around it on the same thread (its parent)
and the id of the request it belongs to; `request(name)` opens a span
that starts a new request (`render`, `step`, `render_sharded`). Both are
hot: they run per request and are recorded only while tracing is on, which
is when CUTRACE_TRACE=1 was set at import, after `enable()`, or while a
torch.profiler records. Off, a hot span is one test that returns a shared
no-op context manager. `setup_span(name)` is recorded always: scene load,
`prepare`, the kernels' load and a program's build, a bounded number per
scene, library and program. While a profiler records, every span also
opens a profiler range of its name (`_RANGE`), so the profiler's trace
names the port's phases on the clock of its device events.

Spans are kept in memory, at most MAX_SPANS of them; past that they are
counted as dropped, not kept.

Device phase marks. Host spans cannot see into a CUDA graph. A program
(render.renderer._Program) runs its function through `Marks.wrap`, which
records a start mark; `mark(phase)` inside it records a timing event on
the current stream that ends `phase`, captured as an event-record node of
the graph. Of the replays made while tracing is on, one in READ_EVERY (the
first, then every READ_EVERY-th) is read: the device time between its
consecutive marks is added to each phase. The next replay reads them
once the device has passed them (a replay whose marks were overwritten
first is counted as lost), and `snapshot()` reads the last. Reading a
replay takes a query and an elapsed time a phase, ~0.1 ms on the card,
so the sampling keeps that out of most traced requests. On the CPU, and
under the tests' stand-in graphs, a mark is a host-clock stamp. Outside
a program `mark` does nothing.

`snapshot()` gives the spans by name (count, total and self time: the
duration less what child spans cover), all of them and split into those
recorded while tracing was on and off, the drops, the port's counters
(the kernel wrappers' launch counts, captures, program-cache misses and
evictions, step re-keys) and the phases' device time by program.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 65536
READ_EVERY = 8  # a program's traced replays read, one in this many
START = "start"  # the mark a program's run begins with

# torch's fast profiler range where it has one (a cpu_op event, ~2 us
# under a recording profiler against record_function's ~15 us, which
# the traced window would count as idle), else record_function (a
# user_annotation event)
_RANGE = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
          or _profiler.record_function)

FROM_ENV = os.environ.get("CUTRACE_TRACE") == "1"
_enabled = FROM_ENV
_NOOP = contextlib.nullcontext()


def on() -> bool:
    """Is tracing on (CUTRACE_TRACE=1 at import, enable(), or a
    torch.profiler recording)?"""
    return _enabled or _profiler._is_profiler_enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    """Tracing off, unless a torch.profiler records."""
    global _enabled
    _enabled = False


class _Trace:
    """What the process recorded: spans (name, start ns, end ns, id, parent
    id, request id, on), drops, each phase's [count, ms] by program, each
    program's [replays read, replays lost], and the marks of replays not
    read yet."""

    def __init__(self):
        self.spans = []
        self.dropped = 0
        self.ids = itertools.count(1)
        self.requests = itertools.count(1)
        self.local = threading.local()
        self.phases = {}
        self.replays = {}
        self.unread = {}

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_trace = _Trace()


def reset():
    """Forget every span, drop, phase and unread mark (the counters belong
    to their modules and stay)."""
    global _trace
    _trace = _Trace()


class _Span:
    __slots__ = ("name", "new_request", "id", "parent", "req", "on", "rf",
                 "t0")

    def __init__(self, name: str, new_request: bool = False):
        self.name, self.new_request = name, new_request

    def __enter__(self):
        st = _trace.stack()
        top = st[-1] if st else None
        self.id = next(_trace.ids)
        self.parent = top.id if top is not None else None
        self.req = (next(_trace.requests) if self.new_request
                    else top.req if top is not None else None)
        self.on = on()
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _RANGE(self.name)
            self.rf.__enter__()
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _trace.stack().pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if len(_trace.spans) < MAX_SPANS:
            _trace.spans.append((self.name, self.t0, t1, self.id,
                                 self.parent, self.req, self.on))
        else:
            _trace.dropped += 1
        return False


def span(name: str):
    """A hot span: recorded only while tracing is on."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NOOP
    return _Span(name)


def request(name: str):
    """A hot span that starts a new request id for the spans inside it."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NOOP
    return _Span(name, new_request=True)


def setup_span(name: str):
    """A set-up span: recorded always."""
    return _Span(name)


# --------------------------------------------------------------------------
# device phase marks
# --------------------------------------------------------------------------

_recording = None  # the Marks of the program whose function is running


def mark(phase: str):
    """End `phase` inside a running program (Marks.wrap); nothing
    elsewhere."""
    m = _recording
    if m is not None:
        m.stamp(phase)


class Marks:
    """The phase marks of one program (`program` names it in the
    snapshot) on `device`: a CUDA timing event each, recorded as a node
    of the captured graph, or a host-clock stamp on the CPU."""

    def __init__(self, program: str, device):
        self.program = program
        self.cuda = torch.device(device).type == "cuda"
        self.phases = []  # the phase each slot ends; START first
        self.slots = []
        self.next = 0
        self.tail_phase = self.tail_slot = None
        self.tailed = False
        self.traced = 0  # replays made while tracing was on
        self.unread = False  # the last replay is to be read and is not

    def wrap(self, fn):
        """fn, run with this program's marks recording: the start mark,
        then each mark(phase) into the next slot (a rerun, as the stand-in
        graphs make, stamps the same slots again)."""

        def marked():
            global _recording
            outer, _recording = _recording, self
            self.next = 0
            try:
                self.stamp(START)
                return fn()
            finally:
                _recording = outer

        return marked

    def _slot(self):
        # `external` makes a record inside a capture an event-record node
        # of the graph; outside a capture it records as usual
        if self.cuda:
            return torch.cuda.Event(enable_timing=True, external=True)
        return [0]

    def _record(self, slot):
        if self.cuda:
            slot.record()
        else:
            slot[0] = time.perf_counter_ns()

    def stamp(self, phase: str):
        i = self.next
        if i == len(self.slots):
            self.phases.append(phase)
            self.slots.append(self._slot())
        elif self.phases[i] != phase:
            raise RuntimeError(f"program {self.program!r}: mark {phase!r} "
                               f"where its capture marked {self.phases[i]!r}")
        self._record(self.slots[i])
        self.next = i + 1

    def before_replay(self):
        """Read the previous replay's marks, before this one overwrites
        them."""
        if self.unread:
            self.read(wait=False)

    def after_replay(self):
        """Hold this replay's marks for reading if tracing is on and the
        replay is one of the READ_EVERY it samples."""
        self.tailed = False
        if _enabled or _profiler._is_profiler_enabled:
            self.traced += 1
            if (self.traced - 1) % READ_EVERY == 0:
                self.unread = True
                _trace.unread[id(self)] = self

    def tail(self, phase: str):
        """An eager mark after a replay to be read (its copies out),
        ending `phase`."""
        if not self.unread:
            return
        if self.tail_slot is None:
            self.tail_slot = self._slot()
        self.tail_phase = phase
        self._record(self.tail_slot)
        self.tailed = True

    def read(self, wait: bool):
        """Add the last replay's phase times to the trace; with `wait`,
        wait for the device to pass them, else count the replay lost if it
        has not."""
        _trace.unread.pop(id(self), None)
        self.unread = False
        slots, phases = list(self.slots), self.phases[1:]
        if self.tailed:
            slots.append(self.tail_slot)
            phases = phases + [self.tail_phase]
        seen = _trace.replays.setdefault(self.program, [0, 0])
        if self.cuda:
            if wait:
                slots[-1].synchronize()
            elif not slots[-1].query():
                seen[1] += 1
                return
            ms = [a.elapsed_time(b) for a, b in zip(slots, slots[1:])]
        else:
            ms = [(b[0] - a[0]) / 1e6 for a, b in zip(slots, slots[1:])]
        seen[0] += 1
        by = _trace.phases.setdefault(self.program, {})
        for phase, t in zip(phases, ms):
            acc = by.setdefault(phase, [0, 0.0])
            acc[0] += 1
            acc[1] += t


# --------------------------------------------------------------------------
# the snapshot
# --------------------------------------------------------------------------

def _counters() -> dict:
    """The port's counters, read where they live."""
    from cutrace_tpu_torch.parallel import train
    from cutrace_tpu_torch.render import renderer

    out = {f"{m.__name__.rsplit('.', 1)[-1]}.{n}": getattr(m, n)
           for m, n in renderer._launch_counters()}
    for n in ("CAPTURES", "PROGRAM_MISSES", "PROGRAM_EVICTIONS"):
        out[f"renderer.{n}"] = getattr(renderer, n)
    out["train.REKEYS"] = train.REKEYS
    return out


def _by_name(spans) -> dict:
    """{"all" | "on" | "off": {name: {count, total_ms, self_ms}}}."""
    covered = {}
    for _, t0, t1, _, parent, _, _ in spans:
        if parent is not None:
            covered[parent] = covered.get(parent, 0) + t1 - t0
    out = {"all": {}, "on": {}, "off": {}}
    for name, t0, t1, sid, _, _, was_on in spans:
        for split in ("all", "on" if was_on else "off"):
            acc = out[split].setdefault(
                name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
            acc["count"] += 1
            acc["total_ms"] += (t1 - t0) / 1e6
            acc["self_ms"] += (t1 - t0 - covered.get(sid, 0)) / 1e6
    return out


def snapshot() -> dict:
    """What the process recorded, as plain JSON-ready values: `spans`
    (_by_name), `dropped`, `counters`, `phases` {program: {phase: {count,
    total_ms}}} (device time), `replays` {program: {read, lost}} and
    `on`. The last traced replay of each program is read first (waiting
    for the device)."""
    for m in list(_trace.unread.values()):
        m.read(wait=True)
    return {
        "on": on(),
        "spans": _by_name(list(_trace.spans)),
        "dropped": _trace.dropped,
        "counters": _counters(),
        "phases": {p: {k: {"count": c, "total_ms": t}
                       for k, (c, t) in by.items()}
                   for p, by in _trace.phases.items()},
        "replays": {p: {"read": r, "lost": lost}
                    for p, (r, lost) in _trace.replays.items()},
    }
