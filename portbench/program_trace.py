"""The program's own trace (cutrace_tpu_torch.utils.tracing), read in the
run's process after the window: the phase marks it recorded while
tracing was on (the traced window's torch.profiler turns it on) and its
set-up spans. The host spans of the window are not read: under the
profiler they hold mostly the profiler's own cost. Each reader gives
None for another kind of run, and where the program has no tracing
module or recorded nothing of the kind asked for."""

from __future__ import annotations


def snapshot(s: dict, *kinds: str):
    """The program's snapshot for a run of one of `kinds`, or None."""
    if s.get("kind") not in kinds:
        return None
    try:
        from cutrace_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def phase_ms(s: dict, kind: str, program: str, *phases: str):
    """Device milliseconds a traced replay of `program` between the marks
    that end `phases`: each phase's total over its count, summed."""
    snap = snapshot(s, kind)
    got = snap and snap["phases"].get(program, {})
    if not got or any(p not in got for p in phases):
        return None
    return sum(got[p]["total_ms"] / got[p]["count"] for p in phases)


def setup_s(s: dict, kinds, name: str):
    """Seconds of every `name` set-up span a run of one of `kinds`
    recorded."""
    snap = snapshot(s, *kinds)
    got = snap and snap["spans"]["all"].get(name)
    return got["total_ms"] / 1e3 if got else None
