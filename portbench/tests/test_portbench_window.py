"""The window's arithmetic: the rate over the whole window, a tail that
moves when one request stalls, the kept request."""

import pytest

from portbench.window import Window, percentile


class FakeClock:
    """A clock that each request advances by its own latency."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def run(latencies, seconds):
    clock = FakeClock()
    it = iter(latencies)

    def request():
        clock.now += next(it)
        return clock.now

    return Window(seconds, seed=7, clock=clock).run(request)


def test_rate_is_the_window_over_its_requests():
    w = run([0.01] * 1000, 1.0)
    assert len(w.latencies) == 100
    assert w.window_s == pytest.approx(1.0)
    assert w.mean_ms() == pytest.approx(10.0)


def test_one_stall_moves_the_tail_and_the_rate():
    base = run([0.01] * 200, 2.0)
    # one request in twenty stalls: the 95th percentile reaches the stall
    stalled = run([0.05 if i % 20 == 0 else 0.01 for i in range(400)], 2.0)
    assert base.p95_ms() == pytest.approx(10.0)
    assert stalled.p95_ms() == pytest.approx(50.0)
    assert stalled.mean_ms() > base.mean_ms()


def test_window_ends_at_the_first_completion_past_its_time():
    w = run([0.3] * 10, 1.0)
    assert len(w.latencies) == 4 and w.window_s == pytest.approx(1.2)


def test_the_kept_request_is_one_of_the_window():
    w = run([0.01] * 100, 0.5)
    assert w.kept is not None
    assert w.kept == pytest.approx(100.0 + 0.01 * (w.kept_index + 1))


def test_the_kept_request_is_drawn_uniformly():
    picks = [0] * 10
    for seed in range(2000):
        w = Window(1.0, seed)
        for i in range(10):
            w.add(0.01, i)
        picks[w.kept] += 1
    assert min(picks) > 150 and max(picks) < 250


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert percentile(xs, 95) == 95
    assert percentile([3.0], 95) == 3.0
