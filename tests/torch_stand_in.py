"""A stand-in for the port's CUDA graphs on the CPU (renderer.GRAPHS), for
the tests of the frame and step programs: tests/test_torch_train.py puts
it in place with monkeypatch, and tests/test_torch_parallel.py's gloo
ranks put it in place for their program cases."""

import torch


class StandInGraph:
    """A stand-in for a torch.cuda.CUDAGraph on the CPU: replay reruns the
    captured function and copies its results into the tensors the capture
    returned. The capture ran the function once where a real one records
    it, so the first replay keeps that run's results (the real first
    replay's update) and reruns nothing."""

    def __init__(self, fn, outputs, log):
        self.fn, self.outputs, self.log = fn, outputs, log
        self.fresh = True

    def replay(self):
        self.log.append("replay")
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
    """renderer.GRAPHS with programs on the CPU: the warm-up runs fn in
    place, a capture returns a StandInGraph. `log` records the calls."""

    def __init__(self):
        self.log = []

    def captures(self, device):
        return True

    def warm(self, fn, device):
        self.log.append("eager")
        return fn()

    def capture(self, fn, device):
        self.log.append("capture")
        outputs = fn()
        return StandInGraph(fn, outputs, self.log), outputs
