"""What every loop shares: the run's context, the device's helpers, the
reference's pixel samples and the scene sizes the bounds need."""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from portbench import inputs

WARMUP = 2  # requests before the window: the capture, then a replay


@dataclasses.dataclass
class Context:
    """One run: the cell, its configuration and mix, the seed, the window's
    seconds, whether it is traced, the device, and the process's start on
    the host clock (time.perf_counter) and the wall clock (time.time)."""

    workload: dict
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    t0_wall: float

    @property
    def window_seconds(self) -> float:
        """A traced run's window is the mix's `trace_seconds` at most."""
        if self.trace:
            return min(self.seconds, self.mix.get("trace_seconds",
                                                  self.seconds))
        return self.seconds

    @property
    def block(self) -> int:
        """Pixels a block of the reference."""
        return self.cfg["reference"]["block"]

    def reference_pixels(self, kind: str) -> int:
        """The configuration's `check_pixels` (0: every pixel) or
        `count_pixels`: how many pixels the reference checks or counts."""
        return self.cfg["reference"][kind]


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev):
    if dev.type == "cuda":
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def free(dev):
    """Let go of what the program's state held on the device."""
    gc.collect()
    if dev.type == "cuda":
        sync(dev)
        torch.cuda.empty_cache()


def sample_pixels(n: int, k: int, seed: int, stream: int, device):
    """k distinct flat pixel indices of n drawn from the seed (every pixel
    when k is 0 or at least n), sorted."""
    if k <= 0 or k >= n:
        idx = np.arange(n)
    else:
        idx = np.sort(inputs.rng(seed, stream).choice(n, k, replace=False))
    return torch.as_tensor(idx, device=device)


def flat_frame(frame):
    """(color (H, W, 3), depth (H, W), normal (H, W, 3)) -> flat rows on
    the CPU."""
    color, depth, normal = frame
    return (color.reshape(-1, 3).cpu(), depth.reshape(-1).cpu(),
            normal.reshape(-1, 3).cpu())


def scene_sizes(data) -> dict:
    """The reference scene's counts the bounds need."""
    return {"n_tris": len(data.tris), "n_planes": len(data.pl_point),
            "n_spheres": len(data.sp_center), "n_mats": len(data.mat_color),
            "n_lights": len(data.light_point)}
