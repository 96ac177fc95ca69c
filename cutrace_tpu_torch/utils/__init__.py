"""Timing, throughput units and profiling of the port (counterpart of
cutrace_tpu.utils)."""

from cutrace_tpu_torch.utils.profiling import (  # noqa: F401
    RenderTimings,
    device_trace,
    summarize_trace,
    timed_render,
)
