"""Timing, throughput units and profiling of the port (counterpart of
cutrace_tpu.utils), and the roofline bounds and image gates its
benchmark and chip smoke test hold the kernels to."""

from cutrace_tpu_torch.utils.profiling import (  # noqa: F401
    RenderTimings,
    device_trace,
    event_ms,
    kernel_records,
    sample_ms,
    spread,
    summarize_trace,
    timed_render,
)
