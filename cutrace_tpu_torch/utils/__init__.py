"""Throughput units of the port (counterpart of cutrace_tpu.utils)."""
