"""Training loops (counterpart of cutrace_tpu.parallel; one device)."""
