"""Device milliseconds a fit step of autograd after the replay backward:
the cotangents routed through the tables and rays to the parameters'
gradients, the step program's phase `routing`."""

from portbench.program_trace import phase_ms


def read(s):
    return phase_ms(s, "train", "step", "routing")
