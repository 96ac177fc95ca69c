"""Device milliseconds a fit step of the optimizer's update (capturable
Adam): the step program's phase `optimizer`."""

from portbench.program_trace import phase_ms


def read(s):
    return phase_ms(s, "train", "step", "optimizer")
