"""Device milliseconds a fit step of the tables rebuilt from the live
parameters (the replay backward's and the forward kernel's): the step
program's phase `tables`."""

from portbench.program_trace import phase_ms


def read(s):
    return phase_ms(s, "train", "step", "tables")
