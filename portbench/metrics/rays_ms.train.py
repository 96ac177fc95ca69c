"""Device milliseconds a fit step of the camera rays (with the
parameters put in the scene): the step program's phase `rays`."""

from portbench.program_trace import phase_ms


def read(s):
    return phase_ms(s, "train", "step", "rays")
