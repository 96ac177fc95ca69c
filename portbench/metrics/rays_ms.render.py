"""Device milliseconds a frame of the camera rays, before the forward
kernel: the frame program's phase `rays`, between its start mark and
the mark after the rays."""

from portbench.program_trace import phase_ms


def read(s):
    return phase_ms(s, "render", "frame", "rays")
