"""Device milliseconds a frame after the forward kernel: the frame
program's phase `unpermute` (the images put back in scanline order) and
the eager `copy_out` after the replay (the images copied out of the
graph's memory)."""

from portbench.program_trace import phase_ms


def read(s):
    return phase_ms(s, "render", "frame", "unpermute", "copy_out")
