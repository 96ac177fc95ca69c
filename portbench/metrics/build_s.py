"""Host seconds of the program's builds in the run: every `program.build`
set-up span (a program's eager warm-up, its kernels' load the first
time, and its capture), all before the window in these cells."""

from portbench.program_trace import setup_s


def read(s):
    return setup_s(s, ("render", "train"), "program.build")
