"""The device's idle share over a steady traced window of fit steps, in
%: 1 - the union of its kernels, copies and memsets over the window's
length."""


def read(s):
    if s.get("kind") != "train":
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
