"""K2 (the replay backward and the rounding of its exact sums) against
the backward's bound (portbench.roofline: the reference's hit nodes and
their lights), in %: bound / the device time of K2's two kernels a
step."""

from portbench.trace import kernel_seconds


def read(s):
    if s.get("kind") != "train" or not s["requests"]:
        return None
    t = kernel_seconds(s, "replay_vjp_kernel",
                       "replay_vjp_finalize_kernel") / s["requests"]
    return 100.0 * s["bounds"]["backward"] / t if t > 0 else None
