"""K1 (the fused forward's shared-memory instance) against the frame's
forward bound (portbench.roofline, from the reference's count of the
work), in %: bound / K1's device time a frame."""

from portbench.trace import kernel_seconds


def read(s):
    if s.get("kind") != "render" or not s["requests"]:
        return None
    t = kernel_seconds(s, "fused_forward_shared_kernel") / s["requests"]
    return 100.0 * s["bounds"]["forward"] / t if t > 0 else None
