"""K3 (the fused forward's ordered tree walk) against the frame's forward
bound (portbench.roofline), in %: bound / K3's device time a frame."""

from portbench.trace import kernel_seconds


def read(s):
    if s.get("kind") != "render" or not s["requests"]:
        return None
    t = kernel_seconds(s, "fused_forward_kernel<true>") / s["requests"]
    return 100.0 * s["bounds"]["forward"] / t if t > 0 else None
