"""K1 with topology codes (the fused forward's shared-memory instance) in
a fit step against the forward's bound (portbench.roofline), in %: bound
/ K1's device time a step."""

from portbench.trace import kernel_seconds


def read(s):
    if s.get("kind") != "train" or not s["requests"]:
        return None
    t = kernel_seconds(s, "fused_forward_shared_kernel") / s["requests"]
    return 100.0 * s["bounds"]["forward"] / t if t > 0 else None
