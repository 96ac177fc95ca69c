"""Device milliseconds a fit step outside the forward kernel (K1 or K3)
and the replay backward (K2): camera rays, the kernels' tables, routing
and the optimizer's update, from the traced window."""

from portbench.trace import kernel_seconds

KERNELS = ("fused_forward", "replay_vjp")


def read(s):
    if s.get("kind") != "train" or not s["requests"]:
        return None
    total = sum(v[1] for v in s["kernels"].values())
    if total == 0:
        return None
    return (total - kernel_seconds(s, *KERNELS)) * 1e3 / s["requests"]
