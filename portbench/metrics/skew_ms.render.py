"""Device milliseconds a frame that the split of the image over the tile
ranks costs a sharded frame: the slowest rank's fused-kernel (K1 or K3)
time a frame less the mean over the ranks, so 0 on an even split."""

from portbench.trace import kernel_seconds


def read(s):
    if s.get("kind") != "render_sharded" or not s["ranks"] or \
            not all(r["requests"] for r in s["ranks"]):
        return None
    per = [kernel_seconds(r, "fused_forward") / r["requests"]
           for r in s["ranks"]]
    if max(per) <= 0:
        return None
    return (max(per) - sum(per) / len(per)) * 1e3
