"""Device milliseconds of the NCCL all-gather kernels a frame on the
slowest rank of a sharded frame (the image's gather, waits included)."""

from portbench.trace import kernel_seconds


def read(s):
    if s.get("kind") != "render_sharded":
        return None
    per = [kernel_seconds(r, "AllGather") / r["requests"]
           for r in s["ranks"] if r["requests"]]
    return max(per) * 1e3 if per and max(per) > 0 else None
