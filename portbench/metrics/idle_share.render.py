"""The device's idle share over a steady traced window of frames, in %:
1 - the union of its kernels, copies and memsets over the window's
length; the mean over the ranks on several cards."""


def read(s):
    if s.get("kind") not in ("render", "render_sharded"):
        return None
    ranks = s.get("ranks", [s])
    return 100.0 * sum(1.0 - r["busy_s"] / r["window_s"]
                       for r in ranks) / len(ranks)
