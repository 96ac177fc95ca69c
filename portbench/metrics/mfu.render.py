"""The whole frame's share of the card's peak, in %: the frame's forward
bound (portbench.roofline, the reference's count of the work) over the
traced window's time a frame."""


def read(s):
    if s.get("kind") != "render" or not s["requests"]:
        return None
    return 100.0 * s["bounds"]["forward"] * s["requests"] / s["window_s"]
