"""The whole fit step's share of the card's peak, in %: the forward's and
the replay backward's bounds (portbench.roofline) over the traced
window's time a step."""


def read(s):
    if s.get("kind") != "train" or not s["requests"]:
        return None
    b = s["bounds"]
    return 100.0 * (b["forward"] + b["backward"]) * s["requests"] \
        / s["window_s"]
