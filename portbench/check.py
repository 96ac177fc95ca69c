"""The numbers that decide `correct`, each against its limit.

A frame (color, depth, normal, flat in scanline order) is compared pixel
by pixel with the reference's:
  pixels_off_pct    the share of compared pixels, in %, where the color
                    differs by more than COLOR_TOL in a channel, the normal
                    by more than NORMAL_TOL in a component, or the depth by
                    more than DEPTH_TOL of max(1, the reference's depth) (a
                    hit against a miss, or a NaN anywhere, is off);
  color_gap_median  the median over the compared pixels of the largest
                    channel's color difference.
A fit's first steps are compared with the reference's steps from the same
start and target:
  loss_gap          the largest |loss - reference loss| / reference loss
                    over the steps;
  grad_gap          the first step's gradient, as the optimizer got it:
                    the worst group's |norm - reference norm| / max(the
                    reference's norm of that group, of the median group);
  change_gap        the same of each group's change over the steps, over
                    the groups whose reference gradient is at least
                    MOVED of the median group's.
"""

from __future__ import annotations

import math

import torch

COLOR_TOL = 1e-3
NORMAL_TOL = 1e-3
DEPTH_TOL = 1e-4
MOVED = 1e-3


def frame_numbers(prog, ref) -> dict:
    """prog, ref: (color (R, 3), depth (R,), normal (R, 3)) on the CPU."""
    pc, pd, pn = (x.double() for x in prog)
    rc, rd, rn = (x.double() for x in ref)
    gap = (pc - rc).abs().amax(1).nan_to_num(math.inf)
    ngap = (pn - rn).abs().amax(1).nan_to_num(math.inf)
    both_inf = torch.isinf(pd) & torch.isinf(rd) & (pd == rd)
    dgap = torch.where(both_inf, torch.zeros_like(pd),
                       (pd - rd).abs().nan_to_num(math.inf))
    off = ((gap > COLOR_TOL) | (ngap > NORMAL_TOL)
           | (dgap > DEPTH_TOL * rd.abs().clamp(min=1.0).nan_to_num(1.0)))
    return {"pixels_off_pct": 100.0 * float(off.double().mean()),
            "color_gap_median": float(gap.median())}


def group_gaps(prog: dict, ref: dict, keys) -> dict:
    """Each group's |norm - reference norm| / max(the reference's norm of
    the group, of the median group)."""
    norms = {k: float(ref[k].double().norm()) for k in keys}
    med = sorted(norms.values())[(len(norms) - 1) // 2]
    return {k: abs(float(prog[k].double().norm()) - norms[k])
            / max(norms[k], med, 1e-300) for k in keys}


def fit_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses": [...], "grads": {group: tensor}, "change":
    {group: tensor}}, tensors on the CPU."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                  ref["losses"])]
    groups = sorted(ref["grads"])
    gnorm = {k: float(ref["grads"][k].double().norm()) for k in groups}
    med = sorted(gnorm.values())[(len(groups) - 1) // 2]
    moved = [k for k in groups if gnorm[k] >= MOVED * med]
    return {"loss_gap": max(losses),
            "grad_gap": max(group_gaps(prog["grads"], ref["grads"],
                                       groups).values()),
            "change_gap": max(group_gaps(prog["change"], ref["change"],
                                         moved).values())}


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): each number at most its limit;
    a number that is not finite, or has no limit, fails."""
    rows = [(k, v, limits.get(k)) for k, v in numbers.items()]
    ok = all(lim is not None and math.isfinite(v) and v <= lim
             for _, v, lim in rows)
    return ok, rows
