"""Checkpoint and resume for inverse-rendering optimization (counterpart of
cutrace_tpu.diff.checkpoint).

A checkpoint is the scene parameters, the optimizer's state_dict and the
step counter, written with torch.save to `<dir>/step_<n>.pt`.
"""

from __future__ import annotations

import os
import pathlib
from typing import Any, Dict, Optional, Tuple

import torch


def save_checkpoint(path: str, params: Dict, opt_state: Any,
                    step: int) -> None:
    """Persist (params, opt_state, step) under the directory `path`."""
    os.makedirs(path, exist_ok=True)
    state = {
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "opt_state": opt_state,
        "step": int(step),
    }
    target = os.path.join(path, f"step_{step}.pt")
    tmp = target + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, target)


def latest_step(path: str) -> Optional[int]:
    """Newest checkpoint step under `path`, or None."""
    p = pathlib.Path(path)
    if not p.exists():
        return None
    steps = []
    for child in p.iterdir():
        name = child.name
        if name.startswith("step_") and name.endswith(".pt"):
            try:
                steps.append(int(name[5:-3]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore_checkpoint(path: str, like_params: Optional[Dict] = None,
                       step: Optional[int] = None,
                       ) -> Optional[Tuple[Dict, Any, int]]:
    """Restore (params, opt_state, step), the newest step unless `step` is
    given; None when no checkpoint exists. Each parameter lands on the
    device of its namesake in `like_params` (the CPU without one); the
    optimizer state loads through the optimizer's load_state_dict, which
    moves it to its parameters' device."""
    if step is None:
        step = latest_step(path)
    if step is None:
        return None
    state = torch.load(os.path.join(path, f"step_{step}.pt"),
                       map_location="cpu", weights_only=True)
    params = state["params"]
    if like_params is not None:
        params = {k: v.to(like_params[k].device) if k in like_params else v
                  for k, v in params.items()}
    return params, state["opt_state"], int(state["step"])
