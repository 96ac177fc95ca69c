"""Differentiable rendering: parameter views, losses and gradients
(counterpart of cutrace_tpu.diff)."""

from cutrace_tpu_torch.diff.grad import (  # noqa: F401
    DIFFERENTIABLE_FIELDS,
    extract_params,
    grad_render_loss,
    render_loss,
    with_params,
)
