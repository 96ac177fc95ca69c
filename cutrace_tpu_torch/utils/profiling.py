"""Throughput units (counterpart of cutrace_tpu.utils.profiling, its
`casts_per_pixel` only), so that Mcasts/s means what it means in the JAX
package. Timing on the card uses CUDA events where it is taken."""

from __future__ import annotations


def casts_per_pixel(soa, bounces: int) -> int:
    """Nearest-hit scene queries per pixel for the compiled bounce tree:
    nodes * (1 + n_lights * shadow_steps), where the node count follows
    the static branch pruning in render/shading.py. It counts the march's
    capacity, not the steps a run takes."""
    if soa.any_reflective and soa.any_transparent:
        nodes = 2 ** (bounces + 1) - 1
    elif soa.any_reflective or soa.any_transparent:
        nodes = bounces + 1
    else:
        nodes = 1
    return nodes * (1 + soa.n_lights * soa.shadow_steps)
