"""3-vector math over (..., 3) arrays (the port's copy of
cutrace_tpu.vecmath).

Analog of the reference's `vector`/`bound`/`matrix` value types (the
reference's inc/vector.hpp:25-277). Instead of a scalar struct everything
is a trailing-dim-3 array. All functions take an optional `xp` array module
(numpy by default).
"""

from __future__ import annotations

import numpy as np


def dot(a, b, xp=np):
    """Row-wise dot product over the trailing axis (vector.hpp:97-99)."""
    return xp.sum(a * b, axis=-1)


def cross(a, b, xp=np):
    """Row-wise 3D cross product (vector.hpp:88-94)."""
    return xp.cross(a, b)


def norm(a, xp=np):
    """Euclidean norm over the trailing axis (vector.hpp:104-106)."""
    return xp.sqrt(dot(a, a, xp))


def normalize(a, xp=np):
    """a / |a| (vector.hpp:111-114). Like the reference, no epsilon guard:
    a zero vector normalizes to NaN/Inf, and downstream comparisons treat
    NaN as "no hit" exactly as the CUDA comparisons do."""
    return a / norm(a, xp)[..., None]


def reflect(incoming, normal, xp=np):
    """incoming - 2 (n . incoming) n (vector.hpp:204-206)."""
    return incoming - 2.0 * dot(normal, incoming, xp)[..., None] * normal
