"""Output image encoders, matching the reference transfer functions exactly.

Equivalent of the reference's inc/images.hpp:26-88 (stb_image_write JPEG,
quality 90). The byte-level transfer functions are replicated so image diffs
against the reference are meaningful:

  depth  : byte = 255*(max_d - v)/max_d for finite v, else 0 (inverted;
           images.hpp:27-29)
  normal : byte = 255*(0.5 + 0.5*n_hat) per channel; |n| <= 1e-6 -> black
           (images.hpp:47-54)
  color  : byte = 255*clamp(v, 0, 1) (images.hpp:72-75)

All three use C-style float->byte truncation (the reference's `(byte)` cast),
not rounding. Files are written by extension: .jpg/.jpeg via PIL at quality
90 (stb's quality knob), .png via PIL lossless.
"""

from __future__ import annotations

import numpy as np

try:  # PIL is the JPEG backend; to_*_bytes work without it.
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def max_finite_depth(depth: np.ndarray) -> float:
    """Max finite depth value, 0 if none (kernel.hpp:121-125)."""
    d = np.asarray(depth)
    finite = d[np.isfinite(d)]
    return float(finite.max()) if finite.size and finite.max() > 0 else 0.0


def to_depth_bytes(depth: np.ndarray, max_d: float) -> np.ndarray:
    """(H,W) float depth -> (H,W,3) uint8, inverted grayscale
    (images.hpp:26-41)."""
    d = np.asarray(depth, np.float32)
    with np.errstate(invalid="ignore"):
        v = 255.0 * (max_d - d) / max_d
    byte = np.where(np.isfinite(d), v, 0.0)
    # C-style (byte) cast: truncation toward zero, wrap via uint8 overflow
    byte = np.nan_to_num(byte, nan=0.0, posinf=0.0, neginf=0.0)
    out = byte.astype(np.int64).astype(np.uint8)
    return np.repeat(out[..., None], 3, axis=-1)


def to_normal_bytes(normal: np.ndarray) -> np.ndarray:
    """(H,W,3) float normals -> (H,W,3) uint8, 0.5 + 0.5*n_hat encoding;
    zero-length normals (misses) -> black (images.hpp:47-66)."""
    n = np.asarray(normal, np.float32)
    length = np.sqrt((n * n).sum(-1, keepdims=True))
    with np.errstate(invalid="ignore", divide="ignore"):
        enc = 255.0 * (0.5 + 0.5 * n / length)
    enc = np.where(length > 1e-6, enc, 0.0)
    enc = np.nan_to_num(enc, nan=0.0, posinf=255.0, neginf=0.0)
    return enc.astype(np.int64).astype(np.uint8)


def to_color_bytes(color: np.ndarray) -> np.ndarray:
    """(H,W,3) linear RGB -> (H,W,3) uint8, clamp [0,1] (images.hpp:72-88)."""
    c = np.clip(np.nan_to_num(np.asarray(color, np.float32), nan=0.0), 0.0, 1.0)
    return (255.0 * c).astype(np.int64).astype(np.uint8)


def _write(path: str, data: np.ndarray) -> None:
    if str(path).lower().endswith((".jpg", ".jpeg")):
        # Prefer the native baseline encoder (native/jpeg.cpp — the
        # replacement for the reference's stb_image_write), quality 90
        # (images.hpp:39); PIL is the fallback.
        from cutrace_tpu_torch import native

        if native.jpeg_write(path, data, quality=90):
            return
    if Image is None:  # pragma: no cover
        raise RuntimeError(
            "neither the native encoder nor PIL is available"
        )
    img = Image.fromarray(data, mode="RGB")
    if str(path).lower().endswith((".jpg", ".jpeg")):
        img.save(path, quality=90)
    else:
        img.save(path)


def write_depth_map(path: str, depth: np.ndarray, max_d: float) -> None:
    """write_depth_map (images.hpp:26-41)."""
    _write(path, to_depth_bytes(depth, max_d))


def write_normal_map(path: str, normal: np.ndarray) -> None:
    """write_normal_map (images.hpp:47-66)."""
    _write(path, to_normal_bytes(normal))


def write_colorized(path: str, color: np.ndarray) -> None:
    """write_colorized (images.hpp:72-88)."""
    _write(path, to_color_bytes(color))
