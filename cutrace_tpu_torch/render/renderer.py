"""The device renderer: the host loop around the batched ray pipeline
(counterpart of cutrace_tpu.render.renderer).

The primary cast feeds the depth and normal buffers (a miss gives depth
+inf and normal 0) and the bounce tree the color buffer. Pixels are
visited in 32x16 blocks, so a warp of the fused kernel, or a chunk of the
composable path, covers a compact patch of the image.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from cutrace_tpu_torch.ops import bvh
from cutrace_tpu_torch.ops import intersect as I
from cutrace_tpu_torch.render import shading as sh
from cutrace_tpu_torch.scene.soa import (SceneArrays, host_triangle_soup,
                                         resolve_device, scene_to_soa)


@dataclasses.dataclass(frozen=True)
class PreparedScene:
    """A scene plus its cluster partition (an ops.bvh.Accel, or None for
    the brute-force composable path) and, on a CUDA device, the kernels'
    ops.fused.KernelTables. Build once with `prepare()`."""

    soa: SceneArrays
    accel: Optional[bvh.Accel] = None
    tables: Optional[object] = None


# Past this many triangles a "fused" partition takes C = 512 (the JAX
# package's VMEM table bound, where its kernel switched to streamed tables
# with bigger per-visit blocks).
BIG_TABLE_TRIANGLES = 262144


def prepare(scene_or_soa, accel: str = "auto", device="cuda",
            bounces: Optional[int] = None) -> PreparedScene:
    """Build the device scene and its acceleration structure.

    accel: "none" (composable brute force), "clusters" (the composable
    path with the dense cast over C=64 clusters, no culling), "pallas"
    (the composable path with the culling cast, K4 on a CUDA device),
    "fused" (the fused kernels K1 / K3 on a CUDA device, their plain
    version on the CPU; the composable culling cast past their 63-node
    scope) or "auto" ("fused" on a CUDA device, "none" on the CPU).
    `device` places a Scene's tensors: the card unless the caller passes
    "cpu" (without a card the call raises); a SceneArrays stays where it
    is. `bounces` is accepted for callers that know the depth; no depth
    is refused. On a CUDA device the kernels' tables are built here, once
    per scene.

    The "fused" cluster size is the JAX package's policy: the smallest of
    C = 64 and 128 that keeps the partition within LANES_MAX_M clusters
    (K1), else C = 256 (K3), and C = 512 past 262,144 triangles."""
    from cutrace_tpu_torch.ops import fused

    host_tris = None
    if isinstance(scene_or_soa, SceneArrays):
        soa = scene_or_soa
    else:
        host_tris = host_triangle_soup(scene_or_soa)
        soa = scene_to_soa(scene_or_soa, device=resolve_device(device))
    if accel == "auto":
        accel = "fused" if soa.device.type == "cuda" else "none"
    if accel == "none":
        return PreparedScene(soa=soa)
    if accel not in bvh.KINDS:
        raise ValueError(f"unknown accel {accel!r}")
    size = bvh.CLUSTER_SIZE
    if accel == "fused":
        n_tris = int(soa.tri_p1.shape[0])
        size = 256
        for c in (64, 128):
            if n_tris <= fused.LANES_MAX_M * c:
                size = c
                break
        if n_tris > BIG_TABLE_TRIANGLES:
            size = 512
    acc = bvh.build_accel(soa, cluster_size=size, host_tris=host_tris,
                          kind=accel)
    tables = (fused.kernel_tables(soa, acc) if soa.device.type == "cuda"
              else None)
    return PreparedScene(soa=soa, accel=acc, tables=tables)


def camera_rays(soa: SceneArrays, px, py):
    """Pinhole rays for pixel coordinates:
    dir = normalize(((x/w - 0.5)·aspect)·right + (0.5 - y/h)·up + forward),
    origin = eye. px, py: (R,) tensors of pixel indices."""
    w = torch.tensor(float(soa.width), dtype=torch.float32, device=px.device)
    h = torch.tensor(float(soa.height), dtype=torch.float32, device=px.device)
    aspect = w / h
    px = px.to(torch.float32)
    py = py.to(torch.float32)
    xv = ((px / w - 0.5) * aspect)[:, None] * soa.cam_right[None, :]
    yv = (0.5 - py / h)[:, None] * soa.cam_up[None, :]
    d = xv + yv + soa.cam_forward[None, :]
    d = d / torch.sqrt((d * d).sum(-1))[:, None]
    o = soa.cam_eye[None, :].expand_as(d)
    return o, d


def render_rays(soa: SceneArrays, o, d, bounces: int, fudge,
                tri_candidates=None):
    """One chunk of the composable pipeline: primary cast (depth/normal)
    + bounce tree (color). Returns (color (R,3), depth (R,), normal (R,3))."""
    primary = I.ray_cast(soa, o, d, fudge, tri_candidates, need_uv=False)
    color = sh.ray_color(soa, o, d, fudge, bounces, tri_candidates)
    return color, primary.t, primary.normal


def default_chunk(soa: SceneArrays, bounces: int, lights: bool = True) -> int:
    """Rays per composable batch. It bounds the peak batch: the deepest
    level carries 2^bounces nodes per pixel in two-branch trees, and shadow
    marches batch all lights into one cast over (rays x triangles)
    intermediates (`lights`; the culling cast has none)."""
    max_nodes = 2**bounces if (soa.any_reflective and soa.any_transparent) \
        else 1
    if lights:
        max_nodes *= max(1, soa.n_lights)
    return max(1024, 65536 // max_nodes)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=8)
def _block_order(w: int, h: int, n_pad: int, bw: int = 32, bh: int = 16):
    """Pixel visit order that walks 32x16 image blocks instead of
    scanlines. Returns (order, inverse) int64 numpy arrays of length
    n_pad; indices >= w*h are padding. Read-only: the cache shares them."""
    xs = np.arange(_ceil_to(w, bw))
    ys = np.arange(_ceil_to(h, bh))
    gx, gy = np.meshgrid(xs, ys)
    key = (
        ((gy // bh) * (10**9))
        + ((gx // bw) * (10**6))
        + ((gy % bh) * (10**3))
        + (gx % bw)
    )
    flat_idx = gy * w + gx
    inside = (gx < w) & (gy < h)
    order = flat_idx[inside].ravel()[np.argsort(key[inside].ravel(),
                                                kind="stable")]
    n = w * h
    order = np.concatenate([order, np.arange(n, n_pad)]).astype(np.int64)
    inverse = np.zeros(n_pad, np.int64)
    inverse[order] = np.arange(n_pad, dtype=np.int64)
    order.flags.writeable = False
    inverse.flags.writeable = False
    return order, inverse


def block_rays(soa: SceneArrays, n_pad: Optional[int] = None):
    """Camera rays for the whole image in 32x16 block order, plus the
    inverse permutation (a tensor) back to scanline order."""
    n = soa.width * soa.height
    order, inverse = _block_order(soa.width, soa.height,
                                  n if n_pad is None else n_pad)
    idx = torch.from_numpy(order.copy()).to(soa.device)
    o, d = camera_rays(soa, idx % soa.width, idx // soa.width)
    return o, d, torch.from_numpy(inverse.copy()).to(soa.device)


def to_image(soa, inverse, color, depth, normal):
    """Per-ray (color, depth, normal) in block order -> (H,W,3), (H,W),
    (H,W,3) images in scanline order."""
    n = soa.width * soa.height
    color = color[inverse][:n]
    depth = depth[inverse][:n]
    normal = normal[inverse][:n]
    return (
        color.reshape(soa.height, soa.width, 3),
        depth.reshape(soa.height, soa.width),
        normal.reshape(soa.height, soa.width, 3),
    )


@torch.no_grad()
def _render_fused(prepared: PreparedScene, bounces: int, fudge: float):
    """Whole-image render through ops.fused.fused_render_rays, one call for
    the full frame."""
    from cutrace_tpu_torch.ops.fused import fused_render_rays

    soa = prepared.soa
    o, d, inverse = block_rays(soa)
    color, depth, normal = fused_render_rays(
        soa, prepared.accel, o, d, fudge, bounces, tables=prepared.tables)
    return to_image(soa, inverse, color, depth, normal)


@torch.no_grad()
def render(scene_or_soa, bounces: int = 5, fudge: float = 1e-3,
           chunk: Optional[int] = None, device="cuda"):
    """Render the full image: (color (H,W,3), depth (H,W), normal (H,W,3))
    float32 tensors on the scene's device.

    Accepts a Scene (placed on `device`: the card unless the caller
    passes "cpu"; without a card the call raises), a SceneArrays (brute-force
    composable path) or a PreparedScene from prepare(). A "fused"
    partition runs ops.fused.fused_render_rays while the bounce tree is in
    the kernels' scope; past it, and for "clusters" and "pallas"
    partitions, the composable path runs with the partition's triangle
    query (ops.bvh.candidates_fn). `chunk` bounds the rays per composable
    batch."""
    from cutrace_tpu_torch.ops import fused

    accel = tables = None
    if isinstance(scene_or_soa, PreparedScene):
        accel, tables = scene_or_soa.accel, scene_or_soa.tables
        if fused.fused_supported(scene_or_soa.soa, accel, bounces):
            return _render_fused(scene_or_soa, bounces, float(fudge))
        scene_or_soa = scene_or_soa.soa
    soa = (
        scene_or_soa
        if isinstance(scene_or_soa, SceneArrays)
        else scene_to_soa(scene_or_soa, device=resolve_device(device))
    )

    n = soa.width * soa.height
    if chunk is None:
        # the culling cast materializes no (rays x triangles) products, so
        # its chunks need not shrink with the light fan-out
        culls = accel is not None and accel.kind != "clusters"
        chunk = default_chunk(soa, bounces, lights=not culls)
    chunk = max(8, min(chunk, _ceil_to(n, 8)))
    o, d, inverse = block_rays(soa, _ceil_to(n, chunk))
    color, depth, normal = render_chunks(soa, o, d, bounces, fudge,
                                         bvh.candidates_fn(accel, tables),
                                         chunk)
    return to_image(soa, inverse, color, depth, normal)


def render_chunks(soa, o, d, bounces: int, fudge, tri_candidates, chunk):
    """render_rays over the rays in batches of `chunk`, concatenated."""
    outs = [
        render_rays(soa, o[s:s + chunk], d[s:s + chunk], bounces, fudge,
                    tri_candidates)
        for s in range(0, o.shape[0], chunk)
    ]
    return tuple(torch.cat(x) for x in zip(*outs))
