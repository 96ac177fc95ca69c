"""The device renderer: the host loop around the batched ray pipeline
(counterpart of cutrace_tpu.render.renderer).

The primary cast feeds the depth and normal buffers (a miss gives depth
+inf and normal 0) and the bounce tree the color buffer; the tree's level
0 is that primary cast. Pixels are visited in 32x16 blocks, so a warp of
the fused kernel, or a chunk of the composable path, covers a compact
patch of the image.

Where the JAX package jits a frame into one program (`_render_fused`,
`_render_padded`), the port captures it on a CUDA device as a CUDA graph
and replays it: the whole fused frame, or one composable chunk replayed
over the frame's chunks. The same functions run op by op on the CPU and
in `render_eager`, the programs' plain version.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import weakref
from typing import NamedTuple, Optional

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


def _device_key(device) -> torch.device:
    """`device` with its index: the current card's for a bare "cuda"."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.cache
def _camera_constants(width: int, height: int, device: torch.device):
    """(3,) float32 [w, h, w / h] on `device`, the quotient taken in
    float32 as the JAX package takes it. Kept on the device, once per key:
    a host scalar divisor would make CUDA's division a multiplication by
    its reciprocal, which changes bits."""
    w, h = np.float32(width), np.float32(height)
    return torch.from_numpy(np.array([w, h, w / h], np.float32)).to(device)


def camera_rays(soa: SceneArrays, px, py):
    """Pinhole rays for pixel coordinates:
    dir = normalize(((x/w - 0.5)·aspect)·right + (0.5 - y/h)·up + forward),
    origin = eye. px, py: (R,) tensors of pixel indices (integer or
    float32). The constants come from a per-device cache, so a warm call
    copies nothing from the host."""
    c = _camera_constants(soa.width, soa.height, _device_key(px.device))
    w, h, aspect = c[0], c[1], c[2]
    px = px.to(torch.float32)
    py = py.to(torch.float32)
    xv = ((px / w - 0.5) * aspect)[:, None] * soa.cam_right[None, :]
    yv = (0.5 - py / h)[:, None] * soa.cam_up[None, :]
    d = xv + yv + soa.cam_forward[None, :]
    # the float32 root correctly rounded on every device, as JAX's and
    # CUDA's are: torch's float32 sqrt on the CPU is one ulp off for about
    # 0.7 % of inputs, while a float64 root rounded to float32 is exact
    norm = torch.sqrt((d * d).sum(-1).to(torch.float64)).to(torch.float32)
    d = d / norm[:, None]
    o = soa.cam_eye[None, :].expand_as(d)
    return o, d


def render_rays(soa: SceneArrays, o, d, bounces: int, fudge,
                tri_candidates=None):
    """One chunk of the composable pipeline: the bounce tree (color), whose
    level-0 hit is the primary cast (depth/normal), so the primary rays
    are cast once, as XLA's CSE leaves the JAX program. Returns (color
    (R,3), depth (R,), normal (R,3))."""
    color, primary = sh._ray_color(soa, o, d, fudge, bounces, tri_candidates)
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


class BlockOrder(NamedTuple):
    """`_block_order` on a device: the visit order and its inverse (int64,
    n_pad), and the visited pixels' float32 coordinates as the rows of
    `pxy` (2, n_pad), `px` = pxy[0] and `py` = pxy[1]."""

    order: torch.Tensor
    inverse: torch.Tensor
    pxy: torch.Tensor

    @property
    def px(self):
        return self.pxy[0]

    @property
    def py(self):
        return self.pxy[1]


@functools.lru_cache(maxsize=8)
def _block_order_on(w: int, h: int, n_pad: int, device: torch.device):
    order, inverse = _block_order(w, h, n_pad)
    pxy = np.stack([order % w, order // w]).astype(np.float32)
    return BlockOrder(*(torch.from_numpy(a.copy()).to(device)
                        for a in (order, inverse, pxy)))


def block_order_tensors(w: int, h: int, n_pad: int, device) -> BlockOrder:
    """The block order of a (w, h) image padded to n_pad pixels on
    `device`, uploaded once per (w, h, n_pad, device) and shared by every
    caller (read-only): the counterpart of the JAX program's compile-time
    constant."""
    return _block_order_on(w, h, n_pad, _device_key(device))


def block_rays(soa: SceneArrays, n_pad: Optional[int] = None):
    """Camera rays for the whole image in 32x16 block order, plus the
    inverse permutation (a tensor) back to scanline order."""
    n = soa.width * soa.height
    bo = block_order_tensors(soa.width, soa.height,
                             n if n_pad is None else n_pad, soa.device)
    o, d = camera_rays(soa, bo.px, bo.py)
    return o, d, bo.inverse


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


# --------------------------------------------------------------------------
# the frame programs
# --------------------------------------------------------------------------

# Programs kept at once (least recently used dropped first); each holds its
# graph's memory pool, a frame's or a chunk's peak.
PROGRAM_CACHE_SIZE = 4
# Programs captured since import: a second render of the same scene
# replays and adds none.
CAPTURES = 0
_PROGRAMS: "collections.OrderedDict" = collections.OrderedDict()
_OWNERS: dict = {}  # id(scene) -> its weakref.finalize


def _launch_counters():
    """(module, name) of every kernel wrapper's launch counter."""
    from cutrace_tpu_torch.ops import fused, pallas_cast, replay_vjp

    return [(fused, n) for n in (
        "LAUNCHES", "TOPO_LAUNCHES", "GLOBAL_LAUNCHES",
        "GLOBAL_TOPO_LAUNCHES", "BIG_LAUNCHES", "BIG_TOPO_LAUNCHES")] + [
        (pallas_cast, "LAUNCHES"), (replay_vjp, "LAUNCHES")]


class _CudaGraphs:
    """How a program is warmed and captured on a device: the CUDA graph
    API. `GRAPHS` is the one place the port reaches torch.cuda.graph; a
    test puts a stand-in there that reruns the captured function."""

    @staticmethod
    def captures(device) -> bool:
        """Are programs captured on `device` (a CUDA device)?"""
        return torch.device(device).type == "cuda"

    @staticmethod
    def warm(fn, device):
        """fn() on a side stream of `device`, joined back to the current
        stream: the eager run a capture needs before it (kernels built
        and loaded, every per-device constant cache filled)."""
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                out = fn()
            torch.cuda.current_stream().wait_stream(side)
        return out

    @staticmethod
    def capture(fn, device):
        """(graph, outputs): fn() captured as a torch.cuda.CUDAGraph on
        `device`, its results in the graph's pool. Nothing runs until
        the graph is replayed; a failure to capture raises."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(graph):
            outputs = fn()
        return graph, outputs


GRAPHS = _CudaGraphs()


class _Program:
    """One program captured as a CUDA graph: a frame, a composable chunk
    or a training step (parallel.train.make_train_step).

    With `warm` fn() first runs once eagerly on a side stream (a frame's
    warm-up, as torch.cuda.graph requires); a caller whose eager run is
    itself a step of its work (a training step, an update each call)
    runs it and passes warm=False. Then fn() is captured. `inputs` are
    the static buffers fn reads, which the caller fills before each
    replay; `outputs` are fn's results in the graph's pool, which the
    next replay overwrites; `keep` holds every object whose tensors the
    graph reads, so no address is freed and reused under it. The kernel
    wrappers count their launches in Python, which a replay never runs:
    the counts the capture added are taken back and added again on
    every replay."""

    def __init__(self, fn, inputs, keep, device, warm=True):
        global CAPTURES
        counters = _launch_counters()
        self.inputs, self.keep = inputs, keep
        if warm:
            GRAPHS.warm(fn, device)
        before = [getattr(m, n) for m, n in counters]
        self.graph, self.outputs = GRAPHS.capture(fn, device)
        self.counts = []
        for (m, n), b in zip(counters, before):
            if getattr(m, n) != b:
                self.counts.append((m, n, getattr(m, n) - b))
                setattr(m, n, b)
        CAPTURES += 1

    def replay(self):
        self.graph.replay()
        for m, n, k in self.counts:
            setattr(m, n, getattr(m, n) + k)


def _forget(owner_id: int):
    _OWNERS.pop(owner_id, None)
    for key in [k for k in _PROGRAMS if k[0] == owner_id]:
        del _PROGRAMS[key]


def drop_programs():
    """Free every cached program, its graph and its memory pool. A graph
    that holds NCCL collectives keeps its communicator's resources, and a
    communicator destroyed under it waits for them: call this before
    torch.distributed.destroy_process_group (four-card runs hung there
    with sharded frame programs alive)."""
    _PROGRAMS.clear()


def _program(owner, key, build) -> _Program:
    """The program cached for (`owner`'s identity, key), built by build()
    on a miss. Scenes are keyed by identity, never by value (their tensor
    fields do not compare); an entry goes when its scene is freed, or as
    the least recently used past PROGRAM_CACHE_SIZE."""
    full = (id(owner),) + tuple(key)
    prog = _PROGRAMS.get(full)
    if prog is not None:
        _PROGRAMS.move_to_end(full)
        return prog
    prog = build()
    _PROGRAMS[full] = prog
    if id(owner) not in _OWNERS:
        _OWNERS[id(owner)] = weakref.finalize(owner, _forget, id(owner))
    while len(_PROGRAMS) > PROGRAM_CACHE_SIZE:
        _PROGRAMS.popitem(last=False)
    return prog


def _detached(owner):
    """A new PreparedScene, ShardedScene or SceneArrays over a new
    SceneArrays holding the same tensors: what a program keeps, so that
    it reads the live tensors by address without keeping the caller's
    objects (its cache key) alive."""
    if isinstance(owner, SceneArrays):
        return dataclasses.replace(owner)
    return dataclasses.replace(owner, soa=dataclasses.replace(owner.soa))


def _fused_frame(prepared: PreparedScene, bounces: int, fudge: float):
    """The fused frame: camera rays in block order, ray packing and K1 or
    K3 (ops.fused.fused_render_rays), un-permute."""
    from cutrace_tpu_torch.ops.fused import fused_render_rays

    soa = prepared.soa
    bo = block_order_tensors(soa.width, soa.height, soa.width * soa.height,
                             soa.device)
    o, d = camera_rays(soa, bo.px, bo.py)
    color, depth, normal = fused_render_rays(
        soa, prepared.accel, o, d, fudge, bounces, tables=prepared.tables)
    return to_image(soa, bo.inverse, color, depth, normal)


@torch.no_grad()
def _render_fused(prepared: PreparedScene, bounces: int, fudge: float,
                  program: bool = True):
    """The whole frame through the fused kernels: on a CUDA device one
    captured program per (scene, bounces, fudge), replayed (the
    counterpart of the JAX package's jitted `_render_fused`); op by op
    without `program` and on the CPU. The images are the frame's own
    tensors, never the graph's memory."""
    if not program or not GRAPHS.captures(prepared.soa.device):
        return _fused_frame(prepared, bounces, fudge)

    def build():
        scene = _detached(prepared)
        soa = scene.soa
        bo = block_order_tensors(soa.width, soa.height,
                                 soa.width * soa.height, soa.device)
        return _Program(lambda: _fused_frame(scene, bounces, fudge), None,
                        (scene, bo), soa.device)

    prog = _program(prepared, ("fused", bounces, fudge), build)
    prog.replay()
    return tuple(x.clone() for x in prog.outputs)


def _chunk(soa, xy, bounces: int, fudge, tri_candidates):
    """One composable chunk from pixel coordinates xy (2, R): camera rays
    and render_rays, packed as (R, 7) rows [color, depth, normal]."""
    o, d = camera_rays(soa, xy[0], xy[1])
    color, depth, normal = render_rays(soa, o, d, bounces, fudge,
                                       tri_candidates)
    return torch.cat([color, depth[:, None], normal], dim=1)


def _unpack(soa, inverse, rows):
    """(n_pad, 7) rows in block order -> to_image's images."""
    return to_image(soa, inverse, rows[:, 0:3], rows[:, 3], rows[:, 4:7])


def _chunk_rows(owner, parts, pxy, bounces: int, fudge: float, chunk: int,
                program: bool):
    """The (R, 7) rows [color, depth, normal] of the pixel coordinates
    pxy (2, R), R a multiple of `chunk`, rendered in chunks of `chunk`
    rays; `parts(owner)` gives the scene's SceneArrays and triangle query
    (None: brute force). Op by op without `program`; else one chunk is a
    captured program per (owner, parts, bounces, fudge, chunk): each
    chunk's coordinates are copied into its static input, it is replayed,
    and its rows are copied out (the counterpart of the JAX package's
    `lax.map` over the chunks). Callers whose chunks make collectives
    (a prim-sharded rank) replay the same count in lockstep."""
    n_pad = pxy.shape[1]
    if not program:
        soa, tc = parts(owner)
        return torch.cat([_chunk(soa, pxy[:, s:s + chunk], bounces, fudge, tc)
                          for s in range(0, n_pad, chunk)])

    def build():
        kept = _detached(owner)
        k_soa, k_tc = parts(kept)
        xy = pxy[:, :chunk].clone()
        return _Program(lambda: _chunk(k_soa, xy, bounces, fudge, k_tc), xy,
                        (kept, k_tc), pxy.device)

    prog = _program(owner, ("chunks", parts, bounces, fudge, chunk), build)
    rows = torch.empty((n_pad, 7), dtype=torch.float32, device=pxy.device)
    for s in range(0, n_pad, chunk):
        prog.inputs.copy_(pxy[:, s:s + chunk])
        prog.replay()
        rows[s:s + chunk].copy_(prog.outputs)
    return rows


def _scene_parts(scene):
    """(SceneArrays, triangle query) of render's composable chunks: a
    PreparedScene's partition query, or brute force for a SceneArrays."""
    if isinstance(scene, PreparedScene):
        return scene.soa, bvh.candidates_fn(scene.accel, scene.tables)
    return scene, None


@torch.no_grad()
def _render_padded(owner, bounces: int, fudge: float, chunk: int,
                   program: bool = True):
    """The composable frame in chunks of `chunk` rays over the block order
    padded to a multiple of it (_chunk_rows). `owner` is a SceneArrays
    (brute force) or a PreparedScene (its partition's triangle query).
    On a CUDA device one chunk is a captured program, replayed over the
    chunks (the counterpart of the JAX package's `_render_padded`); op by
    op without `program` and on the CPU."""
    soa = owner.soa if isinstance(owner, PreparedScene) else owner
    n_pad = _ceil_to(soa.width * soa.height, chunk)
    bo = block_order_tensors(soa.width, soa.height, n_pad, soa.device)
    rows = _chunk_rows(owner, _scene_parts, bo.pxy, bounces, fudge, chunk,
                       program and GRAPHS.captures(soa.device))
    return _unpack(soa, bo.inverse, rows)


def _render(scene_or_soa, bounces, fudge, chunk, device, program):
    """render's dispatch, as the programs (`program`) or op by op: the
    fused frame for a "fused" partition in the kernels' scope, else the
    composable frame, keyed on the PreparedScene when it has a partition
    and on its SceneArrays when not."""
    from cutrace_tpu_torch.ops import fused

    owner = scene_or_soa
    if isinstance(owner, PreparedScene):
        if fused.fused_supported(owner.soa, owner.accel, bounces):
            return _render_fused(owner, bounces, float(fudge), program)
        if owner.accel is None:
            owner = owner.soa
    elif not isinstance(owner, SceneArrays):
        owner = scene_to_soa(owner, device=resolve_device(device))
    soa = owner.soa if isinstance(owner, PreparedScene) else owner
    accel = owner.accel if isinstance(owner, PreparedScene) else None

    n = soa.width * soa.height
    if chunk is None:
        # the culling cast materializes no (rays x triangles) products, so
        # its chunks need not shrink with the light fan-out
        culls = accel is not None and accel.kind != "clusters"
        chunk = default_chunk(soa, bounces, lights=not culls)
    chunk = max(8, min(chunk, _ceil_to(n, 8)))
    return _render_padded(owner, bounces, float(fudge), chunk, program)


@torch.no_grad()
def render(scene_or_soa, bounces: int = 5, fudge: float = 1e-3,
           chunk: Optional[int] = None, device="cuda"):
    """Render the full image: (color (H,W,3), depth (H,W), normal (H,W,3))
    float32 tensors on the scene's device.

    Accepts a Scene (placed on `device`: the card unless the caller
    passes "cpu"; without a card the call raises), a SceneArrays (brute-force
    composable path) or a PreparedScene from prepare(). A "fused"
    partition runs ops.fused.fused_render_rays while the bounce tree is in
    the kernels' scope (`_render_fused`); past it, and for "clusters" and
    "pallas" partitions, the composable path runs with the partition's
    triangle query (ops.bvh.candidates_fn) in batches of `chunk` rays
    (`_render_padded`). On a CUDA device each runs as a captured program,
    built at a scene's first render and replayed after; a failure to
    capture or replay raises. On the CPU both run op by op
    (`render_eager`)."""
    return _render(scene_or_soa, bounces, fudge, chunk, device, True)


@torch.no_grad()
def render_eager(scene_or_soa, bounces: int = 5, fudge: float = 1e-3,
                 chunk: Optional[int] = None, device="cuda"):
    """The plain version of render's programs: the same frame with the
    same kernels, dispatched op by op from Python on any device. It is
    render on the CPU; on the card it is what the programs are held
    against."""
    return _render(scene_or_soa, bounces, fudge, chunk, device, False)
