"""Image-tile data parallelism and triangle sharding over torch.distributed
(counterpart of cutrace_tpu.parallel.sharding).

One process per device. A `Mesh` lays the ranks out row-major as a
(n_tiles, n_prims) grid, as `devices.reshape(n_tiles, n_prims)` does in the
JAX package:

  "tiles"  pixels split into one contiguous run per tile, the scene
           replicated. The forward's one collective is the image's:
           each rank renders its run (through the fused kernels when its
           partition is "fused") and the pieces are gathered once to
           assemble the image. Training sums the gradients over the
           tiles group in rank order (all_reduce_sum, parallel.train).
  "prims"  the triangle buffer split into equal shards, padded with
           never-hit sentinels. Each rank casts its own shard, through its
           own partition (the culling cast, K4 on the card) when it has
           one; the per-ray winners are all-gathered over the prims group
           and reduced by the (t, global order) minimum, which keeps the
           reference's scene-order tie-break across shards.

On a CUDA device over NCCL a frame runs as captured CUDA graphs, its
collectives inside them (render_sharded, mesh_captures), as a training
step does (parallel.train). Collectives on CUDA tensors over a gloo group
go through the host: copied to the CPU, exchanged, copied back (gloo's
own CUDA path stages through host memory the same way; NCCL takes device
tensors directly). That is a synchronization no capture holds, so gloo
runs op by op.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import torch
import torch.distributed as dist

from cutrace_tpu_torch.ops import bvh
from cutrace_tpu_torch.ops import intersect as I
from cutrace_tpu_torch.render import renderer
from cutrace_tpu_torch.scene.soa import SceneArrays, resolve_device, soa_to
from cutrace_tpu_torch.utils import tracing

TILE_AXIS = "tiles"
PRIM_AXIS = "prims"

# Triangle-buffer fields sharded along PRIM_AXIS; the rest of the scene is
# replicated (planes, spheres, materials and lights are small).
_TRI_FIELDS = ("tri_p1", "tri_p2", "tri_p3", "tri_mat", "tri_obj",
               "tri_mesh", "tri_valid")
# Rows of a padding triangle: far away, invalid, an object index past any
# scene's, so it never wins and its order key never ties a live one.
_PAD_ROWS = {
    "tri_p1": (1.0e8, 1.0e8, 1.0e8),
    "tri_p2": (1.0e8, 64.0, 0.0),
    "tri_p3": (1.0e8, 0.0, 64.0),
    "tri_mat": 0,
    "tri_obj": 2**30,
    "tri_mesh": -1,
    "tri_valid": False,
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (n_tiles, n_prims) grid of ranks, and its
    process groups: `tiles_group` along the tiles axis (the ranks that
    hold its triangle shard, one per tile), `prims_group` along the prims
    axis (the ranks that render its pixels, one per shard), `group` every
    rank of the grid. The groups are None in a process without
    torch.distributed, whose only mesh is (1, 1)."""

    n_tiles: int
    n_prims: int
    tile: int
    prim: int
    device: torch.device
    group: Optional[object] = None
    tiles_group: Optional[object] = None
    prims_group: Optional[object] = None

    @property
    def shape(self):
        return {TILE_AXIS: self.n_tiles, PRIM_AXIS: self.n_prims}


def rank_device(device=None) -> torch.device:
    """The device of this rank: `device`, else the card of its local rank
    (`cuda:{LOCAL_RANK}`, as torchrun sets it; cuda:0 without one).
    Without a card the call raises; the caller passes "cpu" for the CPU."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return resolve_device(device)


def make_mesh(n_tiles: int, n_prims: int = 1, group=None,
              device=None) -> Optional[Mesh]:
    """The (tiles, prims) mesh over the ranks of `group` (default: every
    rank), laid out row-major by rank: rank r of the group sits at tile
    r // n_prims, prim r % n_prims.

    Like torch.distributed.new_group, every rank of the default group must
    call it, with the same arguments and in the same order as its other
    group creations; a rank outside `group` gets None. Without
    torch.distributed initialized only the (1, 1) mesh exists. `device` is
    rank_device's."""
    dev = rank_device(device)
    if not dist.is_initialized():
        if n_tiles * n_prims != 1:
            raise ValueError(
                f"a ({n_tiles}, {n_prims}) mesh needs torch.distributed "
                f"initialized (parallel.multihost.initialize)")
        return Mesh(1, 1, 0, 0, dev)
    ranks = (list(range(dist.get_world_size())) if group is None
             else sorted(dist.get_process_group_ranks(group)))
    if len(ranks) != n_tiles * n_prims:
        raise ValueError(f"a ({n_tiles}, {n_prims}) mesh over {len(ranks)} "
                         f"ranks")
    grid = [ranks[t * n_prims:(t + 1) * n_prims] for t in range(n_tiles)]
    rows = [dist.new_group(row) for row in grid]
    cols = [dist.new_group([row[p] for row in grid]) for p in range(n_prims)]
    me = dist.get_rank()
    if me not in ranks:
        return None
    pos = ranks.index(me)
    tile, prim = divmod(pos, n_prims)
    return Mesh(n_tiles, n_prims, tile, prim, dev,
                group=dist.group.WORLD if group is None else group,
                tiles_group=cols[prim], prims_group=rows[tile])


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


# --- collectives -------------------------------------------------------------


def _staged(x, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _all_gather(x, group):
    """(K, *x.shape): x of every rank of `group`, in group-rank order,
    gathered into one buffer by all_gather_into_tensor, which a CUDA
    graph holds on an NCCL group."""
    dev = x.device
    x = x.detach().contiguous()
    if _staged(x, group):
        x = x.cpu()
    k = dist.get_world_size(group)
    out = x.new_empty((k * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.view((k,) + tuple(x.shape)).to(dev)


def all_reduce_sum(x, group):
    """The sum of x over the ranks of `group`, on every rank (x itself
    without a group), added in group-rank order: every rank's x gathered
    (_all_gather), then ((x0 + x1) + x2) + ... elementwise, so the float
    sum has the same bits on every rank and in every run, whatever order
    NCCL's or gloo's own reduction would choose (its algorithm, protocol
    and channels follow the environment and the message size). Not
    .sum(0): a reduction kernel picks its own order. The JAX mesh's
    contract: collectives in a fixed reduction order
    (cutrace_tpu.parallel.sharding)."""
    if group is None:
        return x
    rows = _all_gather(x, group)
    acc = rows[0]
    for row in rows[1:]:
        acc = acc + row
    return acc


def barrier(mesh: Mesh):
    """Wait for every rank of the mesh."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def gather_image(local, mesh: Mesh):
    """Every tile rank's piece of a per-pixel buffer ((R, ...), the same R
    on every rank), concatenated in tile order on every rank: the one
    collective of the tiles axis's forward."""
    if mesh.tiles_group is None:
        return local
    return _all_gather(local, mesh.tiles_group).flatten(0, 1)


class _GatherShards(torch.autograd.Function):
    """All-gather over the prims group, whose every rank goes on to compute
    the same function of the stack. The backward hands this rank the
    cotangent of its own slice, once: an all-gather whose backward summed
    the group's cotangents would count every shard's gradient n_prims
    times."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.index = index
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None, None


# --- scenes and partitions ---------------------------------------------------


def _pad_rows(x, multiple: int, fill):
    """x with rows of `fill` appended to a multiple of `multiple` rows."""
    pad = _ceil_to(x.shape[0], multiple) - x.shape[0]
    if pad == 0:
        return x
    fill = torch.tensor(fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill.expand((pad,) + tuple(x.shape[1:]))])


def pad_triangles(soa: SceneArrays, multiple: int) -> SceneArrays:
    """Pad the triangle buffer with never-hit sentinels to a multiple of
    `multiple` rows, so it splits evenly into shards."""
    if soa.tri_p1.shape[0] % multiple == 0:
        return soa
    return dataclasses.replace(soa, **{
        f: _pad_rows(getattr(soa, f), multiple, _PAD_ROWS[f])
        for f in _TRI_FIELDS})


def shard_rows(x, mesh: Mesh):
    """This rank's shard of a (T_padded, ...) triangle-row tensor."""
    t_local = x.shape[0] // mesh.n_prims
    return x[mesh.prim * t_local:(mesh.prim + 1) * t_local]


def shard_padded(x, mesh: Mesh, fill):
    """This rank's shard of the triangle-row tensor x padded with rows of
    `fill` (pad_triangles' sentinel rows, or zeros)."""
    return shard_rows(_pad_rows(x, mesh.n_prims, fill), mesh)


def unshard_rows(x, mesh: Mesh, n_rows: int):
    """The whole (n_rows, ...) tensor from every prim rank's shard (the
    padding dropped), on every rank."""
    if mesh.n_prims > 1:
        x = _all_gather(x, mesh.prims_group).flatten(0, 1)
    return x[:n_rows]


def shard_scene(soa: SceneArrays, mesh: Mesh) -> SceneArrays:
    """The scene as this rank holds it, on the mesh's device: its shard of
    the padded triangle buffer (the whole buffer without prim sharding),
    everything else whole."""
    if soa.device != mesh.device:
        soa = soa_to(soa, mesh.device)
    if mesh.n_prims == 1:
        return soa
    return dataclasses.replace(soa, **{
        f: shard_padded(getattr(soa, f), mesh, _PAD_ROWS[f])
        for f in _TRI_FIELDS})


def build_sharded_accel(soa: SceneArrays, mesh: Mesh, kind: str = "pallas",
                        cluster_size: Optional[int] = None) -> bvh.Accel:
    """Per-shard cluster partitions stacked to (n_prims, M, C) leaves on
    the mesh's device, M common to every shard (min_clusters pads the
    short ones); each shard's `order` indexes its own triangle buffer.
    Without prim sharding, the scene's partition (M, C)."""
    if cluster_size is None:
        cluster_size = bvh.CLUSTER_SIZE
    if soa.device != mesh.device:
        soa = soa_to(soa, mesh.device)
    if mesh.n_prims == 1:
        return bvh.build_accel(soa, cluster_size, kind=kind)
    padded = pad_triangles(soa, mesh.n_prims)
    t_local = padded.tri_p1.shape[0] // mesh.n_prims
    host = [getattr(padded, f).detach().cpu().numpy()
            for f in ("tri_p1", "tri_p2", "tri_p3", "tri_valid")]
    views = [tuple(h[k * t_local:(k + 1) * t_local] for h in host)
             for k in range(mesh.n_prims)]
    parts = [bvh.build_accel(soa, cluster_size, host_tris=v, kind=kind)
             for v in views]
    m = max(a.order.shape[0] for a in parts)
    parts = [a if a.order.shape[0] == m
             else bvh.build_accel(soa, cluster_size, host_tris=v, kind=kind,
                                  min_clusters=m)
             for a, v in zip(parts, views)]
    return bvh.Accel(order=torch.stack([a.order for a in parts]),
                     valid=torch.stack([a.valid for a in parts]), kind=kind)


def shard_accel(soa: SceneArrays, mesh: Mesh, kind: str = "pallas",
                cluster_size: Optional[int] = None) -> bvh.Accel:
    """This rank's partition of its own triangle shard (local orders):
    its shard of build_sharded_accel, built alone. The common M, the
    largest of the prims group, comes from one all-gather of the counts."""
    if cluster_size is None:
        cluster_size = bvh.CLUSTER_SIZE
    own = shard_scene(soa, mesh)
    if mesh.n_prims == 1:
        return bvh.build_accel(own, cluster_size, kind=kind)
    host = tuple(getattr(own, f).detach().cpu().numpy()
                 for f in ("tri_p1", "tri_p2", "tri_p3", "tri_valid"))
    accel = bvh.build_accel(own, cluster_size, host_tris=host, kind=kind)
    counts = _all_gather(torch.tensor([accel.order.shape[0]],
                                      device=mesh.device), mesh.prims_group)
    m = int(counts.max())
    if accel.order.shape[0] < m:
        accel = bvh.build_accel(own, cluster_size, host_tris=host, kind=kind,
                                min_clusters=m)
    return accel


# --- the sharded triangle query ----------------------------------------------


def _gather_candidates(cand: I.TriCandidate, mesh: Mesh) -> I.TriCandidate:
    """The (K, R, ...) stack of every prim rank's candidates. Vertices
    keep their gradient path to their own shard; t is re-derived after the
    combine (_rederive_t)."""
    floats = torch.cat([cand.t.detach()[:, None], cand.p1, cand.p2, cand.p3],
                       dim=1)
    floats = _GatherShards.apply(floats, mesh.prims_group, mesh.prim)
    ints = torch.stack([cand.obj, cand.order, cand.mat,
                        cand.is_mesh.to(torch.int64)], dim=1)
    ints = _all_gather(ints, mesh.prims_group)
    return I.TriCandidate(
        t=floats[..., 0], obj=ints[..., 0], order=ints[..., 1],
        mat=ints[..., 2], is_mesh=ints[..., 3] != 0, p1=floats[..., 1:4],
        p2=floats[..., 4:7], p3=floats[..., 7:10])


def _rederive_t(best: I.TriCandidate, o, d, o0) -> I.TriCandidate:
    """Under autograd, the winner's t as a function of its vertices (from
    the gathered stack, so their gradient reaches the owning shard) and of
    this rank's rays, with its value unchanged: every rank of a tile row
    then differentiates the same function of the rays, and replicated
    parameters get whole gradients on each."""
    if not torch.is_grad_enabled():
        return best
    p1, p2, p3 = best.p1 - o0, best.p2 - o0, best.p3 - o0
    n = torch.linalg.cross(p2 - p1, p2 - p3)
    alpha = (d * n).sum(-1)
    t = ((p2 - (o - o0)) * n).sum(-1) / torch.where(alpha == 0.0, 1.0,
                                                     alpha)
    live = torch.isfinite(best.t) & torch.isfinite(t)
    return dataclasses.replace(
        best, t=torch.where(live, best.t + (t - t.detach()), best.t))


def sharded_tri_candidates(mesh: Mesh, t_local: int, accel_local=None,
                           tables=None):
    """A ray_cast triangle query over a PRIM_AXIS-sharded buffer of
    `t_local` triangles a shard: the local best (brute force, or this
    rank's partition `accel_local` through bvh.candidates_fn, with its
    `tables`), keyed by global order; the prim ranks' winners
    all-gathered; their (t, global order) minimum."""
    base = mesh.prim * t_local
    local = (functools.partial(I.local_tri_candidates, order_base=base)
             if accel_local is None
             else bvh.candidates_fn(accel_local, tables, order_base=base))

    def tri_c(soa_local, o, d, min_dist, o0):
        stacked = _gather_candidates(local(soa_local, o, d, min_dist, o0),
                                     mesh)
        return _rederive_t(I.combine_tri_candidates(stacked), o, d, o0)

    return tri_c


# --- rendering ---------------------------------------------------------------


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def mesh_captures(mesh: Mesh) -> bool:
    """Do render_sharded and parallel.train.make_train_step run over
    `mesh` as captured programs? On a CUDA device (renderer.GRAPHS) whose
    every process group of the mesh is NCCL's: NCCL's collectives take
    device tensors on the stream, so a CUDA graph holds them (the
    communicators are made by the eager run before each capture). Not on
    the CPU, and not over gloo, whose collectives of CUDA tensors go
    through the host (_staged), a synchronization that no capture
    holds."""
    if not renderer.GRAPHS.captures(mesh.device):
        return False
    return all(_nccl(g) for g in (mesh.group, mesh.tiles_group,
                                  mesh.prims_group) if g is not None)


def _rank_query(soa: SceneArrays, mesh: Mesh, accel, tables):
    """The rank's ray_cast triangle query: with PRIM_AXIS > 1 the sharded
    query over its shard (sharded_tri_candidates), else its partition's
    (bvh.candidates_fn; brute force without one)."""
    if mesh.n_prims > 1:
        return sharded_tri_candidates(mesh, soa.tri_p1.shape[0], accel,
                                      tables)
    return bvh.candidates_fn(accel, tables)


def render_pixels_sharded(soa: SceneArrays, mesh: Mesh, idx, bounces: int,
                          fudge, accel=None, tables=None):
    """Render this rank's flat pixel indices `idx` ((R,) on the mesh's
    device) of the scene as the rank holds it (shard_scene), in one
    batch: (color (R,3), depth (R,), normal (R,3)). The training loss's
    forward (parallel.train.sharded_loss).

    On a tiles-only mesh a "fused" partition inside the kernels' scope
    runs ops.fused.fused_render_rays on the rank's rays (K1 or K3 on the
    card), with no collective; otherwise the composable pipeline with the
    rank's triangle query (_rank_query: with PRIM_AXIS > 1 its partition
    `accel`, local orders, and `tables` its culling-cast tables)."""
    from cutrace_tpu_torch.ops import fused

    o, d = renderer.camera_rays(soa, idx % soa.width, idx // soa.width)
    tracing.mark("rays")
    if mesh.n_prims == 1 and fused.fused_supported(soa, accel, bounces):
        return fused.fused_render_rays(soa, accel, o, d, fudge, bounces,
                                       tables=tables)
    out = renderer.render_rays(soa, o, d, bounces, fudge,
                               _rank_query(soa, mesh, accel, tables))
    tracing.mark("forward")
    return out


@dataclasses.dataclass(frozen=True)
class ShardedScene:
    """A scene as one rank of `mesh` holds it (prepare_sharded): its
    triangle shard, that shard's partition (local orders) and the culling
    cast's tables, built once for every frame. render_sharded's programs
    are cached on its identity."""

    soa: SceneArrays
    mesh: Mesh
    accel: Optional[bvh.Accel] = None
    tables: Optional[object] = None


def prepare_sharded(scene, mesh: Mesh) -> ShardedScene:
    """A SceneArrays or a render.renderer.PreparedScene made ready for
    `mesh` on its device: the rank's shard (shard_scene); with PRIM_AXIS
    > 1 and a partition, the partition rebuilt over the rank's shard
    (shard_accel) and its culling-cast tables. Every rank of the prims
    group calls it together (shard_accel's all-gather)."""
    with tracing.setup_span("prepare_sharded"):
        accel = tables = None
        if isinstance(scene, renderer.PreparedScene):
            accel, tables, scene = scene.accel, scene.tables, scene.soa
        if scene.device != mesh.device:
            scene, tables = soa_to(scene, mesh.device), None
        soa = shard_scene(scene, mesh)
        if mesh.n_prims > 1 and accel is not None:
            from cutrace_tpu_torch.ops.pallas_cast import cluster_tables

            accel = shard_accel(scene, mesh, accel.kind)
            tables = (None if accel.kind == "clusters"
                      else cluster_tables(soa, accel))
        return ShardedScene(soa, mesh, accel, tables)


def _rank_parts(scene: ShardedScene):
    """(SceneArrays, triangle query) of a rank's composable chunks."""
    return scene.soa, _rank_query(scene.soa, scene.mesh, scene.accel,
                                  scene.tables)


def tile_run(soa: SceneArrays, mesh: Mesh) -> int:
    """Pixels of each tile rank's contiguous run: the image padded to a
    multiple of n_tiles, split evenly."""
    return _ceil_to(soa.width * soa.height, mesh.n_tiles) // mesh.n_tiles


def tile_rays(scene: ShardedScene, bo, run: int):
    """Camera rays (o, d) of this rank's run of `run` pixels of the block
    order `bo` (renderer.block_order_tensors)."""
    xy = bo.pxy[:, scene.mesh.tile * run:(scene.mesh.tile + 1) * run]
    return renderer.camera_rays(scene.soa, xy[0], xy[1])


def _fused_rank_frame(scene: ShardedScene, bo, run: int, bounces: int,
                      fudge: float):
    """The rank's frame through the fused kernels: camera rays of its run
    of `run` pixels of the block order `bo`, K1 or K3
    (ops.fused.fused_render_rays), the (R, 7) rows gathered over the
    tiles group (the frame's one collective) and put back in scanline
    order; marks end the phases rays, pack and forward (ops.fused),
    gather, unpermute."""
    from cutrace_tpu_torch.ops.fused import fused_render_rays

    soa, mesh = scene.soa, scene.mesh
    o, d = tile_rays(scene, bo, run)
    tracing.mark("rays")
    color, depth, normal = fused_render_rays(
        soa, scene.accel, o, d, fudge, bounces, tables=scene.tables)
    rows = torch.cat([color, depth[:, None], normal], dim=1)
    rows = gather_image(rows, mesh)
    tracing.mark("gather")
    images = renderer._unpack(soa, bo.inverse, rows)
    tracing.mark("unpermute")
    return images


def _render_sharded(scene, mesh: Mesh, bounces: int, fudge: float,
                    program: bool):
    """render_sharded's frame, as programs where `program` and
    mesh_captures(mesh), else op by op."""
    from cutrace_tpu_torch.ops import fused

    if not isinstance(scene, ShardedScene):
        scene = prepare_sharded(scene, mesh)
    elif scene.mesh != mesh:
        raise ValueError("a ShardedScene renders on the mesh it was "
                         "prepared for")
    program = program and mesh_captures(mesh)
    soa, accel = scene.soa, scene.accel
    run = tile_run(soa, mesh)
    if mesh.n_prims == 1 and fused.fused_supported(soa, accel, bounces):
        bo = renderer.block_order_tensors(soa.width, soa.height,
                                          run * mesh.n_tiles, mesh.device)
        if not program:
            return _fused_rank_frame(scene, bo, run, bounces, fudge)

        def build():
            kept = renderer._detached(scene)
            return renderer._Program(
                "sharded_frame",
                lambda: _fused_rank_frame(kept, bo, run, bounces, fudge),
                None, (kept, bo), mesh.device)

        prog = renderer._program(scene, ("sharded", bounces, fudge), build)
        prog.replay()
        return tuple(x.clone() for x in prog.outputs)
    # the composable frame: the rank's run padded to whole chunks, the
    # same count on every rank, so the prim ranks of a row, whose chunks
    # gather over the prims group, replay them in lockstep
    culls = accel is not None and accel.kind != "clusters"
    chunk = renderer.default_chunk(soa, bounces, lights=not culls)
    chunk = max(8, min(chunk, _ceil_to(run, 8)))
    run = _ceil_to(run, chunk)
    bo = renderer.block_order_tensors(soa.width, soa.height,
                                      run * mesh.n_tiles, mesh.device)
    rows = renderer._chunk_rows(
        scene, _rank_parts, bo.pxy[:, mesh.tile * run:(mesh.tile + 1) * run],
        bounces, fudge, chunk, program)
    return renderer._unpack(soa, bo.inverse, gather_image(rows, mesh))


@torch.no_grad()
def render_sharded(scene, mesh: Mesh, bounces: int = 5, fudge: float = 1e-3):
    """Full-image render over a mesh, the multi-device render.renderer.render:
    (color (H,W,3), depth (H,W), normal (H,W,3)) on every rank, on the
    mesh's device.

    Accepts a SceneArrays, a render.renderer.PreparedScene (prepared for
    the mesh on every call) or a ShardedScene of this mesh
    (prepare_sharded, once for every frame). Pixels go in 32x16-block
    order (renderer.block_order_tensors, on the device once), padded to a
    multiple of n_tiles, one contiguous run per tile rank; with PRIM_AXIS
    > 1 each rank culls only its own shard. The pieces are gathered over
    the tiles group (gather_image) and put back in scanline order.

    Where mesh_captures (a CUDA device, NCCL groups) the frame runs as
    captured programs, cached on the ShardedScene's identity (a
    PreparedScene or SceneArrays is prepared, and so captured, anew on
    every call): a "fused" partition on a tiles-only mesh inside the
    kernels' scope as one program (camera rays, K1 or K3, the image
    gather inside the graph, the un-permute), the counterpart of the JAX
    package's jitted `_render_sharded_jit`; otherwise one composable
    chunk (with PRIM_AXIS > 1 its casts' K4 on the shard, the candidates'
    all-gathers over the prims group and their combine) replayed over
    the rank's run (renderer._chunk_rows), then the gather. A failure to
    capture or replay raises. Free the programs (renderer.drop_programs)
    before torch.distributed.destroy_process_group. On the CPU and over
    gloo the same frame runs op by op (render_sharded_eager). While
    tracing is on (utils.tracing) the call is the request span
    `render_sharded`."""
    with tracing.request("render_sharded"):
        return _render_sharded(scene, mesh, bounces, float(fudge), True)


@torch.no_grad()
def render_sharded_eager(scene, mesh: Mesh, bounces: int = 5,
                         fudge: float = 1e-3):
    """The plain version of render_sharded's programs: the same frame,
    with the same kernels, chunks and collectives, dispatched op by op
    from Python on any mesh. It is render_sharded on the CPU and over
    gloo; on the card it is what the programs are held against."""
    return _render_sharded(scene, mesh, bounces, float(fudge), False)
