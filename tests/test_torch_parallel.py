"""Port parity: cutrace_tpu_torch.parallel (sharding, multihost and the mesh
path of train) over torch.distributed, against the port's one-device path
and the JAX package's mesh path.

A module fixture starts two process groups over gloo on the CPU, one of
four ranks and one of two, each rank running this file's worker:

    python tests/test_torch_parallel.py <world> <rank> <port> <out_dir>

The ranks write .npz files of results that the tests compare: the port's
sharded renders bit-identical to its one-device render (the ranks compute
each ray alone, and the shard combine is an exact (t, order) minimum), and
within the port-vs-JAX gate of JAX's render_sharded on the same mesh (JAX's
8 virtual CPU devices, tests/conftest.py); sharded gradients allclose to
the one-device ones; the multi-process image bit-identical to one
process's."""

import contextlib
import dataclasses
import inspect
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
# (tiles, prims) meshes each world renders or differentiates
RENDER_MESHES = ((4, 1), (2, 2), (1, 4))
GRAD_MESHES = {4: ((2, 2),), 2: ((2, 1), (1, 2))}
GRAD_RTOL = 1e-5
# (tiles, prims) meshes whose frames each world runs as programs, and the
# mesh of its prim-sharded step program
PROGRAM_MESHES = {4: ((4, 1), (2, 2)), 2: ((2, 1), (1, 2))}
STEP_MESH = {4: (2, 2), 2: (1, 2)}
STEPS = 3
# the ordered gradient sum's test vector, and the meshes whose fits run
# twice from one start (FIT_STEPS steps each)
SUM_LEN = 64
FIT_TWICE_MESHES = ((4, 1), (2, 2))
FIT_STEPS = 3
RANK_TIMEOUT = 120


# --- the worker: one rank --------------------------------------------------


def _load(name, w, h, transparent=False):
    from cutrace_tpu_torch import load_scene
    from cutrace_tpu_torch.scene import soa as tsoa

    sc = load_scene(str(REPO / "scenes" / name))
    sc.camera.width, sc.camera.height = w, h
    if transparent:
        mesh = next(ob for ob in sc.objects if type(ob).__name__ == "Mesh")
        sc.materials[mesh.mat_idx].transparency = 0.5
    return tsoa.soa_from_numpy(*tsoa.numpy_leaves(sc), device="cpu")


class _Counting:
    """Wraps module attributes with call counters while active."""

    def __init__(self, module, names):
        self.module, self.names, self.calls = module, names, {}

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        self.sizes, self.groups = {}, {}
        for n, fn in self.saved.items():
            def wrap(*a, _n=n, _fn=fn, **k):
                self.calls[_n] = self.calls.get(_n, 0) + 1
                if a and torch.is_tensor(a[0]):
                    self.sizes.setdefault(_n, []).append(a[0].numel())
                try:  # the group, passed by keyword or by position
                    group = inspect.signature(_fn).bind(
                        *a, **k).arguments.get("group")
                except TypeError:
                    group = k.get("group")
                self.groups.setdefault(_n, []).append(group)
                return _fn(*a, **k)
            setattr(self.module, n, wrap)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


_COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_reduce",
                "broadcast", "reduce", "reduce_scatter",
                "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
                "gather", "scatter", "barrier", "send", "recv", "isend",
                "irecv", "all_gather_object", "broadcast_object_list")


@contextlib.contextmanager
def _programs():
    """The stand-in CUDA graphs (tests/torch_stand_in.py) as
    renderer.GRAPHS and every group taken for NCCL's
    (sharding.mesh_captures): the programs of the card, on gloo ranks on
    the CPU."""
    from cutrace_tpu_torch.parallel import sharding as sh
    from cutrace_tpu_torch.render import renderer
    from torch_stand_in import StandInGraphs

    saved = renderer.GRAPHS, sh._nccl
    renderer.GRAPHS, sh._nccl = StandInGraphs(), lambda group: True
    try:
        yield renderer.GRAPHS
    finally:
        renderer.GRAPHS, sh._nccl = saved


@contextlib.contextmanager
def _no_host_tensors():
    """torch.tensor, as_tensor and from_numpy raise: on a card each is a
    copy from the host, which no CUDA-graph capture holds (the CPU's
    stand-in for "capturable", as tests/test_torch_render.py's)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a tensor made from host data in a warm "
                             "program")

    names = ("tensor", "as_tensor", "from_numpy")
    saved = {n: getattr(torch, n) for n in names}
    for n in names:
        setattr(torch, n, refuse)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch, n, fn)


def _images(out, prefix, imgs):
    for name, x in zip(("color", "depth", "normal"), imgs):
        out[f"{prefix}/{name}"] = x.numpy()


def _grads(out, prefix, soa, mesh, target, accel):
    """The sharded gradient of the mesh (the whole triangle rows) and the
    one-device gradient of the same path: for PRIM_AXIS > 1 a "fused"
    partition takes the culling cast (the fused kernels cover no sharded
    buffer), held against the culling cast over the same scene."""
    from cutrace_tpu_torch.diff import grad as tgrad
    from cutrace_tpu_torch.parallel import sharding as sh
    from cutrace_tpu_torch.parallel import train

    local_acc = ref_acc = accel
    if mesh.n_prims > 1 and accel is not None:
        local_acc = sh.shard_accel(soa, mesh, accel.kind)
        ref_acc = dataclasses.replace(accel, kind="pallas")
    local = sh.shard_scene(soa, mesh)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tgrad.extract_params(local).items()}
    loss = train.sharded_loss(params, local, mesh, target, 1, 1e-3,
                              local_acc)
    loss.backward()
    out[f"{prefix}/loss"] = train._all_reduce_grads(params, loss,
                                                    mesh).numpy()
    n_tris = soa.tri_p1.shape[0]
    for k, v in params.items():
        g = v.grad
        if k in sh._TRI_FIELDS:
            g = sh.unshard_rows(g, mesh, n_tris)
        out[f"{prefix}/grad/{k}"] = g.numpy()
    ref_loss, ref = tgrad.grad_render_loss(soa, target, 1, 1e-3, ref_acc)
    out[f"{prefix}/ref_loss"] = ref_loss.numpy()
    for k, g in ref.items():
        out[f"{prefix}/ref/{k}"] = g.numpy()


def _grad_cases(out, world, rank):
    from cutrace_tpu_torch.diff import grad as tgrad
    from cutrace_tpu_torch.parallel import sharding as sh
    from cutrace_tpu_torch.render.renderer import prepare

    soa = _load("bunny.json", 16, 9)
    with torch.no_grad():
        c0, _, _ = tgrad.render_image_flat(soa, 1, 1e-3)
    target = 0.9 * c0
    fused = prepare(soa, accel="fused").accel
    for t, p in GRAD_MESHES[world]:
        mesh = sh.make_mesh(t, p, device="cpu")
        for label, accel in (("none", None), ("fused", fused)):
            _grads(out, f"grad/{t}x{p}/{label}", soa, mesh, target, accel)


def _program_frames(out, world):
    """Each case of PROGRAM_MESHES[world] rendered through the programs
    (the stand-in graphs) and op by op: a tiles mesh's "fused" bunny
    (one program a frame) and "pallas" mirror (its chunk program), a
    prims mesh's "pallas" mirror and brute-force sphere_plane (the chunk
    program over the sharded query). The second program frame is
    counted (collectives, the candidates' gathers) and replayed with
    host tensors refused."""
    import torch.distributed as dist

    from cutrace_tpu_torch.parallel import sharding as sh
    from cutrace_tpu_torch.render import renderer
    from cutrace_tpu_torch.render.renderer import prepare

    bunny = prepare(_load("bunny.json", 32, 16), accel="fused")
    mirror = prepare(_load("mirror.json", 32, 16), accel="pallas")
    sp = _load("sphere_plane.json", 32, 16)
    for t, p in PROGRAM_MESHES[world]:
        mesh = sh.make_mesh(t, p, device="cpu")
        cases = (("bunny/fused", bunny) if p == 1
                 else ("sphere_plane/none", sp)), ("mirror/pallas", mirror)
        for label, scene in cases:
            prefix = f"program/{label}/{t}x{p}"
            ready = sh.prepare_sharded(scene, mesh)
            with _programs():
                captures = renderer.CAPTURES
                first = sh.render_sharded(ready, mesh, bounces=2)
                with _Counting(dist, _COLLECTIVES) as coll, \
                        _Counting(sh, ("_gather_candidates",)) as casts, \
                        _no_host_tensors():
                    second = sh.render_sharded(ready, mesh, bounces=2)
                out[f"{prefix}/captures"] = np.asarray(
                    renderer.CAPTURES - captures)
            _images(out, f"{prefix}/first", first)
            _images(out, prefix, second)
            _images(out, f"{prefix}/eager",
                    sh.render_sharded_eager(ready, mesh, bounces=2))
            out[f"{prefix}/collectives"] = np.asarray(
                [coll.calls.get(n, 0) for n in _COLLECTIVES])
            out[f"{prefix}/casts"] = np.asarray(
                casts.calls.get("_gather_candidates", 0))


def _prim_step(out, world):
    """STEPS Adam steps of all 19 groups on bunny 16x9 b1 over the "pallas"
    partition of each shard, at STEP_MESH[world]: through the step program
    (the stand-in graphs) and op by op, from one state. Each step's
    gradient sums (sharding.all_reduce_sum) and dist.all_reduce calls are
    counted; the third (a replay) runs with host tensors refused, and its
    gradients are held against one device's at the state it started
    from."""
    import torch.distributed as dist

    from cutrace_tpu_torch.diff import grad as tgrad
    from cutrace_tpu_torch.parallel import sharding as sh
    from cutrace_tpu_torch.parallel import train
    from cutrace_tpu_torch.render.renderer import prepare

    t, p = STEP_MESH[world]
    mesh = sh.make_mesh(t, p, device="cpu")
    soa = _load("bunny.json", 16, 9)
    with torch.no_grad():
        c0, _, _ = tgrad.render_image_flat(soa, 1, 1e-3)
    target = 0.9 * c0
    n_tris = soa.tri_p1.shape[0]
    accel = sh.shard_accel(soa, mesh, "pallas")
    local = sh.shard_scene(soa, mesh)
    prefix = f"step/{t}x{p}"

    def whole(params):
        return {k: sh.unshard_rows(v.detach(), mesh, n_tris)
                if k in sh._TRI_FIELDS else v.detach().clone()
                for k, v in params.items()}

    for label, program in (("program", True), ("eager", False)):
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in tgrad.extract_params(local).items()}
        opt = torch.optim.Adam(list(params.values()), lr=1e-2, eps=1e-8)
        with _programs() as graphs:
            step = train.make_train_step(opt, 1, accel=accel, mesh=mesh,
                                         program=program)
            losses, reduces = [], []
            for i in range(STEPS):
                if program and i == STEPS - 1:
                    start = whole(params)
                refuse = (_no_host_tensors() if i == STEPS - 1
                          else contextlib.nullcontext())
                with _Counting(sh, ("all_reduce_sum",)) as sums, \
                        _Counting(dist, ("all_reduce",)) as coll, refuse:
                    losses.append(step(params, local, target).clone())
                reduces.append([sums.calls.get("all_reduce_sum", 0)]
                               + sums.sizes.get("all_reduce_sum", [])
                               + [g is mesh.tiles_group for g in
                                  sums.groups.get("all_reduce_sum", [])]
                               + [coll.calls.get("all_reduce", 0)])
            out[f"{prefix}/{label}/log"] = np.asarray(graphs.log)
        out[f"{prefix}/{label}/losses"] = torch.stack(losses).numpy()
        out[f"{prefix}/{label}/reduces"] = np.asarray(reduces)
        for k, v in whole(params).items():
            out[f"{prefix}/{label}/param/{k}"] = v.numpy()
        grads = whole({k: v.grad for k, v in params.items()})
        for k, g in grads.items():
            out[f"{prefix}/{label}/grad/{k}"] = g.numpy()
    out[f"{prefix}/size"] = np.asarray(
        sum(v.numel() for v in params.values()) + 1)
    ref_acc = prepare(soa, accel="pallas").accel
    _, ref = tgrad.grad_render_loss(tgrad.with_params(soa, start), target, 1,
                                    1e-3, ref_acc)
    for k, g in ref.items():
        out[f"{prefix}/ref/{k}"] = g.numpy()


def _ordered_sum(out, rank):
    """sharding.all_reduce_sum over the tiles group of a (4, 1) mesh of
    SUM_LEN float32 values whose sum depends on the order of addition:
    each element's four values across the ranks are 1e8, 1, -1e8 and a
    seeded one in [0.25, 4), placed on the ranks by a seeded permutation
    (1e8 + 1 rounds back to 1e8)."""
    from cutrace_tpu_torch.parallel import sharding as sh

    rng = np.random.default_rng(11)
    vals = np.stack([np.full(SUM_LEN, 1e8), np.ones(SUM_LEN),
                     np.full(SUM_LEN, -1e8),
                     rng.uniform(0.25, 4.0, SUM_LEN)]).astype(np.float32)
    perm = np.stack([rng.permutation(4) for _ in range(SUM_LEN)], axis=1)
    x = np.take_along_axis(vals, perm, axis=0)[rank]
    mesh = sh.make_mesh(4, 1, device="cpu")
    out["sum/x"] = x
    out["sum/got"] = sh.all_reduce_sum(torch.from_numpy(x),
                                       mesh.tiles_group).numpy()


def _fits_twice(out, soa, target, kw):
    """FIT_STEPS steps of train.fit at each of FIT_TWICE_MESHES, twice
    from the same start, and once on one device: losses and the whole
    parameters."""
    from cutrace_tpu_torch.parallel import sharding as sh
    from cutrace_tpu_torch.parallel import train

    kw = dict(kw, steps=FIT_STEPS)
    fits = [("one", None, 0)] + [(f"{t}x{p}", (t, p), run)
                                 for t, p in FIT_TWICE_MESHES
                                 for run in (0, 1)]
    for label, shape, run in fits:
        mesh = None if shape is None else sh.make_mesh(*shape, device="cpu")
        params, losses = train.fit(soa, target, mesh=mesh, **kw)
        out[f"twice/{label}/{run}/losses"] = np.asarray(losses)
        for k, v in params.items():
            out[f"twice/{label}/{run}/param/{k}"] = v.numpy()


def _world4(rank, out, tmp):
    import torch.distributed as dist

    from cutrace_tpu_torch.diff import grad as tgrad
    from cutrace_tpu_torch.ops import fused as tfused
    from cutrace_tpu_torch.parallel import sharding as sh
    from cutrace_tpu_torch.parallel import train
    from cutrace_tpu_torch.render.renderer import prepare, render

    sp = _load("sphere_plane.json", 32, 16)
    _images(out, "sphere_plane/one", render(sp, bounces=2))
    for t, p in RENDER_MESHES:
        mesh = sh.make_mesh(t, p, device="cpu")
        _images(out, f"sphere_plane/{t}x{p}",
                sh.render_sharded(sp, mesh, bounces=2))
    # a mesh over a group that leaves ranks 1 and 3 out
    sub = dist.new_group([0, 2])
    mesh = sh.make_mesh(2, 1, group=sub, device="cpu")
    out["group/member"] = np.asarray(mesh is not None)
    if mesh is not None:
        out["group/tile"] = np.asarray(mesh.tile)
        _images(out, "sphere_plane/group2x1",
                sh.render_sharded(sp, mesh, bounces=2))

    # one live triangle split over four shards: three are padding
    tri = _load("triangle.json", 16, 16)
    _images(out, "triangle/one", render(tri, bounces=2))
    _images(out, "triangle/1x4", sh.render_sharded(
        tri, sh.make_mesh(1, 4, device="cpu"), bounces=2))

    mirror = _load("mirror.json", 32, 16)
    _images(out, "mirror/one", render(mirror, bounces=2))
    mesh22 = sh.make_mesh(2, 2, device="cpu")
    _images(out, "mirror/2x2", sh.render_sharded(mirror, mesh22, bounces=2))
    pallas = prepare(mirror, accel="pallas")
    for t, p in ((4, 1), (2, 2)):
        mesh = sh.make_mesh(t, p, device="cpu")
        _images(out, f"mirror/pallas/{t}x{p}",
                sh.render_sharded(pallas, mesh, bounces=2))
        # prepared once, rendered twice
        ready = sh.prepare_sharded(pallas, mesh)
        sh.render_sharded(ready, mesh, bounces=2)
        _images(out, f"mirror/pallas/{t}x{p}/prepared",
                sh.render_sharded(ready, mesh, bounces=2))
    mesh14 = sh.make_mesh(1, 4, device="cpu")
    for label, m in (("1x4", mesh14), ("2x2", mesh22)):
        own = sh.shard_accel(mirror, m, "pallas")
        stack = sh.build_sharded_accel(mirror, m, "pallas")
        out[f"accel/{label}/order"] = own.order.numpy()
        out[f"accel/{label}/valid"] = own.valid.numpy()
        out[f"accel/{label}/stack_order"] = stack.order[m.prim].numpy()
        out[f"accel/{label}/stack_valid"] = stack.valid[m.prim].numpy()
        out[f"accel/{label}/prim"] = np.asarray(m.prim)

    mesh41 = sh.make_mesh(4, 1, device="cpu")
    for label, soa in (("bunny", _load("bunny.json", 32, 16)),
                       ("transparent", _load("bunny.json", 16, 8, True))):
        prepared = prepare(soa, accel="fused")
        _images(out, f"{label}/one", render(prepared, bounces=2))
        with _Counting(tfused, ("fused_render_rays",)) as kern, \
                _Counting(dist, _COLLECTIVES) as coll:
            imgs = sh.render_sharded(prepared, mesh41, bounces=2)
        _images(out, f"{label}/4x1", imgs)
        out[f"{label}/kernel_calls"] = np.asarray(
            kern.calls.get("fused_render_rays", 0))
        out[f"{label}/collectives"] = np.asarray(
            [coll.calls.get(n, 0) for n in _COLLECTIVES])

    _grad_cases(out, 4, rank)
    _program_frames(out, 4)
    _prim_step(out, 4)
    _ordered_sum(out, rank)

    # fit: three steps at (2, 2) with a checkpoint, then a resumed fourth,
    # against four steps on one device
    bunny = _load("bunny.json", 16, 9)
    with torch.no_grad():
        c0, _, _ = tgrad.render_image_flat(bunny, 1, 1e-3)
    rng = np.random.default_rng(0)
    color = bunny.mat_color.numpy()
    start = np.clip(color + rng.normal(0.0, 0.1, color.shape), 0.0,
                    1.0).astype(np.float32)
    bunny = dataclasses.replace(bunny, mat_color=torch.from_numpy(start))
    kw = dict(lr=5e-2, bounces=1, param_filter=("mat_color", "tri_p1"),
              accel="none", device="cpu")
    ck = os.path.join(tmp, "fit_ck")
    params3, losses3 = train.fit(bunny, c0, steps=3, checkpoint_dir=ck,
                                 checkpoint_every=2, mesh=mesh22, **kw)
    params4, losses4 = train.fit(bunny, c0, steps=4, checkpoint_dir=ck,
                                 checkpoint_every=2, mesh=mesh22, **kw)
    ref4, ref_losses = train.fit(bunny, c0, steps=4, **kw)
    _fits_twice(out, bunny, c0, kw)
    out["fit/losses"] = np.asarray(losses3 + losses4)
    out["fit/start"] = start
    out["fit/target"] = c0.numpy()
    out["fit/ref_losses"] = np.asarray(ref_losses)
    for k in ("mat_color", "tri_p1"):
        out[f"fit/params3/{k}"] = params3[k].numpy()
        out[f"fit/params4/{k}"] = params4[k].numpy()
        out[f"fit/ref4/{k}"] = ref4[k].numpy()


def _world2(rank, out, tmp):
    from cutrace_tpu_torch.parallel import multihost
    from cutrace_tpu_torch.parallel import sharding as sh

    sp = _load("sphere_plane.json", 64, 36)
    mesh = multihost.global_mesh(device="cpu")
    out["multihost/shape"] = np.asarray([mesh.n_tiles, mesh.n_prims])
    _images(out, "multihost", multihost.render_multihost(sp, mesh, bounces=2))
    piece = torch.full((3, 2), float(rank))
    out["multihost/gathered"] = multihost.gather_image(piece, mesh).numpy()
    _grad_cases(out, 2, rank)
    _program_frames(out, 2)
    _prim_step(out, 2)


def worker(argv):
    world, rank, port, out_dir = (int(argv[0]), int(argv[1]), int(argv[2]),
                                  argv[3])
    sys.path.insert(0, str(REPO))
    torch.set_num_threads(1)
    from cutrace_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", world, rank, device="cpu")
    out = {}
    (_world4 if world == 4 else _world2)(rank, out, out_dir)
    np.savez(os.path.join(out_dir, f"w{world}_r{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


# --- the tests --------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# torchrun's entry point: two CPU ranks on a (1, 2) mesh of the mirror scene
# with a "pallas" partition per shard
TORCHRUN_ARGS = ("scenes/mirror.json", "--width", "32", "--height", "16",
                 "--bounces", "2", "--prims", "2", "--accel", "pallas",
                 "--device", "cpu", "--reps", "1", "--steps", "2")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]} of both process groups,
    and "torchrun": the entry point's standard output, all run side by
    side."""
    out = tmp_path_factory.mktemp("torch_parallel")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    procs = []
    for world in (4, 2):
        port = _free_port()
        procs += [(world, subprocess.Popen(
            [sys.executable, __file__, str(world), str(rank), str(port),
             str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)) for rank in range(world)]
    procs.append(("torchrun", subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "localhost", "--master_port",
         str(_free_port()), "-m", "cutrace_tpu_torch.parallel.multihost",
         *TORCHRUN_ARGS], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)))
    logs = []
    try:
        for _, p in procs:
            logs.append([x.decode(errors="replace") if x else ""
                         for x in p.communicate(timeout=RANK_TIMEOUT)])
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (world, p), log in zip(procs, logs):
        assert p.returncode == 0, (f"a rank of {world} failed:\n"
                                   f"{(log[0] + log[1])[-4000:]}")
    res = {world: [dict(np.load(out / f"w{world}_r{rank}.npz"))
                   for rank in range(world)] for world in (4, 2)}
    res["torchrun"] = logs[-1][0]
    return res


def _identical(a, b):
    return bool(((a == b) | (np.isinf(a) & np.isinf(b))).all())


def _assert_images_identical(res, got, want):
    for name in ("color", "depth", "normal"):
        a, b = res[f"{got}/{name}"], res[f"{want}/{name}"]
        assert _identical(a, b), f"{got} {name} differs from {want}"


def _jax_soa(scenes_dir, name, w, h):
    from cutrace_tpu.scene.loader import load_scene
    from cutrace_tpu.scene.soa import scene_to_soa

    sc = load_scene(scenes_dir / name)
    sc.camera.width, sc.camera.height = w, h
    return scene_to_soa(sc)


def _jax_mesh(t, p):
    import jax

    from cutrace_tpu.parallel import make_mesh

    return make_mesh(t, p, devices=jax.devices()[:t * p])


@pytest.mark.parametrize("tiles,prims", RENDER_MESHES)
def test_render_sharded_brute_force(runs, scenes_dir, tiles, prims):
    """sphere_plane 32x16 b2: every rank's image bit-identical to the
    port's render, and within the port-vs-JAX gate of JAX's render_sharded
    on the same mesh."""
    from cutrace_tpu.parallel import render_sharded
    from test_fused import _compare

    for res in runs[4]:
        _assert_images_identical(res, f"sphere_plane/{tiles}x{prims}",
                                 "sphere_plane/one")
    soa = _jax_soa(scenes_dir, "sphere_plane.json", 32, 16)
    want = render_sharded(soa, _jax_mesh(tiles, prims), bounces=2)
    got = [runs[4][0][f"sphere_plane/{tiles}x{prims}/{k}"]
           for k in ("color", "depth", "normal")]
    _compare([np.asarray(x) for x in want], got, atol=2e-4)


def test_render_sharded_padded_shards(runs):
    """triangle.json's one triangle over four prim shards, three of them
    padding sentinels: the padding never wins, the image is
    bit-identical."""
    for res in runs[4]:
        _assert_images_identical(res, "triangle/1x4", "triangle/one")
        assert np.isfinite(res["triangle/1x4/depth"]).any()


def test_render_sharded_mesh_scene(runs, scenes_dir):
    """mirror 32x16 b2 (924 triangles) split over two prim shards."""
    from cutrace_tpu.parallel import render_sharded
    from test_fused import _compare

    for res in runs[4]:
        _assert_images_identical(res, "mirror/2x2", "mirror/one")
    soa = _jax_soa(scenes_dir, "mirror.json", 32, 16)
    want = render_sharded(soa, _jax_mesh(2, 2), bounces=2)
    got = [runs[4][0][f"mirror/2x2/{k}"] for k in ("color", "depth",
                                                   "normal")]
    _compare([np.asarray(x) for x in want], got, atol=2e-4)


@pytest.mark.parametrize("tiles,prims", [(4, 1), (2, 2)])
def test_render_sharded_pallas(runs, scenes_dir, tiles, prims):
    """A "pallas" partition: the culling cast on each tile, or on each
    prim shard over its own partition with order_base; within atol 1e-4 of
    JAX's render_sharded of the same prepared scene (tests/test_parallel.py
    test_sharded_render_with_accel)."""
    from cutrace_tpu.parallel import render_sharded
    from cutrace_tpu.render.renderer import prepare

    soa = _jax_soa(scenes_dir, "mirror.json", 32, 16)
    want = render_sharded(prepare(soa, accel="pallas"),
                          _jax_mesh(tiles, prims), bounces=2)
    for res in runs[4]:
        for a, name in zip(want, ("color", "depth", "normal")):
            a = np.asarray(a)
            b = res[f"mirror/pallas/{tiles}x{prims}/{name}"]
            ok = np.isclose(a, b, atol=1e-4) | (np.isinf(a) & np.isinf(b))
            assert ok.all(), f"({tiles},{prims}) {name}"


@pytest.mark.parametrize("tiles,prims", [(4, 1), (2, 2)])
def test_prepared_sharded_scene_renders_the_same(runs, tiles, prims):
    """A scene prepared once for the mesh (prepare_sharded: the rank's
    shard, its partition and tables) renders, frame after frame, the image
    render_sharded makes of the whole prepared scene."""
    for res in runs[4]:
        got = f"mirror/pallas/{tiles}x{prims}"
        _assert_images_identical(res, f"{got}/prepared", got)


def test_prepared_sharded_scene_keeps_its_mesh():
    """A ShardedScene holds one rank's shard of one mesh: render_sharded
    refuses it on another mesh."""
    from cutrace_tpu_torch.parallel import sharding as sh

    mesh = sh.make_mesh(1, 1, device="cpu")
    ready = sh.prepare_sharded(_load("triangle.json", 8, 8), mesh)
    with pytest.raises(ValueError, match="mesh it was prepared for"):
        sh.render_sharded(ready, dataclasses.replace(mesh, n_tiles=2))


@pytest.mark.parametrize("label", ["bunny", "transparent"])
def test_render_sharded_fused_tiles(runs, label):
    """A "fused" partition on a (4, 1) mesh: every rank ran
    fused_render_rays on its run (once, the kernels' entry point), the
    image is bit-identical to the one-device fused render (bunny 32x16 b2,
    and the bunny with its mesh at transparency 0.5 at 16x8 b2), and the
    forward made no collective call: the image's gather is the one
    all_gather_into_tensor."""
    gather = np.zeros(len(_COLLECTIVES), int)
    gather[_COLLECTIVES.index("all_gather_into_tensor")] = 1
    for res in runs[4]:
        assert int(res[f"{label}/kernel_calls"]) == 1
        assert np.array_equal(res[f"{label}/collectives"], gather), dict(
            zip(_COLLECTIVES, res[f"{label}/collectives"]))
        _assert_images_identical(res, f"{label}/4x1", f"{label}/one")


@pytest.mark.parametrize("world,tiles,prims,accel", [
    (w, t, p, a) for w, meshes in GRAD_MESHES.items() for t, p in meshes
    for a in ("none", "fused")])
def test_sharded_gradients(runs, world, tiles, prims, accel):
    """One sharded_loss gradient on bunny 16x9 b1, all 19 groups, after the
    tiles all-reduce, on every rank: allclose to the one-device gradient
    (rtol 1e-5, atol 1e-6 of the group's largest). A shard's vertices get
    their gradient once, however many prim ranks render its rows."""
    prefix = f"grad/{tiles}x{prims}/{accel}"
    for res in runs[world]:
        np.testing.assert_allclose(res[f"{prefix}/loss"],
                                   res[f"{prefix}/ref_loss"], rtol=1e-6)
        keys = [k.split("/")[-1] for k in res
                if k.startswith(f"{prefix}/grad/")]
        assert len(keys) == 19
        for k in keys:
            got, want = res[f"{prefix}/grad/{k}"], res[f"{prefix}/ref/{k}"]
            scale = max(np.abs(want).max(), 1e-12)
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                       atol=1e-6 * scale, err_msg=k)


def test_fit_on_a_mesh(runs, scenes_dir):
    """fit at (2, 2) (mat_color and the sharded tri_p1 trained): three
    steps with a checkpoint, a resumed fourth, losses and whole parameters
    allclose to four steps on one device, the same on every rank; the
    losses within rtol 1e-4 of JAX's fit on the same mesh
    (tests/test_torch_train.py's gate)."""
    import jax

    from cutrace_tpu.parallel import train as jtrain

    ref = runs[4][0]
    losses = ref["fit/losses"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref["fit/ref_losses"], rtol=1e-5)
    js = _jax_soa(scenes_dir, "bunny.json", 16, 9)
    js = dataclasses.replace(js, mat_color=jax.numpy.asarray(
        ref["fit/start"]))
    _, jlosses = jtrain.fit(js, ref["fit/target"], _jax_mesh(2, 2), steps=4,
                            lr=5e-2, bounces=1,
                            param_filter=("mat_color", "tri_p1"),
                            accel="none")
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    for res in runs[4]:
        np.testing.assert_array_equal(res["fit/losses"], losses)
        for k in ("mat_color", "tri_p1"):
            np.testing.assert_allclose(res[f"fit/params4/{k}"],
                                       ref[f"fit/ref4/{k}"], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            assert res[f"fit/params3/{k}"].shape == ref[f"fit/ref4/{k}"].shape


def test_all_reduce_sum_in_rank_order(runs):
    """sharding.all_reduce_sum over four gloo ranks gives, on every rank,
    the float32 sum ((x0 + x1) + x2) + x3 of the ranks' vectors bit for
    bit, whatever order gloo's own all-reduce would take; the same values
    added in another order give other bits, so the check can fail."""
    xs = [res["sum/x"] for res in runs[4]]
    assert len({x.tobytes() for x in xs}) == 4
    want = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    assert want.dtype == np.float32
    for res in runs[4]:
        assert _bits_equal(res["sum/got"], want)
    assert not _bits_equal(((xs[3] + xs[2]) + xs[1]) + xs[0], want)


@pytest.mark.parametrize("tiles,prims", FIT_TWICE_MESHES)
def test_fit_on_a_mesh_twice_bit_equal(runs, tiles, prims):
    """fit(mesh=) twice from the same start (bunny 16x9 b1, mat_color and
    tri_p1 trained, FIT_STEPS steps over gloo): losses and every parameter
    bit-equal between the runs and on every rank, and within GRAD_RTOL of
    the one-device fit."""
    prefix = f"twice/{tiles}x{prims}"
    ref = runs[4][0]
    keys = [k.split("/")[-1] for k in ref
            if k.startswith(f"{prefix}/0/param/")]
    assert len(keys) == 19
    for res in runs[4]:
        for run in (0, 1):
            losses = res[f"{prefix}/{run}/losses"]
            assert len(losses) == FIT_STEPS and np.isfinite(losses).all()
            assert _bits_equal(losses, ref[f"{prefix}/0/losses"])
            for k in keys:
                assert _bits_equal(res[f"{prefix}/{run}/param/{k}"],
                                   ref[f"{prefix}/0/param/{k}"]), (run, k)
    np.testing.assert_allclose(ref[f"{prefix}/0/losses"],
                               ref["twice/one/0/losses"], rtol=GRAD_RTOL)
    for k in ("mat_color", "tri_p1"):
        np.testing.assert_allclose(ref[f"{prefix}/0/param/{k}"],
                                   ref[f"twice/one/0/param/{k}"],
                                   rtol=GRAD_RTOL, atol=1e-6, err_msg=k)


def test_mesh_over_a_group(runs):
    """make_mesh over a group of ranks 0 and 2: they render it, in rank
    order; ranks 1 and 3 get no mesh."""
    for rank, res in enumerate(runs[4]):
        assert bool(res["group/member"]) == (rank in (0, 2))
        if rank in (0, 2):
            assert int(res["group/tile"]) == rank // 2
            _assert_images_identical(res, "sphere_plane/group2x1",
                                     "sphere_plane/one")


@pytest.mark.parametrize("label,tiles,prims", [("1x4", 1, 4),
                                               ("2x2", 2, 2)])
def test_build_sharded_accel_matches_jax(runs, scenes_dir, label, tiles,
                                         prims):
    """Each rank's partition, built alone (shard_accel) and as its shard
    of the stack (build_sharded_accel), equals its shard of JAX's
    build_sharded_accel (local orders, common M)."""
    from cutrace_tpu.parallel.sharding import build_sharded_accel

    soa = _jax_soa(scenes_dir, "mirror.json", 32, 16)
    want = build_sharded_accel(soa, _jax_mesh(tiles, prims), kind="pallas",
                               interpret=True)
    for res in runs[4]:
        prim = int(res[f"accel/{label}/prim"])
        for part in ("", "stack_"):
            np.testing.assert_array_equal(res[f"accel/{label}/{part}order"],
                                          np.asarray(want.order)[prim])
            np.testing.assert_array_equal(res[f"accel/{label}/{part}valid"],
                                          np.asarray(want.valid)[prim])


def test_multihost_matches_one_process(runs, scenes_dir):
    """Two processes over gloo (multihost.initialize, global_mesh,
    render_multihost) render sphere_plane 64x36 b2 bit-identical to one
    process's render_sharded, on both ranks, and within the port-vs-JAX
    gate of JAX's one-device render (JAX's own render_sharded flips
    knife-edge winners against it at this size, 64 pixels here: its ray
    generation compiles apart, tests/test_parallel_fused.py);
    gather_image concatenates the ranks' pieces in rank order."""
    from cutrace_tpu.render.renderer import render as jrender
    from cutrace_tpu_torch.parallel import make_mesh, render_sharded
    from test_fused import _compare

    soa = _load("sphere_plane.json", 64, 36)
    single = render_sharded(soa, make_mesh(1, 1, device="cpu"), bounces=2)
    pieces = np.concatenate([np.full((3, 2), r, np.float32)
                             for r in range(2)])
    for res in runs[2]:
        assert res["multihost/shape"].tolist() == [2, 1]
        for name, want in zip(("color", "depth", "normal"), single):
            assert _identical(res[f"multihost/{name}"], want.numpy()), name
        np.testing.assert_array_equal(res["multihost/gathered"], pieces)
    want = jrender(_jax_soa(scenes_dir, "sphere_plane.json", 64, 36),
                   bounces=2)
    _compare([np.asarray(x) for x in want],
             [runs[2][0][f"multihost/{k}"] for k in ("color", "depth",
                                                     "normal")], atol=2e-4)


def test_torchrun_entry_point(runs):
    """`torchrun -m cutrace_tpu_torch.parallel.multihost` with two CPU
    ranks (initialize from torchrun's environment) on a (1, 2) mesh of the
    mirror scene with a "pallas" partition per shard: the image equals
    one rank's render in every pixel, and its --steps fit runs op by op
    (gloo, prim shards) with finite losses."""
    import json

    row = json.loads(runs["torchrun"].strip().splitlines()[-1])
    assert row["mesh"] == [1, 2] and row["backend"] == "gloo"
    assert row["device"] == "cpu" and len(row["frame_ms"]) == 2
    assert row["pixels_differ"] == 0
    # --steps: a fit over the prim-sharded gloo mesh, op by op by rule
    assert len(row["fit_losses"]) == 2 and row["step_program"] is False
    assert all(np.isfinite(row["fit_losses"]))


def test_torchrun_times_program_and_eager(runs):
    """The entry point times render_sharded (`frame_ms`) and
    render_sharded_eager (`eager_ms`) in turns in one run, every rank's
    both, and counts the programs captured: none over gloo, where both
    run op by op and give the same image."""
    import json

    row = json.loads(runs["torchrun"].strip().splitlines()[-1])
    assert len(row["frame_ms"]) == len(row["eager_ms"]) == 2
    assert all(x > 0 for x in row["frame_ms"] + row["eager_ms"])
    assert [len(row["turns_ms"][k]) for k in ("program", "eager")] == [2, 2]
    assert row["programs"] == 0 and row["eager_pixels_differ"] == 0
    # --steps: the fit again op by op from the same start gives the same
    # losses (over gloo both run op by op)
    assert row["fit_eager_losses"] == row["fit_losses"]
    assert row["fit_s"] > 0 and len(row["fit_eager_s"]) == 2


def test_torchrun_fits_twice_and_samples_frames(runs):
    """The entry point's --steps fits the program route twice from the
    same start: no loss or parameter element differs between the two,
    nor between the two op-by-op fits, and the line holds the SHA-256 of
    the fit's parameters that separate runs compare; every rank's program
    frames come one sample a frame (--reps of them); the kernels' tally
    is not measured on the CPU."""
    import json

    row = json.loads(runs["torchrun"].strip().splitlines()[-1])
    assert row["fit_differ"] == {"program": {"losses": 0, "params": 0},
                                 "eager": {"losses": 0, "params": 0}}
    sha = row["fit_params_sha256"]
    assert len(sha) == 64 and int(sha, 16) >= 0
    assert len(row["fit_program_s"]) == 2 and row["fit_s"] > 0
    assert [len(x) for x in row["frame_samples_ms"]] == [1, 1]
    assert all(x > 0 for x in row["frame_samples_ms"][0])
    assert row["work"] == "not measured"
    # every rank's launches over its sampled frames: none, plain versions
    assert row["sample_launches"] == [{}, {}]


def test_params_sha256_reads_keys_in_order_and_every_bit():
    """multihost.params_sha256: the same tensors in another key order give
    the same digest, one float32 step in one element another."""
    from cutrace_tpu_torch.parallel.multihost import params_sha256

    a = {"x": torch.arange(4, dtype=torch.float32),
         "m": torch.tensor([True, False]), "y": torch.ones(2, 3)}
    b = {k: a[k].clone() for k in ("y", "m", "x")}
    assert params_sha256(a) == params_sha256(b)
    b["x"][1] = torch.nextafter(b["x"][1], torch.tensor(2.0))
    assert params_sha256(a) != params_sha256(b)


def test_compare_fits_on_cpu(tmp_path):
    """python -m cutrace_tpu_torch.compare_fits over one checkout, two
    runs of a 2-rank gloo fit (mirror 32x16 b2): each run's parameters
    digested alike by multihost and by the tool, nothing differing
    between the runs, every program fit's step times kept."""
    import json

    proc = subprocess.run(
        [sys.executable, "-m", "cutrace_tpu_torch.compare_fits", ".",
         "--labels", "new", "--nproc", "2", "--algos", "default", "Ring",
         "--out", str(tmp_path), "--", *TORCHRUN_ARGS[:7], "--accel",
         "none", "--device", "cpu", "--reps", "1", "--steps", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=RANK_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]
    assert [r.get("algo") for r in rows[:2]] == ["default", "Ring"]
    for r in rows[:2]:
        assert r["params_sha256"] == r["fit_params_sha256"]
        assert len(r["fit_losses"]) == 3
        assert r["step_program"] is False and r["pixels_differ"] == 0
        assert [len(s["ms"]) for s in r["steps_ms"]] == [3, 3, 3, 3]
    summary = rows[-1]["summary"]["new"]
    assert summary["differ"]["default/Ring#1"]["losses"] == 0
    assert summary["differ"]["default/Ring#1"]["params"] == 0
    assert summary["differ"]["default/Ring#1"]["param_elements"] > 0
    assert [len(x) for x in summary["replayed_step_ms"]] == [2, 2]


PROGRAM_CASES = [(w, t, p, label) for w, meshes in PROGRAM_MESHES.items()
                 for t, p in meshes
                 for label in (("bunny/fused" if p == 1
                                else "sphere_plane/none"), "mirror/pallas")]


@pytest.mark.parametrize("world,tiles,prims,label", PROGRAM_CASES)
def test_program_frames_equal_eager(runs, world, tiles, prims, label):
    """render_sharded through its programs (the stand-in graphs on gloo
    ranks; sharding.mesh_captures patched to take the groups for NCCL's):
    one capture for the ShardedScene, the first and the replayed frames
    bit-identical to render_sharded_eager on every rank, and a replay
    makes no tensor from host data (the worker refused them)."""
    prefix = f"program/{label}/{tiles}x{prims}"
    for res in runs[world]:
        assert int(res[f"{prefix}/captures"]) == 1
        _assert_images_identical(res, prefix, f"{prefix}/eager")
        _assert_images_identical(res, f"{prefix}/first", f"{prefix}/eager")
        assert np.isfinite(res[f"{prefix}/depth"]).any()


@pytest.mark.parametrize("world,tiles,prims,label", PROGRAM_CASES)
def test_program_frame_collectives(runs, world, tiles, prims, label):
    """A replayed frame's collectives: on a tiles mesh exactly one, the
    image's all_gather_into_tensor (the counterpart of the JAX package's
    collective gates, tests/test_hlo.py, tests/test_parallel_fused.py);
    on a prims mesh two all-gathers a cast (the candidates' floats and
    keys) and the image's."""
    prefix = f"program/{label}/{tiles}x{prims}"
    for res in runs[world]:
        casts = int(res[f"{prefix}/casts"])
        assert (casts > 0) == (prims > 1)
        want = np.zeros(len(_COLLECTIVES), int)
        want[_COLLECTIVES.index("all_gather_into_tensor")] = 2 * casts + 1
        assert np.array_equal(res[f"{prefix}/collectives"], want), dict(
            zip(_COLLECTIVES, res[f"{prefix}/collectives"]))


@pytest.mark.parametrize("world,tiles,prims,label", [
    c for c in PROGRAM_CASES if c[3] != "bunny/fused"])
def test_program_frames_match_jax(runs, scenes_dir, world, tiles, prims,
                                  label):
    """The program frames within the port-vs-JAX gates of JAX's
    render_sharded on the same mesh: "pallas" within atol 1e-4
    (test_render_sharded_pallas's), brute force by _compare
    (test_render_sharded_brute_force's). The fused frames are
    bit-identical to their eager frames, which
    test_render_sharded_fused_tiles holds to the one-device render."""
    from cutrace_tpu.parallel import render_sharded
    from cutrace_tpu.render.renderer import prepare
    from test_fused import _compare

    name, accel = label.split("/")
    soa = _jax_soa(scenes_dir, f"{name}.json", 32, 16)
    scene = soa if accel == "none" else prepare(soa, accel=accel)
    want = [np.asarray(x) for x in render_sharded(
        scene, _jax_mesh(tiles, prims), bounces=2)]
    prefix = f"program/{label}/{tiles}x{prims}"
    for res in runs[world]:
        got = [res[f"{prefix}/{k}"] for k in ("color", "depth", "normal")]
        if accel == "none":
            _compare(want, got, atol=2e-4)
            continue
        for a, b, k in zip(want, got, ("color", "depth", "normal")):
            ok = np.isclose(a, b, atol=1e-4) | (np.isinf(a) & np.isinf(b))
            assert ok.all(), f"({tiles},{prims}) {k}"


def _bits_equal(a, b):
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


@pytest.mark.parametrize("world", sorted(STEP_MESH))
def test_prim_step_program_equals_eager(runs, world):
    """The prim-sharded step program ("pallas" partitions on each shard,
    all 19 groups, Adam) against the op-by-op step from one state, over
    STEPS steps: call 1 eager, call 2 captured and replayed, call 3
    replayed; losses, updated parameters and gradients bit for bit, the
    same on every rank."""
    t, p = STEP_MESH[world]
    prefix = f"step/{t}x{p}"
    first = runs[world][0]
    for res in runs[world]:
        assert list(res[f"{prefix}/program/log"]) == [
            "eager", "capture", "replay", "replay"]
        losses = res[f"{prefix}/program/losses"]
        assert len(losses) == STEPS and np.isfinite(losses).all()
        assert _bits_equal(losses, res[f"{prefix}/eager/losses"])
        assert _bits_equal(losses, first[f"{prefix}/program/losses"])
        keys = [k.split("/")[-1] for k in res
                if k.startswith(f"{prefix}/program/grad/")]
        assert len(keys) == 19
        for kind in ("param", "grad"):
            for k in keys:
                assert _bits_equal(res[f"{prefix}/program/{kind}/{k}"],
                                   res[f"{prefix}/eager/{kind}/{k}"]), (
                    kind, k)


@pytest.mark.parametrize("world", sorted(STEP_MESH))
def test_prim_step_program_gradients(runs, world):
    """The replayed prim-sharded step's gradients (its third call) within
    GRAD_RTOL (atol 1e-6 of the group's largest) of one device's at the
    state the step started from, all 19 groups, the triangle rows
    gathered from the shards."""
    t, p = STEP_MESH[world]
    prefix = f"step/{t}x{p}"
    for res in runs[world]:
        keys = [k.split("/")[-1] for k in res
                if k.startswith(f"{prefix}/ref/")]
        assert len(keys) == 19
        for k in keys:
            got = res[f"{prefix}/program/grad/{k}"]
            want = res[f"{prefix}/ref/{k}"]
            scale = max(np.abs(want).max(), 1e-12)
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                       atol=1e-6 * scale, err_msg=k)


@pytest.mark.parametrize("world", sorted(STEP_MESH))
def test_prim_step_program_one_all_reduce(runs, world):
    """Every call of the prim-sharded step, program and op by op, makes
    exactly one gradient sum (sharding.all_reduce_sum: a gather, then the
    adds in rank order), over the tiles group, of the trainable
    parameters' size plus one (the loss), and no dist.all_reduce, whose
    order of addition the backend chooses: the counterpart of the JAX
    package's gate on its step's collectives (tests/test_hlo.py)."""
    t, p = STEP_MESH[world]
    prefix = f"step/{t}x{p}"
    for res in runs[world]:
        size = int(res[f"{prefix}/size"])
        for label in ("program", "eager"):
            reduces = res[f"{prefix}/{label}/reduces"]
            assert len(reduces) == STEPS
            for calls, numel, tiles_group, all_reduce in reduces:
                assert (calls, numel, tiles_group, all_reduce) == (
                    1, size, 1, 0), label


def test_capture_rule_nccl_and_gloo(monkeypatch):
    """sharding.mesh_captures and train.step_is_captured: a CUDA device
    whose groups are NCCL's captures, prims meshes included; gloo and the
    CPU run op by op. The groups' backends are mocked."""
    from cutrace_tpu_torch.parallel import sharding as sh
    from cutrace_tpu_torch.parallel import train

    cuda = torch.device("cuda", 0)
    groups = dict(group=object(), tiles_group=object(),
                  prims_group=object())
    for n_tiles, n_prims in ((1, 2), (2, 2), (4, 1)):
        mesh = sh.Mesh(n_tiles, n_prims, 0, 0, cuda, **groups)
        cpu = dataclasses.replace(mesh, device=torch.device("cpu"))
        for backend, want in (("nccl", True), ("gloo", False)):
            monkeypatch.setattr(sh.dist, "get_backend",
                                lambda group=None, _b=backend: _b)
            assert sh.mesh_captures(mesh) is want
            assert train.step_is_captured(cuda, mesh) is want
            assert not sh.mesh_captures(cpu)
            assert not train.step_is_captured(torch.device("cpu"), cpu)
    # the one-process (1, 1) mesh has no group: it captures on a card
    assert sh.mesh_captures(sh.Mesh(1, 1, 0, 0, cuda))


def _stack(rng, k, r, ties):
    """A seeded (K, R) candidate stack as numpy leaves, with exact t ties
    across shards on a share of the rays and misses on others."""
    t = rng.uniform(0.5, 3.0, (k, r)).astype(np.float32)
    tie = rng.random(r) < ties
    t[:, tie] = t[0, tie]
    t[:, rng.random(r) < 0.1] = np.inf
    order = rng.permutation(k * r).reshape(k, r).astype(np.int32)
    return dict(
        t=t, obj=rng.integers(0, 5, (k, r)).astype(np.int32), order=order,
        mat=rng.integers(0, 3, (k, r)).astype(np.int32),
        is_mesh=rng.random((k, r)) < 0.5,
        p1=rng.normal(size=(k, r, 3)).astype(np.float32),
        p2=rng.normal(size=(k, r, 3)).astype(np.float32),
        p3=rng.normal(size=(k, r, 3)).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_combine_tri_candidates_matches_jax(seed):
    import jax.numpy as jnp

    from cutrace_tpu.ops import intersect as JI
    from cutrace_tpu_torch.ops import intersect as TI

    leaves = _stack(np.random.default_rng(seed), 4, 257, ties=0.3)
    want = JI.combine_tri_candidates(JI.TriCandidate(
        **{k: jnp.asarray(v) for k, v in leaves.items()}))
    got = TI.combine_tri_candidates(TI.TriCandidate(
        **{k: torch.from_numpy(v) for k, v in leaves.items()}))
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)


def test_order_base_matches_jax(scenes_dir):
    """local_tri_candidates, cluster_candidates, accel_candidates and
    pallas_candidates offset their order keys by order_base as JAX's do,
    misses keeping the sentinel; a shard's partition built with
    min_clusters pads to the same M."""
    from cutrace_tpu.ops import bvh as jbvh
    from cutrace_tpu.ops import intersect as JI
    from cutrace_tpu_torch.ops import bvh as tbvh
    from cutrace_tpu_torch.ops import intersect as TI
    from test_torch_host import port_scene
    from cutrace_tpu.scene.loader import load_scene
    from cutrace_tpu_torch.scene.soa import scene_to_soa

    sc = load_scene(scenes_dir / "mirror.json")
    sc.camera.width, sc.camera.height = 8, 8
    js = _jax_soa(scenes_dir, "mirror.json", 8, 8)
    ts = scene_to_soa(port_scene(sc), device="cpu")
    rng = np.random.default_rng(3)
    o = rng.normal(0.0, 0.5, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    md = np.full(64, 1e-3, np.float32)
    base = 1000
    jacc = jbvh.build_accel(js, 64, kind="clusters", interpret=True,
                            min_clusters=20)
    tacc = tbvh.build_accel(ts, 64, kind="clusters", min_clusters=20)
    assert tacc.order.shape[0] == 20
    np.testing.assert_array_equal(tacc.order.numpy(), np.asarray(jacc.order))
    jargs = (jnp_(o), jnp_(d), jnp_(md), js.scene_center)
    targs = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(md),
             ts.scene_center)
    cases = [
        (JI.local_tri_candidates(js, *jargs, order_base=base),
         TI.local_tri_candidates(ts, *targs, order_base=base)),
        (jbvh.cluster_candidates(js, jacc, *jargs, order_base=base),
         tbvh.cluster_candidates(ts, tacc, *targs, order_base=base)),
        (jbvh.accel_candidates(js, dataclasses.replace(jacc, kind="pallas"),
                               *jargs, order_base=base),
         tbvh.accel_candidates(ts, dataclasses.replace(tacc, kind="pallas"),
                               *targs, order_base=base)),
    ]
    for want, got in cases:
        wo, go = np.asarray(want.order), got.order.numpy()
        hit = np.isfinite(np.asarray(want.t))
        assert hit.any() and (~hit).any()
        np.testing.assert_array_equal(go[hit], wo[hit])
        assert (go[hit] >= base).all()
    # misses of the culling cast keep the sentinel past the offset
    got = cases[2][1]
    assert (got.order.numpy()[~np.isfinite(got.t.numpy())] == 2**30).all()


def jnp_(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


if __name__ == "__main__":
    worker(sys.argv[1:])
