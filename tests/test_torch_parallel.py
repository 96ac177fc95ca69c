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

import dataclasses
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
        for n, fn in self.saved.items():
            def wrap(*a, _n=n, _fn=fn, **k):
                self.calls[_n] = self.calls.get(_n, 0) + 1
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
    all_gather."""
    gather = np.zeros(len(_COLLECTIVES), int)
    gather[_COLLECTIVES.index("all_gather")] = 1
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
