"""Port parity for the culling cast (the K4 path): cutrace_tpu_torch's
ops.pallas_cast, the "pallas" accel, render's fallback past the fused
kernels' 63 nodes and the composable backward past the replay's budgets,
against the JAX package (its `_cast_kernel` in interpret mode, as its own
tests run it) and against the port's plain composable path.

The CUDA kernel K4 runs only on the card; chip_smoke.py holds it against
cast_clusters_plain there. Gates: winner order equal and t within 1e-6
of its cancelling terms' scale, over the hit's cosine floored at 0.1, for
the query; tests/test_fused.py's _compare (atol 2e-4) for renders;
relative error below 2e-4 per parameter group for gradients
(tests/test_torch_grad.py's gate)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutrace_tpu.diff import grad as jgrad
from cutrace_tpu.ops import bvh as jbvh
from cutrace_tpu.ops import pallas_cast as jpc
from cutrace_tpu.render import renderer as JR
from cutrace_tpu.scene.loader import load_scene
from cutrace_tpu.scene.mesh_io import subdivide
from cutrace_tpu.scene.soa import scene_to_soa as jax_soa
from cutrace_tpu_torch import cli
from cutrace_tpu_torch.diff import grad as tgrad
from cutrace_tpu_torch.ops import bvh as tbvh
from cutrace_tpu_torch.ops import fused as tfused
from cutrace_tpu_torch.ops import pallas_cast as tpc
from cutrace_tpu_torch.ops import replay as treplay
from cutrace_tpu_torch.render import renderer as TR
from cutrace_tpu_torch.scene.soa import scene_to_soa
from test_fused import _compare
from test_torch_host import port_scene

torch.set_num_threads(2)


def _scene(scenes_dir, name, w, h):
    sc = load_scene(scenes_dir / name)
    sc.camera.width, sc.camera.height = w, h
    return sc


def _rays(soa_center, n, seed):
    """numpy-seeded rays: origins scattered around the scene center,
    directions uniform on the sphere, min_dist 1e-3."""
    rng = np.random.default_rng(seed)
    o = (np.asarray(soa_center, np.float32)
         + rng.normal(0.0, 0.6, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, np.full((n,), 1e-3, np.float32)


@pytest.mark.parametrize("cluster_size", [64, 8])
def test_cast_clusters_matches_jax(scenes_dir, cluster_size):
    """The plain query against JAX's _run_cast on the 16k bunny: C=64
    (M=256, one resident sweep) and C=8 (M=2048, past M_CHUNK, so JAX's
    streamed chunks are held too)."""
    sc = _scene(scenes_dir, "bunny.json", 8, 8)
    for ob in sc.objects:
        if type(ob).__name__ == "Mesh":
            ob.vertices = subdivide(ob.vertices, 2)
    js = jax_soa(sc)
    ja = jbvh.build_accel(js, cluster_size, kind="pallas", interpret=True)
    assert (ja.order.shape[0] > jpc.M_CHUNK) == (cluster_size == 8)
    cl = jbvh.clusters_from_accel(js, ja)
    o0 = js.scene_center
    o, d, md = _rays(np.asarray(o0), 700, seed=cluster_size)
    want_t, want_ord = jpc._run_cast(
        jpc._cluster_constants(cl, o0), cl.bmin - o0, cl.bmax - o0,
        jnp.asarray(o) - o0, jnp.asarray(d), jnp.asarray(md), True)

    ts = scene_to_soa(port_scene(sc), device="cpu")
    accel = tbvh.accel_from_numpy(np.asarray(ja.order), np.asarray(ja.valid),
                                  device="cpu", kind="pallas")
    tables = tpc.cluster_tables(ts, accel)
    before = tpc.LAUNCHES
    t, order = tpc.cast_clusters(tables, torch.from_numpy(o) - ts.scene_center,
                                 torch.from_numpy(d), torch.from_numpy(md))
    assert tpc.LAUNCHES == before  # CPU tensors: the plain version
    assert order.dtype == torch.int32
    want_ord = np.asarray(want_ord)
    assert np.array_equal(order.numpy(), want_ord)
    hits = want_ord < 2**30
    assert 50 < hits.sum() < 700
    assert np.isinf(t.numpy()[~hits]).all()
    # t within 1e-6 of the scale of its cancelling terms, t + |o - o0|,
    # over the hit's |cos| to the triangle's normal floored at 0.1: in
    # t = (k - o.n) / (d.n) both quotients cancel, near the surface and at
    # grazing hits, and there the two frameworks' rounding grows by those
    # factors. Here |dt| max(|cos|, 0.1) / (t + |o - o0|) reads at most
    # 1.6e-7 (C=8; 8.5e-8 at C=64); without the cosine it reaches 1.6e-6
    # at a grazing hit
    rows = tables.tri.reshape(-1, tpc._TRI_ROWS)[tables.tri.reshape(
        -1, tpc._TRI_ROWS)[:, 17] > 0]
    normal = torch.zeros((ts.tri_p1.shape[0], 3))
    normal[rows[:, 16].long()] = torch.nn.functional.normalize(rows[:, 0:3],
                                                               dim=1)
    cos = (torch.from_numpy(d) * normal[order.clamp(max=normal.shape[0] - 1)
                                        .long()]).sum(1).abs().numpy()
    got, want = t.numpy()[hits], np.asarray(want_t)[hits]
    scale = want + np.linalg.norm(o - np.asarray(o0), axis=1)[hits]
    dt = np.abs(got - want)
    reading = dt * np.maximum(cos[hits], 0.1) / scale
    print(f"C={cluster_size}: max |dt| {dt.max():.2e}, max |dt| "
          f"max(|cos|, 0.1) / (t + |o - o0|) {reading.max():.2e}, without "
          f"the cosine {(dt / scale).max():.2e}")
    assert (reading <= 1e-6).all()
    assert np.median(np.abs(got - want) / want) < 1e-7


@pytest.mark.parametrize("scene", ["bunny.json", "mirror.json"])
def test_pallas_render_matches_jax(scenes_dir, scene):
    """prepare(accel="pallas") + render at 32x18 b3 against JAX's (its
    culling kernel in interpret mode)."""
    sc = _scene(scenes_dir, scene, 32, 18)
    base = JR.render(JR.prepare(jax_soa(sc), accel="pallas"), bounces=3)
    prepared = TR.prepare(scene_to_soa(port_scene(sc), device="cpu"),
                          accel="pallas")
    assert prepared.accel.kind == "pallas"
    out = TR.render(prepared, bounces=3)
    _compare([np.asarray(x) for x in base], [x.numpy() for x in out],
             atol=2e-4)


def test_pallas_grad_matches_jax(scenes_dir):
    """A gradient through accel="pallas" (the culling cast picks winners,
    t is re-derived from the live vertices) against jax.grad of JAX's
    render_loss with a "pallas" accel."""
    sc = _scene(scenes_dir, "bunny.json", 16, 9)
    js = jax_soa(sc)
    ja = jbvh.build_accel(js, 64, kind="pallas", interpret=True)
    color, _, _ = jgrad.render_image_flat(js, 2, 1e-3)
    target = 0.5 * np.asarray(color) + 0.1
    _, want = jgrad.grad_render_loss(js, jnp.asarray(target), 2, accel=ja)
    ts = scene_to_soa(port_scene(sc), device="cpu")
    accel = tbvh.accel_from_numpy(np.asarray(ja.order), np.asarray(ja.valid),
                                  device="cpu", kind="pallas")
    loss, got = tgrad.grad_render_loss(ts, torch.from_numpy(target), 2,
                                       accel=accel)
    assert np.isfinite(loss.item())
    assert np.abs(got["tri_p1"].numpy()).sum() > 0
    for k in tgrad.DIFFERENTIABLE_FIELDS:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert np.isfinite(a).all(), k
        scale = max(np.abs(b).max(), 1e-6)
        err = np.abs(a - b).max() / scale
        assert err < 2e-4, f"{k}: rel err {err:.3e}"


def test_fallback_past_63_nodes(scenes_dir):
    """sphere_plane at 16x8 b6 (a 127-node tree) through
    prepare(accel="fused"): render takes the composable culling cast, and
    matches JAX's render of the same (its own fallback)."""
    sc = _scene(scenes_dir, "sphere_plane.json", 16, 8)
    base = JR.render(JR.prepare(jax_soa(sc), accel="fused"), bounces=6)
    prepared = TR.prepare(scene_to_soa(port_scene(sc), device="cpu"),
                          accel="fused", bounces=6)
    out = TR.render(prepared, bounces=6)
    _compare([np.asarray(x) for x in base], [x.numpy() for x in out],
             atol=2e-4)


@pytest.mark.parametrize("scene,accel,bounces", [
    ("bunny.json", "pallas", 2),
    ("sphere_plane.json", "fused", 6),
])
def test_warm_culling_chunk_makes_no_host_tensor(scenes_dir, monkeypatch,
                                                 scene, accel, bounces):
    """A composable chunk through the culling cast creates no tensor from
    host data once warm (the CPU's stand-in for capturable as a CUDA
    graph): the "pallas" path, and the 127-node fallback of a "fused"
    partition."""
    from test_torch_render import chunk_is_capturable

    sc = _scene(scenes_dir, scene, 16, 8)
    prepared = TR.prepare(scene_to_soa(port_scene(sc), device="cpu"),
                          accel=accel, bounces=bounces)
    assert not tfused.fused_supported(prepared.soa, prepared.accel, bounces)
    chunk_is_capturable(monkeypatch, prepared, bounces)


def test_composable_backward_past_replay(scenes_dir, monkeypatch):
    """Inside the kernels' scope but past the replay's row budget the
    Function's forward emits no codes, and its gradient (the composable
    path with the culling cast, chunked under checkpoint) equals autograd
    of the plain composable path, outputs included."""
    sc = _scene(scenes_dir, "bunny.json", 16, 9)
    ts = scene_to_soa(port_scene(sc), device="cpu")
    accel = TR.prepare(ts, accel="fused").accel
    monkeypatch.setattr(treplay, "REPLAY_MAX_ROWS", 8)
    assert not tfused.replay_supported(ts, accel, 2)
    monkeypatch.setattr(tfused, "emit_topo_plain", None)  # never called
    params = {k: v.clone().requires_grad_()
              for k, v in tgrad.extract_params(ts).items()}

    def loss(acc):
        c, dep, nrm = tgrad.render_image_flat(tgrad.with_params(ts, params),
                                              2, 1e-3, acc)
        fin = torch.isfinite(dep)
        return (torch.mean(c ** 2) + torch.mean(torch.where(fin, dep, 0.0))
                + torch.mean(nrm))

    la, lb = loss(accel), loss(None)
    assert la.item() == pytest.approx(lb.item(), rel=1e-5)
    ga = torch.autograd.grad(la, list(params.values()), allow_unused=True)
    gb = torch.autograd.grad(lb, list(params.values()), allow_unused=True)
    for k, a, b in zip(params, ga, gb):
        if b is None:
            assert a is None or not a.any(), k
            continue
        scale = max(b.abs().max().item(), 1e-6)
        err = (a - b).abs().max().item() / scale
        assert err < 2e-4, f"{k}: rel err {err:.3e}"


def test_composable_rays_chunks_under_checkpoint(scenes_dir, monkeypatch):
    """composable_rays runs JAX's chunk rule (65536 rays, or
    max(4096, 65536 >> bounces) in two-branch trees), each chunk under
    torch.utils.checkpoint."""
    import torch.utils.checkpoint as ckpt

    calls = []
    real = ckpt.checkpoint

    def spy(fn, o, d, **kw):
        calls.append(o.shape[0])
        return real(fn, o, d, **kw)

    monkeypatch.setattr(ckpt, "checkpoint", spy)
    ts = scene_to_soa(port_scene(_scene(scenes_dir, "sphere_plane.json", 4,
                                        2)), device="cpu")
    accel = TR.prepare(ts, accel="fused").accel
    o = ts.cam_eye.expand(9000, 3)
    d = torch.nn.functional.normalize(torch.randn(9000, 3), dim=1)
    c, dep, _ = tfused.composable_rays(ts, accel, o, d, 1e-3, 1)
    assert calls == [9000] and c.shape == (9000, 3)  # 32768 per chunk
    calls.clear()
    tfused.composable_rays(ts, accel, o, d, 1e-3, 5)
    assert calls == [4096, 4096, 808]


def test_culling_provider_caches_per_scene(scenes_dir, monkeypatch):
    """Without cached tables the provider builds them from the live
    leaves once per scene object, not once per cast; a scene with moved
    vertices gets its own."""
    built = []
    real = tpc.cluster_tables
    monkeypatch.setattr(tpc, "cluster_tables",
                        lambda soa, accel: built.append(1) or real(soa, accel))
    ts = scene_to_soa(port_scene(_scene(scenes_dir, "bunny.json", 8, 4)),
                      device="cpu")
    accel = TR.prepare(ts, accel="pallas").accel
    provider = tbvh.candidates_fn(accel)
    o, d, _ = TR.block_rays(ts)
    md = torch.full((o.shape[0],), 1e-3)
    for _ in range(3):
        provider(ts, o, d, md, ts.scene_center)
    assert len(built) == 1
    moved = dataclasses.replace(ts, tri_p1=ts.tri_p1 + 0.01)
    provider(moved, o, d, md, ts.scene_center)
    assert len(built) == 2
    dense = tbvh.candidates_fn(dataclasses.replace(accel, kind="clusters"))
    got = provider(ts, o, d, md, ts.scene_center)
    want = dense(ts, o, d, md, ts.scene_center)
    hit = torch.isfinite(want.t)
    assert hit.any() and torch.equal(torch.isfinite(got.t), hit)
    assert torch.equal(got.order[hit], want.order[hit])


def test_cast_wrapper_contract(scenes_dir, monkeypatch):
    """The CUDA wrapper's host side, with a stand-in library: sizes and
    buffers reach the launch, LAUNCHES counts successful launches only, a
    CUDA error code raises, and rays of the wrong type raise first."""
    calls = []

    class FakeLib:
        rc = 0

        def cutrace_cluster_cast(self, *args):
            calls.append(args)
            return self.rc

    lib = FakeLib()
    from cutrace_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "load_library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    ts = scene_to_soa(port_scene(_scene(scenes_dir, "bunny.json", 8, 4)),
                      device="cpu")
    tables = tpc.cluster_tables(ts, tbvh.build_accel(ts, 64, kind="pallas"))
    o = torch.zeros((10, 3))
    md = torch.full((10,), 1e-3)
    before = tpc.LAUNCHES
    t, order = tpc._cast_clusters_cuda(tables, o, o, md)
    assert tpc.LAUNCHES == before + 1 and calls[0][6:9] == (10, 16, 64)
    assert t.shape == (10,) and order.dtype == torch.int32
    lib.rc = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tpc._cast_clusters_cuda(tables, o, o, md)
    with pytest.raises(ValueError, match="float32"):
        tpc._cast_clusters_cuda(tables, o.double(), o, md)
    assert tpc.LAUNCHES == before + 1 and len(calls) == 2


def test_cli_accel_choices(scenes_dir, tmp_path, capsys):
    """--accel takes the JAX CLI's choices; --accel pallas renders."""
    import re

    import cutrace_tpu.cli as jcli

    def choices(module):
        src = open(module.__file__).read()
        tup = re.search(r'"--accel".*?choices=\(([^)]*)\)', src, re.DOTALL)
        return re.findall(r'"(\w+)"', tup.group(1))

    assert choices(cli) == choices(jcli) == [
        "auto", "none", "clusters", "pallas", "fused"]
    assert cli.main([str(scenes_dir / "triangle.json"), "--accel", "pallas",
                     "--device", "cpu", "--out", str(tmp_path)]) == 0
    for name in ("frame.jpg", "depth_map.jpg", "normal_map.jpg"):
        assert (tmp_path / name).stat().st_size > 0
    with pytest.raises(SystemExit):
        cli.main([str(scenes_dir / "triangle.json"), "--accel", "bvh"])
    assert "invalid choice" in capsys.readouterr().err
