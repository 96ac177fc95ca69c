"""Port parity: cutrace_tpu_torch.scene.soa and the cluster partition of
cutrace_tpu_torch.ops.bvh against the JAX package, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutrace_tpu.ops import bvh as jbvh
from cutrace_tpu.scene import soa as jsoa
from cutrace_tpu.scene.loader import load_scene
from cutrace_tpu_torch.ops import bvh as tbvh
from cutrace_tpu_torch.scene import soa as tsoa
from test_torch_host import port_scene

torch.set_num_threads(2)

SCENES = ["triangle.json", "bunny.json", "bunny_small.json", "mirror.json",
          "sphere_plane.json"]


def _jax_leaves(soa):
    return {name: np.asarray(getattr(soa, name)) for name in tsoa.LEAF_NAMES}


def _assert_same(port, leaves, meta):
    for name in tsoa.LEAF_NAMES:
        got = getattr(port, name).numpy()
        want = leaves[name]
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert np.array_equal(got, want, equal_nan=True), name
    for name in tsoa.META_NAMES:
        assert getattr(port, name) == meta[name], name


@pytest.mark.parametrize("scene", SCENES)
def test_scene_to_soa_bit_identical(scenes_dir, scene):
    sc = load_scene(scenes_dir / scene)
    ref = jsoa.scene_to_soa(sc)
    port = tsoa.scene_to_soa(port_scene(sc), device="cpu")
    meta = {name: getattr(ref, name) for name in tsoa.META_NAMES}
    _assert_same(port, _jax_leaves(ref), meta)


@pytest.mark.parametrize("scene", SCENES)
def test_soa_from_numpy_of_jax_leaves(scenes_dir, scene):
    """The JAX leaves, read back as numpy, rebuild the same tensors."""
    sc = load_scene(scenes_dir / scene)
    ref = jsoa.scene_to_soa(sc)
    leaves = _jax_leaves(ref)
    meta = {name: getattr(ref, name) for name in tsoa.META_NAMES}
    port = tsoa.soa_from_numpy(leaves, meta, device="cpu")
    _assert_same(port, leaves, meta)
    assert port.device == torch.device("cpu")


@pytest.mark.parametrize("scene", SCENES)
def test_host_triangle_soup(scenes_dir, scene):
    sc = load_scene(scenes_dir / scene)
    for got, want in zip(tsoa.host_triangle_soup(port_scene(sc)),
                         jsoa.host_triangle_soup(sc)):
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)


@pytest.mark.parametrize("cluster_size", [64, 128])
@pytest.mark.parametrize("scene", SCENES)
def test_build_accel_partition(scenes_dir, scene, cluster_size):
    sc = load_scene(scenes_dir / scene)
    ref = jbvh.build_accel(jsoa.scene_to_soa(sc), cluster_size,
                           kind="fused", interpret=True)
    port = tbvh.build_accel(
        tsoa.scene_to_soa(port_scene(sc), device="cpu"), cluster_size)
    assert np.array_equal(port.order.numpy(), np.asarray(ref.order))
    assert np.array_equal(port.valid.numpy(), np.asarray(ref.valid))
    again = tbvh.accel_from_numpy(np.asarray(ref.order),
                                  np.asarray(ref.valid), device="cpu")
    assert torch.equal(again.order, port.order)
    assert torch.equal(again.valid, port.valid)


def test_numpy_partition_fallback_matches_native(scenes_dir, monkeypatch):
    """The numpy median split (used when the native library is missing)
    gives the native median split's leaves."""
    from cutrace_tpu_torch import native

    p1, p2, p3, _ = tsoa.host_triangle_soup(
        port_scene(load_scene(scenes_dir / "bunny.json")))
    centroids = (p1 + p2 + p3) / 3.0
    nat = tbvh.build_partition(centroids, 64)
    monkeypatch.setattr(native, "available", lambda: False)
    fallback = tbvh.build_partition(centroids, 64)
    assert len(nat) == len(fallback) == 16
    for a, b in zip(nat, fallback):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("scene", ["bunny.json", "sphere_plane.json"])
def test_clusters_from_accel(scenes_dir, scene):
    sc = load_scene(scenes_dir / scene)
    jsa = jsoa.scene_to_soa(sc)
    ref = jbvh.clusters_from_accel(jsa, jbvh.build_accel(
        jsa, 64, kind="fused", interpret=True))
    tsa = tsoa.scene_to_soa(port_scene(sc), device="cpu")
    port = tbvh.clusters_from_accel(tsa, tbvh.build_accel(tsa, 64))
    for name in ("p1", "p2", "p3", "mat", "obj", "order", "is_mesh",
                 "valid", "bmin", "bmax"):
        assert np.array_equal(getattr(port, name).numpy(),
                              np.asarray(getattr(ref, name))), name


def test_slab_entry_matches_jax():
    """Seeded rays against boxes, including axis-parallel rays that start
    on a box face (the 0 * inf case)."""
    rng = np.random.default_rng(3)
    bmin = rng.uniform(-1.0, 0.0, (8, 3)).astype(np.float32)
    bmax = bmin + rng.uniform(0.1, 1.0, (8, 3)).astype(np.float32)
    o = rng.uniform(-2.0, 2.0, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d[:8, 0] = 0.0
    o[:8, 0] = bmin[:, 0]
    want = jbvh.slab_entry(*(jnp.asarray(a) for a in (bmin, bmax, o, d)))
    got = tbvh.slab_entry(*(torch.from_numpy(a) for a in (bmin, bmax, o, d)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
