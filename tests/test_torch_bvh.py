"""Port parity for the last helpers of ops.bvh: `slab_test` (the boxes'
hit mask) and `build_clusters` (partition and geometry gather in one
call), against the JAX package's on numpy-seeded inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutrace_tpu.ops import bvh as JB
from cutrace_tpu.scene.loader import load_scene
from cutrace_tpu.scene.soa import scene_to_soa as jax_soa
from cutrace_tpu_torch.ops import bvh as TB
from cutrace_tpu_torch.scene.soa import scene_to_soa
from test_torch_host import port_scene

torch.set_num_threads(2)


def _boxes_and_rays(seed, n_boxes=37, n_rays=500):
    """Seeded boxes and rays, a share of the directions with zero
    components (inf reciprocals, 0 * inf = NaN in the slab products) and
    of the origins on a box face."""
    rng = np.random.default_rng(seed)
    lo = rng.normal(0.0, 2.0, (n_boxes, 3)).astype(np.float32)
    bmin = lo
    bmax = (lo + rng.uniform(0.0, 1.5, (n_boxes, 3))).astype(np.float32)
    o = rng.normal(0.0, 3.0, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d[: n_rays // 5, rng.integers(0, 3)] = 0.0
    d[n_rays // 5: n_rays // 4, :2] = 0.0
    o[: n_rays // 10, 0] = bmin[0, 0]
    return bmin, bmax, o, d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slab_test_matches_jax(seed):
    bmin, bmax, o, d = _boxes_and_rays(seed)
    want = np.asarray(JB.slab_test(jnp.asarray(bmin), jnp.asarray(bmax),
                                   jnp.asarray(o), jnp.asarray(d)))
    got = TB.slab_test(*(torch.from_numpy(x) for x in (bmin, bmax, o, d)))
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("scene,cluster_size", [("bunny.json", 64),
                                                ("bunny.json", 16),
                                                ("mirror.json", 8)])
def test_build_clusters_matches_jax(scenes_dir, scene, cluster_size):
    """Every TriClusters field equal to the JAX package's."""
    sc = load_scene(scenes_dir / scene)
    want = JB.build_clusters(jax_soa(sc), cluster_size)
    got = TB.build_clusters(scene_to_soa(port_scene(sc), device="cpu"),
                            cluster_size)
    for f in dataclasses.fields(got):
        a = getattr(got, f.name).numpy()
        b = np.asarray(getattr(want, f.name))
        assert a.shape == b.shape, f.name
        assert np.array_equal(a, b.astype(a.dtype)), f.name
