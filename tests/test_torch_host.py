"""The port's own host layer (scene loading, images, the native library)
against the JAX package's, and the rules that keep the two packages apart:
the port imports nothing of cutrace_tpu, and its entry points run on the
card unless the caller asks for the CPU."""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from cutrace_tpu.io import images as jimages
from cutrace_tpu.scene import loader as jloader
from cutrace_tpu_torch import native as tnative
from cutrace_tpu_torch.io import images as timages
from cutrace_tpu_torch.scene import loader as tloader
from cutrace_tpu_torch.scene import types as PT

REPO = pathlib.Path(__file__).resolve().parent.parent
SCENE_FILES = sorted(p.name for p in (REPO / "scenes").glob("*.json"))


def port_scene(sc):
    """The JAX package's Scene `sc` rebuilt from the port's scene types
    (same field values), for handing one loaded scene to both packages."""
    def conv(x):
        cls = getattr(PT, type(x).__name__)
        return cls(**{f.name: getattr(x, f.name)
                      for f in dataclasses.fields(x)})

    return PT.Scene(objects=[conv(o) for o in sc.objects],
                    lights=[conv(x) for x in sc.lights],
                    materials=[conv(m) for m in sc.materials],
                    camera=conv(sc.camera))


def _assert_same(a, b, where):
    assert type(a).__name__ == type(b).__name__, where
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("name", SCENE_FILES)
@pytest.mark.parametrize("compat", [True, False])
def test_loader_matches_jax(name, compat):
    """Every bundled scene loads to the same Scene, warnings, errors and
    validity as through the JAX package's loader."""
    want = jloader.load_file(str(REPO / "scenes" / name), compat=compat,
                             quiet=True)
    got = tloader.load_file(str(REPO / "scenes" / name), compat=compat,
                            quiet=True)
    assert got.ok == want.ok
    assert list(got.errors) == list(want.errors)
    if want.ok:
        _assert_same(got.scene, want.scene, name)


def test_image_encoders_match_jax():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 9.0, (6, 7)).astype(np.float32)
    depth[0, 0] = np.inf
    normal = rng.normal(size=(6, 7, 3)).astype(np.float32)
    color = rng.uniform(-0.2, 1.2, (6, 7, 3)).astype(np.float32)
    assert timages.max_finite_depth(depth) == jimages.max_finite_depth(depth)
    for fn in ("to_color_bytes", "to_normal_bytes"):
        arg = color if fn == "to_color_bytes" else normal
        assert np.array_equal(getattr(timages, fn)(arg),
                              getattr(jimages, fn)(arg)), fn
    assert np.array_equal(timages.to_depth_bytes(depth, 9.0),
                          jimages.to_depth_bytes(depth, 9.0))


def test_native_library_is_the_ports_own(tmp_path):
    """The port compiles native/*.cpp into build/native/ and loads that
    library, never the one the JAX package builds; its cluster split and
    JPEG encoder behave like the JAX package's binding."""
    from cutrace_tpu import native as jnative

    lib = tnative.load()
    if lib is None:
        pytest.skip("no C++ compiler to build the native library")
    path = tnative.library_path()
    assert path.exists() and path.parent == tnative.BUILD_DIR
    assert lib._name == str(path)
    centroids = np.random.default_rng(1).normal(size=(300, 3))
    got = tnative.build_clusters(centroids.astype(np.float32), 64)
    want = jnative.build_clusters(centroids.astype(np.float32), 64)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    img = (np.arange(8 * 5 * 3) % 256).astype(np.uint8).reshape(8, 5, 3)
    assert tnative.jpeg_write(str(tmp_path / "a.jpg"), img)
    assert (tmp_path / "a.jpg").read_bytes()[:2] == b"\xff\xd8"


@pytest.mark.parametrize("name", SCENE_FILES)
def test_casts_per_pixel_matches_jax(name):
    """The port's utils.profiling.casts_per_pixel (its own copy, so that
    Mcasts/s keeps the JAX package's unit) equals the JAX package's on
    every bundled scene and bounce depth."""
    from cutrace_tpu.scene.soa import scene_to_soa as jax_soa
    from cutrace_tpu.utils.profiling import casts_per_pixel as jcasts
    from cutrace_tpu_torch.scene.soa import scene_to_soa
    from cutrace_tpu_torch.utils.profiling import casts_per_pixel

    want_soa = jax_soa(jloader.load_scene(str(REPO / "scenes" / name)))
    got_soa = scene_to_soa(tloader.load_scene(str(REPO / "scenes" / name)),
                           device="cpu")
    for bounces in range(7):
        assert casts_per_pixel(got_soa, bounces) == jcasts(want_soa, bounces)


def test_no_cutrace_tpu_import_in_the_port():
    """No module of the port and nothing in chip_smoke.py imports the JAX
    package (not even its jax-free modules) or jax."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(cutrace_tpu|jax)(\s|\.|$)", re.MULTILINE)
    files = sorted((REPO / "cutrace_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) >= 20
    for name in ("sharding.py", "multihost.py", "train.py"):
        assert REPO / "cutrace_tpu_torch" / "parallel" / name in files
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders


def test_replay_vjp_has_no_float_atomics():
    """The replay backward kernel sums no float with an atomic, whose
    order would change the bits from run to run: every atomicAdd in
    csrc/replay_vjp.cu adds a 64-bit integer word (its exact sums), and
    no float atomic of another name (atomicAdd_block, atomicAdd_system)
    is there."""
    src = (REPO / "cutrace_tpu_torch" / "ops" / "csrc"
           / "replay_vjp.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    adds = re.findall(r"\batomic\w*\(([^;]*?)\);", code)
    assert len(adds) >= 4
    for args in adds:
        first, second = args.split(",", 1)
        assert "(u64)" in second or "flag" in args, args
    assert "atomicAdd_block" not in code and "atomicAdd_system" not in code
    assert not re.search(r"atomicAdd\(\s*\(float", code)


@pytest.mark.parametrize("entry", ["scene_to_soa", "soa_from_numpy",
                                   "params_from_numpy", "accel_from_numpy",
                                   "prepare", "render", "make_mesh",
                                   "initialize"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without device=, the entry points ask for the card: with no card
    they raise and never run on the CPU."""
    from cutrace_tpu_torch.ops import bvh as tbvh
    from cutrace_tpu_torch.parallel import multihost, sharding
    from cutrace_tpu_torch.render import renderer
    from cutrace_tpu_torch.scene import soa as tsoa

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = tloader.load_scene(str(REPO / "scenes" / "triangle.json"))
    leaves, meta = tsoa.numpy_leaves(sc)
    calls = {
        "scene_to_soa": lambda: tsoa.scene_to_soa(sc),
        "soa_from_numpy": lambda: tsoa.soa_from_numpy(leaves, meta),
        "params_from_numpy": lambda: tsoa.params_from_numpy(
            {"ambient": np.float32(0.1)}),
        "accel_from_numpy": lambda: tbvh.accel_from_numpy(
            np.zeros((1, 64), np.int32), np.ones((1, 64), bool)),
        "prepare": lambda: renderer.prepare(sc, accel="fused"),
        "render": lambda: renderer.render(sc, bounces=1),
        "make_mesh": lambda: sharding.make_mesh(1, 1),
        "initialize": lambda: multihost.initialize("localhost:1", 1, 0),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
