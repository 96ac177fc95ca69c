"""Port parity: cutrace_tpu_torch.ops.replay, the plain topology emitter of
ops.fused and ops.replay_vjp against the JAX package.

JAX's codes come from its fused kernel with emit_topo, run in interpret
mode as tests/test_replay.py runs it; JAX's backward reference is
jax.vjp of its replay_render_rays. Gates: the replay within 1e-5
(tests/test_replay.py:51-54), gradients under tests/test_replay_vjp.py's
isclose(rtol=2e-3, atol=2e-3 * scale), codes equal on the entries the
replay reads (canonical_codes below)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutrace_tpu.ops import replay as jreplay
from cutrace_tpu.ops.fused import _fused_forward
from cutrace_tpu.render import renderer as JR
from cutrace_tpu.scene.loader import load_scene
from cutrace_tpu_torch.ops import bvh as tbvh
from cutrace_tpu_torch.ops import fused as tfused
from cutrace_tpu_torch.ops import replay as treplay
from cutrace_tpu_torch.ops import replay_vjp as tvjp
from cutrace_tpu_torch.scene.soa import scene_to_soa
from test_torch_host import port_scene

torch.set_num_threads(2)

FUDGE = 1e-3
RTOL = 2e-3


@torch.no_grad()
def canonical_codes(soa, o, d, codes, fudge, bounces: int):
    """`codes` with -1 (flag 0 in opaque shadow rows) in every entry that
    cannot change the replay's result: nodes of weight 0 and their
    subtrees, the shadow rows of missed nodes, and march steps that did not
    count (the march had stopped, or the occluder lay at or beyond the
    light). The port's emitters write exactly this form; the JAX package's
    kernel leaves other values there, so its codes compare through this.
    It walks the tree as ops.replay.replay_render_rays does."""
    o0 = soa.scene_center
    out = codes.clone()
    per_light = 1 if not soa.any_transparent else soa.shadow_steps
    _, nodes = treplay.topo_layout(bounces, soa.any_reflective,
                                   soa.any_transparent, soa.n_lights,
                                   soa.shadow_steps)
    it = iter(nodes)
    table = treplay._packed_table(soa)
    r = o.shape[0]
    fudge_v = torch.full((r,), float(fudge), dtype=torch.float32,
                         device=o.device)
    unit_z = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                          device=o.device)
    n_rows = 1 + soa.n_lights * per_light

    def do_node(level, o3, d3, w, alive):
        _, cast_row, shadow_base = next(it)
        code = torch.where(alive, codes[:, cast_row], -1)
        out[:, cast_row] = code
        hit, t, rnorm, is_sp, mrow = treplay.hit_from_code(
            soa, o3, d3, code, fudge_v, o0, table)
        t_safe = torch.where(hit, t, 1.0)
        nd = treplay._normalize(d3)
        point = o3 + t_safe[:, None] * torch.where(is_sp[:, None], nd, d3)
        nrm = torch.where(hit[:, None], rnorm, unit_z[None, :])
        nn_l2 = treplay._dot(nrm, nrm)
        nn = nrm / torch.sqrt(torch.where(nn_l2 == 0.0, 1.0, nn_l2))[:, None]
        rows = slice(shadow_base, cast_row + n_rows)
        if per_light == 1:
            out[:, rows] = torch.where(hit[:, None], codes[:, rows], 0)
        else:
            for li in range(soa.n_lights):
                vec = soa.light_vec[li]
                is_sun = soa.light_kind[li] == 0
                diff = vec[None, :] - point
                dist = treplay._safe_len(treplay._dot(diff, diff))
                dsafe = torch.where(dist == 0.0, 1.0, dist)
                direction = torch.where(is_sun, -vec[None, :],
                                        diff / dsafe[:, None])
                distance = torch.where(is_sun, torch.inf, dist)
                dl = treplay._safe_len(treplay._dot(direction, direction))
                light_dist = distance * dl
                sdir = direction / torch.where(dl == 0.0, 1.0, dl)[:, None]
                sh = torch.zeros_like(light_dist)
                last = torch.zeros_like(light_dist)
                act = hit
                for si in range(per_light):
                    col = shadow_base + li * per_light + si
                    ccode = codes[:, col]
                    shit, st, _, _, srow = treplay.hit_from_code(
                        soa, point, sdir, ccode, last + 1e-3, o0, table)
                    okm = act & shit & torch.isfinite(st) & (st < light_dist)
                    out[:, col] = torch.where(okm, ccode, -1)
                    sh = sh + torch.where(
                        okm, 1.0 - srow[:, treplay._PK_TRANSP], 0.0)
                    last = torch.where(okm, st, last)
                    act = okm & (sh < 1.0)
        if level == bounces or not (soa.any_reflective
                                    or soa.any_transparent):
            return
        if soa.any_transparent:
            tr = mrow[:, treplay._PK_TRANSP]
            f = torch.where(hit & (tr >= treplay._EPS), tr, 0.0)
        else:
            f = torch.zeros_like(w)
        weff = w * (1.0 - f)
        child_o = o3 + t_safe[:, None] * d3
        if soa.any_reflective:
            refl = mrow[:, treplay._PK_REFL]
            rr = torch.where(hit & (refl >= treplay._EPS), refl, 0.0)
            rd = nd - 2.0 * treplay._dot(nd, nn)[:, None] * nn
            do_node(level + 1, child_o, rd, weff * rr, weff * rr != 0.0)
        if soa.any_transparent:
            do_node(level + 1, child_o, d3, w * f, w * f != 0.0)

    do_node(0, o, d, torch.ones((r,), dtype=torch.float32, device=o.device),
            torch.ones((r,), dtype=torch.bool, device=o.device))
    return out


class Case:
    """One scene at a small size through both packages: the JAX soa,
    partition and rays, and the port's on the CPU (same partition)."""

    def __init__(self, sc, bounces):
        self.bounces = bounces
        w, h = sc.camera.width, sc.camera.height
        jp = JR.prepare(sc, accel="fused")
        self.jsoa, self.jaccel = jp.soa, jp.accel
        idx = jnp.arange(w * h, dtype=jnp.int32)
        self.jo, self.jd = JR.camera_rays(self.jsoa, idx % w, idx // w)
        self.soa = scene_to_soa(port_scene(sc), device="cpu")
        self.accel = tbvh.accel_from_numpy(np.asarray(self.jaccel.order),
                                           np.asarray(self.jaccel.valid),
                                           device="cpu")
        self.o = torch.from_numpy(np.array(self.jo))
        self.d = torch.from_numpy(np.array(self.jd))

    def jax_codes(self):
        *_, codes = _fused_forward(self.jsoa, self.jaccel, self.jo, self.jd,
                                   FUDGE, self.bounces, emit_topo=True)
        return codes

    def port_codes(self):
        return tfused.emit_topo_plain(self.soa, self.accel, self.o, self.d,
                                      FUDGE, self.bounces)


def _case(scenes_dir, name, w, h, bounces):
    sc = load_scene(scenes_dir / name)
    sc.camera.width, sc.camera.height = w, h
    return Case(sc, bounces)


def _no_lights_scene(tmp_path):
    """tests/test_replay_vjp.py's zero-light scene (ambient-only)."""
    scene = {
        "camera": {"eye": [0, 1, -5], "up": [0, 1, 0], "look": [0, 1, 0],
                   "width": 16, "height": 8, "ambient": 0.4},
        "materials": [{"type": "solid", "color": [1.0, 0.7, 0.2],
                       "specular": 0.8, "reflect": 0.3, "phong": 50}],
        "lights": [],
        "objects": [
            {"type": "sphere", "material": 0, "center": [0, 1, 0],
             "radius": 0.8},
            {"type": "plane", "material": 0, "point": [0, -0.5, 0],
             "normal": [0, 1, 0]},
        ],
    }
    p = tmp_path / "no_lights.json"
    p.write_text(json.dumps(scene))
    return p


# JAX's interpret-mode kernel costs ~20 s per configuration here, so the
# two configurations that hold the port against JAX's codes are built
# once per module.
JAX_CODE_CASES = [("bunny.json", 24, 12, 2), ("sphere_plane.json", 24, 12, 2)]


@pytest.fixture(scope="module")
def jax_code_cases(request):
    root = request.config.rootpath / "scenes"
    out = {}
    for name, w, h, b in JAX_CODE_CASES:
        case = _case(root, name, w, h, b)
        out[name] = (case, case.jax_codes())
    return out


def test_topo_layout_matches_jax():
    for args in [(2, True, False, 4, 1), (3, True, True, 2, 3),
                 (5, True, True, 2, 3), (1, False, False, 0, 16),
                 (4, False, True, 1, 2)]:
        assert treplay.topo_layout(*args) == jreplay.topo_layout(*args)


@pytest.mark.parametrize("name", [c[0] for c in JAX_CODE_CASES])
def test_replay_matches_jax_on_jax_codes(jax_code_cases, name):
    """The port's replay of JAX's codes reproduces JAX's replay."""
    case, codes = jax_code_cases[name]
    want = jreplay.replay_render_rays(case.jsoa, case.jo, case.jd, codes,
                                      jnp.float32(FUDGE), case.bounces)
    got = treplay.replay_render_rays(case.soa, case.o, case.d,
                                     torch.from_numpy(np.array(codes)),
                                     FUDGE, case.bounces)
    for label, g, w in zip(("color", "depth", "normal"), got, want):
        g, w = g.numpy(), np.asarray(w)
        both_inf = np.isinf(g) & np.isinf(w)
        err = np.abs(np.where(both_inf, 0.0, g) - np.where(both_inf, 0.0,
                                                            w)).max()
        assert err < 1e-5, (label, err)


@pytest.mark.parametrize("name", [c[0] for c in JAX_CODE_CASES])
def test_plain_emitter_matches_jax_codes(jax_code_cases, name):
    """The port's plain emitter writes JAX's codes on every entry the
    replay reads, and -1 (flag 0) on every other entry."""
    case, codes = jax_code_cases[name]
    want = canonical_codes(case.soa, case.o, case.d,
                                   torch.from_numpy(np.array(codes)), FUDGE,
                                   case.bounces)
    got = case.port_codes()
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (case.o.shape[0],
                                treplay.replay_rows(case.soa, case.bounces))
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,w,h,bounces", [
    ("triangle.json", 24, 12, 2),
    ("bunny.json", 24, 12, 2),
    ("mirror.json", 24, 12, 2),
    ("sphere_plane.json", 24, 12, 3),
])
def test_plain_codes_are_canonical(scenes_dir, name, w, h, bounces):
    """Every entry the emitter writes is one the replay reads, and the
    fused forward with emit_topo on CPU tensors returns those codes beside
    its plain forward's values."""
    case = _case(scenes_dir, name, w, h, bounces)
    codes = case.port_codes()
    assert torch.equal(
        canonical_codes(case.soa, case.o, case.d, codes, FUDGE,
                                bounces), codes)
    c, dep, nrm, codes2 = tfused.fused_render_rays(
        case.soa, case.accel, case.o, case.d, FUDGE, bounces,
        emit_topo=True)
    assert torch.equal(codes, codes2)
    plain = tfused.fused_render_rays_plain(case.soa, case.accel, case.o,
                                           case.d, FUDGE, bounces)
    for a, b in zip((c, dep, nrm), plain):
        assert torch.equal(a, b)


def _check(label, a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.isfinite(a).all() and np.isfinite(b).all(), label
    scale = max(np.abs(a).max(), np.abs(b).max(), 1e-12)
    ok = np.isclose(a, b, rtol=rtol, atol=rtol * scale)
    assert ok.all(), (f"{label}: {(~ok).sum()}/{a.size} mismatch, max "
                      f"|diff| {np.abs(a - b).max():.3e} at scale {scale:.3e}")


def _vjp_case(case, seed=0):
    """The port's plain codes through JAX's replay vjp and the port's
    replay_vjp on the same numpy-seeded cotangents (depth cotangents zero
    on misses, as tests/test_replay_vjp.py does)."""
    codes = case.port_codes()
    jcodes = jnp.asarray(codes.numpy())
    r = case.o.shape[0]
    rng = np.random.default_rng(seed)
    cot = [rng.normal(size=s).astype(np.float32)
           for s in ((r, 3), (r,), (r, 3))]
    _, dep, _ = jreplay.replay_render_rays(case.jsoa, case.jo, case.jd,
                                           jcodes, jnp.float32(FUDGE),
                                           case.bounces)
    cot[1] = np.where(np.isfinite(np.asarray(dep)), cot[1], 0.0).astype(
        np.float32)
    _, vjp = jax.vjp(
        lambda s, oo, dd: jreplay.replay_render_rays(
            s, oo, dd, jcodes, jnp.float32(FUDGE), case.bounces),
        case.jsoa, case.jo, case.jd)
    ref_soa, ref_o, ref_d = vjp(tuple(jnp.asarray(c) for c in cot))
    got_soa, got_o, got_d = tvjp.replay_vjp(
        case.soa, case.o, case.d, codes,
        tuple(torch.from_numpy(c) for c in cot), FUDGE, case.bounces)
    return ref_soa, ref_o, ref_d, got_soa, got_o, got_d


@pytest.mark.parametrize("name,w,h,bounces", [
    ("triangle.json", 24, 24, 2),
    ("bunny.json", 32, 16, 2),
    ("mirror.json", 32, 16, 2),
    ("sphere_plane.json", 32, 16, 3),
])
def test_replay_vjp_matches_jax_vjp(scenes_dir, name, w, h, bounces):
    """replay_vjp (torch autograd of the replay, routed to the leaves)
    against jax.vjp of JAX's replay, for every non-camera parameter group
    and for o and d."""
    case = _case(scenes_dir, name, w, h, bounces)
    ref_soa, ref_o, ref_d, got_soa, got_o, got_d = _vjp_case(case)
    assert set(got_soa) == set(tvjp.TABLE_FIELDS)
    for f in tvjp.TABLE_FIELDS:
        _check(f, getattr(ref_soa, f), got_soa[f].numpy())
    _check("o", ref_o, got_o.numpy())
    _check("d", ref_d, got_d.numpy())


def test_zero_light_scene_vjp(tmp_path):
    """A scene without lights keeps the padded (1, 8) light table, and its
    gradients match JAX's."""
    sc = load_scene(_no_lights_scene(tmp_path))
    case = Case(sc, 2)
    assert case.soa.n_lights == 0
    _, lights, _ = tvjp.backward_tables(case.soa)
    assert tuple(lights.shape) == (1, 8)
    ref_soa, ref_o, ref_d, got_soa, got_o, got_d = _vjp_case(case, seed=1)
    for f in ("sp_center", "sp_radius", "mat_color", "ambient", "pl_point"):
        _check(f, getattr(ref_soa, f), got_soa[f].numpy())
    _check("o", ref_o, got_o.numpy())
    _check("d", ref_d, got_d.numpy())
    assert np.abs(got_soa["mat_color"].numpy()).max() > 0


def test_replay_vjp_scope_and_contract(scenes_dir):
    """The kernel's scope (lights, nodes) and the plain version's
    cotangent shapes: the table (N, 17), lights (L, 8), ambient (1,)."""
    case = _case(scenes_dir, "bunny.json", 8, 4, 2)
    assert tvjp.replay_vjp_supported(case.soa, 5)
    assert tfused.replay_supported(case.soa, case.accel, 5, n_rays=1920 *
                                   1080)
    assert not tfused.replay_supported(case.soa, None, 5)
    sp = _case(scenes_dir, "sphere_plane.json", 8, 4, 2)
    assert treplay.replay_rows(sp.soa, 5) == 441
    assert tvjp.replay_vjp_supported(sp.soa, 5)
    assert not tvjp.replay_vjp_supported(sp.soa, 6)
    assert not tfused.replay_supported(sp.soa, sp.accel, 5,
                                       n_rays=4 * 1920 * 1080)
    table, lights, ambient = tvjp.backward_tables(case.soa)
    n = 1000 + 5 + 1
    assert tuple(table.shape) == (n, 17) and tuple(lights.shape) == (4, 8)
    codes = case.port_codes()
    grads = tvjp.vjp_tables(case.soa, table, lights, ambient, case.o,
                            case.d, codes, (None, None, None), FUDGE, 2)
    for g, x in zip(grads, (table, lights, ambient, case.o, case.d)):
        assert g.shape == x.shape and not g.any()
