"""The replay backward's (K2's) fixed-order sums on the CPU.

K2 sums its parameter cotangents exactly in fixed point
(`ops.replay_vjp.exact_sum`, csrc/replay_vjp.cu split / exact_value): the
plain version `exact_sum_plain` is held here to the exactly rounded sum,
to itself with its terms shuffled, and to Python emulations of the
kernel's two device functions. The material columns of the packed table
(`ops.replay._packed_table`) route their gradients through a fixed-order
sum; they are held to index_select's and to jax.vjp of the JAX package's
table. The kernel itself runs only on the card (chip_smoke.py holds it,
and `exact_sum`, to these plain versions there)."""

import dataclasses
import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cutrace_tpu.ops import replay as jreplay
from cutrace_tpu.scene.loader import load_scene
from cutrace_tpu.scene.soa import scene_to_soa as jax_scene_to_soa
from cutrace_tpu_torch.ops import _build
from cutrace_tpu_torch.ops import replay as treplay
from cutrace_tpu_torch.ops import replay_vjp as tvjp
from cutrace_tpu_torch.scene.soa import scene_to_soa
from test_torch_host import port_scene
from test_torch_replay import FUDGE, _case

torch.set_num_threads(2)

SETTINGS = settings(max_examples=150, deadline=None, derandomize=True,
                    database=None)
FLOATS = st.floats(width=32, allow_nan=False, allow_infinity=False)
MAT_FIELDS = ("mat_color", "mat_specular", "mat_reflect", "mat_phong",
              "mat_transparency")


def _grid(v) -> int:
    """A float on the grid 2**-64, ties to even, as an exact integer."""
    return round(Fraction(float(v)) * 2 ** tvjp._GRID_EXP)


def _rounded(n: int) -> float:
    """The float32 nearest (ties to even) to n * 2**-64, from Fraction."""
    if n == 0:
        return 0.0
    x = Fraction(abs(n), 2 ** tvjp._GRID_EXP)
    e = math.floor(math.log2(x))
    while Fraction(2) ** e > x:
        e -= 1
    while Fraction(2) ** (e + 1) <= x:
        e += 1
    ulp = Fraction(2) ** (e - 23)
    q, rem = divmod(x, ulp)
    if rem > ulp / 2 or (rem == ulp / 2 and q % 2):
        q += 1
    f = float(q * ulp) if q * ulp < Fraction(2) ** 128 else math.inf
    return -f if n < 0 else f


def _bits(t):
    return t.contiguous().view(torch.int32)


@SETTINGS
@given(st.lists(st.tuples(st.integers(0, 3), FLOATS), min_size=1,
                max_size=60), st.randoms(use_true_random=False))
def test_exact_sum_does_not_depend_on_order(terms, rnd):
    """The same terms shuffled give the same bits."""
    idx = torch.tensor([i for i, _ in terms])
    val = torch.tensor([v for _, v in terms], dtype=torch.float32)
    perm = list(range(len(terms)))
    rnd.shuffle(perm)
    a = tvjp.exact_sum_plain(idx, val, 4)
    b = tvjp.exact_sum_plain(idx[perm], val[perm], 4)
    assert torch.equal(_bits(a), _bits(b))


@SETTINGS
@given(st.lists(st.tuples(st.integers(-80, 100), st.floats(-1.0, 1.0,
                                                           width=32)),
                min_size=1, max_size=40))
def test_exact_sum_is_the_rounded_exact_sum(terms):
    """Every term on the grid 2**-64 (ties to even), summed exactly and
    rounded once to float32, ties to even: the sum is exact where float
    atomics round at every add."""
    vals = np.array([np.float32(m) * np.float32(2.0 ** e) for e, m in terms],
                    np.float32)
    idx = torch.zeros(len(vals), dtype=torch.int64)
    got = float(tvjp.exact_sum_plain(idx, torch.from_numpy(vals), 1)[0])
    assert got == _rounded(sum(_grid(v) for v in vals))


@SETTINGS
@given(FLOATS)
def test_exact_sum_round_trip(v):
    """One term comes back as itself from 2**-40 on (its grid value is an
    integer), and within half a grid step (2**-65) below."""
    got = float(tvjp.exact_sum_plain(torch.zeros(1, dtype=torch.int64),
                                     torch.tensor([v], dtype=torch.float32),
                                     1)[0])
    if abs(v) >= 2.0 ** -40:
        assert np.float32(got) == np.float32(v)
    else:
        assert abs(got - float(np.float32(v))) <= 2.0 ** -65


@pytest.mark.parametrize("seed", [0, 1])
def test_exact_sum_within_the_k2_gate(seed):
    """K2-like sums (normal cotangents over 5 decades, 2,000 terms into 17
    elements, cancelling): within the K2 gate (rtol 2e-3, atol 2e-3 *
    scale) of the float64 sum, and in fact within one float32 rounding."""
    rng = np.random.default_rng(seed)
    vals = (rng.normal(size=2000) * 10.0 ** rng.uniform(-6, -1, 2000)
            ).astype(np.float32)
    idx = rng.integers(0, 17, 2000)
    got = tvjp.exact_sum_plain(torch.from_numpy(idx), torch.from_numpy(vals),
                               17).double().numpy()
    want = np.zeros(17)
    np.add.at(want, idx, vals.astype(np.float64))
    scale = np.abs(want).max()
    assert np.isclose(got, want, rtol=2e-3, atol=2e-3 * scale).all()
    assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -24 + 1e-30).all()


def test_exact_sum_special_values():
    """NaN, or +inf and -inf together, give NaN; one infinity gives that
    infinity; a finite sum past float32's range gives inf, as a float sum
    would; terms under half a grid step, subnormals and zeros add
    nothing; an element without terms is +0."""
    inf, nan = np.inf, np.nan
    groups = [[inf, 1.0], [-inf, -2.0], [nan, 1.0], [inf, -inf],
              [3e38, 3e38], [2.0 ** -65, 1e-45, -0.0], [2.0 ** -65 * 3], []]
    idx = [i for i, g in enumerate(groups) for _ in g]
    vals = torch.tensor([v for g in groups for v in g], dtype=torch.float32)
    got = tvjp.exact_sum_plain(torch.tensor(idx), vals, len(groups))
    assert got[0] == inf and got[1] == -inf and got[4] == inf
    assert math.isnan(got[2]) and math.isnan(got[3])
    assert got[5] == 0.0 and float(got[6]) == 2.0 ** -63
    assert _bits(got[7:]).item() == 0


def test_exact_sum_raises_past_its_bound(monkeypatch, scenes_dir):
    """Past MAX_TERMS terms a sum's words could wrap: the plain version
    and the kernel's wrappers raise before adding anything (K2 past
    MAX_TERMS codes too)."""
    monkeypatch.setattr(tvjp, "MAX_TERMS", 4)
    idx = torch.zeros(5, dtype=torch.int64)
    with pytest.raises(ValueError, match="terms for one exact sum"):
        tvjp.exact_sum_plain(idx, torch.ones(5), 1)
    assert tvjp.exact_sum_plain(idx[:4], torch.ones(4), 1).item() == 4.0
    monkeypatch.setattr(_build, "load_library", lambda name: pytest.fail(
        "the kernel was reached"))
    with pytest.raises(ValueError, match="terms for one exact sum"):
        tvjp._exact_sum_cuda(idx.int(), torch.ones(5), 1)
    case = _case(scenes_dir, "bunny.json", 8, 4, 1)
    table, lights, ambient = tvjp.backward_tables(case.soa)
    with pytest.raises(ValueError, match="terms for one exact sum"):
        tvjp._replay_vjp_cuda(case.soa, table, lights, ambient, case.o,
                              case.d, case.port_codes(), (None,) * 3,
                              FUDGE, 1)


def _split_scalar(v):
    """csrc/replay_vjp.cu split, line by line, for one float32."""
    b = int(np.float32(v).view(np.uint32))
    ex = (b >> 23) & 0xFF
    if ex == 0xFF:
        return None, (1 if b & 0x7FFFFF else (4 if b >> 31 else 2))
    if ex == 0:
        return None, 0
    m = (b & 0x7FFFFF) | 0x800000
    s = ex - 150 + tvjp._GRID_EXP
    if s < 0:
        k = -s
        if k > 24:
            return None, 0
        q, rem, half = m >> k, m & ((1 << k) - 1), 1 << (k - 1)
        m = q + (1 if rem > half or (rem == half and q & 1) else 0)
        if m == 0:
            return None, 0
        s = 0
    w = m << (s & 31)
    lo, hi = w & 0xFFFFFFFF, w >> 32
    sign = -1 if b >> 31 else 1
    return (s >> 5, sign * lo, sign * hi), 0


@SETTINGS
@given(st.lists(st.floats(width=32), min_size=1, max_size=50))
def test_split_matches_the_kernel(vals):
    """The plain version's vectorized split cuts every float as the
    kernel's split does, specials included; no term reaches past the
    sixth limb, and a limb part stays under 2**32."""
    limb, lo, hi, flag = tvjp._split(torch.tensor(vals, dtype=torch.float32))
    for i, v in enumerate(vals):
        parts, f = _split_scalar(v)
        assert int(flag[i]) == f
        if parts is None:
            assert int(lo[i]) == int(hi[i]) == 0
            continue
        assert (int(limb[i]), int(lo[i]), int(hi[i])) == parts
        assert parts[0] + (parts[2] != 0) < tvjp._WORDS
        assert abs(parts[1]) < 2 ** 32 and abs(parts[2]) < 2 ** 23


def _exact_value_kernel(words):
    """csrc/replay_vjp.cu exact_value, line by line, for finite sums:
    carries into 32-bit digits, the magnitude, a 64-bit window at the top
    digit, round to nearest even by the half bit and the sticky bits."""
    n_w = tvjp._WORDS
    d, c = [], 0
    for w in words:
        t = w + c
        d.append(t & 0xFFFFFFFF)
        c = t >> 32
    d.append(c & 0xFFFFFFFF)
    neg = c < 0
    if neg:
        carry = 1
        for i in range(n_w + 1):
            t = (~d[i] & 0xFFFFFFFF) + carry
            d[i], carry = t & 0xFFFFFFFF, t >> 32
    j = n_w
    while j >= 0 and d[j] == 0:
        j -= 1
    if j < 0:
        return 0.0
    p = d[j].bit_length() - 1
    win = (d[j] << 32) | (d[j - 1] if j > 0 else 0)
    q = win >> (p + 9)
    half = (win >> (p + 8)) & 1
    sticky = (win & ((1 << (p + 8)) - 1)) != 0 or any(d[:max(j - 1, 0)])
    e2 = 32 * (j - 1) + p + 9 - tvjp._GRID_EXP
    if half and (sticky or q & 1):
        q += 1
        if q == 1 << 24:
            q, e2 = q >> 1, e2 + 1
    f = float(np.float32(math.ldexp(q, e2))) if e2 + 24 <= 128 else math.inf
    return -f if neg else f


@SETTINGS
@given(st.lists(st.integers(-(2 ** 62), 2 ** 62), min_size=6, max_size=6),
       st.integers(0, 6))
def test_exact_value_matches_the_kernel(words, top):
    """The kernel's rounding of six signed words (each a sum of up to
    2**30 parts under 2**32) equals the plain version's exact one, with
    the higher words zeroed from `top` on to reach every digit."""
    words = [w if i < top else 0 for i, w in enumerate(words)]
    assert _exact_value_kernel(words) == tvjp._exact_value(words, 0)


def _index_select_table(soa):
    """_packed_table as it was: the material columns by index_select,
    whose backward is index_add_."""
    mats = torch.cat([soa.mat_color, soa.mat_specular[:, None],
                      soa.mat_reflect[:, None], soa.mat_phong[:, None],
                      soa.mat_transparency[:, None]], dim=1)
    t = soa.tri_p1.shape[0]
    p = soa.pl_point.shape[0]
    s = soa.sp_center.shape[0]
    z = lambda n, k: torch.zeros((n, k))  # noqa: E731
    sel = lambda idx: torch.index_select(mats, 0, idx.long())  # noqa: E731
    return torch.cat([
        torch.cat([soa.tri_p1, soa.tri_p2, soa.tri_p3, z(t, 1),
                   sel(soa.tri_mat)], 1),
        torch.cat([soa.pl_point, soa.pl_normal, z(p, 4), sel(soa.pl_mat)], 1),
        torch.cat([soa.sp_center, soa.sp_radius[:, None], z(s, 6),
                   sel(soa.sp_mat)], 1)])


@pytest.mark.parametrize("name", ["bunny.json", "mirror.json",
                                  "sphere_plane.json"])
def test_material_routing_gradients(scenes_dir, name):
    """The bundled scenes with more than one material: the packed table's
    gradients at the five material leaves, through its fixed-order routing,
    equal index_select's and jax.vjp of the JAX package's table
    constructor within float32 reassociation (the same sums of up to 1,000
    unit cotangents in another order: rtol 1e-4, atol 1e-4 * scale); the
    tables themselves are bit-identical."""
    sc = load_scene(scenes_dir / name)
    soa = scene_to_soa(port_scene(sc), device="cpu")
    assert soa.mat_color.shape[0] > 1
    leaves = {k: getattr(soa, k).detach().clone().requires_grad_()
              for k in MAT_FIELDS}
    live = dataclasses.replace(soa, **leaves)
    rng = np.random.default_rng(11)
    table = treplay._packed_table(live)
    cot = torch.from_numpy(rng.normal(size=table.shape).astype(np.float32))
    got = torch.autograd.grad(table, list(leaves.values()), cot)
    old = _index_select_table(live)
    assert torch.equal(_bits(table.detach()), _bits(old.detach()))
    want = torch.autograd.grad(old, list(leaves.values()), cot)

    jsoa = jax_scene_to_soa(sc)

    def jtable(*mats):
        return jreplay._packed_table(dataclasses.replace(
            jsoa, **dict(zip(MAT_FIELDS, mats))))

    jout, vjp = jax.vjp(jtable, *(getattr(jsoa, k) for k in MAT_FIELDS))
    np.testing.assert_array_equal(np.asarray(jout), table.detach().numpy())
    jgrads = vjp(jnp.asarray(cot.numpy()))
    for k, a, b, c in zip(MAT_FIELDS, got, want, jgrads):
        a, b, c = a.double().numpy(), b.double().numpy(), np.asarray(
            c, np.float64)
        scale = max(np.abs(b).max(), 1e-12)
        for other in (b, c):
            assert np.allclose(a, other, rtol=1e-4, atol=1e-4 * scale), k


def test_material_routing_repeats_bit_for_bit(scenes_dir):
    """Two backward passes of the routing give the same bits (its sum has
    one fixed order), equal to index_add_'s within float32 reassociation
    (rtol 1e-4, atol 1e-4 * scale)."""
    sc = load_scene(scenes_dir / "bunny.json")
    soa = scene_to_soa(port_scene(sc), device="cpu")
    rng = np.random.default_rng(5)
    mats = torch.from_numpy(rng.normal(size=(soa.mat_color.shape[0], 7))
                            .astype(np.float32)).requires_grad_()
    idx = soa.tri_mat.long()
    cot = torch.from_numpy(rng.normal(size=(idx.shape[0], 7))
                           .astype(np.float32))
    rows = treplay._MaterialRows.apply(mats, idx)
    assert torch.equal(rows, mats[idx])
    a, = torch.autograd.grad(rows, mats, cot, retain_graph=True)
    b, = torch.autograd.grad(rows, mats, cot)
    assert torch.equal(_bits(a), _bits(b))
    want = torch.zeros_like(mats).index_add_(0, idx, cot)
    assert torch.allclose(a, want, rtol=1e-4, atol=1e-4 * want.abs().max())
