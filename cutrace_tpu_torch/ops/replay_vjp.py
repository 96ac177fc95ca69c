"""The replay backward: fixed-topology gradients from topology codes
(counterpart of cutrace_tpu.ops.replay_vjp).

The vector-Jacobian product of ops.replay.replay_render_rays for given
codes and output cotangents. On CUDA tensors it launches the hand-written
Hopper kernel in `csrc/replay_vjp.cu` (any bounce tree of at most
MAX_NODES nodes), in the instance `vjp_instance` picks before the launch
(where the table cotangent's rows are summed: shared or global memory); on
CPU tensors it runs the plain version, torch autograd of the replay. The
kernel sums its parameter cotangents exactly in fixed point (`exact_sum`,
whose plain version is `exact_sum_plain`) and rounds each sum once, so the
same inputs give the same bits whatever order its blocks run in. Both consume the small tensors the
backward differentiates: the packed table recentered by the scene center
(`_recentered_table`, (N, 17)), the light table (`_light_table_diff`,
(L, 8)) and the ambient term. Their cotangents reach the scene leaves by
torch autograd through those constructors, as `park` does in the JAX
package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from cutrace_tpu_torch.ops import replay as rp
from cutrace_tpu_torch.utils import tracing

# Kernel launches of the replay backward on CUDA tensors since import, or
# since a caller last reset it.
LAUNCHES = 0
# The kernel's scope: lights and bounce-tree nodes.
MAX_LIGHTS = 8
MAX_NODES = 63
_BLOCK = 256  # the kernel's threads a block
# Rays are padded to a multiple of this: the fused forward's own padding
# (ops.fused._BLOCK), so its code buffer is taken as it is.
_PAD = 128
# Shared-memory bytes a block may take for its sums and still share an
# H100 multiprocessor (228 KB, 1 KB reserved a block) with a second one;
# table rows past it are summed in global memory.
SHARED_SUMS_MAX = 112 * 1024
# The kernel's exact sums (csrc/replay_vjp.cu split, exact_value): a float
# term goes in on the grid 2**-_GRID_EXP, as _WORDS limbs of 32 bits, each
# kept in an int64 word; every finite float32 fits. A word takes at most
# MAX_TERMS terms, each under 2**32, so it cannot wrap. A launch adds at
# most one term a code row of a live ray (vjp_terms): padding rays carry
# code -1 and add none.
_WORDS = 6
_GRID_EXP = 64
MAX_TERMS = 1 << 30
_NAN, _POS_INF, _NEG_INF = 1, 2, 4  # flag bits of a sum

# The scene leaves the backward's tables are built from: every
# differentiable field but the camera's, which reach the rays instead.
TABLE_FIELDS = (
    "tri_p1", "tri_p2", "tri_p3", "pl_point", "pl_normal", "sp_center",
    "sp_radius", "mat_color", "mat_specular", "mat_reflect", "mat_phong",
    "mat_transparency", "light_vec", "light_color", "ambient",
)


def replay_vjp_supported(soa, bounces: int) -> bool:
    """Is this configuration inside the kernel's scope: at most MAX_LIGHTS
    lights, MAX_NODES tree nodes and REPLAY_MAX_ROWS topo rows? There is no
    primitive cap: gathers are plain loads."""
    rows, nodes = rp.topo_layout(bounces, soa.any_reflective,
                                 soa.any_transparent, soa.n_lights,
                                 soa.shadow_steps)
    return (soa.n_lights <= MAX_LIGHTS and len(nodes) <= MAX_NODES
            and rows <= rp.REPLAY_MAX_ROWS)


@dataclasses.dataclass(frozen=True)
class VjpInstance:
    """The kernel's instance for a scene and bounce depth."""

    nodes: int  # bounce-tree nodes
    sums: str  # "shared": every table row summed in shared memory
    block: int  # threads a block
    shared_bytes: int  # dynamic shared memory a block
    shared_from: int  # the first table row summed in shared memory


def vjp_instance(soa, bounces: int) -> VjpInstance:
    """Which instance runs the backward, decided before the launch: the
    table rows from `shared_from` on are summed in a block's shared memory
    (each row's 17 exact sums, _WORDS words each), the rest in global
    memory; the block's shared bytes (one light column a thread, then
    those rows) stay within SHARED_SUMS_MAX. Every row when they fit
    ("shared"), else the planes' and spheres', the rows most rays hit,
    else none ("global"). Raises NotImplementedError past the kernel's
    scope; nothing falls back to the plain version."""
    rows, nodes = rp.topo_layout(bounces, soa.any_reflective,
                                 soa.any_transparent, soa.n_lights,
                                 soa.shadow_steps)
    if not replay_vjp_supported(soa, bounces):
        raise NotImplementedError(
            f"replay backward of {soa.n_lights} lights, {len(nodes)} tree "
            f"nodes and {rows} topo rows at bounce depth {bounces}: the "
            f"kernel covers at most {MAX_LIGHTS} lights, {MAX_NODES} tree "
            f"nodes and {rp.REPLAY_MAX_ROWS} topo rows; a fit past them "
            f"takes the composable backward (fused_render_rays under "
            f"autograd)")
    t = soa.tri_p1.shape[0]
    n_tab = t + soa.pl_point.shape[0] + soa.sp_center.shape[0]
    columns = 4 * (6 * soa.n_lights + 1) * _BLOCK
    row = 8 * 17 * _WORDS
    lo = next(lo for lo in (0, t, n_tab)
              if columns + row * (n_tab - lo) <= SHARED_SUMS_MAX)
    return VjpInstance(nodes=len(nodes),
                       sums="shared" if lo == 0 else "global", block=_BLOCK,
                       shared_bytes=columns + row * (n_tab - lo),
                       shared_from=lo)


def _recentered_table(soa, o0):
    """The replay's packed table with positions recentered by o0, as
    hit_from_code subtracts them per kind: triangles columns 0:9, planes
    and spheres columns 0:3. Differentiable in the scene leaves (o0 is
    detached by the caller)."""
    tbl = rp._packed_table(soa)
    return tbl - _position_offset(soa, o0)


def _position_offset(soa, o0):
    """(N, 17) rows holding o0 where the packed table holds positions."""
    t = soa.tri_p1.shape[0]
    adj = torch.zeros((t + soa.pl_point.shape[0] + soa.sp_center.shape[0],
                       17), dtype=torch.float32, device=o0.device)
    adj[:t, 0:9] = o0.repeat(3)
    adj[t:, 0:3] = o0
    return adj


def _light_table_diff(soa, o0):
    """(L, 8) light rows [kind, vx, vy, vz, cr, cg, cb, 0], point-light
    positions recentered by o0, differentiable in light_vec and
    light_color (the padded (1, 8) row of a scene without lights too)."""
    kind = soa.light_kind.to(torch.float32)[:, None]
    is_sun = (soa.light_kind == 0)[:, None]
    vec = torch.where(is_sun, soa.light_vec, soa.light_vec - o0)
    pad = torch.zeros_like(kind)
    return torch.cat([kind, vec, soa.light_color, pad], dim=1)


def backward_tables(soa):
    """(table, lights, ambient): the differentiable inputs of the backward,
    built from the scene leaves by differentiable torch ops."""
    o0 = soa.scene_center.detach()
    return (_recentered_table(soa, o0), _light_table_diff(soa, o0),
            soa.ambient.reshape(1))


def _replay_scene(soa, table, lights, ambient):
    """The replay's inputs rebuilt from the backward's tables: a scene
    whose lights and ambient are views of `lights` and `ambient`, and the
    packed table in world coordinates."""
    o0 = soa.scene_center.detach()
    is_sun = (soa.light_kind == 0)[:, None]
    vec = lights[:, 1:4]
    view = dataclasses.replace(
        soa, light_vec=torch.where(is_sun, vec, vec + o0),
        light_color=lights[:, 4:7], ambient=ambient.reshape(()))
    return view, table + _position_offset(soa, o0)


def _zeros_for_none(cot, o):
    g_c, g_dep, g_n = cot
    r = o.shape[0]
    z = dict(dtype=torch.float32, device=o.device)
    return (torch.zeros((r, 3), **z) if g_c is None else g_c,
            torch.zeros((r,), **z) if g_dep is None else g_dep,
            torch.zeros((r, 3), **z) if g_n is None else g_n)


def replay_vjp_plain(soa, table, lights, ambient, o, d, codes, cot, fudge,
                     bounces: int):
    """The plain version of the kernel: torch autograd of the replay.
    Returns the cotangents of (table, lights, ambient, o, d)."""
    cot = _zeros_for_none(cot, o)
    with torch.enable_grad():
        ins = [x.detach().requires_grad_()
               for x in (table, lights, ambient, o, d)]
        view, world = _replay_scene(soa, *ins[:3])
        outs = rp.replay_render_rays(view, ins[3], ins[4], codes, fudge,
                                     bounces, table=world)
        grads = torch.autograd.grad(outs, ins, cot, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(ins, grads))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def vjp_terms(soa, bounces: int, n_rays: int) -> int:
    """The most terms one exact sum of a replay-backward launch over
    `n_rays` live rays can take: one a code row of a ray. The launch's
    padding rays carry code -1 and add none, so this is the count that
    ops.fused.replay_supported bounds (rows * n_rays * 4 bytes of codes)."""
    return rp.replay_rows(soa, bounces) * n_rays


def _check_terms(n: int):
    if n > MAX_TERMS:
        raise ValueError(f"{n} terms for one exact sum: at most {MAX_TERMS} "
                         f"(2**30), past which an int64 word could wrap")


def _acc(n_el: int, device, n_tab: int = 0):
    """The kernel's zeroed accumulator: n_el sums of _WORDS int64 words,
    then n_el 32-bit flags, then n_tab bytes (the table rows touched)."""
    return torch.zeros((n_el * _WORDS + -(-(4 * n_el + n_tab) // 8),),
                       dtype=torch.int64, device=device)


def _split(values):
    """The fixed-point parts of float32 values, as the kernel's split cuts
    them: (limb, lo, hi, flag), int64; lo and hi zero where a value adds
    nothing (zero, subnormal, under half a grid step, NaN or infinity)."""
    b = values.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ex = (b >> 23) & 0xFF
    frac = b & 0x7FFFFF
    neg = (b >> 31) == 1
    flag = torch.where(ex == 255, torch.where(
        frac != 0, _NAN, torch.where(neg, _NEG_INF, _POS_INF)), 0)
    m = frac | 0x800000
    s = ex - 150 + _GRID_EXP
    k = (-s).clamp(1, 25)  # a shift of 25 leaves nothing, as k > 24 does
    q = m >> k
    rem = m & ((torch.ones_like(k) << k) - 1)
    half = torch.ones_like(k) << (k - 1)
    up = (rem > half) | ((rem == half) & ((q & 1) == 1))
    m = torch.where(s < 0, q + up.to(torch.int64), m)
    s = s.clamp(min=0)
    live = (ex != 0) & (ex != 255) & (m != 0)
    w = torch.where(live, m, 0) << (s & 31)
    sign = torch.where(neg, -1, 1)
    return s >> 5, (w & 0xFFFFFFFF) * sign, (w >> 32) * sign, flag


def _exact_value(words, flag) -> float:
    """The float32 nearest (ties to even) to sum(words[i] * 2**(32 i)) *
    2**-_GRID_EXP, or the float sum's NaN or infinity by `flag`."""
    if flag & _NAN or flag & (_POS_INF | _NEG_INF) == _POS_INF | _NEG_INF:
        return float("nan")
    if flag & _POS_INF:
        return float("inf")
    if flag & _NEG_INF:
        return float("-inf")
    n = sum(int(w) << (32 * i) for i, w in enumerate(words))
    mag = abs(n)
    e = -_GRID_EXP
    if mag.bit_length() > 24:
        shift = mag.bit_length() - 24
        q, rem = mag >> shift, mag & ((1 << shift) - 1)
        half = 1 << (shift - 1)
        mag = q + (rem > half or (rem == half and q & 1))
        e += shift
    if mag.bit_length() + e > 128:
        f = math.inf  # past float32's range, as a float sum overflows
    else:
        f = float(np.float32(math.ldexp(mag, e))) if mag else 0.0
    return -f if n < 0 else f


def exact_sum_plain(index, values, n_el: int):
    """The plain version of the kernel's sums (`exact_sum`): float32
    `values` summed into n_el elements by `index`, each sum exact on the
    grid 2**-_GRID_EXP (a term below it rounded to the grid, ties to even)
    and rounded once to float32, ties to even; a NaN, or +inf and -inf
    together, gives NaN, an infinity that infinity. Integer sums, so the
    result does not depend on the order of the terms. Raises ValueError
    past MAX_TERMS terms."""
    _check_terms(values.numel())
    index = index.reshape(-1).to(torch.int64).cpu()
    limb, lo, hi, flag = _split(values.reshape(-1).cpu())
    words = torch.zeros((n_el * _WORDS,), dtype=torch.int64)
    words.index_add_(0, index * _WORDS + limb, lo)
    words.index_add_(0, index * _WORDS + (limb + 1).clamp(max=_WORDS - 1),
                     hi)
    flags = torch.zeros((n_el,), dtype=torch.int64)
    for bit in (_NAN, _POS_INF, _NEG_INF):
        seen = torch.zeros((n_el,), dtype=torch.int64)
        seen.index_add_(0, index, (flag & bit != 0).to(torch.int64))
        flags |= torch.where(seen > 0, bit, 0)
    words = words.reshape(n_el, _WORDS).tolist()
    out = [_exact_value(w, f) for w, f in zip(words, flags.tolist())]
    return torch.tensor(out, dtype=torch.float32).to(values.device)


def _exact_sum_cuda(index, values, n_el: int):
    from cutrace_tpu_torch.ops import _build

    _check_terms(values.numel())
    if index.dtype != torch.int32 or values.dtype != torch.float32 or (
            index.shape != values.shape) or index.device != values.device:
        raise ValueError(f"exact_sum: int32 index and float32 values of one "
                         f"shape on one device, got {index.dtype} "
                         f"{tuple(index.shape)} on {index.device}, "
                         f"{values.dtype} {tuple(values.shape)} on "
                         f"{values.device}")
    index, values = index.contiguous(), values.contiguous()
    acc = _acc(n_el, values.device)
    out = torch.empty((n_el,), dtype=torch.float32, device=values.device)
    lib = _build.load_library("replay_vjp")
    rc = lib.cutrace_exact_sum(
        _ptr(index), _ptr(values), values.numel(), n_el, _ptr(acc), _ptr(out),
        ctypes.c_void_p(torch.cuda.current_stream(values.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"exact sum kernel launch failed: CUDA error {rc}")
    return out


def exact_sum(index, values, n_el: int):
    """`values` summed into n_el elements by `index` as the replay
    backward kernel sums its cotangents: the kernel's sums alone on CUDA
    tensors, exact_sum_plain on CPU tensors."""
    if values.is_cuda:
        return _exact_sum_cuda(index, values, n_el)
    return exact_sum_plain(index, values, n_el)


def _codes_by_row(codes):
    """(buffer, n_pad): the codes as a (K, n_pad) int32 buffer, rays
    contiguous, n_pad a multiple of _PAD (the kernel's last block of rays
    may be ragged). It is the fused forward's own buffer when `codes` is
    its (R, K) view, else a copy."""
    r, k = codes.shape
    n_pad = codes.stride(1)
    if (codes.dtype == torch.int32 and codes.stride(0) == 1
            and n_pad % _PAD == 0 and n_pad >= r
            and codes.storage_offset() == 0
            and codes.untyped_storage().nbytes() >= k * n_pad * 4):
        return torch.as_strided(codes, (k, n_pad), (n_pad, 1)), n_pad
    n_pad = -(-r // _PAD) * _PAD
    out = torch.full((k, n_pad), -1, dtype=torch.int32, device=codes.device)
    out[:, :r] = codes.T
    return out, n_pad


@torch.no_grad()
def _replay_vjp_cuda(soa, table, lights, ambient, o, d, codes, cot, fudge,
                     bounces: int):
    from cutrace_tpu_torch.ops import _build

    global LAUNCHES
    instance = vjp_instance(soa, bounces)
    dev = table.device
    r = o.shape[0]
    rows = rp.replay_rows(soa, bounces)
    n_tab = (soa.tri_p1.shape[0] + soa.pl_point.shape[0]
             + soa.sp_center.shape[0])
    n_lights = soa.n_lights
    checks = (("table", table, torch.float32, (n_tab, 17)),
              ("lights", lights, torch.float32, (max(n_lights, 1), 8)),
              ("ambient", ambient, torch.float32, (1,)),
              ("o", o, torch.float32, (r, 3)), ("d", d, torch.float32, (r, 3)),
              ("codes", codes, torch.int32, (r, rows)))
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name}: expected {dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    table, lights, ambient = (x.contiguous() for x in (table, lights, ambient))
    g_c, g_dep, g_n = _zeros_for_none(cot, o)
    codes_kn, n_pad = _codes_by_row(codes)
    rays = torch.zeros((n_pad, 8), dtype=torch.float32, device=dev)
    rays[:r, 0:3] = o - soa.scene_center
    rays[:r, 3:6] = d
    rays[r:, 3:6] = 1.0
    cot8 = torch.zeros((n_pad, 8), dtype=torch.float32, device=dev)
    cot8[:r, 0:3] = g_c
    cot8[:r, 3] = g_dep
    cot8[:r, 4:7] = g_n
    _check_terms(vjp_terms(soa, bounces, r))
    d_rays = torch.empty((n_pad, 8), dtype=torch.float32, device=dev)
    n_el = n_tab * 17 + n_lights * 8 + 8
    acc = _acc(n_el, dev, n_tab)
    out = torch.empty((n_el,), dtype=torch.float32, device=dev)

    lib = _build.load_library("replay_vjp")
    tracing.mark("cotangents")
    rc = lib.cutrace_replay_vjp(
        _ptr(rays), _ptr(codes_kn), _ptr(cot8), _ptr(table), _ptr(lights),
        _ptr(ambient), _ptr(d_rays), _ptr(acc), _ptr(out),
        r, n_pad, rows, n_tab, soa.tri_p1.shape[0], soa.pl_point.shape[0],
        n_lights, bounces, soa.shadow_steps, int(soa.any_reflective),
        int(soa.any_transparent), float(fudge), instance.shared_from,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"replay backward kernel launch failed: CUDA "
                           f"error {rc}")
    tracing.mark("backward")
    LAUNCHES += 1
    d_tbl = out[:n_tab * 17].view(n_tab, 17)
    d_misc = out[n_tab * 17:]
    d_lights = torch.zeros_like(lights)
    if n_lights:
        d_lights[:n_lights, 1:7] = d_misc[:n_lights * 8].reshape(
            n_lights, 8)[:, 1:7]
    d_ambient = d_misc[n_lights * 8].reshape(1)
    return d_tbl, d_lights, d_ambient, d_rays[:r, 0:3], d_rays[:r, 3:6]


def vjp_tables(soa, table, lights, ambient, o, d, codes, cot, fudge,
               bounces: int):
    """Cotangents of (table, lights, ambient, o, d) from the output
    cotangents `cot` = (color, depth, normal; None for zero): the kernel on
    CUDA tensors, the plain version on CPU tensors. Inside a program
    (utils.tracing) marks end the phases `cotangents` (everything since
    the last mark: the loss's backward and, on the card, the rays and
    cotangents packed for the kernel) and `backward` (the kernel and its
    finalize, or the plain version)."""
    if o.is_cuda:
        return _replay_vjp_cuda(soa, table, lights, ambient, o, d, codes,
                                cot, fudge, bounces)
    if o.device.type != "cpu":
        raise ValueError(f"unsupported device {o.device}")
    tracing.mark("cotangents")
    out = replay_vjp_plain(soa, table, lights, ambient, o, d, codes, cot,
                           fudge, bounces)
    tracing.mark("backward")
    return out


def replay_vjp(soa, o, d, codes, cot, fudge, bounces: int,
               tables_vjp=None):
    """The fixed-topology backward of a fused render: (g_soa, g_o, g_d)
    from topology codes (R, K) and output cotangents (color (R,3), depth
    (R,), normal (R,3)). g_soa maps each name in TABLE_FIELDS to its
    gradient. Semantics match torch autograd of replay_render_rays.
    `tables_vjp` (default vjp_tables: the kernel on CUDA tensors) computes
    the table-level cotangents; passing replay_vjp_plain routes the plain
    version's instead, e.g. to hold the kernel against it on the card."""
    leaves = {name: getattr(soa, name).detach().requires_grad_()
              for name in TABLE_FIELDS}
    with torch.enable_grad():
        ins = backward_tables(dataclasses.replace(soa, **leaves))
    d_tbl, d_lights, d_amb, g_o, g_d = (tables_vjp or vjp_tables)(
        soa, *(x.detach() for x in ins), o.detach(), d.detach(), codes, cot,
        fudge, bounces)
    grads = torch.autograd.grad(ins, list(leaves.values()),
                                (d_tbl, d_lights, d_amb), allow_unused=True)
    g_soa = {name: torch.zeros_like(leaf) if g is None else g
             for (name, leaf), g in zip(leaves.items(), grads)}
    return g_soa, g_o, g_d
