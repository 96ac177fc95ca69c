// Replay backward for NVIDIA Hopper (sm_90a): the fixed-topology gradient
// of a fused render from its topology codes, one thread per ray.
//
// Replaces cutrace_tpu/ops/replay_vjp.py:_make_replay_vjp_kernel (the TPU
// kernel K2). It computes what that kernel computes, the vector-Jacobian
// product of cutrace_tpu_torch/ops/replay.py:replay_render_rays for given
// codes and output cotangents, but not its TPU tiling:
//   * forward sweep: the bounce tree is walked in preorder from the codes
//     (reflection child first, parked transparency frames, a node of
//     weight 0 skipped with its subtree, as the forward kernel walks it),
//     keeping each live node's (o, d, w);
//   * reverse sweep: nodes in reverse preorder, so children come before
//     parents, with the hand-derived adjoints of hit_from_code and
//     _phong_lights. Every guard of the replay is matched (where(x == 0,
//     1, x) divisors, the guarded normalizations, fmaxf NaN -> 0 gates, the
//     backface gate on pow). Only the winner's kind is differentiated: on
//     the TPU every kind-branch ran on the same row, and its masked-off
//     branches contribute zero. The phong-exponent adjoint is
//     fs * log(base) under the backface gate; transparent scenes add the
//     weff = w (1 - f) spawn adjoints and the march adjoint through each
//     counted occluder's transparency;
//   * a missed node, or a node the codes leave dead, contributes nothing:
//     every cotangent of a miss is gated by hit in the replay, and a dead
//     node's only nonzero cotangent (its weight's) is multiplied by zero
//     in its parent unless the parent's transparency is exactly 1;
//   * gathers are plain loads of the winner's packed row, so the TPU's
//     one-hot contraction and its row caps do not exist here.
// Outputs: d_o and d_d per ray; the packed-table cotangent (N, 17), and
// per light [0, d_vec, d_color, 0] plus d_ambient, summed over rays.
//
// Node state: one kernel covers every tree shape of at most 63 nodes
// (chains such as bunny's, sphere_plane's two-branch tree). The forward
// sweep pushes the live nodes' (o, d, w, node, level) on a per-thread
// stack in preorder and the reverse sweep pops them, so it touches only
// live nodes; a node's children's cotangents wait on a second stack
// bounded by the tree's depth (pending cotangents: at most one per level
// plus two). Both stacks, and the parked transparency frames, are indexed
// at run time and live in local memory: at most 63 x 32 + 8 x 32 + 6 x 36
// bytes a thread, of which a ray touches its live nodes' rows. (A kernel
// for chains alone, templated on the node count with each node's state in
// registers, ran bunny's 6-node chain about 9 % slower: at the register
// cap it spills too, and it reads node state through selects.)
//
// What bounds it on this card: arithmetic and divergence per ray (about
// 300 float operations per live node plus 180 per light, with branches on
// kind, light and march, IEEE division, sqrt, powf and logf throughout: no
// fast math), and the parameter cotangent sums. Blocks and warps run in no
// fixed order, so every sum is made exact, and thereby independent of the
// order its terms arrive in:
//   * blocks of kBlock = 256 threads, persistent (as many as fit on the
//     card at once), each over a grid-stride loop of ray tiles; a ragged
//     last tile (n_pad a multiple of 128) leaves its lanes idle;
//   * a float term v goes into a fixed-point sum on the grid 2^-64
//     (split, add_parts): its 24-bit significand, shifted to v's exponent,
//     falls in at most two of six 32-bit limbs, each limb kept in a 64-bit
//     word and added with an integer atomicAdd. Integer addition is
//     associative, so the words, and the float finalize_kernel rounds them
//     to (nearest, ties to even), are the same whichever warp or block adds
//     first. Every finite float32 fits (|v| < 2^128), so nothing overflows;
//     a term below 2^-64 rounds to the grid (ties to even), the one rounding
//     before the last. A word sums at most k_rows x n_pad <= 2^30 terms (the
//     code buffer's bound, checked at the launch) of magnitude below 2^32,
//     so it cannot wrap. A NaN or infinity sets a flag bit instead, and the
//     element is what a float sum gives: NaN, or that infinity;
//   * the (N, 17) table cotangent: rows from `smem_lo` on are summed in a
//     block's own shared-memory words and added to the global words once,
//     at the block's end; the others go to the global words directly, and
//     mark their row touched, so the rounding skips the rows no ray hit
//     (most of a 256k table at 160x90).
//     ops/replay_vjp.py vjp_instance picks smem_lo: every row when they fit
//     ("shared", sphere_plane), else the planes' and spheres' (bunny's walls
//     take most rays; "global"). The lanes of a warp are grouped by winner
//     code (__match_any_sync) and each group's float sum, in a fixed order
//     of shuffles, is added once, by its lowest lane;
//   * the light and ambient cotangents: one shared-memory column a thread
//     ((6 L + 1) x 256 floats: 25 KB for bunny's 4 lights), so no light
//     index reaches local memory, summed in float over the thread's rays,
//     then over each warp at the block's end in a fixed order of shuffles,
//     and added exactly.
// So the outputs depend on the inputs and the grid alone, not on timing:
// the same inputs give the same bits, run after run. The table's sums do
// not depend on the grid either; the light sums do, through the tiles each
// block takes, and the grid is sized from the card's SM count and
// occupancy, so bits are equal on one card model and build. (Flushing the
// light columns at every tile's end instead made them grid-free too, at
// 0.26 ms of bunny 1080p's 2.6 ms: PERF.md.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attributes.cuh"

namespace {

constexpr int kBlock = 256;      // threads a block (ops/replay_vjp.py _BLOCK)
constexpr int kPad = 128;        // n_pad is a multiple (ops/replay_vjp.py _PAD)
constexpr int kCols = 17;        // packed-table columns (replay._PK_*)
constexpr int kLightRows = 8;    // floats per light row
constexpr int kMaxLights = 8;
constexpr int kMaxNodes = 63;    // bounce-tree nodes
constexpr int kMaxParked = 6;    // parked transparency frames (bounces <= 5)
constexpr int kCotStack = kMaxParked + 2;  // pending child cotangents
constexpr float kEps = 1e-6f;    // material activity threshold
// exact sums: six 32-bit limbs a sum, each in a 64-bit word, on the grid
// 2^-kGridExp (ops/replay_vjp.py _WORDS, _GRID_EXP)
constexpr int kWords = 6;
constexpr int kGridExp = 64;
// flag bits of a sum: a NaN, +inf or -inf was added
constexpr unsigned kNaN = 1u, kPosInf = 2u, kNegInf = 4u;
// packed-table columns
constexpr int PK_A = 0, PK_B = 3, PK_C = 6, PK_COL = 10, PK_SPEC = 13;
constexpr int PK_REFL = 14, PK_PHONG = 15, PK_TRANSP = 16;
// kinds
constexpr int kMiss = -1, kTri = 0, kPlane = 1, kSphere = 2;

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

// Adjoint of v -> v / where(z, 1, |v|) given the unit result and
// inv = 1 / guarded |v|: (g - u (u.g)) * inv, or g where the map is the
// identity (z).
__device__ __forceinline__ V3 norm_vjp(V3 u, float inv, bool z, V3 g) {
  if (z) return g;
  return (g - u * dot(u, g)) * inv;
}

typedef unsigned long long u64;

struct Args {
  const float* rays;    // (n_pad, 8): o - o0, d, 0, 0
  const int* codes;     // (k_rows, n_pad)
  const float* cot;     // (n_pad, 8): color, depth, normal, 0
  const float* table;   // (n_tab, 17) packed rows, positions recentered
  const float* lights;  // (L, 8): kind, vec (point lights recentered), color
  const float* ambient;
  float* d_rays;        // (n_pad, 8): d_o, d_d, 0, 0
  u64* acc;             // (n_el, kWords) exact sums, zeroed by the caller:
                        // the table's n_tab x 17, then L * 8 + 8 light rows
  unsigned* flags;      // (n_el) flag bits, zeroed by the caller
  unsigned char* touched;  // (n_tab) rows below smem_lo added to, zeroed
  int n_rays, n_pad, k_rows, n_tab, t_cnt, p_cnt, n_lights, bounces;
  int shadow_steps, n_nodes, node_rows, smem_lo;
  bool any_refl, any_transp;
  float fudge;
};

// The fixed-point parts of a float v on the grid 2^-kGridExp: v's
// significand (rounded to the grid, ties to even, where v is below
// 2^(24 - kGridExp)) shifted to v's exponent, cut at limb `limb` into lo
// (< 2^32) and hi (< 2^23, zero from limb 5 on), negated with v. false
// when v adds nothing: zero, a subnormal (< 2^-126), a term under half a
// grid step, or a NaN or infinity, which sets `flag` instead.
struct Parts {
  int limb;
  long long lo, hi;
  unsigned flag;
};

__device__ __forceinline__ bool split(float v, Parts& p) {
  const unsigned b = __float_as_uint(v);
  const int ex = (b >> 23) & 0xff;
  p.flag = 0u;
  if (ex == 0xff) {
    p.flag = (b & 0x7fffffu) ? kNaN : ((b >> 31) ? kNegInf : kPosInf);
    return false;
  }
  if (ex == 0) return false;
  unsigned m = (b & 0x7fffffu) | 0x800000u;
  int s = ex - 150 + kGridExp;  // |v| = m 2^(s - kGridExp)
  if (s < 0) {
    const int k = -s;
    if (k > 24) return false;  // m < 2^24 <= half a step of 2^k
    const unsigned q = m >> k, rem = m & ((1u << k) - 1u);
    const unsigned half = 1u << (k - 1);
    m = q + ((rem > half || (rem == half && (q & 1u))) ? 1u : 0u);
    if (m == 0u) return false;
    s = 0;
  }
  p.limb = s >> 5;  // s <= 168: limb <= 5, and hi = 0 at limb 5
  const u64 w = (u64)m << (s & 31);
  p.lo = (long long)(w & 0xffffffffull);
  p.hi = (long long)(w >> 32);
  if (b >> 31) {
    p.lo = -p.lo;
    p.hi = -p.hi;
  }
  return true;
}

// Adds the parts to one sum's words, in shared or global memory (two's
// complement: the words' sums are signed).
__device__ __forceinline__ void add_parts(u64* words, const Parts& p) {
  atomicAdd(words + p.limb, (u64)p.lo);
  if (p.hi != 0) atomicAdd(words + p.limb + 1, (u64)p.hi);
}

// Where a block adds cotangents: rows from smem_lo on to its shared-memory
// words, other rows (marked touched) and the light rows to the global ones.
// The branch keeps each side's address space, so shared adds compile to
// shared-memory atomics.
struct Sums {
  u64* shared;
  u64* global;
  unsigned* flags;
  unsigned char* touched;
  int smem_lo;
  // element el (a table element, or n_tab * kCols + a light-row index) of
  // the global sums
  __device__ __forceinline__ void add_global(size_t el, float v) const {
    Parts p;
    if (split(v, p))
      add_parts(global + el * kWords, p);
    else if (p.flag)
      atomicOr(flags + el, p.flag);
  }
  // column col of table row `row`
  __device__ __forceinline__ void add(int row, int col, float v) const {
    const size_t el = (size_t)row * kCols + col;
    if (row < smem_lo) {
      touched[row] = 1;
      add_global(el, v);
      return;
    }
    Parts p;
    if (split(v, p))
      add_parts(shared + (el - (size_t)smem_lo * kCols) * kWords, p);
    else if (p.flag)
      atomicOr(flags + el, p.flag);
  }
};

// The float nearest (ties to even) to the exact sum in `words`, or the
// float sum's own NaN or infinity when `flag` says one was added. The
// words are carried into kWords + 1 digits of 32 bits (the last signed:
// the sum is below 2^30 x 2^192 grid steps), made a magnitude, and the 24
// bits below its top bit kept, rounded by the next bit and every bit
// under it.
__device__ float exact_value(const u64* words, unsigned flag) {
  if ((flag & kNaN) || (flag & (kPosInf | kNegInf)) == (kPosInf | kNegInf))
    return __int_as_float(0x7fc00000);  // the canonical quiet NaN
  if (flag & kPosInf) return INFINITY;
  if (flag & kNegInf) return -INFINITY;
  unsigned d[kWords + 1];
  long long c = 0;
  for (int i = 0; i < kWords; ++i) {
    const long long t = (long long)words[i] + c;
    d[i] = (unsigned)(t & 0xffffffffll);
    c = t >> 32;  // arithmetic: t = c 2^32 + d[i]
  }
  d[kWords] = (unsigned)c;
  const bool neg = c < 0;
  if (neg) {
    unsigned carry = 1u;
    for (int i = 0; i <= kWords; ++i) {
      const u64 t = (u64)(~d[i]) + carry;
      d[i] = (unsigned)t;
      carry = (unsigned)(t >> 32);
    }
  }
  int j = kWords;
  while (j >= 0 && d[j] == 0u) --j;
  if (j < 0) return 0.0f;
  const int p = 31 - __clz(d[j]);  // the top bit: bit p + 32 of win
  const u64 win = ((u64)d[j] << 32) | (j > 0 ? d[j - 1] : 0u);
  unsigned q = (unsigned)(win >> (p + 9));  // 24 bits
  const bool half = ((win >> (p + 8)) & 1ull) != 0ull;
  bool sticky = (win & ((1ull << (p + 8)) - 1ull)) != 0ull;
  for (int i = 0; i < j - 1; ++i) sticky = sticky || d[i] != 0u;
  int e2 = 32 * (j - 1) + p + 9 - kGridExp;
  if (half && (sticky || (q & 1u))) {
    if (++q == (1u << 24)) {
      q >>= 1;
      ++e2;
    }
  }
  const float f = ldexpf((float)q, e2);  // exact, or inf past float's range
  return neg ? -f : f;
}

__device__ __forceinline__ int kind_of(const Args& a, int code) {
  if (code < 0) return kMiss;
  if (code < a.t_cnt) return kTri;
  return code < a.t_cnt + a.p_cnt ? kPlane : kSphere;
}

__device__ __forceinline__ bool is_leaf(const Args& a, int level) {
  return level == a.bounces || !(a.any_refl || a.any_transp);
}

__device__ __forceinline__ int subtree_nodes(const Args& a, int level) {
  int depth = a.bounces - level + 1;
  if (a.any_refl && a.any_transp) return (1 << depth) - 1;
  return (a.any_refl || a.any_transp) ? depth : 1;
}

// The hit t of a fixed winner (replay hit_from_code), or +inf on a miss.
// Spheres take t in the normalized direction nd; sel0 / sel1 say which
// root was taken (neither: t = 1).
struct SphereRoot {
  float dec, sq, t;
  bool missed, sel0, sel1;
};

__device__ __forceinline__ SphereRoot sphere_root(const float* row, V3 o,
                                                  V3 nd, float mind) {
  V3 c = ld3(row + PK_A);
  float rad = row[PK_B];
  SphereRoot s;
  s.dec = dot(nd, c) - dot(nd, o);
  float ec2 = dot(o, o) - 2.0f * dot(o, c) + dot(c, c);
  float sub = s.dec * s.dec - (ec2 - rad * rad);
  s.missed = sub <= 0.0f;
  s.sq = sqrtf(s.missed ? 1.0f : sub);
  float t0 = s.dec - s.sq, t1 = s.dec + s.sq;
  bool v0 = !s.missed && isfinite(t0) && t0 > mind;
  bool v1 = !s.missed && isfinite(t1) && t1 > mind;
  // t0 <= t1 (sq >= 0), so the both-valid minimum is t0
  s.sel0 = v0;
  s.sel1 = !v0 && v1;
  s.t = v0 ? t0 : (v1 ? t1 : 1.0f);
  return s;
}

__device__ __forceinline__ float tri_t(const float* row, V3 o, V3 d) {
  V3 p1 = ld3(row + PK_A), p2 = ld3(row + PK_B), p3 = ld3(row + PK_C);
  V3 n = cross(p2 - p1, p2 - p3);
  float alpha = dot(d, n);
  float inv = 1.0f / (alpha == 0.0f ? 1.0f : alpha);
  return (dot(p2, n) - dot(o, n)) * inv;
}

__device__ __forceinline__ float plane_t(const float* row, V3 o, V3 d) {
  V3 p = ld3(row + PK_A), pn = ld3(row + PK_B);
  float denom = dot(d, pn);
  return (dot(p, pn) - dot(o, pn)) / (denom == 0.0f ? 1.0f : denom);
}

__device__ float code_t(const Args& a, int code, V3 o, V3 d, V3 nd,
                        float mind) {
  int kind = kind_of(a, code);
  if (kind == kMiss) return INFINITY;
  const float* row = a.table + (size_t)code * kCols;
  if (kind == kTri) return tri_t(row, o, d);
  if (kind == kPlane) return plane_t(row, o, d);
  return sphere_root(row, o, nd, mind).t;
}

// What a live node's winner gives both sweeps.
struct Node {
  int kind;
  const float* row;
  V3 nd;
  float inv_dlen, t_safe;
  V3 point, normal, nn;
  float inv_nn;
  bool nn_z;
};

__device__ Node node_geom(const Args& a, int code, V3 o, V3 d, float mind) {
  Node g;
  g.kind = kind_of(a, code);
  g.row = a.table + (size_t)(code < 0 ? 0 : code) * kCols;
  float dl = sqrtf(dot(d, d));
  g.inv_dlen = 1.0f / dl;
  g.nd = v3(d.x / dl, d.y / dl, d.z / dl);
  float t = 1.0f;
  V3 normal = v3(0.0f, 0.0f, 0.0f);
  if (g.kind == kTri) {
    V3 p1 = ld3(g.row + PK_A), p2 = ld3(g.row + PK_B), p3 = ld3(g.row + PK_C);
    t = tri_t(g.row, o, d);
    V3 ncr = -cross(p2 - p3, p1 - p3);
    float nl2 = dot(ncr, ncr);
    float nl = sqrtf(nl2 == 0.0f ? 1.0f : nl2);
    float den = nl2 == 0.0f ? 1.0f : nl;
    normal = v3(ncr.x / den, ncr.y / den, ncr.z / den);
  } else if (g.kind == kPlane) {
    t = plane_t(g.row, o, d);
    normal = ld3(g.row + PK_B);
  } else if (g.kind == kSphere) {
    SphereRoot s = sphere_root(g.row, o, g.nd, mind);
    t = s.t;
    V3 nsp = o + g.nd * s.t - ld3(g.row + PK_A);
    float nil2 = dot(nsp, nsp);
    float nil = sqrtf(nil2 == 0.0f ? 1.0f : nil2);
    float den = nil2 == 0.0f ? 1.0f : nil;
    normal = v3(nsp.x / den, nsp.y / den, nsp.z / den);
  }
  bool hit = g.kind != kMiss;
  g.t_safe = hit ? t : 1.0f;
  g.point = o + sel(g.kind == kSphere, g.nd, d) * g.t_safe;
  g.normal = normal;
  V3 nrm = hit ? normal : v3(0.0f, 0.0f, 1.0f);
  float l2 = dot(nrm, nrm);
  g.nn_z = l2 == 0.0f;
  float l = sqrtf(g.nn_z ? 1.0f : l2);
  g.inv_nn = 1.0f / (g.nn_z ? 1.0f : l);
  float den = g.nn_z ? 1.0f : l;
  g.nn = v3(nrm.x / den, nrm.y / den, nrm.z / den);
  return g;
}

// Cotangents of a node's inputs (o, d, w).
struct NodeCot {
  V3 o, d;
  float w;
};

// The reverse sweep of one live, hit node. Child cotangents come in
// (zero when the child is dead or missed); the node's packed-row
// cotangent goes to g_row, march transparency cotangents straight to
// `sums`, light and ambient cotangents to the thread's shared column
// `lcol` (row j at lcol[j * kBlock]: per light d_vec (3), d_color (3);
// then d_ambient).
__device__ __forceinline__ NodeCot node_backward(
    const Args& a, int k, int level, V3 o, V3 d, float w, const NodeCot& cr,
    bool has_r, const NodeCot& ct, bool has_t, V3 cot_c, float cot_dep,
    V3 cot_n, float (&g_row)[kCols], const Sums& sums, float* lcol, int i) {
  const int cast_row = k * a.node_rows;
  const int code = a.codes[(size_t)cast_row * a.n_pad + i];
  const float mind = a.fudge;
  Node g = node_geom(a, code, o, d, mind);
  const float* row = g.row;
  const bool leaf = is_leaf(a, level);
  const bool root = k == 0;
  const V3 nd = g.nd, nn = g.nn;
  const float t_safe = g.t_safe;
  const V3 dif = ld3(row + PK_COL);
  const float spec = row[PK_SPEC], refl = row[PK_REFL];
  const float phong_e = row[PK_PHONG], transp = row[PK_TRANSP];
  const float ambient = *a.ambient;

  V3 a_o = v3(0.f, 0.f, 0.f), a_d = a_o, a_nd = a_o, a_nn = a_o, a_pt = a_o;
  float a_ts = 0.0f, a_t = 0.0f, a_w = 0.0f;
  for (int j = 0; j < kCols; ++j) g_row[j] = 0.0f;

  const bool f_on = a.any_transp && !leaf && transp >= kEps;
  const float f = f_on ? transp : 0.0f;
  const float weff = w * (1.0f - f);

  // --- child transitions ---
  float g_weff = 0.0f;
  if (!leaf) {
    V3 g_o_c = v3(0.f, 0.f, 0.f);
    if (a.any_refl && has_r) {
      g_o_c = g_o_c + cr.o;
      // rd = nd - 2 (nd.nn) nn
      float dot_dn = dot(nd, nn);
      float gd_nn = dot(cr.d, nn);
      a_nd = a_nd + (cr.d - nn * (2.0f * gd_nn));
      a_nn = a_nn - (nd * (2.0f * gd_nn) + cr.d * (2.0f * dot_dn));
      // w_refl = weff * r
      const bool r_on = refl >= kEps;
      g_weff += cr.w * (r_on ? refl : 0.0f);
      if (r_on) g_row[PK_REFL] += cr.w * weff;
    }
    if (a.any_transp && has_t) {
      g_o_c = g_o_c + ct.o;
      a_d = a_d + ct.d;  // the transparency child keeps d
    }
    // child_o = o + t_safe * d (both children)
    a_o = a_o + g_o_c;
    a_ts += dot(g_o_c, d);
    a_d = a_d + g_o_c * t_safe;
  }

  // --- color: leaf adds w * ph, others weff * ph ---
  const V3 g_final = cot_c * (leaf ? w : weff);
  const V3 md = -nd;
  V3 a_md = v3(0.f, 0.f, 0.f);
  V3 final = dif * ambient;
  lcol[a.n_lights * 6 * kBlock] += dot(dif, g_final);
  V3 a_dif = g_final * ambient;
  float a_spec = 0.0f, a_phong = 0.0f;
  const int per_light = a.any_transp ? a.shadow_steps : 1;
  const V3 point = g.point;

  for (int li = 0; li < a.n_lights; ++li) {
    const float* L = a.lights + li * kLightRows;
    const bool is_sun = L[0] == 0.0f;
    const V3 vec = ld3(L + 1), lc = ld3(L + 4);
    const V3 diff = vec - point;
    const float dist = sqrtf(dot(diff, diff));
    const bool dist_z = dist == 0.0f;
    const float dsafe = dist_z ? 1.0f : dist;
    const float inv_ds = 1.0f / dsafe;
    const V3 dir_pt = v3(diff.x / dsafe, diff.y / dsafe, diff.z / dsafe);
    const V3 direction = is_sun ? -vec : dir_pt;
    const float dl = sqrtf(dot(direction, direction));
    const bool dl_z = dl == 0.0f;
    const float light_dist = (is_sun ? INFINITY : dist) * dl;
    const float dls = dl_z ? 1.0f : dl;
    const float inv_dl = 1.0f / dls;
    const V3 sdir = v3(direction.x / dls, direction.y / dls, direction.z / dls);
    const int sbase = cast_row + 1 + li * per_light;

    float sh, sh_raw = 0.0f;
    int n_steps = 0;  // counted march steps
    if (!a.any_transp) {
      sh = (float)a.codes[(size_t)sbase * a.n_pad + i];
    } else {
      // march replay: sh accumulates (1 - occluder transparency)
      float last = 0.0f;
      sh = 0.0f;
      const float sl = sqrtf(dot(sdir, sdir));
      const V3 snd = v3(sdir.x / sl, sdir.y / sl, sdir.z / sl);
      for (int si = 0; si < per_light; ++si) {
        int cc = a.codes[(size_t)(sbase + si) * a.n_pad + i];
        float st = code_t(a, cc, point, sdir, snd, last + 1e-3f);
        bool okm = cc >= 0 && isfinite(st) && st < light_dist;
        if (!okm) break;
        sh += 1.0f - a.table[(size_t)cc * kCols + PK_TRANSP];
        last = st;
        n_steps = si + 1;
        if (!(sh < 1.0f)) break;
      }
      sh_raw = sh;
      sh = sh >= 1.0f ? 1.0f : sh;
    }
    const bool lit = sh < 1.0f;

    const float fdd = dot(nn, sdir);
    const bool fd_pos = fdd > 0.0f;
    const float fd = fd_pos ? fdd : 0.0f;
    const V3 hv = md + sdir;
    const float hl = sqrtf(dot(hv, hv));
    const bool hl_z = hl == 0.0f;
    const float hlg = hl_z ? 1.0f : hl;
    const float inv_hl = 1.0f / hlg;
    const float bddv = dot(nn, hv);
    const float bdd = bddv / hlg;
    const bool bdd_pos = bdd > 0.0f;
    const float base = bdd_pos ? bdd : 0.0f;
    const bool backf = base <= 0.0f;
    const float base_g = backf ? 1.0f : base;
    const float fs = backf ? 0.0f : powf(base_g, phong_e);
    const float wgt = lit ? 1.0f - sh : 0.0f;
    const V3 contrib = dif * (fd + fs * spec);
    final = final + mul(contrib, lc) * wgt;

    // adjoints of final += wgt * contrib * lc
    const V3 g_lcol = mul(contrib, g_final) * wgt;
    const V3 g_contrib = mul(lc, g_final) * wgt;
    if (a.any_transp && n_steps > 0 && sh_raw < 1.0f) {
      // wgt = 1 - sh_raw: each counted occluder's transparency gets +g_wgt
      const float g_wgt = dot(mul(contrib, lc), g_final);
      for (int si = 0; si < n_steps; ++si) {
        int cc = a.codes[(size_t)(sbase + si) * a.n_pad + i];
        if (g_wgt != 0.0f) sums.add(cc, PK_TRANSP, g_wgt);
      }
    }
    const float dg = dot(dif, g_contrib);
    const float g_fs = spec * dg;
    a_spec += fs * dg;
    a_dif = a_dif + g_contrib * (fd + fs * spec);
    float g_base = 0.0f;
    if (!backf) {
      a_phong += fs * logf(base_g) * g_fs;
      g_base = fs * phong_e / base_g * g_fs;
    }
    const float g_bdd = bdd_pos ? g_base : 0.0f;
    // bdd = (nn.hv) / guarded |hv|
    a_nn = a_nn + hv * (g_bdd * inv_hl);
    const float ddhl = hl_z ? 0.0f : bddv * inv_hl * inv_hl * inv_hl;
    const V3 g_hv = (nn * inv_hl - hv * ddhl) * g_bdd;
    a_md = a_md + g_hv;
    V3 g_sdir = g_hv;
    const float g_fdd = fd_pos ? dg : 0.0f;
    a_nn = a_nn + sdir * g_fdd;
    g_sdir = g_sdir + nn * g_fdd;
    // sdir = direction / guarded |direction|
    const V3 g_dir = norm_vjp(sdir, inv_dl, dl_z, g_sdir);
    V3 g_vec;
    if (is_sun) {
      g_vec = -g_dir;
    } else {
      g_vec = norm_vjp(dir_pt, inv_ds, dist_z, g_dir);
      a_pt = a_pt - g_vec;
    }
    float* lv = lcol + li * 6 * kBlock;
    lv[0] += g_vec.x;
    lv[kBlock] += g_vec.y;
    lv[2 * kBlock] += g_vec.z;
    lv[3 * kBlock] += g_lcol.x;
    lv[4 * kBlock] += g_lcol.y;
    lv[5 * kBlock] += g_lcol.z;
  }

  // color term and spawn weights
  const float ph_c = dot(final, cot_c);
  if (leaf) {
    a_w += ph_c;
  } else {
    g_weff += ph_c;
    const float g_w_t = (a.any_transp && has_t) ? ct.w : 0.0f;
    a_w += (1.0f - f) * g_weff + f * g_w_t;
    if (f_on) g_row[PK_TRANSP] += -w * g_weff + w * g_w_t;
  }
  g_row[PK_COL] += a_dif.x;
  g_row[PK_COL + 1] += a_dif.y;
  g_row[PK_COL + 2] += a_dif.z;
  g_row[PK_SPEC] += a_spec;
  g_row[PK_PHONG] += a_phong;
  a_nd = a_nd - a_md;  // md = -nd

  // root outputs: depth = t, normal = the raw hit normal
  V3 a_normal = v3(0.f, 0.f, 0.f);
  if (root) {
    a_t += cot_dep;
    a_normal = cot_n;
  }
  // point = o + t_safe * (sphere ? nd : d)
  const bool is_sp = g.kind == kSphere;
  a_o = a_o + a_pt;
  a_ts += dot(a_pt, is_sp ? nd : d);
  if (is_sp) a_nd = a_nd + a_pt * t_safe;
  else a_d = a_d + a_pt * t_safe;
  // nn = nrm / guarded |nrm|
  a_normal = a_normal + norm_vjp(nn, g.inv_nn, g.nn_z, a_nn);
  a_t += a_ts;  // t_safe = t on a hit

  // --- the winner kind's t and normal adjoints ---
  if (g.kind == kTri) {
    const V3 p1 = ld3(row + PK_A), p2 = ld3(row + PK_B), p3 = ld3(row + PK_C);
    const V3 ea = p2 - p1, eb = p2 - p3, q = p1 - p3;
    const V3 n = cross(ea, eb);
    const float alpha = dot(d, n);
    const bool alpha_z = alpha == 0.0f;
    const float inv_a = 1.0f / (alpha_z ? 1.0f : alpha);
    const float s_num = dot(p2, n) - dot(o, n);
    // t = s_num * inv_a
    const float g_snum = a_t * inv_a;
    const float g_inv = a_t * s_num;
    const float g_alpha = alpha_z ? 0.0f : -g_inv * inv_a * inv_a;
    V3 g_p2 = n * g_snum;
    a_o = a_o - n * g_snum;
    V3 g_n = (p2 - o) * g_snum + d * g_alpha;
    a_d = a_d + n * g_alpha;
    // n = ea x eb
    V3 g_ea = cross(eb, g_n);
    V3 g_eb = cross(g_n, ea);
    // shading normal = ncr / guarded |ncr|, ncr = -(eb x q)
    const V3 ncr = -cross(eb, q);
    const float nl2 = dot(ncr, ncr);
    const bool nl2_z = nl2 == 0.0f;
    const float nl = sqrtf(nl2_z ? 1.0f : nl2);
    const float inv_nl = 1.0f / (nl2_z ? 1.0f : nl);
    const V3 g_ncr = -norm_vjp(ncr * inv_nl, inv_nl, nl2_z, a_normal);
    g_eb = g_eb + cross(q, g_ncr);
    const V3 g_q = cross(g_ncr, eb);
    g_p2 = g_p2 + g_ea + g_eb;
    const V3 g_p1 = g_q - g_ea;
    const V3 g_p3 = -(g_eb + g_q);
    g_row[PK_A] += g_p1.x;
    g_row[PK_A + 1] += g_p1.y;
    g_row[PK_A + 2] += g_p1.z;
    g_row[PK_B] += g_p2.x;
    g_row[PK_B + 1] += g_p2.y;
    g_row[PK_B + 2] += g_p2.z;
    g_row[PK_C] += g_p3.x;
    g_row[PK_C + 1] += g_p3.y;
    g_row[PK_C + 2] += g_p3.z;
  } else if (g.kind == kPlane) {
    const V3 pa = ld3(row + PK_A), pn = ld3(row + PK_B);
    const float denom = dot(d, pn);
    const bool den_z = denom == 0.0f;
    const float den = den_z ? 1.0f : denom;
    const float num = dot(pa, pn) - dot(o, pn);
    // t = num / den
    const float g_num = a_t / den;
    const float g_den = den_z ? 0.0f : -a_t * num / (den * den);
    const V3 g_pa = pn * g_num;
    a_o = a_o - pn * g_num;
    const V3 g_pn = (pa - o) * g_num + d * g_den + a_normal;
    a_d = a_d + pn * g_den;
    g_row[PK_A] += g_pa.x;
    g_row[PK_A + 1] += g_pa.y;
    g_row[PK_A + 2] += g_pa.z;
    g_row[PK_B] += g_pn.x;
    g_row[PK_B + 1] += g_pn.y;
    g_row[PK_B + 2] += g_pn.z;
  } else {  // sphere
    const V3 c = ld3(row + PK_A);
    const float rad = row[PK_B];
    const SphereRoot s = sphere_root(row, o, nd, mind);
    // normal = nsp / guarded |nsp|, nsp = o + t nd - c
    const V3 nsp = o + nd * s.t - c;
    const float nil2 = dot(nsp, nsp);
    const bool nil2_z = nil2 == 0.0f;
    const float nil = sqrtf(nil2_z ? 1.0f : nil2);
    const float inv_nil = 1.0f / (nil2_z ? 1.0f : nil);
    const V3 g_nsp = norm_vjp(nsp * inv_nil, inv_nil, nil2_z, a_normal);
    V3 g_c = -g_nsp;
    a_o = a_o + g_nsp;
    float g_t = a_t + dot(g_nsp, nd);
    V3 a_nd_sp = g_nsp * s.t;
    // t = sel0 ? dec - sq : (sel1 ? dec + sq : 1)
    float g_dec = (s.sel0 || s.sel1) ? g_t : 0.0f;
    const float g_sq = (s.sel1 ? g_t : 0.0f) - (s.sel0 ? g_t : 0.0f);
    // sq = sqrt(guarded sub), sub = dec^2 - ec2 + r^2
    const float g_sub = s.missed ? 0.0f : 0.5f / s.sq * g_sq;
    g_dec += 2.0f * s.dec * g_sub;
    const float g_ec2 = -g_sub;
    const float g_rad = 2.0f * rad * g_sub;
    // dec = nd.c - nd.o
    a_nd_sp = a_nd_sp + (c - o) * g_dec;
    g_c = g_c + nd * g_dec;
    a_o = a_o - nd * g_dec;
    // ec2 = o.o - 2 o.c + c.c
    a_o = a_o + (o - c) * (2.0f * g_ec2);
    g_c = g_c + (c - o) * (2.0f * g_ec2);
    a_nd = a_nd + a_nd_sp;
    g_row[PK_A] += g_c.x;
    g_row[PK_A + 1] += g_c.y;
    g_row[PK_A + 2] += g_c.z;
    g_row[PK_B] += g_rad;
  }

  // nd = d / |d| (unguarded, as the replay's _normalize)
  a_d = a_d + (a_nd - nd * dot(nd, a_nd)) * g.inv_dlen;
  return NodeCot{a_o, a_d, a_w};
}

// Adds each lane's packed-row cotangent g to row `code` of the sums (code
// < 0: nothing); g is consumed. Every lane of the warp calls it. Lanes are
// grouped by code (__match_any_sync). Within a group each lane adds in the
// partial sum of the next peer above it still taking part, then every
// second one drops out, so after log2 of the group's size rounds its
// lowest lane holds the group's sum, in an order fixed by the lanes' codes:
// the rays of one wall would otherwise add to the same 17 sums one by one.
// Then each group's row in turn is spread over the lanes, lane j adding
// column j, so no lane splits 17 terms alone (faster than each leader
// adding its own row, for a wall's few groups and a fine mesh's many
// alike: PERF.md).
__device__ __forceinline__ void scatter_row(const Sums& sums, int code,
                                            float (&g)[kCols]) {
  const unsigned full = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(full, code);
  int rank = __popc(peers & ((1u << lane) - 1u));
  const bool leader = rank == 0;
  unsigned above = peers & ~((2u << lane) - 1u);
  while (__any_sync(full, above != 0u)) {
    const int next = __ffs(above) - 1;  // -1: no peer above
    const int src = next < 0 ? (int)lane : next;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float v = __shfl_sync(full, g[j], src);
      if (next >= 0) g[j] += v;
    }
    above &= __ballot_sync(full, (rank & 1) == 0);
    rank >>= 1;
  }
  unsigned rows = __ballot_sync(full, leader && code >= 0);
  while (rows != 0u) {
    const int src = __ffs(rows) - 1;
    rows &= rows - 1u;
    const int row = __shfl_sync(full, code, src);
    float mine = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float v = __shfl_sync(full, g[j], src);
      if (lane == (unsigned)j) mine = v;
    }
    if (lane < (unsigned)kCols && mine != 0.0f) sums.add(row, lane, mine);
  }
}

// What a live node that is not a leaf spawns (the forward kernel's rule):
// both children start at o + t_safe d; the reflection child takes the
// mirrored direction and weight w (1 - f) r, the transparency child keeps
// d with weight w f.
struct Spawn {
  V3 o, d_refl;
  float w_refl, w_transp;
};

__device__ __forceinline__ Spawn spawn(const Args& a, int node, V3 o, V3 d,
                                       float w, int i) {
  const int code = a.codes[(size_t)(node * a.node_rows) * a.n_pad + i];
  const Node g = node_geom(a, code, o, d, a.fudge);
  const bool hit = g.kind != kMiss;
  const float tr = g.row[PK_TRANSP], rf = g.row[PK_REFL];
  const float f = (a.any_transp && hit && tr >= kEps) ? tr : 0.0f;
  const float weff = w * (1.0f - f);
  const float rr = (hit && rf >= kEps) ? rf : 0.0f;
  return Spawn{o + d * g.t_safe, g.nd - g.nn * (2.0f * dot(g.nd, g.nn)),
               weff * rr, w * f};
}

// The output cotangents of ray i: color, depth, normal.
struct RayCot {
  V3 c, n;
  float dep;
};

__device__ __forceinline__ RayCot ray_cot(const Args& a, int i, bool active) {
  const float* cp = a.cot + (size_t)(active ? i : 0) * 8;
  return RayCot{ld3(cp), ld3(cp + 4), cp[3]};
}

// d_o and d_d of ray i: the root's input cotangents, zero when the root
// missed.
__device__ __forceinline__ void write_ray(const Args& a, int i, bool root,
                                          const NodeCot& c) {
  float* q = a.d_rays + (size_t)i * 8;
  const float v[6] = {c.o.x, c.o.y, c.o.z, c.d.x, c.d.y, c.d.z};
#pragma unroll
  for (int j = 0; j < 6; ++j) q[j] = root ? v[j] : 0.0f;
  q[6] = 0.0f;
  q[7] = 0.0f;
}

struct Frame {
  V3 o, d;
  float w;
  int level, node;
};

// A live node's forward state.
struct LiveNode {
  V3 o, d;
  float w;
  int node, level;
};

// A finished node's input cotangents, waiting for its parent.
struct Pending {
  NodeCot c;
  int node;
};

// Ray i through any tree of at most kMaxNodes nodes.
// The forward sweep pushes the live nodes in preorder (reflection child
// first, parked transparency frames); the reverse sweep pops them, so
// children come before parents, each lane at its own live node.
__device__ __forceinline__ void tree_ray(const Args& a, const Sums& sums,
                                         float* lcol, int i, bool active) {
  LiveNode live[kMaxNodes];
  int n_live = 0;
  if (active) {
    const float* ray = a.rays + (size_t)i * 8;
    V3 o = ld3(ray), d = ld3(ray + 3);
    float w = 1.0f;
    int level = 0, node = 0;
    Frame parked[kMaxParked];
    int n_parked = 0;
    while (true) {
      bool descend = false;
      if (node == 0 || w != 0.0f) {
        live[n_live++] = LiveNode{o, d, w, node, level};
        if (!is_leaf(a, level)) {
          const Spawn c = spawn(a, node, o, d, w, i);
          if (a.any_refl) {
            if (a.any_transp)
              parked[n_parked++] =
                  Frame{c.o, d, c.w_transp, level + 1,
                        node + 1 + subtree_nodes(a, level + 1)};
            d = c.d_refl;
            w = c.w_refl;
          } else {
            w = c.w_transp;
          }
          o = c.o;
          level += 1;
          node += 1;
          descend = true;
        }
      }
      if (!descend) {
        if (n_parked == 0) break;
        const Frame fr = parked[--n_parked];
        o = fr.o;
        d = fr.d;
        w = fr.w;
        level = fr.level;
        node = fr.node;
      }
    }
  }

  // Reverse preorder: a node's transparency subtree, then its reflection
  // subtree, then the node; so its finished children sit on top of the
  // pending stack, reflection child first.
  const RayCot rc = ray_cot(a, i, active);
  Pending pending[kCotStack];
  int sp = 0;
  const int rounds = __reduce_max_sync(0xffffffffu, n_live);
  for (int q = rounds - 1; q >= 0; --q) {
    float g_row[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) g_row[j] = 0.0f;
    int code = -1;
    if (q < n_live) {
      const LiveNode s = live[q];
      const int c = a.codes[(size_t)(s.node * a.node_rows) * a.n_pad + i];
      if (c >= 0) {
        const bool inner = !is_leaf(a, s.level);
        const int kr = s.node + 1;
        const int kt =
            s.node + 1 + (a.any_refl ? subtree_nodes(a, s.level + 1) : 0);
        NodeCot cr{}, ct{};
        const bool has_r = inner && a.any_refl && sp > 0 &&
                           pending[sp - 1].node == kr;
        if (has_r) cr = pending[--sp].c;
        const bool has_t = inner && a.any_transp && sp > 0 &&
                           pending[sp - 1].node == kt;
        if (has_t) ct = pending[--sp].c;
        const NodeCot r =
            node_backward(a, s.node, s.level, s.o, s.d, s.w, cr, has_r, ct,
                          has_t, rc.c, rc.dep, rc.n, g_row, sums, lcol, i);
        pending[sp++] = Pending{r, s.node};
        code = c;
      }
    }
    scatter_row(sums, code, g_row);
  }
  if (active) {
    const bool root = sp > 0 && pending[sp - 1].node == 0;
    write_ray(a, i, root, root ? pending[sp - 1].c : NodeCot{});
  }
}

// Adds the warp's light columns to the exact light sums, at the block's
// end: each row summed over the 32 lanes in a fixed order of shuffles and
// added by lane (row mod 32). Rows mirror the light-table columns [kind,
// vec, color, 0] a light, then ambient. Every lane of the warp calls it.
__device__ __forceinline__ void flush_lights(const Args& a, const Sums& sums,
                                             float* lcol) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int n_misc = a.n_lights * 6 + 1;
  for (int j = 0; j < n_misc; ++j) {
    float v = lcol[j * kBlock];
    for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(full, v, off);
    if (lane == (j & 31) && v != 0.0f) {
      const int dst = j < a.n_lights * 6 ? (j / 6) * kLightRows + 1 + j % 6
                                         : a.n_lights * kLightRows;
      sums.add_global((size_t)a.n_tab * kCols + dst, v);
    }
  }
}

// Blocks a multiprocessor should hold at once: the register cap the
// compiler is held to (65,536 / (256 x 2) = 128 a thread).
constexpr int kMinBlocks = 2;

__global__ void __launch_bounds__(kBlock, kMinBlocks)
replay_vjp_kernel(Args a) {
  extern __shared__ u64 smem[];
  const int n_misc = a.n_lights * 6 + 1;
  float* s_light = reinterpret_cast<float*>(smem);  // n_misc x kBlock
  u64* s_tbl = smem + n_misc * (kBlock / 2);
  const int n_words = (a.n_tab - a.smem_lo) * kCols * kWords;
  for (int j = threadIdx.x; j < n_misc * kBlock; j += kBlock)
    s_light[j] = 0.0f;
  for (int j = threadIdx.x; j < n_words; j += kBlock) s_tbl[j] = 0ull;
  __syncthreads();
  const Sums sums{s_tbl, a.acc, a.flags, a.touched, a.smem_lo};
  float* lcol = s_light + threadIdx.x;

  const int n_tiles = (a.n_pad + kBlock - 1) / kBlock;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int i = tile * kBlock + threadIdx.x;
    const bool active = i < a.n_rays;
    tree_ray(a, sums, lcol, i, active);
  }
  flush_lights(a, sums, lcol);
  __syncthreads();
  // the block's shared words into the global ones
  u64* dst = a.acc + (size_t)a.smem_lo * kCols * kWords;
  for (int j = threadIdx.x; j < n_words; j += kBlock) {
    const u64 v = s_tbl[j];
    if (v != 0ull) atomicAdd(dst + j, (u64)v);
  }
}

// One thread an element: the exact sums rounded to float32; a table row
// below smem_lo that no term touched is zero without reading its words.
__global__ void replay_vjp_finalize_kernel(const u64* acc,
                                           const unsigned* flags,
                                           const unsigned char* touched,
                                           int smem_lo, float* out,
                                           int n_el) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_el) return;
  const int row = e / kCols;
  out[e] = row < smem_lo && !touched[row]
               ? 0.0f
               : exact_value(acc + (size_t)e * kWords, flags[e]);
}

// Sums terms into elements exactly, one thread a term: the sums of K2,
// alone (ops/replay_vjp.py exact_sum; chip_smoke.py holds it to its plain
// version).
__global__ void exact_sum_kernel(const int* index, const float* values,
                                 int n, u64* acc, unsigned* flags) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Sums sums{nullptr, acc, flags, nullptr, 0};
  sums.add_global((size_t)index[i], values[i]);
}

int finalize(const u64* acc, const unsigned* flags,
             const unsigned char* touched, int smem_lo, float* out,
             int n_el, cudaStream_t stream) {
  if (n_el <= 0) return 0;
  replay_vjp_finalize_kernel<<<(n_el + kBlock - 1) / kBlock, kBlock, 0,
                               stream>>>(acc, flags, touched, smem_lo, out,
                                         n_el);
  return (int)cudaGetLastError();
}

int launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)(a.n_lights * 6 + 1) * kBlock +
      sizeof(u64) * (size_t)(a.n_tab - a.smem_lo) * kCols * kWords;
  cudaError_t err = cudaFuncSetAttribute(
      replay_vjp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, replay_vjp_kernel, kBlock, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (a.n_pad + kBlock - 1) / kBlock;
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  Args arg = a;
  void* args[] = {&arg};
  err = cudaLaunchKernel((const void*)replay_vjp_kernel, dim3(grid),
                         dim3(kBlock), args, smem, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

int tree_nodes(int bounces, bool refl, bool transp) {
  if (refl && transp) return bounces < 30 ? (1 << (bounces + 1)) - 1 : 1 << 30;
  return (refl || transp) ? bounces + 1 : 1;
}

}  // namespace

// Most terms one exact sum may take (each below 2^32 a limb in a 64-bit
// word): ops/replay_vjp.py MAX_TERMS.
constexpr long long kMaxTerms = 1ll << 30;

// Launches the replay backward on `stream`, then the rounding of its sums;
// returns a CUDA error code (0 on success). n_pad (a multiple of 128, >=
// n_rays) is the row count of rays, cot and d_rays and the ray stride of
// codes; rays past n_rays are ignored. `acc` holds n_el = n_tab * 17 +
// n_lights * 8 + 8 sums of kWords words, then n_el 32-bit flags, then
// n_tab bytes of touched rows, all zeroed by the caller; `out` (n_el
// floats) receives the table cotangent (n_tab, 17), then the light rows
// [0, d_vec, d_color, 0] and d_ambient. Table rows from `smem_lo` on are
// summed in shared memory (ops/replay_vjp.py vjp_instance picks it).
// Refuses (cudaErrorInvalidValue) more than 8 lights, more than 63 tree
// nodes, a two-branch tree deeper than the parked-frame stack, a ragged
// n_pad or more than kMaxTerms codes; a shared-memory request past the
// card's limit fails in the launch.
extern "C" int cutrace_replay_vjp(
    const float* rays, const int* codes, const float* cot,
    const float* table, const float* lights, const float* ambient,
    float* d_rays, long long* acc, float* out, int n_rays, int n_pad,
    int k_rows, int n_tab, int t_cnt, int p_cnt, int n_lights, int bounces,
    int shadow_steps, int any_refl, int any_transp, float fudge,
    int smem_lo, void* stream) {
  const bool refl = any_refl != 0, transp = any_transp != 0;
  const int n_nodes = tree_nodes(bounces, refl, transp);
  if (n_lights < 0 || n_lights > kMaxLights || n_nodes > kMaxNodes ||
      (refl && transp && bounces >= kMaxParked) || n_pad % kPad != 0 ||
      n_rays > n_pad || smem_lo < 0 || smem_lo > n_tab ||
      (long long)k_rows * n_pad > kMaxTerms)
    return (int)cudaErrorInvalidValue;
  const int node_rows = 1 + n_lights * (transp ? shadow_steps : 1);
  if (n_nodes * node_rows != k_rows) return (int)cudaErrorInvalidValue;
  const int n_el = n_tab * kCols + n_lights * kLightRows + kLightRows;
  u64* words = reinterpret_cast<u64*>(acc);
  unsigned* flags = reinterpret_cast<unsigned*>(words + (size_t)n_el * kWords);
  unsigned char* touched = reinterpret_cast<unsigned char*>(flags + n_el);
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_rays > 0) {
    Args a{rays, codes, cot, table, lights, ambient, d_rays, words, flags,
           touched, n_rays, n_pad, k_rows, n_tab, t_cnt, p_cnt, n_lights,
           bounces, shadow_steps, n_nodes, node_rows, smem_lo, refl, transp,
           fudge};
    const int err = launch(a, s);
    if (err != 0) return err;
  }
  return finalize(words, flags, touched, smem_lo, out, n_el, s);
}

// Sums `values` (n) into n_el elements by `index` (each in [0, n_el)),
// exactly as K2 sums its cotangents, into `out`; `acc`: n_el sums of
// kWords words, then n_el 32-bit flags, zeroed by the caller. Returns a
// CUDA error code.
extern "C" int cutrace_exact_sum(const int* index, const float* values,
                                 int n, int n_el, long long* acc, float* out,
                                 void* stream) {
  if (n < 0 || n_el < 0 || (long long)n > kMaxTerms)
    return (int)cudaErrorInvalidValue;
  u64* words = reinterpret_cast<u64*>(acc);
  unsigned* flags = reinterpret_cast<unsigned*>(words + (size_t)n_el * kWords);
  const cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    exact_sum_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        index, values, n, words, flags);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return finalize(words, flags, nullptr, 0, out, n_el, s);
}

// The kernel's resources as compiled (registers, local bytes, static
// shared bytes, max threads a block) into out[4]; returns the CUDA error
// code.
extern "C" int cutrace_replay_vjp_attributes(int* out) {
  return cutrace::kernel_attributes(replay_vjp_kernel, out);
}
