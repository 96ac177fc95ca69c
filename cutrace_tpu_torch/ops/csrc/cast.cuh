// Ray-primitive tests and cluster loops shared by the port's cast kernels:
// the fused forward (csrc/fused_forward.cu, K1 and K3) and the
// cluster-culled nearest-triangle query (csrc/cluster_cast.cu, K4).
//
// Every position is recentered by the scene center. Triangles use the
// precomputed constants n, ub, ug, a, b, k of the identity form
// (cutrace_tpu/ops/pallas_cast.py:_cluster_constants):
//   alpha = d.n   beta = (d.ub - w.b)/alpha   gamma = (w.a - d.ug)/alpha
//   t = (k - o.n)/alpha                       with w = d x o.
// The nearest triangle is the (t, original index) lexicographic minimum.
// A slot test reads the slot's first kSlotRead rows as five 16-byte
// vector loads (a 96-byte slot row starts on a 16-byte boundary of a
// torch allocation). Every kernel runs the same tri_t, so K1, K3 and K4
// round alike.
//
// Two cluster loops cull with a per-ray slab test against the ray's
// best t so far (ties kept with <=), the lanes of a warp together:
//   * the flat loop (K1, and K4 up to 32 clusters) tests every cluster box
//     in index order;
//   * the ordered tree walk (K3, and K4 past 32 clusters) descends a
//     complete binary tree over the clusters (ops/bvh.py tree_boxes: node
//     n's children are 2n and 2n + 1, the leaves are the clusters),
//     entering the child nearer for most lanes first and deferring the
//     other on a stack; a deferred node is dropped when popped past every
//     lane's best t (walk_tree).
// Visiting clusters nearest first finds a near winner early, so it culls
// more, but a new order can cull a cluster that index order visited: a
// rounded triangle t may fall before its own box's rounded entry, and the
// cluster is then dropped once a winner between the two is known. The
// tree's boxes (its leaves too) are therefore widened outward by
// bvh.TREE_MARGIN = 1e-4 of the scene's extent, well past the float32
// rounding of either t at the scene's scale, so the walk only admits
// more than an exact cull would: its winners are the flat loop's, or a
// triangle the flat loop's rounding dropped.
//
// K1 and K3 have a second level of boxes below the cluster: each run of
// kSubSlots = 32 consecutive slots (a group, spatially compact: ops/bvh.py
// group_slots orders a cluster's slots so) has its own box, widened by
// the same margin (ops/bvh.py sub_boxes). An admitted cluster's rays test
// its groups' boxes against the same cull and read only the slot rows of
// the groups they enter, skipping a group entered past the best t found
// so far. K3's walk does so through visit_nearest_sub and visit_any_sub
// (8 or 16 groups a cluster); K1's flat loop, at C = 64 or 128 (2 or 4
// groups), loops over an admitted cluster's groups as over clusters,
// each lane testing its own ray against each group box and the group's
// slots visited as a cluster's are (visit_nearest_warp over the group's
// slot range). The widening keeps the argument above: the group cull
// only admits more than an exact cull of the groups would, so K1's
// winners stay the flat loop's (t, key) minimum. K4 visits whole
// clusters.
//
// K1's flat loop first tests the root box: per axis the least and the
// greatest bound of the M cluster boxes (both corners of each, so a box
// whose low exceeds its high counts too), NaN on an axis where any box
// has a NaN, in float32 and not widened (root_box, once a block). The
// slab test of the root box admits whatever the slab test of any cluster
// box admits, at an entry no later:
//   * on an axis the root gives no NaN, each cluster bound x lies in
//     [lo, hi] of the root's, and (x - o) * inv, each step rounded, is
//     monotone in x, so the root's interval on that axis holds the
//     cluster's. A cluster bound that makes a NaN there (the cluster
//     then unbounded on that axis) does so by 0 * inf: x = o on an axis
//     the ray parallels, and then lo < o < hi (a root bound equal to o
//     would make its own NaN), so the root's interval is [-inf, inf],
//     no narrower after the clamp at 0; or x - o = +-inf with inv = 0,
//     and then the root's bound on that side gives the same infinity,
//     so a NaN;
//   * on an axis the root gives a NaN, the root is unbounded there.
// So the root's entry is <= and its exit >= each cluster's. A lane whose
// ray misses the root box, or enters it past its cull, is admitted by no
// cluster: it tests no cluster box and takes part in the warp's votes
// with nothing admitted, and a warp with no lane in the root box leaves
// the loop at once. Winners, outputs and topology codes are the loop's
// without the root test, bit for bit, with no widening margin. K3 starts
// its walk at the tree's (widened) root instead; K4 tests no root box
// (Clusters.root null). An empty cluster's box, the far point of ops/bvh.py
// _FAR, stretches the root out to that point: still exact, less culled.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attributes.cuh"

namespace cutrace {

constexpr int kTriRows = 24;    // floats per triangle slot
constexpr int kSlotRead = 20;   // rows a slot test reads: five float4s
constexpr int kPsRows = 12;     // floats per plane / sphere row
constexpr int kAabbRows = 8;    // floats per cluster or tree box row
constexpr int kTreeArity = 2;   // children per node (ops/bvh.py TREE_ARITY)
constexpr int kTreeStack = 32;  // deferred nodes: one per tree level at most
constexpr int kSubSlots = 32;   // slots a sub-box covers (bvh.py SUB_GROUP)
constexpr int kMaxGroups = 32;  // groups a cluster: one bit each in a mask
constexpr float kBig = 1073741824.0f;  // 2^30: key of "no winner"

// triangle slot rows (cutrace_tpu_torch/ops/pallas_cast.py _TRI_NAMES)
constexpr int T_N = 0, T_UB = 3, T_UG = 6, T_A = 9, T_B = 12, T_K = 15;
constexpr int T_ORDER = 16, T_VALID = 17, T_SN = 18, T_OBJ = 21, T_MAT = 22;
// plane / sphere rows (cutrace_tpu_torch/ops/fused.py _PS_*)
constexpr int P_OBJ = 0, P_N = 1, P_C = 4, P_K = 7, P_VALID = 8;
constexpr int P_MAT = 9;

static_assert(kTriRows % 4 == 0 && kSlotRead % 4 == 0 &&
                  kSlotRead <= kTriRows && T_K < kSlotRead &&
                  T_ORDER < kSlotRead && T_VALID < kSlotRead,
              "a slot test reads whole float4s of its slot's row");
static_assert(kAabbRows == 8, "a box row is two float4s");

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float norm3(V3 a) { return sqrtf(dot3(a, a)); }
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

// Work counts of one thread: casts (nearest or any-hit queries), the
// (ray, cluster) visits their culls admitted, the slab tests done (root,
// cluster or tree boxes), when `count_needed` the visits the casts need
// whatever the traversal (needed_visits), in the group culls (K1, K3)
// the group box tests of the admitted visits and the groups whose slots
// were tested (0 in K4), and in K1 the casts whose ray failed the root
// box test and so tested no cluster box (0 in K3 and K4).
struct Tally {
  unsigned long long casts = 0, visits = 0, slabs = 0, needed = 0;
  unsigned long long sub_slabs = 0, groups = 0, root_skips = 0;
  bool count_needed = false;
};

// The tally's counts (ops/pallas_cast.py TALLY_COUNTS).
constexpr int kTallyCounts = 7;

// The counts of a launch without a tally (K1's kernels): each += compiles
// to nothing, so the kernel holds no counters.
struct NoCount {
  __device__ __forceinline__ NoCount& operator+=(unsigned long long) {
    return *this;
  }
};
struct NoTally {
  NoCount casts, visits, slabs, needed, sub_slabs, groups, root_skips;
  static constexpr bool count_needed = false;
};

__device__ __forceinline__ void flush_tally(unsigned long long*,
                                            const NoTally&) {}

__device__ __forceinline__ void flush_tally(unsigned long long* out,
                                            const Tally& tl) {
  if (!out) return;
  atomicAdd(out, tl.casts);
  atomicAdd(out + 1, tl.visits);
  atomicAdd(out + 2, tl.slabs);
  atomicAdd(out + 3, tl.needed);
  atomicAdd(out + 4, tl.sub_slabs);
  atomicAdd(out + 5, tl.groups);
  atomicAdd(out + 6, tl.root_skips);
}

// Slab entry of a ray against one box (rows bmin xyz, bmax xyz, read as
// two float4s). A NaN (0 * inf) bound makes that axis unbounded.
__device__ __forceinline__ bool slab(const float* box, V3 o, V3 inv,
                                     float* entry) {
  const float4 b0 = reinterpret_cast<const float4*>(box)[0];
  const float4 b1 = reinterpret_cast<const float4*>(box)[1];
  const float bl[3] = {b0.x, b0.y, b0.z};
  const float bh[3] = {b0.w, b1.x, b1.y};
  float lo[3], hi[3];
  const float oc[3] = {o.x, o.y, o.z};
  const float ic[3] = {inv.x, inv.y, inv.z};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float t1 = (bl[a] - oc[a]) * ic[a];
    float t2 = (bh[a] - oc[a]) * ic[a];
    if (isnan(t1) || isnan(t2)) {
      lo[a] = 0.0f;
      hi[a] = INFINITY;
    } else {
      lo[a] = fminf(t1, t2);
      hi[a] = fmaxf(t1, t2);
    }
  }
  float tmn = fmaxf(fmaxf(lo[0], lo[1]), fmaxf(lo[2], 0.0f));
  float tmx = fminf(fminf(hi[0], hi[1]), hi[2]);
  *entry = tmn;
  return tmn <= tmx;
}

// Rows 4j..4j+3 of one slot, as one float4 load, into r.
__device__ __forceinline__ void load_rows(const float* slot, int j,
                                          float (&r)[kSlotRead]) {
  const float4 v = reinterpret_cast<const float4*>(slot)[j];
  r[4 * j] = v.x;
  r[4 * j + 1] = v.y;
  r[4 * j + 2] = v.z;
  r[4 * j + 3] = v.w;
}

// Triangle t for one slot's rows, or +inf when the ray misses it
// (w = d x o); `key` receives the slot's original index.
__device__ __forceinline__ float tri_t(const float* slot, V3 o, V3 d, V3 w,
                                       float mind, float* key) {
  float s[kSlotRead];
#pragma unroll
  for (int j = 0; j < kSlotRead / 4; ++j) load_rows(slot, j, s);
  *key = s[T_ORDER];
  if (!(s[T_VALID] > 0.0f)) return INFINITY;
  float alpha = d.x * s[T_N] + d.y * s[T_N + 1] + d.z * s[T_N + 2];
  float beta_n = (d.x * s[T_UB] + d.y * s[T_UB + 1] + d.z * s[T_UB + 2]) -
                 (w.x * s[T_B] + w.y * s[T_B + 1] + w.z * s[T_B + 2]);
  float gamma_n = (w.x * s[T_A] + w.y * s[T_A + 1] + w.z * s[T_A + 2]) -
                  (d.x * s[T_UG] + d.y * s[T_UG + 1] + d.z * s[T_UG + 2]);
  float t_n = s[T_K] - (o.x * s[T_N] + o.y * s[T_N + 1] + o.z * s[T_N + 2]);
  if (alpha == 0.0f) return INFINITY;
  float inv = 1.0f / alpha;
  float beta = beta_n * inv;
  float gamma = gamma_n * inv;
  float t = t_n * inv;
  bool ok = beta >= 0.0f && gamma >= 0.0f && beta + gamma <= 1.0f &&
            isfinite(t) && t > mind;
  return ok ? t : INFINITY;
}

__device__ __forceinline__ float plane_t(const float* p, V3 o, V3 d,
                                         float mind) {
  V3 n = load3(p + P_N);
  float denom = dot3(d, n);
  float on = dot3(o, n);
  float t = (p[P_K] - on) / (denom == 0.0f ? 1.0f : denom);
  bool ok = denom != 0.0f && isfinite(t) && t > mind && p[P_VALID] > 0.0f;
  return ok ? t : INFINITY;
}

// Sphere t in the normalized direction nd; an exact tangent is a miss.
__device__ __forceinline__ float sphere_t(const float* p, V3 o, V3 nd,
                                          float mind) {
  V3 c = load3(p + P_C);
  float dec = dot3(nd, c) - dot3(nd, o);
  float oc = dot3(o, c);
  float ec2 = dot3(o, o) - 2.0f * oc + dot3(c, c);
  float sub = dec * dec - (ec2 - p[P_K]);
  bool missed = sub <= 0.0f;
  float sq = sqrtf(missed ? 1.0f : sub);
  float t0 = dec - sq, t1 = dec + sq;
  bool v0 = !missed && isfinite(t0) && t0 > mind;
  bool v1 = !missed && isfinite(t1) && t1 > mind;
  float t = (v0 && v1) ? fminf(t0, t1) : (v0 ? t0 : (v1 ? t1 : INFINITY));
  return ((v0 || v1) && p[P_VALID] > 0.0f) ? t : INFINITY;
}

// A cluster partition: (M, C, kTriRows) slot rows and (M, kAabbRows)
// cluster boxes; (2L, kAabbRows) widened tree boxes for the tree walk, L the
// power of two >= M, node n at row n (row 1 the root, rows L..L+M-1 the
// clusters), null for the flat loop; (M, G, kAabbRows) widened sub-boxes,
// G = ceil(C / kSubSlots), box g over slots kSubSlots g onwards, for the
// group culls (K1, K3), null otherwise (K4); one kAabbRows root box over
// the cluster boxes (root_box, in shared memory) for K1's flat loop, null
// otherwise (K3, K4). Slot offsets are size_t: a 1M-triangle table holds
// 25M floats.
struct Clusters {
  const float* tri;
  const float* aabb;
  const float* tree;
  int m, c, leaves;
  const float* sub;
  const float* root;
};

// The lesser / greater of two floats, NaN if either is (fminf and fmaxf
// drop a NaN).
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// The root box of the m <= 32 cluster boxes at `aabb` (K1's partitions;
// see the note at the top) into root[0..kAabbRows), by the 32 lanes of
// one warp: lane mi takes box mi, then shuffles fold the lanes.
__device__ __forceinline__ void root_box(const float* aabb, int m,
                                         float* root) {
  const int lane = threadIdx.x & 31;
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  if (lane < m) {
    const float* box = aabb + (size_t)lane * kAabbRows;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = nan_min(box[a], box[3 + a]);
      hi[a] = nan_max(box[a], box[3 + a]);
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int off = 16; off > 0; off >>= 1) {
      lo[a] = nan_min(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
      hi[a] = nan_max(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      root[a] = lo[a];
      root[3 + a] = hi[a];
    }
    root[6] = root[7] = 0.0f;
  }
}

// Groups of a cluster's slots, each under one sub-box.
__device__ __forceinline__ int sub_groups(const Clusters& cl) {
  return (cl.c + kSubSlots - 1) / kSubSlots;
}

// The nearest winner: t, its key (original index) and its slot
// (cluster * C + slot), -1 when nothing won.
struct TriWinner {
  float t = INFINITY, key = kBig;
  int slot = -1;
};

__device__ __forceinline__ V3 cross_do(V3 d, V3 o) {
  return v3(d.y * o.z - d.z * o.y, d.z * o.x - d.x * o.z,
            d.x * o.y - d.y * o.x);
}

// ---- one lane a ray (slots that many lanes of a warp visit) -----------
//
// A visit reads slots lo..hi-1 of cluster mi: all C of them, or one
// group's.

__device__ __forceinline__ void visit_nearest(const Clusters& cl, int mi,
                                              int lo, int hi, V3 o, V3 d,
                                              V3 w, float mind,
                                              TriWinner& b) {
  const float* slot = cl.tri + ((size_t)mi * cl.c + lo) * kTriRows;
  for (int ci = lo; ci < hi; ++ci, slot += kTriRows) {
    float key;
    float t = tri_t(slot, o, d, w, mind, &key);
    if (!isfinite(t)) continue;
    if (t < b.t || (t == b.t && key < b.key)) {
      b.t = t;
      b.key = key;
      b.slot = mi * cl.c + ci;
    }
  }
}

__device__ __forceinline__ bool visit_any(const Clusters& cl, int mi, int lo,
                                          int hi, V3 o, V3 d, V3 w,
                                          float mind, float ldist) {
  const float* slot = cl.tri + ((size_t)mi * cl.c + lo) * kTriRows;
  float key;
  for (int ci = lo; ci < hi; ++ci, slot += kTriRows)
    if (tri_t(slot, o, d, w, mind, &key) < ldist) return true;
  return false;
}

// ---- the lanes of a warp together (K1, K4) ----------------------------
//
// The lanes of `mask` (those that entered the loop together) walk the
// same clusters at the same time, each with its own cull. L slots (a
// cluster's C, or a group's) that k lanes admit are visited in one of two
// ways, whichever issues fewer warp steps (a step is one slot test in
// every lane):
//   * together: the k lanes scan the L slots side by side, L steps whose
//     loads are broadcasts of one row;
//   * in turn: for each admitting lane, its ray is handed to every lane
//     of the mask, which test slots rank, rank + n, ... (n lanes), and a
//     warp reduction keeps the (t, key) minimum: k (L / n + kReduceSteps)
//     steps, with n independent rows loaded at once.
// Coherent rays (bunny's primary rays, many lanes a cluster, L1-resident
// tables) favour the first; scattered secondary rays over tables in L2 or
// HBM (one or two lanes a visit, where a lone lane's scan waits on L loads
// in a row) the second. Either finds the winner a lane's own scan of the
// L slots finds. K1 chooses per visit by that count; K4, whose launches
// are mostly shadow and bounce rays, visits in turn always (kInTurn).
constexpr int kReduceSteps = 2;  // a visit's reductions, in slot-test steps

// Visit `len` slots in turn (true) or together (false)?
__device__ __forceinline__ bool visit_in_turn(int len, int k, int n) {
  return k * ((len + n - 1) / n + kReduceSteps) < len;
}

// A float's bits as an unsigned that orders like the float.
__device__ __forceinline__ unsigned sortable(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ V3 shfl3(unsigned mask, V3 a, int src) {
  return v3(__shfl_sync(mask, a.x, src), __shfl_sync(mask, a.y, src),
            __shfl_sync(mask, a.z, src));
}

// The nearest triangle of slots lo..hi-1 of cluster mi for each lane of
// `mask` with `visit` set, merged into its `b`; kInTurn: in turn whatever
// the count.
template <bool kInTurn = false>
__device__ __forceinline__ void visit_nearest_warp(
    const Clusters& cl, int mi, int lo, int hi, unsigned mask, bool visit,
    V3 o, V3 d, V3 w, float mind, TriWinner& b) {
  const unsigned lane_bit = 1u << (threadIdx.x & 31);
  const int rank = __popc(mask & (lane_bit - 1));
  const int n = __popc(mask);
  const float* base = cl.tri + (size_t)mi * cl.c * kTriRows;
  unsigned todo = __ballot_sync(mask, visit);
  if (!kInTurn && !visit_in_turn(hi - lo, __popc(todo), n)) {
    if (visit) visit_nearest(cl, mi, lo, hi, o, d, w, mind, b);
    return;
  }
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const V3 so = shfl3(mask, o, src), sd = shfl3(mask, d, src);
    const V3 sw = shfl3(mask, w, src);
    const float smind = __shfl_sync(mask, mind, src);
    float bt = INFINITY, bk = kBig;
    int bs = -1;
    for (int ci = lo + rank; ci < hi; ci += n) {
      float key;
      const float t =
          tri_t(base + (size_t)ci * kTriRows, so, sd, sw, smind, &key);
      if (isfinite(t) && (t < bt || (t == bt && key < bk))) {
        bt = t;
        bk = key;
        bs = ci;
      }
    }
    const unsigned ut = sortable(bt);
    const unsigned tmin = __reduce_min_sync(mask, ut);
    const unsigned kmin =
        __reduce_min_sync(mask, ut == tmin ? (unsigned)bk : 0xffffffffu);
    const unsigned smin = __reduce_min_sync(
        mask, (ut == tmin && (unsigned)bk == kmin) ? (unsigned)bs
                                                   : 0xffffffffu);
    if (lane_bit == (1u << src) && smin != 0xffffffffu) {
      const float wt = __uint_as_float((tmin & 0x80000000u)
                                           ? (tmin & 0x7fffffffu)
                                           : ~tmin);
      const float wk = (float)kmin;
      if (wt < b.t || (wt == b.t && wk < b.key)) {
        b.t = wt;
        b.key = wk;
        b.slot = mi * cl.c + (int)smin;
      }
    }
  }
}

// For each lane of `mask` with `visit` set: do slots lo..hi-1 of cluster
// mi hold a triangle with mind < t < ldist? Lanes without a visit get
// false.
__device__ __forceinline__ bool visit_any_warp(const Clusters& cl, int mi,
                                               int lo, int hi,
                                               unsigned mask, bool visit,
                                               V3 o, V3 d, V3 w, float mind,
                                               float ldist) {
  const unsigned lane_bit = 1u << (threadIdx.x & 31);
  const int rank = __popc(mask & (lane_bit - 1));
  const int n = __popc(mask);
  const float* base = cl.tri + (size_t)mi * cl.c * kTriRows;
  unsigned todo = __ballot_sync(mask, visit);
  if (!visit_in_turn(hi - lo, __popc(todo), n))
    return visit && visit_any(cl, mi, lo, hi, o, d, w, mind, ldist);
  bool found = false;
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const V3 so = shfl3(mask, o, src), sd = shfl3(mask, d, src);
    const V3 sw = shfl3(mask, w, src);
    const float smind = __shfl_sync(mask, mind, src);
    const float sld = __shfl_sync(mask, ldist, src);
    bool hit = false;
    for (int c0 = lo; c0 < hi; c0 += n) {
      const int ci = c0 + rank;
      float key;
      hit = ci < hi && tri_t(base + (size_t)ci * kTriRows, so, sd, sw,
                             smind, &key) < sld;
      if (__any_sync(mask, hit)) {
        hit = true;
        break;
      }
    }
    if (lane_bit == (1u << src)) found = hit;
  }
  return found;
}

// ---- K3's sub-box walk: a cluster's groups, each under a box ----------
//
// A visit first finds, for each admitting lane, the groups of the cluster
// whose (widened) box its ray enters before its cut: the warp tests one
// admitting lane's ray at a time, lane rank taking groups rank, rank + n,
// ..., or each lane tests every group for its own ray, whichever takes
// fewer steps (entered_groups). Then, as for whole clusters, whichever
// takes fewer steps of slot tests, now counted over the entered groups:
//   * in turn: for each admitting lane, the warp scans that lane's entered
//     groups one after another, a group's 32 slots spread over the lanes,
//     and one warp reduction at the end keeps the (t, key) minimum;
//   * together: the warp runs over the union of the entered groups, each
//     lane scanning a group's 32 slots itself if its ray entered it.
// Either way a group is scanned in index order and skipped when its entry
// lies past the best t found so far (nearest casts), or once a hit is
// found (any-hit queries).

// A float from its sortable() bits.
__device__ __forceinline__ float unsortable(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// A bit per group g = first, first + step, ... of cluster mi whose sub-box
// the ray enters at or before `cut` (kAny: strictly before it).
template <bool kAny>
__device__ __forceinline__ unsigned sub_entered(const Clusters& cl, int mi,
                                                int first, int step, V3 o,
                                                V3 inv, float cut) {
  const int groups = sub_groups(cl);
  const float* box = cl.sub + (size_t)mi * groups * kAabbRows;
  unsigned bits = 0;
  float entry;
  for (int g = first; g < groups; g += step)
    if (slab(box + (size_t)g * kAabbRows, o, inv, &entry) &&
        (kAny ? entry < cut : entry <= cut))
      bits |= 1u << g;
  return bits;
}

// For each lane of `todo` (the admitting lanes of `mask`): the groups of
// cluster mi its ray enters before its `cut`; 0 in the other lanes.
template <bool kAny>
__device__ __forceinline__ unsigned entered_groups(const Clusters& cl,
                                                   int mi, unsigned mask,
                                                   unsigned todo, int rank,
                                                   int n, V3 o, V3 inv,
                                                   float cut) {
  const int groups = sub_groups(cl);
  const unsigned lane_bit = 1u << (threadIdx.x & 31);
  if (__popc(todo) * ((groups + n - 1) / n) > groups)
    return (todo & lane_bit) ? sub_entered<kAny>(cl, mi, 0, 1, o, inv, cut)
                             : 0u;
  unsigned mine = 0;
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const V3 so = shfl3(mask, o, src), sinv = shfl3(mask, inv, src);
    const float scut = __shfl_sync(mask, cut, src);
    const unsigned got = __reduce_or_sync(
        mask, sub_entered<kAny>(cl, mi, rank, n, so, sinv, scut));
    if (lane_bit == (1u << src)) mine = got;
  }
  return mine;
}

// In turn (true) or together (false), from the entered groups: k
// admitting lanes whose rays entered `total` groups in all, `distinct` of
// them different, over n lanes (see visit_in_turn).
__device__ __forceinline__ bool groups_in_turn(int k, int total,
                                               int distinct, int n) {
  return total * ((kSubSlots + n - 1) / n) + k * kReduceSteps <
         distinct * kSubSlots;
}

// visit_nearest_warp's work for K3: the nearest triangle of cluster mi for
// each lane of `mask` with `visit` set, over the groups its ray enters
// at or before min(limit, its best t), merged into its `b`.
__device__ __forceinline__ void visit_nearest_sub(
    const Clusters& cl, int mi, unsigned mask, bool visit, V3 o, V3 d, V3 w,
    V3 inv, float mind, float limit, TriWinner& b, Tally& tl) {
  const unsigned lane_bit = 1u << (threadIdx.x & 31);
  const int rank = __popc(mask & (lane_bit - 1));
  const int n = __popc(mask);
  const int groups = sub_groups(cl);
  const float* base = cl.tri + (size_t)mi * cl.c * kTriRows;
  const float* boxes = cl.sub + (size_t)mi * groups * kAabbRows;
  unsigned todo = __ballot_sync(mask, visit);
  const float cut = fminf(limit, b.t);
  const unsigned gm =
      entered_groups<false>(cl, mi, mask, todo, rank, n, o, inv, cut);
  if (visit) tl.sub_slabs += groups;
  const unsigned entered = __reduce_or_sync(mask, gm);
  const int total = (int)__reduce_add_sync(mask, (unsigned)__popc(gm));
  if (!groups_in_turn(__popc(todo), total, __popc(entered), n)) {
    float entry;
    for (unsigned left = entered; left; left &= left - 1) {
      const int g = __ffs(left) - 1;
      bool scan = (gm >> g) & 1u;
      // a winner found since the test may put the group past it
      if (scan && b.t < cut)
        scan = slab(boxes + (size_t)g * kAabbRows, o, inv, &entry) &&
               entry <= fminf(limit, b.t);
      if (!scan) continue;
      tl.groups += 1;
      const int end = min(cl.c, (g + 1) * kSubSlots);
      for (int ci = g * kSubSlots; ci < end; ++ci) {
        float key;
        const float t =
            tri_t(base + (size_t)ci * kTriRows, o, d, w, mind, &key);
        if (isfinite(t) && (t < b.t || (t == b.t && key < b.key))) {
          b.t = t;
          b.key = key;
          b.slot = mi * cl.c + ci;
        }
      }
    }
    return;
  }
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const V3 so = shfl3(mask, o, src), sd = shfl3(mask, d, src);
    const V3 sw = shfl3(mask, w, src), sinv = shfl3(mask, inv, src);
    const float smind = __shfl_sync(mask, mind, src);
    const float scut = __shfl_sync(mask, cut, src);
    float bt = INFINITY, bk = kBig;
    int bs = -1;
    bool first = true;
    for (unsigned left = __shfl_sync(mask, gm, src); left;
         left &= left - 1) {
      const int g = __ffs(left) - 1;
      if (!first) {
        // skip the group if its entry lies past the best t so far
        const float best =
            fminf(scut, unsortable(__reduce_min_sync(mask, sortable(bt))));
        float entry;
        slab(boxes + (size_t)g * kAabbRows, so, sinv, &entry);
        if (entry > best) continue;
      }
      first = false;
      if (lane_bit == (1u << src)) tl.groups += 1;
      const int end = min(cl.c, (g + 1) * kSubSlots);
      for (int ci = g * kSubSlots + rank; ci < end; ci += n) {
        float key;
        const float t =
            tri_t(base + (size_t)ci * kTriRows, so, sd, sw, smind, &key);
        if (isfinite(t) && (t < bt || (t == bt && key < bk))) {
          bt = t;
          bk = key;
          bs = ci;
        }
      }
    }
    const unsigned ut = sortable(bt);
    const unsigned tmin = __reduce_min_sync(mask, ut);
    const unsigned kmin =
        __reduce_min_sync(mask, ut == tmin ? (unsigned)bk : 0xffffffffu);
    const unsigned smin = __reduce_min_sync(
        mask, (ut == tmin && (unsigned)bk == kmin) ? (unsigned)bs
                                                   : 0xffffffffu);
    if (lane_bit == (1u << src) && smin != 0xffffffffu) {
      const float wt = unsortable(tmin);
      const float wk = (float)kmin;
      if (wt < b.t || (wt == b.t && wk < b.key)) {
        b.t = wt;
        b.key = wk;
        b.slot = mi * cl.c + (int)smin;
      }
    }
  }
}

// visit_any_warp's work for K3: for each lane of `mask` with `visit` set,
// does a group of cluster mi its ray enters before ldist hold a triangle
// with mind < t < ldist? Lanes without a visit get false.
__device__ __forceinline__ bool visit_any_sub(const Clusters& cl, int mi,
                                              unsigned mask, bool visit,
                                              V3 o, V3 d, V3 w, V3 inv,
                                              float mind, float ldist,
                                              Tally& tl) {
  const unsigned lane_bit = 1u << (threadIdx.x & 31);
  const int rank = __popc(mask & (lane_bit - 1));
  const int n = __popc(mask);
  const int groups = sub_groups(cl);
  const float* base = cl.tri + (size_t)mi * cl.c * kTriRows;
  unsigned todo = __ballot_sync(mask, visit);
  const unsigned gm =
      entered_groups<true>(cl, mi, mask, todo, rank, n, o, inv, ldist);
  if (visit) tl.sub_slabs += groups;
  const unsigned entered = __reduce_or_sync(mask, gm);
  const int total = (int)__reduce_add_sync(mask, (unsigned)__popc(gm));
  if (!groups_in_turn(__popc(todo), total, __popc(entered), n)) {
    bool hit = false;
    for (unsigned left = entered; left && !hit; left &= left - 1) {
      const int g = __ffs(left) - 1;
      if (!((gm >> g) & 1u)) continue;
      tl.groups += 1;
      const int end = min(cl.c, (g + 1) * kSubSlots);
      float key;
      for (int ci = g * kSubSlots; ci < end && !hit; ++ci)
        hit = tri_t(base + (size_t)ci * kTriRows, o, d, w, mind, &key) <
              ldist;
    }
    return hit;
  }
  bool found = false;
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const V3 so = shfl3(mask, o, src), sd = shfl3(mask, d, src);
    const V3 sw = shfl3(mask, w, src);
    const float smind = __shfl_sync(mask, mind, src);
    const float sld = __shfl_sync(mask, ldist, src);
    bool hit = false;
    for (unsigned left = __shfl_sync(mask, gm, src); left && !hit;
         left &= left - 1) {
      const int g = __ffs(left) - 1;
      if (lane_bit == (1u << src)) tl.groups += 1;
      for (int c0 = g * kSubSlots; c0 < (g + 1) * kSubSlots; c0 += n) {
        const int ci = c0 + rank;
        float key;
        hit = ci < min(cl.c, (g + 1) * kSubSlots) &&
              tri_t(base + (size_t)ci * kTriRows, so, sd, sw, smind, &key) <
                  sld;
        if (__any_sync(mask, hit)) {
          hit = true;
          break;
        }
      }
    }
    if (lane_bit == (1u << src)) found = hit;
  }
  return found;
}

// The flat loop: the nearest triangle with t > mind over every cluster
// in index order, each lane culling against min(bound, its best t). With
// kSub (K1) the root box goes first (see the note at the top), and an
// admitted cluster's groups are culled the same way, one after another,
// and each admitted group's slots visited, in turn or together by the
// count; else (K4) the cluster's C slots are, in turn. T: Tally or NoTally.
template <bool kSub, class T>
__device__ __forceinline__ void nearest_triangle_flat(const Clusters& cl,
                                                      V3 o, V3 d, float mind,
                                                      float bound,
                                                      TriWinner& b, T& tl) {
  const unsigned mask = __activemask();
  const V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  float entry;
  bool out = false;  // outside the root box: no cluster admits the ray
  if (kSub) {
    tl.slabs += 1;
    out = !(slab(cl.root, o, inv, &entry) && entry <= fminf(bound, b.t));
    if (out) tl.root_skips += 1;
    if (__all_sync(mask, out)) return;
  }
  const V3 w = cross_do(d, o);
  for (int mi = 0; mi < cl.m; ++mi) {
    bool mine = false;
    if (!out) {
      tl.slabs += 1;
      mine = slab(cl.aabb + (size_t)mi * kAabbRows, o, inv, &entry) &&
             entry <= fminf(bound, b.t);
    }
    if (!__any_sync(mask, mine)) continue;
    if (mine) tl.visits += 1;
    if (!kSub) {
      visit_nearest_warp<true>(cl, mi, 0, cl.c, mask, mine, o, d, w, mind, b);
      continue;
    }
    const int groups = sub_groups(cl);
    const float* boxes = cl.sub + (size_t)mi * groups * kAabbRows;
    for (int g = 0; g < groups; ++g) {
      bool in = false;
      if (mine) {
        tl.sub_slabs += 1;
        in = slab(boxes + (size_t)g * kAabbRows, o, inv, &entry) &&
             entry <= fminf(bound, b.t);
      }
      if (!__any_sync(mask, in)) continue;
      if (in) tl.groups += 1;
      visit_nearest_warp(cl, mi, g * kSubSlots,
                         min(cl.c, (g + 1) * kSubSlots), mask, in, o, d, w,
                         mind, b);
    }
  }
}

// K1's occlusion query: any triangle with mind < t < ldist, the root,
// cluster and group boxes entered at or beyond ldist skipped; a lane
// stops visiting once it has a hit.
template <class T>
__device__ __forceinline__ bool any_triangle_flat(const Clusters& cl, V3 o,
                                                  V3 d, float mind,
                                                  float ldist, T& tl) {
  const unsigned mask = __activemask();
  const V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  float entry;
  tl.slabs += 1;
  // outside the root box: no cluster admits the ray
  const bool out = !(slab(cl.root, o, inv, &entry) && entry < ldist);
  if (out) tl.root_skips += 1;
  if (__all_sync(mask, out)) return false;
  const V3 w = cross_do(d, o);
  bool found = false;
  for (int mi = 0; mi < cl.m; ++mi) {
    bool mine = false;
    if (!found && !out) {
      tl.slabs += 1;
      mine = slab(cl.aabb + (size_t)mi * kAabbRows, o, inv, &entry) &&
             entry < ldist;
    }
    if (!__any_sync(mask, mine)) {
      if (__all_sync(mask, found || out)) break;
      continue;
    }
    if (mine) tl.visits += 1;
    const int groups = sub_groups(cl);
    const float* boxes = cl.sub + (size_t)mi * groups * kAabbRows;
    for (int g = 0; g < groups; ++g) {
      bool in = false;
      if (mine && !found) {
        tl.sub_slabs += 1;
        in = slab(boxes + (size_t)g * kAabbRows, o, inv, &entry) &&
             entry < ldist;
      }
      if (!__any_sync(mask, in)) continue;
      if (in) tl.groups += 1;
      found |= visit_any_warp(cl, mi, g * kSubSlots,
                              min(cl.c, (g + 1) * kSubSlots), mask, in, o, d,
                              w, mind, ldist);
    }
  }
  return found;
}

// The ordered walk over the cluster tree (see the note at the top): the
// nearest triangle with t > mind, into `b`, under the same cull as the
// flat loop against the widened tree boxes. kAny turns it into the
// occlusion query against `limit` = ldist (entries strictly before it; a
// lane stops admitting nodes once it finds a triangle before it);
// otherwise `limit` is the plane/sphere bound. Returns whether the
// occlusion query found a hit.
//
// The lanes that enter together walk together: the node and the stack of
// deferred nodes are the same in every lane (each decision is a vote), and
// each lane keeps its own cull, its entry of each deferred node (NaN where
// it did not admit it) and its best t. A node is entered when any lane
// admits it, and a cluster is visited (visit_nearest_warp, or with kSub
// the sub-box walk's visit_nearest_sub) for the lanes that admitted it.
// When a lane admits both children, the nearer one is its preference, and
// the child most lanes prefer goes first.
template <bool kAny, bool kInTurn = false, bool kSub = false>
__device__ __forceinline__ bool walk_tree(const Clusters& cl, V3 o, V3 d,
                                          float mind, float limit,
                                          TriWinner& b, Tally& tl) {
  const unsigned mask = __activemask();
  const V3 w = cross_do(d, o);
  const V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  bool found = false;
  auto admits = [&](float entry) {
    return !found && (kAny ? entry < limit : entry <= fminf(limit, b.t));
  };
  int stack_node[kTreeStack];     // the same in every lane
  float stack_entry[kTreeStack];  // this lane's entry, NaN: not admitted
  int sp = 0;
  float entry;
  tl.slabs += 1;
  bool mine = slab(cl.tree + kAabbRows, o, inv, &entry) && admits(entry);
  if (!__any_sync(mask, mine)) return false;
  int node = 1;
  while (true) {
    if (node >= cl.leaves) {
      const int mi = node - cl.leaves;
      if (mi < cl.m) {
        if (mine) tl.visits += 1;
        if (kSub && kAny)
          found |= visit_any_sub(cl, mi, mask, mine, o, d, w, inv, mind,
                                 limit, tl);
        else if (kSub)
          visit_nearest_sub(cl, mi, mask, mine, o, d, w, inv, mind, limit, b,
                            tl);
        else if (kAny)
          found |= visit_any_warp(cl, mi, 0, cl.c, mask, mine, o, d, w, mind,
                                  limit);
        else
          visit_nearest_warp<kInTurn>(cl, mi, 0, cl.c, mask, mine, o, d, w,
                                      mind, b);
      }
    } else {
      const int c0 = kTreeArity * node;
      float e0 = 0.0f, e1 = 0.0f;
      bool h0 = false, h1 = false;
      if (mine) {
        tl.slabs += 2;
        h0 = slab(cl.tree + (size_t)c0 * kAabbRows, o, inv, &e0) &&
             admits(e0);
        h1 = slab(cl.tree + (size_t)(c0 + 1) * kAabbRows, o, inv, &e1) &&
             admits(e1);
      }
      const bool any0 = __any_sync(mask, h0), any1 = __any_sync(mask, h1);
      if (any0 || any1) {
        bool first0 = any0;
        if (any0 && any1) {
          // the child most lanes enter first goes first (the lower index
          // on a tie); the other is deferred
          const bool pref0 = h0 && (!h1 || e0 <= e1);
          const bool pref1 = h1 && !pref0;
          first0 = __popc(__ballot_sync(mask, pref0)) >=
                   __popc(__ballot_sync(mask, pref1));
          const bool h_far = first0 ? h1 : h0;
          stack_node[sp] = first0 ? c0 + 1 : c0;
          stack_entry[sp] = h_far ? (first0 ? e1 : e0) : __int_as_float(
                                                             0x7fc00000);
          ++sp;
        }
        node = first0 ? c0 : c0 + 1;
        mine = first0 ? h0 : h1;
        continue;
      }
    }
    // the latest deferred node some lane still admits, if any
    bool resumed = false;
    while (sp > 0) {
      --sp;
      mine = admits(stack_entry[sp]);
      if (__any_sync(mask, mine)) {
        node = stack_node[sp];
        resumed = true;
        break;
      }
    }
    if (!resumed) return found;
  }
}

// The cluster visits a cast needs whatever the traversal: the clusters
// whose (unwidened) box the ray enters at or before `limit` (strictly
// before it when `strict`). A nearest cast needs those entered by its
// final winner's t (all entered boxes on a miss); an occlusion query that
// finds no occluder needs those entered before the light.
__device__ __forceinline__ unsigned long long needed_visits(
    const Clusters& cl, V3 o, V3 d, float limit, bool strict) {
  const V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  unsigned long long n = 0;
  float entry;
  for (int mi = 0; mi < cl.m; ++mi)
    if (slab(cl.aabb + (size_t)mi * kAabbRows, o, inv, &entry) &&
        (strict ? entry < limit : entry <= limit))
      ++n;
  return n;
}

}  // namespace cutrace
