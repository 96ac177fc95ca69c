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
//
// The cluster loops cull with a per-ray slab test against the ray's best t
// so far (ties kept with <=). The flat loop tests every cluster box. The
// grouped loop first tests the union box of each run of kGroup consecutive
// clusters and tests member boxes only inside an admitted group. A group
// box holds its members' boxes, and the slab test is monotone in the box
// bounds (a NaN bound takes the neutral interval), so a group's entry is
// never later than a member's: the grouped loop drops only clusters the
// flat loop would drop too, and both find the same winner.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cutrace {

constexpr int kTriRows = 24;    // floats per triangle slot
constexpr int kPsRows = 12;     // floats per plane / sphere row
constexpr int kAabbRows = 8;    // floats per cluster or group box row
constexpr int kGroup = 32;      // clusters per group box (ops/bvh.py GROUP)
constexpr float kBig = 1073741824.0f;  // 2^30: key of "no winner"

// triangle slot rows (cutrace_tpu_torch/ops/pallas_cast.py _TRI_NAMES)
constexpr int T_N = 0, T_UB = 3, T_UG = 6, T_A = 9, T_B = 12, T_K = 15;
constexpr int T_ORDER = 16, T_VALID = 17, T_SN = 18, T_OBJ = 21, T_MAT = 22;
// plane / sphere rows (cutrace_tpu_torch/ops/fused.py _PS_*)
constexpr int P_OBJ = 0, P_N = 1, P_C = 4, P_K = 7, P_VALID = 8;
constexpr int P_MAT = 9;

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
// (ray, cluster) visits their slab tests admitted, and the slab tests done
// (group and member boxes).
struct Tally {
  unsigned long long casts = 0, visits = 0, slabs = 0;
};

// Slab entry of a ray against one box (rows bmin xyz, bmax xyz). A NaN
// (0 * inf) bound makes that axis unbounded.
__device__ __forceinline__ bool slab(const float* box, V3 o, V3 inv,
                                     float* entry) {
  float lo[3], hi[3];
  const float oc[3] = {o.x, o.y, o.z};
  const float ic[3] = {inv.x, inv.y, inv.z};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float t1 = (box[a] - oc[a]) * ic[a];
    float t2 = (box[3 + a] - oc[a]) * ic[a];
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

// Triangle t for one slot, or +inf when the ray misses it (w = d x o).
__device__ __forceinline__ float tri_t(const float* s, V3 o, V3 d, V3 w,
                                       float mind) {
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

// A cluster partition: (M, C, kTriRows) slot rows, (M, kAabbRows) cluster
// boxes and (G, kAabbRows) group boxes, G = ceil(M / kGroup) (null for
// the flat loop). Slot offsets are size_t: a 1M-triangle table holds 25M
// floats.
struct Clusters {
  const float* tri;
  const float* aabb;
  const float* groups;
  int m, c;
};

// The nearest winner: t, its key (original index) and its slot
// (cluster * C + slot), -1 when nothing won.
struct TriWinner {
  float t = INFINITY, key = kBig;
  int slot = -1;
};

__device__ __forceinline__ void visit_nearest(const Clusters& cl, int mi,
                                              V3 o, V3 d, V3 w, float mind,
                                              TriWinner& b) {
  const float* slot = cl.tri + (size_t)mi * cl.c * kTriRows;
  for (int ci = 0; ci < cl.c; ++ci, slot += kTriRows) {
    float t = tri_t(slot, o, d, w, mind);
    if (!isfinite(t)) continue;
    float key = slot[T_ORDER];
    if (t < b.t || (t == b.t && key < b.key)) {
      b.t = t;
      b.key = key;
      b.slot = mi * cl.c + ci;
    }
  }
}

// The nearest triangle with t > mind over the partition, into `b`.
// `bound` (the best plane/sphere t) also culls: a cluster entered beyond
// min(bound, best t) cannot hold a (t, key)-better triangle; equality
// keeps it for the tie-break.
template <bool kGrouped>
__device__ __forceinline__ void nearest_triangle(const Clusters& cl, V3 o,
                                                 V3 d, float mind,
                                                 float bound, TriWinner& b,
                                                 Tally& tl) {
  V3 w = v3(d.y * o.z - d.z * o.y, d.z * o.x - d.x * o.z,
            d.x * o.y - d.y * o.x);
  V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  float entry;
  const int n_groups = kGrouped ? (cl.m + kGroup - 1) / kGroup : 1;
  for (int g = 0; g < n_groups; ++g) {
    int begin = 0, end = cl.m;
    if (kGrouped) {
      tl.slabs += 1;
      if (!slab(cl.groups + (size_t)g * kAabbRows, o, inv, &entry) ||
          !(entry <= fminf(bound, b.t)))
        continue;
      begin = g * kGroup;
      end = min(cl.m, begin + kGroup);
    }
    for (int mi = begin; mi < end; ++mi) {
      tl.slabs += 1;
      if (!slab(cl.aabb + (size_t)mi * kAabbRows, o, inv, &entry) ||
          !(entry <= fminf(bound, b.t)))
        continue;
      tl.visits += 1;
      visit_nearest(cl, mi, o, d, w, mind, b);
    }
  }
}

// Any triangle with mind < t < ldist (the opaque shadow query); boxes
// entered at or beyond ldist are skipped.
template <bool kGrouped>
__device__ __forceinline__ bool any_triangle_before(const Clusters& cl,
                                                    V3 o, V3 d, float mind,
                                                    float ldist, Tally& tl) {
  V3 w = v3(d.y * o.z - d.z * o.y, d.z * o.x - d.x * o.z,
            d.x * o.y - d.y * o.x);
  V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  float entry;
  const int n_groups = kGrouped ? (cl.m + kGroup - 1) / kGroup : 1;
  for (int g = 0; g < n_groups; ++g) {
    int begin = 0, end = cl.m;
    if (kGrouped) {
      tl.slabs += 1;
      if (!slab(cl.groups + (size_t)g * kAabbRows, o, inv, &entry) ||
          !(entry < ldist))
        continue;
      begin = g * kGroup;
      end = min(cl.m, begin + kGroup);
    }
    for (int mi = begin; mi < end; ++mi) {
      tl.slabs += 1;
      if (!slab(cl.aabb + (size_t)mi * kAabbRows, o, inv, &entry) ||
          !(entry < ldist))
        continue;
      tl.visits += 1;
      const float* slot = cl.tri + (size_t)mi * cl.c * kTriRows;
      for (int ci = 0; ci < cl.c; ++ci, slot += kTriRows)
        if (tri_t(slot, o, d, w, mind) < ldist) return true;
    }
  }
  return false;
}

}  // namespace cutrace
