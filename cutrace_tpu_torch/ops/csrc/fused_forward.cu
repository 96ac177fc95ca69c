// Fused forward ray tracer for NVIDIA Hopper (sm_90a): primary cast,
// per-light shadow queries, Phong shading and the reflection/transparency
// bounce tree, one thread per ray, in one kernel launch.
//
// Replaces cutrace_tpu/ops/fused.py:_make_kernel_lanes (the TPU kernel K1,
// forward only). It keeps K1's contract, not its TPU layout:
//   * nearest hit = the (t, key) lexicographic minimum: triangles by their
//     original flat index, then planes and spheres by scene object index
//     against the triangle winner's object index;
//   * all positions are recentered by the scene center, and triangles use
//     the precomputed constants n, ub, ug, a, b, k of the identity form
//     (cutrace_tpu/ops/pallas_cast.py:_cluster_constants);
//   * sphere t is parametric in the normalized direction (reference quirk);
//   * opaque scenes ask one any-hit occlusion query per light; transparent
//     scenes march `shadow_steps` nearest casts accumulating
//     1 - transparency, saturating at 1;
//   * Phong uses CUDA fmaxf semantics (NaN -> 0) and lights only where
//     shadow < 1;
//   * the bounce tree is linearized: a node of weight w adds
//     w * (1 - f) * phong (a leaf w * phong); its reflection child gets
//     w * (1 - f) * r, its transparency child w * f. It is walked depth
//     first at run time with a small stack of parked transparency frames,
//     and a node of weight 0 is skipped.
// Rays-on-lanes, scalar-prefetch cull words, the static unroll over
// clusters and one-hot attribute sums were TPU devices and are gone: each
// thread culls clusters itself with a per-ray slab test against its
// current best t (ties kept with <=), and gathers winner attributes with
// plain loads.
//
// What bounds it on this card: a divergent, latency-bound traversal. Each
// thread walks its own clusters and tree nodes, and the scene tables are
// read from global memory through L1/L2 (bunny: 16 clusters x 64 slots x
// 24 floats = 96 KB of triangle rows). Staging the tables in shared
// memory, warp-ballot culls over coherent rays, and emitting the topology
// codes the backward replays are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kTriRows = 24;    // floats per triangle slot
constexpr int kPsRows = 12;     // floats per plane / sphere row
constexpr int kMatRows = 8;     // floats per material row
constexpr int kLightRows = 8;   // floats per light row
constexpr int kAabbRows = 8;    // floats per cluster AABB row
constexpr int kMaxParked = 6;   // parked transparency frames (bounces <= 5)
constexpr float kEps = 1e-6f;   // material activity threshold
constexpr float kBig = 1073741824.0f;  // 2^30: key of "no winner"

// triangle slot rows (cutrace_tpu_torch/ops/fused.py _TRI_NAMES)
constexpr int T_N = 0, T_UB = 3, T_UG = 6, T_A = 9, T_B = 12, T_K = 15;
constexpr int T_ORDER = 16, T_VALID = 17, T_SN = 18, T_OBJ = 21, T_MAT = 22;
// plane / sphere rows (cutrace_tpu_torch/ops/fused.py _PS_*)
constexpr int P_OBJ = 0, P_N = 1, P_C = 4, P_K = 7, P_VALID = 8;
constexpr int P_MAT = 9;
// material rows: colr colg colb spec refl phong transp 0
constexpr int M_COL = 0, M_SPEC = 3, M_REFL = 4, M_PHONG = 5, M_TRANSP = 6;

struct Scene {
  const float* tri;
  const float* aabb;
  const float* planes;
  const float* spheres;
  const float* mats;
  const float* lights;
  int m, c, n_planes, n_spheres, n_lights, n_mats;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float norm3(V3 a) { return sqrtf(dot3(a, a)); }
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

// kind of a winner
constexpr int kMiss = -1, kTri = 0, kPlane = 1, kSphere = 2;

struct Hit {
  float t;   // +inf on a miss
  int kind;  // kMiss / kTri / kPlane / kSphere
  int idx;   // triangle slot (cluster * C + slot) or plane / sphere row
};

// Slab entry of a ray against one AABB (rows bmin xyz, bmax xyz). A NaN
// (0 * inf) bound makes that axis unbounded, as in K1's cull.
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

// Nearest hit over all kinds. Planes and spheres go first: their best t
// bounds which clusters are worth visiting.
__device__ Hit cast_nearest(const Scene& s, V3 o, V3 d, float mind) {
  V3 nd;
  {
    float dl = norm3(d);
    nd = v3(d.x / dl, d.y / dl, d.z / dl);
  }
  float tp = INFINITY, kp = kBig;
  int ip = -1;
  for (int i = 0; i < s.n_planes; ++i) {
    const float* p = s.planes + i * kPsRows;
    float t = plane_t(p, o, d, mind);
    if (!isfinite(t)) continue;
    float key = p[P_OBJ];
    if (t < tp || (t == tp && key < kp)) {
      tp = t;
      kp = key;
      ip = i;
    }
  }
  float ts = INFINITY, ks = kBig;
  int is = -1;
  for (int i = 0; i < s.n_spheres; ++i) {
    const float* p = s.spheres + i * kPsRows;
    float t = sphere_t(p, o, nd, mind);
    if (!isfinite(t)) continue;
    float key = p[P_OBJ];
    if (t < ts || (t == ts && key < ks)) {
      ts = t;
      ks = key;
      is = i;
    }
  }
  const float bound = fminf(tp, ts);

  V3 w = v3(d.y * o.z - d.z * o.y, d.z * o.x - d.x * o.z,
            d.x * o.y - d.y * o.x);
  V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  float tt = INFINITY, kt = kBig;
  int it = -1;
  for (int mi = 0; mi < s.m; ++mi) {
    float entry;
    // a cluster entered beyond the best t so far cannot hold a
    // (t, key)-better triangle; equality keeps it for the tie-break
    if (!slab(s.aabb + mi * kAabbRows, o, inv, &entry) ||
        !(entry <= fminf(bound, tt)))
      continue;
    const float* slot = s.tri + (size_t)mi * s.c * kTriRows;
    for (int ci = 0; ci < s.c; ++ci, slot += kTriRows) {
      float t = tri_t(slot, o, d, w, mind);
      if (!isfinite(t)) continue;
      float key = slot[T_ORDER];
      if (t < tt || (t == tt && key < kt)) {
        tt = t;
        kt = key;
        it = mi * s.c + ci;
      }
    }
  }

  Hit h{tt, it >= 0 ? kTri : kMiss, it};
  float best_obj = it >= 0 ? s.tri[(size_t)it * kTriRows + T_OBJ] : kBig;
  if (ip >= 0 && (tp < h.t || (tp == h.t && kp < best_obj))) {
    h = Hit{tp, kPlane, ip};
    best_obj = kp;
  }
  if (is >= 0 && (ts < h.t || (ts == h.t && ks < best_obj))) {
    h = Hit{ts, kSphere, is};
  }
  return h;
}

// Any hit closer than ldist (opaque shadow query).
__device__ bool occluded(const Scene& s, V3 o, V3 d, float mind,
                         float ldist) {
  for (int i = 0; i < s.n_planes; ++i)
    if (plane_t(s.planes + i * kPsRows, o, d, mind) < ldist) return true;
  if (s.n_spheres > 0) {
    float dl = norm3(d);
    V3 nd = v3(d.x / dl, d.y / dl, d.z / dl);
    for (int i = 0; i < s.n_spheres; ++i)
      if (sphere_t(s.spheres + i * kPsRows, o, nd, mind) < ldist) return true;
  }
  V3 w = v3(d.y * o.z - d.z * o.y, d.z * o.x - d.x * o.z,
            d.x * o.y - d.y * o.x);
  V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  for (int mi = 0; mi < s.m; ++mi) {
    float entry;
    if (!slab(s.aabb + mi * kAabbRows, o, inv, &entry) || !(entry < ldist))
      continue;
    const float* slot = s.tri + (size_t)mi * s.c * kTriRows;
    for (int ci = 0; ci < s.c; ++ci, slot += kTriRows)
      if (tri_t(slot, o, d, w, mind) < ldist) return true;
  }
  return false;
}

__device__ __forceinline__ int hit_mat(const Scene& s, const Hit& h) {
  float m = 0.0f;
  if (h.kind == kTri) m = s.tri[(size_t)h.idx * kTriRows + T_MAT];
  if (h.kind == kPlane) m = s.planes[h.idx * kPsRows + P_MAT];
  if (h.kind == kSphere) m = s.spheres[h.idx * kPsRows + P_MAT];
  int mi = (int)m;
  return (mi >= 0 && mi < s.n_mats) ? mi : 0;
}

// What one tree node's cast and shade leave for the node's children.
struct Shaded {
  V3 ph;       // phong color (0 on a miss)
  bool hit;
  float t_safe;  // hit t, or 1 on a miss
  V3 nn;       // normalized shading normal ((0,0,1) on a miss)
  V3 rn;       // raw hit normal (output normal of the primary cast)
  float transp, refl;  // winner material's factors
};

__device__ Shaded shade_node(const Scene& s, V3 o, V3 d, float mind,
                             float ambient, int shadow_steps, bool opaque) {
  Hit h = cast_nearest(s, o, d, mind);
  Shaded r;
  r.hit = h.kind != kMiss;
  r.t_safe = r.hit ? h.t : 1.0f;
  float dl = norm3(d);
  V3 nd = v3(d.x / dl, d.y / dl, d.z / dl);
  bool is_sph = h.kind == kSphere;
  V3 dir = is_sph ? nd : d;
  V3 p = v3(o.x + r.t_safe * dir.x, o.y + r.t_safe * dir.y,
            o.z + r.t_safe * dir.z);
  V3 rn = v3(0.0f, 0.0f, 0.0f);
  if (h.kind == kTri) {
    rn = load3(s.tri + (size_t)h.idx * kTriRows + T_SN);
  } else if (h.kind == kPlane) {
    rn = load3(s.planes + h.idx * kPsRows + P_N);
  } else if (is_sph) {
    V3 c = load3(s.spheres + h.idx * kPsRows + P_C);
    V3 sv = v3(p.x - c.x, p.y - c.y, p.z - c.z);
    float sl = norm3(sv);
    sl = sl == 0.0f ? 1.0f : sl;
    rn = v3(sv.x / sl, sv.y / sl, sv.z / sl);
  }
  r.rn = rn;
  V3 g = r.hit ? rn : v3(0.0f, 0.0f, 1.0f);
  float gl = norm3(g);
  gl = gl == 0.0f ? 1.0f : gl;
  r.nn = v3(g.x / gl, g.y / gl, g.z / gl);

  const float* mat = s.mats + hit_mat(s, h) * kMatRows;
  V3 dif = load3(mat + M_COL);
  float spec = mat[M_SPEC], phong_e = mat[M_PHONG];
  r.transp = mat[M_TRANSP];
  r.refl = mat[M_REFL];
  r.ph = v3(0.0f, 0.0f, 0.0f);
  if (!r.hit) return r;

  V3 acc = v3(ambient * dif.x, ambient * dif.y, ambient * dif.z);
  for (int li = 0; li < s.n_lights; ++li) {
    const float* L = s.lights + li * kLightRows;
    bool is_sun = L[0] == 0.0f;
    V3 v = load3(L + 1);
    V3 lc = load3(L + 4);
    V3 ldir;
    float distance;
    if (is_sun) {
      ldir = v3(-v.x, -v.y, -v.z);
      distance = INFINITY;
    } else {
      V3 df = v3(v.x - p.x, v.y - p.y, v.z - p.z);
      float dist = norm3(df);
      float dsafe = dist == 0.0f ? 1.0f : dist;
      ldir = v3(df.x / dsafe, df.y / dsafe, df.z / dsafe);
      distance = dist;
    }
    float ll = norm3(ldir);
    float light_dist = distance * ll;
    ll = ll == 0.0f ? 1.0f : ll;
    V3 sd = v3(ldir.x / ll, ldir.y / ll, ldir.z / ll);

    float shadow;
    if (opaque) {
      shadow = occluded(s, p, sd, 1e-3f, light_dist) ? 1.0f : 0.0f;
    } else {
      shadow = 0.0f;
      float last = 0.0f;
      for (int si = 0; si < shadow_steps; ++si) {
        Hit sh = cast_nearest(s, p, sd, last + 1e-3f);
        bool okm = isfinite(sh.t) && sh.t < light_dist;
        if (!okm) break;
        shadow += 1.0f - s.mats[hit_mat(s, sh) * kMatRows + M_TRANSP];
        last = sh.t;
        if (!(shadow < 1.0f)) break;
      }
      shadow = shadow >= 1.0f ? 1.0f : shadow;
    }
    if (!(shadow < 1.0f)) continue;

    float fdd = dot3(r.nn, sd);
    float fd = fdd > 0.0f ? fdd : 0.0f;
    V3 hv = v3(sd.x - nd.x, sd.y - nd.y, sd.z - nd.z);
    float hl = norm3(hv);
    hl = hl == 0.0f ? 1.0f : hl;
    float bdd = dot3(r.nn, hv) / hl;
    float base = bdd > 0.0f ? bdd : 0.0f;
    float fs = base <= 0.0f ? 0.0f : powf(base, phong_e);
    float wgt = 1.0f - shadow;
    acc.x += wgt * (fd * (dif.x * lc.x) + fs * (spec * dif.x * lc.x));
    acc.y += wgt * (fd * (dif.y * lc.y) + fs * (spec * dif.y * lc.y));
    acc.z += wgt * (fd * (dif.z * lc.z) + fs * (spec * dif.z * lc.z));
  }
  r.ph = acc;
  return r;
}

struct Frame {
  V3 o, d;
  float w;
  int level;
};

__global__ void __launch_bounds__(kBlock)
fused_forward_kernel(const float* __restrict__ rays, Scene s,
                     const float* __restrict__ ambient_p,
                     float* __restrict__ out, int n_rays, int bounces,
                     int shadow_steps, bool any_refl, bool any_transp,
                     float fudge) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float* ray = rays + (size_t)i * 8;
  const float ambient = *ambient_p;
  const bool opaque = !any_transp;
  const bool branches = any_refl || any_transp;

  V3 o = load3(ray), d = load3(ray + 3);
  float w = 1.0f, mind = ray[6];
  int level = 0;
  bool root = true;
  V3 color = v3(0.0f, 0.0f, 0.0f);
  Frame parked[kMaxParked];
  int n_parked = 0;

  while (true) {
    bool descend = false;
    if (root || w != 0.0f) {
      Shaded r = shade_node(s, o, d, mind, ambient, shadow_steps, opaque);
      if (root) {
        float* q = out + (size_t)i * 7;
        q[3] = r.hit ? r.t_safe : INFINITY;
        q[4] = r.hit ? r.rn.x : 0.0f;
        q[5] = r.hit ? r.rn.y : 0.0f;
        q[6] = r.hit ? r.rn.z : 0.0f;
      }
      if (level == bounces || !branches) {
        color.x += w * r.ph.x;
        color.y += w * r.ph.y;
        color.z += w * r.ph.z;
      } else {
        float f = (any_transp && r.hit && r.transp >= kEps) ? r.transp : 0.0f;
        float weff = w * (1.0f - f);
        color.x += weff * r.ph.x;
        color.y += weff * r.ph.y;
        color.z += weff * r.ph.z;
        V3 ch = v3(o.x + r.t_safe * d.x, o.y + r.t_safe * d.y,
                   o.z + r.t_safe * d.z);
        if (any_refl) {
          if (any_transp) parked[n_parked++] = Frame{ch, d, w * f, level + 1};
          float rr = (r.hit && r.refl >= kEps) ? r.refl : 0.0f;
          float dl = norm3(d);
          V3 nd = v3(d.x / dl, d.y / dl, d.z / dl);
          float dn = dot3(nd, r.nn);
          d = v3(nd.x - 2.0f * dn * r.nn.x, nd.y - 2.0f * dn * r.nn.y,
                 nd.z - 2.0f * dn * r.nn.z);
          w = weff * rr;
        } else {
          w = w * f;
        }
        o = ch;
        level += 1;
        mind = fudge;
        descend = true;
      }
    }
    root = false;
    if (!descend) {
      if (n_parked == 0) break;
      Frame fr = parked[--n_parked];
      o = fr.o;
      d = fr.d;
      w = fr.w;
      level = fr.level;
      mind = fudge;
    }
  }
  float* q = out + (size_t)i * 7;
  q[0] = color.x;
  q[1] = color.y;
  q[2] = color.z;
}

}  // namespace

// Launches the kernel on `stream` over n_rays rays; returns the CUDA error
// code of the launch (0 on success). Refuses (cudaErrorInvalidValue) a
// two-branch tree deeper than the parked-frame stack.
extern "C" int cutrace_fused_forward(
    const float* rays, const float* tri, const float* aabb,
    const float* planes, const float* spheres, const float* mats,
    const float* lights, const float* ambient, float* out, int n_rays, int m,
    int c, int n_planes, int n_spheres, int n_lights, int n_mats,
    int bounces, int shadow_steps, int any_refl, int any_transp, float fudge,
    void* stream) {
  if (any_refl && any_transp && bounces >= kMaxParked)
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  Scene s{tri, aabb, planes, spheres, mats, lights,
          m, c, n_planes, n_spheres, n_lights, n_mats};
  int grid = (n_rays + kBlock - 1) / kBlock;
  fused_forward_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      rays, s, ambient, out, n_rays, bounces, shadow_steps, any_refl != 0,
      any_transp != 0, fudge);
  return (int)cudaGetLastError();
}
