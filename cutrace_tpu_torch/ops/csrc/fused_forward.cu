// Fused forward ray tracer for NVIDIA Hopper (sm_90a): primary cast,
// per-light shadow queries, Phong shading and the reflection/transparency
// bounce tree, one thread per ray, in one kernel launch; optionally the
// topology codes the replay backward (csrc/replay_vjp.cu) consumes.
//
// One ray body (trace_ray), three instances, chosen by the caller before
// the launch from the partition's size (ops/fused.py):
//   * K1, which replaces cutrace_tpu/ops/fused.py:_make_kernel_lanes
//     (partitions of at most 32 clusters, forward and emit_topo rows), in
//     two instances over the flat cluster loop of csrc/cast.cuh:
//       - the shared-memory instance runs persistent blocks (as many as
//         fit on the card at once). Each block copies the partition's
//         slot rows and cluster boxes, the plane, sphere, material and
//         light rows into dynamic shared memory once, with cp.async.
//         Then each warp takes 32 rays at a time from a counter until
//         none are left: ray costs vary by orders of magnitude (a miss
//         against a 6-node mirror chain), so a fixed share per warp would
//         leave the card waiting on the slowest. Bunny's tables (16 x 64
//         slots) take 99 KB: two blocks an SM;
//       - the global-memory instance, for partitions whose rows do not fit
//         in a block's shared memory (C = 128 with M up to 32 is up to
//         393 KB), reads the tables through L1/L2.
//     In both, the lanes of a warp walk the clusters in the same index
//     order, each culling against its own best t, so its winner is the
//     flat loop's. A cluster that many lanes admit is scanned by them
//     side by side, one that few admit by the whole warp, one admitting
//     lane's ray at a time with its slots spread over the lanes
//     (csrc/cast.cuh visit_nearest_warp).
//   * K3, which replaces cutrace_tpu/ops/fused.py:_make_kernel (the
//     big-scene kernel, more than 32 clusters of C = 256 or 512 slots),
//     runs the warp-coherent ordered walk over the widened cluster tree of
//     csrc/cast.cuh: its winners are the flat loop's over all M clusters
//     (or a triangle the flat loop's rounding dropped). Its tables stay in
//     global memory (up to 2048 x 512 x 24 floats = 100.7 MB at 1M
//     triangles, past the 50 MB L2; the tree 128 KB). A visit reads a
//     cluster's rows from L2 or HBM: a lone lane scanning its C slots
//     waits on C loads in a row, a warp visiting in turn on C / 32.
// All keep the TPU kernels' contract, not their TPU layout:
//   * nearest hit = the (t, key) lexicographic minimum: triangles by their
//     original flat index, then planes and spheres by scene object index
//     against the triangle winner's object index;
//   * all positions are recentered by the scene center, and triangles use
//     the precomputed constants of the identity form (csrc/cast.cuh);
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
//     and a node of weight 0 is skipped with its subtree;
//   * with a code buffer (K rows x R rays, int32, ray-minor so neighbouring
//     threads write neighbouring words), each visited node writes its
//     winner code (original triangle index, T + plane, T + P + sphere, -1
//     on a miss) at row id * (1 + L * per_light), id = the node's preorder
//     id in cutrace_tpu/ops/replay.py:topo_layout, and per light either the
//     occlusion flag (opaque scenes) or the occluder code of every march
//     step that counted (transparent scenes). The wrapper pre-fills -1
//     (flag rows 0); entries the replay never reads keep that fill. K3
//     writes the same rows for opaque and transparent scenes.
// Rays-on-lanes, scalar-prefetch cull words, static unrolls and one-hot
// attribute sums were TPU devices and are gone: each thread culls clusters
// itself against its current best t and gathers winner attributes with
// plain loads, once per winner. K3's TPU regimes were not carried over
// either: the VMEM / HBM table split and the per-visit DMA streaming, the
// MXU visit forms and the bit-packed opaque flag columns (a Mosaic
// device: K3 writes the replay's row layout directly, as K1 does). The
// TPU's group ordering measured slower there (docs/performance.md), but it
// culled whole tiles; a per-ray ordered walk is another thing.
//
// What bounds it on this card: a divergent, latency-bound traversal, each
// thread walking its own clusters and tree nodes. Its least time is the
// float operations of the cluster visits its casts need (C slot tests
// each: the clusters entered before the final winner, or before the
// light), whatever order visits them. An optional tally counts casts,
// admitted visits, slab tests and those needed visits (a post-pass per
// cast over the unwidened cluster boxes, run only with a tally), from
// which chip_smoke.py computes that bound.

#include "cast.cuh"

namespace {

using namespace cutrace;

constexpr int kBlock = 128;      // threads per block, global-memory instances
constexpr int kSmemBlock = 256;  // threads per block, K1 in shared memory
// instances (ops/fused.py _K1_GLOBAL, _K1_SHARED, _K3)
constexpr int kInstanceK1Global = 0, kInstanceK1Shared = 1, kInstanceK3 = 2;
constexpr int kMatRows = 8;     // floats per material row
constexpr int kLightRows = 8;   // floats per light row
constexpr int kMaxParked = 6;   // parked transparency frames (bounces <= 5)
constexpr float kEps = 1e-6f;   // material activity threshold

// material rows: colr colg colb spec refl phong transp 0
constexpr int M_COL = 0, M_SPEC = 3, M_REFL = 4, M_PHONG = 5, M_TRANSP = 6;

struct Scene {
  Clusters cl;
  const float* planes;
  const float* spheres;
  const float* mats;
  const float* lights;
  int n_planes, n_spheres, n_lights, n_mats;
};

// kind of a winner
constexpr int kMiss = -1, kTri = 0, kPlane = 1, kSphere = 2;

struct Hit {
  float t;   // +inf on a miss
  int kind;  // kMiss / kTri / kPlane / kSphere
  int idx;   // triangle slot (cluster * C + slot) or plane / sphere row
};

// Where a thread writes its topology codes: row r of its ray's column is
// codes[r * stride]; null when the caller wants no codes.
struct Topo {
  int* codes;
  int stride;
  int t_cnt, p_cnt;  // padded triangle / plane leaf lengths
};

// Nearest hit over all kinds. Planes and spheres go first: their best t
// bounds which clusters are worth visiting.
template <bool kTree>
__device__ Hit cast_nearest(const Scene& s, V3 o, V3 d, float mind,
                            Tally& tl) {
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

  TriWinner b;
  tl.casts += 1;
  if (kTree)
    walk_tree<false>(s.cl, o, d, mind, bound, b, tl);
  else
    nearest_triangle_flat(s.cl, o, d, mind, bound, b, tl);

  Hit h{b.t, b.slot >= 0 ? kTri : kMiss, b.slot};
  float best_obj =
      b.slot >= 0 ? s.cl.tri[(size_t)b.slot * kTriRows + T_OBJ] : kBig;
  if (ip >= 0 && (tp < h.t || (tp == h.t && kp < best_obj))) {
    h = Hit{tp, kPlane, ip};
    best_obj = kp;
  }
  if (is >= 0 && (ts < h.t || (ts == h.t && ks < best_obj))) {
    h = Hit{ts, kSphere, is};
  }
  if (tl.count_needed) tl.needed += needed_visits(s.cl, o, d, h.t, false);
  return h;
}

// Any hit closer than ldist (opaque shadow query).
template <bool kTree>
__device__ bool occluded_any(const Scene& s, V3 o, V3 d, float mind,
                             float ldist, Tally& tl) {
  for (int i = 0; i < s.n_planes; ++i)
    if (plane_t(s.planes + i * kPsRows, o, d, mind) < ldist) return true;
  if (s.n_spheres > 0) {
    float dl = norm3(d);
    V3 nd = v3(d.x / dl, d.y / dl, d.z / dl);
    for (int i = 0; i < s.n_spheres; ++i)
      if (sphere_t(s.spheres + i * kPsRows, o, nd, mind) < ldist) return true;
  }
  TriWinner unused;
  return kTree ? walk_tree<true>(s.cl, o, d, mind, ldist, unused, tl)
               : any_triangle_flat(s.cl, o, d, mind, ldist, tl);
}

template <bool kTree>
__device__ bool occluded(const Scene& s, V3 o, V3 d, float mind,
                         float ldist, Tally& tl) {
  tl.casts += 1;
  const bool hit = occluded_any<kTree>(s, o, d, mind, ldist, tl);
  if (tl.count_needed)
    tl.needed += hit ? 1 : needed_visits(s.cl, o, d, ldist, true);
  return hit;
}

// The winner's topology code (cutrace_tpu/ops/replay.py layout).
__device__ __forceinline__ int hit_code(const Scene& s, const Topo& tp,
                                        const Hit& h) {
  if (h.kind == kTri) return (int)s.cl.tri[(size_t)h.idx * kTriRows + T_ORDER];
  if (h.kind == kPlane) return tp.t_cnt + h.idx;
  if (h.kind == kSphere) return tp.t_cnt + tp.p_cnt + h.idx;
  return -1;
}

__device__ __forceinline__ int hit_mat(const Scene& s, const Hit& h) {
  float m = 0.0f;
  if (h.kind == kTri) m = s.cl.tri[(size_t)h.idx * kTriRows + T_MAT];
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

// `row` is the node's cast row in the code buffer (ignored without one).
template <bool kTree>
__device__ Shaded shade_node(const Scene& s, V3 o, V3 d, float mind,
                             float ambient, int shadow_steps, bool opaque,
                             const Topo& tp, int row, Tally& tl) {
  Hit h = cast_nearest<kTree>(s, o, d, mind, tl);
  const int per_light = opaque ? 1 : shadow_steps;
  if (tp.codes) tp.codes[(size_t)row * tp.stride] = hit_code(s, tp, h);
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
    rn = load3(s.cl.tri + (size_t)h.idx * kTriRows + T_SN);
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
    const int srow = row + 1 + li * per_light;  // this light's first row
    if (opaque) {
      shadow = occluded<kTree>(s, p, sd, 1e-3f, light_dist, tl) ? 1.0f : 0.0f;
      if (tp.codes) tp.codes[(size_t)srow * tp.stride] = (int)shadow;
    } else {
      shadow = 0.0f;
      float last = 0.0f;
      for (int si = 0; si < shadow_steps; ++si) {
        Hit sh = cast_nearest<kTree>(s, p, sd, last + 1e-3f, tl);
        bool okm = isfinite(sh.t) && sh.t < light_dist;
        if (!okm) break;
        if (tp.codes)
          tp.codes[(size_t)(srow + si) * tp.stride] = hit_code(s, tp, sh);
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
  int level, node;
};

// Nodes in the subtree of a node at `level` (topo_layout's recursion).
__device__ __forceinline__ int subtree_nodes(int level, int bounces,
                                             bool any_refl, bool any_transp) {
  int depth = bounces - level + 1;
  if (any_refl && any_transp) return (1 << depth) - 1;
  return (any_refl || any_transp) ? depth : 1;
}

// One ray through the bounce tree: color into out[i, 0:3], the primary
// cast's depth and normal into out[i, 3:7].
template <bool kTree>
__device__ __forceinline__ void trace_ray(
    int i, const float* __restrict__ rays, const Scene& s, float ambient,
    float* __restrict__ out, int bounces, int shadow_steps, bool any_refl,
    bool any_transp, float fudge, Topo tp, Tally& tl) {
  const float* ray = rays + (size_t)i * 8;
  const bool opaque = !any_transp;
  const bool branches = any_refl || any_transp;
  const int node_rows = 1 + s.n_lights * (opaque ? 1 : shadow_steps);
  if (tp.codes) tp.codes += i;

  V3 o = load3(ray), d = load3(ray + 3);
  float w = 1.0f, mind = ray[6];
  int level = 0, node = 0;
  bool root = true;
  V3 color = v3(0.0f, 0.0f, 0.0f);
  Frame parked[kMaxParked];
  int n_parked = 0;

  while (true) {
    bool descend = false;
    if (root || w != 0.0f) {
      Shaded r = shade_node<kTree>(s, o, d, mind, ambient, shadow_steps,
                                   opaque, tp, node * node_rows, tl);
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
          if (any_transp)
            parked[n_parked++] = Frame{
                ch, d, w * f, level + 1,
                node + 1 + subtree_nodes(level + 1, bounces, true, true)};
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
        node += 1;  // the first child follows its parent in preorder
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
      node = fr.node;
      mind = fudge;
    }
  }
  float* q = out + (size_t)i * 7;
  q[0] = color.x;
  q[1] = color.y;
  q[2] = color.z;
}

// K1's global-memory instance (kTree false) and K3 (kTree true): one ray a
// thread, tables read from global memory.
template <bool kTree>
__global__ void __launch_bounds__(kBlock)
fused_forward_kernel(const float* __restrict__ rays, Scene s,
                     const float* __restrict__ ambient_p,
                     float* __restrict__ out, int n_rays, int bounces,
                     int shadow_steps, bool any_refl, bool any_transp,
                     float fudge, Topo tp,
                     unsigned long long* __restrict__ tally) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Tally tl;
  tl.count_needed = tally != nullptr;
  trace_ray<kTree>(i, rays, s, *ambient_p, out, bounces, shadow_steps,
                   any_refl, any_transp, fudge, tp, tl);
  flush_tally(tally, tl);
}

// Copy n_floats (a multiple of 4) from global to shared memory in 16-byte
// cp.async chunks spread over the block; returns the next free float.
__device__ __forceinline__ float* stage(float* dst, const float* src,
                                        int n_floats) {
  for (int k = threadIdx.x; k < n_floats / 4; k += blockDim.x) {
    const unsigned a =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * k));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
                 "l"(src + 4 * k)
                 : "memory");
  }
  return dst + n_floats;
}

// The floats K1's shared-memory instance stages (ops/fused.py
// k1_shared_bytes counts the same).
__host__ __device__ __forceinline__ size_t shared_floats(
    int m, int c, int n_planes, int n_spheres, int n_mats, int n_lights) {
  return (size_t)m * c * kTriRows + (size_t)m * kAabbRows +
         (size_t)(n_planes + n_spheres) * kPsRows + (size_t)n_mats * kMatRows +
         (size_t)n_lights * kLightRows;
}

// K1's shared-memory instance: persistent blocks, the scene staged once
// per block; then each warp takes the next 32 rays from a counter
// (`next_chunk`, zeroed by the caller) until none are left, so warps that
// draw cheap rays (misses) take more of them.
__global__ void __launch_bounds__(kSmemBlock, 2)
fused_forward_shared_kernel(const float* __restrict__ rays, Scene s,
                            const float* __restrict__ ambient_p,
                            float* __restrict__ out, int n_rays, int bounces,
                            int shadow_steps, bool any_refl, bool any_transp,
                            float fudge, Topo tp,
                            unsigned long long* __restrict__ tally,
                            int* __restrict__ next_chunk) {
  extern __shared__ float4 smem4[];
  float* p = reinterpret_cast<float*>(smem4);
  Scene ss = s;
  ss.cl.tri = p;
  p = stage(p, s.cl.tri, s.cl.m * s.cl.c * kTriRows);
  ss.cl.aabb = p;
  p = stage(p, s.cl.aabb, s.cl.m * kAabbRows);
  ss.planes = p;
  p = stage(p, s.planes, s.n_planes * kPsRows);
  ss.spheres = p;
  p = stage(p, s.spheres, s.n_spheres * kPsRows);
  ss.mats = p;
  p = stage(p, s.mats, s.n_mats * kMatRows);
  ss.lights = p;
  stage(p, s.lights, s.n_lights * kLightRows);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const float ambient = *ambient_p;
  Tally tl;
  tl.count_needed = tally != nullptr;
  const int lane = threadIdx.x & 31;
  const int n_chunks = (n_rays + 31) / 32;
  while (true) {
    int chunk = 0;
    if (lane == 0) chunk = atomicAdd(next_chunk, 1);
    chunk = __shfl_sync(0xffffffffu, chunk, 0);
    if (chunk >= n_chunks) break;
    const int i = chunk * 32 + lane;
    if (i < n_rays)
      trace_ray<false>(i, rays, ss, ambient, out, bounces, shadow_steps,
                       any_refl, any_transp, fudge, tp, tl);
  }
  flush_tally(tally, tl);
}

}  // namespace

// The largest dynamic shared memory a block of the current device may opt
// in to (bytes), into *bytes; returns the CUDA error code.
extern "C" int cutrace_shared_limit(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Launches the kernel on `stream` over n_rays rays; returns the CUDA error
// code of the launch (0 on success). `instance` is kInstanceK1Global,
// kInstanceK1Shared or kInstanceK3 (ops/fused.py picks it from the
// partition's size); a K1 shared-memory launch whose tables exceed the
// block limit, K3 without a tree, or a two-branch tree deeper than the
// parked-frame stack is refused (cudaErrorInvalidValue), never run as
// another instance. `codes` (K x n_rays int32, pre-filled by the caller)
// receives the topology codes, with t_cnt and p_cnt the padded triangle
// and plane leaf lengths; `tally` (4 x u64, zeroed by the caller) receives
// the casts, admitted cluster visits, slab tests and needed visits. Either
// may be null. `tree` holds K3's (2 * leaves, 8) tree boxes; `next_chunk`
// (one int, zeroed by the caller) is the shared-memory instance's work
// counter.
extern "C" int cutrace_fused_forward(
    const float* rays, const float* tri, const float* aabb,
    const float* planes, const float* spheres, const float* mats,
    const float* lights, const float* ambient, float* out, int n_rays, int m,
    int c, int n_planes, int n_spheres, int n_lights, int n_mats,
    int bounces, int shadow_steps, int any_refl, int any_transp, float fudge,
    int* codes, int t_cnt, int p_cnt, unsigned long long* tally,
    const float* tree, int leaves, int instance, int* next_chunk,
    void* stream) {
  if (any_refl && any_transp && bounces >= kMaxParked)
    return (int)cudaErrorInvalidValue;
  if ((instance == kInstanceK3 && (!tree || leaves < m)) ||
      (instance == kInstanceK1Shared && !next_chunk))
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  Scene s{Clusters{tri, aabb, tree, m, c, leaves},
          planes, spheres, mats, lights,
          n_planes, n_spheres, n_lights, n_mats};
  Topo tp{codes, n_rays, t_cnt, p_cnt};
  cudaStream_t st = (cudaStream_t)stream;
  const bool refl = any_refl != 0, transp = any_transp != 0;
  if (instance == kInstanceK1Shared) {
    const size_t bytes =
        4 * shared_floats(m, c, n_planes, n_spheres, n_mats, n_lights);
    int limit = 0, dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = (cudaError_t)cutrace_shared_limit(&limit);
    if (err != cudaSuccess) return (int)err;
    if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(fused_forward_shared_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_forward_shared_kernel, kSmemBlock, bytes);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (n_rays + kSmemBlock - 1) / kSmemBlock;
    const int grid = min(tiles, max(per_sm, 1) * sms);
    fused_forward_shared_kernel<<<grid, kSmemBlock, bytes, st>>>(
        rays, s, ambient, out, n_rays, bounces, shadow_steps, refl, transp,
        fudge, tp, tally, next_chunk);
    return (int)cudaGetLastError();
  }
  const int grid = (n_rays + kBlock - 1) / kBlock;
  if (instance == kInstanceK3)
    fused_forward_kernel<true><<<grid, kBlock, 0, st>>>(
        rays, s, ambient, out, n_rays, bounces, shadow_steps, refl, transp,
        fudge, tp, tally);
  else if (instance == kInstanceK1Global)
    fused_forward_kernel<false><<<grid, kBlock, 0, st>>>(
        rays, s, ambient, out, n_rays, bounces, shadow_steps, refl, transp,
        fudge, tp, tally);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The resources of an instance's kernel as compiled (registers, local
// bytes, static shared bytes, max threads a block) into out[4]; returns the
// CUDA error code.
extern "C" int cutrace_fused_forward_attributes(int instance, int* out) {
  if (instance == kInstanceK1Global)
    return kernel_attributes(fused_forward_kernel<false>, out);
  if (instance == kInstanceK1Shared)
    return kernel_attributes(fused_forward_shared_kernel, out);
  if (instance == kInstanceK3)
    return kernel_attributes(fused_forward_kernel<true>, out);
  return (int)cudaErrorInvalidValue;
}
