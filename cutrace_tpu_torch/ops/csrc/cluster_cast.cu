// Cluster-culled nearest-triangle query for NVIDIA Hopper (sm_90a): per
// ray, the (t, original index) nearest triangle with t > min_dist over a
// cluster partition. It is the triangle half of the composable culling
// cast (ops/pallas_cast.py: pallas_candidates re-derives t and the hit
// attributes of the winner differentiably outside the kernel).
//
// Replaces cutrace_tpu/ops/pallas_cast.py:_cast_kernel (the TPU kernel K4).
// One thread per ray, the lanes of a warp walking the clusters together
// (csrc/cast.cuh), in two instances chosen by the caller before the launch
// from the partition's size (ops/pallas_cast.py k4_instance):
//   * flat, for at most 32 clusters (bunny's M = 16): every cluster box in
//     index order, as K1 walks them;
//   * tree, for more: the ordered walk over the widened cluster tree
//     (ClusterTables.tree), as K3 walks it.
// In both, a cluster is visited by the whole warp, one admitting lane's
// ray at a time, its C slots spread over the lanes and the (t, key)
// minimum taken by a warp reduction (visit_nearest_warp, in turn always).
// It finds the winner a lane's own scan finds. A lane past n_rays takes
// part in every vote to the end with a ray that admits nothing.
//
// A warp does not take 32 neighbouring rays: the rays of a launch that
// enter the clusters at all are bunched (the pixels around the bunny, the
// bounces off it), and a warp full of them walks a serial chain of
// visits many times longer than the average warp's. A launch is too small
// to fill the card (65,536 or 262,144 rays), so its time is that chain's.
// So lane l of warp w takes ray l * n_warps + w, and every warp samples
// the whole launch. Rays taken apart like this cost no more bytes: a ray
// row is one 32-byte sector either way.
// The per-tile cull masks that XLA built outside the TPU kernel, their
// bit-packed scalar-prefetch words and the M_CHUNK streaming of big
// partitions through VMEM have no counterpart: each ray culls for itself,
// and the (M, C, 24) slot table (of which the first 20 rows are read) is
// read from global memory whatever its size.
//
// What bounds it on this card: the float operations of the cluster
// visits a cast needs (C slot tests of 38 operations each for every
// cluster whose box the ray enters by its winner's t), read through
// L1/L2. A launch covers at most 65,536 rays (renderer.default_chunk):
// 2,048 warps, under a quarter of the card's 8,448 warp slots, so the
// latency of a visit's slot reads sets its time; a visit in turn waits on
// C / 32 reads in a row instead of C. The tally counts casts, admitted
// visits, slab tests and the needed visits (a post-pass over the cluster
// boxes, run only with a tally), from which chip_smoke.py computes that
// bound.

#include "cast.cuh"

namespace {

using namespace cutrace;

constexpr int kBlock = 128;
// instances (ops/pallas_cast.py _K4_FLAT, _K4_TREE)
constexpr int kInstanceFlat = 0, kInstanceTree = 1;

template <bool kTree>
__global__ void __launch_bounds__(kBlock)
cluster_cast_kernel(const float* __restrict__ rays, Clusters cl,
                    float* __restrict__ t_out, int* __restrict__ ord_out,
                    int n_rays, unsigned long long* __restrict__ tally) {
  // lane l of warp w takes ray l * n_warps + w: each warp gathers 32 rays
  // spread evenly over the launch, so every warp carries a like share of
  // the rays that enter the clusters (see the note at the top)
  const int n_warps = gridDim.x * (kBlock / 32);
  const int i = (int)(threadIdx.x & 31) * n_warps + blockIdx.x * (kBlock / 32) +
                (int)(threadIdx.x >> 5);
  const bool active = i < n_rays;
  // a lane past n_rays culls every box against -inf: it admits nothing
  V3 o = v3(0.0f, 0.0f, 0.0f), d = v3(1.0f, 1.0f, 1.0f);
  float mind = 0.0f, bound = -INFINITY;
  if (active) {
    const float4* ray = reinterpret_cast<const float4*>(rays + (size_t)i * 8);
    const float4 r0 = ray[0], r1 = ray[1];
    o = v3(r0.x, r0.y, r0.z);
    d = v3(r0.w, r1.x, r1.y);
    mind = r1.z;
    bound = INFINITY;
  }
  Tally tl;
  TriWinner b;
  if (kTree)
    walk_tree<false, true>(cl, o, d, mind, bound, b, tl);
  else
    nearest_triangle_flat<false>(cl, o, d, mind, bound, b, tl);
  if (!active) return;
  t_out[i] = b.t;
  ord_out[i] = b.slot >= 0 ? (int)b.key : (1 << 30);
  if (tally) {
    tl.casts = 1;
    tl.needed = needed_visits(cl, o, d, b.t, false);
    flush_tally(tally, tl);
  }
}

}  // namespace

// Launches the query on `stream` over n_rays rays (rows [o - o0, d,
// min_dist, 0], 32-byte aligned); returns the CUDA error code of the
// launch (0 on success). `instance` is kInstanceFlat or kInstanceTree
// (ops/pallas_cast.py picks it from the partition's size); the tree
// instance without a tree of at least m leaves, or another instance, is
// refused (cudaErrorInvalidValue). t_out receives +inf and ord_out 2^30
// where no triangle is hit. `tally` (kTallyCounts x u64, zeroed by the
// caller, may be null) receives the casts, admitted cluster visits, slab
// tests and needed visits; the sub-box counts and root skips stay 0.
extern "C" int cutrace_cluster_cast(const float* rays, const float* tri,
                                    const float* aabb, const float* tree,
                                    float* t_out, int* ord_out, int n_rays,
                                    int m, int c, int leaves, int instance,
                                    unsigned long long* tally, void* stream) {
  if ((instance != kInstanceFlat && instance != kInstanceTree) ||
      (instance == kInstanceTree && (!tree || leaves < m)))
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  const int grid = (n_rays + kBlock - 1) / kBlock;
  const Clusters cl{tri, aabb, tree, m, c, leaves, nullptr};
  cudaStream_t st = (cudaStream_t)stream;
  if (instance == kInstanceTree)
    cluster_cast_kernel<true><<<grid, kBlock, 0, st>>>(rays, cl, t_out,
                                                       ord_out, n_rays, tally);
  else
    cluster_cast_kernel<false><<<grid, kBlock, 0, st>>>(
        rays, cl, t_out, ord_out, n_rays, tally);
  return (int)cudaGetLastError();
}

// The resources of an instance's kernel as compiled (registers, local
// bytes, static shared bytes, max threads a block) into out[4]; returns the
// CUDA error code.
extern "C" int cutrace_cluster_cast_attributes(int instance, int* out) {
  if (instance == kInstanceTree)
    return kernel_attributes(cluster_cast_kernel<true>, out);
  if (instance == kInstanceFlat)
    return kernel_attributes(cluster_cast_kernel<false>, out);
  return (int)cudaErrorInvalidValue;
}
