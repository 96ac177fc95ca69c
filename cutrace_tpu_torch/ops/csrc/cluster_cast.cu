// Cluster-culled nearest-triangle query for NVIDIA Hopper (sm_90a): per
// ray, the (t, original index) nearest triangle with t > min_dist over a
// cluster partition. It is the triangle half of the composable culling
// cast (ops/pallas_cast.py: pallas_candidates re-derives t and the hit
// attributes of the winner differentiably outside the kernel).
//
// Replaces cutrace_tpu/ops/pallas_cast.py:_cast_kernel (the TPU kernel K4).
// One thread per ray runs the two-level cull of csrc/cast.cuh against its
// own best t: group boxes of kGroup consecutive clusters, member boxes
// inside an admitted group, then the C slots of each admitted cluster.
// The per-tile cull masks that XLA built outside the TPU kernel, their
// bit-packed scalar-prefetch words and the M_CHUNK streaming of big
// partitions through VMEM have no counterpart: each ray culls for itself,
// and the (M, C, 24) slot table (of which the first 18 rows are read) is
// read from global memory whatever its size.
//
// What bounds it on this card: the float operations of the cluster
// visits a cast needs (C slot tests of 38 operations each for every
// cluster whose box the ray enters by its winner's t), read through
// L1/L2; the tally counts casts, admitted visits, slab tests and those
// needed visits (a post-pass over the cluster boxes, run only with a
// tally), from which chip_smoke.py computes that bound.

#include "cast.cuh"

namespace {

using namespace cutrace;

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
cluster_cast_kernel(const float* __restrict__ rays, Clusters cl,
                    float* __restrict__ t_out, int* __restrict__ ord_out,
                    int n_rays, unsigned long long* __restrict__ tally) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float* ray = rays + (size_t)i * 8;
  V3 o = load3(ray), d = load3(ray + 3);
  Tally tl;
  tl.casts = 1;
  TriWinner b;
  nearest_triangle_grouped(cl, o, d, ray[6], INFINITY, b, tl);
  t_out[i] = b.t;
  ord_out[i] = b.slot >= 0 ? (int)b.key : (1 << 30);
  if (tally) {
    tl.needed = needed_visits(cl, o, d, b.t, false);
    flush_tally(tally, tl);
  }
}

}  // namespace

// Launches the query on `stream` over n_rays rays (rows [o - o0, d,
// min_dist, 0]); returns the CUDA error code of the launch (0 on success).
// t_out receives +inf and ord_out 2^30 where no triangle is hit. `tally`
// (4 x u64, zeroed by the caller, may be null) receives the casts, admitted
// cluster visits, slab tests and needed visits.
extern "C" int cutrace_cluster_cast(const float* rays, const float* tri,
                                    const float* aabb, const float* groups,
                                    float* t_out, int* ord_out, int n_rays,
                                    int m, int c, unsigned long long* tally,
                                    void* stream) {
  if (n_rays <= 0) return 0;
  int grid = (n_rays + kBlock - 1) / kBlock;
  cluster_cast_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      rays, Clusters{tri, aabb, groups, nullptr, m, c, 0}, t_out, ord_out,
      n_rays, tally);
  return (int)cudaGetLastError();
}
