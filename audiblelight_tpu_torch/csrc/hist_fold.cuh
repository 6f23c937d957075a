// The histogram fold shared by the grouped histogram (bin_histogram.cu) and
// the two fused deposit histograms (deposit_histogram.cu,
// deposit_histogram_foa.cu): columns of deposits summed into arrival bins,
// with no atomic of any kind.
//
// Why no atomic: a float atomicAdd on shared memory compiles to a
// compare-and-swap spin (ATOMS.CAST.SPIN) on the H100, and the lanes whose
// arrivals share a bin (the arrivals of one bounce crowd into a few bins)
// serialise on it; global atomics also change the order of the sums from run
// to run. Here every sum is taken in a fixed order, so a launch gives the
// same bits each time.
//
// A kernel built on the fold is launched by `launch` as thread-block
// clusters of C CTAs (C <= 8, the portable limit), one cluster per (group,
// column): grid (C, columns, groups). A column is 4 floats (float4) or 1.
// 1. `zero` clears the CTA's per-warp histograms (n_warps x n_bins columns
//    in dynamic shared memory);
// 2. `share` gives the CTA its 1/C of the group's rays; each warp takes 32
//    of them at a time, one per lane, and every lane of the warp calls
//    `warp_add` with its bin (-1: deposits nowhere) and its column. Lanes of
//    one bin find each other (__match_any_sync), the lowest of them sums the
//    others' columns by shuffles in lane order and adds the sum to its
//    warp's histogram with a plain read-modify-write: no two lanes of a warp
//    touch one bin, and no two warps one histogram;
// 3. `cluster_store` sums the CTA's warp histograms, syncs the cluster, and
//    each CTA sums its 1/C of the bins over the C CTAs' sums through
//    distributed shared memory, in rank order, and hands each sum to the
//    kernel's store: every output cell is written exactly once, so the
//    output needs no memset. A second cluster sync keeps every histogram
//    alive until its readers are done.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace hist_fold {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float vzero(float) { return 0.0f; }
__device__ __forceinline__ float4 vzero(float4) { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float vscale(float a, float s) { return a * s; }
__device__ __forceinline__ float4 vscale(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}
__device__ __forceinline__ float vshfl(float v, int src) { return __shfl_sync(kFull, v, src); }
__device__ __forceinline__ float4 vshfl(float4 v, int src) {
  return make_float4(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src), __shfl_sync(kFull, v.z, src),
                     __shfl_sync(kFull, v.w, src));
}

// Store one summed column of a bin into rows of `stride` floats: a float4
// column is 4 rows (bands) of one bin, so consecutive bins are coalesced
__device__ __forceinline__ void put(float* row, size_t, int bin, float v) { row[bin] = v; }
__device__ __forceinline__ void put(float* row, size_t stride, int bin, float4 v) {
  row[bin] = v.x;
  row[stride + bin] = v.y;
  row[2 * stride + bin] = v.z;
  row[3 * stride + bin] = v.w;
}

template <typename V>
__device__ __forceinline__ void zero(V* hist, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) hist[i] = vzero(V());
  __syncthreads();
}

// [r0, r1): this CTA's share of n rays
__device__ __forceinline__ void share(int n, int& r0, int& r1) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ctas = (int)cluster.num_blocks();
  const int per = (n + n_ctas - 1) / n_ctas;
  r0 = min((int)cluster.block_rank() * per, n);
  r1 = min(r0 + per, n);
}

// One step of a warp: every lane calls it, with bin b (-1: nowhere) and its
// column v. The lowest lane of each bin sums the others' columns in lane
// order (lanes of bin -1 take no part in the shuffles' count).
template <typename V>
__device__ __forceinline__ void warp_add(V* mine, int b, V v) {
  const int lane = threadIdx.x & 31;
  const unsigned group = __match_any_sync(kFull, b);
  unsigned rest = b >= 0 ? group & (group - 1) : 0u;
  const int n_iter = (int)__reduce_max_sync(kFull, (unsigned)__popc(rest));
  V acc = v;
  for (int it = 0; it < n_iter; ++it) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    const V other = vshfl(v, src);
    if (rest) {
      acc = vadd(acc, other);
      rest &= rest - 1;
    }
  }
  if (b >= 0 && lane == __ffs(group) - 1) mine[b] = vadd(mine[b], acc);
}

// The CTA's warp histograms summed, then the cluster's: store(bin, sum) once
// for each of this CTA's 1/C of the bins
template <typename V, typename Store>
__device__ __forceinline__ void cluster_store(V* hist, int n_warps, int n_bins, Store store) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ctas = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    V s = hist[i];
    for (int w = 1; w < n_warps; ++w) s = vadd(s, hist[w * n_bins + i]);
    hist[i] = s;
  }
  cluster.sync();

  // Every remote load issued before the sum needs it
  const int b0 = (int)((long long)n_bins * rank / n_ctas);
  const int b1 = (int)((long long)n_bins * (rank + 1) / n_ctas);
  for (int b = b0 + threadIdx.x; b < b1; b += blockDim.x) {
    V part[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < n_ctas) part[c] = cluster.map_shared_rank(hist, c)[b];
    V s = vzero(V());
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < n_ctas) s = vadd(s, part[c]);
    store(b, s);
  }
  cluster.sync();
}

// Launch `kernel` on grid (CTAs per cluster, columns, groups) with n_warps
// warps a CTA and `smem` bytes of dynamic shared memory (opted in above the
// default 48 KiB); returns the launch's CUDA error code, 0 on success.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, int n_warps, size_t smem, cudaStream_t stream, Args... args) {
  if (n_warps < 1 || n_warps > 32 || grid.x < 1 || grid.x > kMaxCluster || grid.y > 65535 || grid.z > 65535 ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(32 * n_warps, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace hist_fold
