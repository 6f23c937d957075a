// Grouped histogram: out[g, bin, k] = sum over rays r of dep[g, r, k] where
// bins[g, r] == bin; bins outside [0, n_bins) deposit nowhere.
//
// Replaces audiblelight_tpu/ops/pallas_kernels.py:bin_histogram_pallas
// (_bin_histogram_kernel), the fold of the unfused deposit chain (binaural,
// HOA and FOA at other tail orders): rays x (channel, band) deposits into
// per-source arrival-time histograms. The TPU kernel builds a one-hot bin
// matrix and folds it on the matrix unit at HIGHEST precision; here there is
// no matrix: each deposit is added once, in fp32, no tensor cores (so no
// TF32).
//
// Bound on this card: bytes (each deposit read once, 4 B, plus its bin, and
// the (G, n_bins, K) output written once); ~1 add per deposit. Design, with
// no atomic anywhere (a float atomicAdd on shared memory compiles to a
// compare-and-swap spin on this card, ATOMS.CAST.SPIN, which crowded
// arrival bins serialise) and no memset:
// - one thread-block cluster of C CTAs (C <= 8, the portable limit) per
//   (group, column of K): a column is 4 deposits read as one float4 where
//   K % 4 == 0, else 1;
// - each CTA takes 1/C of the group's rays; each warp takes 32 of them at a
//   time, one ray per lane, and keeps its own (n_bins) histogram of columns
//   in shared memory;
// - lanes with the same bin find each other (__match_any_sync), the lowest
//   of them sums the others' columns through shuffles in lane order and
//   adds the sum into its warp's histogram with a plain read-modify-write:
//   no two lanes of a warp touch one bin, and no two warps one histogram;
// - the CTA then sums its warps' histograms, the cluster syncs, and each
//   CTA sums its 1/C of the bins over the C CTAs' sums through distributed
//   shared memory, in rank order, and stores those cells of `out` with
//   plain stores: every output cell is written exactly once. A second
//   cluster sync keeps every histogram alive until its readers are done.
// Every sum is taken in a fixed order, so the result does not change from
// run to run; it agrees with the plain version (index_add_) to fp32 rounding,
// bins exactly. The wrapper (ops/cuda_kernels.py:bin_histogram_shape) sizes
// the warps per CTA to the shared-memory budget (n_warps * n_bins * 16 bytes,
// opted in above the default 48 KiB) and C so that at least ~2 CTAs per SM
// run at K = 64 (HOA3) and K = 8 (binaural).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

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
__device__ __forceinline__ float vshfl(float v, int src) { return __shfl_sync(kFull, v, src); }
__device__ __forceinline__ float4 vshfl(float4 v, int src) {
  return make_float4(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src), __shfl_sync(kFull, v.z, src),
                     __shfl_sync(kFull, v.w, src));
}

// V = float4 (four deposits a column) or float (one); dep is (G, R, kv) and
// out (G, n_bins, kv) in units of V.
template <typename V>
__global__ void bin_histogram_kernel(const int* __restrict__ bins, const V* __restrict__ dep, int n_rays, int kv,
                                     int n_bins, V* __restrict__ out) {
  extern __shared__ float4 smem[];
  V* hist = reinterpret_cast<V*>(smem);  // (n_warps, n_bins)
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ctas = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int col = blockIdx.y;
  const int g = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const V zero = vzero(V());

  for (int i = threadIdx.x; i < n_warps * n_bins; i += blockDim.x) hist[i] = zero;
  __syncthreads();

  const int per = (n_rays + n_ctas - 1) / n_ctas;
  const int r0 = min(rank * per, n_rays);
  const int r1 = min(r0 + per, n_rays);
  const int* brow = bins + (size_t)g * n_rays;
  const V* drow = dep + (size_t)g * n_rays * kv + col;
  V* mine = hist + warp * n_bins;
  for (int base = r0 + 32 * warp; base < r1; base += 32 * n_warps) {
    const int r = base + lane;
    int b = -1;
    V v = zero;
    if (r < r1) {
      b = __ldg(brow + r);
      v = __ldg(drow + (size_t)r * kv);
      if (b < 0 || b >= n_bins) b = -1;
    }
    // The lanes of one bin: the lowest sums the others' in lane order
    const unsigned group = __match_any_sync(kFull, b);
    unsigned rest = group & (group - 1);
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
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    V s = hist[i];
    for (int w = 1; w < n_warps; ++w) s = vadd(s, hist[w * n_bins + i]);
    hist[i] = s;
  }
  cluster.sync();

  // This CTA's share of the bins, summed over the cluster's CTAs in rank
  // order (every remote load issued before the sum needs it)
  const int b0 = (int)((long long)n_bins * rank / n_ctas);
  const int b1 = (int)((long long)n_bins * (rank + 1) / n_ctas);
  V* orow = out + (size_t)g * n_bins * kv + col;
  for (int b = b0 + threadIdx.x; b < b1; b += blockDim.x) {
    V part[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < n_ctas) part[c] = cluster.map_shared_rank(hist, c)[b];
    V s = zero;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < n_ctas) s = vadd(s, part[c]);
    orow[(size_t)b * kv] = s;
  }
  cluster.sync();
}

template <typename V>
int launch(const int* bins, const void* dep, int n_groups, int n_rays, int kv, int n_bins, int n_warps, int cluster,
           void* out, cudaStream_t stream) {
  const size_t smem = (size_t)n_warps * n_bins * sizeof(V);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t err =
        cudaFuncSetAttribute(bin_histogram_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, kv, n_groups);
  cfg.blockDim = dim3(32 * n_warps, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, bin_histogram_kernel<V>, bins, static_cast<const V*>(dep), n_rays, kv,
                                       n_bins, static_cast<V*>(out));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// vec4: K % 4 == 0 and both buffers 16-byte aligned, columns of 4 deposits.
extern "C" int bin_histogram(const int* bins, const float* dep, int n_groups, int n_rays, int k, int n_bins,
                             int vec4, int n_warps, int cluster, float* out, cudaStream_t stream) {
  if (n_groups <= 0 || n_bins <= 0 || k <= 0) return (int)cudaSuccess;
  if (n_warps < 1 || n_warps > 32 || cluster < 1 || cluster > kMaxCluster || n_rays < 0 ||
      (vec4 && (k % 4 != 0 || ((size_t)dep & 15) != 0 || ((size_t)out & 15) != 0)))
    return (int)cudaErrorInvalidValue;
  if (vec4) return launch<float4>(bins, dep, n_groups, n_rays, k / 4, n_bins, n_warps, cluster, out, stream);
  return launch<float>(bins, dep, n_groups, n_rays, k, n_bins, n_warps, cluster, out, stream);
}
