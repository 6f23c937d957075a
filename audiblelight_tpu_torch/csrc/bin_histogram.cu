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
// the (G, n_bins, K) output written once); ~1 add per deposit. Design: the
// atomic-free fold of hist_fold.cuh, one thread-block cluster per (group,
// column of K), a column being 4 deposits read as one float4 where K % 4 ==
// 0, else 1; each lane takes one ray's bin and column, and each output cell
// is stored once, with no memset. The result does not change from run to
// run; it agrees with the plain version (index_add_) to fp32 rounding, bins
// exactly. The wrapper (ops/cuda_kernels.py:bin_histogram_shape) sizes
// the warps per CTA to the shared-memory budget (n_warps * n_bins * 16 bytes,
// opted in above the default 48 KiB) and C so that at least ~2 CTAs per SM
// run at K = 64 (HOA3) and K = 8 (binaural).

#include "hist_fold.cuh"

namespace {

using namespace hist_fold;

// V = float4 (four deposits a column) or float (one); dep is (G, R, kv) and
// out (G, n_bins, kv) in units of V.
template <typename V>
__global__ void bin_histogram_kernel(const int* __restrict__ bins, const V* __restrict__ dep, int n_rays, int kv,
                                     int n_bins, V* __restrict__ out) {
  extern __shared__ float4 smem[];
  V* hist = reinterpret_cast<V*>(smem);  // (n_warps, n_bins)
  const int col = blockIdx.y;
  const int g = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  zero(hist, n_warps * n_bins);

  int r0, r1;
  share(n_rays, r0, r1);
  const int* brow = bins + (size_t)g * n_rays;
  const V* drow = dep + (size_t)g * n_rays * kv + col;
  V* mine = hist + warp * n_bins;
  for (int base = r0 + 32 * warp; base < r1; base += 32 * n_warps) {
    const int r = base + lane;
    int b = -1;
    V v = vzero(V());
    if (r < r1) {
      b = __ldg(brow + r);
      v = __ldg(drow + (size_t)r * kv);
      if (b < 0 || b >= n_bins) b = -1;
    }
    warp_add(mine, b, v);
  }
  V* orow = out + (size_t)g * n_bins * kv + col;
  cluster_store(hist, n_warps, n_bins, [&](int b, V s) { orow[(size_t)b * kv] = s; });
}

template <typename V>
int launch_v(const int* bins, const void* dep, int n_groups, int n_rays, int kv, int n_bins, int n_warps, int cluster,
             void* out, cudaStream_t stream) {
  return launch(bin_histogram_kernel<V>, dim3(cluster, kv, n_groups), n_warps, (size_t)n_warps * n_bins * sizeof(V),
                stream, bins, static_cast<const V*>(dep), n_rays, kv, n_bins, static_cast<V*>(out));
}

}  // namespace

// vec4: K % 4 == 0 and both buffers 16-byte aligned, columns of 4 deposits.
extern "C" int bin_histogram(const int* bins, const float* dep, int n_groups, int n_rays, int k, int n_bins,
                             int vec4, int n_warps, int cluster, float* out, cudaStream_t stream) {
  if (n_groups <= 0 || n_bins <= 0 || k <= 0) return (int)cudaSuccess;
  if (n_rays < 0 || (vec4 && (k % 4 != 0 || ((size_t)dep & 15) != 0 || ((size_t)out & 15) != 0)))
    return (int)cudaErrorInvalidValue;
  if (vec4) return launch_v<float4>(bins, dep, n_groups, n_rays, k / 4, n_bins, n_warps, cluster, out, stream);
  return launch_v<float>(bins, dep, n_groups, n_rays, k, n_bins, n_warps, cluster, out, stream);
}
