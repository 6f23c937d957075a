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
// the (G, n_bins, K) output written once); ~1 add per deposit. Design: one
// block per (group, chunk of 1,024 rays, slice of K); threads walk the
// chunk's (ray, k) elements with k fastest, so a warp reads contiguous
// deposits, and fold them into a (n_bins, K slice) f32 histogram in shared
// memory with shared atomics; the block then adds its non-zero cells into
// the zeroed output with global atomics. The K slice keeps the shared
// histogram under the default 48 KiB (at HOA3, K = 16 channels x 4 bands =
// 64 and 501 bins, 4 slices of 16 take 32 KiB each), so no block opts in to
// the larger dynamic shared memory. Atomics add in a run-dependent order:
// sums agree with the plain version to fp32 rounding, bins exactly.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRaysPerBlock = 1024;
constexpr size_t kMaxSmem = 48 * 1024;

__global__ void bin_histogram_kernel(const int* __restrict__ bins,    // (G, R)
                                     const float* __restrict__ dep,   // (G, R, K)
                                     int n_rays, int k, int n_bins, int k_slice,
                                     float* __restrict__ out) {  // (G, n_bins, K) zeroed
  extern __shared__ float hist[];  // (n_bins, ks)
  const int g = blockIdx.z;
  const int r0 = blockIdx.x * kRaysPerBlock;
  const int r1 = min(r0 + kRaysPerBlock, n_rays);
  const int k0 = blockIdx.y * k_slice;
  const int ks = min(k_slice, k - k0);

  for (int i = threadIdx.x; i < n_bins * ks; i += blockDim.x) hist[i] = 0.0f;
  __syncthreads();

  const int* brow = bins + (size_t)g * n_rays;
  const float* drow = dep + (size_t)g * n_rays * k;
  const int n = (r1 - r0) * ks;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int rr = r0 + i / ks;
    const int kk = i - (i / ks) * ks;
    const int b = __ldg(brow + rr);
    if (b < 0 || b >= n_bins) continue;
    const float v = __ldg(drow + (size_t)rr * k + k0 + kk);
    if (v != 0.0f) atomicAdd(&hist[b * ks + kk], v);
  }
  __syncthreads();

  float* base = out + (size_t)g * n_bins * k + k0;
  for (int i = threadIdx.x; i < n_bins * ks; i += blockDim.x) {
    const float v = hist[i];
    if (v != 0.0f) {
      const int b = i / ks;
      atomicAdd(&base[(size_t)b * k + (i - b * ks)], v);
    }
  }
}

}  // namespace

extern "C" int bin_histogram(const int* bins, const float* dep, int n_groups, int n_rays, int k,
                             int n_bins, int k_slice, float* out, cudaStream_t stream) {
  if (n_groups <= 0 || n_bins <= 0 || k <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_groups * n_bins * k * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  if (n_rays <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)n_bins * k_slice * sizeof(float);
  if (k_slice <= 0 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_rays + kRaysPerBlock - 1) / kRaysPerBlock, (k + k_slice - 1) / k_slice, n_groups);
  bin_histogram_kernel<<<grid, kThreads, smem, stream>>>(bins, dep, n_rays, k, n_bins, k_slice, out);
  return (int)cudaGetLastError();
}
