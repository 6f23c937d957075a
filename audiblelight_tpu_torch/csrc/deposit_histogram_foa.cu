// Fused diffuse-rain deposit + AmbiX first-order encode + arrival-time
// histogram for one listener point, one (source, ray chunk) per block.
//
// Replaces audiblelight_tpu/ops/pallas_kernels.py:deposit_histogram_foa_pallas
// (_deposit_histogram_foa_kernel). For every ray that hit a face this bounce:
//   inv_d = 1 / max(d, 1e-9), cos(theta) = max(v . n * inv_d, 0)
//   deposit = e_refl * cos(theta) / (4 pi^2 max(d, 1e-2)^2)
// masked by visibility (occ == 0), cos(theta) > 0 and the padded bin range,
// binned at int(arrival * (1 / bin_dt)), arrival = (dist + d) * (1 / c), and
// encoded as [W, X, Y, Z] = deposit * [1, ux, uy, uz] of the arrival vector
// u = -v * inv_d (v = listener - hit), per band.
//
// Bound on this card: bytes (hit, normal, e_refl, dist, occ: ~45 B per ray)
// plus the (E, 4, B, n_bins) output; the arithmetic is ~40 flops per ray.
// Design: the per-ray geometry stays in registers; each block folds its
// chunk's rays into a (n_bins_pad, 4, B) f32 histogram in shared memory with
// shared-memory atomics (32 KiB at 512 bins x 4 bands), then adds its non-zero
// bins below n_bins into the zeroed output with global atomics. The TPU's
// one-hot matmul fold has no counterpart here. fp32 throughout, no tensor
// cores; built with --fmad=false so each rounding follows the plain version.
// K4's rounding is its own: cos(theta) multiplies by inv_d where K3 divides.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRaysPerBlock = 1024;

__global__ void deposit_histogram_foa_kernel(const float* __restrict__ hit,     // (E*R, 3)
                                             const float* __restrict__ normal,  // (E*R, 3)
                                             const float* __restrict__ e_refl,  // (E*R, B)
                                             const float* __restrict__ dist,    // (E*R,)
                                             const unsigned char* __restrict__ occ,  // (E*R,)
                                             const float* __restrict__ lis,     // (3,)
                                             int n_rays, int n_bands, int n_bins, int n_bins_pad,
                                             float inv_bin_dt, float range_limit, float inv_c,
                                             float four_pi2,
                                             float* __restrict__ out) {  // (E, 4, B, n_bins)
  extern __shared__ float hist[];  // (n_bins_pad, 4, B)
  const int e = blockIdx.x;
  const int k0 = blockIdx.y * kRaysPerBlock;
  const int k1 = min(k0 + kRaysPerBlock, n_rays);
  const int row = 4 * n_bands;

  for (int i = threadIdx.x; i < n_bins_pad * row; i += blockDim.x) hist[i] = 0.0f;
  __syncthreads();

  const float lx = lis[0], ly = lis[1], lz = lis[2];
  for (int k = k0 + threadIdx.x; k < k1; k += blockDim.x) {
    const int r = e * n_rays + k;
    if (occ[r]) continue;
    const float vx = lx - hit[3 * r];
    const float vy = ly - hit[3 * r + 1];
    const float vz = lz - hit[3 * r + 2];
    const float d2 = vx * vx + vy * vy + vz * vz;
    const float d = sqrtf(d2);
    const float inv_d = 1.0f / fmaxf(d, 1e-9f);
    const float cos_th =
        fmaxf((vx * normal[3 * r] + vy * normal[3 * r + 1] + vz * normal[3 * r + 2]) * inv_d, 0.0f);
    const float arrival = (dist[r] + d) * inv_c;
    if (!(cos_th > 0.0f) || !(arrival < range_limit)) continue;
    int bin = (int)(arrival * inv_bin_dt);
    bin = min(max(bin, 0), n_bins_pad - 1);
    const float m = fmaxf(d, 1e-2f);
    const float geom = cos_th / (four_pi2 * (m * m));
    const float g[4] = {1.0f, -vx * inv_d, -vy * inv_d, -vz * inv_d};
    float* dst = hist + bin * row;
    for (int b = 0; b < n_bands; ++b) {
      const float dep = e_refl[(size_t)r * n_bands + b] * geom;
      atomicAdd(&dst[b], dep);
      for (int c = 1; c < 4; ++c) atomicAdd(&dst[c * n_bands + b], dep * g[c]);
    }
  }
  __syncthreads();

  // Bins >= n_bins are the padding the reference slices off
  float* base = out + (size_t)e * row * n_bins;
  for (int i = threadIdx.x; i < n_bins * row; i += blockDim.x) {
    const int bin = i / row;
    const int cb = i - bin * row;  // c * B + b
    const float v = hist[i];
    if (v != 0.0f) atomicAdd(&base[(size_t)cb * n_bins + bin], v);
  }
}

}  // namespace

extern "C" int deposit_histogram_foa(const float* hit, const float* normal, const float* e_refl,
                                     const float* dist, const unsigned char* occ, const float* lis,
                                     int n_sources, int n_rays, int n_bands, int n_bins,
                                     int n_bins_pad, float inv_bin_dt, float range_limit,
                                     float inv_c, float four_pi2, float* out, cudaStream_t stream) {
  if (n_sources <= 0 || n_rays <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)n_bins_pad * 4 * n_bands * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        deposit_histogram_foa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_sources, (n_rays + kRaysPerBlock - 1) / kRaysPerBlock);
  deposit_histogram_foa_kernel<<<grid, kThreads, smem, stream>>>(
      hit, normal, e_refl, dist, occ, lis, n_rays, n_bands, n_bins, n_bins_pad, inv_bin_dt,
      range_limit, inv_c, four_pi2, out);
  return (int)cudaGetLastError();
}
