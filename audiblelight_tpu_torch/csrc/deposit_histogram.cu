// Fused diffuse-rain deposit + arrival-time histogram, one (capsule, source)
// group per block.
//
// Replaces audiblelight_tpu/ops/pallas_kernels.py:deposit_histogram_pallas
// (_deposit_histogram_kernel). For every ray that hit a face this bounce:
//   deposit = e_refl * cos(theta) / (4 pi^2 max(d, 1e-2)^2)
// masked by visibility (occ == 0), cos(theta) > 0 and the padded bin range,
// binned at int(arrival * (1 / bin_dt)), arrival = (dist + d) * (1 / c), and
// summed per band.
//
// Bound on this card: bytes read per ray (hit, normal, e_refl, dist, occ:
// ~45 B per ray and capsule) plus the shared-memory atomics of the fold; the
// geometry is ~25 flops per (ray, capsule). Design: the per-ray geometry is
// done in registers (none of the (C, rays) intermediates reach device
// memory), each block folds its group's rays into a (n_bins_pad, B) f32
// histogram in shared memory with shared-memory atomics, and writes it out
// once, straight into the (E, C, B, n_bins) layout. The TPU's one-hot matmul
// fold has no counterpart here: atomics are the cheap scatter on this card.
// fp32 throughout, no tensor cores. The binning keeps the Pallas form
// exactly -- reciprocal multiply, range test against the PADDED bin count,
// clip -- and the file is built with --fmad=false so the distance, and with
// it each bin, rounds as the plain version's does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void deposit_histogram_kernel(const float* __restrict__ hit,     // (E*R, 3)
                                         const float* __restrict__ normal,  // (E*R, 3)
                                         const float* __restrict__ e_refl,  // (E*R, B)
                                         const float* __restrict__ dist,    // (E*R,)
                                         const unsigned char* __restrict__ occ,  // (C, E*R)
                                         const float* __restrict__ lis,     // (C, 3)
                                         int n_sources, int n_rays, int n_bands, int n_bins,
                                         int n_bins_pad, float inv_bin_dt, float range_limit,
                                         float inv_c, float four_pi2,
                                         float* __restrict__ out) {  // (E, C, B, n_bins)
  extern __shared__ float hist[];  // (n_bins_pad, B)
  const int e = blockIdx.x;
  const int c = blockIdx.y;
  const int n_cap = gridDim.y;
  const int tr = n_sources * n_rays;

  for (int i = threadIdx.x; i < n_bins_pad * n_bands; i += blockDim.x) hist[i] = 0.0f;
  __syncthreads();

  const float lx = lis[3 * c], ly = lis[3 * c + 1], lz = lis[3 * c + 2];
  for (int k = threadIdx.x; k < n_rays; k += blockDim.x) {
    const int r = e * n_rays + k;
    if (occ[(size_t)c * tr + r]) continue;
    const float vx = lx - hit[3 * r];
    const float vy = ly - hit[3 * r + 1];
    const float vz = lz - hit[3 * r + 2];
    const float d2 = vx * vx + vy * vy + vz * vz;
    const float d = sqrtf(d2);
    const float cos_th =
        fmaxf((vx * normal[3 * r] + vy * normal[3 * r + 1] + vz * normal[3 * r + 2]) /
                  fmaxf(d, 1e-9f),
              0.0f);
    const float arrival = (dist[r] + d) * inv_c;
    if (!(cos_th > 0.0f) || !(arrival < range_limit)) continue;
    int bin = (int)(arrival * inv_bin_dt);
    bin = min(max(bin, 0), n_bins_pad - 1);
    const float m = fmaxf(d, 1e-2f);
    const float geom = cos_th / (four_pi2 * (m * m));
    for (int b = 0; b < n_bands; ++b) {
      atomicAdd(&hist[bin * n_bands + b], e_refl[(size_t)r * n_bands + b] * geom);
    }
  }
  __syncthreads();

  float* dst = out + ((size_t)e * n_cap + c) * n_bands * n_bins;
  for (int i = threadIdx.x; i < n_bands * n_bins; i += blockDim.x) {
    const int b = i / n_bins;
    const int bin = i - b * n_bins;
    dst[i] = hist[bin * n_bands + b];
  }
}

constexpr int kThreads = 512;

}  // namespace

extern "C" int deposit_histogram(const float* hit, const float* normal, const float* e_refl,
                                 const float* dist, const unsigned char* occ, const float* lis,
                                 int n_sources, int n_rays, int n_caps, int n_bands, int n_bins,
                                 int n_bins_pad, float inv_bin_dt, float range_limit,
                                 float inv_c, float four_pi2, float* out, cudaStream_t stream) {
  if (n_sources <= 0 || n_caps <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)n_bins_pad * n_bands * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        deposit_histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_sources, n_caps);
  deposit_histogram_kernel<<<grid, kThreads, smem, stream>>>(
      hit, normal, e_refl, dist, occ, lis, n_sources, n_rays, n_bands, n_bins, n_bins_pad,
      inv_bin_dt, range_limit, inv_c, four_pi2, out);
  return (int)cudaGetLastError();
}
