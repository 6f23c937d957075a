// Fused diffuse-rain deposit + AmbiX first-order encode + arrival-time
// histogram for one listener point, one thread-block cluster per (source,
// channel, column of bands).
//
// Replaces audiblelight_tpu/ops/pallas_kernels.py:deposit_histogram_foa_pallas
// (_deposit_histogram_foa_kernel). For every ray that hit a face this bounce:
//   inv_d = 1 / max(d, 1e-9), cos(theta) = max(v . n * inv_d, 0)
//   deposit = e_refl * cos(theta) / (4 pi^2 max(d, 1e-2)^2)
// masked by visibility (occ == 0), cos(theta) > 0 and the padded bin range,
// binned at int(arrival * (1 / bin_dt)), arrival = (dist + d) * (1 / c), and
// encoded as [W, X, Y, Z] = deposit * [1, ux, uy, uz] of the arrival vector
// u = -v * inv_d (v = listener - hit), per band, into out (E, 4, B, n_bins).
// The sources may belong to several scenes traced in one bounce (the batched
// renders): source e reads its scene's point, row e / sources_per_scene of
// the (n_scenes, 3) listener points; one scene (sources_per_scene = E) row 0.
//
// Bound on this card: bytes (hit, normal, e_refl, dist, occ: ~45 B per ray
// read, plus the (E, 4, B, n_bins) output written once); the arithmetic is
// ~40 flops per ray. Design: the fold of hist_fold.cuh, with no atomic (a
// float atomicAdd on shared memory is a compare-and-swap spin on the H100,
// ATOMS.CAST.SPIN, found when the grouped histogram was rebuilt: PERF.md
// section 6, K5; the arrivals of one bounce crowd into a few bins and would
// serialise on it). The group is one source, the column one channel (W, X,
// Y or Z) as a float4 of its 4 bands (one band a column where B % 4 != 0),
// and each cluster's CTAs split the source's rays
// (ops/cuda_kernels.py:deposit_histogram_shape). Each lane takes one ray:
// geometry, bin (-1 when occluded, cos(theta) <= 0, out of range or in the
// padding above n_bins) and deposit as the plain version forms them, then its
// channel's gain. The four channels' CTAs each form the ray's geometry again
// (~40 flops and ~45 B read from L2 a ray): one CTA holding all 16 values a
// ray would need four histograms a warp (32 KiB at 501 bins), so fewer warps
// and a quarter of the CTAs. Every output cell is stored once, so the
// wrapper needs no memset, and the sums are taken in a fixed order: two
// launches give the same bits. fp32 throughout, no tensor cores; built with
// --fmad=false so each rounding follows the plain version. K4's rounding is
// its own: cos(theta) multiplies by inv_d where K3 divides.

#include <math.h>

#include "hist_fold.cuh"

namespace {

using namespace hist_fold;

// V = float4 (four bands a column) or float (one); e_refl is (E*R, kv) in
// units of V; grid.y = 4 channels x kv columns
template <typename V>
__global__ void deposit_histogram_foa_kernel(const float* __restrict__ hit,     // (E*R, 3)
                                             const float* __restrict__ normal,  // (E*R, 3)
                                             const V* __restrict__ e_refl,      // (E*R, B)
                                             const float* __restrict__ dist,    // (E*R,)
                                             const unsigned char* __restrict__ occ,  // (E*R,)
                                             const float* __restrict__ lis,     // (n_scenes, 3)
                                             int sources_per_scene, int n_rays, int kv, int n_bins, int n_bins_pad,
                                             float inv_bin_dt, float range_limit, float inv_c, float four_pi2,
                                             float* __restrict__ out) {  // (E, 4, B, n_bins)
  constexpr int kWidth = sizeof(V) / sizeof(float);
  extern __shared__ float4 smem[];
  V* hist = reinterpret_cast<V*>(smem);  // (n_warps, n_bins)
  const int ch = blockIdx.y / kv;
  const int j = blockIdx.y - ch * kv;
  const int e = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  zero(hist, n_warps * n_bins);

  int k0, k1;
  share(n_rays, k0, k1);
  const float* row = lis + 3 * (e / sources_per_scene);  // the source's scene's listener point
  const float lx = row[0], ly = row[1], lz = row[2];
  V* mine = hist + warp * n_bins;
  for (int base = k0 + 32 * warp; base < k1; base += 32 * n_warps) {
    const int k = base + lane;
    const int r = e * n_rays + k;
    int b = -1;
    V v = vzero(V());
    if (k < k1 && !occ[r]) {
      const float vx = lx - hit[3 * r];
      const float vy = ly - hit[3 * r + 1];
      const float vz = lz - hit[3 * r + 2];
      const float d2 = vx * vx + vy * vy + vz * vz;
      const float d = sqrtf(d2);
      const float inv_d = 1.0f / fmaxf(d, 1e-9f);
      const float cos_th =
          fmaxf((vx * normal[3 * r] + vy * normal[3 * r + 1] + vz * normal[3 * r + 2]) * inv_d, 0.0f);
      const float arrival = (dist[r] + d) * inv_c;
      if (cos_th > 0.0f && arrival < range_limit) {
        int bin = (int)(arrival * inv_bin_dt);
        bin = min(max(bin, 0), n_bins_pad - 1);
        if (bin < n_bins) {
          const float m = fmaxf(d, 1e-2f);
          const float geom = cos_th / (four_pi2 * (m * m));
          b = bin;
          v = vscale(e_refl[(size_t)r * kv + j], geom);
          if (ch) v = vscale(v, ch == 1 ? -vx * inv_d : ch == 2 ? -vy * inv_d : -vz * inv_d);
        }
      }
    }
    warp_add(mine, b, v);
  }
  float* orow = out + (((size_t)e * 4 + ch) * kv * kWidth + (size_t)j * kWidth) * n_bins;
  cluster_store(hist, n_warps, n_bins, [&](int bin, V s) { put(orow, (size_t)n_bins, bin, s); });
}

template <typename V>
int launch_v(const float* hit, const float* normal, const float* e_refl, const float* dist, const unsigned char* occ,
             const float* lis, int n_sources, int sources_per_scene, int n_rays, int kv, int n_bins, int n_bins_pad,
             float inv_bin_dt, float range_limit, float inv_c, float four_pi2, int n_warps, int cluster, float* out,
             cudaStream_t stream) {
  return launch(deposit_histogram_foa_kernel<V>, dim3(cluster, 4 * kv, n_sources), n_warps,
                (size_t)n_warps * n_bins * sizeof(V), stream, hit, normal, reinterpret_cast<const V*>(e_refl), dist,
                occ, lis, sources_per_scene, n_rays, kv, n_bins, n_bins_pad, inv_bin_dt, range_limit, inv_c,
                four_pi2, out);
}

}  // namespace

// vec4: B % 4 == 0 and e_refl 16-byte aligned, columns of 4 bands.
// n_warps and cluster: ops/cuda_kernels.py:deposit_histogram_shape.
extern "C" int deposit_histogram_foa(const float* hit, const float* normal, const float* e_refl, const float* dist,
                                     const unsigned char* occ, const float* lis, int n_sources,
                                     int sources_per_scene, int n_rays,
                                     int n_bands, int n_bins, int n_bins_pad, float inv_bin_dt, float range_limit,
                                     float inv_c, float four_pi2, int vec4, int n_warps, int cluster, float* out,
                                     cudaStream_t stream) {
  if (n_sources <= 0 || n_bands <= 0 || n_bins <= 0) return (int)cudaSuccess;
  if (n_rays < 0 || n_bins > n_bins_pad || sources_per_scene <= 0 || n_sources % sources_per_scene != 0 ||
      (vec4 && (n_bands % 4 != 0 || ((size_t)e_refl & 15) != 0)))
    return (int)cudaErrorInvalidValue;
  if (vec4)
    return launch_v<float4>(hit, normal, e_refl, dist, occ, lis, n_sources, sources_per_scene, n_rays, n_bands / 4,
                            n_bins, n_bins_pad, inv_bin_dt, range_limit, inv_c, four_pi2, n_warps, cluster, out,
                            stream);
  return launch_v<float>(hit, normal, e_refl, dist, occ, lis, n_sources, sources_per_scene, n_rays, n_bands, n_bins,
                         n_bins_pad, inv_bin_dt, range_limit, inv_c, four_pi2, n_warps, cluster, out, stream);
}
