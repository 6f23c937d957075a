// Fused diffuse-rain deposit + arrival-time histogram, one thread-block
// cluster per (source, capsule, column of bands).
//
// Replaces audiblelight_tpu/ops/pallas_kernels.py:deposit_histogram_pallas
// (_deposit_histogram_kernel). For every ray that hit a face this bounce:
//   deposit = e_refl * cos(theta) / (4 pi^2 max(d, 1e-2)^2)
// masked by visibility (occ == 0), cos(theta) > 0 and the padded bin range,
// binned at int(arrival * (1 / bin_dt)), arrival = (dist + d) * (1 / c), and
// summed per band into out (E, C, B, n_bins). The sources may belong to
// several scenes traced in one bounce (the batched renders): source e reads
// its scene's capsules, row (e / sources_per_scene) * C + c of the (n_scenes
// * C, 3) listener points; one scene (sources_per_scene = E) reads row c.
//
// Bound on this card: bytes (hit, normal, e_refl, dist, occ: ~45 B per ray
// and capsule read, plus the (E, C, B, n_bins) output written once); the
// geometry is ~25 flops per (ray, capsule). Design: the fold of
// hist_fold.cuh, with no atomic (a float atomicAdd on shared memory is a
// compare-and-swap spin on the H100, ATOMS.CAST.SPIN, found when the grouped
// histogram was rebuilt: PERF.md section 6, K5; the arrivals of one bounce
// crowd into a few bins and would serialise on it). The group is (source e,
// capsule c), the column the 4 bands as one float4 (one band a column where
// B % 4 != 0), and each cluster's CTAs split the group's rays, so that a
// bounce of 16 or 8 sources x 4 capsules still fills the card
// (ops/cuda_kernels.py:deposit_histogram_shape). Each lane takes one ray:
// the geometry in registers (no (C, rays) intermediate reaches device
// memory), then its bin (-1 when occluded, cos(theta) <= 0, out of range or
// in the padding above n_bins) and its column of deposits. Every output cell
// is stored once, straight into the (E, C, B, n_bins) layout, and the sums
// are taken in a fixed order: two launches give the same bits.
// fp32 throughout, no tensor cores. The binning keeps the Pallas form
// exactly -- reciprocal multiply, range test against the PADDED bin count,
// clip -- and the file is built with --fmad=false so the distance, and with
// it each bin, rounds as the plain version's does.

#include <math.h>

#include "hist_fold.cuh"

namespace {

using namespace hist_fold;

// V = float4 (four bands a column) or float (one); e_refl is (E*R, kv) in
// units of V
template <typename V>
__global__ void deposit_histogram_kernel(const float* __restrict__ hit,     // (E*R, 3)
                                         const float* __restrict__ normal,  // (E*R, 3)
                                         const V* __restrict__ e_refl,      // (E*R, B)
                                         const float* __restrict__ dist,    // (E*R,)
                                         const unsigned char* __restrict__ occ,  // (C, E*R)
                                         const float* __restrict__ lis,     // (n_scenes * C, 3)
                                         int n_caps, int sources_per_scene, int n_rays, int tr, int kv, int n_bins,
                                         int n_bins_pad,
                                         float inv_bin_dt, float range_limit, float inv_c, float four_pi2,
                                         float* __restrict__ out) {  // (E, C, B, n_bins)
  constexpr int kWidth = sizeof(V) / sizeof(float);
  extern __shared__ float4 smem[];
  V* hist = reinterpret_cast<V*>(smem);  // (n_warps, n_bins)
  const int j = blockIdx.y;
  const int g = blockIdx.z;  // e * C + c
  const int e = g / n_caps;
  const int c = g - e * n_caps;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  zero(hist, n_warps * n_bins);

  int k0, k1;
  share(n_rays, k0, k1);
  const float* row = lis + 3 * ((e / sources_per_scene) * n_caps + c);
  const float lx = row[0], ly = row[1], lz = row[2];
  const unsigned char* occ_row = occ + (size_t)c * tr + (size_t)e * n_rays;
  V* mine = hist + warp * n_bins;
  for (int base = k0 + 32 * warp; base < k1; base += 32 * n_warps) {
    const int k = base + lane;
    int b = -1;
    V v = vzero(V());
    if (k < k1 && !occ_row[k]) {
      const int r = e * n_rays + k;
      const float vx = lx - hit[3 * r];
      const float vy = ly - hit[3 * r + 1];
      const float vz = lz - hit[3 * r + 2];
      const float d2 = vx * vx + vy * vy + vz * vz;
      const float d = sqrtf(d2);
      const float cos_th =
          fmaxf((vx * normal[3 * r] + vy * normal[3 * r + 1] + vz * normal[3 * r + 2]) / fmaxf(d, 1e-9f), 0.0f);
      const float arrival = (dist[r] + d) * inv_c;
      if (cos_th > 0.0f && arrival < range_limit) {
        int bin = (int)(arrival * inv_bin_dt);
        bin = min(max(bin, 0), n_bins_pad - 1);
        if (bin < n_bins) {
          const float m = fmaxf(d, 1e-2f);
          const float geom = cos_th / (four_pi2 * (m * m));
          b = bin;
          v = vscale(e_refl[(size_t)r * kv + j], geom);
        }
      }
    }
    warp_add(mine, b, v);
  }
  float* orow = out + ((size_t)g * kv * kWidth + (size_t)j * kWidth) * n_bins;
  cluster_store(hist, n_warps, n_bins, [&](int bin, V s) { put(orow, (size_t)n_bins, bin, s); });
}

template <typename V>
int launch_v(const float* hit, const float* normal, const float* e_refl, const float* dist, const unsigned char* occ,
             const float* lis, int n_sources, int sources_per_scene, int n_rays, int n_caps, int kv, int n_bins,
             int n_bins_pad, float inv_bin_dt, float range_limit, float inv_c, float four_pi2, int n_warps,
             int cluster, float* out, cudaStream_t stream) {
  return launch(deposit_histogram_kernel<V>, dim3(cluster, kv, n_sources * n_caps), n_warps,
                (size_t)n_warps * n_bins * sizeof(V), stream, hit, normal, reinterpret_cast<const V*>(e_refl), dist,
                occ, lis, n_caps, sources_per_scene, n_rays, n_sources * n_rays, kv, n_bins, n_bins_pad, inv_bin_dt,
                range_limit, inv_c, four_pi2, out);
}

}  // namespace

// vec4: B % 4 == 0 and e_refl 16-byte aligned, columns of 4 bands.
// n_warps and cluster: ops/cuda_kernels.py:deposit_histogram_shape, sized for
// one scene's sources, so that each (source, capsule) group folds as it does
// in a one-scene launch and a batch gives each scene its one-scene bits.
extern "C" int deposit_histogram(const float* hit, const float* normal, const float* e_refl, const float* dist,
                                 const unsigned char* occ, const float* lis, int n_sources, int sources_per_scene,
                                 int n_rays, int n_caps, int n_bands, int n_bins, int n_bins_pad, float inv_bin_dt,
                                 float range_limit, float inv_c, float four_pi2, int vec4, int n_warps, int cluster,
                                 float* out, cudaStream_t stream) {
  if (n_sources <= 0 || n_caps <= 0 || n_bands <= 0 || n_bins <= 0) return (int)cudaSuccess;
  if (n_rays < 0 || n_bins > n_bins_pad || sources_per_scene <= 0 || n_sources % sources_per_scene != 0 ||
      (vec4 && (n_bands % 4 != 0 || ((size_t)e_refl & 15) != 0)))
    return (int)cudaErrorInvalidValue;
  if (vec4)
    return launch_v<float4>(hit, normal, e_refl, dist, occ, lis, n_sources, sources_per_scene, n_rays, n_caps,
                            n_bands / 4, n_bins, n_bins_pad, inv_bin_dt, range_limit, inv_c, four_pi2, n_warps,
                            cluster, out, stream);
  return launch_v<float>(hit, normal, e_refl, dist, occ, lis, n_sources, sources_per_scene, n_rays, n_caps, n_bands,
                         n_bins, n_bins_pad, inv_bin_dt, range_limit, inv_c, four_pi2, n_warps, cluster, out, stream);
}
