// Star any-hit: is the open segment from each surface point to one common
// end point (the listener centroid, or one capsule) blocked by the mesh?
//
// Replaces audiblelight_tpu/ops/star_occlusion.py:star_segments_occluded
// (_star_kernel). The segments all end within r_pad of the star centre, so a
// narrow face (one whose xy-projection stays >= rho_lim from the centre) can
// only block a segment whose start lies inside the face's azimuth window
// about the centre. The host build (ops/star_occlusion.py) sorts the narrow
// faces by window centre into tiles of 256 with one circular window per
// tile, and keeps the rest (the wide faces) apart; the glue sorts the
// segments by azimuth, so each block of 256 segments covers a contiguous
// azimuth range [b_lo, b_hi]. A (block, tile) pair whose circular intervals
// miss is skipped whole; every segment tests every wide face. The cull is
// conservative, so the result equals the dense any-hit's (any_hit.cu): the
// same Moller-Trumbore arithmetic and the window 1e-4 < t < length - 1e-4.
//
// Bound on this card: fp32 ALU, ~46 flops per (segment, face) pair that the
// cull keeps; the tables (110,592 faces x 36 B = 4 MB) stay in L2. Design:
// one thread per azimuth-sorted segment; the tile test is block-uniform, and
// a kept tile is staged cooperatively into shared memory (256 faces x 9 f32 =
// 9 KiB), where every thread reads the same face at once (a broadcast). Few
// segments (80k at the flagship) would under-fill the card, so the work
// items (narrow tiles, then the wide faces in chunks of 256) are split over
// grid.y slices; a thread that finds a blocker stores 1 into its segment's
// zeroed output byte (an OR without atomics). Per thread, the scan stops at
// the first blocker; per block, a slice stops once every segment in it is
// blocked (a block vote). Built with --fmad=false like the other kernels.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kBlock = 256;      // segments per block: STAR_BLOCK in ops/cuda_kernels.py
constexpr int kTileFaces = 256;  // faces per narrow tile: TILE_FACES in ops/star_occlusion.py
constexpr float kEps = 1e-9f;
constexpr float kOnePlusEps = (float)(1.0 + 1e-9);
constexpr float kMargin = 1e-4f;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);

// Moller-Trumbore window test of one segment against `n` faces in shared
// memory; true at the first face that crosses the open segment.
__device__ __forceinline__ bool any_face(const float* faces, int n, float ox, float oy, float oz,
                                         float dx, float dy, float dz, float t_max) {
  for (int f = 0; f < n; ++f) {
    const float* c = faces + 9 * f;
    const float ax = c[0], ay = c[1], az = c[2];
    const float e1x = c[3], e1y = c[4], e1z = c[5];
    const float e2x = c[6], e2y = c[7], e2z = c[8];
    const float hx = dy * e2z - dz * e2y;
    const float hy = dz * e2x - dx * e2z;
    const float hz = dx * e2y - dy * e2x;
    const float a = e1x * hx + e1y * hy + e1z * hz;
    const bool valid_a = fabsf(a) > kEps;
    const float inv = 1.0f / (valid_a ? a : 1.0f);
    const float sx = ox - ax, sy = oy - ay, sz = oz - az;
    const float u = inv * (sx * hx + sy * hy + sz * hz);
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = inv * (dx * qx + dy * qy + dz * qz);
    const float t = inv * (e2x * qx + e2y * qy + e2z * qz);
    if (valid_a && (u >= -kEps) && (u <= kOnePlusEps) && (v >= -kEps) && (u + v <= kOnePlusEps) &&
        (t > kMargin) && (t < t_max))
      return true;
  }
  return false;
}

__global__ void __launch_bounds__(kBlock)
star_any_hit_kernel(const float* __restrict__ o,       // (R_pad, 3) sorted segment starts
                    const float* __restrict__ d,       // (R_pad, 3) unit directions
                    const float* __restrict__ len,     // (R_pad,) lengths (0 on padding)
                    const float* __restrict__ brange,  // (2, n_blocks) [az lo; az hi]
                    const float* __restrict__ narrow,  // (n_tiles * 256, 9) a, e1, e2
                    const float* __restrict__ meta,    // (2, n_tiles) [centre; half-width]
                    const float* __restrict__ wide,    // (n_wide, 9)
                    int n_blocks, int n_tiles, int n_wide, int items_per_slice,
                    unsigned char* __restrict__ out) {  // (R_pad,) zeroed
  __shared__ float faces[kTileFaces * 9];
  const int r = blockIdx.x * kBlock + threadIdx.x;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float t_max = len[r] - kMargin;
  const float b_lo = brange[blockIdx.x], b_hi = brange[n_blocks + blockIdx.x];
  const float b_cen = (b_lo + b_hi) * 0.5f;
  const float b_half = (b_hi - b_lo) * 0.5f;

  // Work items: the narrow tiles, then the wide faces in chunks of 256
  const int n_items = n_tiles + (n_wide + kTileFaces - 1) / kTileFaces;
  const int i_begin = blockIdx.y * items_per_slice;
  const int i_end = min(n_items, i_begin + items_per_slice);
  bool hit = false;
  for (int it = i_begin; it < i_end; ++it) {
    const float* src;
    int n;
    if (it < n_tiles) {
      // Circular interval overlap: the centre difference wrapped into [-pi, pi)
      float dd = __ldg(meta + it) - b_cen;
      dd = dd - kTwoPi * floorf(dd / kTwoPi + 0.5f);
      if (!(fabsf(dd) <= __ldg(meta + n_tiles + it) + b_half)) continue;  // block-uniform
      src = narrow + (size_t)it * kTileFaces * 9;
      n = kTileFaces;
    } else {
      const int w0 = (it - n_tiles) * kTileFaces;
      src = wide + (size_t)w0 * 9;
      n = min(kTileFaces, n_wide - w0);
    }
    // A barrier before the shared tile is overwritten, and the block's vote
    if (__syncthreads_and(hit)) break;
    for (int i = threadIdx.x; i < n * 9; i += kBlock) faces[i] = __ldg(src + i);
    __syncthreads();
    if (!hit) hit = any_face(faces, n, ox, oy, oz, dx, dy, dz, t_max);
  }
  if (hit) out[r] = 1;
}

// Threads worth launching: enough to fill the card's 132 SMs several times
constexpr long long kTargetThreads = 1LL << 18;

}  // namespace

extern "C" int star_any_hit(const float* o, const float* d, const float* len, const float* brange,
                            const float* narrow, const float* meta, const float* wide, int n_seg_pad,
                            int n_tiles, int n_wide, unsigned char* out, cudaStream_t stream) {
  if (n_seg_pad <= 0) return (int)cudaSuccess;
  if (n_seg_pad % kBlock != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_seg_pad, stream);
  if (err != cudaSuccess) return (int)err;
  const int n_items = n_tiles + (n_wide + kTileFaces - 1) / kTileFaces;
  if (n_items <= 0) return (int)cudaSuccess;
  const int n_blocks = n_seg_pad / kBlock;
  const long long want = (kTargetThreads + n_seg_pad - 1) / n_seg_pad;
  const int n_slices = (int)std::max(1LL, std::min({want, (long long)n_items, 65535LL}));
  const int per_slice = (n_items + n_slices - 1) / n_slices;
  const dim3 grid(n_blocks, (n_items + per_slice - 1) / per_slice);
  star_any_hit_kernel<<<grid, kBlock, 0, stream>>>(o, d, len, brange, narrow, meta, wide, n_blocks,
                                                   n_tiles, n_wide, per_slice, out);
  return (int)cudaGetLastError();
}
