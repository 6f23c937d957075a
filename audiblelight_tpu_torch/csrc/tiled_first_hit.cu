// Reachability-culled first hit (t, original face) of a sorted ray wavefront
// against Morton-tiled faces.
//
// Replaces audiblelight_tpu/ops/tiled_first_hit.py:tiled_first_hit
// (_fh_kernel). The host build (ops/tiled_first_hit.py) sorts the faces by
// centroid Morton code into tiles of 256 rows [a, e1, e2, original index]
// with one tight AABB per tile; the glue sorts the rays by direction octant,
// then origin cell, so each block of 512 rays has a tight origin box and
// coherent direction signs, and gives every block its box (`bmeta`), its
// tiles in ascending order of a distance lower bound (`perm`) and those
// bounds (`dlo`). A block walks its tiles in that order:
//
// - a tile that lies wholly behind every ray of the block on one axis (all
//   dx >= 0 and the tile's max x below the block's least origin x, and the
//   five other signed axes) is skipped: the test is block-uniform and
//   conservative, and the early exit below only drops tiles no ray can hit
//   before its best hit, so the result is the dense classic Moller-Trumbore
//   first hit over the original face order;
// - every DONE_CHECK_EVERY tiles the block takes the largest best t over its
//   rays, and stops once it is not above the next tile's bound.
//
// Each thread keeps its ray's best (t, original index) with the strict
// lexicographic rule (smaller t, then smaller original index), which is the
// Pallas kernel's sublane fold; the pair arithmetic is mt_pair.cuh, shared
// with the dense first hit (first_hit.cu), built with --fmad=false.
//
// Bound on this card: fp32 ALU, ~46 flops per (ray, face) pair of the tiles
// the walk keeps; the face table (110,592 faces x 40 B = 4.4 MB) stays in
// L2. Design: one block per 512 sorted rays, one thread per ray; a kept
// tile's 256 x 10 rows (10 KiB) are staged once into shared memory and every
// thread reads the same row at once (a broadcast). The early exit is held
// back by each block's worst ray, as the reference's docstring records.

#include <cuda_runtime.h>
#include <math.h>

#include "mt_pair.cuh"

namespace {

constexpr int kBlock = 512;       // rays per block: TILED_BLOCK in ops/cuda_kernels.py
constexpr int kTileFaces = 256;   // faces per tile: TILED_TILE_FACES
constexpr int kRow = 10;          // a, e1, e2, original index
constexpr int kDoneCheckEvery = 4;  // DONE_CHECK_EVERY
constexpr float kBig = 3.0e38f;
constexpr int kIdxBig = 1 << 30;

__global__ void __launch_bounds__(kBlock)
first_hit_tiled_kernel(const float* __restrict__ o,     // (R_pad, 3) sorted origins
                       const float* __restrict__ d,     // (R_pad, 3) sorted directions
                       const float* __restrict__ bmeta,  // (12, n_blocks) omin, omax, dmin, dmax
                       const int* __restrict__ perm,    // (n_blocks, n_tiles) visit order
                       const float* __restrict__ dlo,   // (n_blocks, n_tiles) ascending bounds
                       const float* __restrict__ tab,   // (n_tiles * 256, 10)
                       const float* __restrict__ aabb,  // (6, n_tiles) lo xyz, hi xyz
                       int n_blocks, int n_tiles,
                       float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float faces[kTileFaces * kRow];
  __shared__ float warp_worst[kBlock / 32];
  const int g = blockIdx.x;
  const int r = g * kBlock + threadIdx.x;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  float om[3], oM[3], dm[3], dM[3];
  for (int ax = 0; ax < 3; ++ax) {
    om[ax] = bmeta[ax * n_blocks + g];
    oM[ax] = bmeta[(3 + ax) * n_blocks + g];
    dm[ax] = bmeta[(6 + ax) * n_blocks + g];
    dM[ax] = bmeta[(9 + ax) * n_blocks + g];
  }
  const int* my_perm = perm + (size_t)g * n_tiles;
  const float* my_dlo = dlo + (size_t)g * n_tiles;

  float best_t = kBig;
  int best_i = kIdxBig;
  for (int i = 0; i < n_tiles; ++i) {
    const int tl = __ldg(my_perm + i);
    bool reachable = true;
    for (int ax = 0; ax < 3; ++ax) {
      const float lo = __ldg(aabb + ax * n_tiles + tl);
      const float hi = __ldg(aabb + (3 + ax) * n_tiles + tl);
      reachable = reachable && !((dm[ax] >= 0.0f) && (hi < om[ax]));
      reachable = reachable && !((dM[ax] <= 0.0f) && (lo > oM[ax]));
    }
    if (reachable) {  // block-uniform
      __syncthreads();  // every thread is done with the previous tile
      const float* src = tab + (size_t)tl * kTileFaces * kRow;
      for (int k = threadIdx.x; k < kTileFaces * kRow; k += kBlock) faces[k] = __ldg(src + k);
      __syncthreads();
      for (int f = 0; f < kTileFaces; ++f) {
        const float* c = faces + kRow * f;
        float t;
        const bool hit = mt_pair::first_hit(c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], ox, oy, oz,
                                            dx, dy, dz, &t) &&
                         (c[9] >= 0.0f);
        const float t_hit = hit ? t : kBig;
        const int fidx = hit ? (int)c[9] : kIdxBig;
        if (t_hit < best_t || (t_hit == best_t && fidx < best_i)) {
          best_t = t_hit;
          best_i = fidx;
        }
      }
    }
    if (i % kDoneCheckEvery == kDoneCheckEvery - 1) {
      // The block's worst resolved ray: a warp max, then the max of the warps'
      float w = best_t;
      for (int s = 16; s > 0; s >>= 1) w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, s));
      if ((threadIdx.x & 31) == 0) warp_worst[threadIdx.x >> 5] = w;
      __syncthreads();
      float worst = warp_worst[0];
      for (int k = 1; k < kBlock / 32; ++k) worst = fmaxf(worst, warp_worst[k]);
      __syncthreads();  // warp_worst is read by all before the next check writes it
      const float nxt = __ldg(my_dlo + min(i + 1, n_tiles - 1));
      if (worst < kBig && (worst <= nxt || i + 1 >= n_tiles)) break;  // block-uniform
    }
  }
  t_out[r] = best_t;
  idx_out[r] = best_t >= kBig ? -1 : best_i;
}

}  // namespace

extern "C" int first_hit_tiled(const float* o, const float* d, const float* bmeta, const int* perm,
                               const float* dlo, const float* tab, const float* aabb, int n_rays_pad,
                               int n_tiles, float* t_out, int* idx_out, cudaStream_t stream) {
  if (n_rays_pad <= 0) return (int)cudaSuccess;
  if (n_rays_pad % kBlock != 0 || n_tiles <= 0) return (int)cudaErrorInvalidValue;
  const int n_blocks = n_rays_pad / kBlock;
  first_hit_tiled_kernel<<<n_blocks, kBlock, 0, stream>>>(o, d, bmeta, perm, dlo, tab, aabb, n_blocks, n_tiles,
                                                          t_out, idx_out);
  return (int)cudaGetLastError();
}
