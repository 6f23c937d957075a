// Cone-sorted, entry-ordered first hit (t, sorted face) of a ray wavefront
// against Morton-tiled faces.
//
// Replaces audiblelight_tpu/ops/sorted_first_hit.py:sorted_first_hit
// (_sfh_kernel). The host build (ops/sorted_first_hit.py) sorts the faces by
// centroid Morton code into tiles of 256 rows of the dense big first hit's
// 16-column table [e2, w2, -e1, -w1, -n, -k], centred on the mesh; the glue
// sorts the rays by (origin cell x direction cone), dead rays last, and
// gives every block of 512 sorted rays its reachable tiles in ascending
// order of a conservative directed entry bound (`perm`, `dlo`) and their
// count (`nv`). A block walks perm[b, 0 .. nv[b]) in that order:
//
// - each tile's 256 x 16 floats (16 KiB) are staged once into shared memory
//   and every thread tests its ray against the 256 faces with the dense big
//   first hit's pair arithmetic (bilinear_pair.cuh, shared with first_hit.cu
//   and pair_first_hit.cu);
// - each thread keeps its ray's smallest (t, sorted face index), the index
//   breaking a tie in t: tiles are visited in bound order, not index order,
//   so a strict `<` alone would keep the earlier-visited face of a tie;
// - after every tile the block takes the largest best t over its rays (dead
//   lanes hold 0) and stops once it is not above the next tile's bound.
//
// The bounds are conservative, so the result is the dense big first hit
// over the Morton-sorted faces, bit for bit (the file is built with
// --fmad=false, as the plain version never contracts a product). Dead lanes
// return t = 0 and -1, misses 3e38 and -1.
//
// Bound on this card: fp32 ALU, 38 flops per (ray, face) pair of the tiles
// the walk keeps; the face table (110,592 faces x 64 B = 7 MB) stays in L2.
// Design: one block per 512 sorted rays, one thread per ray, every thread
// reading the same staged face row at once (a shared-memory broadcast).
// The early exit waits for the block's worst ray, as in the reference.

#include <cuda_runtime.h>
#include <math.h>

#include "bilinear_pair.cuh"

namespace {

constexpr int kBlock = 512;  // sorted rays per block: SFH_LANES in ops/cuda_kernels.py
using bilinear_pair::kBig;
using bilinear_pair::kIdxBig;

__global__ void __launch_bounds__(kBlock)
first_hit_sorted_kernel(const float* __restrict__ o,      // (R_pad, 3) sorted, centred origins
                        const float* __restrict__ d,      // (R_pad, 3) sorted directions
                        const int* __restrict__ alive,    // (R_pad,) 1 = live
                        const int* __restrict__ perm,     // (n_blocks, n_tiles) visit order
                        const float* __restrict__ dlo,    // (n_blocks, n_tiles) ascending bounds
                        const int* __restrict__ nv,       // (n_blocks,) reachable tiles
                        const float* __restrict__ tab,    // (n_tiles * 256, 16)
                        int n_tiles, float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float4 faces[bilinear_pair::kTileFaces * bilinear_pair::kCols / 4];
  __shared__ float warp_worst[kBlock / 32];
  const int g = blockIdx.x;
  const int r = g * kBlock + threadIdx.x;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  // Shared per-ray Plucker moment od = o x d
  const float odx = oy * dz - oz * dy;
  const float ody = oz * dx - ox * dz;
  const float odz = ox * dy - oy * dx;
  const bool live = alive[r] != 0;
  const int* my_perm = perm + (size_t)g * n_tiles;
  const float* my_dlo = dlo + (size_t)g * n_tiles;
  const int n_visit = min(nv[g], n_tiles);

  // Dead lanes start resolved at t = 0, so they never hold the walk open
  float best_t = live ? kBig : 0.0f;
  int best_i = kIdxBig;
  for (int i = 0; i < n_visit; ++i) {
    const int tl = __ldg(my_perm + i);
    __syncthreads();  // every thread is done with the previous tile
    bilinear_pair::stage_tile(faces, tab, tl);
    __syncthreads();
    bilinear_pair::fold_tile(faces, tl, ox, oy, oz, dx, dy, dz, odx, ody, odz, best_t, best_i);
    // The block's worst resolved ray: a warp max, then the max of the warps'
    float w = best_t;
    for (int s = 16; s > 0; s >>= 1) w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, s));
    if ((threadIdx.x & 31) == 0) warp_worst[threadIdx.x >> 5] = w;
    __syncthreads();
    float worst = warp_worst[0];
    for (int k = 1; k < kBlock / 32; ++k) worst = fmaxf(worst, warp_worst[k]);
    const float nxt = i + 1 < n_visit ? __ldg(my_dlo + i + 1) : kBig;
    if (worst <= nxt) break;  // block-uniform; the next tile's first barrier guards warp_worst
  }
  t_out[r] = best_t;
  idx_out[r] = (best_t >= kBig || !live) ? -1 : best_i;
}

}  // namespace

extern "C" int first_hit_sorted(const float* o, const float* d, const int* alive, const int* perm, const float* dlo,
                                const int* nv, const float* tab, int n_rays_pad, int n_tiles, float* t_out,
                                int* idx_out, cudaStream_t stream) {
  if (n_rays_pad <= 0) return (int)cudaSuccess;
  if (n_rays_pad % kBlock != 0 || n_tiles <= 0) return (int)cudaErrorInvalidValue;
  first_hit_sorted_kernel<<<n_rays_pad / kBlock, kBlock, 0, stream>>>(o, d, alive, perm, dlo, nv, tab, n_tiles,
                                                                      t_out, idx_out);
  return (int)cudaGetLastError();
}
