// One round of the per-ray pair-walk first hit: each lane of a tile-aligned
// pair layout tests its ray against its block's tile.
//
// Replaces audiblelight_tpu/ops/pair_first_hit.py:pair_first_hit
// (_pair_kernel). The glue (ops/pair_first_hit.py) slab-tests every (ray,
// tile) pair, takes each ray's K nearest tiles, and lays the (ray, tile)
// pairs out tile-aligned: pairs sort by tile and each tile's run pads to
// whole blocks of 512 lanes, so every block serves exactly one tile
// (`blk_tile`, -1 for a block past every run). Padding lanes carry a zero
// ray, which never hits. Per block:
//
// - a block with a tile id < 0 writes (3e38, -1) on every lane and returns;
// - otherwise it stages the tile's 256 x 16 floats (16 KiB) into shared
//   memory once, and each thread tests its lane's ray against the 256 faces
//   with the dense big first hit's pair arithmetic (bilinear_pair.cuh,
//   shared with first_hit.cu and sorted_first_hit.cu) and keeps the
//   smallest (t, sorted face index);
// - a lane whose best t is 3e38 or more reports face -1.
//
// The glue reduces each ray's K lanes with the same tie rule and repeats
// rounds while a ray's next untested tile could still hold a nearer hit, so
// the op equals the dense big first hit over the Morton-sorted faces, bit
// for bit (built with --fmad=false, as the plain version never contracts).
//
// Bound on this card: fp32 ALU, 38 flops per (lane, face) pair; each block
// reads one 16 KiB tile, which stays in L2 across the blocks of its run.
// Design: one block per 512 lanes, one thread per lane, every thread reading
// the same staged face row at once (a shared-memory broadcast). No block
// waits on another and none exits early, so the launch is dense work.

#include <cuda_runtime.h>
#include <math.h>

#include "bilinear_pair.cuh"

namespace {

constexpr int kBlock = 512;  // pair lanes per block: PFH_LANES in ops/cuda_kernels.py
using bilinear_pair::kBig;
using bilinear_pair::kIdxBig;

__global__ void __launch_bounds__(kBlock)
first_hit_pair_kernel(const float* __restrict__ o,        // (n_lanes, 3) centred origins
                      const float* __restrict__ d,        // (n_lanes, 3) directions
                      const int* __restrict__ blk_tile,   // (n_blocks,) tile per block, -1 for none
                      const float* __restrict__ tab,      // (n_tiles * 256, 16)
                      int n_tiles, float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float4 faces[bilinear_pair::kTileFaces * bilinear_pair::kCols / 4];
  const int g = blockIdx.x;
  const int r = g * kBlock + threadIdx.x;
  const int tl = blk_tile[g];
  if (tl < 0 || tl >= n_tiles) {  // block-uniform, before any barrier
    t_out[r] = kBig;
    idx_out[r] = -1;
    return;
  }
  bilinear_pair::stage_tile(faces, tab, tl);
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  // Shared per-ray Plucker moment od = o x d
  const float odx = oy * dz - oz * dy;
  const float ody = oz * dx - ox * dz;
  const float odz = ox * dy - oy * dx;
  __syncthreads();

  float best_t = kBig;
  int best_i = kIdxBig;
  bilinear_pair::fold_tile(faces, tl, ox, oy, oz, dx, dy, dz, odx, ody, odz, best_t, best_i);
  t_out[r] = best_t;
  idx_out[r] = best_t >= kBig ? -1 : best_i;
}

}  // namespace

extern "C" int first_hit_pair(const float* o, const float* d, const int* blk_tile, const float* tab, int n_lanes,
                              int n_tiles, float* t_out, int* idx_out, cudaStream_t stream) {
  if (n_lanes <= 0) return (int)cudaSuccess;
  if (n_lanes % kBlock != 0 || n_tiles <= 0) return (int)cudaErrorInvalidValue;
  first_hit_pair_kernel<<<n_lanes / kBlock, kBlock, 0, stream>>>(o, d, blk_tile, tab, n_tiles, t_out, idx_out);
  return (int)cudaGetLastError();
}
