// First hit (t, sorted face) of a ray wavefront against the Morton-sorted
// faces of a mesh, dead rays masked.
//
// Replaces audiblelight_tpu/ops/sorted_first_hit.py:sorted_first_hit
// (_sfh_kernel) and its glue. Its contract stays: the dense big first hit
// over the Morton-sorted faces (ops/sorted_first_hit.py:build_sorted_tiles:
// the tiles' 16-column table [e2, w2, -e1, -w1, -n, -k], centred on the
// mesh), bit for bit, each hit reported by its sorted index, the smallest on
// a tie; dead rays and misses (inf, -1).
//
// Bound on this card: bytes. A ray's segment [0, t_hit] enters the boxes of
// only a few faces (0.0035 % of the dense pairs on the 110,592-face room's
// surface rays); reading the rays and the table once is the floor. The TPU
// design sorts the rays by (origin cell, direction cone), bounds every
// (block of 512 rays, tile of 256 faces) pair, tests every face of each
// reachable tile in bound order and waits on the block's worst ray; here
// each ray culls for itself: one thread per ray walks a face tree of the
// sorted table's rows (ops/sorted_first_hit.py:build_sorted_tree, built once
// per tiling: K1 big's tree over the sentinel-padded sorted faces) with the
// walk of first_hit_walk.cuh and the bilinear leaf test of bilinear_pair.cuh
// (both shared with K1 big, first_hit.cu), in one launch: the centring and
// the alive mask are read inside it, with no ray sort, no tile bounds, no
// argsort, no un-sort and no host read. A dead ray writes (inf, -1) without
// walking. The file is built with --fmad=false, as the plain version
// (ops/sorted_first_hit.py:sorted_walk) never contracts a product; with
// `visits` non-null the kernel writes each ray's box tests and leaf folds,
// which equal the plain walk's.

#include <cuda_runtime.h>
#include <math.h>

#include "bilinear_pair.cuh"
#include "first_hit_walk.cuh"

namespace {

__global__ void first_hit_sorted_kernel(const float* __restrict__ o,             // (R, 3) origins, world
                                        const float* __restrict__ d,             // (R, 3) directions
                                        const unsigned char* __restrict__ alive, // (R,) 1 = live; or null
                                        const float* __restrict__ center,        // (3,) the tiles' centre
                                        const float4* __restrict__ rows,         // (L * 16, 4) leaf rows
                                        const int* __restrict__ face,            // (L * 16,) sorted face, -1 pads
                                        const float4* __restrict__ boxes,        // (2L, 2): node i at 2i, centred
                                        int n_rays, int n_leaves, int leaf_faces, float* __restrict__ t_out,
                                        int* __restrict__ idx_out, int* __restrict__ visits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = o[3 * r] - __ldg(center), oy = o[3 * r + 1] - __ldg(center + 1),
              oz = o[3 * r + 2] - __ldg(center + 2);
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  first_hit_walk::Best b;
  const bool live = alive == nullptr || alive[r] != 0;
  if (live && isfinite(ox) && isfinite(oy) && isfinite(oz) && isfinite(dx) && isfinite(dy) && isfinite(dz))
    b = first_hit_walk::walk(bilinear_pair::leaf_of(rows, ox, oy, oz, dx, dy, dz), boxes, face, n_leaves,
                             leaf_faces, ox, oy, oz, dx, dy, dz);
  first_hit_walk::store(r, b, b.t, t_out, idx_out, visits);
}

}  // namespace

extern "C" int first_hit_sorted(const float* o, const float* d, const unsigned char* alive, const float* center,
                                const float* rows, const int* face, const float* boxes, int n_rays, int n_leaves,
                                int leaf_faces, float* t_out, int* idx_out, int* visits, cudaStream_t stream) {
  return first_hit_walk::launch(first_hit_sorted_kernel, n_rays, n_leaves, leaf_faces, stream, o, d, alive, center,
                                reinterpret_cast<const float4*>(rows), face, reinterpret_cast<const float4*>(boxes),
                                n_rays, n_leaves, leaf_faces, t_out, idx_out, visits);
}
