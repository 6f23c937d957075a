// First hit (t, original face) of each ray against the faces of a mesh, in
// classic Moller-Trumbore arithmetic.
//
// Replaces audiblelight_tpu/ops/tiled_first_hit.py:tiled_first_hit
// (_fh_kernel), which culls (ray block, Morton tile) pairs on the TPU. Its
// contract stays: the dense classic Moller-Trumbore first hit over the
// finite, non-degenerate faces of the mesh, the smallest original index on a
// tie (ops/cuda_kernels.py:dense_mt_table), bit for bit.
//
// Bound on this card: bytes. A ray's segment [0, t_hit] enters the boxes of
// only 2-5 faces, so the work the data needs is tiny next to the dense
// pairs (0.004 % of them on the 110,592-face room); reading the rays and the
// table once is the floor. The TPU design tests every face of each tile that
// a block of 512 rays might reach and waits on the block's worst ray, after
// a ray sort and a per-block tile sort; here each ray culls for itself: one
// thread per ray walks the mesh's face tree (first_hit_walk.cuh, the walk of
// the big first hit, first_hit.cu) in one launch, with no sort and no host
// read. The tree (ops/cuda_kernels.py:tiled_face_bvh, built once per mesh)
// holds the finite, non-degenerate faces' rows [a, e1, e2] in world
// coordinates, padded to three float4s, and each row's original face; a
// leaf row goes through mt_pair.cuh's leaf test, shared with the small first
// hit (first_hit.cu), so a tested pair gives the dense bits (built with
// --fmad=false, as the plain PyTorch versions never contract a product). The plain version of
// the walk is ops/cuda_kernels.py:tiled_walk_plain; the dense plain version
// ray_first_hit_plain with dense_mt_table.

#include <cuda_runtime.h>
#include <math.h>

#include "first_hit_walk.cuh"
#include "mt_pair.cuh"

namespace {

__global__ void first_hit_tiled_kernel(const float* __restrict__ o,       // (R, 3) origins
                                       const float* __restrict__ d,       // (R, 3) directions
                                       const float4* __restrict__ rows,   // (L * leaf_faces * 3,) leaf rows
                                       const int* __restrict__ face,      // (L * leaf_faces,) original face, -1 pads
                                       const float4* __restrict__ boxes,  // (2L, 2): node i at 2i
                                       int n_rays, int n_leaves, int leaf_faces, float* __restrict__ t_out,
                                       int* __restrict__ idx_out, int* __restrict__ visits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  first_hit_walk::Best b;
  if (isfinite(ox) && isfinite(oy) && isfinite(oz) && isfinite(dx) && isfinite(dy) && isfinite(dz))
    b = first_hit_walk::walk(mt_pair::MtLeaf<>{rows, ox, oy, oz, dx, dy, dz}, boxes, face, n_leaves, leaf_faces,
                             ox, oy, oz, dx, dy, dz);
  first_hit_walk::store(r, b, b.t, t_out, idx_out, visits);
}

}  // namespace

extern "C" int first_hit_tiled(const float* o, const float* d, const float* rows, const int* face,
                               const float* boxes, int n_rays, int n_leaves, int leaf_faces, float* t_out,
                               int* idx_out, int* visits, cudaStream_t stream) {
  return first_hit_walk::launch(first_hit_tiled_kernel, n_rays, n_leaves, leaf_faces, stream, o, d,
                                reinterpret_cast<const float4*>(rows), face, reinterpret_cast<const float4*>(boxes),
                                n_rays, n_leaves, leaf_faces, t_out, idx_out, visits);
}
