// Segment occlusion (K2): does any face cross the open segment start -> end?
//
// Replaces audiblelight_tpu/ops/pallas_kernels.py:segments_occluded_pallas
// (_any_hit_kernel): Moller-Trumbore with the segment-interior window
// 1e-4 < t < length - 1e-4, OR-folded over all faces. Its callers: the
// per-face rain table (4,071 x 4,071 segments), the diffraction graph legs
// (~600k segments on the 4,071-face LOD), the direct-path and diffraction
// triggers and the line-of-sight query (tens of segments on the 110,592-face
// mesh), and the exact rain mode where no star layout pays.
//
// Bound on this card: the work the data needs is small next to the dense
// R x F pairs the Pallas body tests: a blocked segment needs its one
// blocking face, a free one the faces whose box its segment [0, length]
// enters (a few dozen of 4,071 for a diffraction leg); reading the segments
// and the face table once is the floor where the pairs are that few.
// Design: one thread per segment walks the mesh's any-hit face tree (built
// once per mesh, ops/cuda_kernels.py:any_hit_tree) in one launch, through
// the walk it shares with K6 (any_hit_walk.cuh): no sort, no host read, no
// per-call table, no memset, and no block-level wait, since every thread
// walks its own segment and stops at its own first blocker. Origins, unit
// directions and lengths are formed by the caller in PyTorch
// (cuda_kernels.segment_inputs), as the Pallas wrapper forms them. Built with
// --fmad=false to keep the Pallas body's rounding.

#include "any_hit_walk.cuh"

namespace {

__global__ void __launch_bounds__(any_hit_walk::kThreads)
any_hit_kernel(const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ len,
               const float4* __restrict__ rows, const float4* __restrict__ boxes, int n_leaves, int leaf_faces,
               const float4* __restrict__ always, int n_always, int n_seg, unsigned char* __restrict__ out,
               int* __restrict__ visits) {
  any_hit_walk::segment(o, d, len, rows, boxes, n_leaves, leaf_faces, always, n_always, n_seg, out, visits);
}

}  // namespace

extern "C" int any_hit(const float* o, const float* d, const float* len, const float* rows, const float* boxes,
                       int n_leaves, int leaf_faces, const float* always, int n_always, int n_seg,
                       unsigned char* out, int* visits, cudaStream_t stream) {
  return any_hit_walk::launch<any_hit_kernel>(o, d, len, rows, boxes, n_leaves, leaf_faces, always, n_always,
                                              n_seg, out, visits, stream);
}
