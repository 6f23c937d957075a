// Star any-hit (K6): is the open segment from each surface point to one
// common end point (the listener centroid, or one capsule) blocked by the
// mesh?
//
// Replaces audiblelight_tpu/ops/star_occlusion.py:star_segments_occluded
// (_star_kernel). The reference sorts the segments by azimuth about the
// centre and culls (block x tile) pairs by azimuth windows; the route
// decision that layout makes (ops/star_occlusion.py:build_star_accel) is
// kept, the layout is not. Each exact-mode bounce queries 10k-80k hit
// points against the 110,592-face mesh, once per bounce.
//
// Bound on this card: the work the data needs, counted as for K2: a blocked
// segment needs its one blocking face, a free one the faces whose box its
// segment [0, length] enters; reading the segments and the table once is
// the floor where those pairs are few. Design: one thread per segment walks
// the star's face tree (the faces the reference's star tests: finite, with
// area > 0; built once per mesh) toward the common end, through the walk it
// shares with K2 (any_hit_walk.cuh), in one launch: no azimuth sort, no
// gather, no padding, no un-sort, and no block that waits for its worst
// segment (each thread stops at its own first blocker). The glue
// (ops/star_occlusion.py) forms origins, directions and lengths exactly as
// the dense any-hit does, so the result equals it boolean for boolean.
// Built with --fmad=false like the other kernels.

#include "any_hit_walk.cuh"

namespace {

__global__ void __launch_bounds__(any_hit_walk::kThreads)
star_any_hit_kernel(const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ len,
                    const float4* __restrict__ rows, const float4* __restrict__ boxes, int n_leaves,
                    int leaf_faces, const float4* __restrict__ always, int n_always, int n_seg,
                    unsigned char* __restrict__ out, int* __restrict__ visits) {
  any_hit_walk::segment(o, d, len, rows, boxes, n_leaves, leaf_faces, always, n_always, n_seg, out, visits);
}

}  // namespace

extern "C" int star_any_hit(const float* o, const float* d, const float* len, const float* rows,
                            const float* boxes, int n_leaves, int leaf_faces, const float* always, int n_always,
                            int n_seg, unsigned char* out, int* visits, cudaStream_t stream) {
  return any_hit_walk::launch<star_any_hit_kernel>(o, d, len, rows, boxes, n_leaves, leaf_faces, always,
                                                   n_always, n_seg, out, visits, stream);
}
