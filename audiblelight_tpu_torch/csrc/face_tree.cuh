// The slab test of a padded face-tree box, shared by the first hit's tree
// walk (first_hit_walk.cuh) and the any-hit walk (any_hit_walk.cuh). The trees are
// built by ops/cuda_kernels.py:build_face_bvh (heap order, node i at
// boxes[2i] = lo, boxes[2i + 1] = hi); the plain versions compute the same
// predicate with ops/cuda_kernels.py:slab_inverse and slab_entry_exit.

#pragma once

#include <math.h>

namespace face_tree {

constexpr int kStack = 30;  // BVH_MAX_DEPTH: one pushed node per level at most
constexpr float kSlabTiny = 1e-20f;

// A read of a tree's table: through the read-only data cache where the
// table lies in device memory (kGlobal), a plain load where a block has
// staged it into shared memory (K1 small, first_hit.cu)
template <bool kGlobal, class T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// 1 / d, a component under 1e-20 in size counted as +-1e-20, so that no
// slab product is 0 * inf
__device__ __forceinline__ float slab_inverse(float d) {
  return 1.0f / (fabsf(d) < kSlabTiny ? copysignf(kSlabTiny, d) : d);
}

// (entry, exit) of the ray o + s d, s >= 0, into box `b` (lo at b[0], hi at
// b[1]), with i = slab_inverse(d): the near and far planes chosen by the
// sign of i, so an empty box (+inf, -inf) enters at +inf.
template <bool kGlobal = true>
__device__ __forceinline__ void slab(const float4* __restrict__ b, float ox, float oy, float oz, float ix,
                                     float iy, float iz, float& t_in, float& t_out) {
  const float4 lo = load<kGlobal>(b);
  const float4 hi = load<kGlobal>(b + 1);
  const float nx = ((ix >= 0.0f ? lo.x : hi.x) - ox) * ix;
  const float ny = ((iy >= 0.0f ? lo.y : hi.y) - oy) * iy;
  const float nz = ((iz >= 0.0f ? lo.z : hi.z) - oz) * iz;
  const float fx = ((ix >= 0.0f ? hi.x : lo.x) - ox) * ix;
  const float fy = ((iy >= 0.0f ? hi.y : lo.y) - oy) * iy;
  const float fz = ((iz >= 0.0f ? hi.z : lo.z) - oz) * iz;
  t_in = fmaxf(fmaxf(nx, ny), fmaxf(nz, 0.0f));
  t_out = fminf(fminf(fx, fy), fz);
}

}  // namespace face_tree
