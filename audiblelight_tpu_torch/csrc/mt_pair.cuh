// Classic Moller-Trumbore for one (ray, face) pair, as the Pallas small
// first-hit body (audiblelight_tpu/ops/pallas_kernels.py:
// _first_hit_small_kernel) and the tiled first-hit body
// (audiblelight_tpu/ops/tiled_first_hit.py:_fh_kernel) write it, term for
// term, and the leaf test `MtLeaf` of a face tree's rows [a, e1, e2] for the
// first-hit walk (first_hit_walk.cuh). K1 small (first_hit.cu) and K7
// (tiled_first_hit.cu) both walk with it, so both compute the dense classic
// first hit's bits; every file that includes it is built with --fmad=false,
// as the plain PyTorch version (ops/cuda_kernels.py:_mt_pair) never
// contracts a product.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "face_tree.cuh"

namespace mt_pair {

constexpr float kEps = 1e-9f;
constexpr float kOnePlusEps = (float)(1.0 + 1e-9);  // rounds to 1.0f, as in f32 JAX

// True where the ray (o, d) hits the face (a, e1, e2) inside its window with
// t > 1e-9; `t` is the hit distance in units of |d|.
__device__ __forceinline__ bool first_hit(float ax, float ay, float az, float e1x, float e1y, float e1z,
                                          float e2x, float e2y, float e2z, float ox, float oy, float oz,
                                          float dx, float dy, float dz, float* t_out) {
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
  *t_out = t;
  return valid_a && (u >= -kEps) && (u <= kOnePlusEps) && (v >= -kEps) && (u + v <= kOnePlusEps) &&
         (t > kEps);
}

// The classic Moller-Trumbore test of one face-tree row [a, e1, e2, 0, 0, 0]
// (three float4s, ops/cuda_kernels.py:MT_ROW) against the ray o + s d;
// kGlobal is false where a block has staged the rows into shared memory
template <bool kGlobal = true>
struct MtLeaf {
  const float4* __restrict__ rows;
  float ox, oy, oz, dx, dy, dz;

  __device__ __forceinline__ bool operator()(int row, int, float* t) const {
    const float4 r0 = face_tree::load<kGlobal>(rows + 3 * row), r1 = face_tree::load<kGlobal>(rows + 3 * row + 1),
                 r2 = face_tree::load<kGlobal>(rows + 3 * row + 2);
    return first_hit(r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x, ox, oy, oz, dx, dy, dz, t);
  }
};

}  // namespace mt_pair
