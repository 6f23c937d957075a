// The bilinear ("big") Moller-Trumbore test of one (ray, face) pair, as the
// Pallas big first-hit body (audiblelight_tpu/ops/pallas_kernels.py:
// _first_hit_big_kernel) writes it, term for term, and as the cone-sorted and
// pair-walk bodies (audiblelight_tpu/ops/sorted_first_hit.py:_sfh_kernel,
// audiblelight_tpu/ops/pair_first_hit.py:_pair_kernel) repeat it. The face
// row is the 16-column table [e2, w2, -e1, -w1, -n, -k] in coordinates
// centred on the mesh, and the ray carries its Plucker moment od = o x d.
// K1 big (first_hit.cu), the sorted first hit (sorted_first_hit.cu) and the
// pair first hit (pair_first_hit.cu, one tile's subtree at a time) walk a
// face tree of those rows with the leaf test `BilinearLeaf`. All three
// compute the same bits: every file that includes this is built with
// --fmad=false, as the plain PyTorch versions
// (ops/cuda_kernels.py:_bilinear_pair) never contract a product.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace bilinear_pair {

constexpr float kEps = 1e-9f;
constexpr float kOnePlusEps = (float)(1.0 + 1e-9);  // rounds to 1.0f, as in f32 JAX

// True where the ray hits the face `c` (16 floats) inside its window with
// t > 1e-9; `t` is the hit distance in units of |d|. No guard on a == 0:
// u, v and t become inf or NaN there and every test fails (the zero rows
// that pad a table never hit).
__device__ __forceinline__ bool first_hit(const float* c, float ox, float oy, float oz, float dx, float dy,
                                          float dz, float odx, float ody, float odz, float* t_out) {
  const float u_num = (odx * c[0] + ody * c[1] + odz * c[2]) + (dx * c[3] + dy * c[4] + dz * c[5]);
  const float v_num = (odx * c[6] + ody * c[7] + odz * c[8]) + (dx * c[9] + dy * c[10] + dz * c[11]);
  const float a = dx * c[12] + dy * c[13] + dz * c[14];
  const float t_num = c[15] - (ox * c[12] + oy * c[13] + oz * c[14]);
  const float inv = 1.0f / a;
  const float u = u_num * inv;
  const float v = v_num * inv;
  const float t = t_num * inv;
  *t_out = t;
  return (u >= -kEps) && (u <= kOnePlusEps) && (v >= -kEps) && (u + v <= kOnePlusEps) && (t > kEps);
}

// The bilinear test of one face-tree row (16 floats: four float4s) for the
// first-hit walk (first_hit_walk.cuh)
struct BilinearLeaf {
  const float4* __restrict__ rows;
  float ox, oy, oz, dx, dy, dz, odx, ody, odz;  // the centred ray and its Plucker moment o x d

  __device__ __forceinline__ bool operator()(int row, int, float* t) const {
    float c[16];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 v = __ldg(rows + 4 * row + k);
      c[4 * k] = v.x;
      c[4 * k + 1] = v.y;
      c[4 * k + 2] = v.z;
      c[4 * k + 3] = v.w;
    }
    return first_hit(c, ox, oy, oz, dx, dy, dz, odx, ody, odz, t);
  }
};

// The leaf test of the centred ray (o, d), its Plucker moment formed once
__device__ __forceinline__ BilinearLeaf leaf_of(const float4* __restrict__ rows, float ox, float oy, float oz,
                                                float dx, float dy, float dz) {
  return BilinearLeaf{rows, ox, oy, oz, dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx};
}

}  // namespace bilinear_pair
