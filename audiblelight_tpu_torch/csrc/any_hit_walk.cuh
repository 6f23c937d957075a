// The any-hit walk of one segment through a face tree, shared by K2
// (any_hit.cu, segments_occluded) and K6 (star_any_hit.cu, the segments
// toward one end point).
//
// The tree (ops/cuda_kernels.py:any_hit_tree, built once per mesh) holds the
// dense any-hit table's own rows [a, e1, e2] in world coordinates, padded to
// three float4s, gathered into leaves of BVH_LEAF_FACES Morton-sorted faces
// under a heap-ordered binary tree of boxes padded 1 mm + 1e-6 |x| (the
// first hit's tree, csrc/first_hit.cu, built by the same routine). The rows
// every segment tests first (flat or non-finite faces, whose rounding can
// put a "hit" outside any box) come beside it; the faces left out of both
// (a zero edge) can never pass the dense test.
//
// Per segment: a window 1e-4 < t < length - 1e-4 that is empty (zero
// length, NaN) means free without a test, as in the dense walk. Otherwise
// the always-tested rows, then, for a finite segment, the walk: a box is
// entered where the segment [0, length] meets it (slab entry <= exit and <=
// length), the nearer child first and the farther pushed; the walk stops at
// the first row whose Moller-Trumbore test passes inside the window. The
// test is the dense kernel's arithmetic term for term (the files that
// include this are built with --fmad=false, as the plain PyTorch version
// never contracts), so a tested pair gives the dense answer bit for bit, and
// the segment is blocked exactly when the dense walk says so, given that no
// leaf holding a blocking face is skipped: a blocking face's hit lies on the
// face up to rounding, inside its padded box, so the segment enters that
// leaf's box and every ancestor's (tests/test_torch_any_hit_accel.py
// certifies it). Unlike the first hit, nothing orders the leaves or makes a
// stacked entry stale: any blocking row ends the walk.
//
// The loop is a while-while: a lane that reaches a leaf waits until every
// lane of its warp has reached one (or finished), so the warp tests its
// lanes' leaves together. With `visits` non-null the kernels write each
// segment's slab tests and leaves tested, which equal the plain walk's
// (ops/cuda_kernels.py:any_hit_walk_plain).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "face_tree.cuh"

namespace any_hit_walk {

constexpr float kEps = 1e-9f;
constexpr float kOnePlusEps = (float)(1.0 + 1e-9);  // rounds to 1.0f, as in f32 JAX
constexpr float kMargin = 1e-4f;
constexpr int kRowVecs = 3;  // float4s per row: [a, e1, e2, 0, 0, 0]

// The dense any-hit test of one row (three float4s) against the segment:
// Moller-Trumbore inside 1e-4 < t < t_max.
__device__ __forceinline__ bool blocks(const float4* __restrict__ row, float ox, float oy, float oz, float dx,
                                       float dy, float dz, float t_max) {
  const float4 r0 = __ldg(row), r1 = __ldg(row + 1), r2 = __ldg(row + 2);
  const float ax = r0.x, ay = r0.y, az = r0.z;
  const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
  const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
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
  return valid_a && (u >= -kEps) && (u <= kOnePlusEps) && (v >= -kEps) && (u + v <= kOnePlusEps) &&
         (t > kMargin) && (t < t_max);
}

// The body of both kernels, one thread per segment: out[r] = 1 where a row
// blocks the open segment, else 0.
__device__ __forceinline__ void segment(const float* __restrict__ o,        // (R, 3) segment starts
                                        const float* __restrict__ d,        // (R, 3) unit directions
                                        const float* __restrict__ len,      // (R,) lengths
                                        const float4* __restrict__ rows,    // (L * leaf_faces * 3,) leaf rows
                                        const float4* __restrict__ boxes,   // (2L, 2): node i at 2i
                                        int n_leaves, int leaf_faces,
                                        const float4* __restrict__ always,  // (n_always * 3,)
                                        int n_always, int n_seg, unsigned char* __restrict__ out,
                                        int* __restrict__ visits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_seg) return;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float length = len[r];
  const float t_max = length - kMargin;
  bool hit = false;
  int n_nodes = 0, n_leaf = 0;
  if (t_max > kMargin) {
    for (int i = 0; i < n_always && !hit; ++i) hit = blocks(always + kRowVecs * i, ox, oy, oz, dx, dy, dz, t_max);
    if (!hit && isfinite(ox) && isfinite(oy) && isfinite(oz) && isfinite(dx) && isfinite(dy) && isfinite(dz)) {
      const float ix = face_tree::slab_inverse(dx), iy = face_tree::slab_inverse(dy),
                  iz = face_tree::slab_inverse(dz);
      int stack[face_tree::kStack];
      int sp = 0;
      float e0, x0, e1, x1;
      face_tree::slab(boxes + 2, ox, oy, oz, ix, iy, iz, e0, x0);
      n_nodes = 1;
      int node = (e0 <= x0 && e0 <= length) ? 1 : 0;
      while (node != 0) {
        while (node != 0 && node < n_leaves) {
          const int c0 = 2 * node;
          face_tree::slab(boxes + 2 * c0, ox, oy, oz, ix, iy, iz, e0, x0);
          face_tree::slab(boxes + 2 * c0 + 2, ox, oy, oz, ix, iy, iz, e1, x1);
          n_nodes += 2;
          const bool v0 = e0 <= x0 && e0 <= length;
          const bool v1 = e1 <= x1 && e1 <= length;
          if (v0 && v1) {
            const bool second = e1 < e0;  // the nearer child first; child 2i on a tie
            stack[sp++] = second ? c0 : c0 + 1;
            node = second ? c0 + 1 : c0;
          } else if (v0 || v1) {
            node = v0 ? c0 : c0 + 1;
          } else {
            node = sp > 0 ? stack[--sp] : 0;
          }
        }
        if (node == 0) break;
        const float4* leaf = rows + (size_t)kRowVecs * (node - n_leaves) * leaf_faces;
        ++n_leaf;
        for (int q = 0; q < leaf_faces && !hit; ++q)
          hit = blocks(leaf + kRowVecs * q, ox, oy, oz, dx, dy, dz, t_max);
        if (hit) break;
        node = sp > 0 ? stack[--sp] : 0;
      }
    }
  }
  out[r] = hit ? 1 : 0;
  if (visits != nullptr) {
    visits[2 * r] = n_nodes;
    visits[2 * r + 1] = n_leaf;
  }
}

constexpr int kThreads = 128;

using Kernel = void (*)(const float*, const float*, const float*, const float4*, const float4*, int, int,
                        const float4*, int, int, unsigned char*, int*);

// The launch both kernels' C entry points make: one thread per segment, one
// launch, no memset (every output byte is written once).
template <Kernel kernel>
int launch(const float* o, const float* d, const float* len, const float* rows, const float* boxes, int n_leaves,
           int leaf_faces, const float* always, int n_always, int n_seg, unsigned char* out, int* visits,
           cudaStream_t stream) {
  if (n_seg <= 0) return (int)cudaSuccess;
  if (n_leaves <= 0 || (n_leaves & (n_leaves - 1)) != 0 || 31 - __builtin_clz(n_leaves) > face_tree::kStack ||
      leaf_faces <= 0 || n_always < 0)
    return (int)cudaErrorInvalidValue;
  const int n_blocks = (n_seg + kThreads - 1) / kThreads;
  kernel<<<n_blocks, kThreads, 0, stream>>>(o, d, len, reinterpret_cast<const float4*>(rows),
                                            reinterpret_cast<const float4*>(boxes), n_leaves, leaf_faces,
                                            reinterpret_cast<const float4*>(always), n_always, n_seg, out, visits);
  return (int)cudaGetLastError();
}

}  // namespace any_hit_walk
