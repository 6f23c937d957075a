// First hit (t, face) of each ray against a triangle soup.
//
// Replaces audiblelight_tpu/ops/pallas_kernels.py:ray_first_hit_pallas, both
// of its bodies: _first_hit_big_kernel (F > 512, centred coordinates and the
// precomputed 16-column face table [e2, w2, -e1, -w1, -n, -k]) and
// _first_hit_small_kernel (F <= 512, classic Moller-Trumbore). The pair
// arithmetic of each lives in a header: bilinear_pair.cuh (shared with the
// sorted and the pair first hits) and mt_pair.cuh (shared with the tiled
// first hit). The two formulations round differently in f32, so each is kept
// as written. The file is built with --fmad=false: the Pallas arithmetic has
// no fused multiply-adds, and a contracted product would move t by an ULP and
// flip near-ties.
//
// The big variant walks a face tree (ops/cuda_kernels.py:build_face_bvh,
// built once per mesh): the table's rows gathered into leaves of
// BVH_LEAF_FACES (4) Morton-sorted faces, a complete binary tree of padded
// boxes over the leaves, in heap order. Bound on this card: bytes. A ray's segment [0, t_hit]
// enters the boxes of only 2-5 faces, so the work the data needs is tiny
// next to the dense R x F pairs the Pallas body tests (0.005-0.05 % of them);
// reading the rays and the table once is the floor. Design: one thread per
// ray, one launch, no ray sort and no host read. The thread keeps a stack of
// (node, entry) in local memory, tests both children's boxes, goes to the
// nearer and pushes the farther; a box is skipped only when its slab entry
// exceeds the ray's best t so far (strict, since an equal t with a smaller
// face index may lie inside), and a popped node is skipped the same way.
// The loop is a while-while: a lane that reaches a leaf waits for the warp's
// other lanes to reach theirs, so the warp folds leaves together (lanes
// diverge most there). A leaf folds its rows (read as four float4s each,
// through L1/L2: the full mesh's 7 MB table and 2 MB of boxes stay in the
// 50 MB L2) into the
// lexicographic minimum (t, original face), which is the dense walk's answer
// whatever order the leaves come in. Each row is the dense table's row, bit
// for bit, and goes through the same pair routine, so the result equals the
// dense walk's, given that no leaf holding the dense walk's hit is skipped:
// - the boxes are padded by 1 mm plus 1e-6 of the coordinate's magnitude: a
//   hit the pair arithmetic finds on a grazing ray (a = d.(-n) tiny) can lie
//   off its face by ~1e-6 m / sin(angle) along the ray, and the pad holds it
//   down to ~1e-3 rad (tests/test_torch_first_hit_accel.py certifies every
//   ancestor's entry against the dense t on interior, surface, grazing,
//   axis-aligned, vertex and edge rays). A ray that runs within microns of
//   a face's plane at under ~1e-6 rad is the one case no pad covers: there
//   t_num and a are both rounding noise and the dense walk's "hit" can lie
//   metres off the face, where the tree may not look;
// - a direction component under 1e-20 in size counts as +-1e-20, so the
//   slab products are never 0 * inf (NaN) and a ray lying in a slab's plane
//   is inside it; the near and far planes are chosen by the sign of 1/d, so
//   an empty box (+inf, -inf) enters at +inf and is never visited;
// - a ray with a non-finite component misses every face in the dense walk
//   (its Plucker moment or its u is inf or NaN), so it is written as a miss
//   without a walk;
// - rays that start on a surface (every bounce after the first, 1e-4 m off
//   it) or dead rays need nothing special: the boxes that hold the origin
//   enter at 0 and are walked.
// The plain version of the walk (ops/cuda_kernels.py:_first_hit_walk_plain)
// takes the same steps in the same order; with `visits` non-null the kernel
// writes each ray's box tests and leaf folds, which equal the plain walk's.

#include <cuda_runtime.h>
#include <math.h>

#include "bilinear_pair.cuh"
#include "face_tree.cuh"
#include "mt_pair.cuh"

namespace {

constexpr float kBig = 3.0e38f;

constexpr int kIdxBig = 1 << 30;

using face_tree::kStack;
using face_tree::slab;
using face_tree::slab_inverse;

// The next stacked node whose entry does not pass `best_t`, or 0 (done);
// stale entries are dropped.
__device__ __forceinline__ int pop(const int* stack_node, const float* stack_t, int& sp, float best_t) {
  while (sp > 0) {
    --sp;
    if (stack_t[sp] <= best_t) return stack_node[sp];
  }
  return 0;
}

__global__ void first_hit_big_kernel(const float* __restrict__ o,      // (R, 3), centred
                                     const float* __restrict__ d,      // (R, 3)
                                     const float4* __restrict__ rows,  // (L * 16, 4) leaf-order table rows
                                     const int* __restrict__ face,     // (L * 16,) original face, -1 pads
                                     const float4* __restrict__ boxes, // (2L, 2): node i at 2i
                                     int n_rays, int n_leaves, int leaf_faces, float* __restrict__ t_out,
                                     int* __restrict__ idx_out, int* __restrict__ visits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  float best_t = kBig;
  int best_f = kIdxBig;
  int n_nodes = 0, n_leaf = 0;
  if (isfinite(ox) && isfinite(oy) && isfinite(oz) && isfinite(dx) && isfinite(dy) && isfinite(dz)) {
    // Shared per-ray Plucker moment od = o x d
    const float odx = oy * dz - oz * dy;
    const float ody = oz * dx - ox * dz;
    const float odz = ox * dy - oy * dx;
    const float ix = slab_inverse(dx), iy = slab_inverse(dy), iz = slab_inverse(dz);
    int stack_node[kStack];
    float stack_t[kStack];
    int sp = 0;
    float e0, x0, e1, x1;
    slab(boxes + 2, ox, oy, oz, ix, iy, iz, e0, x0);
    n_nodes = 1;
    int node = e0 <= x0 ? 1 : 0;
    // While-while: a lane that reaches a leaf waits until every lane of the
    // warp has reached one (or finished), so the warp folds its lanes'
    // leaves together; each lane's own steps are the plain walk's
    while (node != 0) {
      while (node != 0 && node < n_leaves) {
        const int c0 = 2 * node;
        slab(boxes + 2 * c0, ox, oy, oz, ix, iy, iz, e0, x0);
        slab(boxes + 2 * c0 + 2, ox, oy, oz, ix, iy, iz, e1, x1);
        n_nodes += 2;
        const bool v0 = e0 <= x0 && e0 <= best_t;
        const bool v1 = e1 <= x1 && e1 <= best_t;
        if (v0 && v1) {
          const bool second = e1 < e0;  // the nearer child first; child 2i on a tie
          stack_node[sp] = second ? c0 : c0 + 1;
          stack_t[sp] = second ? e0 : e1;
          ++sp;
          node = second ? c0 + 1 : c0;
        } else if (v0 || v1) {
          node = v0 ? c0 : c0 + 1;
        } else {
          node = pop(stack_node, stack_t, sp, best_t);
        }
      }
      if (node == 0) break;
      const int base = (node - n_leaves) * leaf_faces;
      for (int q = 0; q < leaf_faces; ++q) {
        const int f = __ldg(face + base + q);
        if (f < 0) continue;
        float c[16];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 v = __ldg(rows + 4 * (base + q) + k);
          c[4 * k] = v.x;
          c[4 * k + 1] = v.y;
          c[4 * k + 2] = v.z;
          c[4 * k + 3] = v.w;
        }
        float t;
        const bool hit = bilinear_pair::first_hit(c, ox, oy, oz, dx, dy, dz, odx, ody, odz, &t);
        if (hit && t < kBig && (t < best_t || (t == best_t && f < best_f))) {
          best_t = t;
          best_f = f;
        }
      }
      ++n_leaf;
      node = pop(stack_node, stack_t, sp, best_t);
    }
  }
  const bool miss = best_t >= kBig;
  t_out[r] = miss ? INFINITY : best_t;
  idx_out[r] = miss ? -1 : best_f;
  if (visits != nullptr) {
    visits[2 * r] = n_nodes;
    visits[2 * r + 1] = n_leaf;
  }
}

__global__ void first_hit_small_kernel(const float* __restrict__ o,    // (R, 3)
                                       const float* __restrict__ d,    // (R, 3)
                                       const float* __restrict__ tab,  // (F, 9): a, e1, e2
                                       int n_rays, int n_faces,
                                       float* __restrict__ t_out, int* __restrict__ idx_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];

  float best_t = kBig;
  int best_f = -1;
  for (int f = 0; f < n_faces; ++f) {
    const float* c = tab + 9 * f;
    float t;
    const bool hit = mt_pair::first_hit(__ldg(c + 0), __ldg(c + 1), __ldg(c + 2), __ldg(c + 3), __ldg(c + 4),
                                        __ldg(c + 5), __ldg(c + 6), __ldg(c + 7), __ldg(c + 8), ox, oy, oz, dx,
                                        dy, dz, &t);
    const float t_hit = hit ? t : kBig;
    if (t_hit < best_t) {
      best_t = t_hit;
      best_f = f;
    }
  }
  const bool miss = best_t >= kBig;
  t_out[r] = miss ? INFINITY : best_t;
  idx_out[r] = miss ? -1 : best_f;
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int first_hit_big(const float* o, const float* d, const float* rows, const int* face,
                             const float* boxes, int n_rays, int n_leaves, int leaf_faces, float* t_out,
                             int* idx_out, int* visits, cudaStream_t stream) {
  if (n_rays <= 0) return (int)cudaSuccess;
  if (n_leaves <= 0 || (n_leaves & (n_leaves - 1)) != 0 || 31 - __builtin_clz(n_leaves) > kStack || leaf_faces <= 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  first_hit_big_kernel<<<blocks, kThreads, 0, stream>>>(o, d, reinterpret_cast<const float4*>(rows), face,
                                                        reinterpret_cast<const float4*>(boxes), n_rays, n_leaves,
                                                        leaf_faces, t_out, idx_out, visits);
  return (int)cudaGetLastError();
}

extern "C" int first_hit_small(const float* o, const float* d, const float* tab, int n_rays,
                               int n_faces, float* t_out, int* idx_out, cudaStream_t stream) {
  if (n_rays <= 0) return (int)cudaSuccess;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  first_hit_small_kernel<<<blocks, kThreads, 0, stream>>>(o, d, tab, n_rays, n_faces, t_out, idx_out);
  return (int)cudaGetLastError();
}
