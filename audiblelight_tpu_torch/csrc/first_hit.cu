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
// built once per mesh) of the table's rows in centred coordinates, one
// thread per ray, one launch: the walk of first_hit_walk.cuh (shared with
// the tiled and the bilinear-window first hits) with the bilinear pair test
// at its leaves. Bound on this card: bytes (a ray's segment [0, t_hit]
// enters the boxes of only 2-5 faces; the rays and the table read once are
// the floor). Each row is the dense table's row, bit for bit, read as four
// float4s, so the result equals the dense walk's; the header says why no
// leaf holding the dense hit is skipped. The plain version of the walk
// (ops/cuda_kernels.py:first_hit_walk_plain) takes the same steps in the
// same order; with `visits` non-null the kernel writes each ray's box tests
// and leaf folds, which equal the plain walk's.

#include <cuda_runtime.h>
#include <math.h>

#include "bilinear_pair.cuh"
#include "first_hit_walk.cuh"
#include "mt_pair.cuh"

namespace {

constexpr float kBig = first_hit_walk::kBig;

// The bilinear pair test of one leaf row (16 floats: four float4s)
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
    return bilinear_pair::first_hit(c, ox, oy, oz, dx, dy, dz, odx, ody, odz, t);
  }
};

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
  first_hit_walk::Best b;
  if (isfinite(ox) && isfinite(oy) && isfinite(oz) && isfinite(dx) && isfinite(dy) && isfinite(dz)) {
    // Shared per-ray Plucker moment od = o x d
    const BilinearLeaf leaf{rows, ox, oy, oz, dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx};
    b = first_hit_walk::walk(leaf, boxes, face, n_leaves, leaf_faces, ox, oy, oz, dx, dy, dz);
  }
  first_hit_walk::store(r, b, b.t, t_out, idx_out, visits);
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

constexpr int kThreads = first_hit_walk::kThreads;

}  // namespace

extern "C" int first_hit_big(const float* o, const float* d, const float* rows, const int* face,
                             const float* boxes, int n_rays, int n_leaves, int leaf_faces, float* t_out,
                             int* idx_out, int* visits, cudaStream_t stream) {
  return first_hit_walk::launch(first_hit_big_kernel, n_rays, n_leaves, leaf_faces, stream, o, d,
                                reinterpret_cast<const float4*>(rows), face, reinterpret_cast<const float4*>(boxes),
                                n_rays, n_leaves, leaf_faces, t_out, idx_out, visits);
}

extern "C" int first_hit_small(const float* o, const float* d, const float* tab, int n_rays,
                               int n_faces, float* t_out, int* idx_out, cudaStream_t stream) {
  if (n_rays <= 0) return (int)cudaSuccess;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  first_hit_small_kernel<<<blocks, kThreads, 0, stream>>>(o, d, tab, n_rays, n_faces, t_out, idx_out);
  return (int)cudaGetLastError();
}
