// First hit (t, face) of each ray against a triangle soup.
//
// Replaces audiblelight_tpu/ops/pallas_kernels.py:ray_first_hit_pallas, both
// of its bodies: _first_hit_big_kernel (F > 512, centred coordinates and the
// precomputed 16-column face table [e2, w2, -e1, -w1, -n, -k]) and
// _first_hit_small_kernel (F <= 512, classic Moller-Trumbore). The pair
// arithmetic of each lives in a header with its leaf test: bilinear_pair.cuh
// (shared with the sorted and the pair first hits) and mt_pair.cuh (shared
// with the tiled first hit). The two formulations round differently in f32,
// so each is kept as written. The file is built with --fmad=false: the
// Pallas arithmetic has no fused multiply-adds, and a contracted product
// would move t by an ULP and flip near-ties.
//
// Both variants walk a face tree, one thread per ray, one launch: the walk of
// first_hit_walk.cuh (shared with the tiled, bilinear-window and sorted
// first hits). Bound on this card: bytes (a ray's segment [0, t_hit] enters
// the boxes of only a few faces; the rays and the table read once are the
// floor). Each row is the dense table's row, bit for bit, so the result
// equals the dense walk's; the header says why no leaf holding the dense hit
// is skipped. The plain versions of the walks
// (ops/cuda_kernels.py:first_hit_walk_plain) take the same steps in the same
// order; with `visits` non-null a kernel writes each ray's box tests and leaf
// folds, which equal the plain walk's.
//
// - Big: the tree (ops/cuda_kernels.py:big_face_bvh, built once per mesh)
//   holds the big table's rows in centred coordinates, read as four float4s
//   through L1/L2.
// - Small: the mesh's any-hit tree (ops/cuda_kernels.py:any_hit_tree, built
//   once per mesh and shared with the occlusion queries K2 and K6): the
//   classic rows [a, e1, e2] in world coordinates, faces with a zero edge
//   left out (the dense test never passes there), and the rows whose
//   rounding can put a hit outside any box (flat or non-finite faces) in an
//   always-tested list that every ray folds first, whatever its own
//   components. A mesh of <= 512 faces gives a tree of <= 128 leaves: its
//   boxes, rows and face ids and the always-tested rows fit in under 62 KiB,
//   so each block of 256 rays stages them all into shared memory once
//   (cp.async for the float4 rows) and walks from there: on the card no
//   slower than the same walk reading the tree through L1/L2 (K7's kernel
//   on this tree, with the same rows and leaf test; PERF.md).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bilinear_pair.cuh"
#include "first_hit_walk.cuh"
#include "mt_pair.cuh"

namespace {

constexpr float kBig = first_hit_walk::kBig;

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
  if (isfinite(ox) && isfinite(oy) && isfinite(oz) && isfinite(dx) && isfinite(dy) && isfinite(dz))
    b = first_hit_walk::walk(bilinear_pair::leaf_of(rows, ox, oy, oz, dx, dy, dz), boxes, face, n_leaves,
                             leaf_faces, ox, oy, oz, dx, dy, dz);
  first_hit_walk::store(r, b, b.t, t_out, idx_out, visits);
}

constexpr int kSmallThreads = 256;  // rays per block: one staging of the tree serves them all
constexpr int kRowVecs = 3;         // float4s per row: [a, e1, e2, 0, 0, 0]
constexpr int kMaxShared = 232448;  // dynamic shared memory a block may opt into on sm_90

// Copies n float4s into shared memory with cp.async, the block's threads
// taking one each in turn; the caller waits and syncs before reading them.
__device__ __forceinline__ void stage_async(float4* dst, const float4* __restrict__ src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) __pipeline_memcpy_async(dst + k, src + k, sizeof(float4));
}

__device__ __forceinline__ void stage_ints(int* dst, const int* __restrict__ src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = __ldg(src + k);
}

// The shared-memory bytes of a staged tree: boxes, rows and always-tested
// rows (float4s), then the rows' and the always-tested rows' faces (ints)
size_t small_shared_bytes(int n_leaves, int leaf_faces, int n_always) {
  const size_t vecs = 4 * (size_t)n_leaves + (size_t)kRowVecs * ((size_t)n_leaves * leaf_faces + n_always);
  return vecs * sizeof(float4) + ((size_t)n_leaves * leaf_faces + n_always) * sizeof(int);
}

__global__ void __launch_bounds__(kSmallThreads)
first_hit_small_kernel(const float* __restrict__ o,             // (R, 3)
                       const float* __restrict__ d,             // (R, 3)
                       const float4* __restrict__ rows,         // (L * leaf_faces * 3,) leaf rows
                       const int* __restrict__ face,            // (L * leaf_faces,) original face, -1 pads
                       const float4* __restrict__ boxes,        // (2L, 2): node i at 2i
                       const float4* __restrict__ always,       // (n_always * 3,) always-tested rows
                       const int* __restrict__ always_face,     // (n_always,) their original faces
                       int n_rays, int n_leaves, int leaf_faces, int n_always, float* __restrict__ t_out,
                       int* __restrict__ idx_out, int* __restrict__ visits) {
  // The whole tree, once per block, before any thread returns
  extern __shared__ float4 shared[];
  const int n_rows = n_leaves * leaf_faces;
  float4* s_boxes = shared;
  float4* s_rows = s_boxes + 4 * n_leaves;
  float4* s_always = s_rows + kRowVecs * n_rows;
  int* s_face = reinterpret_cast<int*>(s_always + kRowVecs * n_always);
  int* s_always_face = s_face + n_rows;
  stage_async(s_boxes, boxes, 4 * n_leaves);
  stage_async(s_rows, rows, kRowVecs * n_rows);
  stage_async(s_always, always, kRowVecs * n_always);
  __pipeline_commit();
  stage_ints(s_face, face, n_rows);
  stage_ints(s_always_face, always_face, n_always);
  __pipeline_wait_prior(0);
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  first_hit_walk::Best b;
  // The always-tested rows first, folded as the walk folds a leaf's
  const mt_pair::MtLeaf<false> always_leaf{s_always, ox, oy, oz, dx, dy, dz};
  for (int i = 0; i < n_always; ++i) {
    float t;
    const bool hit = always_leaf(i, 0, &t);
    const int f = s_always_face[i];
    if (hit && t < kBig && (t < b.t || (t == b.t && f < b.face))) {
      b.t = t;
      b.face = f;
    }
  }
  if (isfinite(ox) && isfinite(oy) && isfinite(oz) && isfinite(dx) && isfinite(dy) && isfinite(dz))
    b = first_hit_walk::walk<false>(mt_pair::MtLeaf<false>{s_rows, ox, oy, oz, dx, dy, dz}, s_boxes, s_face,
                                    n_leaves, leaf_faces, ox, oy, oz, dx, dy, dz, b);
  first_hit_walk::store(r, b, b.t, t_out, idx_out, visits);
}

}  // namespace

extern "C" int first_hit_big(const float* o, const float* d, const float* rows, const int* face,
                             const float* boxes, int n_rays, int n_leaves, int leaf_faces, float* t_out,
                             int* idx_out, int* visits, cudaStream_t stream) {
  return first_hit_walk::launch(first_hit_big_kernel, n_rays, n_leaves, leaf_faces, stream, o, d,
                                reinterpret_cast<const float4*>(rows), face, reinterpret_cast<const float4*>(boxes),
                                n_rays, n_leaves, leaf_faces, t_out, idx_out, visits);
}

extern "C" int first_hit_small(const float* o, const float* d, const float* rows, const int* face,
                               const float* boxes, const float* always, const int* always_face, int n_rays,
                               int n_leaves, int leaf_faces, int n_always, float* t_out, int* idx_out, int* visits,
                               cudaStream_t stream) {
  if (n_rays <= 0) return (int)cudaSuccess;
  if (n_leaves <= 0 || (n_leaves & (n_leaves - 1)) != 0 || 31 - __builtin_clz(n_leaves) > face_tree::kStack ||
      leaf_faces <= 0 || n_always < 0)
    return (int)cudaErrorInvalidValue;
  const size_t shared = small_shared_bytes(n_leaves, leaf_faces, n_always);
  if (shared > (size_t)kMaxShared) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;  // above 48 KiB only after the opt-in, made once per process
  if (shared > 48 * 1024 && !opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(first_hit_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int blocks = (n_rays + kSmallThreads - 1) / kSmallThreads;
  first_hit_small_kernel<<<blocks, kSmallThreads, shared, stream>>>(
      o, d, reinterpret_cast<const float4*>(rows), face, reinterpret_cast<const float4*>(boxes),
      reinterpret_cast<const float4*>(always), always_face, n_rays, n_leaves, leaf_faces, n_always, t_out, idx_out,
      visits);
  return (int)cudaGetLastError();
}
