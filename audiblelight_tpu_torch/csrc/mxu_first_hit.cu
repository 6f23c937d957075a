// Bilinear first hit (t, face) of the tracer's bounce wavefront against an
// acoustic LOD, with each ray's launch face masked out.
//
// Replaces audiblelight_tpu/ops/mxu_first_hit.py:mxu_first_hit
// (_mxu_first_hit_kernel) and its glue. The reference writes Moller-Trumbore's
// triple products as four bilinear forms of one ray vector r = [o' x d, d,
// o', 1] (o' the origin less the mesh centre) against per-face columns, and
// runs them as (R, 16) x (16, F) matrix products:
//
//     u_num = r . [e2, w2]      v_num = r . [-e1, -w1]
//     det   = r . [-n]          t_num = r . [n, -k]
//
// then tests the window u, v >= -0.02, u + v <= 1.02 (a 2 % slop), t > 1e-4,
// |det| > 1e-6 and face != the ray's previous face, keeps the smallest t
// (the smallest face index on a tie), and re-evaluates the winner's plane
// exactly in f32 (the reference's :271-284).
//
// Bound on this card: bytes. The dense form tests every face; a ray's
// segment [0, t_hit] reaches the windows of only ~2.5 of the LOD's 4,071
// faces (0.061 % of the dense pairs), so reading the rays and the table once
// is the floor. Design: one thread per ray, one launch, no host read. The
// thread centres its origin, forms its ray vector in registers, walks the
// LOD's face tree (first_hit_walk.cuh, the walk of the big first hit,
// first_hit.cu) and re-evaluates its winner's plane from the winner's row.
// The tree (ops/cuda_kernels.py:build_face_bvh, built once per mesh) holds
// each face's 19 non-zero entries [e2, w2, -e1, -w1, -n, n, -k] padded to
// five float4s, in the centred frame, under boxes of the slop-widened
// triangles (the region the window accepts: A + s e1 + t e2 at (-0.02,
// -0.02), (1.04, -0.02), (-0.02, 1.04)) padded as the other trees are. The
// walk folds the lexicographic (t, face) minimum, which is the dense scan's
// "ascending faces, strict <" answer in any visit order.
//
// Precision: all four forms run in fp32 on the CUDA cores, their terms
// summed left to right with the zero columns of the reference's operands
// left out (an exact +0 changes no sum), the centring, the ray vector and
// the plane re-evaluation as the plain PyTorch glue writes them
// (ops/mxu_first_hit.py: `utils.cross3`, `utils.dot3` summed left to
// right), built with --fmad=false, so the kernel equals the dense plain
// version (ops/cuda_kernels.py:first_hit_mxu_plain and its glue) and the
// plain walk (mxu_walk_plain) bit for bit. The TPU ran det and t_num at its
// DEFAULT (bf16-input) precision; fp32 is what the reference computes in
// interpret mode on a CPU, and the reference records what bf16 did to the
// acoustics (audiblelight_tpu/ops/mxu_first_hit.py:43-55). Tensor cores are
// not used: the data needs 0.061 % of the dense pairs, so any dense product
// does ~1,600x the needed work, and a single-pass TF32 or bf16 product would
// repeat that selection noise.

#include <cuda_runtime.h>
#include <math.h>

#include "first_hit_walk.cuh"

namespace {

constexpr int kRowVecs = 5;  // float4s per tree row: MXU_PACKED_COLS (19) entries and a zero
constexpr float kEpsUv = 0.02f;
constexpr float kOnePlusEpsUv = (float)(1.0 + 0.02);
constexpr float kTEps = 1e-4f;
constexpr float kDetEps = 1e-6f;
constexpr float kDenomEps = 1e-9f;

// The window test of one leaf row against the ray vector `rv` = [o' x d, d,
// o'], the ray's launch face `skip` masked
struct WindowLeaf {
  const float4* __restrict__ rows;
  float rv[9];
  int skip;

  __device__ __forceinline__ bool operator()(int row, int f, float* t_out) const {
    float c[4 * kRowVecs];
#pragma unroll
    for (int k = 0; k < kRowVecs; ++k) {
      const float4 v = __ldg(rows + kRowVecs * row + k);
      c[4 * k] = v.x;
      c[4 * k + 1] = v.y;
      c[4 * k + 2] = v.z;
      c[4 * k + 3] = v.w;
    }
    float u_num = rv[0] * c[0];
    u_num = u_num + rv[1] * c[1];
    u_num = u_num + rv[2] * c[2];
    u_num = u_num + rv[3] * c[3];
    u_num = u_num + rv[4] * c[4];
    u_num = u_num + rv[5] * c[5];
    float v_num = rv[0] * c[6];
    v_num = v_num + rv[1] * c[7];
    v_num = v_num + rv[2] * c[8];
    v_num = v_num + rv[3] * c[9];
    v_num = v_num + rv[4] * c[10];
    v_num = v_num + rv[5] * c[11];
    float det = rv[3] * c[12];
    det = det + rv[4] * c[13];
    det = det + rv[5] * c[14];
    float t_num = rv[6] * c[15];
    t_num = t_num + rv[7] * c[16];
    t_num = t_num + rv[8] * c[17];
    t_num = t_num + c[18];
    const bool valid = fabsf(det) > kDetEps;
    const float inv = 1.0f / (valid ? det : 1.0f);
    const float u = u_num * inv;
    const float v = v_num * inv;
    const float t = t_num * inv;
    *t_out = t;
    return valid && (u >= -kEpsUv) && (u <= kOnePlusEpsUv) && (v >= -kEpsUv) && (u + v <= kOnePlusEpsUv) &&
           (t > kTEps) && (f != skip);
  }
};

__global__ void first_hit_mxu_kernel(const float* __restrict__ o,       // (R, 3) origins
                                     const float* __restrict__ d,       // (R, 3) directions
                                     const int* __restrict__ prev,      // (R,) face to exclude, -1 for none; or null
                                     const float* __restrict__ center,  // (3,) the tables' centre
                                     const float4* __restrict__ rows,   // (L * leaf_faces * 5,) leaf rows
                                     const int* __restrict__ face,      // (L * leaf_faces,) face, -1 pads
                                     const float4* __restrict__ boxes,  // (2L, 2): node i at 2i, centred
                                     int n_rays, int n_leaves, int leaf_faces, float* __restrict__ t_out,
                                     int* __restrict__ idx_out, int* __restrict__ visits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = o[3 * r] - __ldg(center), oy = o[3 * r + 1] - __ldg(center + 1),
              oz = o[3 * r + 2] - __ldg(center + 2);
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  first_hit_walk::Best b;
  float t = first_hit_walk::kBig;
  if (isfinite(ox) && isfinite(oy) && isfinite(oz) && isfinite(dx) && isfinite(dy) && isfinite(dz)) {
    const WindowLeaf leaf{rows,
                          {oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx, dx, dy, dz, ox, oy, oz},
                          prev == nullptr ? -1 : prev[r]};
    b = first_hit_walk::walk(leaf, boxes, face, n_leaves, leaf_faces, ox, oy, oz, dx, dy, dz);
    t = b.t;
    if (b.t < first_hit_walk::kBig) {
      // The exact f32 plane of the winner: n = columns 15-17, k = -column 18
      const float4 r3 = __ldg(rows + kRowVecs * b.row + 3), r4 = __ldg(rows + kRowVecs * b.row + 4);
      const float nx = r3.w, ny = r4.x, nz = r4.y, k = -r4.z;
      const float denom = (dx * nx + dy * ny) + dz * nz;
      const float numer = k - ((ox * nx + oy * ny) + oz * nz);
      const float t_exact = fabsf(denom) > kDenomEps ? numer / denom : b.t;
      t = t_exact > 0.0f ? t_exact : b.t;
    }
  }
  first_hit_walk::store(r, b, t, t_out, idx_out, visits);
}

}  // namespace

extern "C" int first_hit_mxu(const float* o, const float* d, const int* prev, const float* center,
                             const float* rows, const int* face, const float* boxes, int n_rays, int n_leaves,
                             int leaf_faces, float* t_out, int* idx_out, int* visits, cudaStream_t stream) {
  return first_hit_walk::launch(first_hit_mxu_kernel, n_rays, n_leaves, leaf_faces, stream, o, d, prev, center,
                                reinterpret_cast<const float4*>(rows), face, reinterpret_cast<const float4*>(boxes),
                                n_rays, n_leaves, leaf_faces, t_out, idx_out, visits);
}
