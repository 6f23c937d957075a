// Bilinear first hit (t, face) of the tracer's bounce wavefront against an
// acoustic LOD, with each ray's launch face masked out.
//
// Replaces audiblelight_tpu/ops/mxu_first_hit.py:mxu_first_hit
// (_mxu_first_hit_kernel). The reference writes Moller-Trumbore's triple
// products as four bilinear forms of one ray vector r = [o' x d, d, o', 1]
// (o' the origin less the mesh centre) against per-face columns, and runs
// them as (R, 16) x (16, F) matrix products:
//
//     u_num = r . [e2, w2]      v_num = r . [-e1, -w1]
//     det   = r . [-n]          t_num = r . [n, -k]
//
// then tests the window u, v >= -0.02, u + v <= 1.02 (a 2 % slop), t > 1e-4,
// |det| > 1e-6 and face != the ray's previous face, and keeps the smallest
// t, the smallest face index on ties. The glue (ops/mxu_first_hit.py)
// re-evaluates the winner's plane exactly.
//
// Precision: all four products run in fp32 on the CUDA cores, with the
// terms summed left to right and the zero columns of the reference's
// 16-wide operands left out (an exact +0 changes no sum), exactly as the
// plain PyTorch version (ops/cuda_kernels.py:first_hit_mxu_plain) sums them,
// so the two agree bit for bit. The TPU ran det and t_num at its DEFAULT
// (bf16-input) precision; fp32 is what the reference computes in interpret
// mode on a CPU, and the reference records what bf16 did to the acoustics
// (audiblelight_tpu/ops/mxu_first_hit.py:43-55). A tensor-core form (3xTF32
// on wgmma) is left to later work.
//
// Triton is not used: the work is a min-reduction over faces with an index
// tie rule and a self-mask, not a plain elementwise pass.
//
// Bound on this card: fp32 ALU, 38 flops per (ray, face) pair (four dots of
// 6, 6, 3 and 3 + 1 terms, one division, three products, one sum); the
// table (4,071 faces x 76 B = 309 KB) is read once per block. Design: one
// thread per ray keeps its 9-component ray vector in registers; the faces'
// 19 non-zero entries (u [e2, w2], v [-e1, -w1], a [-n], t [n, -k]) are
// staged through shared memory 256 faces at a time and read as a
// broadcast. Built with --fmad=false like the other kernels.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;  // faces staged per round
constexpr int kCols = 19;   // MXU_PACKED_COLS in ops/cuda_kernels.py
constexpr float kEpsUv = 0.02f;
constexpr float kOnePlusEpsUv = (float)(1.0 + 0.02);
constexpr float kTEps = 1e-4f;
constexpr float kDetEps = 1e-6f;
constexpr float kBig = 3.0e38f;
constexpr int kIdxBig = 1 << 30;

__global__ void __launch_bounds__(kThreads)
first_hit_mxu_kernel(const float* __restrict__ rvec,    // (R, 9): o' x d, d, o'
                     const int* __restrict__ prev,      // (R,) face to exclude, -1 for none
                     const float* __restrict__ packed,  // (F, 19)
                     int n_rays, int n_faces,
                     float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float faces[kTile * kCols];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool live = r < n_rays;
  float rv[9];
  for (int k = 0; k < 9; ++k) rv[k] = live ? rvec[9 * r + k] : 0.0f;
  const int skip = live ? prev[r] : -1;

  float best_t = kBig;
  int best_i = kIdxBig;
  for (int f0 = 0; f0 < n_faces; f0 += kTile) {
    const int n = min(kTile, n_faces - f0);
    __syncthreads();  // every thread is done with the previous faces
    const float* src = packed + (size_t)f0 * kCols;
    for (int k = threadIdx.x; k < n * kCols; k += kThreads) faces[k] = __ldg(src + k);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* c = faces + kCols * j;
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
      const int lane = f0 + j;
      const bool hit = valid && (u >= -kEpsUv) && (u <= kOnePlusEpsUv) && (v >= -kEpsUv) &&
                       (u + v <= kOnePlusEpsUv) && (t > kTEps) && (lane != skip);
      const float t_hit = hit ? t : kBig;
      if (t_hit < best_t) {  // ascending faces: the smallest index keeps a tie
        best_t = t_hit;
        best_i = lane;
      }
    }
  }
  if (!live) return;
  t_out[r] = best_t;
  idx_out[r] = best_t >= kBig ? -1 : best_i;
}

}  // namespace

extern "C" int first_hit_mxu(const float* rvec, const int* prev, const float* packed, int n_rays, int n_faces,
                             float* t_out, int* idx_out, cudaStream_t stream) {
  if (n_rays <= 0) return (int)cudaSuccess;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  first_hit_mxu_kernel<<<blocks, kThreads, 0, stream>>>(rvec, prev, packed, n_rays, n_faces, t_out, idx_out);
  return (int)cudaGetLastError();
}
