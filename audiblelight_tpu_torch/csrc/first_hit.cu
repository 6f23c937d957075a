// First hit (t, face) of each ray against a triangle soup.
//
// Replaces audiblelight_tpu/ops/pallas_kernels.py:ray_first_hit_pallas, both
// of its bodies: _first_hit_big_kernel (F > 512, centred coordinates and the
// precomputed 16-column face table [e2, w2, -e1, -w1, -n, -k]) and
// _first_hit_small_kernel (F <= 512, classic Moller-Trumbore). The pair
// arithmetic of each lives in a header: bilinear_pair.cuh (shared with the
// sorted and the pair first hits) and mt_pair.cuh (shared with the tiled
// first hit).
// The two formulations round differently in f32, so each is kept as written.
//
// Bound on this card: fp32 ALU. Every (ray, face) pair costs ~30 flops and
// the face table is tiny next to the work (4,071 faces x 64 B = 260 KB), so
// bytes do not matter; the launch is R * F * ~30 flops over 67 TFLOP/s.
// Design: one thread per ray, one loop over all faces in ascending order.
// All threads of a warp read the same face, which the L1 broadcasts, so the
// table is read from global memory without staging. A strict `<` keeps the
// smallest face index on equal t, which is the Pallas tie rule without its
// 8-sublane and 16,384-face-tile folds. The file is built with
// --fmad=false: the Pallas arithmetic has no fused multiply-adds, and a
// contracted product would move t by an ULP and flip near-ties.

#include <cuda_runtime.h>
#include <math.h>

#include "bilinear_pair.cuh"
#include "mt_pair.cuh"

namespace {

constexpr float kBig = 3.0e38f;

__global__ void first_hit_big_kernel(const float* __restrict__ o,     // (R, 3), centred
                                     const float* __restrict__ d,     // (R, 3)
                                     const float* __restrict__ tab,   // (F, 16)
                                     int n_rays, int n_faces,
                                     float* __restrict__ t_out, int* __restrict__ idx_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  // Shared per-ray Plucker moment od = o x d
  const float odx = oy * dz - oz * dy;
  const float ody = oz * dx - ox * dz;
  const float odz = ox * dy - oy * dx;

  float best_t = kBig;
  int best_f = -1;
  for (int f = 0; f < n_faces; ++f) {
    float c[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) c[k] = __ldg(tab + 16 * f + k);
    float t;
    const bool hit = bilinear_pair::first_hit(c, ox, oy, oz, dx, dy, dz, odx, ody, odz, &t);
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

extern "C" int first_hit_big(const float* o, const float* d, const float* tab, int n_rays,
                             int n_faces, float* t_out, int* idx_out, cudaStream_t stream) {
  if (n_rays <= 0) return (int)cudaSuccess;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  first_hit_big_kernel<<<blocks, kThreads, 0, stream>>>(o, d, tab, n_rays, n_faces, t_out, idx_out);
  return (int)cudaGetLastError();
}

extern "C" int first_hit_small(const float* o, const float* d, const float* tab, int n_rays,
                               int n_faces, float* t_out, int* idx_out, cudaStream_t stream) {
  if (n_rays <= 0) return (int)cudaSuccess;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  first_hit_small_kernel<<<blocks, kThreads, 0, stream>>>(o, d, tab, n_rays, n_faces, t_out, idx_out);
  return (int)cudaGetLastError();
}
