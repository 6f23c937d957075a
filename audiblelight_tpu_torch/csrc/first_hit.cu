// First hit (t, face) of each ray against a triangle soup.
//
// Replaces audiblelight_tpu/ops/pallas_kernels.py:ray_first_hit_pallas, both
// of its bodies: _first_hit_big_kernel (F > 512, centred coordinates and the
// precomputed 16-column face table [e2, w2, -e1, -w1, -n, -k]) and
// _first_hit_small_kernel (F <= 512, classic Moller-Trumbore). The two
// formulations round differently in f32, so each is kept as written.
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

namespace {

constexpr float kEps = 1e-9f;
constexpr float kOnePlusEps = (float)(1.0 + 1e-9);  // rounds to 1.0f, as in f32 JAX
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
    const float* c = tab + 16 * f;
    const float e2x = __ldg(c + 0), e2y = __ldg(c + 1), e2z = __ldg(c + 2);
    const float w2x = __ldg(c + 3), w2y = __ldg(c + 4), w2z = __ldg(c + 5);
    const float me1x = __ldg(c + 6), me1y = __ldg(c + 7), me1z = __ldg(c + 8);
    const float mw1x = __ldg(c + 9), mw1y = __ldg(c + 10), mw1z = __ldg(c + 11);
    const float mnx = __ldg(c + 12), mny = __ldg(c + 13), mnz = __ldg(c + 14);
    const float mk = __ldg(c + 15);

    const float u_num = (odx * e2x + ody * e2y + odz * e2z) + (dx * w2x + dy * w2y + dz * w2z);
    const float v_num = (odx * me1x + ody * me1y + odz * me1z) + (dx * mw1x + dy * mw1y + dz * mw1z);
    const float a = dx * mnx + dy * mny + dz * mnz;
    const float t_num = mk - (ox * mnx + oy * mny + oz * mnz);
    // No guard on a == 0: u, v, t become inf or NaN and every test fails.
    const float inv = 1.0f / a;
    const float u = u_num * inv;
    const float v = v_num * inv;
    const float t = t_num * inv;
    const bool hit = (u >= -kEps) && (u <= kOnePlusEps) && (v >= -kEps) &&
                     (u + v <= kOnePlusEps) && (t > kEps);
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
    const float ax = __ldg(c + 0), ay = __ldg(c + 1), az = __ldg(c + 2);
    const float e1x = __ldg(c + 3), e1y = __ldg(c + 4), e1z = __ldg(c + 5);
    const float e2x = __ldg(c + 6), e2y = __ldg(c + 7), e2z = __ldg(c + 8);

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
    const bool hit = valid_a && (u >= -kEps) && (u <= kOnePlusEps) && (v >= -kEps) &&
                     (u + v <= kOnePlusEps) && (t > kEps);
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
