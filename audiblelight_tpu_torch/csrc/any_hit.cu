// Segment occlusion: does any face cross the open segment start -> end?
//
// Replaces audiblelight_tpu/ops/pallas_kernels.py:segments_occluded_pallas
// (_any_hit_kernel): Moller-Trumbore with the segment-interior window
// 1e-4 < t < length - 1e-4, OR-folded over all faces.
//
// Bound on this card: fp32 ALU, ~30 flops per (segment, face) pair tested.
// The diffraction graph legs (~600k segments x 4,071 faces) and the per-face
// rain table (4,071 x 4,071 pairs) are the big calls; the face table is small
// and L1-resident. Design: one thread per (segment, slice of faces), looping
// over its slice in order and leaving the loop at the first blocking face (a
// segment is either free, and tests every face, or blocked, and usually stops
// early). Many segments run one slice of all faces each; few segments against
// many faces (the direct-path and diffraction-trigger queries, 64 segments x
// 110,592 faces) split the faces into slices of at least kMinSliceFaces, so
// the card is filled either way. A thread that finds a blocking face stores 1
// into its segment's zeroed output byte: an OR that needs no atomics.
// Origins, unit directions and lengths are computed once by the caller in
// PyTorch, so only the per-pair arithmetic lives here. Built with
// --fmad=false to keep the Pallas body's rounding.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr float kEps = 1e-9f;
constexpr float kOnePlusEps = (float)(1.0 + 1e-9);
constexpr float kMargin = 1e-4f;

__global__ void any_hit_kernel(const float* __restrict__ o,     // (R, 3) segment starts
                               const float* __restrict__ d,     // (R, 3) unit directions
                               const float* __restrict__ len,   // (R,) segment lengths
                               const float* __restrict__ tab,   // (F, 9): a, e1, e2
                               int n_seg, int n_faces, int slice_faces,
                               unsigned char* __restrict__ out) {  // (R,) zeroed
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_seg) return;
  const int f_begin = blockIdx.y * slice_faces;
  const int f_end = min(n_faces, f_begin + slice_faces);
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float t_max = len[r] - kMargin;

  for (int f = f_begin; f < f_end; ++f) {
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
    if (valid_a && (u >= -kEps) && (u <= kOnePlusEps) && (v >= -kEps) &&
        (u + v <= kOnePlusEps) && (t > kMargin) && (t < t_max)) {
      out[r] = 1;
      return;
    }
  }
}

constexpr int kThreads = 128;
// Threads worth launching: enough to fill the card's 132 SMs several times
constexpr long long kTargetThreads = 1LL << 18;
constexpr int kMinSliceFaces = 64;

}  // namespace

extern "C" int any_hit(const float* o, const float* d, const float* len, const float* tab,
                       int n_seg, int n_faces, unsigned char* out, cudaStream_t stream) {
  if (n_seg <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_seg, stream);
  if (err != cudaSuccess) return (int)err;
  if (n_faces <= 0) return (int)cudaSuccess;
  // Slices per segment: enough threads, slices of >= kMinSliceFaces faces,
  // and within the grid's y limit
  const long long want = (kTargetThreads + n_seg - 1) / n_seg;
  const long long most = (n_faces + kMinSliceFaces - 1) / kMinSliceFaces;
  const int n_slices = (int)std::max(1LL, std::min({want, most, 65535LL}));
  const int slice_faces = (n_faces + n_slices - 1) / n_slices;
  const dim3 grid((n_seg + kThreads - 1) / kThreads, (n_faces + slice_faces - 1) / slice_faces);
  any_hit_kernel<<<grid, kThreads, 0, stream>>>(o, d, len, tab, n_seg, n_faces, slice_faces, out);
  return (int)cudaGetLastError();
}
