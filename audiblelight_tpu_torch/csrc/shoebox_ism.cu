// The shoebox image-source sum (Allen & Berkley, frequency domain): for every
// path p (a listener row and an emitter), channel c and rfft bin f,
//   out[c, p, f] = sum over images k of
//     amp[p, k] * gain(k, f) * exp(-2 pi i ((f d_mod) mod n + f d_frac) / n) * enc[p, k, c]
//   gain(k, f) = exp(((m0 lb0(f) + m1 lb1(f)) + ...) + m5 lb5(f)),
// with the per-(path, image) quantities (d_mod, d_frac, the in-range amp and
// the receiver gains enc) and the wall counts m of each image formed beforehand
// in PyTorch (rir/image_source.py:image_terms).
//
// Replaces no Pallas kernel: the JAX package leaves this sum to XLA's fusion
// (audiblelight_tpu/rir/image_source.py scans chunks of images). Eager
// PyTorch wrote every (path, image, bin) intermediate to device memory, ~20
// passes over 0.4 GB tensors a block of images; here each term lives in
// registers only and each accumulator is stored once.
//
// Bound on this card: fp32 operations, 30 a term by the benchmark's count
// (portbench/counts.py: the integer and float phase, a sincos, the gain and
// the weighted accumulation); the inputs are ~10-80 B a (path, image) against
// thousands of bins, so bytes do not bound it. Design: one thread a bin,
// holding a group of paths times all C channels of (real, imaginary)
// accumulators in registers across the images (the group sized by C: 16
// paths of 1 channel, 8 of 4, 3 of 9, 2 of 16, ~64 accumulators); a block is
// 256 consecutive bins of one path group and one split of the images. A tile
// of 64 images' records is staged in shared memory and read by every lane as a
// broadcast. gain(k, f) depends on neither the emitter nor the listener row:
// each thread forms it once per image and reuses it for all paths it holds.
// The integer phase is exact without a division: the block's base
// (f_block d_mod) mod n is formed once per record in 64 bits, and each lane
// reduces x = base + (f - f_block) d_mod < 2^32 by q = umulhi(x, floor((2^32 -
// 1) / n)), which is the quotient or one less, and one conditional subtract.
// Images out of range (amp == 0, the same for every lane) are skipped; they
// add zeros. Precise sincosf and expf (no intrinsics, no fast-math), and
// --fmad=false: each rounding of a term follows the eager path's order.
// The images are split so that the grid fills the card's resident blocks in
// whole waves; each split writes its partial sums, and a second launch adds
// the splits in order. No atomics: the same inputs give the same bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // bins of a block: 8 warps of 32 consecutive bins
constexpr int kTile = 64;      // images staged in shared memory at a time

// Paths a thread holds, by channel count: ~64 accumulator registers
template <int C>
struct Tiling;
template <>
struct Tiling<1> { static constexpr int paths = 16; };
template <>
struct Tiling<4> { static constexpr int paths = 8; };
template <>
struct Tiling<9> { static constexpr int paths = 3; };
template <>
struct Tiling<16> { static constexpr int paths = 2; };

// Words of one staged (path, image) record, in float4s: [base, d_mod, d_frac,
// amp] then the gains of channels 1..C-1 (channel 0's is 1: the pressure of an
// omni row and the W of every ambisonic layout)
template <int C>
struct Record { static constexpr int words = (4 + C - 1 + 3) / 4 * 4; };

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
shoebox_ism_kernel(const int* __restrict__ d_mod,     // (P, K)
                   const float* __restrict__ d_frac,  // (P, K)
                   const float* __restrict__ amp,     // (P, K)
                   const float* __restrict__ enc,     // (P, K, C); unread for C == 1
                   const float* __restrict__ walls,   // (K, 6)
                   const float* __restrict__ lb,      // (F, 6)
                   int n_paths, int n_images, int n_freq, unsigned n, unsigned magic, float phase_scale,
                   int split_images,
                   float2* __restrict__ part) {  // (splits, C, P, F)
  constexpr int PT = Tiling<C>::paths;
  constexpr int W = Record<C>::words;
  __shared__ __align__(16) float rec[kTile][PT][W];
  __shared__ __align__(16) float wall[kTile][8];

  const int f_block = blockIdx.x * kThreads;
  const int f = f_block + threadIdx.x;
  const int p_base = blockIdx.y * PT;
  const int np = min(PT, n_paths - p_base);
  const int k_begin = blockIdx.z * split_images;
  const int k_end = min(n_images, k_begin + split_images);
  float l[6];
  const int fc = min(f, n_freq - 1);
#pragma unroll
  for (int i = 0; i < 6; ++i) l[i] = __ldg(lb + (size_t)fc * 6 + i);
  const float ff = (float)f;
  const unsigned delta = threadIdx.x;

  float acc_re[PT][C], acc_im[PT][C];
#pragma unroll
  for (int p = 0; p < PT; ++p)
#pragma unroll
    for (int c = 0; c < C; ++c) acc_re[p][c] = acc_im[p][c] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += kTile) {
    const int nk = min(kTile, k_end - k0);
    __syncthreads();  // every lane is done with the previous tile
    for (int i = threadIdx.x; i < np * nk; i += kThreads) {
      const int pp = i / nk, kk = i - pp * nk;
      const size_t pk = (size_t)(p_base + pp) * n_images + (k0 + kk);
      const unsigned dm = (unsigned)__ldg(d_mod + pk);
      float* r = rec[kk][pp];
      r[0] = __uint_as_float((unsigned)((unsigned long long)f_block * dm % n));
      r[1] = __uint_as_float(dm);
      r[2] = __ldg(d_frac + pk);
      r[3] = __ldg(amp + pk);
      for (int c = 1; c < C; ++c) r[3 + c] = __ldg(enc + pk * C + c);
    }
    for (int i = threadIdx.x; i < nk * 6; i += kThreads) wall[i / 6][i % 6] = __ldg(walls + (size_t)k0 * 6 + i);
    __syncthreads();

    for (int kk = 0; kk < nk; ++kk) {
      const float4 wa = *reinterpret_cast<const float4*>(wall[kk]);
      const float2 wb = *reinterpret_cast<const float2*>(wall[kk] + 4);
      float g = wa.x * l[0];
      g = g + wa.y * l[1];
      g = g + wa.z * l[2];
      g = g + wa.w * l[3];
      g = g + wb.x * l[4];
      g = g + wb.y * l[5];
      g = expf(g);
#pragma unroll
      for (int pp = 0; pp < PT; ++pp) {
        if (pp >= np) continue;
        const float4 h = *reinterpret_cast<const float4*>(rec[kk][pp]);
        if (h.w == 0.0f) continue;  // out of range: the term is zero
        float e[W - 4 > 0 ? W - 4 : 1];
#pragma unroll
        for (int q = 1; q < W / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(rec[kk][pp] + 4 * q);
          e[4 * q - 4] = v.x;
          e[4 * q - 3] = v.y;
          e[4 * q - 2] = v.z;
          e[4 * q - 1] = v.w;
        }
        // (f d_mod) mod n, exact: x < 2^32, q the quotient or one less
        const unsigned dm = __float_as_uint(h.y);
        const unsigned x = __float_as_uint(h.x) + delta * dm;
        unsigned r = x - __umulhi(x, magic) * n;
        r = min(r, r - n);
        const float ph = ((float)r + ff * h.z) * phase_scale;
        float sn, cs;
        sincosf(ph, &sn, &cs);
        const float w = h.w * g;
        const float re = cs * w, im = sn * w;
        acc_re[pp][0] += re;
        acc_im[pp][0] += im;
#pragma unroll
        for (int c = 1; c < C; ++c) {
          acc_re[pp][c] += re * e[c - 1];
          acc_im[pp][c] += im * e[c - 1];
        }
      }
    }
  }
  if (f >= n_freq) return;
#pragma unroll
  for (int pp = 0; pp < PT; ++pp) {
    if (pp >= np) continue;
#pragma unroll
    for (int c = 0; c < C; ++c)
      part[(((size_t)blockIdx.z * C + c) * n_paths + p_base + pp) * n_freq + f] =
          make_float2(acc_re[pp][c], acc_im[pp][c]);
  }
}

// out[i] = the sum of the splits' part[s, i], s = 0, 1, ... in order
__global__ void shoebox_ism_reduce(const float2* __restrict__ part, int n_splits, size_t total,
                                   float2* __restrict__ out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += (size_t)gridDim.x * blockDim.x) {
    float2 s = part[i];
    for (int z = 1; z < n_splits; ++z) {
      const float2 v = part[(size_t)z * total + i];
      s.x += v.x;
      s.y += v.y;
    }
    out[i] = s;
  }
}

template <int C>
int launch(const int* d_mod, const float* d_frac, const float* amp, const float* enc, const float* walls,
           const float* lb, int n_paths, int n_images, int n_freq, int n_samples, unsigned magic, float phase_scale,
           int n_splits, float* part, float* out, cudaStream_t stream) {
  constexpr int PT = Tiling<C>::paths;
  const dim3 grid((n_freq + kThreads - 1) / kThreads, (n_paths + PT - 1) / PT, n_splits);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const int split_images = (n_images + n_splits - 1) / n_splits;
  shoebox_ism_kernel<C><<<grid, kThreads, 0, stream>>>(d_mod, d_frac, amp, enc, walls, lb, n_paths, n_images, n_freq,
                                                       (unsigned)n_samples, magic, phase_scale, split_images,
                                                       reinterpret_cast<float2*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)C * n_paths * n_freq;
  const int blocks = (int)((total + 255) / 256 < 65535 ? (total + 255) / 256 : 65535);
  shoebox_ism_reduce<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float2*>(part), n_splits, total,
                                                 reinterpret_cast<float2*>(out));
  return (int)cudaGetLastError();
}

template <int C>
int shape(int* paths_per_block, int* blocks_per_sm) {
  *paths_per_block = Tiling<C>::paths;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, shoebox_ism_kernel<C>, kThreads, 0);
}

}  // namespace

// The paths a block holds and the blocks an SM keeps resident, for C channels
extern "C" int shoebox_ism_shape(int channels, int* paths_per_block, int* blocks_per_sm) {
  switch (channels) {
    case 1: return shape<1>(paths_per_block, blocks_per_sm);
    case 4: return shape<4>(paths_per_block, blocks_per_sm);
    case 9: return shape<9>(paths_per_block, blocks_per_sm);
    case 16: return shape<16>(paths_per_block, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

// part: (n_splits, C, P, F) float2 scratch; out: (C, P, F) float2. Needs
// 2 <= n_samples < 2^24 (the phase's integers exact in float32) and magic =
// floor((2^32 - 1) / n_samples).
extern "C" int shoebox_ism(const int* d_mod, const float* d_frac, const float* amp, const float* enc,
                           const float* walls, const float* lb, int channels, int n_paths, int n_images,
                           int n_samples, unsigned magic, float phase_scale, int n_splits, float* part, float* out,
                           cudaStream_t stream) {
  const int n_freq = n_samples / 2 + 1;
  if (n_paths <= 0) return (int)cudaSuccess;
  if (n_images <= 0 || n_splits <= 0 || n_samples < 2 || n_samples >= (1 << 24)) return (int)cudaErrorInvalidValue;
  switch (channels) {
    case 1: return launch<1>(d_mod, d_frac, amp, enc, walls, lb, n_paths, n_images, n_freq, n_samples, magic,
                             phase_scale, n_splits, part, out, stream);
    case 4: return launch<4>(d_mod, d_frac, amp, enc, walls, lb, n_paths, n_images, n_freq, n_samples, magic,
                             phase_scale, n_splits, part, out, stream);
    case 9: return launch<9>(d_mod, d_frac, amp, enc, walls, lb, n_paths, n_images, n_freq, n_samples, magic,
                             phase_scale, n_splits, part, out, stream);
    case 16: return launch<16>(d_mod, d_frac, amp, enc, walls, lb, n_paths, n_images, n_freq, n_samples, magic,
                               phase_scale, n_splits, part, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
