// The pair-walk first hit (t, sorted face) of a ray wavefront against the
// Morton tiles of a mesh: each ray through its nearest tiles in rounds,
// every round of every ray in one launch.
//
// Replaces audiblelight_tpu/ops/pair_first_hit.py:pair_first_hit
// (_pair_call, _pair_kernel) and its glue (_tile_entries, _one_round, the
// rounds' while loop). Its contract stays: for each ray the dense big first
// hit over the Morton-sorted faces (ops/sorted_first_hit.py:
// build_sorted_tiles: tiles of 256 rows of [e2, w2, -e1, -w1, -n, -k],
// centred on the mesh), bit for bit, each hit reported by its sorted index,
// the smallest on a tie; dead rays and misses (inf, -1).
//
// The reference's rounds, kept as they are: a ray's tiles are ordered by
// (entry into the tile's tight box, tile id); a round takes the next k of
// them; a candidate is live where its entry is finite and no later than the
// ray's best t at the round's start (+inf before a hit); every live tile is
// tested; the ray is done once its next untested tile enters after its best
// t. Each entry is the reference's f32 arithmetic (a direction component
// under 1e-12 counted as +-1e-12, the near and far planes picked by the
// sign of 1 / d, which gives min and max of the two plane distances exactly),
// so the candidates are the plain version's (ops/cuda_kernels.py:
// tile_entries, pair_walk_plain), bit for bit, this file built with
// --fmad=false.
//
// Bound on this card: bytes. A ray's segment [0, t_hit] enters the boxes of
// only a few faces; reading the rays and the table once is the floor. The
// TPU design lays the live (ray, tile) pairs out tile-aligned per round
// (sorts, scatters and a host read per round) and tests all 256 faces of
// each; here one thread per ray runs all of its rounds:
// - the block streams the tiles' tight boxes through shared memory in
//   chunks of at most kChunk (32 KiB, cp.async), staged once where the mesh
//   has at most kChunk tiles; every thread reads the same box at once (a
//   broadcast) and keeps its kSlots smallest (entry, tile) keys above the
//   last one it consumed in registers, then parks them in shared memory for
//   its walks; the block scans again while any of its rays needs more
//   candidates (__syncthreads_or). The walk is latency-bound, so the
//   registers and shared memory a block holds, which set the warps an SM
//   keeps in flight, set its pace;
// - a live tile is tested by walking that tile's own subtree of the pair
//   tree (ops/pair_first_hit.py:build_pair_tree: the sorted rows in their
//   own order, tile t under node n_leaves / 64 + t) with K1 big's walk and
//   bilinear leaf (first_hit_walk.cuh, bilinear_pair.cuh) from the ray's
//   best so far; the walk takes the ray's next live tile as soon as it is
//   done with one, without waiting for the warp's other lanes. The
//   lexicographic fold gives the dense answer in any visit order, and the
//   subtree's boxes are padded, so pruning against the current best is
//   exact. Every candidate live by the round-start best is
//   walked, even one whose tight box enters after a hit found earlier in the
//   same round: a grazing ray's rounded hit can lie just outside its tile's
//   unpadded box, and the reference tests that tile.
// With `counts` non-null each ray writes its rounds, live (ray, tile) pairs,
// subtree box tests and leaves folded, which equal the plain walk's; a dead
// ray or one with a non-finite component takes one round and walks nothing.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bilinear_pair.cuh"
#include "first_hit_walk.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;    // tile boxes a block stages at once: at most 32 KiB
constexpr int kSlots = 8;       // candidates a scan keeps: two registers each while it runs
constexpr int kLeafFaces = 4;   // rows per leaf: BVH_LEAF_FACES in ops/cuda_kernels.py
constexpr int kTileLeaves = 64; // leaves of one tile's subtree: TILE_LEAVES in ops/cuda_kernels.py
constexpr float kEntryTiny = 1e-12f;
constexpr unsigned long long kNone = ~0ull;
using first_hit_walk::kBig;

// 1 / d as the tile entries take it: a component under 1e-12 in size counts
// as +-1e-12 by the sign of d (-0 as +1e-12)
__device__ __forceinline__ float entry_inverse(float d) {
  return 1.0f / (fabsf(d) < kEntryTiny ? (d < 0.0f ? -kEntryTiny : kEntryTiny) : d);
}

// Copies tiles [c0, c0 + n) of the (T, 3) minima and maxima into `box` (tile
// j at box[2j] = lo, box[2j + 1] = hi) with cp.async, one float at a time.
// The caller waits and syncs before reading them.
__device__ __forceinline__ void stage_boxes(float4* box, const float* __restrict__ lo, const float* __restrict__ hi,
                                            int c0, int n) {
  float* dst = reinterpret_cast<float*>(box);
  for (int q = threadIdx.x; q < 6 * n; q += blockDim.x) {
    const int j = q / 6, a = q % 6;
    const float* src = a < 3 ? lo + 3 * (c0 + j) + a : hi + 3 * (c0 + j) + a - 3;
    __pipeline_memcpy_async(dst + 8 * j + (a < 3 ? a : a + 1), src, sizeof(float));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// Inserts `key` into the ascending list `cand` (kNone where empty), dropping
// the largest.
__device__ __forceinline__ void insert(unsigned long long (&cand)[kSlots], unsigned long long key) {
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const unsigned long long c = cand[q];
    cand[q] = key < c ? key : c;
    key = key < c ? c : key;
  }
}

__global__ void __launch_bounds__(kThreads)
first_hit_pair_kernel(const float* __restrict__ o,              // (R, 3) origins, world
                      const float* __restrict__ d,              // (R, 3) directions
                      const unsigned char* __restrict__ alive,  // (R,) 1 = live; or null
                      const float* __restrict__ center,         // (3,) the tiles' centre
                      const float* __restrict__ tile_lo,        // (T, 3) tight boxes, centred
                      const float* __restrict__ tile_hi,        // (T, 3)
                      const float4* __restrict__ rows,          // (L * 4 * 4,) leaf rows, tile order
                      const int* __restrict__ face,             // (L * 4,) sorted face, -1 pads
                      const float4* __restrict__ boxes,         // (2L, 2): node i at 2i, centred
                      int n_rays, int n_tiles, int n_leaves, int k, float* __restrict__ t_out,
                      int* __restrict__ idx_out, int* __restrict__ counts) {
  extern __shared__ float4 box[];  // the staged tile boxes: 2 min(T, kChunk) float4s
  // Each thread's candidates from its last scan, slot q at q * kThreads: kept
  // here between the scan and the walks, so neither holds the other's registers
  __shared__ unsigned long long s_cand[kSlots * kThreads];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  bool walking = false;
  if (r < n_rays) {
    ox = o[3 * r] - __ldg(center);
    oy = o[3 * r + 1] - __ldg(center + 1);
    oz = o[3 * r + 2] - __ldg(center + 2);
    dx = d[3 * r];
    dy = d[3 * r + 1];
    dz = d[3 * r + 2];
    walking = (alive == nullptr || alive[r] != 0) && isfinite(ox) && isfinite(oy) && isfinite(oz) &&
              isfinite(dx) && isfinite(dy) && isfinite(dz);
  }
  const float ix = entry_inverse(dx), iy = entry_inverse(dy), iz = entry_inverse(dz);
  const bool px = ix >= 0.0f, py = iy >= 0.0f, pz = iz >= 0.0f;
  const bilinear_pair::BilinearLeaf leaf = bilinear_pair::leaf_of(rows, ox, oy, oz, dx, dy, dz);
  const int root0 = n_leaves / kTileLeaves;  // tile t's subtree: node root0 + t

  first_hit_walk::Best b;
  int rounds = 1, pairs = 0, slots = k;
  float round_best = INFINITY;       // the best t at the round's start
  unsigned long long next_key = 0;   // the least (entry, tile) key not consumed yet
  const bool one_chunk = n_tiles <= kChunk;
  if (one_chunk) stage_boxes(box, tile_lo, tile_hi, 0, n_tiles);
  while (__syncthreads_or(walking)) {
    // One scan: the kSlots smallest finite keys from next_key on
    unsigned long long cand[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) cand[q] = kNone;
    for (int c0 = 0; c0 < n_tiles; c0 += kChunk) {
      const int n = min(kChunk, n_tiles - c0);
      if (!one_chunk) {
        __syncthreads();  // every thread is done with the last chunk
        stage_boxes(box, tile_lo, tile_hi, c0, n);
        __syncthreads();
      }
      if (!walking) continue;
      for (int j = 0; j < n; ++j) {
        const float4 lo = box[2 * j], hi = box[2 * j + 1];
        const float nx = ((px ? lo.x : hi.x) - ox) * ix, fx = ((px ? hi.x : lo.x) - ox) * ix;
        const float ny = ((py ? lo.y : hi.y) - oy) * iy, fy = ((py ? hi.y : lo.y) - oy) * iy;
        const float nz = ((pz ? lo.z : hi.z) - oz) * iz, fz = ((pz ? hi.z : lo.z) - oz) * iz;
        const float ent = fmaxf(fmaxf(fmaxf(0.0f, nx), ny), nz);
        const float exi = fminf(fminf(fx, fy), fz);
        if (!(exi >= ent)) continue;  // the line misses the box: entry +inf, never a candidate
        // -0 and +0 are one entry: the sign bit dropped
        const unsigned long long key =
            ((unsigned long long)(__float_as_uint(ent) & 0x7fffffffu) << 32) | (unsigned)(c0 + j);
        if (key >= next_key && key < cand[kSlots - 1]) insert(cand, key);
      }
    }
    if (!walking) continue;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) s_cand[q * kThreads + threadIdx.x] = cand[q];
    // The candidates in (entry, tile) order, as the rounds take them: the
    // walk asks for the next live one each time it is done with a subtree
    int taken = 0;
    auto next = [&](const first_hit_walk::Best& cur) -> int {
      if (taken == kSlots) return 0;  // this scan's candidates are used up: scan again
      const unsigned long long key = s_cand[taken * kThreads + threadIdx.x];
      ++taken;
      const float e = __uint_as_float((unsigned)(key >> 32));
      if (key != kNone && slots == 0) {  // the round is over: another only if this tile enters no later than the best t
        const float best = cur.t >= kBig ? INFINITY : cur.t;
        if (e <= best) {
          ++rounds;
          round_best = best;
          slots = k;
        }
      }
      // No finite tile left, or this one not live, nor any later candidate: done
      if (key == kNone || slots == 0 || !(e <= round_best)) {
        walking = false;
        taken = kSlots;
        return 0;
      }
      ++pairs;
      --slots;
      next_key = key + 1;
      return root0 + (int)(key & 0xffffffffu);
    };
    b = first_hit_walk::walk_roots(leaf, boxes, face, n_leaves, kLeafFaces, ox, oy, oz, dx, dy, dz, b, next);
  }
  if (r >= n_rays) return;
  const bool miss = b.t >= kBig;
  t_out[r] = miss ? INFINITY : b.t;
  idx_out[r] = miss ? -1 : b.face;
  if (counts != nullptr) {
    counts[4 * r] = rounds;
    counts[4 * r + 1] = pairs;
    counts[4 * r + 2] = b.nodes;
    counts[4 * r + 3] = b.leaves;
  }
}

}  // namespace

extern "C" int first_hit_pair(const float* o, const float* d, const unsigned char* alive, const float* center,
                              const float* tile_lo, const float* tile_hi, const float* rows, const int* face,
                              const float* boxes, int n_rays, int n_tiles, int n_leaves, int k, float* t_out,
                              int* idx_out, int* counts, cudaStream_t stream) {
  if (n_rays <= 0) return (int)cudaSuccess;
  if (n_tiles <= 0 || k < 1 || n_leaves <= 0 || (n_leaves & (n_leaves - 1)) != 0 ||
      n_leaves / kTileLeaves < n_tiles || 31 - __builtin_clz(n_leaves) > face_tree::kStack)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const size_t staged = 2 * (size_t)(n_tiles < kChunk ? n_tiles : kChunk) * sizeof(float4);
  first_hit_pair_kernel<<<blocks, kThreads, staged, stream>>>(
      o, d, alive, center, tile_lo, tile_hi, reinterpret_cast<const float4*>(rows), face,
      reinterpret_cast<const float4*>(boxes), n_rays, n_tiles, n_leaves, k, t_out, idx_out, counts);
  return (int)cudaGetLastError();
}
