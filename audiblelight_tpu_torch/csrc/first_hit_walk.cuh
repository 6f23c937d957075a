// The first-hit walk of one ray through a face tree, shared by K1 big
// (first_hit.cu, the bilinear rows of the dense big table), K1 small
// (first_hit.cu, classic Moller-Trumbore rows, the tree staged in shared
// memory), K7 (tiled_first_hit.cu, classic Moller-Trumbore rows), K8
// (mxu_first_hit.cu, the bilinear window rows with a launch-face mask), K9
// (sorted_first_hit.cu, the bilinear rows over the Morton-sorted faces, dead
// rays masked) and K10 (pair_first_hit.cu, the same rows, one tile's subtree
// after another). Each kernel passes its own leaf test; the walk, its visit
// order and its fold are the same for all six.
//
// The trees are built by ops/cuda_kernels.py:build_face_bvh, once per mesh:
// a kernel's table rows gathered into leaves of BVH_LEAF_FACES (4)
// Morton-sorted faces, a complete binary tree of padded boxes over the
// leaves, in heap order (node i at boxes[2i] = lo, boxes[2i + 1] = hi). Bound
// on this card: bytes. A ray's segment [0, t_hit] enters the boxes of only
// 2-5 faces, so the work the data needs is tiny next to the dense R x F
// pairs (0.005-0.06 % of them); reading the rays and the table once is the
// floor. Design: one thread per ray, one launch, no ray sort and no host
// read. The thread keeps a stack of (node, entry) in local memory, tests
// both children's boxes, goes to the nearer and pushes the farther; a box is
// skipped only when its slab entry exceeds the ray's best t so far (strict,
// since an equal t with a smaller face index may lie inside), and a popped
// node is skipped the same way. The loop is a while-while: a lane that
// reaches a leaf waits for the warp's other lanes to reach theirs, so the
// warp folds leaves together (lanes diverge most there). A leaf folds its
// rows (read through L1/L2: the full mesh's tables and boxes stay in the
// 50 MB L2) into the lexicographic minimum (t, original face), which is the
// dense walk's answer whatever order the leaves come in. Each row is the
// dense table's row, bit for bit, and goes through the same pair routine,
// so the result equals the dense walk's, given that no leaf holding the
// dense walk's hit is skipped:
// - the boxes hold the region each row's test accepts (the triangle; K8's
//   triangle widened by its 2 % window slop) padded by 1 mm plus 1e-6 of the
//   coordinate's magnitude: a hit the pair arithmetic finds on a grazing ray
//   can lie off its face by ~1e-6 m / sin(angle) along the ray, and the pad
//   holds it down to ~1e-3 rad (tests/test_torch_first_hit_accel.py
//   certifies every ancestor's entry against the dense t for each kernel's
//   arithmetic on interior, surface, grazing, axis-aligned, vertex and edge
//   rays). A ray that runs within microns of a face's plane at under ~1e-6
//   rad is the one case no pad covers: there the dense walk's "hit" is
//   rounding noise and can lie metres off the face, where the tree may not
//   look;
// - a direction component under 1e-20 in size counts as +-1e-20, so the
//   slab products are never 0 * inf (NaN) and a ray lying in a slab's plane
//   is inside it; the near and far planes are chosen by the sign of 1/d, so
//   an empty box (+inf, -inf) enters at +inf and is never visited;
// - a ray with a non-finite component misses every face in each dense walk
//   (a product with it is inf or NaN in every test), so the caller writes it
//   as a miss without a walk;
// - rays that start on a surface (every bounce after the first, 1e-4 m off
//   it) or dead rays need nothing special: the boxes that hold the origin
//   enter at 0 and are walked.
// The plain version (ops/cuda_kernels.py:_first_hit_walk_plain, given the
// kernel's pair test) takes the same steps in the same order; the kernels
// write each ray's box tests and leaf folds where asked, which equal the
// plain walk's.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "face_tree.cuh"

namespace first_hit_walk {

constexpr float kBig = 3.0e38f;    // t of a miss
constexpr int kIdxBig = 1 << 30;  // face of a miss, above every face index
constexpr int kThreads = 128;

// The next stacked node whose entry does not pass `best_t`, or 0 (done);
// stale entries are dropped.
__device__ __forceinline__ int pop(const int* stack_node, const float* stack_t, int& sp, float best_t) {
  while (sp > 0) {
    --sp;
    if (stack_t[sp] <= best_t) return stack_node[sp];
  }
  return 0;
}

// The best hit of one ray and the walk's counts.
struct Best {
  float t = kBig;
  int face = kIdxBig;
  int row = -1;    // the winner's row in the tree's table
  int nodes = 0;   // boxes slab-tested
  int leaves = 0;  // leaves folded
};

// Walks the tree (`boxes`, `face`: (n_leaves * leaf_faces,) original face
// of each row, -1 on padding) for the ray o + s d, s >= 0, in the frame of
// the boxes, from each root that `next(b)` gives in turn: a node, or 0 when
// none is left, asked for when the walk from the last root is done (so `b`
// holds its result). `leaf(row, f, &t)` is the kernel's pair test of row
// `row` (original face f): true where the ray hits it, with its hit
// distance t. The fold starts from `b` (K1 small's always-tested rows, K10's
// best over the tiles walked before), whose counts the walk adds to;
// kGlobal is false where `boxes` and `face` lie in shared memory. A lane
// goes on to its next root without waiting for the warp, so K10's walks of
// several tile subtrees are one walk; each lane's steps are those of one
// walk per root, in turn.
template <bool kGlobal = true, class Leaf, class Next>
__device__ __forceinline__ Best walk_roots(const Leaf& leaf, const float4* __restrict__ boxes,
                                           const int* __restrict__ face, int n_leaves, int leaf_faces, float ox,
                                           float oy, float oz, float dx, float dy, float dz, Best b, Next next) {
  const float ix = face_tree::slab_inverse(dx), iy = face_tree::slab_inverse(dy),
              iz = face_tree::slab_inverse(dz);
  int stack_node[face_tree::kStack];
  float stack_t[face_tree::kStack];
  int sp = 0;
  float e0, x0, e1, x1;
  // The next root whose box the ray enters, each root's test counted; 0 when none is left
  auto enter = [&]() -> int {
    for (int root = next(b); root != 0; root = next(b)) {
      face_tree::slab<kGlobal>(boxes + 2 * root, ox, oy, oz, ix, iy, iz, e0, x0);
      ++b.nodes;
      if (e0 <= x0) return root;
    }
    return 0;
  };
  int node = enter();
  // While-while: a lane that reaches a leaf waits until every lane of the
  // warp has reached one (or finished), so the warp folds its lanes' leaves
  // together; each lane's own steps are the plain walk's
  while (node != 0) {
    while (node != 0 && node < n_leaves) {
      const int c0 = 2 * node;
      face_tree::slab<kGlobal>(boxes + 2 * c0, ox, oy, oz, ix, iy, iz, e0, x0);
      face_tree::slab<kGlobal>(boxes + 2 * c0 + 2, ox, oy, oz, ix, iy, iz, e1, x1);
      b.nodes += 2;
      const bool v0 = e0 <= x0 && e0 <= b.t;
      const bool v1 = e1 <= x1 && e1 <= b.t;
      if (v0 && v1) {
        const bool second = e1 < e0;  // the nearer child first; child 2i on a tie
        stack_node[sp] = second ? c0 : c0 + 1;
        stack_t[sp] = second ? e0 : e1;
        ++sp;
        node = second ? c0 + 1 : c0;
      } else if (v0 || v1) {
        node = v0 ? c0 : c0 + 1;
      } else {
        node = pop(stack_node, stack_t, sp, b.t);
        if (node == 0) node = enter();
      }
    }
    if (node == 0) break;
    const int base = (node - n_leaves) * leaf_faces;
    for (int q = 0; q < leaf_faces; ++q) {
      const int f = face_tree::load<kGlobal>(face + base + q);
      if (f < 0) continue;
      float t;
      const bool hit = leaf(base + q, f, &t);
      if (hit && t < kBig && (t < b.t || (t == b.t && f < b.face))) {
        b.t = t;
        b.face = f;
        b.row = base + q;
      }
    }
    ++b.leaves;
    node = pop(stack_node, stack_t, sp, b.t);
    if (node == 0) node = enter();
  }
  return b;
}

// `walk_roots` from the root of the whole tree, node 1.
template <bool kGlobal = true, class Leaf>
__device__ __forceinline__ Best walk(const Leaf& leaf, const float4* __restrict__ boxes,
                                     const int* __restrict__ face, int n_leaves, int leaf_faces, float ox,
                                     float oy, float oz, float dx, float dy, float dz, Best b = Best()) {
  int root = 1;
  return walk_roots<kGlobal>(leaf, boxes, face, n_leaves, leaf_faces, ox, oy, oz, dx, dy, dz, b,
                             [&root](const Best&) {
                               const int r = root;
                               root = 0;
                               return r;
                             });
}

// The launch every first-hit walk kernel makes: one thread per ray.
template <class Kernel, class... Args>
int launch(Kernel kernel, int n_rays, int n_leaves, int leaf_faces, cudaStream_t stream, Args... args) {
  if (n_rays <= 0) return (int)cudaSuccess;
  if (n_leaves <= 0 || (n_leaves & (n_leaves - 1)) != 0 || 31 - __builtin_clz(n_leaves) > face_tree::kStack ||
      leaf_faces <= 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Writes one ray's result: (inf, -1) on a miss; with `visits` non-null its
// box tests and leaves folded.
__device__ __forceinline__ void store(int r, const Best& b, float t, float* __restrict__ t_out,
                                      int* __restrict__ idx_out, int* __restrict__ visits) {
  const bool miss = b.t >= kBig;
  t_out[r] = miss ? INFINITY : t;
  idx_out[r] = miss ? -1 : b.face;
  if (visits != nullptr) {
    visits[2 * r] = b.nodes;
    visits[2 * r + 1] = b.leaves;
  }
}

}  // namespace first_hit_walk
