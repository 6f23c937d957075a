// Host-side geometry engine: BVH-accelerated mesh queries for placement.
//
// The port's own copy of the reference's cpp/geomlib.cpp, code unchanged.
// Placement's rejection loop issues many small batches of point-in-mesh,
// nearest-surface, first-hit and segment-occlusion queries; a BVH on the
// host answers them without a device round trip per attempt, and lets the
// scene-prep workers, which never see the card, place scenes quickly.
// Bulk work (the tracer's bounces, the rain table) stays on the card.
//
// Exposed as a C ABI consumed through ctypes
// (audiblelight_tpu_torch/geometry/native.py), which builds it at first use:
//   g++ -O3 -shared -fPIC -o libgeom.so geomlib.cpp
// No -march=native: on an FMA host GCC would then contract the
// Moller-Trumbore products and the booleans could split from the reference's.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline Vec3 operator*(Vec3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3 cross(Vec3 a, Vec3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float norm(Vec3 a) { return std::sqrt(dot(a, a)); }

struct AABB {
    Vec3 lo{1e30f, 1e30f, 1e30f};
    Vec3 hi{-1e30f, -1e30f, -1e30f};
    void grow(Vec3 p) {
        lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y); lo.z = std::min(lo.z, p.z);
        hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y); hi.z = std::max(hi.z, p.z);
    }
    void grow(const AABB& b) { grow(b.lo); grow(b.hi); }
};

struct BVHNode {
    AABB box;
    int32_t left = -1;    // child index, or -1 for leaf
    int32_t right = -1;
    int32_t first = 0;    // first triangle (leaf)
    int32_t count = 0;    // triangle count (leaf)
};

struct Mesh {
    std::vector<Vec3> v0, e1, e2;  // triangle origin + edge vectors
    std::vector<AABB> tri_box;
    std::vector<int32_t> order;    // BVH-reordered triangle indices
    std::vector<BVHNode> nodes;
};

std::vector<Mesh*> g_meshes;

int build_node(Mesh& m, std::vector<int32_t>& idx, int first, int count) {
    BVHNode node;
    for (int i = first; i < first + count; ++i) node.box.grow(m.tri_box[idx[i]]);

    int node_id = (int)m.nodes.size();
    m.nodes.push_back(node);

    if (count <= 4) {
        m.nodes[node_id].first = first;
        m.nodes[node_id].count = count;
        return node_id;
    }

    // Median split along the widest axis
    Vec3 extent = node.box.hi - node.box.lo;
    int axis = 0;
    if (extent.y > extent.x) axis = 1;
    if (extent.z > (axis == 0 ? extent.x : extent.y)) axis = 2;

    auto center = [&](int32_t t) {
        const AABB& b = m.tri_box[t];
        float c[3] = {(b.lo.x + b.hi.x), (b.lo.y + b.hi.y), (b.lo.z + b.hi.z)};
        return c[axis];
    };
    std::nth_element(idx.begin() + first, idx.begin() + first + count / 2,
                     idx.begin() + first + count,
                     [&](int32_t a, int32_t b) { return center(a) < center(b); });

    int mid = count / 2;
    int left = build_node(m, idx, first, mid);
    int right = build_node(m, idx, first + mid, count - mid);
    m.nodes[node_id].left = left;
    m.nodes[node_id].right = right;
    return node_id;
}

// NaN-safe slab reciprocal: a zero direction component with an origin
// exactly ON a box plane makes 0 * inf = NaN, and min/max propagate it
// unpredictably (a blocking subtree can be skipped). Replacing a zero
// component with a tiny SIGNED value keeps the slab test finite and
// conservative (the same fix as the Python grid kernels' safe_dir).
inline Vec3 safe_inv(Vec3 d) {
    const float tiny = 1e-30f;
    auto inv = [&](float c) {
        if (c > tiny || c < -tiny) return 1.0f / c;
        return std::copysign(1.0f / tiny, c == 0.0f ? 1.0f : c);
    };
    return {inv(d.x), inv(d.y), inv(d.z)};
}

inline bool aabb_hit(const AABB& b, Vec3 o, Vec3 inv_d, float t_max) {
    float tx1 = (b.lo.x - o.x) * inv_d.x, tx2 = (b.hi.x - o.x) * inv_d.x;
    float ty1 = (b.lo.y - o.y) * inv_d.y, ty2 = (b.hi.y - o.y) * inv_d.y;
    float tz1 = (b.lo.z - o.z) * inv_d.z, tz2 = (b.hi.z - o.z) * inv_d.z;
    float tmin = std::max({std::min(tx1, tx2), std::min(ty1, ty2), std::min(tz1, tz2)});
    float tmax = std::min({std::max(tx1, tx2), std::max(ty1, ty2), std::max(tz1, tz2)});
    return tmax >= std::max(tmin, 0.0f) && tmin < t_max;
}

// Moller-Trumbore; returns t or -1
inline float tri_hit(const Mesh& m, int32_t t, Vec3 o, Vec3 d) {
    const float EPS = 1e-9f;
    Vec3 h = cross(d, m.e2[t]);
    float a = dot(m.e1[t], h);
    if (std::fabs(a) < EPS) return -1.0f;
    float f = 1.0f / a;
    Vec3 s = o - m.v0[t];
    float u = f * dot(s, h);
    if (u < -EPS || u > 1.0f + EPS) return -1.0f;
    Vec3 q = cross(s, m.e1[t]);
    float v = f * dot(d, q);
    if (v < -EPS || u + v > 1.0f + EPS) return -1.0f;
    float tt = f * dot(m.e2[t], q);
    return tt > EPS ? tt : -1.0f;
}

// First hit along a ray (returns t and triangle id)
void ray_first_hit(const Mesh& m, Vec3 o, Vec3 d, float* t_out, int32_t* id_out) {
    Vec3 inv_d = safe_inv(d);
    float best = std::numeric_limits<float>::infinity();
    int32_t best_id = -1;
    int stack[64];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
        const BVHNode& n = m.nodes[stack[--sp]];
        if (!aabb_hit(n.box, o, inv_d, best)) continue;
        if (n.left < 0) {
            for (int i = n.first; i < n.first + n.count; ++i) {
                int32_t tri = m.order[i];
                float t = tri_hit(m, tri, o, d);
                if (t > 0 && t < best) { best = t; best_id = tri; }
            }
        } else {
            if (sp < 62) { stack[sp++] = n.left; stack[sp++] = n.right; }
        }
    }
    *t_out = best;
    *id_out = best_id;
}

// Count crossings along a fixed parity direction
int crossing_count(const Mesh& m, Vec3 o, Vec3 d) {
    Vec3 inv_d = safe_inv(d);
    int count = 0;
    int stack[64];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
        const BVHNode& n = m.nodes[stack[--sp]];
        if (!aabb_hit(n.box, o, inv_d, std::numeric_limits<float>::infinity())) continue;
        if (n.left < 0) {
            for (int i = n.first; i < n.first + n.count; ++i) {
                if (tri_hit(m, m.order[i], o, d) > 0) ++count;
            }
        } else {
            if (sp < 62) { stack[sp++] = n.left; stack[sp++] = n.right; }
        }
    }
    return count;
}

// Any hit with t in (margin, max_t - margin)? (segment occlusion)
bool segment_blocked(const Mesh& m, Vec3 o, Vec3 d, float max_t, float margin) {
    Vec3 inv_d = safe_inv(d);
    int stack[64];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
        const BVHNode& n = m.nodes[stack[--sp]];
        if (!aabb_hit(n.box, o, inv_d, max_t)) continue;
        if (n.left < 0) {
            for (int i = n.first; i < n.first + n.count; ++i) {
                float t = tri_hit(m, m.order[i], o, d);
                if (t > margin && t < max_t - margin) return true;
            }
        } else {
            if (sp < 62) { stack[sp++] = n.left; stack[sp++] = n.right; }
        }
    }
    return false;
}

inline float sq(float x) { return x * x; }

float aabb_dist_sq(const AABB& b, Vec3 p) {
    float d = 0;
    if (p.x < b.lo.x) d += sq(b.lo.x - p.x); else if (p.x > b.hi.x) d += sq(p.x - b.hi.x);
    if (p.y < b.lo.y) d += sq(b.lo.y - p.y); else if (p.y > b.hi.y) d += sq(p.y - b.hi.y);
    if (p.z < b.lo.z) d += sq(b.lo.z - p.z); else if (p.z > b.hi.z) d += sq(p.z - b.hi.z);
    return d;
}

// Point-to-triangle squared distance (Ericson)
float point_tri_dist_sq(const Mesh& m, int32_t t, Vec3 p) {
    Vec3 a = m.v0[t];
    Vec3 ab = m.e1[t], ac = m.e2[t];
    Vec3 ap = p - a;
    float d1 = dot(ab, ap), d2 = dot(ac, ap);
    if (d1 <= 0 && d2 <= 0) return dot(ap, ap);

    Vec3 b = a + ab;
    Vec3 bp = p - b;
    float d3 = dot(ab, bp), d4 = dot(ac, bp);
    if (d3 >= 0 && d4 <= d3) return dot(bp, bp);

    float vc = d1 * d4 - d3 * d2;
    if (vc <= 0 && d1 >= 0 && d3 <= 0) {
        float v = d1 / (d1 - d3);
        Vec3 q = ap - ab * v;
        return dot(q, q);
    }

    Vec3 c = a + ac;
    Vec3 cp = p - c;
    float d5 = dot(ab, cp), d6 = dot(ac, cp);
    if (d6 >= 0 && d5 <= d6) return dot(cp, cp);

    float vb = d5 * d2 - d1 * d6;
    if (vb <= 0 && d2 >= 0 && d6 <= 0) {
        float w = d2 / (d2 - d6);
        Vec3 q = ap - ac * w;
        return dot(q, q);
    }

    float va = d3 * d6 - d5 * d4;
    if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
        float w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
        Vec3 q = bp - (c - b) * w;
        return dot(q, q);
    }

    float denom = 1.0f / (va + vb + vc);
    float v = vb * denom, w = vc * denom;
    Vec3 q = ap - ab * v - ac * w;
    return dot(q, q);
}

float nearest_dist_sq(const Mesh& m, Vec3 p) {
    float best = std::numeric_limits<float>::infinity();
    // Best-first traversal with a small manual stack
    int stack[64];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
        const BVHNode& n = m.nodes[stack[--sp]];
        if (aabb_dist_sq(n.box, p) >= best) continue;
        if (n.left < 0) {
            for (int i = n.first; i < n.first + n.count; ++i)
                best = std::min(best, point_tri_dist_sq(m, m.order[i], p));
        } else {
            // Visit nearer child last so it pops first
            float dl = aabb_dist_sq(m.nodes[n.left].box, p);
            float dr = aabb_dist_sq(m.nodes[n.right].box, p);
            if (sp < 62) {
                if (dl < dr) { stack[sp++] = n.right; stack[sp++] = n.left; }
                else { stack[sp++] = n.left; stack[sp++] = n.right; }
            }
        }
    }
    return best;
}

const float PARITY_DIR[3] = {0.57735027f, 0.62882718f, 0.52019128f};

}  // namespace

extern "C" {

// Build a BVH over (n_tris, 3, 3) float32 triangles; returns a handle (or -1).
int32_t geom_build(const float* tris, int32_t n_tris) {
    Mesh* m = new Mesh();
    m->v0.resize(n_tris);
    m->e1.resize(n_tris);
    m->e2.resize(n_tris);
    m->tri_box.resize(n_tris);
    for (int32_t i = 0; i < n_tris; ++i) {
        Vec3 a = {tris[i * 9 + 0], tris[i * 9 + 1], tris[i * 9 + 2]};
        Vec3 b = {tris[i * 9 + 3], tris[i * 9 + 4], tris[i * 9 + 5]};
        Vec3 c = {tris[i * 9 + 6], tris[i * 9 + 7], tris[i * 9 + 8]};
        m->v0[i] = a;
        m->e1[i] = b - a;
        m->e2[i] = c - a;
        m->tri_box[i].grow(a);
        m->tri_box[i].grow(b);
        m->tri_box[i].grow(c);
    }
    std::vector<int32_t> idx(n_tris);
    for (int32_t i = 0; i < n_tris; ++i) idx[i] = i;
    m->nodes.reserve(2 * n_tris);
    build_node(*m, idx, 0, n_tris);
    m->order = std::move(idx);

    g_meshes.push_back(m);
    return (int32_t)g_meshes.size() - 1;
}

void geom_free(int32_t handle) {
    if (handle >= 0 && handle < (int32_t)g_meshes.size() && g_meshes[handle]) {
        delete g_meshes[handle];
        g_meshes[handle] = nullptr;
    }
}

// Ray-parity inside test for n points -> uint8 results
void geom_contains(int32_t handle, const float* points, int32_t n, uint8_t* out) {
    const Mesh& m = *g_meshes[handle];
    Vec3 d = {PARITY_DIR[0], PARITY_DIR[1], PARITY_DIR[2]};
    for (int32_t i = 0; i < n; ++i) {
        Vec3 p = {points[i * 3], points[i * 3 + 1], points[i * 3 + 2]};
        out[i] = (uint8_t)(crossing_count(m, p, d) % 2);
    }
}

// Nearest surface distance for n points
void geom_nearest(int32_t handle, const float* points, int32_t n, float* out) {
    const Mesh& m = *g_meshes[handle];
    for (int32_t i = 0; i < n; ++i) {
        Vec3 p = {points[i * 3], points[i * 3 + 1], points[i * 3 + 2]};
        out[i] = std::sqrt(nearest_dist_sq(m, p));
    }
}

// First-hit distances + triangle ids for n rays
void geom_raycast(int32_t handle, const float* origins, const float* dirs, int32_t n,
                  float* t_out, int32_t* id_out) {
    const Mesh& m = *g_meshes[handle];
    for (int32_t i = 0; i < n; ++i) {
        Vec3 o = {origins[i * 3], origins[i * 3 + 1], origins[i * 3 + 2]};
        Vec3 d = {dirs[i * 3], dirs[i * 3 + 1], dirs[i * 3 + 2]};
        ray_first_hit(m, o, d, &t_out[i], &id_out[i]);
    }
}

// Segment occlusion for n (start, end) pairs -> uint8 results
void geom_occluded(int32_t handle, const float* starts, const float* ends, int32_t n,
                   float margin, uint8_t* out) {
    const Mesh& m = *g_meshes[handle];
    for (int32_t i = 0; i < n; ++i) {
        Vec3 a = {starts[i * 3], starts[i * 3 + 1], starts[i * 3 + 2]};
        Vec3 b = {ends[i * 3], ends[i * 3 + 1], ends[i * 3 + 2]};
        Vec3 seg = b - a;
        float len = norm(seg);
        if (len < 1e-12f) { out[i] = 0; continue; }
        Vec3 d = seg * (1.0f / len);
        out[i] = (uint8_t)segment_blocked(m, a, d, len, margin);
    }
}

}  // extern "C"
