// Shared device helpers of the cluster walks: the watertight ray/triangle
// test and the cluster slab test, written operation for operation like the
// torch spec in ops/intersect.py and ops/cluster_intersect.py (which follow
// the JAX package's ops/intersect.py watertight_setup / _wt_block). Built
// with -fmad=false, so no multiply-add is contracted and the kernels round
// exactly like the plain versions.
#pragma once

#include <cuda_runtime.h>

#define RT_RAY_TMAX 1e30f
#define RT_INF 3e38f
#define RT_META_COLS 13
// sign-test tolerance: 4 ulps of the edge-function product magnitudes
#define RT_WT_EPS (4.0f * 1.1920928955078125e-07f)

struct WtRay {
    float rx0, rx1, rx2, ry0, ry1, ry2, rz0, rz1, rz2;
    float rxo, ryo, rzo;
    bool degenerate;
};

// Per-ray shear basis (Woop/Benthin/Wald 2013): the axis permutation and
// the shear fold into three dense rows, so each sheared corner coordinate
// is one 3-term dot product.
static __device__ __forceinline__ WtRay wt_setup(float ox, float oy, float oz,
                                                 float dx, float dy, float dz) {
    const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
    const bool zmax = (az >= ax) && (az >= ay);
    const bool ymax = !zmax && (ay >= ax);
    const int kz = zmax ? 2 : (ymax ? 1 : 0);
    const float d_kz = zmax ? dz : (ymax ? dy : dx);
    const bool neg = d_kz < 0.0f;
    const int kx = neg ? (kz + 2) % 3 : (kz + 1) % 3;
    const int ky = neg ? (kz + 1) % 3 : (kz + 2) % 3;
    const float ex0 = kx == 0 ? 1.0f : 0.0f, ex1 = kx == 1 ? 1.0f : 0.0f,
                ex2 = kx == 2 ? 1.0f : 0.0f;
    const float ey0 = ky == 0 ? 1.0f : 0.0f, ey1 = ky == 1 ? 1.0f : 0.0f,
                ey2 = ky == 2 ? 1.0f : 0.0f;
    const float ez0 = kz == 0 ? 1.0f : 0.0f, ez1 = kz == 1 ? 1.0f : 0.0f,
                ez2 = kz == 2 ? 1.0f : 0.0f;
    const float d_kx = ex0 * dx + ex1 * dy + ex2 * dz;
    const float d_ky = ey0 * dx + ey1 * dy + ey2 * dz;
    const float inv_kz = 1.0f / (d_kz == 0.0f ? 1.0f : d_kz);
    const float sx = d_kx * inv_kz, sy = d_ky * inv_kz, sz = inv_kz;
    WtRay w;
    w.rx0 = ex0 - sx * ez0; w.rx1 = ex1 - sx * ez1; w.rx2 = ex2 - sx * ez2;
    w.ry0 = ey0 - sy * ez0; w.ry1 = ey1 - sy * ez1; w.ry2 = ey2 - sy * ez2;
    w.rz0 = sz * ez0; w.rz1 = sz * ez1; w.rz2 = sz * ez2;
    w.rxo = w.rx0 * ox + w.rx1 * oy + w.rx2 * oz;
    w.ryo = w.ry0 * ox + w.ry1 * oy + w.ry2 * oz;
    w.rzo = w.rz0 * ox + w.rz1 * oy + w.rz2 * oz;
    w.degenerate = (ax == 0.0f) && (ay == 0.0f) && (az == 0.0f);
    return w;
}

// The shear basis of a world ray taken to an instance row's object space:
// m is the row's world->object matrix (row-major 3x4), applied as
// m[0]*ox + m[1]*oy + m[2]*oz + m[3] left to right (the plain version's
// order, ops/cluster_intersect.py _row_w2o_ray); the direction is not
// renormalised, so a hit's t stays in world units.
static __device__ __forceinline__ WtRay w2o_setup(const float* m, float ox,
                                                  float oy, float oz,
                                                  float dx, float dy,
                                                  float dz) {
    const float oxx = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
    const float oyy = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
    const float ozz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
    const float dxx = m[0] * dx + m[1] * dy + m[2] * dz;
    const float dyy = m[4] * dx + m[5] * dy + m[6] * dz;
    const float dzz = m[8] * dx + m[9] * dy + m[10] * dz;
    return wt_setup(oxx, oyy, ozz, dxx, dyy, dzz);
}

// The bits of the w2o matrix a lane's shear basis was last built from:
// the clusters of one instance share their matrix, so a walk rebuilds the
// basis only where the row's matrix changes.
struct W2oCache {
    unsigned int bits[12];
    bool valid = false;
};

// Takes w to the object space of the row whose w2o matrix is m (12
// floats), unless c says w was built from the same bits; returns whether
// it rebuilt w.
static __device__ __forceinline__ bool w2o_update(W2oCache& c, const float* m,
                                                  float ox, float oy, float oz,
                                                  float dx, float dy, float dz,
                                                  WtRay* w) {
    bool same = c.valid;
#pragma unroll
    for (int k = 0; k < 12; ++k)
        same = same && __float_as_uint(m[k]) == c.bits[k];
    if (same) return false;
    *w = w2o_setup(m, ox, oy, oz, dx, dy, dz);
#pragma unroll
    for (int k = 0; k < 12; ++k) c.bits[k] = __float_as_uint(m[k]);
    c.valid = true;
    return true;
}

static __device__ __forceinline__ void wt_shear(const WtRay& w, float vx,
                                                float vy, float vz, float* x,
                                                float* y, float* z) {
    *x = w.rx0 * vx + w.rx1 * vy + w.rx2 * vz - w.rxo;
    *y = w.ry0 * vx + w.ry1 * vy + w.ry2 * vz - w.ryo;
    *z = w.rz0 * vx + w.rz1 * vy + w.rz2 * vz - w.rzo;
}

// One triangle given by its corners. Returns whether it is hit inside
// (tmin, tmax), with t and the v1/v2 weights u, v.
static __device__ __forceinline__ bool wt_tri_c(
    const WtRay& w, float v0x, float v0y, float v0z, float v1x, float v1y,
    float v1z, float v2x, float v2y, float v2z, float tmin, float tmax,
    float* t, float* u, float* v) {
    float ax, ay, az, bx, by, bz, cx, cy, cz;
    wt_shear(w, v0x, v0y, v0z, &ax, &ay, &az);
    wt_shear(w, v1x, v1y, v1z, &bx, &by, &bz);
    wt_shear(w, v2x, v2y, v2z, &cx, &cy, &cz);
    // edge functions with a tolerance band: a shared edge is "on the edge"
    // for both neighbours, so no grazing ray leaks between them
    float p1 = bx * cy, p2 = by * cx;
    const float w_a = p1 - p2, tol_a = RT_WT_EPS * (fabsf(p1) + fabsf(p2));
    p1 = cx * ay; p2 = cy * ax;
    const float w_b = p1 - p2, tol_b = RT_WT_EPS * (fabsf(p1) + fabsf(p2));
    p1 = ax * by; p2 = ay * bx;
    const float w_c = p1 - p2, tol_c = RT_WT_EPS * (fabsf(p1) + fabsf(p2));
    const float det = w_a + w_b + w_c;
    const bool sign_ok = (w_a >= -tol_a && w_b >= -tol_b && w_c >= -tol_c) ||
                         (w_a <= tol_a && w_b <= tol_b && w_c <= tol_c);
    const bool det_ok = fabsf(det) > tol_a + tol_b + tol_c;
    const float inv = 1.0f / (det == 0.0f ? 1.0f : det);
    const float tt = (w_a * az + w_b * bz + w_c * cz) * inv;
    *t = tt;
    *u = fminf(fmaxf(w_b * inv, 0.0f), 1.0f);
    *v = fminf(fmaxf(w_c * inv, 0.0f), 1.0f);
    return sign_ok && det_ok && tt > tmin && tt < tmax && !w.degenerate;
}

// One triangle given as v0 and the edges e1 = v1 - v0, e2 = v2 - v0 (a
// cluster row's layout): the corners are rebuilt as v0 + e, which decides
// their last bit, as in the plain version.
static __device__ __forceinline__ bool wt_tri_v(
    const WtRay& w, float v0x, float v0y, float v0z, float e1x, float e1y,
    float e1z, float e2x, float e2y, float e2z, float tmin, float tmax,
    float* t, float* u, float* v) {
    return wt_tri_c(w, v0x, v0y, v0z, v0x + e1x, v0y + e1y, v0z + e1z,
                    v0x + e2x, v0y + e2y, v0z + e2z, tmin, tmax, t, u, v);
}

// wt_tri_v on tri = [v0(3), e1(3), e2(3)] in global memory (a row of the
// cluster table, read through the read-only path).
static __device__ __forceinline__ bool wt_tri(const WtRay& w,
                                              const float* __restrict__ tri,
                                              float tmin, float tmax, float* t,
                                              float* u, float* v) {
    return wt_tri_v(w, __ldg(tri + 0), __ldg(tri + 1), __ldg(tri + 2),
                    __ldg(tri + 3), __ldg(tri + 4), __ldg(tri + 5),
                    __ldg(tri + 6), __ldg(tri + 7), __ldg(tri + 8), tmin, tmax,
                    t, u, v);
}

// Motion rows: a row's triangles [v0, e1, e2] are followed, after all of
// them (at RT_META_COLS + 9 ct), by their shutter deltas in the same
// layout, and its prim ids start at RT_META_COLS + 18 ct. The triangle a
// ray of time `time` meets is each component lerped as v + time * dv (the
// plain version's order, ops/cluster_intersect.py _row_tris), before the
// corners are rebuilt as v0 + e.
static __device__ __forceinline__ int rt_prim_col(int ct, bool motion) {
    return RT_META_COLS + (motion ? 18 : 9) * ct;
}

// The 9 lerped components of a triangle into c; tri and dlt may lie in
// shared or global memory.
static __device__ __forceinline__ void rt_lerp9(const float* tri,
                                                const float* dlt, float time,
                                                float* c) {
#pragma unroll
    for (int j = 0; j < 9; ++j) c[j] = tri[j] + time * dlt[j];
}

// wt_tri_v on the triangle tri = [v0, e1, e2] at time `time` (dlt: its
// deltas); with MOT false, on tri itself.
template <bool MOT>
static __device__ __forceinline__ bool wt_tri_at(const WtRay& w,
                                                 const float* tri,
                                                 const float* dlt, float time,
                                                 float tmin, float tmax,
                                                 float* t, float* u,
                                                 float* v) {
    float c[9];
    if (MOT) {
        rt_lerp9(tri, dlt, time, c);
    } else {
#pragma unroll
        for (int j = 0; j < 9; ++j) c[j] = tri[j];
    }
    return wt_tri_v(w, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8],
                    tmin, tmax, t, u, v);
}

static __device__ __forceinline__ float safe_inv(float d) {
    if (fabsf(d) > 1e-20f) return 1.0f / (d == 0.0f ? 1.0f : d);
    return d >= 0.0f ? 1e20f : -1e20f;
}

// Slab test of the segment [tmin, tmax] against box b = [lo(3), hi(3)].
// Returns the entry distance max(t_near, tmin), or RT_INF on a miss.
static __device__ __forceinline__ float slab_entry(const float* b, float ox,
                                                   float oy, float oz, float ix,
                                                   float iy, float iz,
                                                   float tmin, float tmax) {
    float tn = -RT_INF, tf = RT_INF;
    float t0 = (b[0] - ox) * ix, t1 = (b[3] - ox) * ix;
    tn = fmaxf(tn, fminf(t0, t1)); tf = fminf(tf, fmaxf(t0, t1));
    t0 = (b[1] - oy) * iy; t1 = (b[4] - oy) * iy;
    tn = fmaxf(tn, fminf(t0, t1)); tf = fminf(tf, fmaxf(t0, t1));
    t0 = (b[2] - oz) * iz; t1 = (b[5] - oz) * iz;
    tn = fmaxf(tn, fminf(t0, t1)); tf = fminf(tf, fmaxf(t0, t1));
    const bool ok = (tn <= tf) && (tf >= tmin) && (tn <= tmax);
    return ok ? fmaxf(tn, tmin) : RT_INF;
}

#define RT_TILE 32

// A tile of rays is one warp. The warp's pick over an entry table in shared
// memory, e[count][RT_TILE] (a lane reads its own column): the lexicographic
// minimum (entry, index) over lanes of each lane's first smallest entry
// below its gate. Returns the entry (RT_INF when none) and sets *idx.
static __device__ __forceinline__ float warp_pick(const float* e, int count,
                                                  int lane, float gate,
                                                  int* idx) {
    float m = RT_INF;
    int mc = count;
    for (int c = 0; c < count; ++c) {
        const float x = e[c * RT_TILE + lane];
        if (x < gate && x < m) {
            m = x;
            mc = c;
        }
    }
    for (int off = RT_TILE / 2; off > 0; off >>= 1) {
        const float om = __shfl_xor_sync(0xFFFFFFFFu, m, off);
        const int oc = __shfl_xor_sync(0xFFFFFFFFu, mc, off);
        if (om < m || (om == m && oc < mc)) {
            m = om;
            mc = oc;
        }
    }
    *idx = mc;
    return m;
}

// ---- packed cluster keys and the per-lane key queue (K2, K7) ----
//
// A lane visits its clusters by the packed key
// (f32_bits(entry) & ~0x1FF) | cluster_id, smallest first: keys are unique
// (the id breaks ties), and order like the entries (9 truncated mantissa
// bits only coarsen the order). A negative entry sorts after every
// non-negative one.
#define RT_KEY_ID_BITS 9
#define RT_KEY_ID_MASK ((1u << RT_KEY_ID_BITS) - 1u)
#define RT_KEY_NEG 0x80000000u  // sign bit of the entry: a negative entry
#define RT_NO_KEY 0xFFFFFFFFu   // an empty queue slot (no key reaches it)

static __device__ __forceinline__ unsigned int rt_pack_key(float e, int c) {
    e = e + 0.0f;  // -0.0 -> +0.0 before taking the bits
    return (__float_as_uint(e) & ~RT_KEY_ID_MASK) | (unsigned int)c;
}

static __device__ __forceinline__ float rt_key_entry(unsigned int key) {
    return __uint_as_float(key & ~RT_KEY_ID_MASK);
}

// Insert key into the sorted queue q of Q registers (a fully unrolled
// insertion network over fixed registers: no array indexed at run time,
// so nothing goes to local memory). Returns the key that falls off the
// end: q's former last key, key itself when it is not smaller, or
// RT_NO_KEY.
template <int Q>
static __device__ __forceinline__ unsigned int rt_queue_insert(
    unsigned int (&q)[Q], unsigned int key) {
    if (!(key < q[Q - 1])) return key;
    const unsigned int out = q[Q - 1];
#pragma unroll
    for (int j = Q - 1; j > 0; --j)
        q[j] = key < q[j - 1] ? q[j - 1] : (key < q[j] ? key : q[j]);
    q[0] = key < q[0] ? key : q[0];
    return out;
}

// Drop the queue's head.
template <int Q>
static __device__ __forceinline__ void rt_queue_pop(unsigned int (&q)[Q]) {
#pragma unroll
    for (int k = 0; k < Q - 1; ++k) q[k] = q[k + 1];
    q[Q - 1] = RT_NO_KEY;
}

template <int Q>
static __device__ __forceinline__ void rt_queue_clear(unsigned int (&q)[Q]) {
#pragma unroll
    for (int k = 0; k < Q; ++k) q[k] = RT_NO_KEY;
}
