// K1: the dense sweep. Every ray against every triangle of a small scene
// (at most 1,024 static triangles take this path), in four modes.
//
// Replaces the TPU kernel raytracingproject_tpu/ops/pallas_intersect.py
// intersect_brute_pallas / _intersect_kernel, which streams (8, 3) triangle
// packets past a tile of 1,024 rays and keeps the closest hit in
// Moeller-Trumbore arithmetic. Mode `mt` computes exactly that. The
// renders of the JAX package never call that kernel: their dense path is
// the watertight ops/intersect.py intersect_brute, shadow_blocked_brute and
// intersect_brute_occlusion (held prim-equal to the TPU kernel by its
// tests), computed outside any kernel. Modes `closest`, `any` and `dual`
// compute those three contracts, so the one kernel file serves the renders
// too. Plain versions: ops/intersect.py intersect_brute,
// shadow_blocked_brute, intersect_brute_occlusion, intersect_brute_mt.
//
// Design: one thread per ray, 128-thread blocks. The ray's shear basis
// (watertight.cuh wt_setup) is computed once. Triangles are staged through
// shared memory, STAGE at a time: each thread of the block converts a few
// triangles to the (v0, e1 = v1 - v0, e2 = v2 - v0) layout of the plain
// version and looks up the triangle's object and its object's visibility
// bits; then every thread walks the stage, all threads reading the same
// shared-memory word at a time (a broadcast: no bank conflict). The corners
// are rebuilt as v0 + e1, v0 + e2 as the plain version does, which decides
// the last bit.
//
// The closest-hit winner follows the plain version literally: triangles go
// in blocks of 8 against the best t before the block; inside a block a tie
// in t goes to the highest index (u and v each to the largest among the
// tied); a later block wins only with a strictly smaller t. Walls and boxes
// that share an edge do tie there. `any` stops testing once every lane of
// the warp is blocked or has an empty window. `dual` tests against
// RAY_TMAX and applies its two windows afterwards, as the plain version.
//
// What bounds it on the H100: arithmetic. A test is ~110 float32
// operations on 12 staged words that every thread of the block shares, so
// the bytes are the rays and results (tens of bytes per ray) while the
// work is rays x triangles x 110.
#include "watertight.cuh"

#define TRI_BLOCK 8
#define STAGE 256  // triangles per stage: 32 blocks of 8, 12 KB

struct StagedTris {
    float tri[STAGE][9];  // v0, e1, e2
    int obj[STAGE];       // prim_object (-1: padding, never hit)
    int vis[STAGE];       // object_visibility[object]
    int bnd[STAGE];       // volume-boundary flag
};

static __device__ __forceinline__ void stage_tris(
    StagedTris& s, const float* __restrict__ tri_verts,
    const int* __restrict__ prim_object, const int* __restrict__ obj_vis,
    const unsigned char* __restrict__ boundary, int base, int count) {
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
        const float* tv = tri_verts + (size_t)(base + k) * 9;
        for (int j = 0; j < 3; ++j) {
            const float v0 = __ldg(tv + j);
            s.tri[k][j] = v0;
            s.tri[k][3 + j] = __ldg(tv + 3 + j) - v0;
            s.tri[k][6 + j] = __ldg(tv + 6 + j) - v0;
        }
        const int ob = __ldg(prim_object + base + k);
        s.obj[k] = ob;
        s.vis[k] = obj_vis ? __ldg(obj_vis + (ob > 0 ? ob : 0)) : 0;
        s.bnd[k] = boundary ? (int)boundary[base + k] : 0;
    }
}

struct Ray {
    float tmin;
    WtRay w;
};

static __device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                               const float* __restrict__ d,
                                               const float* __restrict__ tmin,
                                               int i, bool live) {
    Ray r;
    // lanes past n carry a ray that the callers never store
    const float ox = live ? o[3 * i] : 0.0f, oy = live ? o[3 * i + 1] : 0.0f,
                oz = live ? o[3 * i + 2] : 0.0f;
    const float dx = live ? d[3 * i] : 1.0f, dy = live ? d[3 * i + 1] : 0.0f,
                dz = live ? d[3 * i + 2] : 0.0f;
    r.tmin = live ? tmin[i] : 0.0f;
    r.w = wt_setup(ox, oy, oz, dx, dy, dz);
    return r;
}

#define TRI_ARGS(s, k)                                                       \
    s.tri[k][0], s.tri[k][1], s.tri[k][2], s.tri[k][3], s.tri[k][4],        \
        s.tri[k][5], s.tri[k][6], s.tri[k][7], s.tri[k][8]

__global__ void dense_closest_kernel(
    const float* __restrict__ tri_verts, const int* __restrict__ prim_object,
    const int* __restrict__ obj_vis, int P, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ tmin_a,
    const float* __restrict__ tmax_a, const int* __restrict__ vis_a, int n,
    float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ obj_out) {
    __shared__ StagedTris s;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;
    const Ray r = load_ray(o, d, tmin_a, i, live);
    const float t0 = fminf(live ? tmax_a[i] : -1.0f, RT_RAY_TMAX);
    const int vis = (live && vis_a) ? vis_a[i] : 0;
    float bt = t0, bu = 0.0f, bv = 0.0f;
    int bp = -1;
    for (int base = 0; base < P; base += STAGE) {
        const int count = min(STAGE, P - base);
        __syncthreads();  // every thread is done with the previous stage
        stage_tris(s, tri_verts, prim_object, obj_vis, nullptr, base, count);
        __syncthreads();
        for (int b = 0; b < count; b += TRI_BLOCK) {
            float tk = RT_RAY_TMAX, uk = 0.0f, vk = 0.0f;
            int kk = -1;
            const int kend = min(b + TRI_BLOCK, count);
            for (int k = b; k < kend; ++k) {
                if (s.obj[k] < 0) continue;
                if (vis_a && (s.vis[k] & vis) == 0) continue;
                float t, u, v;
                if (!wt_tri_v(r.w, TRI_ARGS(s, k), r.tmin, bt, &t, &u, &v))
                    continue;
                if (t < tk) {
                    tk = t; kk = k; uk = u; vk = v;
                } else if (t == tk) {
                    kk = k; uk = fmaxf(uk, u); vk = fmaxf(vk, v);
                }
            }
            if (tk < bt) {
                bt = tk; bp = base + kk; bu = uk; bv = vk;
            }
        }
    }
    if (!live) return;
    const bool hit = bt < t0 && bp >= 0;
    t_out[i] = bt;
    prim_out[i] = hit ? bp : -1;
    u_out[i] = bu;
    v_out[i] = bv;
    obj_out[i] = hit ? prim_object[bp] : -1;
}

__global__ void dense_any_kernel(
    const float* __restrict__ tri_verts, const int* __restrict__ prim_object,
    const int* __restrict__ obj_vis, int P, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ tmin_a,
    const float* __restrict__ tmax_a, const int* __restrict__ vis_a, int n,
    unsigned char* __restrict__ blocked_out) {
    __shared__ StagedTris s;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;
    const Ray r = load_ray(o, d, tmin_a, i, live);
    const float tmax = live ? tmax_a[i] : -1.0f;
    const int vis = (live && vis_a) ? vis_a[i] : 0;
    bool blocked = false;
    // a lane with an empty window can never be blocked
    bool warp_done = __all_sync(0xFFFFFFFFu, !(tmax > r.tmin));
    for (int base = 0; base < P; base += STAGE) {
        const int count = min(STAGE, P - base);
        __syncthreads();
        stage_tris(s, tri_verts, prim_object, obj_vis, nullptr, base, count);
        __syncthreads();
        for (int b = 0; b < count && !warp_done; b += TRI_BLOCK) {
            const int kend = min(b + TRI_BLOCK, count);
            for (int k = b; k < kend; ++k) {
                if (s.obj[k] < 0) continue;
                if (vis_a && (s.vis[k] & vis) == 0) continue;
                float t, u, v;
                if (wt_tri_v(r.w, TRI_ARGS(s, k), r.tmin, tmax, &t, &u, &v))
                    blocked = true;
            }
            warp_done = __all_sync(0xFFFFFFFFu, blocked || !(tmax > r.tmin));
        }
    }
    if (live) blocked_out[i] = blocked ? 1 : 0;
}

__global__ void dense_dual_kernel(
    const float* __restrict__ tri_verts, const int* __restrict__ prim_object,
    const int* __restrict__ obj_vis,
    const unsigned char* __restrict__ boundary, int P,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin_a, const float* __restrict__ tmaxc_a,
    const float* __restrict__ tmaxa_a, const int* __restrict__ visc_a,
    const int* __restrict__ visa_a, int n, float* __restrict__ tb_out,
    float* __restrict__ to_out, unsigned char* __restrict__ blocked_out) {
    __shared__ StagedTris s;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;
    const Ray r = load_ray(o, d, tmin_a, i, live);
    const float tmaxc = live ? tmaxc_a[i] : -1.0f;
    const float tmaxa = live ? tmaxa_a[i] : -1.0f;
    const int visc = live ? visc_a[i] : 0, visa = live ? visa_a[i] : 0;
    float tb = RT_RAY_TMAX, to = RT_RAY_TMAX;
    bool blocked = false;
    for (int base = 0; base < P; base += STAGE) {
        const int count = min(STAGE, P - base);
        __syncthreads();
        stage_tris(s, tri_verts, prim_object, obj_vis, boundary, base, count);
        __syncthreads();
        for (int k = 0; k < count; ++k) {
            if (s.obj[k] < 0) continue;
            float t, u, v;
            if (!wt_tri_v(r.w, TRI_ARGS(s, k), r.tmin, RT_RAY_TMAX, &t, &u,
                          &v))
                continue;
            if (t < tmaxa && (s.vis[k] & visa) != 0) blocked = true;
            if (t < tmaxc && (s.vis[k] & visc) != 0) {
                if (s.bnd[k]) tb = fminf(tb, t);
                else to = fminf(to, t);
            }
        }
    }
    if (!live) return;
    tb_out[i] = tb;
    to_out[i] = to;
    blocked_out[i] = blocked ? 1 : 0;
}

// Mode mt: the TPU kernel's own arithmetic. v0/e1/e2 are (P, 3) packets
// (P a multiple of 8, padded with all-zero triangles, whose det is 0).
__global__ void dense_mt_kernel(
    const float* __restrict__ v0_a, const float* __restrict__ e1_a,
    const float* __restrict__ e2_a, int P, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ tmin_a,
    const float* __restrict__ tmax_a, int n, float* __restrict__ t_out,
    int* __restrict__ prim_out, float* __restrict__ u_out,
    float* __restrict__ v_out) {
    __shared__ float tri[STAGE][9];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;
    const float ox = live ? o[3 * i] : 0.0f, oy = live ? o[3 * i + 1] : 0.0f,
                oz = live ? o[3 * i + 2] : 0.0f;
    const float dx = live ? d[3 * i] : 1.0f, dy = live ? d[3 * i + 1] : 0.0f,
                dz = live ? d[3 * i + 2] : 0.0f;
    const float tmin = live ? tmin_a[i] : 0.0f;
    float bt = RT_RAY_TMAX, bu = 0.0f, bv = 0.0f;
    int bp = -1;
    for (int base = 0; base < P; base += STAGE) {
        const int count = min(STAGE, P - base);
        __syncthreads();
        for (int k = threadIdx.x; k < count; k += blockDim.x)
            for (int j = 0; j < 3; ++j) {
                tri[k][j] = __ldg(v0_a + (size_t)(base + k) * 3 + j);
                tri[k][3 + j] = __ldg(e1_a + (size_t)(base + k) * 3 + j);
                tri[k][6 + j] = __ldg(e2_a + (size_t)(base + k) * 3 + j);
            }
        __syncthreads();
        for (int b = 0; b < count; b += TRI_BLOCK) {
            float t_blk = RT_RAY_TMAX, u_blk = 0.0f, v_blk = 0.0f;
            int k_blk = 0;
            const int kend = min(b + TRI_BLOCK, count);
            for (int k = b; k < kend; ++k) {
                const float v0x = tri[k][0], v0y = tri[k][1], v0z = tri[k][2];
                const float e1x = tri[k][3], e1y = tri[k][4], e1z = tri[k][5];
                const float e2x = tri[k][6], e2y = tri[k][7], e2z = tri[k][8];
                const float px = dy * e2z - dz * e2y;
                const float py = dz * e2x - dx * e2z;
                const float pz = dx * e2y - dy * e2x;
                const float det = e1x * px + e1y * py + e1z * pz;
                const bool det_ok = fabsf(det) > 1e-12f;
                const float inv =
                    det_ok ? 1.0f / (det == 0.0f ? 1.0f : det) : 0.0f;
                const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
                const float u = (tx * px + ty * py + tz * pz) * inv;
                const float qx = ty * e1z - tz * e1y;
                const float qy = tz * e1x - tx * e1z;
                const float qz = tx * e1y - ty * e1x;
                const float v = (dx * qx + dy * qy + dz * qz) * inv;
                const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
                const bool hit = det_ok && u >= 0.0f && u <= 1.0f &&
                                 v >= 0.0f && u + v <= 1.0f && t > tmin &&
                                 t < bt;
                if (hit && t < t_blk) {
                    t_blk = t; k_blk = k; u_blk = u; v_blk = v;
                }
            }
            if (t_blk < bt) {
                bt = t_blk; bp = base + k_blk; bu = u_blk; bv = v_blk;
            }
        }
    }
    if (!live) return;
    const float t0 = fminf(tmax_a[i], RT_RAY_TMAX);
    const bool hit = bt < t0;
    t_out[i] = hit ? bt : t0;
    prim_out[i] = hit ? bp : -1;
    u_out[i] = bu;
    v_out[i] = bv;
}

#define BLOCK 128
#define GRID(n) (((n) + BLOCK - 1) / BLOCK)

extern "C" int rt_dense_closest(const float* tri_verts, const int* prim_object,
                                const int* obj_vis, int P, const float* o,
                                const float* d, const float* tmin,
                                const float* tmax, const int* vis, int n,
                                float* t, int* prim, float* u, float* v,
                                int* obj, void* stream) {
    if (n <= 0) return 0;
    dense_closest_kernel<<<GRID(n), BLOCK, 0, (cudaStream_t)stream>>>(
        tri_verts, prim_object, obj_vis, P, o, d, tmin, tmax, vis, n, t, prim,
        u, v, obj);
    return (int)cudaGetLastError();
}

extern "C" int rt_dense_any(const float* tri_verts, const int* prim_object,
                            const int* obj_vis, int P, const float* o,
                            const float* d, const float* tmin,
                            const float* tmax, const int* vis, int n,
                            unsigned char* blocked, void* stream) {
    if (n <= 0) return 0;
    dense_any_kernel<<<GRID(n), BLOCK, 0, (cudaStream_t)stream>>>(
        tri_verts, prim_object, obj_vis, P, o, d, tmin, tmax, vis, n, blocked);
    return (int)cudaGetLastError();
}

extern "C" int rt_dense_dual(const float* tri_verts, const int* prim_object,
                             const int* obj_vis, const unsigned char* boundary,
                             int P, const float* o, const float* d,
                             const float* tmin, const float* tmaxc,
                             const float* tmaxa, const int* visc,
                             const int* visa, int n, float* tb, float* to,
                             unsigned char* blocked, void* stream) {
    if (n <= 0) return 0;
    dense_dual_kernel<<<GRID(n), BLOCK, 0, (cudaStream_t)stream>>>(
        tri_verts, prim_object, obj_vis, boundary, P, o, d, tmin, tmaxc, tmaxa,
        visc, visa, n, tb, to, blocked);
    return (int)cudaGetLastError();
}

extern "C" int rt_dense_mt(const float* v0, const float* e1, const float* e2,
                           int P, const float* o, const float* d,
                           const float* tmin, const float* tmax, int n,
                           float* t, int* prim, float* u, float* v,
                           void* stream) {
    if (n <= 0) return 0;
    dense_mt_kernel<<<GRID(n), BLOCK, 0, (cudaStream_t)stream>>>(
        v0, e1, e2, P, o, d, tmin, tmax, n, t, prim, u, v);
    return (int)cudaGetLastError();
}
