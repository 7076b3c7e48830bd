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
// What bounds it on the H100: arithmetic. A test is ~110 float32
// operations on 12 staged words that every thread of the block shares, so
// the bytes are the rays and results (tens of bytes per ray) while the
// all-pairs work is rays x triangles x 110. The render modes therefore do
// fewer tests, not faster ones, and every output stays the plain
// version's to the bit.
//
// Design of the render modes (closest, any, dual): 128-thread blocks, one
// thread per ray. Triangles are staged through shared memory STAGE at a
// time: each thread converts a few triangles to their corners v0,
// v1 = v0 + (tv1 - v0), v2 = v0 + (tv2 - v0) (the plain version's
// operations, once per triangle instead of once per ray and triangle) and
// looks up the triangle's object and its object's visibility bits, and
// computes its unit normal and the bounds of the edge-on test; then for
// each block of TRI_BLOCK triangles one thread writes the block's two
// padded boxes, its edge-on data and the OR of its visibility bits.
//
// 1. Empty windows cost nothing. A block of threads takes `rounds` x 128
//    lanes; a lane whose window is empty (closest and any: tmax <= tmin;
//    dual: both windows empty) writes its miss result at once, and the
//    others are gathered in lane order into a shared list (__ballot_sync /
//    __popc, a prefix over the warps), which the block runs 128 at a time,
//    re-staging the triangles for each round.
// 2. A lane tests a block's triangles only if the block can hold a
//    triangle that changes its result (keep_block): the lane's visibility
//    meets the block's, and the block's boxes admit a hit below the lane's
//    gate. A triangle changes a result only with t below the gate: the
//    best t before the block (closest; a later block wins only with a
//    strictly smaller t), tmax until blocked (any), and K3's
//    occlusion_gate, max(min(max(t_b, t_o), tmax_c), blocked ? -inf :
//    tmax_a) (dual). Whole blocks are skipped, so the block-of-8 winner
//    rule (a tie in t goes to the highest index, u and v each to the
//    largest) runs on the same triangles against the same best t.
// 3. A warp's lanes keep different blocks (on volume_sss's recorded
//    bounce rays the warp's union is 3-5x a lane's own, PERF.md), and a
//    thread that tests a block's 8 triangles for its own lane leaves the
//    others idle. So a block kept by at most SPREAD_MAX lanes of the warp
//    has its (lane, triangle) pairs spread over the 32 threads, 4 lanes a
//    round: each thread fetches its pair's ray by shuffles, tests one
//    triangle, and each group of 8 threads reduces its lane's results by
//    the mode's rule (closest: the smallest t, among ties the highest
//    index and u and v each the largest; dual: two minima and an OR; any:
//    an OR). These are associative and commutative, so the bits do not
//    depend on the order. A block kept by more lanes runs per lane.
//
// keep_block is exact, not a heuristic. Let u = 2^-24. The test shears
// the corners into the ray's frame (x, y across the ray, z its
// parameter), takes the edge functions w_i with tolerances tol_i = 8u
// (|p1| + |p2|) and det = sum w_i, and accepts when every w_i >= -tol_i
// (or every w_i <= tol_i) and |det| > T = sum tol_i. Each of the block's
// two boxes is padded by BOX_REL x (largest |coordinate| of the block) +
// BOX_ABS and, per lane, by BOX_REL x (largest |coordinate| of the
// origin): some 100x the rounding of the shear, of the slab test and of
// the ray's frame against the line (o, d), a few u of those coordinates.
// The narrow box grows by MU and the wide one by WIDE times the block's
// extent on each axis. A block is kept where all three hold:
//  - the bound on t. t = sum(w_i z_i) / det, and the tests bound the
//    negative weights w_i / det to a sum below 1 (T / det < 1). So t lies
//    in [2 zlo - zhi, 2 zhi - zlo], with [zlo, zhi] the ray's interval in
//    the narrow box's slab on its dominant axis kz (wt_setup's), widened
//    by T_REL of its ends for the rounding of t. That range must meet
//    (tmin, gate).
//  - the line meets the wide box. The rays' true weights lambda_i (the
//    exact barycentrics of the ray in the rounded sheared triangle) differ
//    from w_i by at most tol_i / 4, so their negative part sums to
//    nu <= 1.25 T / (0.75 T) = 5/3: the line passes through
//    sum lambda_i v_i, within nu < WIDE times the extent of the triangle.
//  - the line meets the narrow box, or the lane is edge-on to the block.
//    With R the largest |x| + |y| of a corner and L the largest such
//    length of an edge, R <= (1 + 2 nu) L and T <= 24u R^2, so
//    nu <= 30u (1 + 2 nu)^2 L^2 / D, with D the exact sum of the edge
//    functions, twice the rounded sheared triangle's area. Where kappa = 30u L^2 / D <= 0.05
//    and nu <= 5/3, that gives nu <= 1.3 kappa. L <= 2.83 diam + 4 eps
//    (|sx|, |sy| <= 1) and D >= 2 A (c - 3u) - 11.4 eps diam - 8 eps^2,
//    with A the triangle's area, c = |n . d| / |d| and eps <= 5u (M + |o|)
//    the rounding of a sheared coordinate. So nu <= MU = 0.01 wherever
//    c >= 3u + (1.9e-3 diam^2 + 11.4 E diam + 16 E^2) / (2 A), E = 1e-6
//    (M + max |o|); keep_block asks c >= K + (B + G E) E with K = C0 +
//    C1 alpha, B = C2 beta, G = C3 gamma (alpha = diam^2 / 2A, beta =
//    diam / 2A, gamma = 1 / 2A, each the block's largest, 2A taken as
//    |cross| - GEO_REL diam^2, below the true value): twice the bound,
//    which covers the rounding of the normals and of c. A degenerate
//    triangle has alpha = beta = gamma = inf and is always edge-on. A lane
//    that is not edge-on to any of the block's triangles thus meets them
//    only within MU times their extent, inside the narrow box.
// ops/dense_sweep.py block_keep computes the same predicate in the same
// operation order, and tests/test_torch_dense_cull.py holds it against
// every hit of the plain watertight test on the scenes' triangles, with
// rays nearly along their edges (ops/dense_sweep.py edge_rays), where a
// line test with a pad of a few ulps drops hits.
//
// Deform modes (DEF; the JAX package's dense sweeps with tri_verts_t1 and
// time, ops/intersect.py _motion_components): every triangle moves on a
// piecewise-linear path of S1 uniform segments over the shutter, given as
// its positions at the S1 steps after shutter open, and each lane tests
// the triangles where they are at its time. Staging keeps a triangle's
// v0, e1 = tv1 - v0, e2 = tv2 - v0 (in place of its corners) and, in
// dynamic shared memory, the per-segment deltas of those nine numbers
// (step g's minus step g - 1's, the plain version's operations); a lane
// sums them with the hat weights w_g = clip(time S1 - g, 0, 1) (time
// itself for one segment), segment by segment, v + w_g dv_g, and rebuilds
// the corners as v0 + e before the test. The cull keeps only its box part:
// the block's boxes are taken over the corners of every step, and a block
// is kept where the bound on t meets (tmin, gate) and the line meets the
// wide box. Both hold for a moving triangle as for a static one (they
// need only that its corners lie in the narrow box, which holds up to the
// rounding of the lerp, a few ulps against the pad of ~250). The edge-on
// test takes its bounds from one triangle's normal and area, which change
// as the triangle moves, so it is not used: a lane keeps every block whose
// wide box its line meets. ops/dense_sweep.py block_keep takes the steps
// and computes the same predicate.
//
// The counting variant (COUNT) also writes per lane the triangles it
// tested, the blocks it kept and, for the lane's warp in its round, the
// blocks that any lane of the warp kept, into counts[3 * lane].
//
// Registers and spills: chip_smoke.py prints the build log (ptxas -v), and
// PERF.md section 6 records them.
//
// Mode mt: one thread per ray, 128-thread blocks, the packets staged 256
// triangles at a time, every ray against every triangle (no render calls
// it).
#include "watertight.cuh"

#define TRI_BLOCK 8
#define STAGE 256  // triangles per stage: 32 blocks of 8
#define STAGE_BLOCKS (STAGE / TRI_BLOCK)
#define BLOCK 128
#define WARPS (BLOCK / 32)
#define MAX_ROUNDS 4
#define FULL_MASK 0xFFFFFFFFu
// A block kept by at most SPREAD_MAX lanes of a warp has its (lane,
// triangle) tests spread over the warp's 32 threads, 4 lanes a round. A
// round costs one test and ~40 shuffles, so nk lanes cost ~nk / 4 x ~150
// operations, against 8 tests (~880) per lane: the spread wins up to
// ~23 lanes, and 20 leaves a margin for the rounds' reductions
#define SPREAD_MAX 20
// the cull's constants (kept equal to ops/dense_sweep.py; the header says
// where each comes from)
#define BOX_REL 3e-5f
#define BOX_ABS 1e-3f
#define T_REL 1e-5f
#define MU 1e-2f
#define WIDE 2.0f
#define GEO_REL 2e-6f
#define C0 1e-5f
#define C1 4e-3f
#define C2 24.0f
#define C3 32.0f
#define EPS_E 1e-6f
#define RT_INFTY __int_as_float(0x7f800000)
// deform modes: segments of a path whose deltas the stage holds (the
// dynamic shared memory, STAGE x 9 x S1 floats, stays within a block's
// 227 KB beside the static part)
#define MAX_SEGMENTS 20

enum { MODE_CLOSEST = 0, MODE_ANY = 1, MODE_DUAL = 2 };

struct StagedTris {
    float c[STAGE][9];           // corners v0, v1, v2 (DEF: v0, e1, e2)
    float nrm[STAGE][3];         // unit normals (0 for a degenerate one;
                                 // DEF: the low corner of its shutter box)
    float abg[STAGE][3];         // alpha, beta, gamma of the edge-on test
                                 // (DEF: the high corner of its box)
    int obj[STAGE];              // prim_object (-1: never hit)
    int vis[STAGE];              // object_visibility[object]
    int bnd[STAGE];              // volume-boundary flag
    float box[STAGE_BLOCKS][6];  // narrow padded box: lo, hi
    float wbox[STAGE_BLOCKS][6]; // wide padded box: lo, hi
    float geo[STAGE_BLOCKS][4];  // K, B, G, M of the edge-on test
    int bvis[STAGE_BLOCKS];      // OR of the block's visibility
};

static __device__ __forceinline__ float dot3(float ax, float ay, float az,
                                             float bx, float by, float bz) {
    return (ax * bx + ay * by) + az * bz;
}

// The paths of the deform modes: steps (S1, P, 3, 3), the triangles at
// the S1 uniform steps after shutter open; dl the stage's deltas in
// dynamic shared memory, 9 floats a (triangle, segment).
struct DeformPath {
    const float* steps;
    int S1;
    int P;
    float* dl;
};

// Stage triangles [base, base + count) and their blocks' boxes and
// edge-on data (DEF: the triangles' v0, e1, e2, their segment deltas and
// their boxes over every step); ends with the stage visible to the whole
// block.
template <bool DEF>
static __device__ __forceinline__ void stage_tris(
    StagedTris& s, const float* __restrict__ tri_verts,
    const int* __restrict__ prim_object, const int* __restrict__ obj_vis,
    const unsigned char* __restrict__ boundary, int base, int count,
    const DeformPath& dp) {
    __syncthreads();  // every thread is done with the previous stage
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
        const float* tv = tri_verts + (size_t)(base + k) * 9;
        float c[9];
        for (int j = 0; j < 3; ++j) {
            const float v0 = __ldg(tv + j);
            c[j] = v0;
            c[3 + j] = v0 + (__ldg(tv + 3 + j) - v0);
            c[6 + j] = v0 + (__ldg(tv + 6 + j) - v0);
        }
        if (DEF) {
            float prev[9], lo[3], hi[3];
            for (int j = 0; j < 3; ++j) {
                prev[j] = c[j];
                prev[3 + j] = __ldg(tv + 3 + j) - c[j];
                prev[6 + j] = __ldg(tv + 6 + j) - c[j];
                lo[j] = fminf(fminf(c[j], c[3 + j]), c[6 + j]);
                hi[j] = fmaxf(fmaxf(c[j], c[3 + j]), c[6 + j]);
            }
            for (int j = 0; j < 9; ++j) s.c[k][j] = prev[j];
            for (int g = 0; g < dp.S1; ++g) {
                const float* sv =
                    dp.steps + ((size_t)g * dp.P + base + k) * 9;
                float* dg = dp.dl + (size_t)(k * dp.S1 + g) * 9;
                for (int j = 0; j < 3; ++j) {
                    const float v0 = __ldg(sv + j);
                    const float e1 = __ldg(sv + 3 + j) - v0;
                    const float e2 = __ldg(sv + 6 + j) - v0;
                    const float c1 = v0 + e1, c2 = v0 + e2;
                    lo[j] = fminf(lo[j], fminf(fminf(v0, c1), c2));
                    hi[j] = fmaxf(hi[j], fmaxf(fmaxf(v0, c1), c2));
                    dg[j] = v0 - prev[j];
                    dg[3 + j] = e1 - prev[3 + j];
                    dg[6 + j] = e2 - prev[6 + j];
                    prev[j] = v0;
                    prev[3 + j] = e1;
                    prev[6 + j] = e2;
                }
            }
            for (int j = 0; j < 3; ++j) {
                s.nrm[k][j] = lo[j];
                s.abg[k][j] = hi[j];
            }
        } else {
            for (int j = 0; j < 9; ++j) s.c[k][j] = c[j];
            const float e1x = c[3] - c[0], e1y = c[4] - c[1], e1z = c[5] - c[2];
            const float e2x = c[6] - c[0], e2y = c[7] - c[1], e2z = c[8] - c[2];
            const float e3x = c[6] - c[3], e3y = c[7] - c[4], e3z = c[8] - c[5];
            const float cx = e1y * e2z - e1z * e2y;
            const float cy = e1z * e2x - e1x * e2z;
            const float cz = e1x * e2y - e1y * e2x;
            const float nl = sqrtf(dot3(cx, cy, cz, cx, cy, cz));
            const float dm = fmaxf(fmaxf(dot3(e1x, e1y, e1z, e1x, e1y, e1z),
                                         dot3(e2x, e2y, e2z, e2x, e2y, e2z)),
                                   dot3(e3x, e3y, e3z, e3x, e3y, e3z));
            const float a2 = nl - GEO_REL * dm;
            const bool ok = a2 > 0.0f;
            const float inv = 1.0f / a2;
            s.abg[k][0] = ok ? dm * inv : RT_INFTY;
            s.abg[k][1] = ok ? sqrtf(dm) * inv : RT_INFTY;
            s.abg[k][2] = ok ? inv : RT_INFTY;
            s.nrm[k][0] = nl > 0.0f ? cx / nl : 0.0f;
            s.nrm[k][1] = nl > 0.0f ? cy / nl : 0.0f;
            s.nrm[k][2] = nl > 0.0f ? cz / nl : 0.0f;
        }
        const int ob = __ldg(prim_object + base + k);
        s.obj[k] = ob;
        s.vis[k] = obj_vis ? __ldg(obj_vis + (ob > 0 ? ob : 0)) : 0;
        s.bnd[k] = boundary ? (int)boundary[base + k] : 0;
    }
    __syncthreads();
    const int nb = (count + TRI_BLOCK - 1) / TRI_BLOCK;
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
        float lo[3] = {RT_INF, RT_INF, RT_INF};
        float hi[3] = {-RT_INF, -RT_INF, -RT_INF};
        float al = 0.0f, be = 0.0f, ga = 0.0f;
        int bv = 0;
        const int kend = min(b * TRI_BLOCK + TRI_BLOCK, count);
        for (int k = b * TRI_BLOCK; k < kend; ++k) {
            if (DEF) {
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    lo[j] = fminf(lo[j], s.nrm[k][j]);
                    hi[j] = fmaxf(hi[j], s.abg[k][j]);
                }
            } else {
#pragma unroll
                for (int j = 0; j < 9; ++j) {
                    lo[j % 3] = fminf(lo[j % 3], s.c[k][j]);
                    hi[j % 3] = fmaxf(hi[j % 3], s.c[k][j]);
                }
                al = fmaxf(al, s.abg[k][0]);
                be = fmaxf(be, s.abg[k][1]);
                ga = fmaxf(ga, s.abg[k][2]);
            }
            bv |= s.vis[k];
        }
        const float m = fmaxf(fmaxf(fmaxf(fabsf(lo[0]), fabsf(lo[1])),
                                    fmaxf(fabsf(lo[2]), fabsf(hi[0]))),
                              fmaxf(fabsf(hi[1]), fabsf(hi[2])));
        const float pad = BOX_REL * m + BOX_ABS;
        for (int j = 0; j < 3; ++j) {
            const float ext = hi[j] - lo[j];
            s.box[b][j] = lo[j] - (pad + MU * ext);
            s.box[b][3 + j] = hi[j] + (pad + MU * ext);
            s.wbox[b][j] = lo[j] - (pad + WIDE * ext);
            s.wbox[b][3 + j] = hi[j] + (pad + WIDE * ext);
        }
        s.geo[b][0] = C0 + C1 * al;
        s.geo[b][1] = C2 * be;
        s.geo[b][2] = C3 * ga;
        s.geo[b][3] = m;
        s.bvis[b] = bv;
    }
    __syncthreads();
}

// What keep_block needs of a lane's ray.
struct CullRay {
    float ox, oy, oz, dx, dy, dz;   // origin, direction
    float ix, iy, iz;               // safe_inv(direction)
    float mo;                       // largest |origin coordinate|
    float m;                        // BOX_REL x mo
    float dn;                       // |direction|
    float tmin;
    int kz;                         // wt_setup's dominant axis
};

static __device__ __forceinline__ CullRay cull_ray(float ox, float oy,
                                                   float oz, float dx,
                                                   float dy, float dz,
                                                   float tmin) {
    CullRay c;
    c.ox = ox; c.oy = oy; c.oz = oz;
    c.dx = dx; c.dy = dy; c.dz = dz;
    c.ix = safe_inv(dx); c.iy = safe_inv(dy); c.iz = safe_inv(dz);
    c.mo = fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz));
    c.m = BOX_REL * c.mo;
    c.dn = sqrtf(dot3(dx, dy, dz, dx, dy, dz));
    c.tmin = tmin;
    const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
    const bool zmax = (az >= ax) && (az >= ay);
    const bool ymax = !zmax && (ay >= ax);
    c.kz = zmax ? 2 : (ymax ? 1 : 0);
    return c;
}

// Whether the line meets box b = [lo(3), hi(3)], grown by the lane's pad
// (the slab test with no window); the slabs' ends on each axis in n, f.
static __device__ __forceinline__ bool line_meets(const float* b,
                                                  const CullRay& r, float* n,
                                                  float* f) {
    float t0 = ((b[0] - r.ox) - r.m) * r.ix, t1 = ((b[3] - r.ox) + r.m) * r.ix;
    n[0] = fminf(t0, t1); f[0] = fmaxf(t0, t1);
    t0 = ((b[1] - r.oy) - r.m) * r.iy; t1 = ((b[4] - r.oy) + r.m) * r.iy;
    n[1] = fminf(t0, t1); f[1] = fmaxf(t0, t1);
    t0 = ((b[2] - r.oz) - r.m) * r.iz; t1 = ((b[5] - r.oz) + r.m) * r.iz;
    n[2] = fminf(t0, t1); f[2] = fmaxf(t0, t1);
    return fmaxf(fmaxf(n[0], n[1]), n[2]) <= fminf(fminf(f[0], f[1]), f[2]);
}

// Whether block b of the stage can hold a triangle that the watertight
// test hits with tmin < t < gate (see the header; DEF: the box part).
template <bool DEF>
static __device__ __forceinline__ bool keep_block(const StagedTris& s, int b,
                                                  int count,
                                                  const CullRay& r,
                                                  float gate) {
    float n[3], f[3];
    const bool n_ok = line_meets(s.box[b], r, n, f);
    const float zl = r.kz == 0 ? n[0] : (r.kz == 1 ? n[1] : n[2]);
    const float zh = r.kz == 0 ? f[0] : (r.kz == 1 ? f[1] : f[2]);
    const float ext = zh - zl;
    const float slack = T_REL * (fabsf(zl) + fabsf(zh));
    const float lower = (zl - ext) - slack;
    const float upper = (zh + ext) + slack;
    if (!(lower < gate && upper > r.tmin)) return false;
    if (n_ok) return true;  // the wide box holds the narrow one
    if (!line_meets(s.wbox[b], r, n, f)) return false;
    if (DEF) return true;  // no edge-on bound for a moving triangle
    // edge-on: |normal . d| < (K + (B + G E) E) |d| for one triangle
    const float e = EPS_E * (s.geo[b][3] + r.mo);
    const float thr =
        (s.geo[b][0] + (s.geo[b][1] + s.geo[b][2] * e) * e) * r.dn;
    const int kend = min(b * TRI_BLOCK + TRI_BLOCK, count);
    bool edge_on = false;
    for (int k = b * TRI_BLOCK; k < kend; ++k)
        edge_on |= !(fabsf(dot3(s.nrm[k][0], s.nrm[k][1], s.nrm[k][2], r.dx,
                                r.dy, r.dz)) >= thr);
    return edge_on;
}

// Position of the n-th (from 0) set bit of m; m has more than n set bits.
static __device__ __forceinline__ int nth_set_bit(unsigned int m, int n) {
    int pos = 0;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
        if (__popc(m & ((1u << (pos + w)) - 1u)) <= n) pos += w;
    return pos;
}

// Lane src's shear basis, to every thread of the warp.
static __device__ __forceinline__ WtRay shfl_ray(const WtRay& w, int src) {
    WtRay r;
    r.rx0 = __shfl_sync(FULL_MASK, w.rx0, src);
    r.rx1 = __shfl_sync(FULL_MASK, w.rx1, src);
    r.rx2 = __shfl_sync(FULL_MASK, w.rx2, src);
    r.ry0 = __shfl_sync(FULL_MASK, w.ry0, src);
    r.ry1 = __shfl_sync(FULL_MASK, w.ry1, src);
    r.ry2 = __shfl_sync(FULL_MASK, w.ry2, src);
    r.rz0 = __shfl_sync(FULL_MASK, w.rz0, src);
    r.rz1 = __shfl_sync(FULL_MASK, w.rz1, src);
    r.rz2 = __shfl_sync(FULL_MASK, w.rz2, src);
    r.rxo = __shfl_sync(FULL_MASK, w.rxo, src);
    r.ryo = __shfl_sync(FULL_MASK, w.ryo, src);
    r.rzo = __shfl_sync(FULL_MASK, w.rzo, src);
    r.degenerate = __shfl_sync(FULL_MASK, (int)w.degenerate, src) != 0;
    return r;
}

// The corners of staged triangle k for a lane of time tm, into c: the
// staged corners, or (DEF) its v0, e1, e2 moved segment by segment,
// v + w_g dv_g, then v0, v0 + e1, v0 + e2.
template <bool DEF>
static __device__ __forceinline__ void tri_corners(const StagedTris& s,
                                                   const DeformPath& dp,
                                                   int k, float tm,
                                                   float* c) {
    if (!DEF) {
#pragma unroll
        for (int j = 0; j < 9; ++j) c[j] = s.c[k][j];
        return;
    }
    float x[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) x[j] = s.c[k][j];
    for (int g = 0; g < dp.S1; ++g) {
        const float w =
            dp.S1 == 1 ? tm
                       : fminf(fmaxf(tm * (float)dp.S1 - (float)g, 0.0f),
                               1.0f);
        const float* dg = dp.dl + (size_t)(k * dp.S1 + g) * 9;
#pragma unroll
        for (int j = 0; j < 9; ++j) x[j] = x[j] + w * dg[j];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        c[j] = x[j];
        c[3 + j] = x[j] + x[3 + j];
        c[6 + j] = x[j] + x[6 + j];
    }
}

// The corners a test takes: the lerped ones in c (DEF), else staged
// triangle k's, read from shared memory at the call as before the deform
// modes existed (DEF is a template constant: the choice folds away)
#define CORNERS(c, s, k)                                                    \
    (DEF ? c[0] : s.c[k][0]), (DEF ? c[1] : s.c[k][1]),                     \
        (DEF ? c[2] : s.c[k][2]), (DEF ? c[3] : s.c[k][3]),                 \
        (DEF ? c[4] : s.c[k][4]), (DEF ? c[5] : s.c[k][5]),                 \
        (DEF ? c[6] : s.c[k][6]), (DEF ? c[7] : s.c[k][7]),                 \
        (DEF ? c[8] : s.c[k][8])

// The render modes' arguments (one struct: the kernel takes them by value)
struct DenseArgs {
    const float* tri_verts;
    const int* prim_object;
    const int* obj_vis;               // null: no visibility masks
    const unsigned char* boundary;    // dual
    int P;
    const float* o;
    const float* d;
    const float* tmin;
    const float* tmax;                // dual: tmax of the closest window
    const float* tmax_any;            // dual
    const int* vis;                   // dual: the closest window's
    const int* vis_any;               // dual
    int n;
    int rounds;                       // 128-lane rounds per block
    const float* steps;               // DEF: (S1, P, 3, 3)
    int S1;                           // DEF: segments of the path
    const float* time;                // DEF: the lanes' times
    float* t;                         // dual: t_boundary
    int* prim;
    float* u;
    float* v;
    int* obj;
    float* t_other;                   // dual
    unsigned char* blocked;           // any, dual
    int* counts;
};

template <int MODE>
static __device__ __forceinline__ bool lane_live(const DenseArgs& a, int i) {
    const float tmin = a.tmin[i];
    if (MODE == MODE_CLOSEST) return fminf(a.tmax[i], RT_RAY_TMAX) > tmin;
    if (MODE == MODE_ANY) return a.tmax[i] > tmin;
    return a.tmax[i] > tmin || a.tmax_any[i] > tmin;
}

// The result of a lane whose window is empty (the plain version's).
template <int MODE, bool COUNT>
static __device__ __forceinline__ void write_empty(const DenseArgs& a,
                                                   int i) {
    if (MODE == MODE_CLOSEST) {
        a.t[i] = fminf(a.tmax[i], RT_RAY_TMAX);
        a.prim[i] = -1;
        a.u[i] = 0.0f;
        a.v[i] = 0.0f;
        a.obj[i] = -1;
    } else if (MODE == MODE_ANY) {
        a.blocked[i] = 0;
    } else {
        a.t[i] = RT_RAY_TMAX;
        a.t_other[i] = RT_RAY_TMAX;
        a.blocked[i] = 0;
    }
    if (COUNT) {
        a.counts[3 * i] = 0;
        a.counts[3 * i + 1] = 0;
        a.counts[3 * i + 2] = 0;
    }
}

template <int MODE, bool COUNT, bool DEF>
__global__ void __launch_bounds__(BLOCK) dense_kernel(const DenseArgs a) {
    __shared__ StagedTris s;
    extern __shared__ float dl_s[];  // DEF: STAGE x S1 x 9 deltas
    const DeformPath dp = {a.steps, a.S1, a.P, dl_s};
    __shared__ int wcount[MAX_ROUNDS * WARPS];
    __shared__ int live_list[MAX_ROUNDS * BLOCK];
    const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;

    // ---- gather the lanes with a window, in lane order ----
    const int base = blockIdx.x * a.rounds * BLOCK;
    unsigned int ballot[MAX_ROUNDS];
#pragma unroll
    for (int r = 0; r < MAX_ROUNDS; ++r) {
        const int i = base + r * BLOCK + tid;
        const bool in = r < a.rounds && i < a.n;
        const bool live = in && lane_live<MODE>(a, i);
        if (in && !live) write_empty<MODE, COUNT>(a, i);
        ballot[r] = __ballot_sync(FULL_MASK, live);
        if (wl == 0) wcount[r * WARPS + warp] = __popc(ballot[r]);
    }
    __syncthreads();
    int nlive = 0, offset[MAX_ROUNDS];
#pragma unroll
    for (int slot = 0; slot < MAX_ROUNDS * WARPS; ++slot) {
        if (slot % WARPS == warp) offset[slot / WARPS] = nlive;
        nlive += wcount[slot];
    }
#pragma unroll
    for (int r = 0; r < MAX_ROUNDS; ++r)
        if ((ballot[r] >> wl) & 1u)
            live_list[offset[r] + __popc(ballot[r] & ((1u << wl) - 1u))] =
                base + r * BLOCK + tid;
    __syncthreads();

    const bool use_vis = a.obj_vis != nullptr && a.vis != nullptr;
    for (int r0 = 0; r0 < nlive; r0 += BLOCK) {
        const bool act = r0 + tid < nlive;
        const int i = act ? live_list[r0 + tid] : 0;
        const float ox = act ? a.o[3 * i] : 0.0f,
                    oy = act ? a.o[3 * i + 1] : 0.0f,
                    oz = act ? a.o[3 * i + 2] : 0.0f;
        const float dx = act ? a.d[3 * i] : 1.0f,
                    dy = act ? a.d[3 * i + 1] : 0.0f,
                    dz = act ? a.d[3 * i + 2] : 0.0f;
        const float tmin = act ? a.tmin[i] : 0.0f;
        const float tm = (DEF && act) ? a.time[i] : 0.0f;
        const WtRay w = wt_setup(ox, oy, oz, dx, dy, dz);
        const CullRay cr = cull_ray(ox, oy, oz, dx, dy, dz, tmin);
        const float tmax = act ? a.tmax[i] : -1.0f;
        const float tmax_any =
            (MODE == MODE_DUAL && act) ? a.tmax_any[i] : -1.0f;
        const int vis = (act && a.vis) ? a.vis[i] : 0;
        const int vis_any = (MODE == MODE_DUAL && act) ? a.vis_any[i] : 0;
        // closest: the best hit; dual: t_boundary in bt, t_other in bo_t
        const float t0 = fminf(tmax, RT_RAY_TMAX);
        float bt = MODE == MODE_CLOSEST ? t0 : RT_RAY_TMAX, bu = 0.0f,
              bv = 0.0f, bo_t = RT_RAY_TMAX;
        int bp = -1;
        bool blocked = false;
        int tested = 0, kept = 0, unions = 0;
        for (int pbase = 0; pbase < a.P; pbase += STAGE) {
            const int count = min(STAGE, a.P - pbase);
            stage_tris<DEF>(s, a.tri_verts, a.prim_object, a.obj_vis,
                            MODE == MODE_DUAL ? a.boundary : nullptr, pbase,
                            count, dp);
            const int nb = (count + TRI_BLOCK - 1) / TRI_BLOCK;
            for (int b = 0; b < nb; ++b) {
                if (MODE == MODE_ANY &&
                    __all_sync(FULL_MASK, !act || blocked))
                    break;
                float gate;
                int mask = vis;
                if (MODE == MODE_CLOSEST) {
                    gate = bt;
                } else if (MODE == MODE_ANY) {
                    gate = blocked ? -RT_INF : tmax;
                } else {
                    gate = fmaxf(fminf(fmaxf(bt, bo_t), tmax),
                                 blocked ? -RT_INF : tmax_any);
                    mask = vis | vis_any;
                }
                const bool vis_ok =
                    (MODE != MODE_DUAL && !use_vis) || (s.bvis[b] & mask) != 0;
                const bool keep = act && vis_ok &&
                                  keep_block<DEF>(s, b, count, cr, gate);
                const unsigned int km = __ballot_sync(FULL_MASK, keep);
                if (COUNT) {
                    kept += keep ? 1 : 0;
                    unions += km ? 1 : 0;
                }
                if (km == 0u) continue;
                const int kend = min(b * TRI_BLOCK + TRI_BLOCK, count);
                const int nk = __popc(km);
                if (nk <= SPREAD_MAX) {
                    // ---- the block's (lane, triangle) tests over the warp:
                    // pair j tests triangle j % 8 for the (j / 8)-th lane
                    // that keeps the block; each group of 8 threads then
                    // reduces its lane's 8 results by the mode's rule, and
                    // the lane takes them ----
                    if (COUNT && keep)
                        for (int k = b * TRI_BLOCK; k < kend; ++k)
                            if (s.obj[k] >= 0 &&
                                (MODE == MODE_DUAL || !use_vis ||
                                 (s.vis[k] & vis) != 0))
                                ++tested;
                    const int slot = __popc(km & ((1u << wl) - 1u));
                    for (int j0 = 0; j0 < nk * TRI_BLOCK; j0 += 32) {
                        const int j = j0 + wl;
                        const int src = nth_set_bit(
                            km, min(j / TRI_BLOCK, nk - 1));
                        const WtRay ws = shfl_ray(w, src);
                        const float s_tmin = __shfl_sync(FULL_MASK, tmin, src);
                        const float s_tmax = __shfl_sync(FULL_MASK, tmax, src);
                        const int s_vis = __shfl_sync(FULL_MASK, vis, src);
                        const float s_tm =
                            DEF ? __shfl_sync(FULL_MASK, tm, src) : 0.0f;
                        const int k = b * TRI_BLOCK + j % TRI_BLOCK;
                        const bool pair = j < nk * TRI_BLOCK && k < kend &&
                                          s.obj[k] >= 0;
                        const int from = slot * TRI_BLOCK - j0;
                        const bool mine = keep && from >= 0 && from < 32;
                        const int fsrc = mine ? from : 0;
                        float t, u, v, c[9];
                        if (DEF && pair) tri_corners<DEF>(s, dp, k, s_tm, c);
                        if (MODE == MODE_CLOSEST) {
                            const float s_bt = __shfl_sync(FULL_MASK, bt, src);
                            float tk = RT_RAY_TMAX, uk = 0.0f, vk = 0.0f;
                            int kk = -1;
                            if (pair && (!use_vis || (s.vis[k] & s_vis) != 0) &&
                                wt_tri_c(ws, CORNERS(c, s, k), s_tmin, s_bt, &t,
                                         &u, &v)) {
                                tk = t; kk = k; uk = u; vk = v;
                            }
                            // the block-of-8 rule: the smallest t; among
                            // ties the highest index, u and v each the
                            // largest (order free)
#pragma unroll
                            for (int off = TRI_BLOCK / 2; off > 0; off >>= 1) {
                                const float ot = __shfl_xor_sync(FULL_MASK, tk, off);
                                const int ok = __shfl_xor_sync(FULL_MASK, kk, off);
                                const float ou = __shfl_xor_sync(FULL_MASK, uk, off);
                                const float ov = __shfl_xor_sync(FULL_MASK, vk, off);
                                if (ot < tk) {
                                    tk = ot; kk = ok; uk = ou; vk = ov;
                                } else if (ot == tk) {
                                    kk = max(kk, ok);
                                    uk = fmaxf(uk, ou);
                                    vk = fmaxf(vk, ov);
                                }
                            }
                            tk = __shfl_sync(FULL_MASK, tk, fsrc);
                            kk = __shfl_sync(FULL_MASK, kk, fsrc);
                            uk = __shfl_sync(FULL_MASK, uk, fsrc);
                            vk = __shfl_sync(FULL_MASK, vk, fsrc);
                            if (mine && tk < bt) {
                                bt = tk; bp = pbase + kk; bu = uk; bv = vk;
                            }
                        } else if (MODE == MODE_ANY) {
                            const bool hit =
                                pair && (!use_vis || (s.vis[k] & s_vis) != 0) &&
                                wt_tri_c(ws, CORNERS(c, s, k), s_tmin, s_tmax, &t,
                                         &u, &v);
                            const unsigned int hm = __ballot_sync(FULL_MASK, hit);
                            if (mine && ((hm >> from) & 0xFFu) != 0u)
                                blocked = true;
                        } else {
                            const float s_tmax_any =
                                __shfl_sync(FULL_MASK, tmax_any, src);
                            const int s_vis_any =
                                __shfl_sync(FULL_MASK, vis_any, src);
                            float tb = RT_RAY_TMAX, to = RT_RAY_TMAX;
                            bool hit_any = false;
                            if (pair && wt_tri_c(ws, CORNERS(c, s, k), s_tmin,
                                                 RT_RAY_TMAX, &t, &u, &v)) {
                                hit_any = t < s_tmax_any &&
                                          (s.vis[k] & s_vis_any) != 0;
                                if (t < s_tmax && (s.vis[k] & s_vis) != 0) {
                                    if (s.bnd[k]) tb = t;
                                    else to = t;
                                }
                            }
#pragma unroll
                            for (int off = TRI_BLOCK / 2; off > 0; off >>= 1) {
                                tb = fminf(tb, __shfl_xor_sync(FULL_MASK, tb, off));
                                to = fminf(to, __shfl_xor_sync(FULL_MASK, to, off));
                            }
                            tb = __shfl_sync(FULL_MASK, tb, fsrc);
                            to = __shfl_sync(FULL_MASK, to, fsrc);
                            const unsigned int hm =
                                __ballot_sync(FULL_MASK, hit_any);
                            if (mine) {
                                bt = fminf(bt, tb);
                                bo_t = fminf(bo_t, to);
                                if (((hm >> from) & 0xFFu) != 0u) blocked = true;
                            }
                        }
                    }
                    continue;
                }
                if (!keep) continue;
                if (MODE == MODE_CLOSEST) {
                    float tk = RT_RAY_TMAX, uk = 0.0f, vk = 0.0f;
                    int kk = -1;
                    for (int k = b * TRI_BLOCK; k < kend; ++k) {
                        if (s.obj[k] < 0) continue;
                        if (use_vis && (s.vis[k] & vis) == 0) continue;
                        if (COUNT) ++tested;
                        float t, u, v, c[9];
                        if (DEF) tri_corners<DEF>(s, dp, k, tm, c);
                        if (!wt_tri_c(w, CORNERS(c, s, k), tmin, bt, &t, &u,
                                      &v))
                            continue;
                        if (t < tk) {
                            tk = t; kk = k; uk = u; vk = v;
                        } else if (t == tk) {
                            kk = k; uk = fmaxf(uk, u); vk = fmaxf(vk, v);
                        }
                    }
                    if (tk < bt) {
                        bt = tk; bp = pbase + kk; bu = uk; bv = vk;
                    }
                } else if (MODE == MODE_ANY) {
                    for (int k = b * TRI_BLOCK; k < kend; ++k) {
                        if (s.obj[k] < 0) continue;
                        if (use_vis && (s.vis[k] & vis) == 0) continue;
                        if (COUNT) ++tested;
                        float t, u, v, c[9];
                        if (DEF) tri_corners<DEF>(s, dp, k, tm, c);
                        if (wt_tri_c(w, CORNERS(c, s, k), tmin, tmax, &t, &u,
                                     &v)) {
                            blocked = true;
                            break;
                        }
                    }
                } else {
                    for (int k = b * TRI_BLOCK; k < kend; ++k) {
                        if (s.obj[k] < 0) continue;
                        if (COUNT) ++tested;
                        float t, u, v, c[9];
                        if (DEF) tri_corners<DEF>(s, dp, k, tm, c);
                        if (!wt_tri_c(w, CORNERS(c, s, k), tmin, RT_RAY_TMAX,
                                      &t, &u, &v))
                            continue;
                        if (t < tmax_any && (s.vis[k] & vis_any) != 0)
                            blocked = true;
                        if (t < tmax && (s.vis[k] & vis) != 0) {
                            if (s.bnd[k]) bt = fminf(bt, t);
                            else bo_t = fminf(bo_t, t);
                        }
                    }
                }
            }
        }
        if (!act) continue;
        if (MODE == MODE_CLOSEST) {
            const bool hit = bt < t0 && bp >= 0;
            a.t[i] = bt;
            a.prim[i] = hit ? bp : -1;
            a.u[i] = bu;
            a.v[i] = bv;
            a.obj[i] = hit ? a.prim_object[bp] : -1;
        } else if (MODE == MODE_ANY) {
            a.blocked[i] = blocked ? 1 : 0;
        } else {
            a.t[i] = bt;
            a.t_other[i] = bo_t;
            a.blocked[i] = blocked ? 1 : 0;
        }
        if (COUNT) {
            a.counts[3 * i] = tested;
            a.counts[3 * i + 1] = kept;
            a.counts[3 * i + 2] = unions;
        }
    }
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

#define GRID(n) (((n) + BLOCK - 1) / BLOCK)

// Lanes per block of the render modes: one 128-lane round while the grid
// has fewer than 4 blocks per SM, up to MAX_ROUNDS rounds beyond that (a
// longer list to compact, fewer re-stagings of the triangles).
static int rounds_for(int n) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms <= 0) sms = 132;
    }
    const int r = n / (BLOCK * 4 * sms);
    return r < 1 ? 1 : (r > MAX_ROUNDS ? MAX_ROUNDS : r);
}

template <int MODE, bool COUNT, bool DEF>
static int launch_variant(const DenseArgs& a, int grid, void* stream) {
    const size_t smem = DEF ? (size_t)STAGE * 9 * a.S1 * sizeof(float) : 0;
    if (DEF) {
        const cudaError_t err = cudaFuncSetAttribute(
            dense_kernel<MODE, COUNT, DEF>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dense_kernel<MODE, COUNT, DEF>
        <<<grid, BLOCK, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

template <int MODE>
static int launch_dense(DenseArgs a, void* stream) {
    if (a.n <= 0) return 0;
    const bool def = a.steps != nullptr;
    if (def && (a.S1 < 1 || a.S1 > MAX_SEGMENTS || a.time == nullptr))
        return (int)cudaErrorInvalidValue;
    a.rounds = rounds_for(a.n);
    const int grid = (a.n + a.rounds * BLOCK - 1) / (a.rounds * BLOCK);
    auto* fn = a.counts ? (def ? launch_variant<MODE, true, true>
                               : launch_variant<MODE, true, false>)
                        : (def ? launch_variant<MODE, false, true>
                               : launch_variant<MODE, false, false>);
    return fn(a, grid, stream);
}

extern "C" int rt_dense_closest(const float* tri_verts, const int* prim_object,
                                const int* obj_vis, int P, const float* o,
                                const float* d, const float* tmin,
                                const float* tmax, const int* vis, int n,
                                float* t, int* prim, float* u, float* v,
                                int* obj, int* counts, const float* steps,
                                int S1, const float* time, void* stream) {
    DenseArgs a = {};
    a.tri_verts = tri_verts; a.prim_object = prim_object; a.obj_vis = obj_vis;
    a.P = P; a.o = o; a.d = d; a.tmin = tmin; a.tmax = tmax; a.vis = vis;
    a.n = n; a.t = t; a.prim = prim; a.u = u; a.v = v; a.obj = obj;
    a.counts = counts; a.steps = steps; a.S1 = S1; a.time = time;
    return launch_dense<MODE_CLOSEST>(a, stream);
}

extern "C" int rt_dense_any(const float* tri_verts, const int* prim_object,
                            const int* obj_vis, int P, const float* o,
                            const float* d, const float* tmin,
                            const float* tmax, const int* vis, int n,
                            unsigned char* blocked, int* counts,
                            const float* steps, int S1, const float* time,
                            void* stream) {
    DenseArgs a = {};
    a.tri_verts = tri_verts; a.prim_object = prim_object; a.obj_vis = obj_vis;
    a.P = P; a.o = o; a.d = d; a.tmin = tmin; a.tmax = tmax; a.vis = vis;
    a.n = n; a.blocked = blocked; a.counts = counts;
    a.steps = steps; a.S1 = S1; a.time = time;
    return launch_dense<MODE_ANY>(a, stream);
}

extern "C" int rt_dense_dual(const float* tri_verts, const int* prim_object,
                             const int* obj_vis, const unsigned char* boundary,
                             int P, const float* o, const float* d,
                             const float* tmin, const float* tmaxc,
                             const float* tmaxa, const int* visc,
                             const int* visa, int n, float* tb, float* to,
                             unsigned char* blocked, int* counts,
                             const float* steps, int S1, const float* time,
                             void* stream) {
    DenseArgs a = {};
    a.tri_verts = tri_verts; a.prim_object = prim_object; a.obj_vis = obj_vis;
    a.boundary = boundary; a.P = P; a.o = o; a.d = d; a.tmin = tmin;
    a.tmax = tmaxc; a.tmax_any = tmaxa; a.vis = visc; a.vis_any = visa;
    a.n = n; a.t = tb; a.t_other = to; a.blocked = blocked;
    a.counts = counts; a.steps = steps; a.S1 = S1; a.time = time;
    return launch_dense<MODE_DUAL>(a, stream);
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
