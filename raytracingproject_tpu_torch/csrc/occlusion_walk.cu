// K3: dual-reduction occlusion walk (NEE shadow test).
//
// Replaces the TPU kernel raytracingproject_tpu/ops/pallas_cluster.py:759
// occlusion_clusters_pallas / _occlusion_kernel (:624). Same contract as
// the plain walk ops/cluster_intersect.py occlusion_clusters: per lane, two
// masked minima over camera-visible hits inside [tmin, tmax_closest]
// (volume-boundary prims -> t_boundary, the rest -> t_other) and an
// any-hit OR under vis_any inside [tmin, tmax_any]. Single-level tables of
// up to 640 clusters (the JAX package's single-level cap), with instance
// rows or motion rows or neither.
//
// What bounds it on the H100: latency of the row reads, not bytes or
// operations. The tables stay in L2 (138 KB for glossy); a lane tests
// boxes from shared memory and reads the rows of the clusters its segment
// enters. Read one float at a time by each lane from its own row, those
// reads are 32 separate cache lines per warp load, none coalesced. The
// surface NEE calls it with an empty closest window, where an unblocked
// lane must test every cluster its segment enters.
//
// Design: a warp walks the clusters together, in table order (the BVH's
// depth-first order, so neighbouring clusters are neighbours in space).
// The outputs are order-free reductions, so the lanes need no
// front-to-back order. For each cluster every live lane tests the box
// against its own gate -- the largest t that could still tighten a minimum
// or, while unblocked, find the any-hit (the TPU kernel's gate,
// pallas_cluster.py:672-678) -- and __ballot_sync collects the lanes that
// need the cluster. If none does, the warp moves on. Otherwise the warp
// copies the columns K3 reads (vertices, prim ids, visibility, and the
// cluster's row of cboundary) into a per-warp buffer in shared memory with
// coalesced loads. The gate only shrinks, so a cluster skipped once could
// never matter later. A lane whose gate falls to tmin (with the closest
// window empty: its first accepted any-hit) leaves the walk; the warp
// stops when no lane is live. Lanes past n take part in every ballot as
// not live.
//
// Split triangle tests: the counts (PERF.md) show that a lane tests about
// one row and that a staged row is tested by about six of its warp's 32
// lanes, so testing it lane by lane takes ct serial steps with most
// threads idle. The row's tests are spread over the warp instead: with k
// needing lanes the k x ct (lane, triangle) pairs go to the 32 threads in
// rounds (four for six lanes at 15 triangles, one for up to two). Each
// thread tests its pair's triangle against that lane's ray, read from the
// warp's ray table in shared memory (written once at the start), and
// writes t and the hit's flags (closest-window boundary / other hit,
// any-hit) to a per-warp result slot; each needing lane then folds its
// pairs' results into its own minima and OR. A lane's gate and liveness
// change only when it has tested a row, so both stay in registers and the
// warp asks whether any lane is still live only after a staged row. Every
// (lane, triangle) test is the one-lane design's test with the same
// arithmetic, and minima and OR do not depend on their order, so t_b, t_o
// and blocked are those of the plain version to the bit, in the surface
// and the dual form.
//
// Instance rows (INST): a row's first 12 floats are its instance's
// world->object matrix (row-major 3x4). Boxes are world boxes, so the
// gate, the ballot and the staging do not change. Once the row is staged,
// each needing lane transforms its own world ray by the row's matrix
// (m[0]*ox + m[1]*oy + m[2]*oz + m[3], left to right as in the plain
// version; the direction is not renormalised, so t stays in world units)
// and rewrites its slot of the warp's ray table with the shear basis of
// that ray, unless the matrix's 12 floats are bit for bit the ones the
// slot holds (an instance's clusters are neighbours in the table). The
// pair rounds then read the slot as without instances. A slot is read
// only by the pairs of its own lane, and only in rounds of a row that
// lane needs, so a stale slot is never read.
//
// Motion rows (MOT; the TPU kernel's has_motion branch, :723): the warp
// stages each triangle's shutter deltas after the vertices (21 floats a
// triangle in place of 12: 1,260 bytes at ct = 15, against 720), and each
// lane writes its ray's time into float 16 of its slot of the ray table
// (the padding of RAY_STRIDE). A pair lerps its triangle to its lane's
// time, v + time * dv per component, before the test (the plain
// version's order). Boxes cover both shutter ends: the gate, the ballot
// and the staging order do not change. Motion rows never carry instances
// (the entry point refuses the two together).
//
// The counting variant (COUNT) also writes per lane the rows it tested,
// the boxes it tested and the rows its warp staged, into counts[3 * lane].
//
// Registers and spills (ptxas -v, CUDA 12.8, sm_90a): 64 registers, no
// spills, in both variants; with instance rows 80; motion rows: PERF.md
// section 6; chip_smoke.py prints the build log.
#include "watertight.cuh"

#define K3_WARPS 4  // warps per block
#define RT_FULL_MASK 0xFFFFFFFFu

static __device__ __forceinline__ float occ_gate(float t_b, float t_o,
                                                 bool blocked, float tmaxc,
                                                 float tmaxa) {
    const float g = fmaxf(fminf(t_b, tmaxc), fminf(t_o, tmaxc));
    return blocked ? g : fmaxf(g, tmaxa);
}

// Shared memory of one warp, in floats: the staged columns of one cluster
// (per triangle k of ct: the vertices at 9k, with motion rows their deltas
// at 9ct + 9k; then with TW = 9, or 18 with motion rows, the prim id at
// TW ct + k, the visibility at (TW + 1) ct + k and the boundary flag at
// (TW + 2) ct + k), the warp's rays (RAY_STRIDE floats a lane: the shear
// basis, the degenerate flag, tmin, tmax_closest, tmax_any, the time),
// the round's results (t and flags a thread) and the lane of each needing
// rank.
#define RAY_STRIDE 17  // odd: no bank conflicts by lane
#define HIT_BOUNDARY 1
#define HIT_OTHER 2
#define HIT_ANY 4
// A lane's slot of the warp's ray table: the shear basis and the
// degenerate flag (floats 0-12; 13-15 hold the lane's window)
static __device__ __forceinline__ void store_ray(float* my, const WtRay& w) {
    my[0] = w.rx0; my[1] = w.rx1; my[2] = w.rx2;
    my[3] = w.ry0; my[4] = w.ry1; my[5] = w.ry2;
    my[6] = w.rz0; my[7] = w.rz1; my[8] = w.rz2;
    my[9] = w.rxo; my[10] = w.ryo; my[11] = w.rzo;
    my[12] = w.degenerate ? 1.0f : 0.0f;
}

static __host__ __device__ __forceinline__ int stage_floats(int ct,
                                                            bool motion) {
    return (motion ? 21 : 12) * ct;
}
static __host__ __device__ __forceinline__ int warp_floats(int ct,
                                                           bool motion) {
    return stage_floats(ct, motion) + 32 * RAY_STRIDE + 3 * 32;
}

template <bool COUNT, bool INST, bool MOT>
__global__ void occlusion_walk_kernel(
    const float* __restrict__ cbounds, const float* __restrict__ ctable,
    const float* __restrict__ cboundary, int C, int W, int ct,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin_a, const float* __restrict__ tmaxc_a,
    const float* __restrict__ tmaxa_a, const float* __restrict__ time_a,
    int n, int vis_closest, int vis_any,
    float* __restrict__ tb_out, float* __restrict__ to_out,
    bool* __restrict__ blk_out, int* __restrict__ counts) {
    extern __shared__ float smem[];
    float* sb = smem;
    const int lane = threadIdx.x & 31;
    constexpr int TW = MOT ? 18 : 9;  // floats a staged triangle
    float* buf = smem + C * 6 + (threadIdx.x >> 5) * warp_floats(ct, MOT);
    float* rays = buf + stage_floats(ct, MOT);
    float* res_t = rays + 32 * RAY_STRIDE;
    int* res_f = (int*)(res_t + 32);
    int* lane_of = res_f + 32;
    for (int i = threadIdx.x; i < C * 6; i += blockDim.x) sb[i] = cbounds[i];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool in = i < n;
    const int r = in ? i : 0;

    const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
    const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
    const float tmin = tmin_a[r], tmaxc = tmaxc_a[r], tmaxa = tmaxa_a[r];
    const float need_t = fmaxf(tmaxc, tmaxa);
    float* my = rays + lane * RAY_STRIDE;
    if (!INST) store_ray(my, wt_setup(ox, oy, oz, dx, dy, dz));
    my[13] = tmin; my[14] = tmaxc; my[15] = tmaxa;
    if (MOT) my[16] = time_a[r];
    W2oCache wc;  // the w2o bits the lane's slot was last built from (INST)
    __syncthreads();  // the bounds and the warp's rays are in place
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

    float t_b = RT_RAY_TMAX, t_o = RT_RAY_TMAX;
    bool blocked = false;
    int rows = 0, boxes = 0, staged = 0;
    const int vcol = RT_META_COLS + (TW + 2) * ct;
    const float* pid_s = buf + TW * ct;
    const float* vis_s = buf + (TW + 1) * ct;
    const float* bnd_s = buf + (TW + 2) * ct;
    float g = occ_gate(t_b, t_o, blocked, tmaxc, tmaxa);
    bool live = in && g > tmin;
    bool any_live = __ballot_sync(RT_FULL_MASK, live) != 0u;
    for (int c = 0; any_live && c < C; ++c) {
        bool need = false;
        if (live) {
            need = slab_entry(sb + 6 * c, ox, oy, oz, ix, iy, iz, tmin,
                              need_t) < g;
            if (COUNT) ++boxes;
        }
        const unsigned int m = __ballot_sync(RT_FULL_MASK, need);
        if (m == 0u) continue;
        if (COUNT) {
            ++staged;
            if (need) ++rows;
        }
        // stage the cluster's columns, lanes striding (coalesced)
        const float* row = ctable + (size_t)c * W;
        for (int k = lane; k < (TW + 1) * ct; k += 32)
            buf[k] = __ldg(row + RT_META_COLS + k);
        for (int k = lane; k < ct; k += 32) {
            buf[(TW + 1) * ct + k] = __ldg(row + vcol + k);
            buf[(TW + 2) * ct + k] = __ldg(cboundary + (size_t)c * ct + k);
        }
        const int rank = __popc(m & ((1u << lane) - 1u));
        if (need) lane_of[rank] = lane;
        if (INST && need) {
            float w2o[12];
#pragma unroll
            for (int k = 0; k < 12; ++k) w2o[k] = __ldg(row + k);
            WtRay w;
            if (w2o_update(wc, w2o, ox, oy, oz, dx, dy, dz, &w))
                store_ray(my, w);
        }
        __syncwarp();
        // the (needing lane, triangle) pairs, 32 a round
        const int pairs = __popc(m) * ct;
        for (int base = 0; base < pairs; base += 32) {
            const int p = base + lane;
            float t = 0.0f;
            int f = 0;
            if (p < pairs) {
                const int q = p / ct, k = p - q * ct;
                if (pid_s[k] >= 0.0f) {
                    const float* ry = rays + lane_of[q] * RAY_STRIDE;
                    WtRay w;
                    w.rx0 = ry[0]; w.rx1 = ry[1]; w.rx2 = ry[2];
                    w.ry0 = ry[3]; w.ry1 = ry[4]; w.ry2 = ry[5];
                    w.rz0 = ry[6]; w.rz1 = ry[7]; w.rz2 = ry[8];
                    w.rxo = ry[9]; w.ryo = ry[10]; w.rzo = ry[11];
                    w.degenerate = ry[12] != 0.0f;
                    float u, v;
                    if (wt_tri_at<MOT>(w, buf + 9 * k, buf + 9 * (ct + k),
                                       MOT ? ry[16] : 0.0f, ry[13],
                                       RT_RAY_TMAX, &t, &u, &v)) {
                        const int tv = (int)vis_s[k];
                        if (t < ry[14] && (tv & vis_closest) != 0)
                            f = bnd_s[k] > 0.0f ? HIT_BOUNDARY : HIT_OTHER;
                        if (t < ry[15] && (tv & vis_any) != 0) f |= HIT_ANY;
                    }
                }
            }
            res_t[lane] = t;
            res_f[lane] = f;
            __syncwarp();
            if (need) {  // fold this lane's pairs of the round
                const int lo = max(rank * ct, base) - base;
                const int hi = min(rank * ct + ct, base + 32) - base;
                for (int x = lo; x < hi; ++x) {
                    const int fx = res_f[x];
                    if (fx & HIT_BOUNDARY) t_b = fminf(t_b, res_t[x]);
                    if (fx & HIT_OTHER) t_o = fminf(t_o, res_t[x]);
                    if (fx & HIT_ANY) blocked = true;
                }
            }
            __syncwarp();  // results and buffer read before they change
        }
        if (need) {
            g = occ_gate(t_b, t_o, blocked, tmaxc, tmaxa);
            live = g > tmin;
        }
        any_live = __ballot_sync(RT_FULL_MASK, live) != 0u;
    }
    if (!in) return;
    tb_out[i] = t_b;
    to_out[i] = t_o;
    blk_out[i] = blocked;
    if (COUNT) {
        counts[3 * i] = rows;
        counts[3 * i + 1] = boxes;
        counts[3 * i + 2] = staged;
    }
}

template <bool COUNT, bool INST, bool MOT>
static void launch(int grid, int block, size_t smem, cudaStream_t stream,
                   const float* cbounds, const float* ctable,
                   const float* cboundary, int C, int W, int ct,
                   const float* o, const float* d, const float* tmin,
                   const float* tmaxc, const float* tmaxa, const float* time,
                   int n, int vis_closest, int vis_any, float* tb, float* to,
                   bool* blocked, int* counts) {
    occlusion_walk_kernel<COUNT, INST, MOT><<<grid, block, smem, stream>>>(
        cbounds, ctable, cboundary, C, W, ct, o, d, tmin, tmaxc, tmaxa, time,
        n, vis_closest, vis_any, tb, to, blocked, counts);
}

extern "C" int rt_occlusion_walk(const float* cbounds, const float* ctable,
                                 const float* cboundary, int C, int W, int ct,
                                 const float* o, const float* d,
                                 const float* tmin, const float* tmaxc,
                                 const float* tmaxa, int n, int vis_closest,
                                 int vis_any, int instances, int motion,
                                 const float* time, float* tb, float* to,
                                 bool* blocked, int* counts, void* stream) {
    if (n <= 0) return 0;
    if (instances && motion) return (int)cudaErrorInvalidValue;
    const int block = K3_WARPS * 32;
    const int grid = (n + block - 1) / block;
    const size_t smem = ((size_t)C * 6 + (size_t)K3_WARPS *
                                             warp_floats(ct, motion != 0)) *
                        sizeof(float);
    auto* fn = counts ? (instances ? launch<true, true, false>
                                   : motion ? launch<true, false, true>
                                            : launch<true, false, false>)
                      : (instances ? launch<false, true, false>
                                   : motion ? launch<false, false, true>
                                            : launch<false, false, false>);
    fn(grid, block, smem, (cudaStream_t)stream, cbounds, ctable, cboundary, C,
       W, ct, o, d, tmin, tmaxc, tmaxa, time, n, vis_closest, vis_any, tb, to,
       blocked, counts);
    return (int)cudaGetLastError();
}
