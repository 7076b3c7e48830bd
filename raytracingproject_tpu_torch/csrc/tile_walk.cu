// K4: tile-shared single-level cluster walk, closest hit or any hit.
//
// Replaces the TPU kernel raytracingproject_tpu/ops/pallas_cluster.py
// intersect_clusters_pallas / _cluster_kernel. Same contract as the plain
// walk ops/cluster_intersect.py intersect_clusters (single-level cluster
// tables with C <= 640, the JAX package's single-level cap, with
// instance rows or motion rows or neither).
//
// What the TPU kernel does: a tile of 1,024 rays keeps a (C, tile) table
// of entry distances in VMEM; each step it takes the cluster whose masked
// entry (entry < the lane's best t, or nothing for a lane that already
// has its any hit) is smallest over the whole tile, tests every lane of
// the tile against that one row, and retires the cluster for the tile.
//
// Design here: the tile is one warp of 32 rays, and each step picks what
// the TPU kernel's step picks: the lexicographic minimum (entry, cluster)
// over the lanes' smallest unretired entries below their gates.
//   - The earlier design kept a (C, 32) entry table per warp in shared
//     memory (80 KB at C = 640, 2 warps a block) and scanned a lane's
//     whole column on every step: C shared loads per lane per step.
//   - Now each lane keeps the K4_QUEUE smallest (entry, cluster) pairs of
//     a box pass, sorted in registers as 64-bit keys (csrc/pair_queue.cuh:
//     the entry's 32 bits, then the id; the order is exact for any cluster
//     id, unlike K2's 9-bit packed key). A step: each lane drops the
//     head pairs that are retired or not below its gate (and makes a new
//     box pass when its queue ran dry and a pair fell off its end), five
//     shuffles take the warp's minimum of the heads, the warp copies that
//     row into shared memory, every lane whose own entry into the cluster
//     (one slab test) is below its gate tests the row's triangles in
//     order with strict t < best, and lane 0 sets the cluster's bit in the
//     warp's retired bitmask (ceil(C / 32) words). The candidate sets only
//     shrink, so a lane's head is always what the table scan found, and
//     the warp visits the earlier design's clusters in its order.
//   - Shared memory: the cluster bounds once per block (C x 24 bytes, 15
//     KB at 640) and per warp a row and the bitmask, so 4 warps a block
//     at every C.
//   - The walk ends when no lane has a pair left, or after C steps.
// What bounds it on the H100: latency, not bytes. A warp's steps are
// serial: a dependent row copy and up to ct triangle tests, run for the
// warp whenever one lane tests the row; the tables (72 KB for volume_sss)
// stay in L2. A box pass runs the insertion network for the warp whenever
// one lane inserts, so a lane that needs a second pass holds its warp: the
// queue is long enough that none does on the render input.
//
// Instance rows (INST): a row's first 12 floats are its instance's
// world->object matrix. Boxes are world boxes, so the queues, the warp
// minimum and the retired bitmask do not change. A lane that tests the
// staged row first transforms its world ray by the matrix and rebuilds its
// shear basis (watertight.cuh w2o_setup), unless the 12 floats are bit for
// bit the ones it used last (an instance's clusters share them); t stays
// in world units.
//
// Motion rows (MOT; the TPU kernel's has_motion branch, :164): the staged
// row carries each triangle's shutter deltas after the triangles, and its
// prim ids start at 13 + 18 ct. Boxes cover both shutter ends, so the
// queues, the warp minimum and the retired bitmask do not change (the
// mirrors take the same picks); a lane that tests the row lerps each
// triangle to its time, v + time * dv per component, the plain version's
// order. Motion rows never carry instances (the entry point refuses the
// two together).
//
// The counting variant (COUNT) writes per lane the steps of its warp (rows
// fetched), the rows it tested, its box tests and its box passes, into
// counts[4 * lane]; ops/tile_walk.py tile_queue_order computes the same
// counts in plain torch.
//
// Rounding: the triangle and slab tests are the shared helpers of
// watertight.cuh, built with -fmad=false, so t, u, v equal the plain
// version's to the bit; prim and object (and t by an ulp, for coplanar
// triangles) can differ only where two clusters hold hits at the same t
// (the warp's visit order differs from the lane's). Every output equals
// tile_scan_order's on every lane.
#include "pair_queue.cuh"

#define TILE RT_TILE
#define K4_WARPS 4
#define K4_MAX_WORDS 20  // retired bitmask words: C <= 640
// Queue length (PERF.md section 6, compare_walks.py): at 12 no lane of
// volume_sss's render input makes a second pass, and 12 was the fastest of
// 4, 8, 12 and 16 there (at 80 registers; 123 with instance rows, no
// spills).
#ifndef K4_QUEUE
#define K4_QUEUE 12
#endif

template <int Q, bool COUNT, bool INST, bool MOT>
__global__ void __launch_bounds__(K4_WARPS* TILE) tile_walk_kernel(
    const float* __restrict__ cbounds, const float* __restrict__ ctable,
    int C, int W, int ct, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ tmin_a,
    const float* __restrict__ tmax_a, const int* __restrict__ vis_a,
    const float* __restrict__ time_a, int n,
    int any_hit, float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ obj_out, int* __restrict__ counts) {
    extern __shared__ float smem[];
    __shared__ unsigned int retired_all[K4_WARPS][K4_MAX_WORDS];
    const int lane = threadIdx.x & (TILE - 1);
    const int warp = threadIdx.x / TILE;
    float* sb = smem;
    float* row = smem + (size_t)C * 6 + (size_t)warp * W;
    unsigned int* retired = retired_all[warp];
    for (int k = threadIdx.x; k < C * 6; k += blockDim.x) sb[k] = cbounds[k];
    for (int k = lane; k < K4_MAX_WORDS; k += TILE) retired[k] = 0u;
    __syncthreads();
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;  // lanes past n walk along with no entries

    const float ox = live ? o[3 * i] : 0.0f, oy = live ? o[3 * i + 1] : 0.0f,
                oz = live ? o[3 * i + 2] : 0.0f;
    const float dx = live ? d[3 * i] : 1.0f, dy = live ? d[3 * i + 1] : 0.0f,
                dz = live ? d[3 * i + 2] : 0.0f;
    const float tmin = live ? tmin_a[i] : 0.0f;
    const float tmax = live ? tmax_a[i] : -1.0f;
    const int vis = live ? vis_a[i] : 0;
    const float tm = (MOT && live) ? time_a[i] : 0.0f;
    WtRay w = wt_setup(ox, oy, oz, dx, dy, dz);
    W2oCache wc;  // the w2o bits w was last built from (INST)
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    auto entry_of = [&](int c) {
        return slab_entry(sb + 6 * c, ox, oy, oz, ix, iy, iz, tmin, tmax);
    };

    float bt = fminf(tmax, RT_RAY_TMAX), bu = 0.0f, bv = 0.0f;
    int bp = -1, bo = -1;
    int steps = 0, rows = 0, boxes = 0, passes = 0;
    const int pbase = rt_prim_col(ct, MOT), obase = pbase + ct,
              vbase = obase + ct;
    RtLaneQueue<Q> queue;
    queue.init(live);
    for (int step = 0; step < C; ++step) {
        // the lane's gate: entries below its best t; none once an any-hit
        // lane has its hit
        const float gate = (any_hit && bp >= 0) ? -RT_INF : fminf(bt, RT_INF);
        const rt_key m = rt_warp_key_min(
            queue.head(retired, C, gate, entry_of, &passes, &boxes));
        if (m == RT_NO_KEY64) break;  // warp-uniform: no lane has a pair
        const int mc = rt_key_id(m);
        const float* grow = ctable + (size_t)mc * W;
        __syncwarp();  // every lane is done with the previous row
        for (int k = lane; k < W; k += TILE) row[k] = __ldg(grow + k);
        __syncwarp();
        if (COUNT) {
            ++steps;
            ++boxes;
        }
        if (live && entry_of(mc) < gate) {
            if (COUNT) ++rows;
            if (INST) w2o_update(wc, row, ox, oy, oz, dx, dy, dz, &w);
            for (int k = 0; k < ct; ++k) {
                const float pid = row[pbase + k];
                if (!(pid >= 0.0f)) continue;
                if (((int)row[vbase + k] & vis) == 0) continue;
                float t, u, v;
                if (wt_tri_at<MOT>(w, row + RT_META_COLS + 9 * k,
                                   row + RT_META_COLS + 9 * (ct + k), tm,
                                   tmin, bt, &t, &u, &v)) {
                    bt = t;
                    bp = (int)pid;
                    bu = u;
                    bv = v;
                    bo = (int)row[obase + k];
                }
            }
        }
        // retired for the whole warp; every lane is past its reads of the
        // bitmask (the shuffles above)
        if (lane == 0) retired[mc >> 5] |= 1u << (mc & 31);
        __syncwarp();
    }
    if (!live) return;
    t_out[i] = bt;
    prim_out[i] = bp;
    u_out[i] = bu;
    v_out[i] = bv;
    obj_out[i] = bo;
    if (COUNT) {
        counts[4 * i] = steps;
        counts[4 * i + 1] = rows;
        counts[4 * i + 2] = boxes;
        counts[4 * i + 3] = passes;
    }
}

template <bool COUNT, bool INST, bool MOT>
static int launch(const float* cbounds, const float* ctable, int C, int W,
                  int ct, const float* o, const float* d, const float* tmin,
                  const float* tmax, const int* vis, const float* time, int n,
                  int any_hit, float* t, int* prim, float* u, float* v,
                  int* obj, int* counts, cudaStream_t stream) {
    const size_t smem = ((size_t)C * 6 + (size_t)K4_WARPS * W) * sizeof(float);
    if (smem + sizeof(unsigned int) * K4_WARPS * K4_MAX_WORDS > 227 * 1024)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        tile_walk_kernel<K4_QUEUE, COUNT, INST, MOT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int block = K4_WARPS * TILE;
    const int grid = (n + block - 1) / block;
    tile_walk_kernel<K4_QUEUE, COUNT, INST, MOT>
        <<<grid, block, smem, stream>>>(cbounds, ctable, C, W, ct, o, d, tmin,
                                        tmax, vis, time, n, any_hit, t, prim,
                                        u, v, obj, counts);
    return (int)cudaGetLastError();
}

extern "C" int rt_tile_walk(const float* cbounds, const float* ctable, int C,
                            int W, int ct, const float* o, const float* d,
                            const float* tmin, const float* tmax,
                            const int* vis, int n, int any_hit,
                            int instances, int motion, const float* time,
                            float* t, int* prim, float* u, float* v, int* obj,
                            int* counts, void* stream) {
    if (n <= 0) return 0;
    if (C > K4_MAX_WORDS * 32) return (int)cudaErrorInvalidValue;
    if (instances && motion) return (int)cudaErrorInvalidValue;
    auto* fn = counts ? (instances ? launch<true, true, false>
                                   : motion ? launch<true, false, true>
                                            : launch<true, false, false>)
                      : (instances ? launch<false, true, false>
                                   : motion ? launch<false, false, true>
                                            : launch<false, false, false>);
    return fn(cbounds, ctable, C, W, ct, o, d, tmin, tmax, vis, time, n,
              any_hit, t, prim, u, v, obj, counts, (cudaStream_t)stream);
}
