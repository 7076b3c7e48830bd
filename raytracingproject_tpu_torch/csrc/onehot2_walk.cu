// K6: two-level cluster walk with a tile-shared supercluster pick and a
// per-lane walk inside each picked group; closest hit or any hit, with
// instance rows or motion rows.
//
// Replaces the TPU kernel raytracingproject_tpu/ops/pallas_onehot.py
// intersect_clusters2_onehot / _onehot2_kernel. Same contract as the plain
// walk ops/cluster_intersect.py intersect_clusters over all C clusters
// (the JAX package's own reference for that kernel): the exact closest (or
// any) hit, t = min(tmax, RAY_TMAX) and prim = object = -1 on a miss.
//
// What the TPU kernel computes: per tile of rays an outer loop picks the
// nearest live supercluster (the argmin over superclusters of the tile's
// masked entry distances) and brings that group's tables in once for the
// tile; inside the group every lane walks on its own, front to back: it
// keeps packed keys (f32 bits of its entry & ~0x1FF) | local cluster id,
// takes its smallest key, fetches that cluster's row, transforms its ray
// by an instance row's w2o, tests the row's triangles with strict t < best
// and retires every cluster whose entry is not below its best t. The
// bf16x3 split of the rows, their (W_pad, 128) transposition and the
// 128-column bounds padding feed the TPU's matrix unit and DMA alignment
// and are not carried: this kernel reads the f32 sc_bounds, cluster_bounds
// and cluster_table that K5 reads.
//
// Design here: a tile is one warp of 32 rays.
//   - Supercluster level: K5's (csrc/cluster2_walk.cu, csrc/pair_queue.cuh).
//     Each lane keeps the K6_QUEUE smallest (entry, supercluster) pairs of
//     a box pass in registers as exact 64-bit keys, the warp a retired
//     bitmask (SC <= 512 bits); a pick drops retired and gated heads,
//     refills a dry queue whose pairs fell off, and takes the warp's
//     minimum of the heads, ties to the smaller id. The supercluster boxes
//     sit in shared memory once a block. The first design kept a (SC, 32)
//     entry table per warp (68.6 KB at SC = 512) and scanned it on every
//     pick (watertight.cuh warp_pick); the order is the same.
//   - Group level: the warp copies the group's gcount x 6 bounds into its
//     shared memory. Each lane whose own entry into the supercluster is
//     below its gate walks the group alone, in packed-key order (K2's key,
//     watertight.cuh rt_pack_key): one box pass, segment capped by its gate
//     at group entry, keeps the K6_GQUEUE smallest keys above its last one
//     whose truncated entry is below its gate (rt_queue_insert), then pops
//     them; a popped key whose truncated entry has reached the gate is
//     dropped (the gate only falls, so it stays culled; a dropped key of
//     non-negative entry culls every later one, as in K2), and when the
//     queue runs dry while a key fell off its end the lane makes one more
//     pass above its last key. The first design rescanned all gcount boxes
//     for every visit; the keys visited are the same, in the same order.
//   - Row: every lane reads its own row (W floats, 1,876 bytes at 38
//     triangles) through the read-only path; the big_instanced table (1.9
//     MB) stays in L2. With instance rows a lane transforms its ray and
//     rebuilds its shear basis only at the first triangle of a row that it
//     tests (not skipped by prim id or visibility), and only when the
//     row's 12 w2o floats differ bit for bit from the ones it used last
//     (the clusters of one instance share them). The first design
//     transformed for every row.
//   - Shared memory: the supercluster table once a block (SC x 32 bytes),
//     per warp the group's bounds (gmax x 24 bytes) and the bitmask; 4
//     warps a block at every SC.
// What bounds it on the H100: latency. A lane's visits are serial, each a
// dependent, uncoalesced row read and up to ct triangle tests, and a warp
// takes as long as its slowest lane in every group any of its lanes walks
// (the visit order per lane is the contract; PERF.md records the warp's
// steps against the lanes'). The bytes (rays, results, tables once) take
// about a microsecond at 3.35 TB/s.
//
// Motion rows (MOT; the TPU kernel's has_motion branch, pallas_onehot.py
// :415 and :515): a row is 13 + 21 ct floats, each triangle's shutter
// deltas after the triangles, its prim ids from 13 + 18 ct. Boxes cover
// both shutter ends, so the supercluster queues and each lane's key order
// do not change (the mirrors take the same visits); a lane lerps each
// triangle it tests to its time, v + time * dv per component (watertight.cuh
// wt_tri_at, as K2-K5), the plain version's order. Motion rows never carry
// instances (the entry point refuses the two together). The TPU kernel
// reads a row through its bf16 thirds; this one reads the f32 row, so the
// row's width changes no shared memory here.
//
// The counting variant (COUNT) writes per lane the superclusters its warp
// entered, the groups it walked, its group-level box tests and box
// passes, the rows it read, the rows it tested (at least one triangle not
// skipped), the w2o transforms it computed and its supercluster passes,
// into counts[8 * lane]; ops/onehot2_walk.py onehot2_queue_order computes
// the same counts in plain torch.
//
// Rounding: the slab and triangle tests are watertight.cuh's, the
// transform is m[0]*ox + m[1]*oy + m[2]*oz + m[3] left to right as in the
// plain version, and the build uses -fmad=false, so t, u, v equal the
// plain version's to the bit; prim and object can differ only where two
// clusters hold hits at the same t. Every output equals
// onehot2_scan_order's (the first design's visit order) on every lane.
#include "pair_queue.cuh"

#define TILE RT_TILE
#define K6_WARPS 4
#define K6_MAX_WORDS 16  // supercluster bitmask words: SC <= 512
#define G_CAP 128        // clusters per supercluster (the JAX package's G_PAD)
// Queue lengths (PERF.md section 6, compare_walks.py --kernel k6): 8 and
// 8 were the fastest pair on the recorded big_instanced:onehot2 inputs.
// 8 keys make one supercluster pass a lane there and at SC = 512, where 4
// gave 1.004 passes a lane (at most 3), and a lane's second pass over 512
// boxes holds its whole warp. 118 registers, no spills.
#ifndef K6_QUEUE
#define K6_QUEUE 8
#endif
#ifndef K6_GQUEUE
#define K6_GQUEUE 8
#endif

template <int Q, int GQ, bool COUNT, bool MOT>
__global__ void __launch_bounds__(K6_WARPS* TILE) onehot2_walk_kernel(
    const float* __restrict__ scb, const float* __restrict__ cbounds,
    const float* __restrict__ ctable, int SC, int C, int W, int ct, int gmax,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin_a, const float* __restrict__ tmax_a,
    const int* __restrict__ vis_a, const float* __restrict__ time_a, int n,
    int any_hit, int instances,
    float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ obj_out, int* __restrict__ counts) {
    extern __shared__ float smem[];
    __shared__ unsigned int retired_all[K6_WARPS][K6_MAX_WORDS];
    const int lane = threadIdx.x & (TILE - 1);
    const int warp = threadIdx.x / TILE;
    float* ssc = smem;
    float* gb = smem + (size_t)SC * 8 + (size_t)warp * gmax * 6;
    unsigned int* retired = retired_all[warp];
    for (int k = threadIdx.x; k < SC * 8; k += blockDim.x) ssc[k] = scb[k];
    for (int k = lane; k < K6_MAX_WORDS; k += TILE) retired[k] = 0u;
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
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    WtRay w = wt_setup(ox, oy, oz, dx, dy, dz);
    auto sc_entry_of = [&](int s) {
        return slab_entry(ssc + 8 * s, ox, oy, oz, ix, iy, iz, tmin, tmax);
    };
    W2oCache wc;  // the w2o bits w was last built from

    float bt = fminf(tmax, RT_RAY_TMAX), bu = 0.0f, bv = 0.0f;
    int bp = -1, bo = -1;
    int entered = 0, walked = 0, gboxes = 0, gpasses = 0, rows = 0,
        tested = 0, xforms = 0, passes = 0, boxes = 0;
    const int pbase = rt_prim_col(ct, MOT), obase = pbase + ct,
              vbase = obase + ct;
    // the lane's gate: entries below its best t; none once an any-hit lane
    // has its hit
#define GATE() ((any_hit && bp >= 0) ? -RT_INF : fminf(bt, RT_INF))
    RtLaneQueue<Q> queue;
    queue.init(live);
    for (int outer = 0; outer < SC; ++outer) {
        const rt_key msc = rt_warp_key_min(
            queue.head(retired, SC, GATE(), sc_entry_of, &passes, &boxes));
        if (msc == RT_NO_KEY64) break;  // warp-uniform: no lane has a pair
        const int scid = rt_key_id(msc);
        const int cstart = (int)ssc[8 * scid + 6];
        const int gcount = min((int)ssc[8 * scid + 7], gmax);
        __syncwarp();  // every lane is done with the previous group's boxes
        for (int k = lane; k < gcount * 6; k += TILE)
            gb[k] = __ldg(cbounds + (size_t)6 * cstart + k);
        __syncwarp();
        if (COUNT) ++entered;
        const float own = live ? sc_entry_of(scid) : RT_INF;
        if (own < GATE()) {
            // the lane's own walk over the group; its segment is capped by
            // its gate at the group's entry
            if (COUNT) ++walked;
            const float need = fminf(GATE(), tmax);
            long long last = -1;  // packed key of the last visited cluster
            bool more = true;     // a live key may lie beyond the queue
            while (more) {
                // ---- one pass: the GQ smallest live keys above last ----
                unsigned int q[GQ];
                rt_queue_clear(q);
                bool fell_pos = false, fell_neg = false;
                const float gate = GATE();
                for (int g = 0; g < gcount; ++g) {
                    const float e = slab_entry(gb + 6 * g, ox, oy, oz, ix, iy,
                                               iz, tmin, need);
                    if (e >= RT_INF) continue;
                    const unsigned int key = rt_pack_key(e, g);
                    if ((long long)key <= last) continue;     // visited
                    if (rt_key_entry(key) >= gate) continue;  // culled
                    const unsigned int out = rt_queue_insert(q, key);
                    if (out != RT_NO_KEY) {
                        if (out & RT_KEY_NEG)
                            fell_neg = true;
                        else
                            fell_pos = true;
                    }
                }
                if (COUNT) {
                    ++gpasses;
                    gboxes += gcount;
                }
                // ---- the walk: pop the keys in order ----
                bool done = false;
                for (int j = 0; j < GQ; ++j) {
                    const unsigned int key = q[0];
                    rt_queue_pop(q);
                    if (key == RT_NO_KEY) break;
                    if (rt_key_entry(key) >= GATE()) {
                        // culled since the pass; so is every later key of
                        // non-negative entry, including those that fell off
                        if (!(key & RT_KEY_NEG)) fell_pos = false;
                        continue;
                    }
                    last = key;
                    const float* row =
                        ctable +
                        (size_t)(cstart + (int)(key & RT_KEY_ID_MASK)) * W;
                    if (COUNT) ++rows;
                    bool first = true;  // no triangle of the row tested yet
                    for (int k = 0; k < ct; ++k) {
                        const float pid = __ldg(row + pbase + k);
                        if (!(pid >= 0.0f)) continue;
                        if (((int)__ldg(row + vbase + k) & vis) == 0) continue;
                        if (first) {
                            first = false;
                            if (COUNT) ++tested;
                            if (instances) {
                                float m[12];
#pragma unroll
                                for (int r = 0; r < 12; ++r)
                                    m[r] = __ldg(row + r);
                                if (w2o_update(wc, m, ox, oy, oz, dx, dy, dz,
                                               &w) && COUNT)
                                    ++xforms;
                            }
                        }
                        float t, u, v;
                        const bool hit =
                            MOT ? wt_tri_at<true>(
                                      w, row + RT_META_COLS + 9 * k,
                                      row + RT_META_COLS + 9 * (ct + k), tm,
                                      tmin, bt, &t, &u, &v)
                                : wt_tri(w, row + RT_META_COLS + 9 * k, tmin,
                                         bt, &t, &u, &v);
                        if (hit) {
                            bt = t;
                            bp = (int)pid;
                            bu = u;
                            bv = v;
                            bo = (int)__ldg(row + obase + k);
                        }
                    }
                    if (any_hit && bp >= 0) {
                        done = true;
                        break;
                    }
                }
                more = !done && (fell_pos || fell_neg);
            }
        }
        // the supercluster is retired for the warp; every lane is past its
        // reads of the bitmask (the shuffles above)
        if (lane == 0) retired[scid >> 5] |= 1u << (scid & 31);
        __syncwarp();
    }
#undef GATE
    if (!live) return;
    t_out[i] = bt;
    prim_out[i] = bp;
    u_out[i] = bu;
    v_out[i] = bv;
    obj_out[i] = bo;
    if (COUNT) {
        int* c = counts + 8 * i;
        c[0] = entered;
        c[1] = walked;
        c[2] = gboxes;
        c[3] = gpasses;
        c[4] = rows;
        c[5] = tested;
        c[6] = xforms;
        c[7] = passes;
    }
}

template <bool COUNT, bool MOT>
static int launch(const float* scb, const float* cbounds, const float* ctable,
                  int SC, int C, int W, int ct, int gmax, const float* o,
                  const float* d, const float* tmin, const float* tmax,
                  const int* vis, const float* time, int n, int any_hit,
                  int instances, float* t, int* prim, float* u, float* v,
                  int* obj, int* counts, cudaStream_t stream) {
    // the supercluster table, then per warp one group's bounds (the
    // bitmasks are static): 28.3 KB a block at SC = 512, gmax = 128
    const size_t smem =
        ((size_t)SC * 8 + (size_t)K6_WARPS * gmax * 6) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        onehot2_walk_kernel<K6_QUEUE, K6_GQUEUE, COUNT, MOT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int block = K6_WARPS * TILE;
    const int grid = (n + block - 1) / block;
    onehot2_walk_kernel<K6_QUEUE, K6_GQUEUE, COUNT, MOT>
        <<<grid, block, smem, stream>>>(scb, cbounds, ctable, SC, C, W, ct,
                                        gmax, o, d, tmin, tmax, vis, time, n,
                                        any_hit, instances, t, prim, u, v, obj,
                                        counts);
    return (int)cudaGetLastError();
}

// K5's argument list; gmax (the largest group) must be 1..G_CAP and SC at
// most K6_MAX_WORDS x 32. time: (N,) f32 with motion rows (motion != 0),
// else null; counts: (N, 8) int32, or null (the counting variant runs when
// given).
extern "C" int rt_onehot2_walk(const float* scb, const float* cbounds,
                               const float* ctable, int SC, int C, int W,
                               int ct, int gmax, const float* o,
                               const float* d, const float* tmin,
                               const float* tmax, const int* vis, int n,
                               int any_hit, int instances, int motion,
                               const float* time, float* t, int* prim,
                               float* u, float* v, int* obj, int* counts,
                               void* stream) {
    if (n <= 0) return 0;
    if (gmax < 1 || gmax > G_CAP || SC > K6_MAX_WORDS * 32)
        return (int)cudaErrorInvalidValue;
    if (instances && motion) return (int)cudaErrorInvalidValue;
    auto* fn = counts ? (motion ? launch<true, true> : launch<true, false>)
                      : (motion ? launch<false, true> : launch<false, false>);
    return fn(scb, cbounds, ctable, SC, C, W, ct, gmax, o, d, tmin, tmax, vis,
              time, n, any_hit, instances, t, prim, u, v, obj, counts,
              (cudaStream_t)stream);
}
