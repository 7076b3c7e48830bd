// K5: two-level tile-shared cluster walk over superclusters and their
// clusters, closest hit or any hit, with instance rows or motion rows.
//
// Replaces the TPU kernel raytracingproject_tpu/ops/pallas_cluster.py
// intersect_clusters2_pallas / _cluster2_kernel. Same contract as the
// plain walk ops/cluster_intersect.py intersect_clusters (which walks all
// C clusters of a lane without the second level): closest (or any) hit,
// with t = min(tmax, RAY_TMAX) and prim = object = -1 on a miss.
//
// What the TPU kernel computes: per tile of rays, an outer loop picks the
// nearest live supercluster as the argmin over clusters of the tile's
// masked entry distances (entry < the lane's best t; nothing for an
// any-hit lane that has its hit); on entry it builds the (gmax, tile)
// entry table of that group's clusters, each lane's segment capped by its
// gate; an inner loop is the single-level tile walk over the group (one
// row fetched from HBM per step, tested by every lane whose entry passes
// its gate, then retired for the tile). Instance rows carry the
// instance's world->object transform: each lane transforms its ray by the
// row's w2o (t is kept: the direction is not renormalised) before the
// watertight test. Supercluster and cluster boxes are world space.
//
// Design here: K4's (csrc/tile_walk.cu) at the supercluster level; the
// tile is one warp of 32 rays.
//   - Supercluster level: each lane keeps the K5_QUEUE smallest (entry,
//     supercluster) pairs of a box pass in registers (64-bit keys), and the
//     warp a retired bitmask (SC <= 512 bits); a pick drops retired and gated
//     heads, refills a dry queue whose pairs fell off, and takes the
//     warp's minimum of the heads (csrc/pair_queue.cuh). The earlier
//     design scanned a (SC, 32) entry table on every pick.
//   - Group level: the (gmax, 32) entry table in the warp's shared memory,
//     laid out [entry][lane], filled on every group entry from the cluster
//     bounds (read through L2) with each lane's boxes capped by its gate,
//     and scanned on every pick (watertight.cuh warp_pick): gcount <= 16
//     on big_instanced, so a queue would buy a pass as long as the scan.
//   - Row: the warp copies the picked cluster's row (W floats; 1,876 bytes
//     at 38 triangles) into a per-warp shared buffer, lanes striding. A
//     lane whose entry passes its gate tests the row's triangles in order
//     with strict t < best; with instance rows it first transforms its ray
//     and rebuilds its shear basis, unless the row's 12 w2o floats are bit
//     for bit the ones it used last (the clusters of one instance share
//     them). The earlier design transformed on every lane for every row.
//   - Shared memory: the supercluster table once per block (SC x 32
//     bytes) and per warp the group table, a row and the bitmask; up to 4
//     warps a block (3 at SC = gmax = 512).
// What bounds it on the H100: latency, not bytes or arithmetic. A warp's
// steps are serial: a dependent row copy, then up to 38 triangle tests.
// The bytes the function must move (rays, results, 2 MB of tables) take
// about a microsecond at 3.35 TB/s.
//
// Motion rows (MOT; the TPU kernel's has_motion branch, pallas_cluster.py
// :432): a row is 13 + 21 ct floats, each triangle's shutter deltas after
// the triangles, its prim ids from 13 + 18 ct (1,357 floats, 5.4 KB, at
// ct = 64: the staged row grows from 13 + 12 ct). Supercluster and
// cluster boxes cover both shutter ends, so the queues, the group table
// and the warp's picks do not change (the mirrors take the same picks); a
// lane that tests the staged row lerps each triangle to its time, v +
// time * dv per component (watertight.cuh wt_tri_at, as K2-K4), the plain
// version's order. Motion rows never carry instances (the entry point
// refuses the two together). Shared memory at SC = 25, gmax = 64: 800
// bytes of supercluster table and 13,620 a warp, 55 KB a block of 4.
//
// The counting variant (COUNT) writes per lane the superclusters its warp
// entered, the group tables it filled, the rows its warp fetched, the rows
// it tested, the w2o transforms it computed and its supercluster passes,
// into counts[6 * lane]; ops/cluster2_walk.py cluster2_queue_order
// computes the same counts in plain torch.
//
// Rounding: the slab and triangle tests are watertight.cuh's, the
// transform is m[0]*ox + m[1]*oy + m[2]*oz + m[3] left to right as in the
// plain version, and the build uses -fmad=false, so t, u, v equal the
// plain version's to the bit; prim and object can differ only where two
// clusters hold hits at the same t (the warp's visit order differs from
// the lane's). Every output equals cluster2_scan_order's on every lane.
#include "pair_queue.cuh"

#define TILE RT_TILE
#define K5_WARPS 4
#define K5_MAX_WORDS 16  // supercluster bitmask words: SC <= 512
// Queue length (PERF.md section 6, compare_walks.py): big_instanced's
// render inputs make 1.00 supercluster passes a lane at 4 (max 2), and 4
// was as fast as 8, 12 and 16 there at the fewest registers.
#ifndef K5_QUEUE
#define K5_QUEUE 4
#endif

template <int Q, bool COUNT, bool MOT>
__global__ void __launch_bounds__(K5_WARPS* TILE) cluster2_walk_kernel(
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
    __shared__ unsigned int retired_all[K5_WARPS][K5_MAX_WORDS];
    const int lane = threadIdx.x & (TILE - 1);
    const int warp = threadIdx.x / TILE;
    float* ssc = smem;
    float* centry = smem + (size_t)SC * 8 + (size_t)warp * (gmax * TILE + W);
    float* row = centry + (size_t)gmax * TILE;
    unsigned int* retired = retired_all[warp];
    for (int k = threadIdx.x; k < SC * 8; k += blockDim.x) ssc[k] = scb[k];
    for (int k = lane; k < K5_MAX_WORDS; k += TILE) retired[k] = 0u;
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
    int entered = 0, fills = 0, fetched = 0, rows = 0, xforms = 0,
        passes = 0, boxes = 0;
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
        const int gcount = (int)ssc[8 * scid + 7];
        // the group's entry table, each lane's segment capped by its gate
        const float need = fminf(GATE(), tmax);
        __syncwarp();  // every lane is done with the previous group's table
        for (int g = 0; g < gmax; ++g) {
            float e = RT_INF;
            if (g < gcount && live) {
                float b[6];
                for (int j = 0; j < 6; ++j)
                    b[j] = __ldg(cbounds + 6 * (cstart + g) + j);
                e = slab_entry(b, ox, oy, oz, ix, iy, iz, tmin, need);
            }
            centry[g * TILE + lane] = e;
        }
        if (COUNT) {
            ++entered;
            ++fills;
        }
        int g;
        float mc = warp_pick(centry, gcount, lane, GATE(), &g);
        for (int inner = 0; inner < gcount && mc < RT_INF; ++inner) {
            const float* grow = ctable + (size_t)(cstart + g) * W;
            __syncwarp();  // every lane is done with the previous row
            for (int k = lane; k < W; k += TILE) row[k] = __ldg(grow + k);
            __syncwarp();
            if (COUNT) ++fetched;
            if (centry[g * TILE + lane] < GATE()) {
                if (COUNT) ++rows;
                if (instances &&
                    w2o_update(wc, row, ox, oy, oz, dx, dy, dz, &w) && COUNT)
                    ++xforms;
                for (int k = 0; k < ct; ++k) {
                    const float pid = row[pbase + k];
                    if (!(pid >= 0.0f)) continue;
                    if (((int)row[vbase + k] & vis) == 0) continue;
                    const float* tri = row + RT_META_COLS + 9 * k;
                    float t, u, v;
                    const bool hit =
                        MOT ? wt_tri_at<true>(w, tri,
                                              row + RT_META_COLS + 9 * (ct + k),
                                              tm, tmin, bt, &t, &u, &v)
                            : wt_tri_v(w, tri[0], tri[1], tri[2], tri[3],
                                       tri[4], tri[5], tri[6], tri[7], tri[8],
                                       tmin, bt, &t, &u, &v);
                    if (hit) {
                        bt = t;
                        bp = (int)pid;
                        bu = u;
                        bv = v;
                        bo = (int)row[obase + k];
                    }
                }
            }
            centry[g * TILE + lane] = RT_INF;  // retired for the tile
            mc = warp_pick(centry, gcount, lane, GATE(), &g);
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
        int* c = counts + 6 * i;
        c[0] = entered;
        c[1] = fills;
        c[2] = fetched;
        c[3] = rows;
        c[4] = xforms;
        c[5] = passes;
    }
}

template <bool COUNT, bool MOT>
static int launch(const float* scb, const float* cbounds, const float* ctable,
                  int SC, int C, int W, int ct, int gmax, const float* o,
                  const float* d, const float* tmin, const float* tmax,
                  const int* vis, const float* time, int n, int any_hit,
                  int instances, float* t, int* prim, float* u, float* v,
                  int* obj, int* counts, cudaStream_t stream) {
    // the supercluster table, then per warp the group table and a row; up
    // to K5_WARPS warps a block within the 227 KB a block can have (the
    // bitmasks are static)
    const size_t fixed = (size_t)SC * 8 * sizeof(float);
    const size_t per_warp = ((size_t)gmax * TILE + W) * sizeof(float);
    const size_t smem_max =
        227 * 1024 - K5_WARPS * K5_MAX_WORDS * sizeof(unsigned int);
    if (fixed + per_warp > smem_max) return (int)cudaErrorInvalidValue;
    int warps = (int)((smem_max - fixed) / per_warp);
    if (warps > K5_WARPS) warps = K5_WARPS;
    const size_t smem = fixed + per_warp * warps;
    cudaError_t err = cudaFuncSetAttribute(
        cluster2_walk_kernel<K5_QUEUE, COUNT, MOT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int block = warps * TILE;
    const int grid = (n + block - 1) / block;
    cluster2_walk_kernel<K5_QUEUE, COUNT, MOT><<<grid, block, smem, stream>>>(
        scb, cbounds, ctable, SC, C, W, ct, gmax, o, d, tmin, tmax, vis, time,
        n, any_hit, instances, t, prim, u, v, obj, counts);
    return (int)cudaGetLastError();
}

// time: (N,) f32 with motion rows (motion != 0), else null; counts: (N, 6)
// int32, or null (the counting variant runs when given).
extern "C" int rt_cluster2_walk(const float* scb, const float* cbounds,
                                const float* ctable, int SC, int C, int W,
                                int ct, int gmax, const float* o,
                                const float* d, const float* tmin,
                                const float* tmax, const int* vis, int n,
                                int any_hit, int instances, int motion,
                                const float* time, float* t, int* prim,
                                float* u, float* v, int* obj, int* counts,
                                void* stream) {
    if (n <= 0) return 0;
    if (SC > K5_MAX_WORDS * 32) return (int)cudaErrorInvalidValue;
    if (instances && motion) return (int)cudaErrorInvalidValue;
    auto* fn = counts ? (motion ? launch<true, true> : launch<true, false>)
                      : (motion ? launch<false, true> : launch<false, false>);
    return fn(scb, cbounds, ctable, SC, C, W, ct, gmax, o, d, tmin, tmax, vis,
              time, n, any_hit, instances, t, prim, u, v, obj, counts,
              (cudaStream_t)stream);
}
