// K5: two-level tile-shared cluster walk over superclusters and their
// clusters, closest hit or any hit, with instance rows.
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
// Design here: K4's (csrc/tile_walk.cu), one level up. The tile is one
// warp of 32 rays.
//   - Entry tables in shared memory, laid out [entry][lane] (a lane reads
//     its own column, conflict free): the supercluster table (SC, 32),
//     8.3 KB at SC = 65 and 64 KB at the cap of 512, filled once; the
//     group table (gmax, 32), 8 KB at gmax = 64, refilled on every group
//     entry from the cluster bounds (read through L2; every lane reads the
//     same box).
//   - Pick: each lane scans its column for its smallest masked entry
//     (first index on ties), then five butterfly shuffles take the warp's
//     lexicographic minimum (entry, index): the TPU kernel's argmin over
//     the per-entry tile minimum.
//   - Row: the warp copies the picked cluster's row (W floats; 1,876 bytes
//     at 38 triangles) from global memory (the 1.9 MB table of the
//     big_instanced scene stays in L2) into a per-warp shared buffer,
//     lanes striding. With instance rows every lane then transforms its
//     ray and rebuilds its shear basis; every lane whose entry passes its
//     gate tests the row's triangles in order with strict t < best.
//   - The host fits up to 4 warps per block into the 227 KB a block can
//     have and refuses tables that do not fit one warp.
// What bounds it on the H100: latency, not bytes or arithmetic. A warp's
// steps are serial: a shared-memory scan of SC or gmax entries per lane,
// a dependent row copy, then up to 38 triangle tests. The bytes the
// function must move (rays, results, 2 MB of tables) take about a
// microsecond at 3.35 TB/s.
//
// Rounding: the slab and triangle tests are watertight.cuh's, the
// transform is m[0]*ox + m[1]*oy + m[2]*oz + m[3] left to right as in the
// plain version, and the build uses -fmad=false, so t, u, v equal the
// plain version's to the bit; prim and object can differ only where two
// clusters hold hits at the same t (the tile's visit order differs from
// the lane's).
#include "watertight.cuh"

#define TILE RT_TILE

__global__ void cluster2_walk_kernel(
    const float* __restrict__ scb, const float* __restrict__ cbounds,
    const float* __restrict__ ctable, int SC, int C, int W, int ct, int gmax,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin_a, const float* __restrict__ tmax_a,
    const int* __restrict__ vis_a, int n, int any_hit, int instances,
    float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ obj_out) {
    extern __shared__ float smem[];
    const int lane = threadIdx.x & (TILE - 1);
    const int warp = threadIdx.x / TILE;
    const size_t per_warp = (size_t)(SC + gmax) * TILE + W;
    float* sc_entry = smem + (size_t)warp * per_warp;
    float* centry = sc_entry + (size_t)SC * TILE;
    float* row = centry + (size_t)gmax * TILE;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;  // lanes past n walk along with no entries

    const float ox = live ? o[3 * i] : 0.0f, oy = live ? o[3 * i + 1] : 0.0f,
                oz = live ? o[3 * i + 2] : 0.0f;
    const float dx = live ? d[3 * i] : 1.0f, dy = live ? d[3 * i + 1] : 0.0f,
                dz = live ? d[3 * i + 2] : 0.0f;
    const float tmin = live ? tmin_a[i] : 0.0f;
    const float tmax = live ? tmax_a[i] : -1.0f;
    const int vis = live ? vis_a[i] : 0;
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    WtRay w = wt_setup(ox, oy, oz, dx, dy, dz);
    for (int s = 0; s < SC; ++s) {
        float b[6];
        for (int j = 0; j < 6; ++j) b[j] = __ldg(scb + 8 * s + j);
        sc_entry[s * TILE + lane] =
            live ? slab_entry(b, ox, oy, oz, ix, iy, iz, tmin, tmax) : RT_INF;
    }

    float bt = fminf(tmax, RT_RAY_TMAX), bu = 0.0f, bv = 0.0f;
    int bp = -1, bo = -1;
    const int pbase = RT_META_COLS + 9 * ct, obase = pbase + ct,
              vbase = obase + ct;
    // the lane's mask: entries below its best t; none once an any-hit lane
    // has its hit
#define GATE() ((any_hit && bp >= 0) ? -RT_INF : fminf(bt, RT_INF))
    int scid;
    float msc = warp_pick(sc_entry, SC, lane, GATE(), &scid);
    for (int outer = 0; outer < SC && msc < RT_INF; ++outer) {
        const int cstart = (int)__ldg(scb + 8 * scid + 6);
        const int gcount = (int)__ldg(scb + 8 * scid + 7);
        // the group's entry table, each lane's segment capped by its gate
        const float need = fminf(GATE(), tmax);
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
        int g;
        float mc = warp_pick(centry, gcount, lane, GATE(), &g);
        for (int inner = 0; inner < gcount && mc < RT_INF; ++inner) {
            const float* grow = ctable + (size_t)(cstart + g) * W;
            __syncwarp();  // every lane is done with the previous row
            for (int k = lane; k < W; k += TILE) row[k] = __ldg(grow + k);
            __syncwarp();
            if (instances) {
                const float* m = row;
                const float oxx = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
                const float oyy = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
                const float ozz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
                const float dxx = m[0] * dx + m[1] * dy + m[2] * dz;
                const float dyy = m[4] * dx + m[5] * dy + m[6] * dz;
                const float dzz = m[8] * dx + m[9] * dy + m[10] * dz;
                w = wt_setup(oxx, oyy, ozz, dxx, dyy, dzz);
            }
            if (centry[g * TILE + lane] < GATE()) {
                for (int k = 0; k < ct; ++k) {
                    const float pid = row[pbase + k];
                    if (!(pid >= 0.0f)) continue;
                    if (((int)row[vbase + k] & vis) == 0) continue;
                    const float* tri = row + RT_META_COLS + 9 * k;
                    float t, u, v;
                    if (wt_tri_v(w, tri[0], tri[1], tri[2], tri[3], tri[4],
                                 tri[5], tri[6], tri[7], tri[8], tmin, bt,
                                 &t, &u, &v)) {
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
        sc_entry[scid * TILE + lane] = RT_INF;
        msc = warp_pick(sc_entry, SC, lane, GATE(), &scid);
    }
#undef GATE
    if (!live) return;
    t_out[i] = bt;
    prim_out[i] = bp;
    u_out[i] = bu;
    v_out[i] = bv;
    obj_out[i] = bo;
}

// Shared memory one warp needs: both entry tables and a row.
static size_t per_warp_bytes(int SC, int gmax, int W) {
    return ((size_t)(SC + gmax) * TILE + (size_t)W) * sizeof(float);
}

extern "C" int rt_cluster2_walk(const float* scb, const float* cbounds,
                                const float* ctable, int SC, int C, int W,
                                int ct, int gmax, const float* o,
                                const float* d, const float* tmin,
                                const float* tmax, const int* vis, int n,
                                int any_hit, int instances, float* t,
                                int* prim, float* u, float* v, int* obj,
                                void* stream) {
    if (n <= 0) return 0;
    const size_t per_warp = per_warp_bytes(SC, gmax, W);
    const size_t smem_max = 227 * 1024;
    int warps = (int)(smem_max / per_warp);
    if (warps < 1) return (int)cudaErrorInvalidValue;
    if (warps > 4) warps = 4;
    const size_t smem = per_warp * warps;
    cudaError_t err = cudaFuncSetAttribute(
        cluster2_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int block = warps * TILE;
    const int grid = (n + block - 1) / block;
    cluster2_walk_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        scb, cbounds, ctable, SC, C, W, ct, gmax, o, d, tmin, tmax, vis, n,
        any_hit, instances, t, prim, u, v, obj);
    return (int)cudaGetLastError();
}
