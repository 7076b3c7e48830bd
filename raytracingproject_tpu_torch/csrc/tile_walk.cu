// K4: tile-shared single-level cluster walk, closest hit or any hit.
//
// Replaces the TPU kernel raytracingproject_tpu/ops/pallas_cluster.py
// intersect_clusters_pallas / _cluster_kernel. Same contract as the plain
// walk ops/cluster_intersect.py intersect_clusters (static, single-level
// cluster tables with C <= 512; no instance or motion rows).
//
// What the TPU kernel does: a tile of 1,024 rays keeps a (C, tile) table
// of entry distances in VMEM; each step it takes the cluster whose masked
// entry (entry < the lane's best t, or nothing for a lane that already
// has its any hit) is smallest over the whole tile, tests every lane of
// the tile against that one row, and retires the cluster for the tile.
//
// Design here: the tile is one warp of 32 rays, and the same walk runs
// with warp-level reductions instead of the 1,024-lane vector unit.
//   - Entry table: per warp a (C, 32) float table in shared memory,
//     laid out [cluster][lane] so that a lane reading its own column is
//     bank-conflict free. It is filled once from the cluster bounds.
//     Sizing the tile by C keeps it in shared memory: C * 32 * 4 bytes
//     is 11.9 KB at C = 93 (volume_sss), 22.9 KB at C = 179 (glossy) and
//     64 KB at C = 512; the host picks 4 warps per block where that fits
//     in the 227 KB a block can have, fewer for large C.
//   - Pick: each lane scans its column for its smallest masked entry
//     (first cluster on ties), then five butterfly shuffles take the
//     lexicographic minimum (entry, cluster) over the warp -- the TPU
//     kernel's argmin over clusters of the per-cluster tile minimum.
//   - Row: the warp copies the picked cluster's row (W floats, 772 bytes
//     at 15 triangles) into a per-warp shared-memory buffer, lanes
//     striding, and every lane whose own entry passes its mask tests the
//     row's triangles in order with strict t < best (the TPU kernel's
//     sequential update). The cluster is then retired for the warp.
//   - The walk ends when no lane has a masked entry left, or after C
//     steps.
// What bounds it on the H100: latency, not bytes. Each step costs a
// C-entry shared-memory scan per lane and a dependent row copy; the
// tables (72 KB for volume_sss) stay in L2. The bytes the function must
// move (rays, results, tables) take microseconds at 3.35 TB/s.
//
// Rounding: the triangle and slab tests are the shared helpers of
// watertight.cuh, built with -fmad=false, so t, u, v equal the plain
// version's to the bit; prim and object can differ only where two
// clusters hold hits at the same t (the tile's visit order differs from
// the lane's).
#include "watertight.cuh"

#define TILE 32

__global__ void tile_walk_kernel(
    const float* __restrict__ cbounds, const float* __restrict__ ctable,
    int C, int W, int ct, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ tmin_a,
    const float* __restrict__ tmax_a, const int* __restrict__ vis_a, int n,
    int any_hit, float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ obj_out) {
    extern __shared__ float smem[];
    const int lane = threadIdx.x & (TILE - 1);
    const int warp = threadIdx.x / TILE;
    const int warps = blockDim.x / TILE;
    float* entry = smem + (size_t)warp * C * TILE;
    float* row = smem + (size_t)warps * C * TILE + (size_t)warp * W;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;  // lanes past n walk along with no entries

    const float ox = live ? o[3 * i] : 0.0f, oy = live ? o[3 * i + 1] : 0.0f,
                oz = live ? o[3 * i + 2] : 0.0f;
    const float dx = live ? d[3 * i] : 1.0f, dy = live ? d[3 * i + 1] : 0.0f,
                dz = live ? d[3 * i + 2] : 0.0f;
    const float tmin = live ? tmin_a[i] : 0.0f;
    const float tmax = live ? tmax_a[i] : -1.0f;
    const int vis = live ? vis_a[i] : 0;
    const WtRay w = wt_setup(ox, oy, oz, dx, dy, dz);
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    for (int c = 0; c < C; ++c) {
        float b[6];
        for (int j = 0; j < 6; ++j) b[j] = __ldg(cbounds + 6 * c + j);
        entry[c * TILE + lane] =
            live ? slab_entry(b, ox, oy, oz, ix, iy, iz, tmin, tmax) : RT_INF;
    }

    float bt = fminf(tmax, RT_RAY_TMAX), bu = 0.0f, bv = 0.0f;
    int bp = -1, bo = -1;
    const int pbase = RT_META_COLS + 9 * ct, obase = pbase + ct,
              vbase = obase + ct;
    for (int step = 0; step < C; ++step) {
        // the lane's mask: entries below its best t; none once an any-hit
        // lane has its hit
        const float gate = (any_hit && bp >= 0) ? -RT_INF : fminf(bt, RT_INF);
        float m = RT_INF;
        int mc = C;
        for (int c = 0; c < C; ++c) {
            const float e = entry[c * TILE + lane];
            if (e < gate && e < m) {
                m = e;
                mc = c;
            }
        }
        for (int off = TILE / 2; off > 0; off >>= 1) {
            const float om = __shfl_xor_sync(0xFFFFFFFFu, m, off);
            const int oc = __shfl_xor_sync(0xFFFFFFFFu, mc, off);
            if (om < m || (om == m && oc < mc)) {
                m = om;
                mc = oc;
            }
        }
        if (!(m < RT_INF)) break;  // warp-uniform: no lane has an entry
        const float* grow = ctable + (size_t)mc * W;
        __syncwarp();  // every lane is done with the previous row
        for (int k = lane; k < W; k += TILE) row[k] = __ldg(grow + k);
        __syncwarp();
        if (entry[mc * TILE + lane] < gate) {
            for (int k = 0; k < ct; ++k) {
                const float pid = row[pbase + k];
                if (!(pid >= 0.0f)) continue;
                if (((int)row[vbase + k] & vis) == 0) continue;
                const float* tri = row + RT_META_COLS + 9 * k;
                float t, u, v;
                if (wt_tri_v(w, tri[0], tri[1], tri[2], tri[3], tri[4], tri[5],
                             tri[6], tri[7], tri[8], tmin, bt, &t, &u, &v)) {
                    bt = t;
                    bp = (int)pid;
                    bu = u;
                    bv = v;
                    bo = (int)row[obase + k];
                }
            }
        }
        entry[mc * TILE + lane] = RT_INF;  // retired for the whole tile
    }
    if (!live) return;
    t_out[i] = bt;
    prim_out[i] = bp;
    u_out[i] = bu;
    v_out[i] = bv;
    obj_out[i] = bo;
}

extern "C" int rt_tile_walk(const float* cbounds, const float* ctable, int C,
                            int W, int ct, const float* o, const float* d,
                            const float* tmin, const float* tmax,
                            const int* vis, int n, int any_hit, float* t,
                            int* prim, float* u, float* v, int* obj,
                            void* stream) {
    if (n <= 0) return 0;
    const size_t per_warp = ((size_t)C * TILE + (size_t)W) * sizeof(float);
    const size_t smem_max = 227 * 1024;
    int warps = (int)(smem_max / per_warp);
    if (warps < 1) return (int)cudaErrorInvalidValue;
    if (warps > 4) warps = 4;
    const size_t smem = per_warp * warps;
    cudaError_t err = cudaFuncSetAttribute(
        tile_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int block = warps * TILE;
    const int grid = (n + block - 1) / block;
    tile_walk_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        cbounds, ctable, C, W, ct, o, d, tmin, tmax, vis, n, any_hit, t, prim,
        u, v, obj);
    return (int)cudaGetLastError();
}
