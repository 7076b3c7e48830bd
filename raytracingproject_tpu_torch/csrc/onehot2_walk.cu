// K6: two-level cluster walk with a tile-shared supercluster pick and a
// per-lane walk inside each picked group; closest hit or any hit, with
// instance rows.
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
// Design: K5's outer level (csrc/cluster2_walk.cu) and K2's inner loop
// (csrc/cluster_walk.cu). A tile is one warp of 32 rays. The (SC, 32)
// supercluster entry table sits in the warp's shared memory and each pick
// is a lane scan plus five shuffles (watertight.cuh warp_pick). Per outer
// visit the warp copies the group's gcount x 6 bounds into shared memory
// (3 KB at the cap of 128 clusters). Then each lane whose own entry into
// the group is below its best t loops alone: it rescans the group's boxes
// for its smallest packed key above its last one, culls keys whose
// truncated entry is not below its best t, reads that row from global
// memory (every lane a different row; the big_instanced table, 1.9 MB,
// stays in L2), transforms its ray in the plain walk's operation order and
// tests up to ct triangles. The other lanes of the warp wait at the next
// pick, which is the price of the tile-shared outer level.
//
// What bounds it on the H100: latency. A lane's visits are serial, each a
// rescan of up to 128 boxes and a dependent, uncoalesced 1,876-byte row
// read, and a warp takes as long as its slowest lane in every group any of
// its lanes enters.
//
// Rounding: as in the other walks (watertight.cuh, -fmad=false) t, u, v
// equal the plain version's to the bit; prim and object can differ only
// where two clusters hold hits at the same t.
#include "watertight.cuh"

#define TILE RT_TILE
#define G_CAP 128  // clusters per supercluster (the JAX package's G_PAD)
#define ID_BITS 9
#define ID_MASK ((1u << ID_BITS) - 1u)

__global__ void onehot2_walk_kernel(
    const float* __restrict__ scb, const float* __restrict__ cbounds,
    const float* __restrict__ ctable, int SC, int C, int W, int ct,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin_a, const float* __restrict__ tmax_a,
    const int* __restrict__ vis_a, int n, int any_hit, int instances,
    float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ obj_out) {
    extern __shared__ float smem[];
    const int lane = threadIdx.x & (TILE - 1);
    const int warp = threadIdx.x / TILE;
    const size_t per_warp = (size_t)SC * TILE + G_CAP * 6;
    float* sc_entry = smem + (size_t)warp * per_warp;
    float* gb = sc_entry + (size_t)SC * TILE;
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
        const int gcount = min((int)__ldg(scb + 8 * scid + 7), G_CAP);
        __syncwarp();  // every lane is done with the previous group's boxes
        for (int k = lane; k < gcount * 6; k += TILE)
            gb[k] = __ldg(cbounds + (size_t)6 * cstart + k);
        __syncwarp();
        if (sc_entry[scid * TILE + lane] < GATE()) {
            // the lane's own walk over the group; its segment is capped by
            // its gate at the group's entry
            const float need = fminf(GATE(), tmax);
            long long last = -1;  // packed key of the last visited cluster
            for (int visit = 0; visit < gcount; ++visit) {
                const float gate = GATE();
                unsigned int best = 0xFFFFFFFFu;
                bool found = false;
                for (int g = 0; g < gcount; ++g) {
                    float e = slab_entry(gb + 6 * g, ox, oy, oz, ix, iy, iz,
                                         tmin, need);
                    if (e >= RT_INF) continue;
                    e = e + 0.0f;  // -0.0 -> +0.0 before taking the bits
                    const unsigned int key =
                        (__float_as_uint(e) & ~ID_MASK) | (unsigned int)g;
                    if ((long long)key <= last) continue;  // visited
                    if (__uint_as_float(key & ~ID_MASK) >= gate)
                        continue;  // culled
                    if (key < best) {
                        best = key;
                        found = true;
                    }
                }
                if (!found) break;
                last = best;
                const float* row =
                    ctable + (size_t)(cstart + (int)(best & ID_MASK)) * W;
                if (instances) {
                    float m[12];
                    for (int j = 0; j < 12; ++j) m[j] = __ldg(row + j);
                    const float oxx = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
                    const float oyy = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
                    const float ozz =
                        m[8] * ox + m[9] * oy + m[10] * oz + m[11];
                    const float dxx = m[0] * dx + m[1] * dy + m[2] * dz;
                    const float dyy = m[4] * dx + m[5] * dy + m[6] * dz;
                    const float dzz = m[8] * dx + m[9] * dy + m[10] * dz;
                    w = wt_setup(oxx, oyy, ozz, dxx, dyy, dzz);
                }
                for (int k = 0; k < ct; ++k) {
                    const float pid = __ldg(row + pbase + k);
                    if (!(pid >= 0.0f)) continue;
                    if (((int)__ldg(row + vbase + k) & vis) == 0) continue;
                    float t, u, v;
                    if (wt_tri(w, row + RT_META_COLS + 9 * k, tmin, bt, &t, &u,
                               &v)) {
                        bt = t;
                        bp = (int)pid;
                        bu = u;
                        bv = v;
                        bo = (int)__ldg(row + obase + k);
                    }
                }
                if (any_hit && bp >= 0) break;
            }
        }
        sc_entry[scid * TILE + lane] = RT_INF;  // retired for the tile
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

// K5's argument list; gmax (the largest group) must be at most G_CAP.
extern "C" int rt_onehot2_walk(const float* scb, const float* cbounds,
                               const float* ctable, int SC, int C, int W,
                               int ct, int gmax, const float* o,
                               const float* d, const float* tmin,
                               const float* tmax, const int* vis, int n,
                               int any_hit, int instances, float* t,
                               int* prim, float* u, float* v, int* obj,
                               void* stream) {
    if (n <= 0) return 0;
    if (gmax > G_CAP) return (int)cudaErrorInvalidValue;
    const size_t per_warp =
        ((size_t)SC * TILE + (size_t)G_CAP * 6) * sizeof(float);
    const size_t smem_max = 227 * 1024;
    int warps = (int)(smem_max / per_warp);
    if (warps < 1) return (int)cudaErrorInvalidValue;
    if (warps > 4) warps = 4;
    const size_t smem = per_warp * warps;
    cudaError_t err = cudaFuncSetAttribute(
        onehot2_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int block = warps * TILE;
    const int grid = (n + block - 1) / block;
    onehot2_walk_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        scb, cbounds, ctable, SC, C, W, ct, o, d, tmin, tmax, vis, n, any_hit,
        instances, t, prim, u, v, obj);
    return (int)cudaGetLastError();
}
