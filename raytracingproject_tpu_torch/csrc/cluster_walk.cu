// K2: per-lane front-to-back cluster walk, closest hit or any hit.
//
// Replaces the TPU kernel raytracingproject_tpu/ops/pallas_onehot.py:969
// intersect_clusters_onehot / _onehot_kernel (:145). Same contract as the
// plain walk ops/cluster_intersect.py intersect_clusters (single-level
// cluster tables, C <= 512, with instance rows or motion rows or
// neither).
//
// What bounds it on the H100: per-lane latency, not bytes. A lane's visits
// are serial, and each reads one 193-float row (at 15 triangles) that
// depends on the visit before; the glossy table is 138 KB and stays in L2,
// so the rows cost L2 latency, not HBM bandwidth. Lanes diverge in visit
// counts (camera rays fewer than bounce rays).
//
// Visit order: a lane visits its clusters by the packed key
// (f32_bits(entry) & ~0x1FF) | cluster_id, smallest first. Keys are unique
// (the id breaks ties), increase strictly along the walk, and order like
// the entries (9 truncated mantissa bits only coarsen the order; hit
// selection compares exact t). A cluster whose truncated entry is >= the
// best t is retired, exactly the TPU kernel's cull. The TPU kernel keeps a
// (C, lanes) entry table in VMEM and takes a min per visit; 512 floats a
// lane fit neither registers nor shared memory here.
//
// Design: one thread per ray, 128-thread blocks, the cluster bounds
// (C * 6 floats, <= 12 KB) in shared memory, rows read from global memory
// through the read-only path. A lane makes one pass over the C boxes and
// keeps, sorted in registers, the K2_QUEUE smallest live keys above the
// last one it visited (a fully unrolled insertion network over fixed
// registers: no array indexed at run time, so nothing goes to local
// memory), and notes whether a live key fell off the end. It then pops
// the keys in order and tests each popped cluster's row. A popped key
// whose truncated entry has reached the (shrinking) best t is retired
// there; since keys only grow, every later key of non-negative entry is
// retired with it. When the queue runs dry and a key fell off, the lane
// makes another pass from its last key. The clusters visited are the ones
// the earlier design visited (a full box rescan per visit), key for key,
// so t, u, v, prim and object are the same to the bit; box tests fall
// from (visits + 1) x C to C x passes, about C x ceil(visits / queue).
//
// Instance rows (INST): a row's first 12 floats are its instance's
// world->object matrix. Boxes are world boxes, so the keys, the cull and
// the visit order do not change. Before a popped row's tests the lane
// transforms its world ray by the matrix and rebuilds its shear basis
// (watertight.cuh w2o_setup), unless the 12 floats are bit for bit the
// ones it used last (an instance's clusters share them); t stays in world
// units.
//
// Motion rows (MOT; the TPU kernel's has_motion branch, :277): each
// triangle's shutter deltas follow the row's triangles, and the prim,
// object and visibility columns start at 13 + 18 ct (watertight.cuh
// rt_prim_col). Boxes cover both shutter ends, so the keys, the cull and
// the visit order do not change; a lane tests each triangle of a popped
// row lerped to its time, v + time * dv per component, the plain
// version's order. Motion rows never carry instances (the JAX package
// packs no cluster table for moving instances): the entry point refuses
// the two together.
//
// The counting variant (COUNT) also writes per lane the rows it tested and
// the boxes it tested, into counts[2 * lane].
//
// Entries are >= tmin; callers pass tmin >= 0. A negative entry (tmin < 0)
// sorts after every non-negative one, as in the earlier design; it stays
// exact, and such keys are never retired by a non-negative key's cull.
//
// Registers and spills (ptxas -v, CUDA 12.8, sm_90a): 72 registers, no
// spills, in both variants; with instance rows 88 and 89; motion rows:
// PERF.md section 6; chip_smoke.py prints the build log.
#include "watertight.cuh"

// Queue length: the counts (PERF.md) give p99 4 visits a lane on glossy's
// render input, so one pass serves nearly every lane.
#define K2_QUEUE 8

template <int Q, bool COUNT, bool INST, bool MOT>
__global__ void cluster_walk_kernel(
    const float* __restrict__ cbounds, const float* __restrict__ ctable,
    int C, int W, int ct, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ tmin_a,
    const float* __restrict__ tmax_a, const int* __restrict__ vis_a,
    const float* __restrict__ time_a, int n,
    int any_hit, float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ obj_out, int* __restrict__ counts) {
    extern __shared__ float sb[];
    for (int i = threadIdx.x; i < C * 6; i += blockDim.x) sb[i] = cbounds[i];
    __syncthreads();
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float tmin = tmin_a[i], tmax = tmax_a[i];
    const int vis = vis_a[i];
    const float tm = MOT ? time_a[i] : 0.0f;
    WtRay w = wt_setup(ox, oy, oz, dx, dy, dz);
    W2oCache wc;  // the w2o bits w was last built from (INST)
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

    float bt = fminf(tmax, RT_RAY_TMAX), bu = 0.0f, bv = 0.0f;
    int bp = -1, bo = -1;
    int rows = 0, passes = 0;
    const int pbase = rt_prim_col(ct, MOT), obase = pbase + ct,
              vbase = pbase + 2 * ct;
    long long last = -1;  // packed key of the last visited cluster
    bool more = true;     // a live key may lie beyond the queue
    while (more) {
        // ---- one pass: the Q smallest live keys above last, sorted ----
        unsigned int q[Q];
        rt_queue_clear(q);
        bool fell_pos = false, fell_neg = false;
        const float gate = fminf(bt, RT_INF);
        for (int c = 0; c < C; ++c) {
            const float e =
                slab_entry(sb + 6 * c, ox, oy, oz, ix, iy, iz, tmin, tmax);
            if (e >= RT_INF) continue;
            const unsigned int key = rt_pack_key(e, c);
            if ((long long)key <= last) continue;      // visited
            if (rt_key_entry(key) >= gate) continue;   // culled
            const unsigned int out = rt_queue_insert(q, key);
            if (out != RT_NO_KEY) {
                if (out & RT_KEY_NEG)
                    fell_neg = true;
                else
                    fell_pos = true;
            }
        }
        ++passes;
        // ---- the walk: pop the keys in order ----
        bool done = false;
        for (int j = 0; j < Q; ++j) {
            const unsigned int key = q[0];
            rt_queue_pop(q);
            if (key == RT_NO_KEY) break;
            if (rt_key_entry(key) >= fminf(bt, RT_INF)) {
                // retired since the pass; so is every later key of
                // non-negative entry, including those that fell off
                if (!(key & RT_KEY_NEG)) fell_pos = false;
                continue;
            }
            last = key;
            const float* row = ctable + (size_t)(key & RT_KEY_ID_MASK) * W;
            if (COUNT) ++rows;
            if (INST) {
                float m[12];
#pragma unroll
                for (int k = 0; k < 12; ++k) m[k] = __ldg(row + k);
                w2o_update(wc, m, ox, oy, oz, dx, dy, dz, &w);
            }
            for (int k = 0; k < ct; ++k) {
                const float pid = __ldg(row + pbase + k);
                if (!(pid >= 0.0f)) continue;
                if (((int)__ldg(row + vbase + k) & vis) == 0) continue;
                float t, u, v;
                const bool hit =
                    MOT ? wt_tri_at<true>(w, row + RT_META_COLS + 9 * k,
                                          row + RT_META_COLS + 9 * (ct + k),
                                          tm, tmin, bt, &t, &u, &v)
                        : wt_tri(w, row + RT_META_COLS + 9 * k, tmin, bt, &t,
                                 &u, &v);
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
    t_out[i] = bt;
    prim_out[i] = bp;
    u_out[i] = bu;
    v_out[i] = bv;
    obj_out[i] = bo;
    if (COUNT) {
        counts[2 * i] = rows;
        counts[2 * i + 1] = passes * C;
    }
}

template <bool COUNT, bool INST, bool MOT>
static void launch(int grid, int block, size_t smem, cudaStream_t stream,
                   const float* cbounds, const float* ctable, int C, int W,
                   int ct, const float* o, const float* d, const float* tmin,
                   const float* tmax, const int* vis, const float* time,
                   int n, int any_hit, float* t, int* prim, float* u,
                   float* v, int* obj, int* counts) {
    cluster_walk_kernel<K2_QUEUE, COUNT, INST, MOT>
        <<<grid, block, smem, stream>>>(cbounds, ctable, C, W, ct, o, d, tmin,
                                        tmax, vis, time, n, any_hit, t, prim,
                                        u, v, obj, counts);
}

extern "C" int rt_cluster_walk(const float* cbounds, const float* ctable,
                               int C, int W, int ct, const float* o,
                               const float* d, const float* tmin,
                               const float* tmax, const int* vis, int n,
                               int any_hit, int instances, int motion,
                               const float* time, float* t, int* prim,
                               float* u, float* v, int* obj, int* counts,
                               void* stream) {
    if (n <= 0) return 0;
    if (instances && motion) return (int)cudaErrorInvalidValue;
    const int block = 128;
    const int grid = (n + block - 1) / block;
    const size_t smem = (size_t)C * 6 * sizeof(float);
    auto* fn = counts ? (instances ? launch<true, true, false>
                                   : motion ? launch<true, false, true>
                                            : launch<true, false, false>)
                      : (instances ? launch<false, true, false>
                                   : motion ? launch<false, false, true>
                                            : launch<false, false, false>);
    fn(grid, block, smem, (cudaStream_t)stream, cbounds, ctable, C, W, ct, o,
       d, tmin, tmax, vis, time, n, any_hit, t, prim, u, v, obj, counts);
    return (int)cudaGetLastError();
}
