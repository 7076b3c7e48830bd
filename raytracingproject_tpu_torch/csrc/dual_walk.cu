// K7: the union walk. Per lane a closest-hit ray and an any-hit ray (the
// next bounce and this bounce's NEE shadow test) walk the single-level
// cluster table together.
//
// Replaces the TPU kernel raytracingproject_tpu/ops/pallas_onehot.py
// intersect_clusters_onehot_dual / _onehot_dual_kernel. Same contract as
// the plain version ops/cluster_intersect.py intersect_clusters_dual (the
// closest walk on one ray and the any-hit walk on the other; single-level
// tables, C <= 512, with or without instance rows; no motion rows). A
// window with tmax <= tmin holds no hit and disables that ray of the lane.
//
// What bounds it on the H100: per-lane latency, as K2. A lane's visits are
// serial and each reads one row from the L2-resident table that depends
// on the visit before; what the union saves over K2 + K3 is the second
// launch, the second read of a row both rays enter, and the second read
// of the boxes.
//
// Design: K2's for each ray (csrc/cluster_walk.cu), one thread per lane,
// 128-thread blocks, the C x 6 bounds in shared memory, rows through the
// read-only path. One pass over the C boxes reads each box from shared
// memory once and fills two sorted register queues (watertight.cuh
// rt_queue_insert): the K7_QC smallest packed keys of the closest ray
// above its last visited key, under K2's cull (truncated entry below the
// best t), and the K7_QA smallest of the any-hit ray above its own last
// key with an entry inside its window. Each ray notes whether a key fell
// off its queue. The lane then pops the smaller of the two heads; when
// both heads name one cluster, its row is read once and tested against
// both rays. A closest key whose truncated entry has reached the best t
// is retired as in K2 (with every later key of non-negative entry); the
// any-hit ray is done at its first blocker. When both queues are dry and
// a ray has a key that fell off, one more pass refills the queue of each
// such ray. So the closest ray visits exactly K2's clusters in K2's order
// (t, u, v, prim and object are K2's, which equal the plain walk's), and
// the any-hit ray visits clusters of entry inside its window until it is
// blocked (an order-free flag, equal to the plain walk's). Box tests fall
// from (visits + 1) x 2C in the earlier design (a rescan of every box for
// both rays on every visit, with a visited bit per cluster and lane in
// shared memory) to C per ray and pass.
//
// Instance rows (INST): a row's first 12 floats are its instance's
// world->object matrix. Boxes are world boxes, so the keys, the queues and
// the visit order do not change. A row that both heads name is still read
// once: the lane reads its matrix and takes each ray that tests the row to
// object space by it, rebuilding that ray's shear basis (watertight.cuh
// w2o_setup; the direction is not renormalised, so t stays in world
// units). Each ray is transformed at every row it tests: the bit-for-bit
// cache of the last matrix that K2-K6 keep (watertight.cuh W2oCache)
// would hold two matrices' 24 words here, on top of 124 registers.
//
// The counting variant (COUNT) also writes per lane the rows it read, the
// rows read once for both rays, the passes made and the boxes tested,
// into counts[4 * lane].
//
// Registers and spills (ptxas -v, CUDA 12.8, sm_90a): 116 and 121 in the
// two variants, no spills; with instance rows 124 and 128; chip_smoke.py
// prints the build log.
#include "watertight.cuh"

#define DUAL_BLOCK 128
// Queue lengths: K2's 8 for the closest ray; the any-hit ray stops at its
// first blocker (K3 visits 0.87 rows a lane on glossy, PERF.md)
#define K7_QC 8
#define K7_QA 8

template <int QC, int QA, bool COUNT, bool INST>
__global__ void dual_walk_kernel(
    const float* __restrict__ cbounds, const float* __restrict__ ctable,
    int C, int W, int ct, const float* __restrict__ oc,
    const float* __restrict__ dc, const float* __restrict__ tminc_a,
    const float* __restrict__ tmaxc_a, const int* __restrict__ visc_a,
    const float* __restrict__ oa, const float* __restrict__ da,
    const float* __restrict__ tmina_a, const float* __restrict__ tmaxa_a,
    const int* __restrict__ visa_a, int n, float* __restrict__ t_out,
    int* __restrict__ prim_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ obj_out,
    bool* __restrict__ blk_out, int* __restrict__ counts) {
    extern __shared__ float sb[];
    for (int i = threadIdx.x; i < C * 6; i += blockDim.x) sb[i] = cbounds[i];
    __syncthreads();
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    const float cox = oc[3 * i], coy = oc[3 * i + 1], coz = oc[3 * i + 2];
    const float cdx = dc[3 * i], cdy = dc[3 * i + 1], cdz = dc[3 * i + 2];
    const float aox = oa[3 * i], aoy = oa[3 * i + 1], aoz = oa[3 * i + 2];
    const float adx = da[3 * i], ady = da[3 * i + 1], adz = da[3 * i + 2];
    const float tminc = tminc_a[i], tmaxc = tmaxc_a[i];
    const float tmina = tmina_a[i], tmaxa = tmaxa_a[i];
    const int visc = visc_a[i], visa = visa_a[i];
    WtRay wc = wt_setup(cox, coy, coz, cdx, cdy, cdz);
    WtRay wa = wt_setup(aox, aoy, aoz, adx, ady, adz);
    const float cix = safe_inv(cdx), ciy = safe_inv(cdy), ciz = safe_inv(cdz);
    const float aix = safe_inv(adx), aiy = safe_inv(ady), aiz = safe_inv(adz);

    float bt = fminf(tmaxc, RT_RAY_TMAX), bu = 0.0f, bv = 0.0f;
    int bp = -1, bo = -1;
    bool blocked = false;
    // the any-hit walk's own gate: entries below min(tmax, RAY_TMAX)
    const float a_gate = fminf(tmaxa, RT_RAY_TMAX);
    const int pbase = RT_META_COLS + 9 * ct, obase = pbase + ct,
              vbase = obase + ct;
    int rows = 0, shared_rows = 0, passes = 0, boxes = 0;
    long long last_c = -1, last_a = -1;  // last visited key of each ray
    // a ray needs a pass while a live key of it may lie beyond its queue
    bool need_c = tmaxc > tminc, need_a = tmaxa > tmina;
    unsigned int qc[QC], qa[QA];
    rt_queue_clear(qc);
    rt_queue_clear(qa);
    while (need_c || need_a) {
        // ---- one pass over the boxes, for each ray that needs one ----
        bool fell_c_pos = false, fell_c_neg = false, fell_a = false;
        const float c_gate = fminf(bt, RT_INF);
        for (int c = 0; c < C; ++c) {
            const float* b = sb + 6 * c;
            if (need_c) {
                const float e = slab_entry(b, cox, coy, coz, cix, ciy, ciz,
                                           tminc, tmaxc);
                if (e < RT_INF) {
                    const unsigned int key = rt_pack_key(e, c);
                    if ((long long)key > last_c && rt_key_entry(key) < c_gate) {
                        const unsigned int out = rt_queue_insert(qc, key);
                        if (out != RT_NO_KEY) {
                            if (out & RT_KEY_NEG)
                                fell_c_neg = true;
                            else
                                fell_c_pos = true;
                        }
                    }
                }
            }
            if (need_a) {
                const float e = slab_entry(b, aox, aoy, aoz, aix, aiy, aiz,
                                           tmina, tmaxa);
                if (e < a_gate) {
                    const unsigned int key = rt_pack_key(e, c);
                    if ((long long)key > last_a &&
                        rt_queue_insert(qa, key) != RT_NO_KEY)
                        fell_a = true;
                }
            }
        }
        if (COUNT) {
            ++passes;
            boxes += C * ((need_c ? 1 : 0) + (need_a ? 1 : 0));
        }
        // ---- the walk: pop the smaller head until both queues are dry ----
        for (int it = 0; it < QC + QA; ++it) {
            const unsigned int hc = qc[0], ha = qa[0];
            if (hc != RT_NO_KEY && rt_key_entry(hc) >= fminf(bt, RT_INF)) {
                // retired since the pass; so is every later key of
                // non-negative entry, including those that fell off
                rt_queue_pop(qc);
                if (!(hc & RT_KEY_NEG)) fell_c_pos = false;
                continue;
            }
            const unsigned int pick = min(hc, ha);
            if (pick == RT_NO_KEY) break;
            const unsigned int cid = pick & RT_KEY_ID_MASK;
            const bool do_c = hc != RT_NO_KEY && (hc & RT_KEY_ID_MASK) == cid;
            const bool do_a = ha != RT_NO_KEY && (ha & RT_KEY_ID_MASK) == cid;
            if (do_c) {
                rt_queue_pop(qc);
                last_c = hc;
            }
            if (do_a) {
                rt_queue_pop(qa);
                last_a = ha;
            }
            if (COUNT) {
                ++rows;
                if (do_c && do_a) ++shared_rows;
            }
            const float* row = ctable + (size_t)cid * W;
            if (INST) {
                float m[12];
#pragma unroll
                for (int k = 0; k < 12; ++k) m[k] = __ldg(row + k);
                if (do_c) wc = w2o_setup(m, cox, coy, coz, cdx, cdy, cdz);
                if (do_a && !blocked)
                    wa = w2o_setup(m, aox, aoy, aoz, adx, ady, adz);
            }
            for (int k = 0; k < ct; ++k) {
                const float pid = __ldg(row + pbase + k);
                if (!(pid >= 0.0f)) continue;
                const int tv = (int)__ldg(row + vbase + k);
                const bool on_c = do_c && (tv & visc) != 0;
                const bool on_a = do_a && !blocked && (tv & visa) != 0;
                if (!on_c && !on_a) continue;
                const float* tri = row + RT_META_COLS + 9 * k;
                const float v0x = __ldg(tri + 0), v0y = __ldg(tri + 1),
                            v0z = __ldg(tri + 2), e1x = __ldg(tri + 3),
                            e1y = __ldg(tri + 4), e1z = __ldg(tri + 5),
                            e2x = __ldg(tri + 6), e2y = __ldg(tri + 7),
                            e2z = __ldg(tri + 8);
                float t, u, v;
                if (on_c && wt_tri_v(wc, v0x, v0y, v0z, e1x, e1y, e1z, e2x,
                                     e2y, e2z, tminc, bt, &t, &u, &v)) {
                    bt = t;
                    bp = (int)pid;
                    bu = u;
                    bv = v;
                    bo = (int)__ldg(row + obase + k);
                }
                if (on_a && wt_tri_v(wa, v0x, v0y, v0z, e1x, e1y, e1z, e2x,
                                     e2y, e2z, tmina, a_gate, &t, &u, &v))
                    blocked = true;
            }
            if (blocked && qa[0] != RT_NO_KEY) {
                rt_queue_clear(qa);
                fell_a = false;
            }
        }
        need_c = fell_c_pos || fell_c_neg;
        need_a = !blocked && fell_a;
    }
    t_out[i] = bt;
    prim_out[i] = bp;
    u_out[i] = bu;
    v_out[i] = bv;
    obj_out[i] = bo;
    blk_out[i] = blocked;
    if (COUNT) {
        counts[4 * i] = rows;
        counts[4 * i + 1] = shared_rows;
        counts[4 * i + 2] = passes;
        counts[4 * i + 3] = boxes;
    }
}

template <bool COUNT, bool INST>
static void launch(int grid, size_t smem, cudaStream_t stream,
                   const float* cbounds, const float* ctable, int C, int W,
                   int ct, const float* oc, const float* dc,
                   const float* tminc, const float* tmaxc, const int* visc,
                   const float* oa, const float* da, const float* tmina,
                   const float* tmaxa, const int* visa, int n, float* t,
                   int* prim, float* u, float* v, int* obj, bool* blocked,
                   int* counts) {
    dual_walk_kernel<K7_QC, K7_QA, COUNT, INST>
        <<<grid, DUAL_BLOCK, smem, stream>>>(
        cbounds, ctable, C, W, ct, oc, dc, tminc, tmaxc, visc, oa, da, tmina,
        tmaxa, visa, n, t, prim, u, v, obj, blocked, counts);
}

extern "C" int rt_dual_walk(const float* cbounds, const float* ctable, int C,
                            int W, int ct, const float* oc, const float* dc,
                            const float* tminc, const float* tmaxc,
                            const int* visc, const float* oa, const float* da,
                            const float* tmina, const float* tmaxa,
                            const int* visa, int n, int instances,
                            float* t, int* prim, float* u, float* v,
                            int* obj, bool* blocked, int* counts,
                            void* stream) {
    if (n <= 0) return 0;
    const int grid = (n + DUAL_BLOCK - 1) / DUAL_BLOCK;
    const size_t smem = (size_t)C * 6 * sizeof(float);
    auto* fn = counts
                   ? (instances ? launch<true, true> : launch<true, false>)
                   : (instances ? launch<false, true> : launch<false, false>);
    fn(grid, smem, (cudaStream_t)stream, cbounds, ctable, C, W, ct, oc, dc,
       tminc, tmaxc, visc, oa, da, tmina, tmaxa, visa, n, t, prim, u, v, obj,
       blocked, counts);
    return (int)cudaGetLastError();
}
