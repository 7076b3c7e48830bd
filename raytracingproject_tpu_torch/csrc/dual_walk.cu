// K7: the union walk. Per lane a closest-hit ray and an any-hit ray (the
// next bounce and this bounce's NEE shadow test) walk the single-level
// cluster table together.
//
// Replaces the TPU kernel raytracingproject_tpu/ops/pallas_onehot.py
// intersect_clusters_onehot_dual / _onehot_dual_kernel. Same contract as
// the plain version ops/cluster_intersect.py intersect_clusters_dual (the
// closest walk on one ray and the any-hit walk on the other; static,
// single-level tables; no instance or motion rows). A window with
// tmax <= tmin holds no hit and disables that ray of the lane.
//
// What bounds it on the H100: per-lane latency, as K2. Each visit rescans
// the C <= 512 cluster boxes for both rays (two slab tests a box) and then
// reads one row from the L2-resident table; what the union saves is the
// second launch, the second read of a row both rays enter, and the shadow
// walk's own setup.
//
// Design: K2's, one thread per lane, 128-thread blocks, the C x 6 bounds
// in shared memory, rows through the read-only path. Every visit forms
// both rays' packed keys (f32_bits(entry) & ~0x1FF) | cluster_id over the
// boxes and takes the smallest key that is still live in either queue: a
// closest key is live while its (truncated) entry is below the best t, an
// any key while its entry is inside the shadow window and the lane is not
// blocked. The row is read once and each of its triangles is tested
// against every ray in whose queue the cluster is live (closest: strict
// t < best under the ray's visibility; any: latch only), then the cluster
// is retired from both queues. K2 knows the visited clusters by one "last
// key" because its keys only grow along the walk; here a cluster's union
// key is the smaller of two keys and either can drop out (the closest
// entry once best t tightens, the any queue once the lane is blocked), so
// a cluster reached through one ray's key could come up again through the
// other's. Each lane therefore keeps a visited bit per cluster (C / 32
// words a lane, in shared memory beside the bounds); every visit sets one
// new bit, so the walk ends within C visits. A queue found empty by a scan
// stays empty (gates only shrink, bits only get set) and its slab tests
// are skipped from then on. The TPU kernel's (C, tile) entry tables, its
// one-hot bf16x3 row fetch and its float liveness scalar are not carried
// over. It tests a fetched row against both rays whatever queue picked it
// (its vector lanes pay for the test anyway); a thread that skips the test
// of a ray whose segment never enters the box saves that time, and the
// lane's results are those of the two separate walks: the same closest
// hit except where two triangles tie in t (the visit order picks), the
// same blocked flag.
#include "watertight.cuh"

#define ID_BITS 9
#define ID_MASK ((1u << ID_BITS) - 1u)
#define DUAL_BLOCK 128
#define NO_KEY 0xFFFFFFFFu

static __device__ __forceinline__ unsigned int pack_key(float e, int c) {
    e = e + 0.0f;  // -0.0 -> +0.0 before taking the bits
    return (__float_as_uint(e) & ~ID_MASK) | (unsigned int)c;
}

static __device__ __forceinline__ float key_entry(unsigned int key) {
    return __uint_as_float(key & ~ID_MASK);
}

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
    bool* __restrict__ blk_out) {
    extern __shared__ float sb[];
    // visited bits: word w of this thread's lane at seen[w * DUAL_BLOCK + tid]
    unsigned int* seen = (unsigned int*)(sb + C * 6) + threadIdx.x;
    const int words = (C + 31) >> 5;
    for (int i = threadIdx.x; i < C * 6; i += blockDim.x) sb[i] = cbounds[i];
    for (int w = 0; w < words; ++w) seen[w * DUAL_BLOCK] = 0u;
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
    const WtRay wc = wt_setup(cox, coy, coz, cdx, cdy, cdz);
    const WtRay wa = wt_setup(aox, aoy, aoz, adx, ady, adz);
    const float cix = safe_inv(cdx), ciy = safe_inv(cdy), ciz = safe_inv(cdz);
    const float aix = safe_inv(adx), aiy = safe_inv(ady), aiz = safe_inv(adz);

    float bt = fminf(tmaxc, RT_RAY_TMAX), bu = 0.0f, bv = 0.0f;
    int bp = -1, bo = -1;
    bool blocked = false;
    // the any-hit walk's own gate: entries below min(tmax, RAY_TMAX)
    const float a_gate = fminf(tmaxa, RT_RAY_TMAX);
    bool c_live = tmaxc > tminc, a_live = tmaxa > tmina;
    const int pbase = RT_META_COLS + 9 * ct, obase = pbase + ct,
              vbase = obase + ct;
    for (int visit = 0; visit < C && (c_live || a_live); ++visit) {
        const float c_gate = fminf(bt, RT_INF);
        unsigned int best_c = NO_KEY, best_a = NO_KEY;
        for (int w = 0; w < words; ++w) {
            const unsigned int done = seen[w * DUAL_BLOCK];
            const int c_end = min(C, (w + 1) << 5);
            for (int c = w << 5; c < c_end; ++c) {
                if ((done >> (c & 31)) & 1u) continue;
                if (c_live) {
                    const float e = slab_entry(sb + 6 * c, cox, coy, coz, cix,
                                               ciy, ciz, tminc, tmaxc);
                    if (e < RT_INF) {
                        const unsigned int key = pack_key(e, c);
                        if (key_entry(key) < c_gate) best_c = min(best_c, key);
                    }
                }
                if (a_live) {
                    const float e = slab_entry(sb + 6 * c, aox, aoy, aoz, aix,
                                               aiy, aiz, tmina, tmaxa);
                    if (e < a_gate) best_a = min(best_a, pack_key(e, c));
                }
            }
        }
        c_live = best_c != NO_KEY;
        a_live = best_a != NO_KEY;
        const unsigned int pick = min(best_c, best_a);
        if (pick == NO_KEY) break;
        const int c = (int)(pick & ID_MASK);
        seen[(c >> 5) * DUAL_BLOCK] |= 1u << (c & 31);
        // the picked cluster may be live in the other ray's queue too
        bool do_c = c_live, do_a = a_live;
        if (do_c && (best_c & ID_MASK) != (unsigned int)c) {
            const float e = slab_entry(sb + 6 * c, cox, coy, coz, cix, ciy, ciz,
                                       tminc, tmaxc);
            do_c = e < RT_INF && key_entry(pack_key(e, c)) < c_gate;
        }
        if (do_a && (best_a & ID_MASK) != (unsigned int)c) {
            const float e = slab_entry(sb + 6 * c, aox, aoy, aoz, aix, aiy, aiz,
                                       tmina, tmaxa);
            do_a = e < a_gate;
        }
        const float* row = ctable + (size_t)c * W;
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
            if (on_c && wt_tri_v(wc, v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y,
                                 e2z, tminc, bt, &t, &u, &v)) {
                bt = t;
                bp = (int)pid;
                bu = u;
                bv = v;
                bo = (int)__ldg(row + obase + k);
            }
            if (on_a && wt_tri_v(wa, v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y,
                                 e2z, tmina, a_gate, &t, &u, &v))
                blocked = true;
        }
        if (blocked) a_live = false;
    }
    t_out[i] = bt;
    prim_out[i] = bp;
    u_out[i] = bu;
    v_out[i] = bv;
    obj_out[i] = bo;
    blk_out[i] = blocked;
}

extern "C" int rt_dual_walk(const float* cbounds, const float* ctable, int C,
                            int W, int ct, const float* oc, const float* dc,
                            const float* tminc, const float* tmaxc,
                            const int* visc, const float* oa, const float* da,
                            const float* tmina, const float* tmaxa,
                            const int* visa, int n, float* t, int* prim,
                            float* u, float* v, int* obj, bool* blocked,
                            void* stream) {
    if (n <= 0) return 0;
    const int grid = (n + DUAL_BLOCK - 1) / DUAL_BLOCK;
    const size_t smem = (size_t)C * 6 * sizeof(float) +
                        (size_t)((C + 31) / 32) * DUAL_BLOCK * sizeof(unsigned int);
    dual_walk_kernel<<<grid, DUAL_BLOCK, smem, (cudaStream_t)stream>>>(
        cbounds, ctable, C, W, ct, oc, dc, tminc, tmaxc, visc, oa, da, tmina,
        tmaxa, visa, n, t, prim, u, v, obj, blocked);
    return (int)cudaGetLastError();
}
