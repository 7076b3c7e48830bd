// The per-lane queue of (entry, id) pairs and the retired bitmask of the
// tile-shared walks (K4 csrc/tile_walk.cu, K5 csrc/cluster2_walk.cu).
//
// A lane keeps the Q smallest (entry, id) pairs of its last box pass,
// sorted lexicographically in registers: entry first, the smaller id on
// equal entries, which is the order in which the earlier design's table
// scan took them (its first smallest entry). A pair is held as one 64-bit
// key: the entry's 32 bits mapped to an unsigned integer that orders like
// the float (-0.0 taken as +0.0, as float comparison does), then the
// 32-bit id. Unlike K2's packed key (watertight.cuh rt_pack_key), no bit
// of the entry is dropped, so the order is exact for any id. A warp
// retires an id for all its lanes in a bitmask in shared memory.
#pragma once

#include "watertight.cuh"

typedef unsigned long long rt_key;
#define RT_NO_KEY64 0xFFFFFFFFFFFFFFFFull  // an empty slot: after every key

// The entry's order-preserving bits: a float a < b exactly when
// rt_order(a) < rt_order(b) (no NaN reaches it).
static __device__ __forceinline__ unsigned int rt_order(float e) {
    const unsigned int u = __float_as_uint(e + 0.0f);  // -0.0 -> +0.0
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

static __device__ __forceinline__ rt_key rt_key_of(float e, int id) {
    return ((rt_key)rt_order(e) << 32) | (unsigned int)id;
}

// Keys below rt_gate_key(g) are exactly the pairs with entry < g.
static __device__ __forceinline__ rt_key rt_gate_key(float g) {
    return (rt_key)rt_order(g) << 32;
}

static __device__ __forceinline__ int rt_key_id(rt_key k) {
    return (int)(unsigned int)k;
}

// Insert key into the sorted queue q (a fully unrolled insertion network
// over fixed registers, as watertight.cuh rt_queue_insert: no array indexed
// at run time). Returns whether a key fell off the end: key itself, or the
// former last key.
template <int Q>
static __device__ __forceinline__ bool rt_keys_insert(rt_key (&q)[Q],
                                                      rt_key key) {
    if (!(key < q[Q - 1])) return true;
    const bool out = q[Q - 1] != RT_NO_KEY64;
#pragma unroll
    for (int j = Q - 1; j > 0; --j)
        q[j] = key < q[j - 1] ? q[j - 1] : (key < q[j] ? key : q[j]);
    q[0] = key < q[0] ? key : q[0];
    return out;
}

template <int Q>
static __device__ __forceinline__ void rt_keys_pop(rt_key (&q)[Q]) {
#pragma unroll
    for (int k = 0; k < Q - 1; ++k) q[k] = q[k + 1];
    q[Q - 1] = RT_NO_KEY64;
}

static __device__ __forceinline__ bool rt_retired(const unsigned int* bits,
                                                  int id) {
    return (bits[id >> 5] >> (id & 31)) & 1u;
}

// The warp's smallest key (RT_NO_KEY64 when no lane has one).
static __device__ __forceinline__ rt_key rt_warp_key_min(rt_key k) {
#pragma unroll
    for (int off = RT_TILE / 2; off > 0; off >>= 1) {
        const rt_key o = __shfl_xor_sync(0xFFFFFFFFu, k, off);
        k = o < k ? o : k;
    }
    return k;
}

// One lane's queue and its step: drop the head keys that are retired or
// not below the gate; when the queue ran dry, a key fell off at the last
// pass and the last dropped key is below the gate, make a box pass
// (entry_of(id) is the lane's entry into box id, RT_INF on a miss): the Q
// smallest keys above the last dropped one that are unretired and below
// the gate. The lanes' candidate sets only shrink (the gate falls, ids
// retire), so the head is always the lane's smallest unretired pair below
// its gate: what the earlier design's table scan found.
template <int Q>
struct RtLaneQueue {
    rt_key q[Q];
    rt_key last;  // the last dropped key (first: below every key)
    bool fell;

    __device__ __forceinline__ void init(bool live) {
#pragma unroll
        for (int k = 0; k < Q; ++k) q[k] = RT_NO_KEY64;
        last = rt_gate_key(-RT_INF);
        fell = live;  // the first step makes the first pass
    }

    // Returns the head (RT_NO_KEY64 when empty); counts passes and box
    // tests.
    template <class EntryOf>
    __device__ __forceinline__ rt_key head(const unsigned int* bits,
                                           int count, float gate,
                                           EntryOf entry_of, int* passes,
                                           int* boxes) {
        const rt_key gk = rt_gate_key(gate);
        while (q[0] != RT_NO_KEY64 &&
               (!(q[0] < gk) || rt_retired(bits, rt_key_id(q[0])))) {
            last = q[0];
            rt_keys_pop(q);
        }
        if (q[0] == RT_NO_KEY64 && fell && last < gk) {
            fell = false;
            ++*passes;
            unsigned int word = 0u;
            for (int c = 0; c < count; ++c) {
                if ((c & 31) == 0) word = bits[c >> 5];
                if ((word >> (c & 31)) & 1u) continue;
                const float e = entry_of(c);
                ++*boxes;
                if (!(e < gate)) continue;
                const rt_key key = rt_key_of(e, c);
                if (!(last < key)) continue;
                if (rt_keys_insert(q, key)) fell = true;
            }
        }
        return q[0];
    }
};
