"""Samplers and hashes (JAX counterpart: raytracingproject_tpu/utils/rng.py).

Hash-based Owen-scrambled Sobol (Burley 2020) and the PCG hashes, bit
for bit. torch has no usable uint32 arithmetic (add, shift and compare
raise on the CPU), so every value is a uint32 held in int64 and masked
with & 0xFFFFFFFF after each step. A 32x32-bit product would overflow
int64's sign bit, so `_mul32` splits the constant into 16-bit halves:
each partial product stays below 2^48 and the result is exact on any
device, with no reliance on signed wrap-around.
"""

from __future__ import annotations

import numpy as np
import torch

# Dimension-pair enumeration (same slots as the JAX package).
PRNG_FILTER = 0
PRNG_LENS = 1
PRNG_TIME = 2
PRNG_BASE_NUM = 4
PRNG_BSDF = 0
PRNG_LIGHT = 1
PRNG_TERMINATE = 2
PRNG_PHASE = 3
PRNG_BOUNCE_NUM = 4

SOBOL_SAMPLER = 0

MASK32 = 0xFFFFFFFF

# Joe-Kuo "new-joe-kuo-6" initialization for dimensions 2..4 (dimension
# 1 is the van der Corput sequence): (s, a, m).
_JOE_KUO = [
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
]


def _generate_sobol_matrices(num_dims=4, bits=32):
    """Direction numbers: V[d][j] = j-th direction number of dim d."""
    v = np.zeros((num_dims, bits), dtype=np.uint64)
    for j in range(bits):
        v[0, j] = 1 << (bits - 1 - j)
    for d, (s, a, m_init) in enumerate(_JOE_KUO[: num_dims - 1], start=1):
        m = list(m_init)
        for k in range(s, bits):
            mk = m[k - s] ^ (m[k - s] << s)
            for i in range(1, s):
                if (a >> (s - 1 - i)) & 1:
                    mk ^= m[k - i] << i
            m.append(mk)
        for j in range(bits):
            v[d, j] = m[j] << (bits - 1 - j)
    return v.astype(np.uint32)


SOBOL_MATRICES = _generate_sobol_matrices()  # (4, 32) uint32


def _u32(x):
    """Any integer tensor -> int64 tensor holding uint32 values."""
    return torch.as_tensor(x).to(torch.int64) & MASK32


def _mul32(x, c):
    """(x * c) mod 2^32 for uint32 x (int64 tensor) and a python constant."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def hash_pcg(x):
    """PCG output-permutation hash of a uint32."""
    x = _u32(x)
    state = (_mul32(x, 747796405) + 2891336453) & MASK32
    word = _mul32(((state >> ((state >> 28) + 4)) ^ state), 277803737)
    return (word >> 22) ^ word


def hash_combine(seed, v):
    """boost-style hash_combine."""
    seed = _u32(seed)
    v = _u32(v)
    return seed ^ ((hash_pcg(v) + 0x9E3779B9 + ((seed << 6) & MASK32)
                    + (seed >> 2)) & MASK32)


def hash_pcg2d(a, b):
    return hash_pcg(hash_combine(hash_pcg(a), b))


def hash_pcg3d(a, b, c):
    return hash_pcg(hash_combine(hash_combine(hash_pcg(a), b), c))


def uint_to_float_01(x):
    """uint32 -> float32 in [0, 1) with 24-bit mantissa exactness."""
    return (_u32(x) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def reverse_bits(x):
    x = _u32(x)
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & MASK32


def _laine_karras_permutation(x, seed):
    """Base-2 nested uniform permutation (Laine-Karras hash with
    Burley's constants)."""
    x = (_u32(x) + _u32(seed)) & MASK32
    x = x ^ _mul32(x, 0x6C50B47C)
    x = x ^ _mul32(x, 0xB82F1E52)
    x = x ^ _mul32(x, 0xC7AFE638)
    x = x ^ _mul32(x, 0x8D22F6E6)
    return x


def nested_uniform_scramble(x, seed):
    """Owen scramble of a [0,1)-fixed-point uint32."""
    return reverse_bits(_laine_karras_permutation(reverse_bits(x), seed))


def _sobol_eval(dim, index):
    """Sobol' value (uint32) of `index` for direction matrix row `dim`."""
    index = _u32(index)
    if dim == 0:
        return reverse_bits(index)
    result = torch.zeros_like(index)
    for j, m in enumerate(SOBOL_MATRICES[dim].tolist()):
        result = result ^ (((index >> j) & 1) * m)
    return result


def sobol_burley_2d(sample_index, dim_pair, seed):
    """Owen-scrambled, index-shuffled 2D Sobol point; arguments broadcast,
    returns two float32 tensors in [0, 1)."""
    pair_seed = hash_pcg2d(dim_pair, seed)
    shuffled = nested_uniform_scramble(
        sample_index, hash_combine(pair_seed, 0x55AAFACE))
    x = _sobol_eval(0, shuffled)
    y = _sobol_eval(1, shuffled)
    x = nested_uniform_scramble(x, hash_combine(pair_seed, 1))
    y = nested_uniform_scramble(y, hash_combine(pair_seed, 2))
    return uint_to_float_01(x), uint_to_float_01(y)


def pixel_rng_hash(pixel_index, seed):
    """Per-pixel decorrelation hash."""
    return hash_pcg2d(pixel_index, seed)


def path_rng_2d(rng_hash, sample, dim_pair, pattern=SOBOL_SAMPLER):
    if pattern != SOBOL_SAMPLER:
        raise NotImplementedError(
            f"sampling pattern {pattern}: only sobol_burley is ported")
    return sobol_burley_2d(sample, dim_pair, rng_hash)
