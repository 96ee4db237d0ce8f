"""Quasi-Monte-Carlo (Sobol) uniforms for the direct sampler — the PyTorch
counterpart of ``altair_tpu/core/qmc.py``.

The closed-form direct engine consumes exactly seven uniforms per ray, the
textbook setting where a low-discrepancy sequence beats i.i.d. sampling.
32-bit Sobol points with the Joe-Kuo "new-joe-kuo-6" direction numbers
(the table scipy.stats.qmc.Sobol ships; dims 1..16) are generated on the
device from the point index, then randomised per dimension by one 32-bit
word: a digital shift (XOR) or a hash-based Owen scramble.  Each word
block gives an unbiased replicate.

Arithmetic runs in int64 holding 32-bit values, masked back to 32 bits
after every shift and add: torch has no shifts or adds for ``uint32`` on
the CPU.  Products are split into 16-bit halves so no intermediate leaves
the int64 range.  The randomisation takes its words as an argument
(``sobol_uniforms_from_words``), so a test can feed it the words the JAX
function drew and compare bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

# Joe-Kuo new-joe-kuo-6 parameters, dims 2..16 (dim 1 is the van der
# Corput sequence in base 2), as in the JAX module: poly = primitive
# polynomial bitmask (leading + constant bits included), vinit = initial
# direction integers m_1..m_s.
_POLY = [3, 7, 11, 13, 19, 25, 37, 41, 47, 55, 59, 61, 67, 91, 97]
_VINIT = [
    [1],
    [1, 3],
    [1, 3, 1],
    [1, 1, 1],
    [1, 1, 3, 3],
    [1, 3, 5, 13],
    [1, 1, 5, 5, 17],
    [1, 1, 5, 5, 5],
    [1, 1, 7, 11, 19],
    [1, 1, 5, 1, 1],
    [1, 1, 1, 3, 11],
    [1, 3, 5, 5, 31],
    [1, 3, 3, 9, 7, 49],
    [1, 1, 1, 15, 21, 21],
    [1, 3, 1, 13, 27, 49],
]
MAX_DIM = 1 + len(_POLY)
_BITS = 32
_MASK = 0xFFFFFFFF


def _direction_matrix(dim: int) -> np.ndarray:
    """``[dim, 32]`` uint32 direction numbers v_k (host-side, tiny)."""
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"sobol dims 1..{MAX_DIM}, got {dim}")
    V = np.zeros((dim, _BITS), np.uint32)
    # dim 1: van der Corput — v_k = 1 << (32 - k)
    for k in range(_BITS):
        V[0, k] = np.uint32(1) << np.uint32(_BITS - 1 - k)
    for d in range(1, dim):
        poly = _POLY[d - 1]
        m = list(_VINIT[d - 1])
        s = len(m)
        # inner coefficients a_1..a_{s-1}: bits of poly between the
        # leading and constant terms, high to low
        a = [(poly >> (s - i)) & 1 for i in range(1, s)]
        v = [np.uint32(m[k]) << np.uint32(_BITS - 1 - k) for k in range(s)]
        for k in range(s, _BITS):
            new = v[k - s] ^ (v[k - s] >> np.uint32(s))
            for i in range(1, s):
                if a[i - 1]:
                    new ^= v[k - i]
            v.append(new)
        V[d] = v
    return V


def sobol_bits(n: int, dim: int, device="cpu") -> torch.Tensor:
    """``[dim, n]`` Sobol integers for point indices 0..n-1 (int64 holding
    32-bit values), in Gray-code order like scipy's: an XOR-reduce of the
    direction numbers selected by the index bits."""
    V = torch.from_numpy(_direction_matrix(dim).astype(np.int64)).to(device)
    i = torch.arange(n, dtype=torch.int64, device=device)
    idx = i ^ (i >> 1)
    acc = torch.zeros((dim, n), dtype=torch.int64, device=device)
    # indices < n use only the low ceil(log2(n)) bits
    n_bits = max(1, int(n - 1).bit_length()) if n > 1 else 1
    for k in range(min(_BITS, n_bits)):
        acc ^= V[:, k, None] * ((idx >> k) & 1)
    return acc


def _reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse each 32-bit value (the classic 5-step swap network)."""
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & _MASK) | (x >> 16)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for 32-bit ``x`` and constant ``c``: the high
    half of ``x`` meets only the low half of ``c``, so every partial
    product stays below 2^49."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * (c & 0xFFFF)) << 16
    return (lo + hi) & _MASK


def _laine_karras(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Laine-Karras hash permutation (Burley, JCGT 2020), applied in
    bit-reversed space: a nested (Owen) permutation selected by ``seed``."""
    x = (x + seed) & _MASK
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return x


def sobol_uniforms_from_words(words: torch.Tensor, n: int, dim: int,
                              dtype=torch.float32,
                              mode: str = "shift") -> torch.Tensor:
    """``[dim, n]`` randomised Sobol uniforms in [0, 1) on ``words``'s
    device.  ``words`` is the ``[dim, 1]`` block of 32-bit randomisation
    words (any integer dtype): the XOR shift (``"shift"``) or the Owen
    seeds (``"owen"``) per dimension.  The top 24 bits become the value,
    so every uniform is exact in float32."""
    if mode not in ("shift", "owen"):
        raise ValueError(f"qmc mode {mode!r} (want 'shift' or 'owen')")
    w = words.to(torch.int64) & _MASK
    x = sobol_bits(n, dim, w.device)
    if mode == "shift":
        x = x ^ w
    else:
        x = _reverse_bits32(_laine_karras(_reverse_bits32(x), w))
    return (x >> 8).to(dtype) * (1.0 / (1 << 24))


def sobol_uniforms(gen: torch.Generator, n: int, dim: int,
                   dtype=torch.float32, mode: str = "shift",
                   device="cpu") -> torch.Tensor:
    """``[dim, n]`` randomised Sobol uniforms on ``device``, the ``[dim,
    1]`` randomisation words drawn from the CPU key ``gen``: a fresh
    unbiased replicate per key.  ``mode`` as ``sobol_uniforms_from_words``
    (``"owen"`` breaks Sobol's diagonal alignment, which helps
    discontinuous observables such as flux-map cells)."""
    words = torch.randint(0, 1 << 32, (dim, 1), generator=gen,
                          dtype=torch.int64)
    return sobol_uniforms_from_words(words.to(device), n, dim, dtype, mode)
