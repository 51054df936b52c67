"""Scalar numpy/python golden rANS — the definitional reference implementation.

A copy of ``repro.core.golden`` (the port imports nothing from the JAX
package): the same inputs give the same bytes and symbols.  This is the
"software pipeline" whose bitstream the accelerator must reproduce
*bit-exactly* (paper Sec. V-B: "RAS reproduces the exact bitstreams of the
reference implementation").  It uses plain Python integers, the
textbook while-loop renormalization and direct // and % — no tricks — so it
serves as the oracle for:

  * the vectorized multi-lane coder (core/coder.py),
  * the CUDA kernels and their plain versions (kernels/),
  * the Fig. 4(a) phase of chip_smoke.py.

Encode follows Eq. (1):  s' = floor(s/f) * 2**n + (s mod f) + C(x),
processing symbols in *reverse* (rANS is LIFO) and emitting renorm bytes
backward so the decoder reads forward.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core import constants as C


def encode(symbols: Sequence[int],
           freq: np.ndarray,
           cdf: np.ndarray,
           prob_bits: int = C.PROB_BITS) -> bytes:
    """Encode one lane of symbols.  Returns the forward-readable stream."""
    C.check_prob_bits(prob_bits)
    scale = C.x_max_scale(prob_bits)
    freq = np.asarray(freq)
    cdf = np.asarray(cdf)
    s = C.RANS_L
    rev: list[int] = []  # bytes in emission order (reverse of read order)
    for x in reversed(list(symbols)):
        f = int(freq[x])
        c = int(cdf[x])
        assert f >= 1, "zero frequency symbol is unencodable"
        x_max = scale * f
        while s >= x_max:
            rev.append(s & C.BYTE_MASK)
            s >>= C.RENORM_SHIFT
        s = ((s // f) << prob_bits) + (s % f) + c  # Eq. (1)
        assert C.RANS_L <= s < C.STATE_UPPER, s
    # 4-byte big-endian state header, read first by the decoder.
    head = [(s >> 24) & 0xFF, (s >> 16) & 0xFF, (s >> 8) & 0xFF, s & 0xFF]
    return bytes(head + rev[::-1])


def decode(stream: bytes,
           n_symbols: int,
           freq: np.ndarray,
           cdf: np.ndarray,
           prob_bits: int = C.PROB_BITS) -> np.ndarray:
    """Decode ``n_symbols`` from a forward stream.  Inverse of :func:`encode`."""
    C.check_prob_bits(prob_bits)
    mask = (1 << prob_bits) - 1
    freq = np.asarray(freq)
    cdf = np.asarray(cdf)
    k = len(freq)
    s = int.from_bytes(stream[:4], "big")
    ptr = 4
    out = np.empty(n_symbols, np.int64)
    for t in range(n_symbols):
        slot = s & mask
        # textbook binary search: find x with cdf[x] <= slot < cdf[x+1]
        lo, hi = 0, k
        while hi - lo > 1:
            mid = (lo + hi) >> 1
            if int(cdf[mid]) <= slot:
                lo = mid
            else:
                hi = mid
        x = lo
        out[t] = x
        s = int(freq[x]) * (s >> prob_bits) + slot - int(cdf[x])
        while s < C.RANS_L:
            s = (s << C.RENORM_SHIFT) | stream[ptr]
            ptr += 1
    return out


def encode_per_position(symbols: Sequence[int],
                        freq: np.ndarray,   # (T, K)
                        cdf: np.ndarray,    # (T, K+1)
                        prob_bits: int = C.PROB_BITS) -> bytes:
    """Adaptive variant: position t uses its own table row (neural priors)."""
    C.check_prob_bits(prob_bits)
    scale = C.x_max_scale(prob_bits)
    s = C.RANS_L
    rev: list[int] = []
    for t in range(len(symbols) - 1, -1, -1):
        x = int(symbols[t])
        f = int(freq[t, x])
        c = int(cdf[t, x])
        x_max = scale * f
        while s >= x_max:
            rev.append(s & C.BYTE_MASK)
            s >>= C.RENORM_SHIFT
        s = ((s // f) << prob_bits) + (s % f) + c
    head = [(s >> 24) & 0xFF, (s >> 16) & 0xFF, (s >> 8) & 0xFF, s & 0xFF]
    return bytes(head + rev[::-1])


def decode_per_position(stream: bytes,
                        freq: np.ndarray,   # (T, K)
                        cdf: np.ndarray,    # (T, K+1)
                        prob_bits: int = C.PROB_BITS) -> np.ndarray:
    C.check_prob_bits(prob_bits)
    mask = (1 << prob_bits) - 1
    n_symbols, k = freq.shape
    s = int.from_bytes(stream[:4], "big")
    ptr = 4
    out = np.empty(n_symbols, np.int64)
    for t in range(n_symbols):
        slot = s & mask
        lo, hi = 0, k
        while hi - lo > 1:
            mid = (lo + hi) >> 1
            if int(cdf[t, mid]) <= slot:
                lo = mid
            else:
                hi = mid
        x = lo
        out[t] = x
        s = int(freq[t, x]) * (s >> prob_bits) + slot - int(cdf[t, x])
        while s < C.RANS_L:
            s = (s << C.RENORM_SHIFT) | stream[ptr]
            ptr += 1
    return out
