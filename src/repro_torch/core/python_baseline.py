"""The paper's comparison target: a plain single-lane Python rANS codec.

Fig. 4(a) of the RAS paper normalizes against "a Python rANS implementation"
running on an Apple M4.  This module is that baseline, a copy of
``repro.core.python_baseline``, kept deliberately idiomatic-Python (dicts,
lists, per-symbol interpreter loop, no numpy vectorization) so the speedup
measured by the Fig. 4(a) phase of ``chip_smoke.py`` is an apples-to-apples
reproduction of the paper's measurement protocol
("cycle-normalized compute cost ... same symbolization and CDFs, so the
bitstreams are identical").
"""

from __future__ import annotations

from repro_torch.core import constants as C


class PyRans:
    """Single-lane software rANS with while-loop renorm and binary search."""

    def __init__(self, freq, cdf, prob_bits: int = C.PROB_BITS):
        self.prob_bits = prob_bits
        self.mask = (1 << prob_bits) - 1
        self.scale = C.x_max_scale(prob_bits)
        self.freq = [int(f) for f in freq]
        self.cdf = [int(c) for c in cdf]
        self.k = len(self.freq)
        self.search_steps = 0  # instrumentation for Fig. 4(b)

    # -- encode ------------------------------------------------------------
    def encode(self, symbols) -> bytes:
        s = C.RANS_L
        rev = []
        freq, cdf, scale, n = self.freq, self.cdf, self.scale, self.prob_bits
        for x in reversed(symbols):
            f = freq[x]
            x_max = scale * f
            while s >= x_max:
                rev.append(s & 0xFF)
                s >>= 8
            s = ((s // f) << n) + (s % f) + cdf[x]
        head = [(s >> 24) & 0xFF, (s >> 16) & 0xFF, (s >> 8) & 0xFF, s & 0xFF]
        rev.reverse()
        return bytes(head + rev)

    # -- decode ------------------------------------------------------------
    def _search(self, slot: int) -> int:
        """Baseline binary search over the CDF; counts steps like Fig. 4(b)."""
        lo, hi = 0, self.k
        while hi - lo > 1:
            self.search_steps += 1
            mid = (lo + hi) >> 1
            if self.cdf[mid] <= slot:
                lo = mid
            else:
                hi = mid
        return lo

    def decode(self, stream: bytes, n_symbols: int) -> list:
        s = int.from_bytes(stream[:4], "big")
        ptr = 4
        out = []
        freq, cdf, n, mask = self.freq, self.cdf, self.prob_bits, self.mask
        for _ in range(n_symbols):
            slot = s & mask
            x = self._search(slot)
            out.append(x)
            s = freq[x] * (s >> n) + slot - cdf[x]
            while s < C.RANS_L:
                s = (s << 8) | stream[ptr]
                ptr += 1
        return out
