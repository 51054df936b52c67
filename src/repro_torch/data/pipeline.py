"""Deterministic synthetic token streams (numpy, seeded).

A copy of ``repro.data.pipeline.token_stream``: the same seed gives the
same tokens in both packages.
"""

from __future__ import annotations

import numpy as np


def _rng(*keys: int) -> np.random.Generator:
    return np.random.default_rng([k & 0x7FFFFFFF for k in keys])


def token_stream(vocab: int, shape: tuple, *, seed: int = 0,
                 zipf_a: float = 1.3, momentum: float = 0.3) -> np.ndarray:
    """Zipf ranks with first-order momentum: compressible, non-trivial."""
    rng = _rng(seed, vocab, *shape)
    n = int(np.prod(shape))
    ranks = rng.zipf(zipf_a, size=n).astype(np.int64)
    toks = (ranks - 1) % vocab
    # momentum: with prob `momentum`, repeat the previous symbol
    rep = rng.random(n) < momentum
    out = toks.copy()
    for i in range(1, n):
        if rep[i]:
            out[i] = out[i - 1]
    return out.reshape(shape)
