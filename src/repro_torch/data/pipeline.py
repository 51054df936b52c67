"""Deterministic synthetic data (numpy, seeded).

Copies of ``repro.data.pipeline``'s ``token_stream``, ``image_rows``,
``synthetic_image``, ``candidate_planes`` and ``train_batch``: the same
seed gives the same values in both packages.
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


def image_rows(lanes: int, t: int, *, seed: int = 0,
               step_scale: int = 3) -> np.ndarray:
    """Smooth random-walk rows in [0, 255]: image-like raster symbols."""
    rng = _rng(seed, lanes, t)
    steps = rng.integers(-step_scale, step_scale + 1, (lanes, t))
    return np.clip(128 + np.cumsum(steps, axis=1), 0, 255).astype(np.int64)


def synthetic_image(h: int, w: int, *, seed: int = 0) -> np.ndarray:
    """2-D smooth field (separable random walk plus noise) as uint8."""
    rng = _rng(seed, h, w)
    rows = np.cumsum(rng.integers(-2, 3, (h, 1)), axis=0)
    cols = np.cumsum(rng.integers(-2, 3, (1, w)), axis=1)
    noise = rng.integers(-4, 5, (h, w))
    img = 128 + rows + cols + noise
    return np.clip(img, 0, 255).astype(np.uint8)


def candidate_planes(syms: np.ndarray, k: int, topk: int,
                     hit_rate: float, seed: int = 0) -> np.ndarray:
    """(T, lanes, topk) model-top-k stand-in: slot 0 holds the true symbol
    with probability ``hit_rate``, the other slots random alphabet ids."""
    rng = _rng(seed, k, topk)
    syms = np.asarray(syms)
    lanes, t = syms.shape
    cands = rng.integers(0, k, (t, lanes, topk))
    hit = rng.random((t, lanes)) < hit_rate
    cands[..., 0] = np.where(hit, syms.T, cands[..., 0])
    return cands.astype(np.int32)


def train_batch(cfg, batch: int, seq: int, *, step: int = 0, host: int = 0,
                seed: int = 0) -> dict:
    """One training batch for ``cfg``: ``tokens`` and next-token
    ``labels``, ``(batch, seq)`` int32 from one :func:`token_stream` seeded
    by ``(seed, step, host)``; a ``vlm`` config's ``memory`` and an
    encoder-decoder's ``enc_inputs``, ``(batch, memory_tokens, d_model)``
    float32 normal draws x 0.02, in that order from one generator seeded
    by ``(seed, step, host, batch, seq)``."""
    rng = _rng(seed, step, host, batch, seq)
    toks = token_stream(cfg.vocab_size, (batch, seq + 1),
                        seed=seed * 1000003 + step * 101 + host)
    out = {"tokens": toks[:, :-1].astype(np.int32),
           "labels": toks[:, 1:].astype(np.int32)}
    if cfg.family == "vlm":
        out["memory"] = (rng.standard_normal(
            (batch, cfg.memory_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    if cfg.is_encdec:
        out["enc_inputs"] = (rng.standard_normal(
            (batch, cfg.memory_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    return out
