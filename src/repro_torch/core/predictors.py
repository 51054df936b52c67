"""Decode-side predictors (paper Sec. IV-C).

Port of ``repro.core.predictors``.  A predictor proposes an anchor ``mu``
and a tolerance ``delta``; the decoder verifies the bracket ``[mu - delta,
mu + delta]`` against the CDF with one probe and falls back to the full
binary search on a miss, so only the probe count depends on it, never the
symbols.  The context of previously decoded symbols is a ``(lanes,
window)`` int64 tensor that the decode loop threads through ``predict`` and
``update``; it resets at every chunk (chunks are standalone streams).

Configs are hashable NamedTuples that compare by type as well as fields
(``LastValue(8) != ZeroPredictor(8)``), as in the reference.  The CUDA
full-stream decode kernel (``csrc/rans_decode_lanes.cu``) keeps the
``NeighborAverage`` window as a ring with a running sum
(:func:`running_mean_mu` is its plain mirror).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_I64 = torch.int64


class Prediction(NamedTuple):
    mu: torch.Tensor                        # (lanes,) int64 anchor symbol
    delta: int                              # half-window
    candidates: torch.Tensor | None = None  # (lanes, k) trial symbols


def _static_config(cls):
    """Make a NamedTuple config hash and compare by type as well as fields
    (plain NamedTuples compare as bare tuples)."""

    def __eq__(self, other):
        return type(other) is type(self) and tuple(self) == tuple(other)

    cls.__eq__ = __eq__
    cls.__ne__ = lambda self, other: not __eq__(self, other)
    cls.__hash__ = lambda self: hash((cls.__qualname__,) + tuple(self))
    return cls


@_static_config
class NeighborAverage(NamedTuple):
    """Mean of the last ``window`` decoded symbols (the paper's Fig. 3
    image predictor); last value with one neighbour, zero with none."""

    window: int = 4
    delta: int = 8

    def init(self, lanes: int, device=None) -> torch.Tensor:
        return torch.full((lanes, self.window), -1, dtype=_I64,
                          device=device)

    def predict(self, ctx: torch.Tensor) -> Prediction:
        valid = ctx >= 0
        n_valid = valid.sum(-1)
        ssum = torch.where(valid, ctx, 0).sum(-1)
        mu = torch.where(n_valid > 0, ssum // n_valid.clamp(min=1), 0)
        return Prediction(mu=mu, delta=self.delta)

    def update(self, ctx: torch.Tensor, decoded: torch.Tensor):
        return torch.cat([ctx[:, 1:], decoded.to(_I64)[:, None]], dim=1)


@_static_config
class LastValue(NamedTuple):
    """Anchor = the previous symbol (0 before the first)."""

    delta: int = 8

    def init(self, lanes: int, device=None) -> torch.Tensor:
        return torch.zeros((lanes, 1), dtype=_I64, device=device)

    def predict(self, ctx: torch.Tensor) -> Prediction:
        return Prediction(mu=ctx[:, 0], delta=self.delta)

    def update(self, ctx: torch.Tensor, decoded: torch.Tensor):
        return decoded.to(_I64)[:, None]


@_static_config
class ZeroPredictor(NamedTuple):
    """Anchor 0, the paper's "zero fallback"."""

    delta: int = 8

    def init(self, lanes: int, device=None) -> torch.Tensor:
        return torch.zeros((lanes, 0), dtype=_I64, device=device)

    def predict(self, ctx: torch.Tensor) -> Prediction:
        return Prediction(mu=torch.zeros((ctx.shape[0],), dtype=_I64,
                                         device=ctx.device),
                          delta=self.delta)

    def update(self, ctx: torch.Tensor, decoded: torch.Tensor):
        return ctx


def mean_rcp(n: int) -> int:
    """``ceil(2**32 / n)`` for ``n >= 2`` (0 otherwise): the CUDA decode
    kernel's ``sum // n`` is ``(sum * mean_rcp(n)) >> 32``, exact for sums
    below ``2**28``."""
    return (0xFFFFFFFF // n) + 1 if n > 1 else 0


def running_mean_mu(symbols: torch.Tensor, window: int,
                    chunk: int) -> torch.Tensor:
    """The anchors ``NeighborAverage(window)`` gives at every step of
    ``symbols (lanes, T)``, the context reset every ``chunk`` steps, as the
    CUDA decode kernel computes them: a ring of the last ``window`` symbols
    with a running sum and a valid count, ``mu = sum // n_valid`` (0 with
    none) taken as the kernel takes it, ``(sum * mean_rcp(n_valid)) >> 32``.
    The plain mirror tests hold against :meth:`NeighborAverage.predict`;
    nothing on the decode paths calls it.  Returns int64 ``(lanes, T)``."""
    lanes, t_len = symbols.shape
    syms = symbols.to(_I64)
    mu = torch.zeros((lanes, t_len), dtype=_I64, device=symbols.device)
    ring = torch.zeros((lanes, window), dtype=_I64, device=symbols.device)
    total = torch.zeros((lanes,), dtype=_I64, device=symbols.device)
    cnt = head = 0
    for t in range(t_len):
        if t % chunk == 0:
            total.zero_()
            cnt = head = 0
        mu[:, t] = (total * mean_rcp(cnt)) >> 32 if cnt > 1 else total
        if cnt == window:
            total -= ring[:, head]
        else:
            cnt += 1
        total += syms[:, t]
        ring[:, head] = syms[:, t]
        head = (head + 1) % window
    return mu


def topk_first(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: (values, indices), each (...,
    k), the largest first and the lower index first among equal values.

    A stable descending sort keeps that order on the CPU and on the card
    (``torch.topk`` orders ties otherwise on both), whatever the row holds:
    ``-inf`` entries sort last in index order, where repeated ``argmax``
    over a row masked with ``-inf`` could pick an index twice."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return x.gather(-1, idx), idx


def model_topk_candidates(logits: torch.Tensor, k: int) -> torch.Tensor:
    """(lanes, V) logits -> (lanes, k) int32 trial symbols, in
    ``jax.lax.top_k``'s order (:func:`topk_first`), so the per-lane probe
    counts are the reference's."""
    if k == 0:
        return torch.zeros((logits.shape[0], 0), dtype=torch.int32,
                           device=logits.device)
    return topk_first(logits, k)[1].to(torch.int32)
