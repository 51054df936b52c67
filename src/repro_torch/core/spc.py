"""Streaming Prefetch Converter (SPC): BF16 probabilities -> fixed point.

Port of ``repro.core.spc`` (paper Sec. IV-A).  Distributions are stored in
BF16; one conversion gives ``f(x) = max(1, round(p_x * 2**n))`` and one
deterministic largest-remainder pass makes ``sum f == 2**n`` with every
``f >= 1``.  The SPC also emits the Barrett planes ``(rcp, rshift, bias,
cmpl, x_max)`` so the encoder never divides.

Every table field is an ``int32`` tensor of uint32 bit patterns (see
:mod:`repro_torch.core.u32`); the construction itself runs in int64.
Results are integer-identical to the JAX reference on the same BF16
probabilities, tie patterns included (``torch.sort(stable=True)`` and
``torch.round``'s half-to-even match ``jnp.argsort(stable=True)`` and
``jnp.round``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import constants as C
from repro_torch.core import u32

_I64 = torch.int64


class TableSet(NamedTuple):
    """Fixed-point coding tables for one distribution or a batch ``(..., K)``.

    int32 bit patterns of uint32 values; ``cdf`` has one more entry than the
    others (``cdf[..., K] == 2**prob_bits``).
    """

    freq: torch.Tensor      # (..., K)   quantized frequencies, >= 1
    cdf: torch.Tensor       # (..., K+1) exclusive prefix sums
    rcp: torch.Tensor       # (..., K)   Barrett reciprocal
    rshift: torch.Tensor    # (..., K)   post-mulhi shift
    bias: torch.Tensor      # (..., K)   additive bias (folds CDF + f==1)
    cmpl: torch.Tensor      # (..., K)   2**n - f
    x_max: torch.Tensor     # (..., K)   encoder renorm threshold

    @property
    def alphabet_size(self) -> int:
        return self.freq.shape[-1]


def store_bf16(probs: torch.Tensor) -> torch.Tensor:
    """The paper's BF16 global-memory storage of distributions."""
    return probs.to(torch.bfloat16)


def quantize_probs(probs: torch.Tensor,
                   prob_bits: int = C.PROB_BITS) -> torch.Tensor:
    """BF16/float probabilities ``(..., K)`` -> int32 frequencies, mass 2**n.

    One stable ascending sort; the descending stable rank follows from
    tie-run bookkeeping (``rank_desc = K - runlen + 2*pos_in_run -
    rank_asc``) and the inverse permutations are scatters, as in the
    reference.
    """
    C.check_prob_bits(prob_bits)
    total = 1 << prob_bits
    k = probs.shape[-1]
    if k > total:
        raise ValueError(
            f"alphabet size {k} exceeds 2**prob_bits={total}; raise prob_bits")

    p = probs.to(torch.bfloat16).to(torch.float32)
    p = torch.where(torch.isfinite(p) & (p > 0), p, torch.zeros_like(p))
    scaled = p * float(total)

    f0 = torch.clamp(torch.round(scaled), min=1.0).to(_I64)
    delta = total - f0.sum(-1, keepdim=True)                  # (..., 1)
    resid = scaled - f0.to(torch.float32)

    sortd, order_asc = torch.sort(resid, dim=-1, stable=True)
    pidx = torch.arange(k, dtype=_I64, device=probs.device).expand(
        resid.shape)
    edge = torch.ones(resid.shape[:-1] + (1,), dtype=torch.bool,
                      device=probs.device)
    first = torch.cat([edge, sortd[..., 1:] != sortd[..., :-1]], -1)
    last = torch.cat([first[..., 1:], edge], -1)
    start = torch.cummax(torch.where(first, pidx, 0), dim=-1).values
    end = torch.flip(torch.cummin(
        torch.flip(torch.where(last, pidx, k - 1), [-1]), dim=-1).values,
        [-1])
    runlen = end - start + 1
    rank_desc_sorted = k - runlen + 2 * (pidx - start) - pidx

    # delta > 0: floor(delta/K) to every symbol, the remainder to the
    # largest residuals (stable largest-remainder rule)
    rank_desc = torch.zeros_like(pidx).scatter(-1, order_asc,
                                               rank_desc_sorted)
    f_pos = f0 + delta // k + (rank_desc < delta % k).to(_I64)

    # delta < 0: remove -delta units, smallest residual first, never below 1
    need = -delta
    cap_sorted = torch.gather(f0 - 1, -1, order_asc)
    cum_excl = torch.cumsum(cap_sorted, -1) - cap_sorted
    take_sorted = torch.minimum(torch.clamp(need - cum_excl, min=0),
                                cap_sorted)
    take = torch.zeros_like(pidx).scatter(-1, order_asc, take_sorted)
    f_neg = f0 - take

    return torch.where(delta >= 0, f_pos, f_neg).to(torch.int32)


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """``int.bit_length`` of non-negative int64 values below 2**32, in exact
    integer steps (a binary search over the shift), like the reference's
    ``32 - clz``.  A float ``log2`` is not exact on every device: on CUDA
    it can land below an exact power of two and floor one short."""
    n = torch.zeros_like(x)
    for sh in (16, 8, 4, 2, 1):
        big = x >= (1 << sh)
        n = n + big * sh
        x = torch.where(big, x >> sh, x)
    return n + (x > 0)


def barrett_planes(freq: torch.Tensor, start: torch.Tensor, prob_bits: int):
    """``(freq, start)`` -> int32 planes ``(rcp, rshift, bias, cmpl, x_max)``.

    ``rcp = ceil(2**(31 + s) / f)`` with ``s = ceil(log2 f)`` (exact in
    int64), the f == 1 corner folded into ``bias`` exactly as the
    reference's uint32 construction.
    """
    total = 1 << prob_bits
    f = u32.value(freq)
    start = u32.value(start)
    is_one = f == 1
    f2 = torch.clamp(f, min=2)
    shift = _bit_length(f2 - 1)
    rcp_ge2 = ((torch.ones_like(f) << (31 + shift)) + f2 - 1) // f2
    rcp = torch.where(is_one, torch.full_like(f, C.U32_MASK), rcp_ge2)
    rshift = torch.where(is_one, torch.zeros_like(f), shift - 1)
    bias = torch.where(is_one, start + total - 1, start)
    cmpl = total - f
    x_max = C.x_max_scale(prob_bits) * f
    return tuple(u32.bits(a) for a in (rcp, rshift, bias, cmpl, x_max))


def _cdf(f: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros(f.shape[:-1] + (1,), dtype=_I64, device=f.device)
    return torch.cat([zeros, torch.cumsum(f.to(_I64), -1)], -1).to(
        torch.int32)


def build_tables(freq: torch.Tensor,
                 prob_bits: int = C.PROB_BITS) -> TableSet:
    """Quantized frequencies -> full fixed-point TableSet (batched OK)."""
    C.check_prob_bits(prob_bits)
    f = freq.to(torch.int32)
    cdf = _cdf(f)
    rcp, rshift, bias, cmpl, x_max = barrett_planes(f, cdf[..., :-1],
                                                    prob_bits)
    return TableSet(freq=f, cdf=cdf, rcp=rcp, rshift=rshift, bias=bias,
                    cmpl=cmpl, x_max=x_max)


def freq_cdf_from_probs(probs: torch.Tensor, prob_bits: int = C.PROB_BITS):
    """Decode-only SPC fast path: probabilities -> ``(freq, cdf)``, equal to
    ``(t.freq, t.cdf)`` of :func:`tables_from_probs` bit for bit."""
    f = quantize_probs(probs, prob_bits)
    return f, _cdf(f)


def tables_from_probs(probs: torch.Tensor,
                      prob_bits: int = C.PROB_BITS) -> TableSet:
    """One-shot SPC: BF16 probabilities -> coding tables."""
    return build_tables(quantize_probs(probs, prob_bits), prob_bits)


def tables_from_logits(logits: torch.Tensor,
                       prob_bits: int = C.PROB_BITS) -> TableSet:
    """Model logits ``(..., K)`` -> coding tables: softmax in float32,
    stored as BF16, then the SPC."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return tables_from_probs(store_bf16(probs), prob_bits)


class FreqCdf(NamedTuple):
    """The two planes a decoder reads (a :class:`TableSet` without the
    encoder's Barrett planes)."""

    freq: torch.Tensor      # (..., K)
    cdf: torch.Tensor       # (..., K+1)


def decode_lut(tables, prob_bits: int = C.PROB_BITS) -> torch.Tensor:
    """Static-table slot -> symbol lookup, ``(2**prob_bits,)`` int64: one
    gather replaces the CDF search."""
    slots = torch.arange(1 << prob_bits, dtype=_I64, device=tables.cdf.device)
    return torch.searchsorted(tables.cdf.to(_I64), slots, right=True) - 1


def tables_from_counts_np(counts: np.ndarray,
                          prob_bits: int = C.PROB_BITS) -> TableSet:
    """Raw symbol counts (numpy) -> host TableSet, with +1 smoothing."""
    counts = np.asarray(counts, np.float64)
    probs = (counts + 1.0) / (counts + 1.0).sum(-1, keepdims=True)
    return tables_from_probs(torch.as_tensor(probs.astype(np.float32)),
                             prob_bits)
