"""Prediction-guided CDF search core (paper Sec. IV-C).

Port of ``repro.core.search`` with the same normative probe accounting
(the Fig. 4(b) unit is one CDF access):

  1. each candidate verify costs 1 probe per lane not yet resolved;
  2. every *active* binary-search iteration costs 1 probe; the equality
     early-commit (``cdf[mid] == slot`` proves ``symbol == mid``) collapses
     the bracket so later iterations stop counting.

CDF entries are below 2**31, so their int32 bit patterns compare as the
uint32 values they are.  The CUDA decode-step kernel
(``csrc/rans_decode_step.cu``) repeats this logic per lane.
"""

from __future__ import annotations

import torch

_I64 = torch.int64


def ceil_log2(k: int) -> int:
    """Fixed binary-search depth covering an alphabet of ``k`` symbols."""
    return max(1, (k - 1).bit_length())


def take_gather(field: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``field[..., x]`` for shared ``(K,)`` or per-lane ``(lanes, K)``
    tables."""
    if field.ndim == 1:
        return field[x]
    return torch.gather(field, -1, x[..., None].to(_I64))[..., 0]


def bsearch(cdf: torch.Tensor, slot: torch.Tensor, lo: torch.Tensor,
            hi: torch.Tensor, n_iter: int, gather=take_gather):
    """Masked fixed-depth binary search: x with cdf[x] <= slot < cdf[x+1];
    counts only the active iterations per lane."""
    steps = torch.zeros_like(lo)
    for _ in range(n_iter):
        active = (hi - lo) > 1
        mid = (lo + hi) >> 1
        c_mid = gather(cdf, mid).to(_I64)
        eq = active & (c_mid == slot)
        go_right = c_mid <= slot
        lo = torch.where(active & go_right, mid, lo)
        hi = torch.where(eq, mid + 1, torch.where(active & ~go_right, mid, hi))
        steps = steps + active.to(_I64)
    return lo, steps


def find_symbol(cdf: torch.Tensor, k: int, slot: torch.Tensor,
                candidates: torch.Tensor | None = None,
                gather=take_gather):
    """State-to-symbol inversion with optional candidate speculation.

    ``cdf``: ``(K+1,)`` or ``(lanes, K+1)``; ``slot``: ``(lanes,)`` int64;
    ``candidates``: optional ``(lanes, topk)`` trial symbols (``topk == 0``
    means none).  Returns int64 ``(symbol, probes)``.
    """
    if candidates is not None and candidates.shape[-1] == 0:
        candidates = None
    lanes = slot.shape[0]
    dev = slot.device
    lo0 = torch.zeros((lanes,), dtype=_I64, device=dev)
    hi0 = torch.full((lanes,), k, dtype=_I64, device=dev)
    probes = torch.zeros((lanes,), dtype=_I64, device=dev)
    found = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    x_spec = torch.zeros((lanes,), dtype=_I64, device=dev)

    if candidates is not None:
        for j in range(candidates.shape[-1]):
            cand = torch.clamp(candidates[:, j].to(_I64), 0, k - 1)
            ok = ((gather(cdf, cand).to(_I64) <= slot)
                  & (slot < gather(cdf, cand + 1).to(_I64)))
            probes = probes + (~found).to(_I64)
            x_spec = torch.where(~found & ok, cand, x_spec)
            found = found | ok

    lo0 = torch.where(found, x_spec, lo0)
    hi0 = torch.where(found, x_spec + 1, hi0)
    x, steps = bsearch(cdf, slot, lo0, hi0, ceil_log2(k), gather=gather)
    return x, probes + steps
