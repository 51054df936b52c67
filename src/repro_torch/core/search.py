"""Prediction-guided CDF search core (paper Sec. IV-C).

Port of ``repro.core.search`` with the same normative probe accounting
(the Fig. 4(b) unit is one CDF access):

  1. each candidate verify costs 1 probe per lane not yet resolved;
  2. the predictor's window verify costs 1 probe per lane the candidates
     did not resolve, on a bracket hit and on a miss alike;
  3. every *active* binary-search iteration costs 1 probe; the equality
     early-commit (``cdf[mid] == slot`` proves ``symbol == mid``) collapses
     the bracket so later iterations stop counting;
  4. the static-table LUT (``coder.pop(lut=...)``) costs exactly 1 probe.

CDF entries are below 2**31, so their int32 bit patterns compare as the
uint32 values they are.  The CUDA decode-step kernel
(``csrc/rans_decode_step.cu``) repeats this logic per lane; the
full-stream decode (``csrc/rans_decode_lanes.cu``) runs it on tables with
a zero frequency and otherwise replays the probe count from the symbol
(``csrc/decode_search.cuh``), of which :func:`replay_probes` is the plain
mirror.
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
                gather=take_gather, mu: torch.Tensor | None = None,
                delta=None):
    """State-to-symbol inversion with optional speculation.

    ``cdf``: ``(K+1,)`` or ``(lanes, K+1)``; ``slot``: ``(lanes,)`` int64;
    ``candidates``: optional ``(lanes, topk)`` trial symbols (``topk == 0``
    means none); ``mu``/``delta``: optional predictor bracket
    ``[mu - delta, mu + delta]``, verified with one probe per lane the
    candidates left unresolved, on a hit and on a miss alike.  Returns
    int64 ``(symbol, probes)``.
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

    if mu is not None:
        d = torch.as_tensor(delta, dtype=_I64, device=dev)
        lo_w = torch.clamp(mu.to(_I64) - d, 0, k - 1)
        hi_w = torch.clamp(mu.to(_I64) + d + 1, 1, k)
        hit = ((gather(cdf, lo_w).to(_I64) <= slot)
               & (slot < gather(cdf, hi_w).to(_I64)) & ~found)
        probes = probes + (~found).to(_I64)
        lo0 = torch.where(hit, lo_w, lo0)
        hi0 = torch.where(hit, hi_w, hi0)

    lo0 = torch.where(found, x_spec, lo0)
    hi0 = torch.where(found, x_spec + 1, hi0)
    x, steps = bsearch(cdf, slot, lo0, hi0, ceil_log2(k), gather=gather)
    return x, probes + steps


def bisect_probes(w: torch.Tensor, off: torch.Tensor,
                  at_start: torch.Tensor) -> torch.Tensor:
    """Active iterations of :func:`bsearch` from ``[lo, lo + w)`` down to
    ``lo + off`` on a strictly increasing CDF, ``at_start`` meaning ``slot
    == cdf[lo + off]`` (the early commit).  The search is translation
    invariant: ``(lo + hi) >> 1 == lo + (w >> 1)``."""
    w, off = w.to(_I64), off.to(_I64)
    probes = torch.zeros_like(w)
    while bool((w > 1).any()):
        act = w > 1
        mid = w >> 1
        right = act & (off >= mid)
        off = torch.where(right, off - mid, off)
        commit = right & at_start & (off == 0)
        w = torch.where(right, torch.where(commit, 1, w - mid),
                        torch.where(act, mid, w))
        probes = probes + act.to(_I64)
    return probes


def replay_probes(x: torch.Tensor, at_start: torch.Tensor,
                  candidates: torch.Tensor | None, lo_w, hi_w,
                  k: int) -> torch.Tensor:
    """The probes of :func:`find_symbol` from the symbol alone: the plain
    mirror of the CUDA decode kernel's replay (``csrc/decode_search.cuh``),
    exact when the CDF is strictly increasing (every frequency >= 1).

    ``x``: ``(lanes,)`` symbols; ``at_start``: ``slot == cdf[x]``;
    ``candidates``: ``(lanes, topk)`` or None (a candidate hits iff its
    clipped id equals ``x``); ``lo_w``/``hi_w``: the predictor's window
    ``[lo_w, hi_w)`` (already clipped) or None (it hits iff ``lo_w <= x <
    hi_w``).  Tests hold it against :func:`find_symbol`; nothing on the
    decode paths calls it."""
    x = x.to(_I64)
    at_start = at_start.to(torch.bool)
    cand = torch.zeros_like(x)
    found = torch.zeros_like(at_start)
    if candidates is not None and candidates.shape[-1] > 0:
        topk = candidates.shape[-1]
        hits = torch.clamp(candidates.to(_I64), 0, k - 1) == x[:, None]
        found = hits.any(-1)
        cand = torch.where(found, hits.to(torch.int8).argmax(-1) + 1, topk)
    lo = torch.zeros_like(x)
    w = torch.full_like(x, k)
    window = torch.zeros_like(x)
    if lo_w is not None:
        lo_w, hi_w = torch.as_tensor(lo_w).to(_I64), torch.as_tensor(hi_w).to(
            _I64)
        hit = (lo_w <= x) & (x < hi_w)
        lo = torch.where(hit, lo_w, lo)
        w = torch.where(hit, hi_w - lo_w, w)
        window = torch.ones_like(x)
    bis = bisect_probes(w, x - lo, at_start)
    return torch.where(found, cand, cand + window + bis)
