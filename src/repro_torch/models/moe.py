"""Mixture-of-Experts FFN: top-k routing, the reference's two dispatch
schedules, and the fixed-shape form of a serving step.

Port of ``repro.models.moe`` (same weight layouts: ``router (D, E)``,
``wi_gate``/``wi_up (E, D, F)``, ``wo (E, F, D)``).

* :func:`moe_capacity` (the default, ``moe_impl="capacity"``): tokens are
  ranked within their expert, row by row of the batch, in token-major
  order, and dropped beyond ``cap = max(4, ceil(k * S / E *
  capacity_factor))`` rounded up to a multiple of 4; each expert runs over
  its ``(B, cap, D)`` slots and the k outputs fold back token-major with
  the router weights.  At S > 1 a row's tokens compete for the slots, so
  tokens drop; at S = 1 every row's k picks take slot 0 of k distinct
  experts and nothing drops.
* :func:`moe_dense`: every expert runs every token, folded by a gate row
  that holds the k router weights (exact, no drops).
* :func:`moe_step`: the serving step's form (S = 1).  Every expert runs
  over the step's B rows in one batched product (each expert's weights are
  read once, as the reference's all-expert einsum reads them; the rows
  that did not pick an expert are wasted FLOPs, few at B = 16), then each
  row takes its k picks.  Its shapes never depend on the routing: no row
  counts, no ``nonzero``, no host read, so an expert's product rounds the
  same whoever picked it and the step can run under
  ``torch.cuda.set_sync_debug_mode("error")``.  It folds each row's k
  picks token-major, as :func:`moe_capacity` folds one token; at S = 1
  nothing drops, so this is also :func:`moe_dense`'s function (its gate
  row sums the same k products in another order).

Top-k keeps ``jax.lax.top_k``'s order: among equal probabilities the lower
expert index comes first.  Router logits are rounded to the model's type
before the float32 softmax, so in bfloat16 equal probabilities are common,
and a tie between the k-th and the (k+1)-th place decides which experts
run.  :func:`topk_first` (``core.predictors``, shared with the decode's
top-k candidates) is a stable descending sort, which keeps that order on
both devices.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.predictors import topk_first
from repro_torch.models.config import ModelConfig


class MoE(nn.Module):
    """The expert FFN's parameters."""

    @staticmethod
    def axes(cfg: ModelConfig) -> dict:
        """Each leaf's logical axes (``make_moe_defs``)."""
        return {"router": ("embed", None),
                "wi_gate": ("experts", "embed", "mlp"),
                "wi_up": ("experts", "embed", "mlp"),
                "wo": ("experts", "mlp", "embed")}

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = nn.Parameter(torch.empty(d, e))
        self.wi_gate = nn.Parameter(torch.empty(e, d, ff))
        self.wi_up = nn.Parameter(torch.empty(e, d, ff))
        self.wo = nn.Parameter(torch.empty(e, ff, d))


def _gate(p: MoE, x2: torch.Tensor, cfg: ModelConfig):
    """x2 (N, D) -> (router probabilities (N, E) float32, normalised top-k
    weights (N, k) in x2's type, expert ids (N, k) int64)."""
    logits = (x2 @ p.router).float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = topk_first(probs, cfg.topk_experts)
    w = w / w.sum(-1, keepdim=True)
    return probs, w.to(x2.dtype), ids


def _route(p: MoE, x2: torch.Tensor, cfg: ModelConfig):
    """x2 (N, D) -> (weights (N, k), ids (N, k), the Switch-style
    load-balance loss ``E * sum_e f_e * p_e`` over the first picks)."""
    probs, w, ids = _gate(p, x2, cfg)
    e = cfg.n_experts
    f_e = F.one_hot(ids[:, 0], e).float().mean(0)
    aux = e * (f_e * probs.mean(0)).sum()
    return w, ids, aux


def _gates(w: torch.Tensor, ids: torch.Tensor, e: int) -> torch.Tensor:
    """(N, E) gate rows in w's type: the k weights at their experts."""
    iota = torch.arange(e, device=w.device)
    gates = w.new_zeros((w.shape[0], e))
    for j in range(ids.shape[1]):
        gates = gates + (iota == ids[:, j:j + 1]).to(w.dtype) * w[:, j:j + 1]
    return gates


def moe_dense(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, D) -> (out (B, S, D), aux): every expert over every token."""
    b, s, d = x.shape
    x2 = x.reshape(-1, d)
    w, ids, aux = _route(p, x2, cfg)
    g = torch.einsum("nd,edf->nef", x2, p.wi_gate)
    u = torch.einsum("nd,edf->nef", x2, p.wi_up)
    y = torch.einsum("nef,efd->ned", F.silu(g) * u, p.wo)
    out = torch.einsum("ned,ne->nd", y, _gates(w, ids, cfg.n_experts))
    return out.reshape(b, s, d), aux


def moe_capacity(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, D) -> (out (B, S, D), aux): the reference's group-limited
    capacity dispatch, drops included."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.topk_experts
    w, ids, aux = _route(p, x.reshape(-1, d), cfg)
    cap = int(math.ceil(k * s / e * cfg.capacity_factor))
    cap = max(4, -(-cap // 4) * 4)        # a multiple of 4, at least 4
    eid = ids.reshape(b, s * k)                       # token-major (s, k)
    wgt = w.reshape(b, s * k)
    tok = torch.arange(s, device=x.device).repeat_interleave(k)
    onehot = F.one_hot(eid, e)                        # (B, A, E)
    rank = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)
    keep = rank < cap
    slot = torch.where(keep, eid * cap + rank, e * cap)
    bidx = torch.arange(b, device=x.device)[:, None].expand_as(slot)
    # one spare slot past the experts takes the dropped tokens' writes
    buf = x.new_zeros((b, e * cap + 1, d))
    buf[bidx, slot] = x[:, tok]
    buf = buf[:, :e * cap].reshape(b, e, cap, d)
    g = torch.einsum("becd,edf->becf", buf, p.wi_gate)
    u = torch.einsum("becd,edf->becf", buf, p.wi_up)
    yb = torch.einsum("becf,efd->becd", F.silu(g) * u, p.wo)
    flat = yb.reshape(b, e * cap, d)
    gathered = flat[bidx, torch.clamp(slot, max=e * cap - 1)]
    gathered = gathered * keep[..., None].to(x.dtype) * wgt[..., None]
    return gathered.reshape(b, s, k, d).sum(2), aux


def moe(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """The configured schedule over a whole sequence (training)."""
    if cfg.moe_impl == "dense":
        return moe_dense(p, x, cfg)
    return moe_capacity(p, x, cfg)


def moe_step(p: MoE, x1: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The serving step's MoE FFN: x1 (B, 1, D) -> (B, 1, D), every
    expert over the B rows at fixed shapes, each row's k picks folded
    token-major (no token drops at S = 1, whichever the schedule)."""
    b, _, d = x1.shape
    x2 = x1.reshape(b, d)
    _, w, ids = _gate(p, x2, cfg)
    g = torch.matmul(x2, p.wi_gate)                   # (E, B, F)
    u = torch.matmul(x2, p.wi_up)
    y = torch.matmul(F.silu(g) * u, p.wo)             # (E, B, D)
    rows = torch.arange(b, device=x1.device)[:, None]
    out = (y[ids, rows] * w[..., None]).sum(1)        # (B, k, D) -> (B, D)
    return out.reshape(b, 1, d)
