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

Under the compute placement (``parallel/sharding.place_model``) the
three take the rank's ``place`` (a ``sharding.Placement``).  The router
runs on the residual stream as the rank holds it (under sequence
parallelism its slab, the logits then gathered whole,
``place.whole_sequence``), so every model rank of a data row gets the
same probabilities, ids and capacity ranks, and drops the same tokens as
the reference; the load-balance loss's expert shares are averaged over
the data slabs before their product (``place.batch_mean``: the
reference's means span every token of the batch).  The experts then run
on the whole sequence (``place.enter``) at the rank's share: under expert
parallelism (``place.moe_rule == "experts"``) its ``E / tp`` experts
from ``place.expert_start``, another rank's pick adding zero; under
per-expert tensor parallelism (``"mlp"``) every expert on its ``d_ff /
tp`` columns, as the gated MLP.  The k picks fold on those partial
outputs with the router weights (``place.fold``: their gradient is each
rank's part) and the fold is summed over ``model`` (``place.exit``).
Without ``place``, or at a ``model`` axis of 1, each function is the
unplaced one, op for op.

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


def _pick(logits: torch.Tensor, cfg: ModelConfig, dtype):
    """Router logits (N, E) -> (probabilities (N, E) float32, normalised
    top-k weights (N, k) in ``dtype``, expert ids (N, k) int64)."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, ids = topk_first(probs, cfg.topk_experts)
    w = w / w.sum(-1, keepdim=True)
    return probs, w.to(dtype), ids


def _gate(p: MoE, x2: torch.Tensor, cfg: ModelConfig):
    """x2 (N, D) -> (router probabilities (N, E) float32, normalised top-k
    weights (N, k) in x2's type, expert ids (N, k) int64)."""
    return _pick(x2 @ p.router, cfg, x2.dtype)


def _route(p: MoE, x: torch.Tensor, cfg: ModelConfig, place=None):
    """x (N, D), or (B, S, D) as the rank holds it -> (weights (N, k), ids
    (N, k), the Switch-style load-balance loss ``E * sum_e f_e * p_e``
    over the first picks), N = B x S over the whole sequence of the rows;
    placed, the slab's logits gathered whole and ``f_e``, ``p_e``
    averaged over the data slabs."""
    e = cfg.n_experts
    logits = x.reshape(-1, x.shape[-1]) @ p.router
    if place is not None and place.sp:
        logits = place.whole_sequence(
            logits.reshape(x.shape[:-1] + (e,))).reshape(-1, e)
    probs, w, ids = _pick(logits, cfg, x.dtype)
    f_e = F.one_hot(ids[:, 0], e).float().mean(0)
    p_e = probs.mean(0)
    if place is not None:
        f_e, p_e = place.batch_mean(f_e), place.batch_mean(p_e)
    aux = e * (f_e * p_e).sum()
    return w, ids, aux


def _share(p: MoE, place) -> tuple[int, int]:
    """(first expert, expert count) of the experts this rank runs: all of
    them unplaced and under per-expert tensor parallelism."""
    return (0 if place is None else place.expert_start), p.wi_gate.shape[0]


def _enter(x: torch.Tensor, w: torch.Tensor, place):
    """The experts' input and the fold's weights: placed, the whole
    sequence on every model rank and the weights whose gradient is summed
    over ``model``."""
    if place is None:
        return x, w
    return place.enter(x), place.fold(w)


def _gates(w: torch.Tensor, ids: torch.Tensor, e: int) -> torch.Tensor:
    """(N, E) gate rows in w's type: the k weights at their experts."""
    iota = torch.arange(e, device=w.device)
    gates = w.new_zeros((w.shape[0], e))
    for j in range(ids.shape[1]):
        gates = gates + (iota == ids[:, j:j + 1]).to(w.dtype) * w[:, j:j + 1]
    return gates


def moe_dense(p: MoE, x: torch.Tensor, cfg: ModelConfig, place=None):
    """x (B, S, D) -> (out (B, S, D), aux): every expert over every token
    (placed: the rank's experts or columns, the fold summed over
    ``model``)."""
    w, ids, aux = _route(p, x, cfg, place)
    x, w = _enter(x, w, place)
    b, s, d = x.shape
    x2 = x.reshape(-1, d)
    e0, el = _share(p, place)
    g = torch.einsum("nd,edf->nef", x2, p.wi_gate)
    u = torch.einsum("nd,edf->nef", x2, p.wi_up)
    y = torch.einsum("nef,efd->ned", F.silu(g) * u, p.wo)
    gates = _gates(w, ids, cfg.n_experts)
    if el < cfg.n_experts:
        gates = gates[:, e0:e0 + el]
    out = torch.einsum("ned,ne->nd", y, gates).reshape(b, s, d)
    return (out if place is None else place.exit(out)), aux


def moe_capacity(p: MoE, x: torch.Tensor, cfg: ModelConfig, place=None):
    """x (B, S, D) -> (out (B, S, D), aux): the reference's group-limited
    capacity dispatch, drops included (placed: the rank's experts' slots,
    or every expert's slots on the rank's columns; the fold summed over
    ``model``)."""
    w, ids, aux = _route(p, x, cfg, place)
    x, w = _enter(x, w, place)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.topk_experts
    e0, el = _share(p, place)
    cap = int(math.ceil(k * s / e * cfg.capacity_factor))
    cap = max(4, -(-cap // 4) * 4)        # a multiple of 4, at least 4
    eid = ids.reshape(b, s * k)                       # token-major (s, k)
    wgt = w.reshape(b, s * k)
    tok = torch.arange(s, device=x.device).repeat_interleave(k)
    onehot = F.one_hot(eid, e)                        # (B, A, E)
    rank = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)
    keep = rank < cap
    if el < e:                            # another rank's experts: zero
        keep = keep & (eid >= e0) & (eid < e0 + el)
    slot = torch.where(keep, (eid - e0) * cap + rank, el * cap)
    bidx = torch.arange(b, device=x.device)[:, None].expand_as(slot)
    # one spare slot past the experts takes the dropped tokens' writes
    buf = x.new_zeros((b, el * cap + 1, d))
    buf[bidx, slot] = x[:, tok]
    buf = buf[:, :el * cap].reshape(b, el, cap, d)
    g = torch.einsum("becd,edf->becf", buf, p.wi_gate)
    u = torch.einsum("becd,edf->becf", buf, p.wi_up)
    yb = torch.einsum("becf,efd->becd", F.silu(g) * u, p.wo)
    flat = yb.reshape(b, el * cap, d)
    gathered = flat[bidx, torch.clamp(slot, max=el * cap - 1)]
    gathered = gathered * keep[..., None].to(x.dtype) * wgt[..., None]
    out = gathered.reshape(b, s, k, d).sum(2)
    return (out if place is None else place.exit(out)), aux


def moe(p: MoE, x: torch.Tensor, cfg: ModelConfig, place=None):
    """The configured schedule over a whole sequence (training)."""
    if cfg.moe_impl == "dense":
        return moe_dense(p, x, cfg, place)
    return moe_capacity(p, x, cfg, place)


def moe_step(p: MoE, x1: torch.Tensor, cfg: ModelConfig,
             place=None) -> torch.Tensor:
    """The serving step's MoE FFN: x1 (B, 1, D) -> (B, 1, D), every
    expert over the B rows at fixed shapes, each row's k picks folded
    token-major (no token drops at S = 1, whichever the schedule).
    Placed (a serving ``Placement``: the stream whole on every model
    rank), the rank's experts or columns, the fold summed over
    ``model``."""
    b, _, d = x1.shape
    x2 = x1.reshape(b, d)
    _, w, ids = _gate(p, x2, cfg)
    e0, el = _share(p, place)
    g = torch.matmul(x2, p.wi_gate)                   # (E, B, F)
    u = torch.matmul(x2, p.wi_up)
    y = torch.matmul(F.silu(g) * u, p.wo)             # (E, B, D)
    rows = torch.arange(b, device=x1.device)[:, None]
    if el < cfg.n_experts:                # another rank's pick adds zero
        local = ids - e0
        w = w * ((local >= 0) & (local < el)).to(w.dtype)
        ids = local.clamp(0, el - 1)
    out = (y[ids, rows] * w[..., None]).sum(1)        # (B, k, D) -> (B, D)
    out = out.reshape(b, 1, d)
    return out if place is None else place.exit(out)
