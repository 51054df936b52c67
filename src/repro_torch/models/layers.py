"""Shared layers: RMSNorm, RoPE, gated MLP, the recurrent blocks' causal
convolution (whole sequence and step), embeddings, the logits (tied or through ``lm_head``)
and the training losses.

Ports of ``repro.models.layers``, same weight layouts (``wi_gate (d, ff)``,
``wo (ff, d)``, ``embedding (Vpad, d)``).  In a bfloat16 model the norm
and the RoPE rotation compute in float32 and round once to bfloat16, as
the reference does; in a float32 model every cast below is the identity.

Under the compute placement (``parallel/sharding.place_model``)
:func:`mlp`, :func:`embed`, :func:`xent_loss`, :func:`chunked_xent_loss`
and :func:`rmsnorm` take the rank's ``place`` (a
``sharding.Placement``): the MLP is column-parallel into ``wi_gate``/
``wi_up`` and row-parallel out of ``wo``; the embedding and the logits
are vocabulary-parallel, each rank holding rows ``[vocab_start,
vocab_start + Vpad / tp)``; the cross entropy reduces its row max, its
sum of exponentials and the gold logit over ``model``.  Without
``place`` every function is the unplaced one, op for op.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5, place=None) -> torch.Tensor:
    """Second moment and scaling in float32 (bfloat16 squares are exact
    there), the result in ``x``'s type.  Placed (``place``), ``x`` and
    ``scale`` are this rank's slab of the normed dim (the SSM's gated
    norm over its channels): the sum of squares is summed over ``model``
    both ways (``place.model_total``) and divided by the whole width."""
    xf = x.float()
    sq, n = (xf * xf).sum(-1, keepdim=True), x.shape[-1]
    if place is not None:
        sq, n = place.model_total(sq), n * place.tp
    var = sq / n
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """The depthwise causal convolution of training, the reference's
    ``_causal_conv``: ``x`` (B, S, C) zero-padded by ``W - 1`` positions in
    front, against the taps ``w`` (W, C) (tap ``W - 1`` meets the current
    input), plus the bias (C,).  The taps sum in float32 in the
    reference's order and round once to the model's type, as
    :func:`conv_step` does at one position (identity in float32)."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0)).float()
    out = xp[:, :s] * w[0].float()
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i].float()
    return out.to(x.dtype) + b


def conv_step(hist: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """One output of a depthwise causal convolution: the history ``hist``
    (B, W, C) (oldest first, the newest input last) against the taps ``w``
    (W, C) plus the bias (C,), the reference's ``einsum("bwc,wc->bc")``:
    a float32 sum rounded once to the model's type."""
    return (hist.float() * w.float()).sum(1).to(hist.dtype) + b


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


_FREQS: dict = {}     # rope_freqs as float32 tensors, per device


def _freqs(dh: int, theta: float, device) -> torch.Tensor:
    """:func:`rope_freqs` on ``device``, copied there once (a copy from
    host memory would wait for the card at every step)."""
    key = (dh, theta, device)
    if key not in _FREQS:
        _FREQS[key] = torch.as_tensor(rope_freqs(dh, theta),
                                      dtype=torch.float32, device=device)
    return _FREQS[key]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions broadcastable to (..., S)."""
    dh = x.shape[-1]
    freqs = _freqs(dh, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def mlp(wi_gate: torch.Tensor, wi_up: torch.Tensor, wo: torch.Tensor,
        x: torch.Tensor, place=None) -> torch.Tensor:
    """The gated MLP; placed, on this rank's columns of ``d_ff``: the
    residual stream enters whole and the partial sums of ``wo`` leave
    reduced over ``model`` (``place.enter``/``place.exit``)."""
    if place is None:
        return (F.silu(x @ wi_gate) * (x @ wi_up)) @ wo
    x = place.enter(x)
    return place.exit((F.silu(x @ wi_gate) * (x @ wi_up)) @ wo)


def embed(embedding: torch.Tensor, tokens: torch.Tensor,
          place=None) -> torch.Tensor:
    """The rows of ``tokens``; placed, ``embedding`` is this rank's
    vocabulary rows: ids outside them give zero rows, and the sum over
    ``model`` (one nonzero term, so exact) is the lookup, this rank's
    sequence slab of it under sequence parallelism."""
    if place is None:
        return embedding[tokens]
    local = tokens - place.vocab_start
    ok = (local >= 0) & (local < embedding.shape[0])
    x = embedding[local.clamp(0, embedding.shape[0] - 1)]
    return place.exit(torch.where(ok[..., None], x, torch.zeros_like(x)))


def logits(embedding: torch.Tensor, x: torch.Tensor,
           lm_head: torch.Tensor | None = None) -> torch.Tensor:
    """Logits over the padded vocabulary: tied ``x @ E^T``, or ``x @
    lm_head`` (D, Vpad) when the config unties the head."""
    return x @ embedding.T if lm_head is None else x @ lm_head


def xent_loss(lg: torch.Tensor, labels: torch.Tensor,
              vocab_size: int, place=None) -> torch.Tensor:
    """Mean token cross entropy in float32; the padded vocabulary tail is
    pushed to -1e30 so it takes no mass.  Placed, ``lg`` is this rank's
    vocabulary shard: the tail is found by global index, the row max and
    the sum of exponentials are reduced over ``model``, and the gold logit
    comes from the one shard that holds the label."""
    lg = lg.to(torch.float32)
    if place is None:
        if lg.shape[-1] > vocab_size:
            lg = torch.cat([lg[..., :vocab_size],
                            lg[..., vocab_size:] - 1e30], -1)
        lse = torch.logsumexp(lg, dim=-1)
        gold = lg.gather(-1, labels[..., None].to(torch.int64))[..., 0]
        return (lse - gold).mean()
    n = lg.shape[-1]
    idx = place.vocab_start + torch.arange(n, device=lg.device)
    lg = torch.where(idx >= vocab_size, lg - 1e30, lg)
    m = place.model_max(lg.amax(-1))
    sumexp = place.model_sum(torch.exp(lg - m[..., None]).sum(-1))
    lse = m + torch.log(sumexp)
    local = labels.to(torch.int64) - place.vocab_start
    ok = (local >= 0) & (local < n)
    gold = lg.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = place.model_sum(torch.where(ok, gold, torch.zeros_like(gold)))
    return (lse - gold).mean()


def chunked_xent_loss(embedding: torch.Tensor, x: torch.Tensor,
                      labels: torch.Tensor, vocab_size: int, chunk: int,
                      lm_head: torch.Tensor | None = None,
                      place=None) -> torch.Tensor:
    """:func:`xent_loss` of the :func:`logits` over ``chunk``-position
    slices of the sequence, averaged over the slices: never holds the
    whole ``(B, S, V)`` logits.  Placed, ``x`` is the whole sequence on
    every model rank and the heads are this rank's vocabulary shard."""
    s = x.shape[1]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of "
                         f"logits_chunk {chunk}")
    total = x.new_zeros((), dtype=torch.float32)
    for c in range(0, s, chunk):
        total = total + xent_loss(logits(embedding, x[:, c:c + chunk],
                                         lm_head),
                                  labels[:, c:c + chunk], vocab_size, place)
    return total / (s // chunk)
