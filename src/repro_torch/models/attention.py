"""Grouped-query self-attention decode against a KV ring cache.

Port of ``repro.models.attention.attn_decode`` and its single attend core
``_attend_slots``.  Two properties of the reference are kept, not its
floats (DESIGN.md §11):

* **fixed 32-slot tiles** (``_RING_BLOCK``): scores are one batched GEMM of
  fixed per-tile shape, and the softmax denominator and the weighted value
  sum accumulate tile by tile in a fixed sequential order, so a longer ring
  only appends all-zero tiles that add an exact +0.0;
* **query extent 1**: every attend sees one query position, the shape a
  later prefill path must reuse to stay bitwise equal to the step path.

The cache is allocated with its slot axis padded to a whole number of
tiles; slots past the ring length are never valid.  The step writes its
K/V row in place (the reference returns a new cache).
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope

_NEG = -1e30
_RING_BLOCK = 32


def ring_slots(max_len: int) -> int:
    """Allocated slot count: ``max_len`` padded to whole ``_RING_BLOCK``
    tiles."""
    return -(-max_len // _RING_BLOCK) * _RING_BLOCK


def _seq_sum(tiles: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in a fixed left-to-right order (tile by tile)."""
    acc = torch.zeros_like(tiles.select(dim, 0))
    for i in range(tiles.shape[dim]):
        acc = acc + tiles.select(dim, i)
    return acc


def _attend_slots(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                  valid: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Single-position attention: q (B,1,Hp,Dh) against the tile-padded
    cache (B,Rp,KV,Dh) under a (B|1, Rp) slot mask -> (B,1,Hp,Dh)."""
    hp, kv, dh = cfg.n_heads_padded, cfg.n_kv_heads, cfg.head_dim_
    if kv == 0 or hp % kv:
        raise ValueError(f"grouped decode needs n_heads_padded % n_kv_heads"
                         f" == 0; got {hp} and {kv}")
    g = hp // kv
    b, rp = ck.shape[:2]
    nb = rp // _RING_BLOCK
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, kv, 1, g, dh)
    kt = ck.view(b, nb, _RING_BLOCK, kv, dh).permute(0, 3, 1, 4, 2)
    s = torch.matmul(qg, kt)                       # (B, KV, nb, g, BLOCK)
    s = s.permute(0, 1, 3, 2, 4).reshape(b, kv, g, rp) * scale
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, torch.full_like(s, _NEG))
    m = s.amax(-1, keepdim=True)
    e = torch.where(vmask, torch.exp(s - m), torch.zeros_like(s))
    tiles = e.view(b, kv, g, nb, _RING_BLOCK)
    prob = e / _seq_sum(tiles.sum(-1), dim=-1)[..., None]
    pt = prob.view(b, kv, g, nb, _RING_BLOCK).transpose(2, 3)
    vt = cv.view(b, nb, _RING_BLOCK, kv, dh).permute(0, 3, 1, 2, 4)
    out = _seq_sum(torch.matmul(pt, vt), dim=2)    # (B, KV, g, Dh)
    return out.reshape(b, 1, hp, dh)


def attn_decode(wq, wk, wv, wo, x1: torch.Tensor, ck: torch.Tensor,
                cv: torch.Tensor, cache_len: int, pos: int,
                cfg: ModelConfig) -> torch.Tensor:
    """One-token decode at absolute position ``pos`` (a Python int shared by
    all rows).  ``x1``: (B,1,D); ``ck``/``cv``: this layer's (B,Rp,KV,Dh)
    cache, written in place at ``slot = pos % cache_len`` (a cache shorter
    than the stream rings; entries older than ``cache_len`` age out)."""
    b, _, d = x1.shape
    hp, kv, dh = cfg.n_heads_padded, cfg.n_kv_heads, cfg.head_dim_
    q = (x1 @ wq.reshape(d, hp * dh)).view(b, 1, hp, dh)
    k = (x1 @ wk.reshape(d, kv * dh)).view(b, 1, kv, dh)
    v = (x1 @ wv.reshape(d, kv * dh)).view(b, 1, kv, dh)
    pos_t = torch.full((1, 1), pos, dtype=torch.int64, device=x1.device)
    q = apply_rope(q, pos_t, cfg.rope_theta)
    k = apply_rope(k, pos_t, cfg.rope_theta)
    slot = pos % cache_len
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]
    idx = torch.arange(ck.shape[1], device=x1.device)
    age = (slot - idx) % cache_len
    valid = ((age <= pos) & (idx < cache_len))[None]
    out = _attend_slots(q, ck, cv, valid, cfg)
    return out.reshape(b, 1, hp * dh) @ wo.reshape(hp * dh, d)
