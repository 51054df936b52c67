"""Grouped-query self-attention against a KV ring cache: the decode step
and the teacher-forced prefill; the full-sequence causal attention of
training (:func:`attn_forward`), naive or blockwise; and cross attention
over a memory (:func:`attn_forward` with ``mem``, :func:`attn_cross`).

Port of ``repro.models.attention.attn_decode``/``attn_prefill`` and their
single attend core ``_attend_slots``.  Two properties of the reference are
kept, not its floats (DESIGN.md §11):

* **fixed 32-slot tiles** (``_RING_BLOCK``): scores are one batched GEMM of
  fixed per-tile shape, and the softmax denominator and the weighted value
  sum accumulate tile by tile in a fixed sequential order, so a longer ring
  only appends all-zero tiles that add an exact +0.0 (on the card the
  batched GEMM's kernel still depends on the tile count, so a stream's
  floats depend on its ring length there);
* **query extent 1**: every attend sees one query position, the shape the
  prefill reuses to stay bitwise equal to the step path.

The cache is allocated with its slot axis padded to a whole number of
tiles; slots past the ring length are never valid.  The step writes its
K/V row in place (the reference returns a new cache).  A config with a
window (``cfg.window``: the hybrid's ``local_window``, mixtral's
``sliding_window``) rings a cache of ``min(max_len, window)`` slots and
also masks entries ``window`` or more positions old.  In a bfloat16
model the scores and the softmax run in float32 and the weights round to
bfloat16 before the value product, as the reference's
``preferred_element_type`` does.

The projections are the reference's ``_project_qkv`` in all three paths:
with ``cfg.qkv_bias`` the biases ``bq``/``bk``/``bv`` are added, then
with ``cfg.qk_norm`` q and k take a per-head RMSNorm over ``head_dim``;
RoPE follows.  A query head reads the kv head of the reference's
``kv_head_map``: the true heads in groups of ``n_heads // n_kv_heads``,
every padded head kv head 0.  Where ``n_heads`` is unpadded and a multiple
of ``n_kv_heads`` that is the grouping ``i // (n_heads // n_kv_heads)``,
and the heads contract against the kv heads directly; otherwise (for
example ``qwen1.5-4b``: 20 heads padded to 32 over 20 kv heads) the K/V
heads are gathered to the query heads first.

:func:`attn_forward` is the reference's naive schedule (``_naive_attn``:
one batched product for the scores in float32, the causal mask (and the
``sliding_window``, as the reference's training path reads it), softmax,
one batched product for the values) or, with ``attn_impl="blockwise"``,
its online softmax over ``attn_block`` key chunks (``_blockwise_attn``).
Neither has a tie to the decode path's tiles: trained weights are priced
by ``decode_step`` on both sides of a stream, so training needs no
bitwise tie to decode.

Cross attention is the reference's ``mem`` branch: K and V are the
memory's projections, there is no RoPE and no causal mask, and each query
head reads its :func:`kv_head_map` kv head, as on the self path.
:func:`attn_forward` with ``mem`` masks keys by ``cfg.sliding_window``
(the reference's ``attn_forward``); the decode step's
:func:`attn_cross` is the reference's ``attn_decode(mem=)``: the naive
schedule with no window, the memory's K and V projected anew at every
step (nothing is cached).  The encoder's self-attention is cross
attention against its own input (the reference's ``mem=h``).

Under the compute placement (``parallel/sharding.place_model``)
:func:`attn_forward`, :func:`attn_decode`, :func:`attn_prefill` and
:func:`attn_cross` take the rank's ``place``: its query heads are the
rank's share, their kv heads its shard or, where the kv heads replicate
over ``model``, picked from the whole K/V by :func:`kv_head_map`
(``Placement.kv_index``), and ``wo`` is row-parallel.  The serving pair
reads the rank's shard of the KV ring, its kv heads or its slab of the
slots (:func:`_ring_step`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, rmsnorm

_NEG = -1e30
_RING_BLOCK = 32


class Attention(nn.Module):
    """The parameters of ``make_attn_defs``: ``wq (D,Hp,Dh)``, ``wk``/``wv
    (D,KV,Dh)``, ``wo (Hp,Dh,D)``, and with ``cfg.qkv_bias`` ``bq
    (Hp,Dh)``, ``bk``/``bv (KV,Dh)``, with ``cfg.qk_norm`` ``q_norm``/
    ``k_norm (Dh,)``."""

    INIT = {"bq": 0.0, "bk": 0.0, "bv": 0.0}    # the norms' scales: 1

    @staticmethod
    def axes(cfg: ModelConfig) -> dict:
        """Each leaf's logical axes (``make_attn_defs``); the KV heads
        replicate over the model axis unless ``cfg.kv_sharded``."""
        kv = "kv_heads" if cfg.kv_sharded else "kv_heads_repl"
        return {"wq": ("embed", "heads", None), "wk": ("embed", kv, None),
                "wv": ("embed", kv, None), "wo": ("heads", None, "embed"),
                "bq": ("heads", None), "bk": (kv, None), "bv": (kv, None),
                "q_norm": (None,), "k_norm": (None,)}

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, hp, kv, dh = (cfg.d_model, cfg.n_heads_padded, cfg.n_kv_heads,
                         cfg.head_dim_)

        def p(*shape):
            return nn.Parameter(torch.empty(shape))

        self.wq, self.wk, self.wv = p(d, hp, dh), p(d, kv, dh), p(d, kv, dh)
        self.wo = p(hp, dh, d)
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = p(hp, dh), p(kv, dh), p(kv, dh)
        if cfg.qk_norm:
            self.q_norm, self.k_norm = p(dh), p(dh)


def kv_head_map(cfg: ModelConfig, device=None) -> torch.Tensor:
    """The reference's static query-head -> kv-head map, (Hp,) int64 on
    ``device``: true head ``i`` reads ``min(i // (n_heads // n_kv_heads),
    n_kv_heads - 1)``, a padded head kv head 0 (built on the device: no
    host copy)."""
    h, kv, hp = cfg.n_heads, cfg.n_kv_heads, cfg.n_heads_padded
    i = torch.arange(hp, device=device)
    return torch.where(i < h, torch.clamp(i // (h // kv), max=kv - 1), 0)


def _grouped(cfg: ModelConfig) -> bool:
    """Whether :func:`kv_head_map` is the grouping ``i // (Hp // KV)``:
    no padded heads and whole groups."""
    return (cfg.n_heads_padded == cfg.n_heads
            and cfg.n_heads % cfg.n_kv_heads == 0)


def _heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
           place=None):
    """K/V with the head axis 2 in the layout the attend contracts: as
    they are when grouped, else gathered to the query heads by
    :func:`kv_head_map`.  Returns (k, v, kv heads, queries per kv head).
    Placed, the query heads are this rank's ``place.heads`` and
    ``place.kv_index`` maps them into the K/V heads it computed (None
    when grouped)."""
    if place is None:
        hp = cfg.n_heads_padded
        idx = None if _grouped(cfg) else kv_head_map(cfg, k.device)
    else:
        hp, idx = place.heads, place.kv_index
    if idx is None:
        kv = k.shape[2]
    else:
        k, v, kv = k.index_select(2, idx), v.index_select(2, idx), hp
    return k, v, kv, hp // kv


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
                  valid: torch.Tensor, cfg: ModelConfig, place=None,
                  partial: bool = False):
    """Single-position attention: q (B,1,H,Dh) against the cache
    (B,R,KV,Dh) under a (B|1, R) slot mask -> (B,1,H,Dh).  The slots
    reduce in tiles of ``_RING_BLOCK``, or of ``gcd(R, _RING_BLOCK)`` on
    a context-parallel rank's slab that is not whole tiles (a slab of 8
    slots at ``tp = 4`` on a 32-slot ring): the order within a tile and
    across tiles is then that slab's, not the whole ring's.  ``place``:
    the rank's query heads against its K/V heads (:func:`_heads`).
    ``partial`` returns the unnormalised partials ``(m, l, acc)`` of each
    head, (B,H,1), (B,H,1) and (B,H,Dh): the row max, the sum of ``exp(s
    - m)`` and the sum of those weights times the values, for
    ``parallel.tensor.softmax_combine``."""
    hp, dh = q.shape[2], cfg.head_dim_
    ck, cv, kv, g = _heads(ck, cv, cfg, place)
    b, rp = ck.shape[:2]
    blk = math.gcd(rp, _RING_BLOCK)
    nb = rp // blk
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, kv, 1, g, dh)
    kt = ck.view(b, nb, blk, kv, dh).permute(0, 3, 1, 4, 2)
    s = torch.matmul(qg.float(), kt.float())       # (B, KV, nb, g, BLOCK)
    s = s.permute(0, 1, 3, 2, 4).reshape(b, kv, g, rp) * scale
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, torch.full_like(s, _NEG))
    m = s.amax(-1, keepdim=True)
    e = torch.where(vmask, torch.exp(s - m), torch.zeros_like(s))
    tiles = e.view(b, kv, g, nb, blk)
    den = _seq_sum(tiles.sum(-1), dim=-1)[..., None]
    prob = e if partial else e / den
    pt = prob.to(cv.dtype).view(b, kv, g, nb, blk).transpose(2, 3)
    vt = cv.view(b, nb, blk, kv, dh).permute(0, 3, 1, 2, 4)
    out = _seq_sum(torch.matmul(pt, vt), dim=2)    # (B, KV, g, Dh)
    if partial:
        return (m.reshape(b, hp, 1), den.reshape(b, hp, 1),
                out.reshape(b, hp, dh))
    return out.reshape(b, 1, hp, dh)


def _positions(pos, b: int, device):
    """``pos`` (a Python int, or a ``(B,)`` int64 device tensor) -> the
    rows' positions as a ``(1|B,)`` int64 tensor (one row for an int)."""
    if isinstance(pos, int):
        return torch.full((1,), pos, dtype=torch.int64, device=device)
    if pos.shape != (b,):
        raise ValueError(f"per-row positions must be ({b},); got "
                         f"{tuple(pos.shape)}")
    return pos.to(torch.int64)


def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
         mem: torch.Tensor | None = None):
    """x (B,S,D) -> q (B,S,Hp,Dh), k and v (B,M,KV,Dh): the projections
    (K and V of ``mem`` (B,M,D) when given, else of ``x``), the biases
    (``qkv_bias``) and the per-head norms (``qk_norm``), as the
    reference's ``_project_qkv``.  The head counts are the weights'
    (a placed rank's shards)."""
    b, s, d = x.shape
    src = x if mem is None else mem
    m = src.shape[1]
    hp, kv, dh = p.wq.shape[1], p.wk.shape[1], cfg.head_dim_
    q = (x @ p.wq.reshape(d, hp * dh)).view(b, s, hp, dh)
    k = (src @ p.wk.reshape(d, kv * dh)).view(b, m, kv, dh)
    v = (src @ p.wv.reshape(d, kv * dh)).view(b, m, kv, dh)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = rmsnorm(p.k_norm, k, cfg.norm_eps)
    return q, k, v


def _write_kv(ck, cv, k, v, pos, slot, write=None):
    """Write each row's K/V into its ring slot in place.  ``slot`` is an
    int shared by all rows or a ``(B,)`` tensor (a row-indexed write, one
    slot per row, so no index repeats and the write is deterministic).
    ``write`` (B,) bool keeps the rows where it is False unchanged."""
    if isinstance(pos, int):
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        return
    rows = torch.arange(ck.shape[0], device=ck.device)
    kn, vn = k[:, 0], v[:, 0]
    if write is not None:
        keep = ~write[:, None, None]
        kn = torch.where(keep, ck[rows, slot], kn)
        vn = torch.where(keep, cv[rows, slot], vn)
    ck[rows, slot] = kn
    cv[rows, slot] = vn


def _valid(pos_b: torch.Tensor, slot, idx: torch.Tensor,
           cache_len: int, window: int = 0) -> torch.Tensor:
    """(1|B, Rp) slot mask: each row sees its own ring's entries no older
    than its position (and, with a ``window``, younger than it); slots past
    the ring length are never valid."""
    slot_b = slot if isinstance(slot, torch.Tensor) else pos_b % cache_len
    age = (slot_b[:, None] - idx[None, :]) % cache_len
    valid = (age <= pos_b[:, None]) & (idx < cache_len)[None]
    return valid & (age < window) if window else valid


def _ring_step(q, k, v, ck, cv, pos, pos_b, slot, cache_len: int,
               cfg: ModelConfig, place=None, write=None) -> torch.Tensor:
    """One position's K/V into the ring and its attend: q (B,1,H,Dh) of
    the rank's query heads -> (B,1,H,Dh).

    Unplaced, and placed under the ``"kv_heads"`` and ``"replicated"``
    ring layouts (``place.ring``, ``parallel/sharding.ring_layout``), the
    rank holds every slot of its K/V heads: the write and the attend are
    the unplaced ones over the rank's heads.  Under ``"slots"`` (decode
    context parallelism) the rank holds every K/V head of its slab
    ``[place.slab_start, + ck.shape[1])`` of the slots: the new K/V (whole,
    as ``wk``/``wv`` replicate there) is written only where its slot falls
    in the slab, a masked write that leaves the other ranks' slots and the
    rest of the slab as they are (the reference's masked select,
    ``src/repro/models/attention.py:335-337``); the queries of every head
    are gathered over ``model``, each rank attends its slab into
    unnormalised partials, and ``place.combine``
    (``parallel.tensor.softmax_combine``) joins them in rank order.  The
    rank keeps its own heads of the result."""
    if place is None or place.ring != "slots":
        _write_kv(ck, cv, k, v, pos, slot, write)
        idx = torch.arange(ck.shape[1], device=ck.device)
        return _attend_slots(q, ck, cv, _valid(pos_b, slot, idx, cache_len,
                                               cfg.window), cfg, place)
    start, n = place.slab_start, ck.shape[1]
    local = slot - start
    if isinstance(pos, int):
        if 0 <= local < n:
            _write_kv(ck, cv, k, v, pos, local)
    else:
        hit = (local >= 0) & (local < n)
        _write_kv(ck, cv, k, v, pos, local.clamp(0, n - 1),
                  hit if write is None else hit & write)
    idx = start + torch.arange(n, device=ck.device)
    qa = place.model_gather(q, 2)
    m, den, acc = _attend_slots(qa, ck, cv, _valid(pos_b, slot, idx,
                                                   cache_len, cfg.window),
                                cfg, partial=True)
    out = place.combine(m, den, acc.float())
    h = q.shape[2]
    return out[:, None, place.tp_rank * h:(place.tp_rank + 1) * h].to(
        q.dtype)


def attn_decode(p: Attention, x1: torch.Tensor, ck: torch.Tensor,
                cv: torch.Tensor, cache_len: int, pos,
                cfg: ModelConfig, place=None) -> torch.Tensor:
    """One-token decode.  ``x1``: (B,1,D); ``ck``/``cv``: this layer's
    (B,Rp,KV,Dh) cache (or a view of it), written in place at ``slot = pos
    % cache_len`` (a cache shorter than the stream rings; entries older
    than ``cache_len`` age out).

    ``pos`` is a Python int shared by all rows, or a ``(B,)`` int64 device
    tensor of per-row positions (the batching engine's slots): every row
    then writes its own slot and masks its own ring, with no host read.
    An int gives logits bitwise equal to a constant vector: the same ops
    on the same values, one mask row broadcast over the batch.

    Placed (``place``: ``sharding.Placement.serving``, the dense and MoE
    families' compute placement): ``p`` holds the rank's query heads and
    their ``wo`` rows, ``ck``/``cv`` the rank's shard of the ring
    (:func:`_ring_step`), and ``wo``'s partial sums leave reduced over
    ``model``."""
    b, _, d = x1.shape
    q, k, v = _qkv(p, x1, cfg)
    pos_b = _positions(pos, b, x1.device)
    q = apply_rope(q, pos_b[:, None], cfg.rope_theta)
    k = apply_rope(k, pos_b[:, None], cfg.rope_theta)
    slot = pos % cache_len if isinstance(pos, int) else pos_b % cache_len
    out = _ring_step(q, k, v, ck, cv, pos, pos_b, slot, cache_len, cfg,
                     place)
    y = out.reshape(b, 1, -1) @ p.wo.reshape(-1, d)
    return y if place is None else place.exit(y)


def attn_prefill(p: Attention, hs, ck: torch.Tensor, cv: torch.Tensor,
                 cache_len: int, pos0: torch.Tensor, n_valid: torch.Tensor,
                 cfg: ModelConfig, place=None) -> torch.Tensor:
    """Teacher-forced attention over S positions, bitwise the S
    :func:`attn_decode` steps on the live positions.  ``hs``: the S
    positions' normed inputs, each (B,1,D); ``pos0``/``n_valid``: (B,)
    int64 chunk start and live step count.  Position t of row b runs at
    ``pos0 + min(t, n_valid)``; rows past ``n_valid`` write nothing, and
    their queries (which the engine discards) attend the unchanged ring.

    Each position runs the step path's exact shapes: its projections are
    GEMMs of B rows (cuBLAS may order a sum otherwise at another row
    count), then the K/V write and the query-extent-1
    :func:`_attend_slots` (placed: :func:`_ring_step` on the rank's shard,
    and the reduce of ``wo``'s partial sums at the step's size).  Only
    the RoPE runs over all positions at once (elementwise).  Returns
    (S,B,D)."""
    s_len, b = len(hs), hs[0].shape[0]
    d = hs[0].shape[-1]
    qkv = [_qkv(p, h, cfg) for h in hs]
    steps = torch.arange(s_len, device=ck.device)
    pq = pos0[None, :] + torch.minimum(steps[:, None], n_valid[None, :])
    q = apply_rope(torch.cat([x[0] for x in qkv], 1), pq.T, cfg.rope_theta)
    k = apply_rope(torch.cat([x[1] for x in qkv], 1), pq.T, cfg.rope_theta)
    v = torch.cat([x[2] for x in qkv], 1)
    outs = []
    for t in range(s_len):
        out = _ring_step(q[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], ck, cv,
                         pq[t], pq[t], pq[t] % cache_len, cache_len, cfg,
                         place, write=t < n_valid)
        y = out.reshape(b, -1) @ p.wo.reshape(-1, d)
        outs.append(y if place is None else place.exit(y))
    return torch.stack(outs)


def _blockwise_attn(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: int, block: int) -> torch.Tensor:
    """The reference's ``_blockwise_attn``: the queries ``qg``
    (B,KV,g,S,Dh) against ``k``/``v`` (B,M,KV,Dh) one chunk of ``block``
    keys at a time (the keys zero-padded to whole chunks), with an online
    softmax in float32 from a running max of ``_NEG``; returns (B,KV,g,S,Dh)
    in ``qg``'s type."""
    b, kv, g, s, dh = qg.shape
    m_len = k.shape[1]
    blk = min(block, m_len)
    n = -(-m_len // blk)
    k = F.pad(k, (0, 0, 0, 0, 0, n * blk - m_len))
    v = F.pad(v, (0, 0, 0, 0, 0, n * blk - m_len))
    scale = 1.0 / math.sqrt(dh)
    q_idx = torch.arange(s, device=qg.device)[:, None]
    qf = qg.float()
    m = qf.new_full((b, kv, g, s), _NEG)
    l = qf.new_zeros((b, kv, g, s))
    acc = qf.new_zeros((b, kv, g, s, dh))
    for j in range(n):
        kv_idx = j * blk + torch.arange(blk, device=qg.device)[None, :]
        ok = kv_idx < m_len                              # (1, blk)
        if causal:
            ok = ok & (kv_idx <= q_idx)                  # (S, blk)
        if window:
            ok = ok & (kv_idx > q_idx - window)
        kj = k[:, j * blk:(j + 1) * blk].permute(0, 2, 3, 1)[:, :, None]
        vj = v[:, j * blk:(j + 1) * blk].permute(0, 2, 1, 3)[:, :, None]
        sc = torch.where(ok, torch.matmul(qf, kj.float()) * scale, _NEG)
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None]) * ok
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p.to(v.dtype), vj).float()
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(qg.dtype)


def _attend(p: Attention, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, cfg: ModelConfig, causal: bool, window: int,
            blockwise: bool, place=None) -> torch.Tensor:
    """Queries (B,S,Hp,Dh) against keys and values (B,M,KV,Dh), each query
    head reading its :func:`kv_head_map` kv head, then the output
    projection -> (B,S,D).  The naive schedule (the reference's
    ``_naive_attn``: the whole score matrix in float32, the mask, softmax,
    the value product) or :func:`_blockwise_attn`; the mask keeps keys at
    or before the query (``causal``) and, with a ``window``, keys less
    than ``window`` positions behind it."""
    b, s = q.shape[:2]
    hp, dh = q.shape[2], cfg.head_dim_
    k, v, kv, g = _heads(k, v, cfg, place)
    qg = q.view(b, s, kv, g, dh).permute(0, 2, 3, 1, 4)   # (B,KV,g,S,Dh)
    if blockwise:
        out = _blockwise_attn(qg, k, v, causal, window, cfg.attn_block)
    else:
        m_len = k.shape[1]
        kt = k.permute(0, 2, 3, 1)[:, :, None]            # (B,KV,1,Dh,M)
        sc = torch.matmul(qg.float(), kt.float()) * (1.0 / math.sqrt(dh))
        if causal or window:
            ok = torch.ones((s, m_len), dtype=torch.bool, device=q.device)
            if causal:
                ok = ok.tril()
            if window:
                ok = ok.triu(1 - window)
            sc = torch.where(ok, sc, _NEG)
        pr = torch.softmax(sc, dim=-1)
        out = torch.matmul(pr.to(v.dtype), v.permute(0, 2, 1, 3)[:, :, None])
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, hp * dh)
    return out @ p.wo.reshape(hp * dh, p.wo.shape[-1])


def attn_forward(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 mem: torch.Tensor | None = None,
                 place=None) -> torch.Tensor:
    """Attention over a whole sequence (training, the encoder): x (B,S,D)
    -> (B,S,D).  Without ``mem``: causal self-attention, RoPE at positions
    ``arange(S)``.  With ``mem`` (B,M,D): cross attention, K and V from
    the memory, no RoPE, no causal mask.  A ``sliding_window`` masks keys
    ``window`` or more positions behind the query (the reference's
    ``kv_idx > q_idx - window``) on both.  ``cfg.attn_impl``: ``"naive"``
    (the whole score matrix) or ``"blockwise"`` (:func:`_blockwise_attn`
    over ``cfg.attn_block`` keys at a time).

    Placed (``place``, the compute placement): ``p`` holds this rank's
    query heads ``[r Hp/tp, (r+1) Hp/tp)`` and their ``wo`` rows, and its
    kv heads' shard (or all kv heads, when they replicate over
    ``model``); the residual stream enters whole (``place.enter``) and
    ``wo``'s partial sums leave reduced over ``model`` (``place.exit``).
    A memory is whole along M on every model rank and enters as it lies
    (``place.enter_memory``: identity forward, its gradient summed over
    ``model`` backward); the encoder's ``mem=h``, the residual stream
    itself, enters once."""
    if cfg.attn_impl not in ("naive", "blockwise"):
        raise ValueError(f"attn_impl={cfg.attn_impl!r}: expected 'naive' "
                         "or 'blockwise'")
    if place is not None:
        x_in, x = x, place.enter(x)
        if mem is not None:
            mem = x if mem is x_in else place.enter_memory(mem)
    q, k, v = _qkv(p, x, cfg, mem)
    if mem is None:
        pos = torch.arange(x.shape[1], device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = _attend(p, q, k, v, cfg, causal=mem is None,
                  window=cfg.sliding_window,
                  blockwise=cfg.attn_impl == "blockwise", place=place)
    return out if place is None else place.exit(out)


def attn_cross(p: Attention, x1: torch.Tensor, mem: torch.Tensor,
               cfg: ModelConfig, place=None) -> torch.Tensor:
    """The decode step's cross attention, the reference's
    ``attn_decode(mem=)``: x1 (B,1,D) against the whole memory (B,M,D),
    its K and V projected at this step, naive, no mask -> (B,1,D).
    Placed (``place``, ``Placement.serving``): the rank's query heads
    against the K/V of its kv heads, ``wo``'s partial sums reduced over
    ``model``."""
    q, k, v = _qkv(p, x1, cfg, mem)
    out = _attend(p, q, k, v, cfg, causal=False, window=0, blockwise=False,
                  place=place)
    return out if place is None else place.exit(out)
