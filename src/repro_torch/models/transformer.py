"""Dense decoder-only transformer as an ``nn.Module``: the serving
direction and the training forward.

Port of the dense part of ``repro.models.transformer``: pre-norm blocks of
RoPE grouped-query self-attention and a gated SiLU MLP, a final RMSNorm and
tied-embedding logits over the padded vocabulary.  Weight layouts match
the reference (``wq (d, Hp, Dh)``, ``wo (Hp, Dh, d)``, ``wi_gate (d, ff)``,
...), so ``models.convert`` copies a JAX parameter tree over unchanged.

Training runs :meth:`DenseLM.forward` over whole sequences (causal
:func:`~repro_torch.models.attention.attn_forward`) and :func:`loss_fn`.
Serving runs one token at a time through :meth:`DenseLM.decode_step`
against a :class:`KVState`, which the step updates in place, or a
teacher-forced chunk of positions through :meth:`DenseLM.prefill_chunk`,
bitwise the same steps.

Both take optional :class:`RowGroup` s, the batching engine's slots: each
group runs as the single-request step of the same request would, at the
same shapes (``lanes`` rows, the request's own ring length).  cuBLAS
picks a GEMM's kernel, and with it the order of each output's sum, from
the GEMM's shape, and PyTorch's row reductions pick their thread layout
from the row count, so the same rows inside a larger batch can round
differently on the card; a group is the unit at which the engine's floats
are the single-request path's by construction (``PERF.md`` §7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import (attn_decode, attn_forward,
                                         attn_prefill, ring_slots)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (chunked_xent_loss, embed, logits, mlp,
                                       rmsnorm, xent_loss)


@dataclass
class KVState:
    """Per-layer KV rings: ``k``/``v`` are (L, B, Rp, KV, Dh) with the slot
    axis padded to whole attention tiles; ``length`` is the ring length."""

    k: torch.Tensor
    v: torch.Tensor
    length: int


class RowGroup(NamedTuple):
    """Rows ``[r0, r1)`` run as one model call: GEMMs of ``r1 - r0`` rows
    and attention over the ring's first ``ring_slots(length)`` slots with
    ring length ``length``, the shapes ``init_state(r1 - r0, length)``
    gives the single-request path."""

    r0: int
    r1: int
    length: int


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, hp, kv, dh = (cfg.d_model, cfg.n_heads_padded, cfg.n_kv_heads,
                         cfg.head_dim_)
        self.wq = nn.Parameter(torch.empty(d, hp, dh))
        self.wk = nn.Parameter(torch.empty(d, kv, dh))
        self.wv = nn.Parameter(torch.empty(d, kv, dh))
        self.wo = nn.Parameter(torch.empty(hp, dh, d))


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.wi_gate = nn.Parameter(torch.empty(d, ff))
        self.wi_up = nn.Parameter(torch.empty(d, ff))
        self.wo = nn.Parameter(torch.empty(ff, d))


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model))
        self.attn = Attention(cfg)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model))
        self.ffn = MLP(cfg)


class DenseLM(nn.Module):
    """The dense ``ras-pimc``-family model (float32, tied embeddings)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.family != "dense" or not cfg.tie_embeddings:
            raise ValueError(f"DenseLM ports the tied-embedding dense family;"
                             f" got family={cfg.family!r}, "
                             f"tie_embeddings={cfg.tie_embeddings}")
        if cfg.sliding_window or cfg.local_window:
            raise ValueError("windowed attention is not ported yet; got "
                             f"sliding_window={cfg.sliding_window}, "
                             f"local_window={cfg.local_window}")
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty(cfg.vocab_padded,
                                                  cfg.d_model))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         scale: float = 0.02) -> "DenseLM":
        """Seeded init: normal(0, scale) matrices and embeddings, unit norm
        scales (the reference's init rule; its random bits differ)."""
        for name, p in self.named_parameters():
            if p.ndim == 1:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * scale)
        return self

    def forward(self, tokens: torch.Tensor):
        """tokens (B,S) -> (final-normed hidden states (B,S,D), aux loss);
        the aux loss is 0.0 for the dense family."""
        cfg = self.cfg
        x = embed(self.embedding, tokens)
        for blk in self.blocks:
            a, f = blk.attn, blk.ffn
            x = x + attn_forward(a.wq, a.wk, a.wv, a.wo,
                                 rmsnorm(blk.ln1, x, cfg.norm_eps), cfg)
            x = x + mlp(f.wi_gate, f.wi_up, f.wo,
                        rmsnorm(blk.ln2, x, cfg.norm_eps))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return rmsnorm(self.final_norm, x, cfg.norm_eps), aux

    def init_state(self, batch: int, max_len: int) -> KVState:
        cfg = self.cfg
        p = self.embedding
        shape = (cfg.n_layers, batch, ring_slots(max_len), cfg.n_kv_heads,
                 cfg.head_dim_)
        return KVState(k=torch.zeros(shape, dtype=p.dtype, device=p.device),
                       v=torch.zeros(shape, dtype=p.dtype, device=p.device),
                       length=max_len)

    def _groups(self, state: KVState, rows: int, groups):
        if groups is None:
            return (RowGroup(0, rows, state.length),)
        for g in groups:
            if not (0 <= g.r0 < g.r1 <= rows and 0 < g.length
                    <= state.length):
                raise ValueError(f"row group {g} does not fit {rows} rows "
                                 f"of a ring of length {state.length}")
        return tuple(groups)

    def _kv(self, state: KVState, g: RowGroup):
        """The group's rows of every layer's ring, cut to its length."""
        n = ring_slots(g.length)
        return (state.k[:, g.r0:g.r1, :n], state.v[:, g.r0:g.r1, :n])

    def _step(self, ck, cv, length: int, token, pos) -> torch.Tensor:
        """The single-request step over rings ``ck``/``cv`` (L,B,Rp,KV,Dh)
        of ring length ``length``."""
        cfg = self.cfg
        x = embed(self.embedding, token)
        for i, blk in enumerate(self.blocks):
            a, f = blk.attn, blk.ffn
            h = rmsnorm(blk.ln1, x, cfg.norm_eps)
            x = x + attn_decode(a.wq, a.wk, a.wv, a.wo, h, ck[i], cv[i],
                                length, pos, cfg)
            h = rmsnorm(blk.ln2, x, cfg.norm_eps)
            x = x + mlp(f.wi_gate, f.wi_up, f.wo, h)
        x = rmsnorm(self.final_norm, x, cfg.norm_eps)
        return logits(self.embedding, x)[:, 0]

    @torch.no_grad()
    def decode_step(self, state: KVState, token: torch.Tensor, pos,
                    groups=None) -> torch.Tensor:
        """token (B,1) int -> logits (B, Vpad); ``state`` advances in
        place.  ``pos`` is an int shared by all rows or a ``(B,)`` int64
        device tensor of per-row positions.  ``groups`` (default: all
        rows, the state's ring) runs each :class:`RowGroup` as its own
        single-request step; rows outside every group get zero logits and
        leave the state unchanged."""
        groups = self._groups(state, token.shape[0], groups)
        if len(groups) == 1 and groups[0][:2] == (0, token.shape[0]):
            return self._step(*self._kv(state, groups[0]), groups[0].length,
                              token, pos)
        out = self.embedding.new_zeros((token.shape[0],
                                        self.cfg.vocab_padded))
        for g in groups:
            p = pos if isinstance(pos, int) else pos[g.r0:g.r1]
            out[g.r0:g.r1] = self._step(*self._kv(state, g), g.length,
                                        token[g.r0:g.r1], p)
        return out

    def _prefill(self, ck, cv, length: int, tokens, pos0, n_valid):
        """:meth:`prefill_chunk` of one group: (B,S) -> (B,S,Vpad)."""
        cfg = self.cfg
        s_len = tokens.shape[1]

        def per_position(fn, xs):
            return torch.stack([fn(xs[t][:, None])[:, 0]
                                for t in range(s_len)])

        xs = embed(self.embedding, tokens.T)            # (S, B, D)
        for i, blk in enumerate(self.blocks):
            a, f = blk.attn, blk.ffn
            hs = [rmsnorm(blk.ln1, xs[t][:, None], cfg.norm_eps)
                  for t in range(s_len)]
            xs = xs + attn_prefill(a.wq, a.wk, a.wv, a.wo, hs, ck[i], cv[i],
                                   length, pos0, n_valid, cfg)
            xs = xs + per_position(lambda x1: mlp(
                f.wi_gate, f.wi_up, f.wo,
                rmsnorm(blk.ln2, x1, cfg.norm_eps)), xs)
        return per_position(lambda x1: logits(
            self.embedding, rmsnorm(self.final_norm, x1, cfg.norm_eps)),
            xs).transpose(0, 1)

    @torch.no_grad()
    def prefill_chunk(self, state: KVState, tokens: torch.Tensor,
                      pos0: torch.Tensor, n_valid: torch.Tensor,
                      groups=None) -> torch.Tensor:
        """Teacher-forced chunk: tokens (B,S) at per-row positions ``pos0 +
        [0, S)`` -> logits (B,S,Vpad), ``state`` updated in place.

        Bitwise equal to S :meth:`decode_step` calls at positions ``pos0 +
        min(t, n_valid)`` on every live position (``t < n_valid``) and on
        every ring slot the live steps write, when the chunk stays inside
        the ring (``pos0 + n_valid <= length``).  Rows past ``n_valid``
        write nothing; their logits are not the step path's (the step path
        writes the clamped position's slot, the next chunk's first step
        overwrites it).  Only the embedding, the RoPE and the residual adds
        (elementwise) run over all S positions at once: every norm, GEMM
        and attend runs per position at the step path's shapes, since
        cuBLAS's GEMMs and PyTorch's row reductions may order a sum
        otherwise at another row count."""
        b = tokens.shape[0]
        groups = self._groups(state, b, groups)
        pos0, n_valid = pos0.to(torch.int64), n_valid.to(torch.int64)
        if len(groups) == 1 and groups[0][:2] == (0, b):
            return self._prefill(*self._kv(state, groups[0]),
                                 groups[0].length, tokens, pos0, n_valid)
        out = self.embedding.new_zeros(tuple(tokens.shape)
                                       + (self.cfg.vocab_padded,))
        for g in groups:
            r = slice(g.r0, g.r1)
            out[r] = self._prefill(*self._kv(state, g), g.length, tokens[r],
                                   pos0[r], n_valid[r])
        return out


def loss_fn(model: DenseLM, batch: dict) -> torch.Tensor:
    """Next-token cross entropy of ``batch`` (``tokens``/``labels`` (B,S)
    tensors on the model's device) plus 0.01 x the aux loss.
    ``model.cfg.logits_chunk`` > 0 runs the chunked loss."""
    cfg = model.cfg
    if batch.get("memory") is not None or batch.get("enc_inputs") is not None:
        raise NotImplementedError("memory/enc_inputs batches are not ported "
                                  "yet (ROADMAP A6)")
    x, aux = model(batch["tokens"])
    if cfg.logits_chunk:
        ce = chunked_xent_loss(model.embedding, x, batch["labels"],
                               cfg.vocab_size, cfg.logits_chunk)
    else:
        ce = xent_loss(logits(model.embedding, x), batch["labels"],
                       cfg.vocab_size)
    return ce + 0.01 * aux


def init_model(cfg: ModelConfig, seed: int = 0,
               device: torch.device | str | None = None) -> DenseLM:
    """Seeded random weights, drawn on the CPU so every device gets the
    same ones, then moved to ``device`` (the card when None)."""
    dev = resolve_device(device)
    model = DenseLM(cfg).reset_parameters(
        torch.Generator().manual_seed(seed))
    return model.to(dev)
