"""Dense decoder-only transformer as an ``nn.Module`` (serving direction).

Port of the dense part of ``repro.models.transformer``: pre-norm blocks of
RoPE grouped-query self-attention and a gated SiLU MLP, a final RMSNorm and
tied-embedding logits over the padded vocabulary.  Weight layouts match
the reference (``wq (d, Hp, Dh)``, ``wo (Hp, Dh, d)``, ``wi_gate (d, ff)``,
...), so ``models.convert`` copies a JAX parameter tree over unchanged.

Serving runs one token at a time through :meth:`DenseLM.decode_step`
against a :class:`KVState`, which the step updates in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import attn_decode, ring_slots
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed, logits, mlp, rmsnorm


@dataclass
class KVState:
    """Per-layer KV rings: ``k``/``v`` are (L, B, Rp, KV, Dh) with the slot
    axis padded to whole attention tiles; ``length`` is the ring length."""

    k: torch.Tensor
    v: torch.Tensor
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

    def init_state(self, batch: int, max_len: int) -> KVState:
        cfg = self.cfg
        p = self.embedding
        shape = (cfg.n_layers, batch, ring_slots(max_len), cfg.n_kv_heads,
                 cfg.head_dim_)
        return KVState(k=torch.zeros(shape, dtype=p.dtype, device=p.device),
                       v=torch.zeros(shape, dtype=p.dtype, device=p.device),
                       length=max_len)

    @torch.no_grad()
    def decode_step(self, state: KVState, token: torch.Tensor,
                    pos: int) -> torch.Tensor:
        """token (B,1) int -> logits (B, Vpad); ``state`` advances in
        place."""
        cfg = self.cfg
        x = embed(self.embedding, token)
        for i, blk in enumerate(self.blocks):
            a = blk.attn
            h = rmsnorm(blk.ln1, x, cfg.norm_eps)
            x = x + attn_decode(a.wq, a.wk, a.wv, a.wo, h, state.k[i],
                                state.v[i], state.length, pos, cfg)
            h = rmsnorm(blk.ln2, x, cfg.norm_eps)
            x = x + mlp(blk.ffn.wi_gate, blk.ffn.wi_up, blk.ffn.wo, h)
        x = rmsnorm(self.final_norm, x, cfg.norm_eps)
        return logits(self.embedding, x)[:, 0]


def init_model(cfg: ModelConfig, seed: int = 0,
               device: torch.device | str | None = None) -> DenseLM:
    """Seeded random weights, drawn on the CPU so every device gets the
    same ones, then moved to ``device`` (the card when None)."""
    dev = resolve_device(device)
    model = DenseLM(cfg).reset_parameters(
        torch.Generator().manual_seed(seed))
    return model.to(dev)
