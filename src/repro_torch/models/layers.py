"""Shared layers: RMSNorm, RoPE, gated MLP, embeddings, tied logits.

Ports of ``repro.models.layers``, same weight layouts (``wi_gate (d, ff)``,
``wo (ff, d)``, ``embedding (Vpad, d)``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    var = (x * x).sum(-1, keepdim=True) / x.shape[-1]
    return x * torch.rsqrt(var + eps) * scale


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions broadcastable to (..., S)."""
    dh = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(dh, theta), dtype=torch.float32,
                            device=x.device)
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def mlp(wi_gate: torch.Tensor, wi_up: torch.Tensor, wo: torch.Tensor,
        x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ wi_gate) * (x @ wi_up)) @ wo


def embed(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embedding[tokens]


def logits(embedding: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits ``x @ E^T`` over the padded vocabulary."""
    return x @ embedding.T
