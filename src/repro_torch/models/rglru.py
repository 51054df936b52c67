"""RG-LRU recurrent block (RecurrentGemma / Griffin), the serving
direction: an O(1)-state decode step.

Port of ``repro.models.rglru``:

    x -> [W_x -> causal conv(4) -> RG-LRU]  (.)  [W_y -> GeLU]  -> W_out

    r_t = sigmoid(w_a . u_t + b_a)          (recurrence gate)
    i_t = sigmoid(w_i . u_t + b_i)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The GeLU is the tanh approximation, ``jax.nn.gelu``'s default.  The
associative scan of training (``rglru_forward``) is not ported yet
(ROADMAP A6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import conv_step


def rglru_width(cfg: ModelConfig) -> int:
    return cfg.d_model  # RecurrentGemma: lru_width == d_model


class RGLRU(nn.Module):
    """The parameters of ``make_rglru_defs``, under the reference's leaf
    names."""

    INIT = {"conv_b": 0.0, "gate_a_b": 0.0, "gate_i_b": 0.0, "lam": 1.0}

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, w = cfg.d_model, rglru_width(cfg)

        def p(*shape):
            return nn.Parameter(torch.empty(shape))

        self.w_x, self.w_y = p(d, w), p(d, w)
        self.conv_w, self.conv_b = p(cfg.conv_width, w), p(w)
        self.gate_a_w, self.gate_a_b = p(w), p(w)
        self.gate_i_w, self.gate_i_b = p(w), p(w)
        self.lam = p(w)
        self.w_out = p(w, d)


def _rglru_gates(p: RGLRU, u: torch.Tensor, cfg: ModelConfig):
    uf = u.float()
    r = torch.sigmoid(uf * p.gate_a_w.float() + p.gate_a_b.float())
    i = torch.sigmoid(uf * p.gate_i_w.float() + p.gate_i_b.float())
    log_a = -cfg.rglru_c * F.softplus(p.lam.float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * i * uf


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device,
                     layers: int = 1) -> dict:
    """Zero ``conv`` (layers, B, W-1, w) in ``dtype`` and ``h`` (layers,
    B, w) float32."""
    w = rglru_width(cfg)
    return {
        "conv": torch.zeros((layers, batch, cfg.conv_width - 1, w),
                            dtype=dtype, device=device),
        "h": torch.zeros((layers, batch, w), dtype=torch.float32,
                         device=device),
    }


def rglru_decode_step(p: RGLRU, x1: torch.Tensor, cache: dict,
                      cfg: ModelConfig) -> torch.Tensor:
    """x1 (B,1,D) -> y (B,1,D); ``cache["conv"]`` (B,W-1,w) and
    ``cache["h"]`` (B,w) advance in place."""
    u1 = x1 @ p.w_x
    gy = F.gelu(x1 @ p.w_y, approximate="tanh")
    hist = torch.cat([cache["conv"], u1], 1)
    u = conv_step(hist, p.conv_w, p.conv_b)[:, None, :]
    a, b = _rglru_gates(p, u, cfg)
    h = a[:, 0] * cache["h"] + b[:, 0]
    out = h[:, None, :].to(x1.dtype) * gy
    cache["conv"].copy_(hist[:, 1:])
    cache["h"].copy_(h)
    return out @ p.w_out


def rglru_forward(p: RGLRU, x: torch.Tensor, cfg: ModelConfig):
    """The full-sequence block of training (the associative scan)."""
    raise NotImplementedError(
        "rglru_forward (the RG-LRU training scan) is not ported yet "
        "(ROADMAP A6); the port serves RecurrentGemma through "
        "rglru_decode_step")
