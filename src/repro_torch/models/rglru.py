"""RG-LRU recurrent block (RecurrentGemma / Griffin): the whole-sequence
block of training and an O(1)-state decode step.

Port of ``repro.models.rglru``:

    x -> [W_x -> causal conv(4) -> RG-LRU]  (.)  [W_y -> GeLU]  -> W_out

    r_t = sigmoid(w_a . u_t + b_a)          (recurrence gate)
    i_t = sigmoid(w_i . u_t + b_i)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The GeLU is the tanh approximation, ``jax.nn.gelu``'s default.  Training
runs the recurrence over the sequence as a doubling scan in float32
(:func:`linear_scan`, the reference's ``associative_scan``): log2 S steps,
each combining every position with the one ``d`` behind it.  A closed
form ``exp(cumsum(log a))`` would divide by products that underflow
within a few steps (``log a_t`` reaches ``-c * softplus(Lambda)`` a step).

Placed (``parallel/sharding.place_model``: every leaf but ``w_out`` on
``ssm_inner -> model``), the recurrence is per channel, so a rank's slab
is self-contained: ``w_x``/``w_y`` column-parallel, the convolution,
gates and scan on its channels, ``w_out`` row-parallel; its decode state
(``h`` (B, w) and ``conv`` (B, W-1, w), the last dim over ``model``) is
exactly its channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import causal_conv, conv_step


def rglru_width(cfg: ModelConfig) -> int:
    return cfg.d_model  # RecurrentGemma: lru_width == d_model


class RGLRU(nn.Module):
    """The parameters of ``make_rglru_defs``, under the reference's leaf
    names."""

    INIT = {"conv_b": 0.0, "gate_a_b": 0.0, "gate_i_b": 0.0, "lam": 1.0}

    @staticmethod
    def axes(cfg: ModelConfig) -> dict:
        """Each leaf's logical axes (``make_rglru_defs``)."""
        vec = ("ssm_inner",)
        return {"w_x": ("embed", "ssm_inner"), "w_y": ("embed", "ssm_inner"),
                "conv_w": (None, "ssm_inner"), "conv_b": vec,
                "gate_a_w": vec, "gate_a_b": vec, "gate_i_w": vec,
                "gate_i_b": vec, "lam": vec, "w_out": ("ssm_inner", "embed")}

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
    # maximum, not clamp: at the floor the gradient splits as JAX's does
    beta = torch.sqrt(torch.maximum(1.0 - a * a, a.new_tensor(1e-12)))
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
                      cfg: ModelConfig, place=None) -> torch.Tensor:
    """x1 (B,1,D) -> y (B,1,D); ``cache["conv"]`` (B,W-1,w) and
    ``cache["h"]`` (B,w) advance in place.  Placed (``place``), on the
    rank's channels and their state slab, the output summed over
    ``model``."""
    if place is not None:
        x1 = place.enter(x1)
    u1 = x1 @ p.w_x
    gy = F.gelu(x1 @ p.w_y, approximate="tanh")
    hist = torch.cat([cache["conv"], u1], 1)
    u = conv_step(hist, p.conv_w, p.conv_b)[:, None, :]
    a, b = _rglru_gates(p, u, cfg)
    h = a[:, 0] * cache["h"] + b[:, 0]
    out = h[:, None, :].to(x1.dtype) * gy
    cache["conv"].copy_(hist[:, 1:])
    cache["h"].copy_(h)
    out = out @ p.w_out
    return out if place is None else place.exit(out)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0`` over axis 1 of
    ``a``/``b`` (B,S,W): the Hillis-Steele scan of the combine ``(a1, b1)
    . (a2, b2) = (a1 a2, a2 b1 + b2)``, out of place (differentiable)."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b


def rglru_forward(p: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                  place=None) -> torch.Tensor:
    """The full-sequence block of training, x (B,S,D) -> (B,S,D): ``w_x``,
    the causal convolution (no activation), the gates, the recurrence in
    float32, times ``gelu_tanh(x @ w_y)``, then ``w_out``.  Placed
    (``place``), on the rank's channels: x enters whole (``place.enter``)
    and the output of the row-parallel ``w_out`` leaves summed over
    ``model`` (``place.exit``)."""
    if place is not None:
        x = place.enter(x)
    u = causal_conv(x @ p.w_x, p.conv_w, p.conv_b)
    gy = F.gelu(x @ p.w_y, approximate="tanh")
    a, b = _rglru_gates(p, u, cfg)
    out = (linear_scan(a, b).to(x.dtype) * gy) @ p.w_out
    return out if place is None else place.exit(out)
