"""Mamba-2 SSD mixer, the serving direction: an O(1)-state decode step.

Port of ``repro.models.ssm``.  The linear recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * x_t (x) B_t        (state (H,P,N))
    y_t = h_t . C_t + D * x_t

runs one token at a time against a cache of the convolution's last
``conv_width - 1`` inputs (``conv``, the model's type) and the state
(``h``, float32).  The input projection is stored per component (``wz wx
wb wc wdt``), as in the reference, so a JAX parameter tree copies over
leaf for leaf.  The chunked SSD scan of training (``ssd_chunked``,
``ssm_forward``) is not ported yet (ROADMAP A6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import conv_step, rmsnorm


def ssm_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_headdim
    groups = 1
    return d_in, heads, groups


class SSM(nn.Module):
    """The parameters of ``make_ssm_defs``, under the reference's leaf
    names."""

    # leaves the reference initialises to a constant (the rest: normal)
    INIT = {"conv_x_b": 0.0, "conv_b_b": 0.0, "conv_c_b": 0.0, "A_log": 0.0,
            "D": 1.0, "dt_bias": 0.0, "norm_scale": 1.0}

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, w = cfg.d_model, cfg.conv_width
        d_in, heads, groups = ssm_dims(cfg)
        gn = groups * cfg.ssm_state

        def p(*shape):
            return nn.Parameter(torch.empty(shape))

        self.wz, self.wx = p(d, d_in), p(d, d_in)
        self.wb, self.wc = p(d, gn), p(d, gn)
        self.wdt = p(d, heads)
        self.conv_x_w, self.conv_x_b = p(w, d_in), p(d_in)
        self.conv_b_w, self.conv_b_b = p(w, gn), p(gn)
        self.conv_c_w, self.conv_c_b = p(w, gn), p(gn)
        self.A_log, self.D, self.dt_bias = p(heads), p(heads), p(heads)
        self.norm_scale = p(d_in)
        self.out_proj = p(d_in, d)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device,
                   layers: int = 1) -> dict:
    """Zero ``conv`` (layers, B, W-1, d_in + 2N) in ``dtype`` and ``h``
    (layers, B, H, P, N) float32 (the reference's leaves with a leading
    layer axis)."""
    d_in, heads, groups = ssm_dims(cfg)
    conv_dim = d_in + 2 * groups * cfg.ssm_state
    return {
        "conv": torch.zeros((layers, batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "h": torch.zeros((layers, batch, heads, cfg.ssm_headdim,
                          cfg.ssm_state), dtype=torch.float32,
                         device=device),
    }


def ssm_decode_step(p: SSM, x1: torch.Tensor, cache: dict,
                    cfg: ModelConfig) -> torch.Tensor:
    """x1 (B,1,D) -> y (B,1,D); ``cache["conv"]`` (B,W-1,C) and
    ``cache["h"]`` (B,H,P,N) (views into the serving state) advance in
    place."""
    b = x1.shape[0]
    d_in, heads, groups = ssm_dims(cfg)
    gn = groups * cfg.ssm_state
    z, xs, bm, cm, dt = (x1 @ w for w in (p.wz, p.wx, p.wb, p.wc, p.wdt))
    hist = torch.cat([cache["conv"], torch.cat([xs, bm, cm], -1)], 1)
    conv_w = torch.cat([p.conv_x_w, p.conv_b_w, p.conv_c_w], 1)
    conv_b = torch.cat([p.conv_x_b, p.conv_b_b, p.conv_c_b], 0)
    xs, bm, cm = F.silu(conv_step(hist, conv_w, conv_b)).split(
        [d_in, gn, gn], -1)
    rep = heads // groups
    xh = xs.reshape(b, heads, cfg.ssm_headdim).float()
    bmh = bm.reshape(b, groups, cfg.ssm_state).repeat_interleave(
        rep, 1).float()
    cmh = cm.reshape(b, groups, cfg.ssm_state).repeat_interleave(
        rep, 1).float()
    dtv = F.softplus(dt.float() + p.dt_bias.float())[:, 0]       # (B, H)
    a_head = -torch.exp(p.A_log.float())
    decay = torch.exp(dtv * a_head)[..., None, None]
    h = decay * cache["h"] + (xh * dtv[..., None])[..., None] \
        * bmh[:, :, None, :]
    y = torch.matmul(h, cmh[..., None])[..., 0]                  # (B,H,P)
    y = y + xh * p.D.float()[:, None]
    y = y.reshape(b, 1, d_in).to(x1.dtype)
    y = rmsnorm(p.norm_scale, y * F.silu(z), cfg.norm_eps)
    cache["conv"].copy_(hist[:, 1:])
    cache["h"].copy_(h)
    return y @ p.out_proj


def ssm_forward(p: SSM, x: torch.Tensor, cfg: ModelConfig):
    """The full-sequence mixer of training (the chunked SSD scan)."""
    raise NotImplementedError(
        "ssm_forward / ssd_chunked (the Mamba2 training scan) are not "
        "ported yet (ROADMAP A6); the port serves Mamba2 through "
        "ssm_decode_step")
