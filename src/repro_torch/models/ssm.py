"""Mamba-2 SSD mixer: the chunked SSD scan of training and an O(1)-state
decode step.

Port of ``repro.models.ssm``.  The linear recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * x_t (x) B_t        (state (H,P,N))
    y_t = h_t . C_t + D * x_t

runs one token at a time against a cache of the convolution's last
``conv_width - 1`` inputs (``conv``, the model's type) and the state
(``h``, float32).  The input projection is stored per component (``wz wx
wb wc wdt``), as in the reference, so a JAX parameter tree copies over
leaf for leaf.

Training runs the whole sequence through :func:`ssm_forward`, whose scan
is :func:`ssd_chunked`: within a chunk of ``cfg.ssm_chunk`` positions an
attention-like quadratic form, across chunks a loop over the chunk-final
states, all in float32 (:func:`ssd_sequential` is its step-by-step oracle
for tests).  Two choices keep it trainable on the card under
deterministic algorithms: the in-chunk cumulative log-decay is a product
with a lower-triangular matrix (a float ``cumsum`` has no deterministic
CUDA kernel), and the decay's upper triangle is masked before the
``exp`` (``exp`` of it overflows, and ``inf * 0`` is NaN in the backward
pass).

Placed (``place``, ``parallel/sharding.place_model``: the reference's
``ssm_inner -> model`` and ``ssm_state -> model``), a rank holds its
``d_in / tp`` channels of ``wz wx conv_x_* norm_scale out_proj`` and its
``N / tp`` slab of ``wb wc conv_b_* conv_c_*``; ``wdt A_log D dt_bias``
are whole.  The recurrence is independent per channel given whole
``B``, ``C`` and ``dt``, so training (:func:`ssm_forward`) gathers the
rank's ``B``/``C`` slabs over ``model`` (the backward reduce-scatters
their gradients), runs :func:`ssd_chunked` on its channels cut into
sub-heads of ``gcd(headdim, d_in / tp)`` channels (a head may span two
ranks: each sub-head reads its head's ``dt``, decay and ``D``), sums the
gated norm's squares over ``model`` and leaves ``out_proj``
row-parallel.  Decode (:func:`ssm_decode_step`) runs on the reference's
serving state, whose shards do not line up with the channel slabs:
``h`` (B, H, P, N) holds the rank's ``N`` slab of every head, and
``conv`` (B, W-1, d_in + 2N) a contiguous slab of the concatenated ``[x
| B | C]`` dim.  The step gathers the projected ``[x | B | C]`` and the
convolution taps over ``model``, convolves the rank's conv slab, gathers
the convolved vector whole, updates ``h`` on the rank's ``N`` slab,
reduce-scatters ``y`` (summed over ``N``) onto the rank's channels, then
the ``D`` skip, the gated norm and ``out_proj`` as in training.  At a
``model`` axis of 1 every collective is the identity and each placed
function is the unplaced one op for op.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import causal_conv, conv_step, rmsnorm


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

    @staticmethod
    def axes(cfg: ModelConfig) -> dict:
        """Each leaf's logical axes (``make_ssm_defs``)."""
        inner, state = ("embed", "ssm_inner"), ("embed", "ssm_state")
        return {"wz": inner, "wx": inner, "wb": state, "wc": state,
                "wdt": ("embed", None),
                "conv_x_w": (None, "ssm_inner"), "conv_x_b": ("ssm_inner",),
                "conv_b_w": (None, "ssm_state"), "conv_b_b": ("ssm_state",),
                "conv_c_w": (None, "ssm_state"), "conv_c_b": ("ssm_state",),
                "A_log": (None,), "D": (None,), "dt_bias": (None,),
                "norm_scale": ("ssm_inner",),
                "out_proj": ("ssm_inner", "embed")}

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


def _expand(t: torch.Tensor, k: int) -> torch.Tensor:
    """Each entry of ``t``'s last dim repeated ``k`` times in place
    (``repeat_interleave`` without a host sync)."""
    return t[..., None].expand(*t.shape, k).flatten(-2)


def _xbc(t: torch.Tensor, tp: int, w: int, n: int) -> torch.Tensor:
    """A last dim gathered over ``model`` in rank order, ``[x_r | B_r |
    C_r]`` of ``w``, ``n`` and ``n`` entries a rank, as the concatenated
    ``[x | B | C]`` of the conv state."""
    t = t.unflatten(-1, (tp, w + 2 * n))
    return torch.cat([t[..., :w].flatten(-2), t[..., w:w + n].flatten(-2),
                      t[..., w + n:].flatten(-2)], -1)


def ssm_decode_step(p: SSM, x1: torch.Tensor, cache: dict,
                    cfg: ModelConfig, place=None) -> torch.Tensor:
    """x1 (B,1,D) -> y (B,1,D); ``cache["conv"]`` (B,W-1,C) and
    ``cache["h"]`` (B,H,P,N) (views into the serving state) advance in
    place.  Placed (``place``), the cache holds the rank's shards (the
    module's docstring): collectives over ``model`` gather ``[x | B |
    C]``, the taps and the convolved vector, and reduce-scatter ``y``; the
    gated norm all-reduces its squares and ``out_proj`` its partial
    sums."""
    b = x1.shape[0]
    d_in, heads, groups = ssm_dims(cfg)
    n, hd = cfg.ssm_state, cfg.ssm_headdim
    gn = groups * n
    tp, r = (1, 0) if place is None else (place.tp, place.tp_rank)
    w = d_in // tp
    if place is not None:
        x1 = place.enter(x1)
    z, xs, bm, cm, dt = (x1 @ wt for wt in (p.wz, p.wx, p.wb, p.wc, p.wdt))
    new = torch.cat([xs, bm, cm], -1)
    conv_w = torch.cat([p.conv_x_w, p.conv_b_w, p.conv_c_w], 1)
    conv_b = torch.cat([p.conv_x_b, p.conv_b_b, p.conv_c_b], 0)
    if place is not None:
        # the rank's slab of the conv state's [x | B | C] dim
        cw = cache["conv"].shape[-1]
        c0 = r * cw
        new = _xbc(place.model_gather(new, 2), tp, w, gn // tp)[
            ..., c0:c0 + cw]
        taps = _xbc(place.model_gather(torch.cat([conv_w, conv_b[None]]),
                                       1), tp, w, gn // tp)[:, c0:c0 + cw]
        conv_w, conv_b = taps[:-1], taps[-1]
    hist = torch.cat([cache["conv"], new], 1)
    u = F.silu(conv_step(hist, conv_w, conv_b))
    if place is not None:
        u = place.model_gather(u, 1)
    xs, bm, cm = u.split([d_in, gn, gn], -1)
    # the rank's slab of h's N
    nh = cache["h"].shape[-1]
    n0 = r * nh
    rep = heads // groups
    xh = xs.reshape(b, heads, hd).float()
    bmh = bm.reshape(b, groups, n).repeat_interleave(rep, 1).float()[
        ..., n0:n0 + nh]
    cmh = cm.reshape(b, groups, n).repeat_interleave(rep, 1).float()[
        ..., n0:n0 + nh]
    dtv = F.softplus(dt.float() + p.dt_bias.float())[:, 0]       # (B, H)
    a_head = -torch.exp(p.A_log.float())
    decay = torch.exp(dtv * a_head)[..., None, None]
    h = decay * cache["h"] + (xh * dtv[..., None])[..., None] \
        * bmh[:, :, None, :]
    y = torch.matmul(h, cmh[..., None])[..., 0].reshape(b, d_in)
    if place is not None:
        # each rank's part of the sum over N, summed onto its channels
        y = place.model_scatter(y, 1)
    x0 = r * w
    y = y + xs[:, x0:x0 + w].float() * _expand(p.D.float(), hd)[x0:x0 + w]
    y = y.reshape(b, 1, w).to(x1.dtype)
    y = rmsnorm(p.norm_scale, y * F.silu(z), cfg.norm_eps, place)
    cache["conv"].copy_(hist[:, 1:])
    cache["h"].copy_(h)
    y = y @ p.out_proj
    return y if place is None else place.exit(y)


def ssd_chunked(x, dt, a_head, bm, cm, chunk: int) -> torch.Tensor:
    """x (B,S,H,P), dt (B,S,H), a_head (H,), bm/cm (B,S,G,N) -> y
    (B,S,H,P) in ``x``'s type; float32 inside.  ``S`` not a multiple of
    the chunk is zero-padded (dt = 0: a padded step decays by 1 and adds
    nothing) and the output cut back."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    q = min(chunk, s)
    if s % q:
        pad = q - s % q

        def zpad(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))

        return ssd_chunked(zpad(x), zpad(dt), a_head, zpad(bm), zpad(cm),
                           q)[:, :s]
    nc, rep = s // q, h // g
    dtf = dt.float()
    da = dtf * a_head.float()                              # (B,S,H) log-decay
    xdt = x.float() * dtf[..., None]                       # dt-weighted input

    def r4(t):                                  # (B,S,...) -> (B,nc,Q,...)
        return t.reshape((b, nc, q) + t.shape[2:])

    da_c, xdt_c = r4(da), r4(xdt)
    bh_c = r4(bm.repeat_interleave(rep, 2).float())        # (B,nc,Q,H,N)
    ch_c = r4(cm.repeat_interleave(rep, 2).float())
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    cs = torch.einsum("ij,bcjh->bcih", tri.float(), da_c)  # inclusive sums

    # intra-chunk: y_i += sum_{j<=i} exp(cs_i - cs_j) (C_i . B_j) xdt_j
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]     # (B,nc,i,j,H)
    el = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                               float("-inf")))
    scores = torch.einsum("bcihn,bcjhn->bcijh", ch_c, bh_c)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores * el, xdt_c)

    # chunk-final states: S_c = sum_j exp(cs_end - cs_j) xdt_j (x) B_j
    dec_end = torch.exp(cs[:, :, -1:, :] - cs)             # (B,nc,Q,H)
    s_c = torch.einsum("bcjhp,bcjhn->bchpn", xdt_c * dec_end[..., None],
                       bh_c)

    # inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(cs[:, :, -1, :])[..., None, None]  # (B,nc,H,1,1)
    hprev = x.new_zeros((b, h, p, n), dtype=torch.float32)
    before = []
    for c in range(nc):
        before.append(hprev)
        hprev = chunk_decay[:, c] * hprev + s_c[:, c]
    h_before = torch.stack(before, 1)                      # (B,nc,H,P,N)

    y_inter = torch.einsum("bcihn,bchpn->bcihp", ch_c, h_before) \
        * torch.exp(cs)[..., None]
    return (y_intra + y_inter).reshape(b, s, h, p).to(x.dtype)


def ssd_sequential(x, dt, a_head, bm, cm) -> torch.Tensor:
    """The step-by-step oracle of :func:`ssd_chunked` (the same
    recurrence, one position at a time, float32); tests only."""
    b, s, h, p = x.shape
    rep = h // bm.shape[2]
    bh = bm.repeat_interleave(rep, 2).float()
    ch = cm.repeat_interleave(rep, 2).float()
    xf, dtf, a = x.float(), dt.float(), a_head.float()
    hs = x.new_zeros((b, h, p, bm.shape[3]), dtype=torch.float32)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a)[..., None, None]
        hs = decay * hs + (xf[:, t] * dtf[:, t, :, None])[..., None] \
            * bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", hs, ch[:, t]))
    return torch.stack(ys, 1).to(x.dtype)


def ssm_forward(p: SSM, x: torch.Tensor, cfg: ModelConfig,
                place=None) -> torch.Tensor:
    """The full-sequence mixer of training, x (B,S,D) -> (B,S,D):
    projections, the three causal convolutions with SiLU, softplus ``dt``,
    :func:`ssd_chunked`, the D skip, the gated RMSNorm and ``out_proj``.
    Placed (``place``), on the rank's ``d_in / tp`` channels, cut into
    sub-heads of ``q = gcd(headdim, d_in / tp)`` channels, each inside
    one head: every sub-head takes its head's ``dt``, decay and ``D``;
    ``B`` and ``C`` are the rank's convolved slabs gathered whole over
    ``model``; x enters whole (``place.enter``) and the output leaves
    summed over ``model`` (``place.exit``)."""
    b, s, _ = x.shape
    d_in, heads, groups = ssm_dims(cfg)
    n, hd = cfg.ssm_state, cfg.ssm_headdim
    tp, r = (1, 0) if place is None else (place.tp, place.tp_rank)
    w = d_in // tp
    q = math.gcd(hd, w)
    j0, nq = r * w // q, w // q                    # the rank's sub-heads
    if place is not None:
        x = place.enter(x)
    z, xs, bm, cm, dt = (x @ wt for wt in (p.wz, p.wx, p.wb, p.wc, p.wdt))
    xs = F.silu(causal_conv(xs, p.conv_x_w, p.conv_x_b))
    bm = F.silu(causal_conv(bm, p.conv_b_w, p.conv_b_b))
    cm = F.silu(causal_conv(cm, p.conv_c_w, p.conv_c_b))
    if place is not None:
        bm, cm = place.model_gather(bm, 2), place.model_gather(cm, 2)
    xh = xs.reshape(b, s, nq, q)
    dtv = F.softplus(dt.float() + p.dt_bias.float())
    a_head = -torch.exp(p.A_log.float())

    def sub(t):                     # per head -> the rank's sub-heads
        return t if tp == 1 else _expand(t, hd // q)[..., j0:j0 + nq]

    y = ssd_chunked(xh, sub(dtv), sub(a_head),
                    bm.reshape(b, s, groups, n), cm.reshape(b, s, groups, n),
                    cfg.ssm_chunk)
    y = y + xh * sub(p.D)[:, None].to(y.dtype)
    y = rmsnorm(p.norm_scale, y.reshape(b, s, w) * F.silu(z), cfg.norm_eps,
                place)
    y = y @ p.out_proj
    return y if place is None else place.exit(y)
