"""Bit-Swap hierarchical VAE over the lane stack (bits-back coding).

Port of ``repro.models.vae``: a small 2-level VAE whose coding path runs
through :mod:`repro_torch.core.stack`.  Each lane is one data vector (an
image patch of ``d_x`` pixels); the lane axis is the coder's SIMD axis.

    p(z2) = N(0, I)                q2(z2 | z1) = N(mu2(z1), sig2(z1))
    p(z1 | z2) = N(mu, sig)(z2)    q1(z1 | x)  = N(mu1(x), sig1(x))
    p(x | z1)  = DiscretizedLogistic(mu(z1), s(z1)) per pixel

Bit-Swap coding order (encode; decode is the exact reverse with push and
pop swapped, which restores the initial stack bit for bit):

    A. pop  k1 ~ q1(. | x)      (recovers bits: the bits-back credit)
    B. push x  ~ p(x | z1)
    C. pop  k2 ~ q2(. | z1)
    D. push k1 ~ p(z1 | z2)
    E. push k2 ~ p(z2)          (equal-mass bins: exactly Uniform)

Parameters are a flat dict of float32 tensors keyed ``"<net>.<leaf>"``
(``"enc1.win"``, ``"enc1.core.wi_gate"``, ...); :func:`from_reference` and
:func:`to_reference` convert the reference's nested tree.  Training
(:func:`train_vae`) maximizes the continuous ELBO with reparameterized
samples and the port's AdamW.

The decode side recomputes every net on decoded symbols at the encode
side's shapes (``(lanes, d)``), so the tables are the same integers only
if the same floats come out: on the card that needs the deterministic
settings of :func:`repro_torch.configure_cuda_numerics` and the same row
counts on both sides.  The tables' SPC runs through B6 for CUDA tensors
(:func:`repro_torch.core.stack.freq_cdf`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import constants as C
from repro_torch.core import stack
from repro_torch.device import resolve_device
from repro_torch.models.layers import mlp
from repro_torch.train import optimizer

NETS = ("enc1", "enc2", "dec2", "dec1")
_LEAVES = ("win", "core.wi_gate", "core.wi_up", "core.wo", "wout", "bout")
# each net leaf's logical axes (the reference's ``_net_defs``)
_AXES = {"win": ("embed", "mlp"), "core.wi_gate": ("embed", "mlp"),
         "core.wi_up": ("embed", "mlp"), "core.wo": ("mlp", "embed"),
         "wout": ("mlp", "embed"), "bout": ("embed",)}


def param_axes() -> dict:
    """Each parameter's logical axes, keyed as the parameters are
    (``vae_defs``)."""
    return {f"{net}.{leaf}": _AXES[leaf] for net in NETS for leaf in _LEAVES}


class VAEConfig(NamedTuple):
    d_x: int = 64        # pixels per lane (one 8x8 patch)
    d_z: int = 4         # latent dims per level
    d_h: int = 48        # hidden width
    z_bins: int = 16     # latent quantile bins (power of two: exact Uniform)
    x_bins: int = 256    # pixel levels
    prob_bits: int = C.PROB_BITS


def _shapes(cfg: VAEConfig) -> dict:
    """Each parameter's shape and its init scale (None: zeros)."""
    io = {"enc1": (cfg.d_x, 2 * cfg.d_z), "enc2": (cfg.d_z, 2 * cfg.d_z),
          "dec2": (cfg.d_z, 2 * cfg.d_z), "dec1": (cfg.d_z, 2 * cfg.d_x)}
    h, ff = cfg.d_h, 2 * cfg.d_h
    out = {}
    for net, (d_in, d_out) in io.items():
        out.update({f"{net}.win": ((d_in, h), 0.1),
                    f"{net}.core.wi_gate": ((h, ff), 0.02),
                    f"{net}.core.wi_up": ((h, ff), 0.02),
                    f"{net}.core.wo": ((ff, h), 0.02),
                    f"{net}.wout": ((h, d_out), 0.1),
                    f"{net}.bout": ((d_out,), None)})
    return out


def init_vae(cfg: VAEConfig, seed: int = 0, device=None) -> dict:
    """Seeded init, the reference's rule (normal x scale, zero biases; its
    random bits differ), drawn on the CPU then moved to ``device`` (the
    card when None)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.zeros(shape) if scale is None
                else torch.randn(shape, generator=g) * scale).to(dev)
            for k, (shape, scale) in _shapes(cfg).items()}


def from_reference(tree: dict, device=None) -> dict:
    """The reference's nested parameter tree (numpy arrays) -> the flat
    dict of float32 tensors on ``device`` (the card when None)."""
    dev = resolve_device(device)
    out = {}
    for net in NETS:
        for leaf in _LEAVES:
            a = tree[net]
            for part in leaf.split("."):
                a = a[part]
            out[f"{net}.{leaf}"] = torch.as_tensor(
                np.asarray(a, np.float32).copy(), device=dev)
    return out


def to_reference(params: dict) -> dict:
    """The flat dict -> the reference's nested tree of numpy arrays."""
    tree: dict = {}
    for key, t in params.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy().copy()
    return tree


# ---------------------------------------------------------------------------
# networks: in-proj -> gated-SiLU MLP residual core -> out-proj
# ---------------------------------------------------------------------------

def _net(params: dict, net: str, x: torch.Tensor) -> torch.Tensor:
    p = {leaf: params[f"{net}.{leaf}"] for leaf in _LEAVES}
    h = F.silu(x @ p["win"])
    h = h + mlp(p["core.wi_gate"], p["core.wi_up"], p["core.wo"], h)
    return h @ p["wout"] + p["bout"]


def _mu_sig(raw: torch.Tensor):
    """``(..., 2d)`` -> (mu, sigma) with log-sigma clamped to [-4, 2]
    (training and coding see the same distributions)."""
    mu, logsig = raw.chunk(2, dim=-1)
    return mu, torch.exp(torch.clamp(logsig, -4.0, 2.0))


def _mu_logs(raw: torch.Tensor):
    """Pixel-likelihood head: (mu, log-scale clamped to [-7, 1])."""
    mu, log_s = raw.chunk(2, dim=-1)
    return mu, torch.clamp(log_s, -7.0, 1.0)


def normalize(x: torch.Tensor, x_bins: int) -> torch.Tensor:
    """Integer pixel levels -> bin centres in [-1, 1]."""
    return 2.0 * (x.to(torch.float32) + 0.5) / x_bins - 1.0


# ---------------------------------------------------------------------------
# continuous ELBO (training)
# ---------------------------------------------------------------------------

def _gauss_logpdf(z, mu, sig):
    zn = (z - mu) / sig
    return -0.5 * zn * zn - torch.log(sig) - 0.5 * math.log(2 * math.pi)


def _dlogistic_loglik(x, mu, log_s, x_bins: int):
    """log p(x) of the discretized logistic over ``x_bins`` levels in
    [-1, 1] (the binning the coding path quantizes; end bins take the open
    tails)."""
    xf = x.to(torch.float32)
    lower = 2.0 * xf / x_bins - 1.0
    upper = 2.0 * (xf + 1.0) / x_bins - 1.0
    inv_s = torch.exp(-log_s)
    cdf_lo = torch.where(x <= 0, 0.0, torch.sigmoid((lower - mu) * inv_s))
    cdf_hi = torch.where(x >= x_bins - 1, 1.0,
                         torch.sigmoid((upper - mu) * inv_s))
    return torch.log(torch.clamp(cdf_hi - cdf_lo, min=1e-12))


def elbo_loss(params: dict, x: torch.Tensor, cfg: VAEConfig, noise=None,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """Negative ELBO in nats per lane (mean over lanes).  ``noise`` is the
    two reparameterization draws ``(e1, e2)``, each ``(lanes, d_z)``; when
    None they are drawn from ``generator`` on its device."""
    xn = normalize(x, cfg.x_bins)
    mu1, sig1 = _mu_sig(_net(params, "enc1", xn))
    if noise is None:
        noise = tuple(torch.randn(mu1.shape, generator=generator,
                                  device=generator.device).to(mu1.device)
                      for _ in range(2))
    e1, e2 = noise
    z1 = mu1 + sig1 * e1
    mu2, sig2 = _mu_sig(_net(params, "enc2", z1))
    z2 = mu2 + sig2 * e2

    mu1p, sig1p = _mu_sig(_net(params, "dec2", z2))
    mux, log_sx = _mu_logs(_net(params, "dec1", z1))

    log_px = _dlogistic_loglik(x, mux, log_sx, cfg.x_bins).sum(-1)
    kl1 = (_gauss_logpdf(z1, mu1, sig1)
           - _gauss_logpdf(z1, mu1p, sig1p)).sum(-1)
    kl2 = (_gauss_logpdf(z2, mu2, sig2)
           - _gauss_logpdf(z2, torch.zeros_like(mu2),
                           torch.ones_like(sig2))).sum(-1)
    return (-log_px + kl1 + kl2).mean()


def train_vae(cfg: VAEConfig, batches, *, steps: int = 300,
              lr: float = 3e-3, seed: int = 0, device=None):
    """Train on ``batches`` (callable ``step -> (lanes, d_x)`` int array)
    with AdamW (weight decay 1e-4) and a global-norm clip of 1.0.
    Returns ``(params, final loss)``; runs on ``device`` (the card when
    None), its noise from a generator there seeded with ``seed``."""
    dev = resolve_device(device)
    params = init_vae(cfg, seed, dev)
    opt = optimizer.adamw_init(params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    loss = None
    for i in range(steps):
        x = torch.as_tensor(np.asarray(batches(i)), dtype=torch.int64,
                            device=dev)
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        loss = elbo_loss(leaves, x, cfg, generator=gen)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        grads, _ = optimizer.clip_by_global_norm(grads, 1.0)
        params, opt = optimizer.adamw_update(grads, opt, params, lr,
                                             weight_decay=1e-4)
    return params, float(loss.detach())


# ---------------------------------------------------------------------------
# bits-back coding over the stack
# ---------------------------------------------------------------------------

def _latent_tables(mu, sig, edges, prob_bits: int):
    """Per-dim Gaussian bin tables: (lanes, d) nets -> (d, lanes, B)
    freq/cdf (the stack's per-position-per-lane layout)."""
    return stack.freq_cdf(stack.gaussian_bin_probs(mu.T, sig.T, edges),
                          prob_bits)


def _pixel_tables(params: dict, z1c, cfg: VAEConfig):
    """p(x | z1) tables: (d_x, lanes, x_bins) discretized logistic."""
    mux, log_sx = _mu_logs(_net(params, "dec1", z1c))
    return stack.freq_cdf(stack.logistic_bin_probs(mux.T, log_sx.T,
                                                   cfg.x_bins),
                          cfg.prob_bits)


def _uniform_tables(k: int, prob_bits: int, device):
    """Exact uniform tables over ``k`` symbols (``2**prob_bits % k == 0``:
    the equal-mass standard-normal prior over its own quantile bins)."""
    total = 1 << prob_bits
    if total % k:
        raise ValueError(f"uniform prior needs 2**{prob_bits} % {k} == 0")
    f = total // k
    freq = torch.full((k,), f, dtype=torch.int32, device=device)
    cdf = torch.arange(k + 1, dtype=torch.int32, device=device) * f
    return freq, cdf


def _bins(z_bins: int, device):
    edges, centres = stack.std_gaussian_bins(z_bins)
    return edges.to(device), centres.to(device)


@torch.no_grad()
def bb_encode(st: stack.StackState, params: dict, x: torch.Tensor,
              cfg: VAEConfig, backend: str = "coder") -> stack.StackState:
    """Bits-back encode one ``(lanes, d_x)`` batch onto the stack (the A-E
    schedule above).  The message's net cost is the growth of
    ``stack.stack_bytes``.  ``backend`` is the pops' (B2 for "kernel")."""
    pb = cfg.prob_bits
    edges, centres = _bins(cfg.z_bins, x.device)
    x = x.to(torch.int64)

    # A: pop k1 ~ q1(. | x)
    mu1, sig1 = _mu_sig(_net(params, "enc1", normalize(x, cfg.x_bins)))
    f1, c1 = _latent_tables(mu1, sig1, edges, pb)
    st, k1 = stack.pop_symbols(st, cfg.d_z, f1, c1, pb, backend=backend)
    z1c = centres[k1]

    # B: push x ~ p(x | z1)
    fx, cx = _pixel_tables(params, z1c, cfg)
    st = stack.push_symbols(st, x, fx, cx, pb)

    # C: pop k2 ~ q2(. | z1)
    mu2, sig2 = _mu_sig(_net(params, "enc2", z1c))
    f2, c2 = _latent_tables(mu2, sig2, edges, pb)
    st, k2 = stack.pop_symbols(st, cfg.d_z, f2, c2, pb, backend=backend)
    z2c = centres[k2]

    # D: push k1 ~ p(z1 | z2)
    mu1p, sig1p = _mu_sig(_net(params, "dec2", z2c))
    fp, cp = _latent_tables(mu1p, sig1p, edges, pb)
    st = stack.push_symbols(st, k1, fp, cp, pb)

    # E: push k2 ~ p(z2) (exactly uniform over equal-mass bins)
    fu, cu = _uniform_tables(cfg.z_bins, pb, x.device)
    return stack.push_symbols(st, k2, fu, cu, pb)


@torch.no_grad()
def bb_decode(st: stack.StackState, params: dict, cfg: VAEConfig,
              backend: str = "coder"):
    """Exact reverse of :func:`bb_encode`; returns ``(state, x (lanes,
    d_x) int64)``, the state equal to the pre-encode stack bit for bit."""
    pb = cfg.prob_bits
    dev = st.buf.device
    edges, centres = _bins(cfg.z_bins, dev)

    # E': pop k2 ~ p(z2)
    fu, cu = _uniform_tables(cfg.z_bins, pb, dev)
    st, k2 = stack.pop_symbols(st, cfg.d_z, fu, cu, pb, backend=backend)
    z2c = centres[k2]

    # D': pop k1 ~ p(z1 | z2)
    mu1p, sig1p = _mu_sig(_net(params, "dec2", z2c))
    fp, cp = _latent_tables(mu1p, sig1p, edges, pb)
    st, k1 = stack.pop_symbols(st, cfg.d_z, fp, cp, pb, backend=backend)
    z1c = centres[k1]

    # C': push k2 ~ q2(. | z1)
    mu2, sig2 = _mu_sig(_net(params, "enc2", z1c))
    f2, c2 = _latent_tables(mu2, sig2, edges, pb)
    st = stack.push_symbols(st, k2, f2, c2, pb)

    # B': pop x ~ p(x | z1)
    fx, cx = _pixel_tables(params, z1c, cfg)
    st, x = stack.pop_symbols(st, cfg.d_x, fx, cx, pb, backend=backend)

    # A': push k1 ~ q1(. | x)
    mu1, sig1 = _mu_sig(_net(params, "enc1", normalize(x, cfg.x_bins)))
    f1, c1 = _latent_tables(mu1, sig1, edges, pb)
    return stack.push_symbols(st, k1, f1, c1, pb), x
