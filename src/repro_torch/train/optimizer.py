"""AdamW (float32 or bfloat16 moments) with a global-norm clip.

Port of ``repro.train.optimizer`` as plain functions over dicts of tensors
(parameter name -> tensor), under ``torch.no_grad()``.  The arithmetic is
the reference's, in its order, in float32: ``m`` and ``v`` are updated in
float32 from the stored moments and rounded to ``moment_dtype`` only when
stored, and the update is ``(m/bc1) / (sqrt(v/bc2) + eps) + wd * p``,
applied as ``p - lr * update``.  ``torch.optim.AdamW`` places ``eps`` and
the decay otherwise, so it is a different function and is not used.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    m: dict
    v: dict


def as_dtype(dt) -> torch.dtype:
    """A dtype or its name (``"float32"``, ``"bfloat16"``)."""
    return getattr(torch, dt) if isinstance(dt, str) else dt


@torch.no_grad()
def adamw_init(params: dict, moment_dtype=_F32) -> AdamWState:
    dt = as_dtype(moment_dtype)
    some = next(iter(params.values()))
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=some.device),
        m={k: torch.zeros(p.shape, dtype=dt, device=p.device)
           for k, p in params.items()},
        v={k: torch.zeros(p.shape, dtype=dt, device=p.device)
           for k, p in params.items()})


@torch.no_grad()
def global_norm(tree: dict, total=None) -> torch.Tensor:
    """The L2 norm of every leaf.  ``total`` maps the leaves' sums of
    squares (by name) to the global sum: a placed rank's
    (``sharding.Placement.sum_squares``) counts each entry of the mesh
    once."""
    sq = {k: torch.sum(torch.square(x.to(_F32))) for k, x in tree.items()}
    if total is not None:
        return torch.sqrt(total(sq))
    return torch.sqrt(torch.sum(torch.stack(list(sq.values()))))


@torch.no_grad()
def clip_by_global_norm(tree: dict, max_norm: float, total=None):
    """Scale every leaf by ``min(1, max_norm / norm)``; returns the scaled
    tree and the norm before scaling (``total``: :func:`global_norm`)."""
    norm = global_norm(tree, total)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.to(_F32) * scale).to(g.dtype)
            for k, g in tree.items()}, norm


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params: dict, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One AdamW step; returns ``(new params, new state)`` as new tensors
    (the inputs are left as they are).  ``lr`` is a float or a float32
    scalar tensor."""
    step = state.step + 1
    t = step.to(_F32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=_F32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=_F32, device=t.device), t)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        gf = grads[k].to(_F32)
        m32 = state.m[k].to(_F32) * b1 + gf * (1 - b1)
        v32 = state.v[k].to(_F32) * b2 + gf * gf * (1 - b2)
        upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        upd = upd + weight_decay * p.to(_F32)
        new_p[k] = (p.to(_F32) - lr * upd).to(p.dtype)
        new_m[k] = m32.to(state.m[k].dtype)
        new_v[k] = v32.to(state.v[k].dtype)
    return new_p, AdamWState(step=step, m=new_m, v=new_v)


def cosine_lr(step: torch.Tensor, *, base_lr: float = 3e-4,
              warmup: int = 100, total: int = 10_000,
              min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup over ``warmup`` steps, then a cosine decay to
    ``min_ratio * base_lr`` at ``total``; a float32 scalar tensor."""
    t = step.to(_F32)
    warm = t / max(warmup, 1)
    frac = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return base_lr * torch.where(t < warmup, warm, cos)
