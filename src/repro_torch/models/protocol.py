"""The model-state protocol surface ``serve/`` drives.

Port of the dense part of ``repro.models.protocol``: serving code calls
:func:`init_state` and :func:`decode_step` and never touches an
architecture module.  Only the dense family is ported; other families
raise a named ``KeyError``.
"""

from __future__ import annotations

import torch

from repro_torch.models.transformer import DenseLM, KVState

FAMILIES = ("dense",)


def _check(model) -> DenseLM:
    if model.cfg.family not in FAMILIES:
        raise KeyError(f"family {model.cfg.family!r} is not ported yet "
                       f"(ported: {FAMILIES})")
    return model


def init_state(model, batch: int, max_len: int) -> KVState:
    """All-zero serving state for ``batch`` rows and a ``max_len`` ring."""
    return _check(model).init_state(batch, max_len)


def decode_step(model, state: KVState, token: torch.Tensor,
                pos: int) -> torch.Tensor:
    """One serving step: token (B,1) -> logits (B, Vpad); state in place."""
    return _check(model).decode_step(state, token, pos)
