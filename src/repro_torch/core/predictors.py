"""Decode-side predictors.  The main path needs only the model's own top-k
as trial symbols (the LM analogue of the paper's trial-symbol path)."""

from __future__ import annotations

import torch


def model_topk_candidates(logits: torch.Tensor, k: int) -> torch.Tensor:
    """(lanes, V) logits -> (lanes, k) int32 trial symbols.

    ``torch.topk`` may order tied logits differently from
    ``jax.lax.top_k``: that changes probe counts, never symbols.
    """
    if k == 0:
        return torch.zeros((logits.shape[0], 0), dtype=torch.int32,
                           device=logits.device)
    return torch.topk(logits, k, dim=-1).indices.to(torch.int32)
