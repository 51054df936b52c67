"""uint32 values in PyTorch.

PyTorch's CPU kernels have no arithmetic on ``torch.uint32`` (shifts, adds,
comparisons and gathers raise), so the port keeps two representations:

* **bit patterns** — ``int32`` tensors whose bits are the uint32 value.
  Tables (``TableSet`` fields) and the kernels' state inputs use them; only
  the Barrett reciprocal ``rcp`` ever exceeds ``2**31 - 1``.
* **values** — ``int64`` tensors holding the uint32 value exactly.  The
  plain PyTorch paths do their arithmetic here and mask with ``& U32_MASK``
  wherever the uint32 original wraps.

Conversion happens at API edges, never inside the per-step loops.
"""

from __future__ import annotations

import torch

from repro_torch.core.constants import U32_MASK


def value(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or any int tensor) -> int64 uint32 value."""
    return x.to(torch.int64) & U32_MASK


def bits(x: torch.Tensor) -> torch.Tensor:
    """int64 uint32 value -> int32 bit pattern (wraps values >= 2**31)."""
    x = x & U32_MASK
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
