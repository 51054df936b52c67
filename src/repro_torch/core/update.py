"""Shared two-stage rANS encode update (paper Sec. IV-A/B).

Port of ``repro.core.update``.  ``encode_step`` is the encoder's hot loop in
plain PyTorch: a fixed 2-step masked byte renorm that emits ``(byte,
emitted?)`` records, then the Barrett two-path update ``s + bias + q*cmpl``
with ``q = umulhi32(s, rcp) >> rshift``.  States are int64 uint32 values
(:mod:`repro_torch.core.u32`); table planes are int32 bit patterns.  The
CUDA encode kernel (``csrc/rans_encode.cu``) runs the same arithmetic with
``__umulhi``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import constants as C
from repro_torch.core import u32
from repro_torch.core.search import take_gather


def umulhi32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact high 32 bits of a 32x32 unsigned product, for any uint32
    inputs: ``floor(a*b / 2**32) = (a*bh + (a*bl >> 16)) >> 16`` with
    16-bit limbs of ``b``, every partial product below 2**49 in int64."""
    a = u32.value(a)
    b = u32.value(b)
    bl, bh = b & 0xFFFF, b >> 16
    return (a * bh + ((a * bl) >> 16)) >> 16


def barrett_div(s: torch.Tensor, rcp: torch.Tensor,
                rshift: torch.Tensor) -> torch.Tensor:
    """floor(s / f) via the SPC reciprocal; exact for s < 2**31, f >= 2."""
    return umulhi32(s, rcp) >> rshift.to(torch.int64)


class EncTables(NamedTuple):
    """The five encoder-side planes of a TableSet."""

    rcp: torch.Tensor
    rshift: torch.Tensor
    bias: torch.Tensor
    cmpl: torch.Tensor
    x_max: torch.Tensor


def encode_planes(tbl) -> EncTables:
    """Project a TableSet(-like) down to the encoder's five planes."""
    return EncTables(rcp=tbl.rcp, rshift=tbl.rshift, bias=tbl.bias,
                     cmpl=tbl.cmpl, x_max=tbl.x_max)


# the reference's name for the planes gathered at each lane's symbol
EncEntry = EncTables


def gather_encode_entry(tbl, x: torch.Tensor, gather=take_gather) -> EncEntry:
    """Per-lane encode entries for symbols ``x``, as int64 uint32 values."""
    return EncEntry(*(u32.value(gather(getattr(tbl, name), x))
                      for name in EncEntry._fields))


def encode_step(s: torch.Tensor, e: EncEntry):
    """Push one symbol per lane.  ``s``: int64 uint32 values; ``e``: int64
    entries.  Returns ``(s', records)`` with ``MAX_RENORM_STEPS`` records of
    ``(byte int64, emitted bool)`` in emission order."""
    records = []
    for _ in range(C.MAX_RENORM_STEPS):
        cond = s >= e.x_max
        records.append((s & C.BYTE_MASK, cond))
        s = torch.where(cond, s >> C.RENORM_SHIFT, s)
    q = barrett_div(s, e.rcp, e.rshift)
    s = (s + e.bias + q * e.cmpl) & C.U32_MASK
    return s, tuple(records)
