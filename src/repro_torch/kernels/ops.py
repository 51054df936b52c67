"""Public wrappers around the port's kernels.

``rans_encode`` / ``rans_encode_chunked`` wrap the encode kernel
(:mod:`repro_torch.kernels.rans_encode`) and return packed
``EncodedLanes`` / ``ChunkedLanes``, byte-identical to the pure-torch
``core.coder.encode[_chunked]``; the chunked encode is one launch for the
whole stream.  ``rans_decode_step`` (from
:mod:`repro_torch.kernels.rans_decode`) is the fused serve decode's
per-position pop.  Each wrapper runs its kernel for CUDA tensors and the
kernel's plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.core import constants as C
from repro_torch.core.bitstream import ChunkedLanes, EncodedLanes
from repro_torch.core.coder import default_cap, num_chunks
from repro_torch.kernels.rans_decode import rans_decode_step  # noqa: F401
from repro_torch.kernels.rans_encode import rans_encode_lanes

__all__ = ["rans_encode", "rans_encode_chunked", "rans_decode_step"]


def _header_only(lanes: int, cap: int, device) -> EncodedLanes:
    """The ``T == 0`` stream: the 4 flush bytes of the initial state, with
    the coder's drop-not-wrap cursor (``cap < 4`` overflows)."""
    buf = torch.zeros((lanes, cap), dtype=torch.uint8, device=device)
    p = cap
    for sh in (0, 8, 16, 24):
        if p > 0:
            buf[:, p - 1] = (C.RANS_L >> sh) & 0xFF
        p -= 1
    def full(v, dt):
        return torch.full((lanes,), v, dtype=dt, device=device)

    return EncodedLanes(buf=buf, start=full(max(p, 0), torch.int32),
                        length=full(cap - p, torch.int32),
                        overflow=full(p < 0, torch.bool))


def rans_encode(symbols: torch.Tensor, tbl, cap: int | None = None
                ) -> EncodedLanes:
    """Kernel-backed monolithic multi-lane encode."""
    lanes, t_len = symbols.shape
    cap = default_cap(t_len) if cap is None else cap
    if t_len == 0:
        return _header_only(lanes, cap, symbols.device)
    buf, start, length, overflow = rans_encode_lanes(
        symbols.to(torch.int32).contiguous(), tbl, cap=cap)
    return EncodedLanes(buf=buf[0], start=start[0], length=length[0],
                        overflow=overflow[0])


def rans_encode_chunked(symbols: torch.Tensor, tbl, chunk_size: int,
                        cap: int | None = None) -> ChunkedLanes:
    """Kernel-backed chunked encode (bit-exact vs coder.encode_chunked)."""
    lanes, t_len = symbols.shape
    num_chunks(t_len, chunk_size)            # validates chunk_size > 0
    cap = default_cap(min(chunk_size, t_len)) if cap is None else cap
    if t_len == 0:
        z = torch.zeros((0, lanes), dtype=torch.int32, device=symbols.device)
        return ChunkedLanes(
            buf=torch.zeros((0, lanes, cap), dtype=torch.uint8,
                            device=symbols.device),
            start=z, length=z,
            overflow=torch.zeros((0, lanes), dtype=torch.bool,
                                 device=symbols.device))
    return ChunkedLanes(*rans_encode_lanes(
        symbols.to(torch.int32).contiguous(), tbl, cap=cap,
        chunk_size=chunk_size))
