"""Vectorized multi-lane rANS coder in plain PyTorch (the ``coder`` backend).

Port of ``repro.core.coder``: ``lanes`` independent rANS states updated in
lockstep, each lane owning a private byte stream written backward (rANS is
LIFO) through a per-lane cursor.  A cursor that runs past the buffer head
keeps decrementing while its writes drop, never wrap, so ``cap - ptr``
reports the true need and the lane is flagged as overflowed.

Decoding pops one symbol per lane with the fixed 2-step masked refill; a
refill that would read past the window injects 0 and raises the lane's
underflow flag, which host entry points turn into
:class:`StreamExhaustedError`.

States are int64 uint32 values; tables are int32 bit patterns.  The
kernels' plain versions in ``repro_torch.kernels`` are built on this
module (:func:`encode_chunked` and :func:`pop`), so one implementation
answers to the reference's tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import constants as C
from repro_torch.core import search, update
from repro_torch.core.bitstream import ChunkedLanes, EncodedLanes
from repro_torch.core.search import take_gather
from repro_torch.core.spc import TableSet

_I64 = torch.int64
_I32 = torch.int32


class EncState(NamedTuple):
    s: torch.Tensor     # (lanes,) int64 uint32 values
    buf: torch.Tensor   # (lanes, cap + 1) uint8; column cap is the drop slot
    ptr: torch.Tensor   # (lanes,) int64 cursor; next write at ptr-1


def encoder_init(lanes: int, cap: int, device) -> EncState:
    return EncState(s=torch.full((lanes,), C.RANS_L, dtype=_I64,
                                 device=device),
                    buf=torch.zeros((lanes, cap + 1), dtype=torch.uint8,
                                    device=device),
                    ptr=torch.full((lanes,), cap, dtype=_I64, device=device))


def _emit_backward(buf, ptr, byte, cond):
    """Masked one-byte backward emit: lanes that do not emit, or whose
    cursor is past the buffer head, write to the drop column instead; the
    cursor still decrements for every emitting lane."""
    drop = buf.shape[1] - 1
    widx = torch.where(cond & (ptr > 0), ptr - 1, drop)
    buf.scatter_(1, widx[:, None], byte[:, None].to(torch.uint8))
    return buf, ptr - cond.to(_I64)


def encode_put(st: EncState, x: torch.Tensor, tbl) -> EncState:
    """Push one symbol per lane and land its renorm records backward."""
    e = update.gather_encode_entry(tbl, x)
    s, recs = update.encode_step(st.s, e)
    buf, ptr = st.buf, st.ptr
    for byte, cond in recs:
        buf, ptr = _emit_backward(buf, ptr, byte, cond)
    return EncState(s, buf, ptr)


def encoder_flush(st: EncState) -> EncState:
    """Write the 4-byte big-endian final state header (low byte first)."""
    s, buf, ptr = st.s, st.buf, st.ptr
    true = torch.ones_like(s, dtype=torch.bool)
    for shift in (0, 8, 16, 24):
        buf, ptr = _emit_backward(buf, ptr, (s >> shift) & 0xFF, true)
    return EncState(s, buf, ptr)


def default_cap(n_symbols: int) -> int:
    """Worst case 2 bytes/symbol + 4-byte state header, padded."""
    return 2 * n_symbols + 8


def is_per_position(tbl: TableSet, t_len: int) -> bool:
    """True when the TableSet carries a leading per-position T dim."""
    return tbl.freq.ndim in (2, 3) and tbl.freq.shape[0] == t_len


def encode(symbols: torch.Tensor, tbl: TableSet,
           cap: int | None = None) -> EncodedLanes:
    """Encode ``(lanes, T)`` symbols against static ``(K,)`` or
    per-position ``(T, K)`` / ``(T, lanes, K)`` tables."""
    lanes, t_len = symbols.shape
    cap = default_cap(t_len) if cap is None else cap
    per_position = is_per_position(tbl, t_len)
    sym = symbols.to(_I64)
    st = encoder_init(lanes, cap, symbols.device)
    for t in range(t_len - 1, -1, -1):
        tbl_t = TableSet(*(a[t] for a in tbl)) if per_position else tbl
        st = encode_put(st, sym[:, t], tbl_t)
    st = encoder_flush(st)
    return EncodedLanes(buf=st.buf[:, :cap],
                        start=torch.clamp(st.ptr, min=0).to(_I32),
                        length=(cap - st.ptr).to(_I32), overflow=st.ptr < 0)


def num_chunks(n_symbols: int, chunk_size: int) -> int:
    """Chunk count covering ``n_symbols`` (last chunk may be ragged)."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    return -(-n_symbols // chunk_size)


def chunk_lengths(n_symbols: int, chunk_size: int) -> list[int]:
    """Per-chunk symbol counts; all ``chunk_size`` except a ragged tail."""
    n = num_chunks(n_symbols, chunk_size)
    return [min(chunk_size, n_symbols - c * chunk_size) for c in range(n)]


def chunk_encoded(enc: ChunkedLanes, c: int) -> EncodedLanes:
    """View chunk ``c`` as a standalone :class:`EncodedLanes`."""
    return EncodedLanes(buf=enc.buf[c], start=enc.start[c],
                        length=enc.length[c],
                        overflow=None if enc.overflow is None
                        else enc.overflow[c])


def encode_chunked(symbols: torch.Tensor, tbl: TableSet, chunk_size: int,
                   cap: int | None = None) -> ChunkedLanes:
    """Encode ``(lanes, T)`` as independent chunks, each with its own flush;
    chunk ``c``'s bytes equal :func:`encode` of its symbols alone."""
    lanes, t_len = symbols.shape
    num_chunks(t_len, chunk_size)
    cap = default_cap(min(chunk_size, t_len)) if cap is None else cap
    per_position = is_per_position(tbl, t_len)
    dev = symbols.device
    if t_len == 0:
        z = torch.zeros((0, lanes), dtype=_I32, device=dev)
        return ChunkedLanes(buf=torch.zeros((0, lanes, cap), dtype=torch.uint8,
                                            device=dev),
                            start=z, length=z,
                            overflow=torch.zeros((0, lanes), dtype=torch.bool,
                                                 device=dev))
    parts = []
    for c, n in enumerate(chunk_lengths(t_len, chunk_size)):
        t0 = c * chunk_size
        tbl_c = (TableSet(*(a[t0:t0 + n] for a in tbl)) if per_position
                 else tbl)
        parts.append(encode(symbols[:, t0:t0 + n], tbl_c, cap=cap))
    return ChunkedLanes(*(torch.stack(xs) for xs in zip(*parts)))


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

class StreamExhaustedError(ValueError):
    """Decode read past the end of a lane's byte window (more symbols were
    requested than the stream encodes, or the stream is truncated)."""


def _check_exhausted(underflow, where: str = "decode") -> None:
    """Host-side gate on the per-lane underflow flag."""
    if underflow is None:
        return
    u = (underflow.detach().cpu().numpy() if isinstance(underflow,
                                                        torch.Tensor)
         else np.asarray(underflow))
    if u.any():
        bad = np.nonzero(u.reshape(-1))[0].tolist()
        raise StreamExhaustedError(
            f"{where}: {int(u.sum())} lane stream(s) exhausted mid-decode "
            f"(flat lane indices {bad[:16]}{'...' if len(bad) > 16 else ''}) "
            "— more symbols were requested than the stream encodes, or the "
            "stream is truncated; symbols past that point are garbage")


class DecState(NamedTuple):
    s: torch.Tensor                         # (lanes,) int64 uint32 values
    ptr: torch.Tensor                       # (lanes,) int64 read cursor
    underflow: torch.Tensor | None = None   # (lanes,) bool


def _read_byte(buf, lane_idx, ptr, cap):
    """Guarded forward byte read: out-of-window reads yield 0 and report."""
    oob = (ptr < 0) | (ptr >= cap)
    byte = buf[lane_idx, torch.clamp(ptr, 0, cap - 1)].to(_I64)
    return torch.where(oob, torch.zeros_like(byte), byte), oob


def decoder_init(enc: EncodedLanes) -> DecState:
    """Read each lane's 4-byte big-endian state header."""
    lanes, cap = enc.buf.shape
    dev = enc.buf.device
    lane_idx = torch.arange(lanes, device=dev)
    s = torch.zeros((lanes,), dtype=_I64, device=dev)
    ptr = enc.start.to(_I64)
    under = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    for _ in range(4):
        byte, oob = _read_byte(enc.buf, lane_idx, ptr, cap)
        under = under | oob
        s = ((s << 8) | byte) & C.U32_MASK
        ptr = ptr + 1
    return DecState(s=s, ptr=ptr, underflow=under)


def pop(buf: torch.Tensor, s: torch.Tensor, ptr: torch.Tensor,
        freq: torch.Tensor, cdf: torch.Tensor, prob_bits: int = C.PROB_BITS,
        candidates: torch.Tensor | None = None):
    """Pop one symbol per lane from int64 states and cursors: CDF search,
    state update, fixed 2-step masked refill.  ``freq``/``cdf`` are ``(K,)``
    shared or ``(lanes, K)`` rows.  Returns ``(s', ptr', symbol, probes,
    under)``; ``under`` counts the lane's active refills that read outside
    its window (each injects 0)."""
    lanes, cap = buf.shape
    lane_idx = torch.arange(lanes, device=buf.device)
    slot = s & ((1 << prob_bits) - 1)
    k = freq.shape[-1]
    x, probes = search.find_symbol(cdf, k, slot, candidates=candidates)
    f = take_gather(freq, x).to(_I64)
    start = take_gather(cdf, x).to(_I64)
    s = (f * (s >> prob_bits) + slot - start) & C.U32_MASK
    under = torch.zeros((lanes,), dtype=_I64, device=buf.device)
    for _ in range(C.MAX_RENORM_STEPS):
        cond = s < C.RANS_L
        byte, oob = _read_byte(buf, lane_idx, ptr, cap)
        under = under + (cond & oob).to(_I64)
        s = torch.where(cond, ((s << C.RENORM_SHIFT) | byte) & C.U32_MASK, s)
        ptr = ptr + cond.to(_I64)
    return s, ptr, x, probes, under


def decode_get(st: DecState, buf: torch.Tensor, tbl,
               prob_bits: int = C.PROB_BITS,
               candidates: torch.Tensor | None = None):
    """Pop one symbol per lane.  ``tbl`` needs ``freq``/``cdf`` rows
    (``(K,)`` shared or ``(lanes, K)``).  Returns (state', symbol, probes)."""
    s, ptr, x, probes, n_under = pop(buf, st.s, st.ptr, tbl.freq, tbl.cdf,
                                     prob_bits, candidates)
    under = n_under > 0
    if st.underflow is not None:
        under = under | st.underflow
    return DecState(s, ptr, under), x, probes
