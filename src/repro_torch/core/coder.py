"""Vectorized multi-lane rANS coder in plain PyTorch (the ``coder`` backend).

Port of ``repro.core.coder``: ``lanes`` independent rANS states updated in
lockstep, each lane owning a private byte stream written backward (rANS is
LIFO) through a per-lane cursor.  A cursor that runs past the buffer head
keeps decrementing while its writes drop, never wrap, so ``cap - ptr``
reports the true need and the lane is flagged as overflowed.

Decoding pops one symbol per lane with the fixed 2-step masked refill; a
refill that would read past the window injects 0 and raises the lane's
underflow flag, which host entry points turn into
:class:`StreamExhaustedError`.  :func:`decode_grid` decodes every (chunk,
lane) cell of a chunked stream at once, with the predictor-guided search,
candidate planes and per-cell read limits.

:func:`encode_records` is the scatter-free encode: the records scan
(:func:`encode_record_planes`) stacks each step's fixed-shape renorm
records, and one ``bitstream.compact_records`` pass builds the streams.

States are int64 uint32 values; tables are int32 bit patterns.  The
kernels' plain versions in ``repro_torch.kernels`` are built on this
module (:func:`encode_chunked`, :func:`encode_record_planes`, :func:`pop`
and :func:`decode_grid`), so one implementation answers to the
reference's tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import constants as C
from repro_torch.core import search, spc, update
from repro_torch.core.bitstream import (ChunkedLanes, EncodedLanes,
                                        compact_records)
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


def is_per_position(tbl, t_len: int) -> bool:
    """True when the encoder tables (a TableSet or its five encoder
    planes) carry a leading per-position T dim."""
    return tbl.x_max.ndim in (2, 3) and tbl.x_max.shape[0] == t_len


def _encode_rows(sym: torch.Tensor, rows, cap: int) -> EncodedLanes:
    """Encode ``(cells, n)`` symbols, one standalone stream per cell, with
    step ``t``'s table ``rows(t)`` (static ``(K,)`` or per-cell ``(cells,
    K)`` planes)."""
    st = encoder_init(sym.shape[0], cap, sym.device)
    sym = sym.to(_I64)
    for t in range(sym.shape[1] - 1, -1, -1):
        st = encode_put(st, sym[:, t], rows(t))
    st = encoder_flush(st)
    return EncodedLanes(buf=st.buf[:, :cap],
                        start=torch.clamp(st.ptr, min=0).to(_I32),
                        length=(cap - st.ptr).to(_I32), overflow=st.ptr < 0)


def encode(symbols: torch.Tensor, tbl: TableSet,
           cap: int | None = None) -> EncodedLanes:
    """Encode ``(lanes, T)`` symbols against static ``(K,)`` or
    per-position ``(T, K)`` / ``(T, lanes, K)`` tables."""
    t_len = symbols.shape[1]
    cap = default_cap(t_len) if cap is None else cap
    if is_per_position(tbl, t_len):
        return _encode_rows(symbols, lambda t: type(tbl)(*(a[t] for a in tbl)),
                            cap)
    return _encode_rows(symbols, lambda t: tbl, cap)


def encode_record_planes(symbols: torch.Tensor, tbl):
    """The records scan: push ``(lanes, T)`` symbols backward through
    :func:`update.encode_step` and stack its fixed-shape renorm records.

    ``tbl`` is a TableSet or its five encoder planes, static ``(K,)`` or
    per-position ``(T, K)`` / ``(T, lanes, K)``.  Returns ``(bytes, mask,
    s)``: ``(T, 2, lanes)`` uint8 planes, where every record's byte is the
    state's low byte whatever its mask, and the final states ``(lanes,)``
    as int64 values.
    """
    lanes, t_len = symbols.shape
    planes = update.encode_planes(tbl)
    per_position = is_per_position(planes, t_len)
    sym = symbols.to(_I64)
    dev = symbols.device
    s = torch.full((lanes,), C.RANS_L, dtype=_I64, device=dev)
    shape = (t_len, C.MAX_RENORM_STEPS, lanes)
    byts = torch.zeros(shape, dtype=torch.uint8, device=dev)
    mask = torch.zeros(shape, dtype=torch.uint8, device=dev)
    for t in range(t_len - 1, -1, -1):
        planes_t = (update.EncTables(*(a[t] for a in planes)) if per_position
                    else planes)
        s, recs = update.encode_step(
            s, update.gather_encode_entry(planes_t, sym[:, t]))
        byts[t] = torch.stack([b for b, _ in recs]).to(torch.uint8)
        mask[t] = torch.stack([c for _, c in recs]).to(torch.uint8)
    return byts, mask, s


def encode_records(symbols: torch.Tensor, tbl: TableSet,
                   cap: int | None = None) -> EncodedLanes:
    """Scatter-free encode: the records scan, then one vectorized
    :func:`~repro_torch.core.bitstream.compact_records` pass.  Byte-identical
    to :func:`encode` (same emission order, same overflow contract)."""
    cap = default_cap(symbols.shape[1]) if cap is None else cap
    return compact_records(*encode_record_planes(symbols, tbl), cap)


def num_chunks(n_symbols: int, chunk_size: int) -> int:
    """Chunk count covering ``n_symbols`` (last chunk may be ragged)."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    return -(-n_symbols // chunk_size)


def check_chunk_count(n_chunks: int, n_symbols: int, chunk_size: int) -> None:
    """Raise unless a stream of ``n_chunks`` chunks is what ``n_symbols`` at
    ``chunk_size`` encodes to."""
    n_total = num_chunks(n_symbols, chunk_size)
    if n_chunks != n_total:
        raise ValueError(
            f"stream has {n_chunks} chunks but n_symbols={n_symbols} at "
            f"chunk_size={chunk_size} implies {n_total}; decode with the "
            "chunk_size the stream was encoded with")


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
    chunk ``c``'s bytes equal :func:`encode` of its symbols alone.  The
    full chunks encode together as one batch of cells, the ragged tail as
    another, so a call takes ``chunk_size`` steps, not ``T``."""
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
    chunk = min(chunk_size, t_len)
    n_full, tail = divmod(t_len, chunk)
    parts = []
    for c0, g, n in ((0, n_full, chunk), (n_full, 1, tail)):
        if n == 0:
            continue
        t0 = c0 * chunk
        cells = symbols[:, t0:t0 + g * n].reshape(lanes, g, n)
        first = torch.arange(g, device=dev) * n + t0

        def rows(t, t0=t0, g=g, first=first):
            if not per_position:
                return tbl
            if g == 1:                       # one chunk: rows as they are
                return type(tbl)(*(a[t0 + t] for a in tbl))

            def cut(a):
                a = a[first + t]
                if a.ndim == 2:              # (g, K): one row per chunk
                    a = a[:, None].expand(g, lanes, a.shape[-1])
                return a.reshape(g * lanes, a.shape[-1])
            return type(tbl)(*(cut(a) for a in tbl))

        enc = _encode_rows(cells.transpose(0, 1).reshape(g * lanes, n), rows,
                           cap)
        parts.append([a.reshape((g, lanes) + a.shape[1:]) for a in enc])
    return ChunkedLanes(*(torch.cat(xs) for xs in zip(*parts)))


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


def _read_byte(buf, lane_idx, ptr, cap, limit=None):
    """Guarded forward byte read.  A read outside ``[0, cap)`` yields 0; a
    read before 0 or at or past the lane's read limit (``cap`` unless
    given: a container window passes its span end) is flagged."""
    flag = (ptr < 0) | (ptr >= (cap if limit is None else limit))
    inside = (ptr >= 0) & (ptr < cap)
    byte = buf[lane_idx, torch.clamp(ptr, 0, cap - 1)].to(_I64)
    return torch.where(inside, byte, torch.zeros_like(byte)), flag


def _read_header(buf, start, limit=None):
    """Each lane's 4-byte big-endian state header.  Returns ``(s, ptr,
    under)`` with ``under`` the count of flagged header reads."""
    lanes, cap = buf.shape
    lane_idx = torch.arange(lanes, device=buf.device)
    s = torch.zeros((lanes,), dtype=_I64, device=buf.device)
    ptr = start.to(_I64)
    under = torch.zeros((lanes,), dtype=_I64, device=buf.device)
    for _ in range(4):
        byte, flag = _read_byte(buf, lane_idx, ptr, cap, limit)
        under = under + flag.to(_I64)
        s = ((s << 8) | byte) & C.U32_MASK
        ptr = ptr + 1
    return s, ptr, under


def decoder_init(enc: EncodedLanes) -> DecState:
    """Read each lane's 4-byte big-endian state header."""
    s, ptr, under = _read_header(enc.buf, enc.start)
    return DecState(s=s, ptr=ptr, underflow=under > 0)


def pop(buf: torch.Tensor, s: torch.Tensor, ptr: torch.Tensor,
        freq: torch.Tensor, cdf: torch.Tensor, prob_bits: int = C.PROB_BITS,
        candidates: torch.Tensor | None = None, mu=None, delta=None,
        lut: torch.Tensor | None = None, limit=None):
    """Pop one symbol per lane from int64 states and cursors: CDF search
    (or the static LUT), state update, fixed 2-step masked refill.
    ``freq``/``cdf`` are ``(K,)`` shared or ``(lanes, K)`` rows; ``mu`` and
    ``delta`` a predictor bracket; ``limit`` per-lane read limits (default
    ``cap``).  Returns ``(s', ptr', symbol, probes, under)``; ``under``
    counts the lane's active refills that were flagged (each injects 0)."""
    lanes, cap = buf.shape
    lane_idx = torch.arange(lanes, device=buf.device)
    slot = s & ((1 << prob_bits) - 1)
    if lut is not None:
        x = lut[slot]
        probes = torch.ones((lanes,), dtype=_I64, device=buf.device)
    else:
        x, probes = search.find_symbol(cdf, freq.shape[-1], slot,
                                       candidates=candidates, mu=mu,
                                       delta=delta)
    f = take_gather(freq, x).to(_I64)
    start = take_gather(cdf, x).to(_I64)
    s = (f * (s >> prob_bits) + slot - start) & C.U32_MASK
    under = torch.zeros((lanes,), dtype=_I64, device=buf.device)
    for _ in range(C.MAX_RENORM_STEPS):
        cond = s < C.RANS_L
        byte, flag = _read_byte(buf, lane_idx, ptr, cap, limit)
        under = under + (cond & flag).to(_I64)
        s = torch.where(cond, ((s << C.RENORM_SHIFT) | byte) & C.U32_MASK, s)
        ptr = ptr + cond.to(_I64)
    return s, ptr, x, probes, under


def find_symbol(tbl, slot: torch.Tensor, mu=None, delta=None,
                candidates: torch.Tensor | None = None):
    """State-to-symbol inversion over ``tbl``'s CDF (``(K+1,)`` or
    ``(lanes, K+1)``) for ``slot`` ``(lanes,)``: :func:`repro_torch.core.
    search.find_symbol` with its predictor bracket and candidates.
    Returns int64 ``(symbol, probes)``, the Fig. 4(b) probe count."""
    return search.find_symbol(tbl.cdf, tbl.alphabet_size, slot.to(_I64),
                              candidates=candidates, mu=mu, delta=delta)


def decode_get(st: DecState, buf: torch.Tensor, tbl,
               prob_bits: int = C.PROB_BITS, mu=None, delta=None,
               candidates: torch.Tensor | None = None,
               lut: torch.Tensor | None = None):
    """Pop one symbol per lane.  ``tbl`` needs ``freq``/``cdf`` rows
    (``(K,)`` shared or ``(lanes, K)``).  Returns (state', symbol, probes)."""
    s, ptr, x, probes, n_under = pop(buf, st.s, st.ptr, tbl.freq, tbl.cdf,
                                     prob_bits, candidates, mu, delta, lut)
    under = n_under > 0
    if st.underflow is not None:
        under = under | st.underflow
    return DecState(s, ptr, under), x, probes


def slice_tables(tbl, t0: int, t1: int):
    """Per-position table rows for the position range ``[t0, t1)``."""
    return type(tbl)(*(a[t0:t1] for a in tbl))


def chunk_tables(tbl, n_full: int, chunk_size: int):
    """Per-position tables -> chunk-major ``(n_full, chunk_size, ...)``."""
    return type(tbl)(*(a[:n_full * chunk_size].reshape(
        (n_full, chunk_size) + a.shape[1:]) for a in tbl))


def table_layout(freq: torch.Tensor, t_len: int, lanes: int) -> str:
    """"static" ``(K,)``, "perpos" ``(T, K)`` or "lane" ``(T, lanes, K)``."""
    if freq.ndim == 1:
        return "static"
    if freq.ndim == 2 and freq.shape[0] == t_len:
        return "perpos"
    if freq.ndim == 3 and tuple(freq.shape[:2]) == (t_len, lanes):
        return "lane"
    raise ValueError(
        f"decode tables must be (K,), (T, K) or (T, lanes, K) with T="
        f"{t_len}, lanes={lanes}; got {tuple(freq.shape)}")


def _decode_cells(buf, start, limit, n: int, rows, prob_bits: int,
                  predictor, lut):
    """Decode ``n`` symbols from every one of ``cells`` standalone streams
    in lockstep.  ``buf`` ``(cells, cap)``; ``rows(t)`` gives step ``t``'s
    ``(freq, cdf, candidates)``.  Returns int64 ``symbols (cells, n)``,
    ``probes (cells,)`` and ``under (cells,)`` (flagged reads)."""
    cells = buf.shape[0]
    s, ptr, under = _read_header(buf, start, limit)
    ctx = None if predictor is None else predictor.init(cells, buf.device)
    sym = torch.empty((n, cells), dtype=_I64, device=buf.device)
    probes = torch.zeros((cells,), dtype=_I64, device=buf.device)
    for t in range(n):
        freq, cdf, cands = rows(t)
        mu = delta = None
        if predictor is not None:
            pred = predictor.predict(ctx)
            mu, delta = pred.mu, pred.delta
            if cands is None:
                cands = pred.candidates
        s, ptr, x, p, u = pop(buf, s, ptr, freq, cdf, prob_bits, cands, mu,
                              delta, lut, limit)
        if predictor is not None:
            ctx = predictor.update(ctx, x)
        sym[t] = x
        probes += p
        under += u
    return sym.T, probes, under


def decode_grid(buf: torch.Tensor, start: torch.Tensor, t_len: int,
                chunk_size: int, tbl, prob_bits: int = C.PROB_BITS,
                predictor=None, candidates: torch.Tensor | None = None,
                lut: torch.Tensor | None = None, limit=None):
    """Decode every (chunk, lane) cell of ``buf (n_chunks, lanes, cap)``:
    the full-stream decode kernel's arithmetic in plain PyTorch.

    Each cell is a standalone stream read from ``start[c, l]``: state,
    cursor, probe count and predictor context reset per chunk.  ``tbl``
    has ``freq``/``cdf`` in the static, per-position or per-lane layout;
    ``candidates`` is an optional ``(T, lanes, topk)`` plane; ``limit`` an
    optional ``(n_chunks, lanes)`` read limit (default ``cap``).  The full
    chunks decode together as one batch of cells, the ragged tail as
    another.  Returns int64 ``symbols (lanes, T)``, ``probes (n_chunks,
    lanes)`` and ``under (n_chunks, lanes)`` (flagged header reads and
    active refills).  Callers pass ``t_len > 0`` and a chunk count checked
    by :func:`check_chunk_count`.
    """
    n_chunks, lanes, cap = buf.shape
    chunk = min(chunk_size, t_len)
    layout = table_layout(tbl.freq, t_len, lanes)
    if candidates is not None and candidates.shape[-1] == 0:
        candidates = None
    if candidates is not None and tuple(candidates.shape[:2]) != (t_len,
                                                                  lanes):
        raise ValueError(
            f"candidate planes must be (T, lanes, topk)=({t_len}, {lanes}, "
            f"*); got {tuple(candidates.shape)}")
    dev = buf.device
    if limit is None:
        limit = torch.full((n_chunks, lanes), cap, dtype=_I64, device=dev)
    sym = torch.empty((lanes, t_len), dtype=_I64, device=dev)
    probes = torch.empty((n_chunks, lanes), dtype=_I64, device=dev)
    under = torch.empty_like(probes)
    n_full, tail = divmod(t_len, chunk)
    for c0, g, n in ((0, n_full, chunk), (n_full, n_chunks - n_full, tail)):
        if g == 0 or n == 0:
            continue
        cells = g * lanes
        first = torch.arange(c0, c0 + g, device=dev) * chunk

        def rows(t, c0=c0, g=g, first=first, cells=cells):
            if g == 1:                       # one chunk: rows as they are
                p = c0 * chunk + t
                return (tbl.freq if layout == "static" else tbl.freq[p],
                        tbl.cdf if layout == "static" else tbl.cdf[p],
                        None if candidates is None else candidates[p])
            pos = first + t

            def cut(a):
                if layout == "static":
                    return a
                a = a[pos]
                if layout == "perpos":
                    a = a[:, None].expand(g, lanes, a.shape[-1])
                return a.reshape(cells, a.shape[-1])
            return (cut(tbl.freq), cut(tbl.cdf),
                    None if candidates is None
                    else candidates[pos].reshape(cells, -1))

        s, p, u = _decode_cells(
            buf[c0:c0 + g].reshape(cells, cap),
            start[c0:c0 + g].reshape(cells),
            limit[c0:c0 + g].reshape(cells), n, rows, prob_bits, predictor,
            lut)
        sym[:, c0 * chunk:c0 * chunk + g * n] = (
            s.reshape(g, lanes, n).permute(1, 0, 2).reshape(lanes, g * n))
        probes[c0:c0 + g] = p.reshape(g, lanes)
        under[c0:c0 + g] = u.reshape(g, lanes)
    return sym, probes, under


def _decode_lut(tbl, layout: str, candidates, prob_bits: int, use_lut: bool):
    if not use_lut:
        return None
    if layout != "static":
        raise ValueError("the LUT path requires a static (K,) table")
    if candidates is not None and candidates.shape[-1] > 0:
        raise ValueError("use_lut and candidate planes are exclusive: the "
                         "LUT already inverts in one probe")
    return spc.decode_lut(tbl, prob_bits)


def no_symbols(lanes: int, device, lane_probes: bool = False,
               chunk_probes: bool = False, exhausted_flags: bool = False,
               n_chunks: int | None = None):
    """The result of a decode of zero symbols: ``(symbols (lanes, 0),
    avg 0[, per-lane probes][, per-chunk probes][, exhausted flags])``;
    the probe and flag planes are ``(n_chunks, lanes)`` when ``n_chunks`` is
    given, else ``(lanes,)``."""
    cells = (lanes,) if n_chunks is None else (n_chunks, lanes)
    out = (torch.zeros((lanes, 0), dtype=torch.int32, device=device),
           torch.zeros((), dtype=torch.float32, device=device))
    if lane_probes:
        out = out + (torch.zeros((lanes,), dtype=_I64, device=device),)
    if chunk_probes:
        out = out + (torch.zeros(cells, dtype=torch.int32, device=device),)
    if exhausted_flags:
        out = out + (torch.zeros(cells, dtype=torch.bool, device=device),)
    return out


def _avg(probes: torch.Tensor, lanes: int, n_symbols: int) -> torch.Tensor:
    return probes.sum().to(torch.float32) / max(lanes * n_symbols, 1)


def decode(enc: EncodedLanes, n_symbols: int, tbl,
           prob_bits: int = C.PROB_BITS, predictor=None,
           use_lut: bool = False, lane_probes: bool = False,
           candidates: torch.Tensor | None = None,
           return_exhausted: bool = False):
    """Decode ``n_symbols`` per lane against static ``(K,)`` or
    per-position ``(T, K)`` / ``(T, lanes, K)`` tables.

    ``predictor`` (a :mod:`repro_torch.core.predictors` config) drives the
    window-gated search; ``use_lut`` inverts a static table in one probe
    (ignored with a predictor, as in the reference); ``candidates`` is an
    optional ``(T, lanes, topk)`` plane.  Returns ``(symbols (lanes, T)
    int32, avg_probes[, per-lane probes])`` and raises
    :class:`StreamExhaustedError` on a read past a lane's stream, unless
    ``return_exhausted`` appends the per-lane flag instead.
    """
    lanes = enc.buf.shape[0]
    dev = enc.buf.device
    if n_symbols == 0:
        _, _, under = _read_header(enc.buf, enc.start)
        sym = torch.zeros((lanes, 0), dtype=torch.int32, device=dev)
        probes = torch.zeros((lanes,), dtype=_I64, device=dev)
    else:
        layout = table_layout(tbl.freq, n_symbols, lanes)
        lut = _decode_lut(tbl, layout, candidates, prob_bits, use_lut)
        sym, probes, under = decode_grid(
            enc.buf[None], enc.start[None], n_symbols, n_symbols, tbl,
            prob_bits, predictor, candidates,
            lut if predictor is None else None)
        sym, probes, under = sym.to(torch.int32), probes[0], under[0]
    out = (sym, _avg(probes, lanes, n_symbols))
    if lane_probes:
        out = out + (probes,)
    if return_exhausted:
        return out + (under > 0,)
    _check_exhausted(under > 0)
    return out


def decode_chunked(chunks: ChunkedLanes, n_symbols: int, tbl,
                   chunk_size: int, prob_bits: int = C.PROB_BITS,
                   use_lut: bool = False, predictor=None,
                   lane_probes: bool = False,
                   candidates: torch.Tensor | None = None):
    """Decode a chunked stream (bit-exact inverse of :func:`encode_chunked`);
    the predictor context resets at every chunk.  Returns ``(symbols
    (lanes, T) int32, avg_probes[, per-lane probes])``; raises
    :class:`StreamExhaustedError` on a read past a stream."""
    check_chunk_count(chunks.buf.shape[0], n_symbols, chunk_size)
    lanes = chunks.buf.shape[1]
    if n_symbols == 0:
        return no_symbols(lanes, chunks.buf.device, lane_probes)
    layout = table_layout(tbl.freq, n_symbols, lanes)
    lut = _decode_lut(tbl, layout, candidates, prob_bits, use_lut)
    sym, probes, under = decode_grid(
        chunks.buf, chunks.start, n_symbols, chunk_size, tbl, prob_bits,
        predictor, candidates, lut if predictor is None else None)
    _check_exhausted((under > 0).any(0), "decode_chunked")
    per_lane = probes.sum(0)
    out = (sym.to(torch.int32), _avg(per_lane, lanes, n_symbols))
    if lane_probes:
        out = out + (per_lane,)
    return out
