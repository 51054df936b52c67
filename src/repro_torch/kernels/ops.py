"""Public wrappers around the port's kernels.

``rans_encode`` / ``rans_encode_chunked`` wrap the encode kernel (B1) and
return packed ``EncodedLanes`` / ``ChunkedLanes``, byte-identical to the
pure-torch ``core.coder.encode[_chunked]``; the chunked encode is one
launch for the whole stream.  ``rans_decode`` / ``rans_decode_chunked``
wrap the full-stream decode kernel (B3): static and adaptive tables, the
predictors and ``(T, lanes, topk)`` candidate planes, one launch for the
whole stream with the chunk axis in the grid.  ``rans_decode_chunked(
from_container=...)`` decodes straight off a validated container's payload
slab (B4).  ``rans_decode_step`` (B2) is the fused serve decode's
per-position pop; ``rans_decode_step_rows`` is the batching engine's pop
over its ``slots x lanes`` rows, through B2 or the coder.  Symbols and
per-lane probe counters equal the coder's.
``rans_encode_records`` (B5) is the records reference encode: fixed-shape
renorm record planes that the re-exported ``compact_records`` turns into
the same streams as B1.  ``spc_quantize_tables`` is the kernel-backed SPC:
B6 quantizes a ``(B, K)`` probability batch, then ``build_tables`` adds the
CDF and Barrett planes.  Each wrapper runs its kernel for CUDA tensors and
the kernel's plain version for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import coder, u32
from repro_torch.core import constants as C
from repro_torch.core.bitstream import (ChunkedLanes, ContainerSlab,
                                        EncodedLanes,
                                        compact_records)  # noqa: F401
from repro_torch.core.spc import TableSet, build_tables
from repro_torch.core.coder import (_check_exhausted, check_chunk_count,
                                    default_cap, no_symbols, num_chunks)
from repro_torch.kernels.rans_decode import (rans_decode_lanes,
                                             rans_decode_slab,
                                             rans_decode_step)  # noqa: F401
from repro_torch.kernels.rans_encode import (rans_encode_lanes,
                                             rans_encode_records)  # noqa: F401
from repro_torch.kernels.spc_quantize import spc_quantize

__all__ = ["rans_encode", "rans_encode_chunked", "rans_encode_records",
           "compact_records", "rans_decode", "rans_decode_chunked",
           "rans_decode_step", "rans_decode_step_rows", "slab_planes",
           "spc_quantize_tables"]


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


def rans_decode(enc: EncodedLanes, n_symbols: int, tbl,
                prob_bits: int = C.PROB_BITS, predictor=None,
                candidates: torch.Tensor | None = None,
                lane_probes: bool = False, exhausted_flags: bool = False):
    """Kernel-backed monolithic decode (B3); returns ``(symbols (lanes, T),
    avg probes/symbol[, per-lane probes])``.

    ``predictor`` is a :mod:`repro_torch.core.predictors` config;
    ``candidates`` an optional ``(T, lanes, topk)`` plane.  A read past a
    lane's stream raises :class:`~repro_torch.core.coder.StreamExhaustedError`,
    unless ``exhausted_flags`` appends the per-lane flag instead.
    """
    lanes = enc.buf.shape[0]
    if n_symbols == 0:
        return no_symbols(lanes, enc.buf.device, lane_probes,
                          exhausted_flags=exhausted_flags)
    sym, probes, under = rans_decode_lanes(
        enc.buf, enc.start, tbl.freq, tbl.cdf, n_symbols,
        prob_bits=prob_bits, predictor=predictor, candidates=candidates)
    probes = probes[0].to(torch.int64)
    under = under[0] > 0
    out = (sym, probes.sum().to(torch.float32) / (lanes * n_symbols))
    if lane_probes:
        out = out + (probes,)
    if exhausted_flags:
        return out + (under,)
    _check_exhausted(under, "rans_decode")
    return out


def slab_planes(cs: ContainerSlab, device):
    """A validated :class:`ContainerSlab` -> B4's inputs on ``device``:
    ``(slab, base, wstart, wlen)`` and the window size ``cap``.

    ``cap = max(cs.cap, 4)`` (the header read always has columns); the
    payload is zero-padded to at least ``cap`` bytes; ``base = clip(offset,
    0, S - cap)`` keeps every window inside the slab and ``wstart = offset -
    base`` re-bases each span into its window.
    """
    if cs.slab.shape[0] >= 2 ** 31:
        raise ValueError(
            f"container payload of {cs.slab.shape[0]} bytes exceeds the "
            "int32 index range of the device slab paths")
    cap = max(cs.cap, 4)
    slab = np.asarray(cs.slab, np.uint8)
    if slab.shape[0] < cap:
        slab = np.concatenate([slab, np.zeros(cap - slab.shape[0], np.uint8)])
    base = np.clip(cs.offset, 0, slab.shape[0] - cap).astype(np.int32)
    wstart = (cs.offset - base).astype(np.int32)
    wlen = cs.length.astype(np.int32)
    planes = tuple(torch.as_tensor(np.array(a), device=device)
                   for a in (slab, base, wstart, wlen))
    return planes, cap


def rans_decode_chunked(chunks: ChunkedLanes | None = None,
                        n_symbols: int | None = None, tbl=None,
                        chunk_size: int | None = None,
                        prob_bits: int = C.PROB_BITS, predictor=None,
                        candidates: torch.Tensor | None = None,
                        lane_probes: bool = False, chunk_probes: bool = False,
                        exhausted_flags: bool = False,
                        from_container: ContainerSlab | None = None):
    """Kernel-backed chunked decode: one launch for the whole stream.

    Every (chunk, lane) cell is a standalone stream: the kernel re-reads
    its state header and resets cursor, probes and predictor context per
    chunk.  Pass a dense :class:`ChunkedLanes` (B3) or
    ``from_container=`` a validated :class:`ContainerSlab` (B4, decoding
    straight off the payload on the tables' device; ``n_symbols`` and
    ``chunk_size`` default to the container's).  Returns ``(symbols
    (lanes, T), avg_probes[, per-lane probes][, per-(chunk, lane) probes])``
    and raises :class:`~repro_torch.core.coder.StreamExhaustedError` unless
    ``exhausted_flags`` appends the ``(n_chunks, lanes)`` flags.
    """
    if from_container is not None:
        if chunks is not None:
            raise ValueError(
                "pass either a dense ChunkedLanes stream or "
                "from_container=<ContainerSlab>, not both")
        cs = from_container
        n_symbols = cs.meta.n_symbols if n_symbols is None else n_symbols
        chunk_size = (cs.meta.chunk_size if chunk_size is None
                      else chunk_size)
        n_chunks, lanes = cs.offset.shape
        device = tbl.freq.device
    else:
        if chunks is None:
            raise ValueError("a ChunkedLanes stream or from_container=... "
                             "is required")
        n_chunks, lanes = chunks.buf.shape[:2]
        device = chunks.buf.device
    if n_symbols == 0:                   # the kernel wrappers check t > 0
        check_chunk_count(n_chunks, 0, chunk_size)
        return no_symbols(lanes, device, lane_probes, chunk_probes,
                          exhausted_flags, n_chunks=0)
    if from_container is not None:
        (slab, base, wstart, wlen), cap = slab_planes(cs, device)
        sym, cprobes, cunder = rans_decode_slab(
            slab, base, wstart, wlen, tbl.freq, tbl.cdf, cap=cap,
            t_len=n_symbols, chunk_size=chunk_size, prob_bits=prob_bits,
            predictor=predictor, candidates=candidates)
    else:
        sym, cprobes, cunder = rans_decode_lanes(
            chunks.buf, chunks.start, tbl.freq, tbl.cdf, n_symbols,
            chunk_size, prob_bits=prob_bits, predictor=predictor,
            candidates=candidates)
    per_lane = cprobes.sum(0)
    out = (sym, per_lane.sum().to(torch.float32) / (lanes * n_symbols))
    if lane_probes:
        out = out + (per_lane,)
    if chunk_probes:
        out = out + (cprobes,)
    if exhausted_flags:
        return out + (cunder > 0,)
    _check_exhausted(cunder > 0, "rans_decode_chunked")
    return out


def rans_decode_step_rows(buf: torch.Tensor, s: torch.Tensor,
                          ptr: torch.Tensor, tbl,
                          prob_bits: int = C.PROB_BITS,
                          candidates: torch.Tensor | None = None,
                          backend: str = "kernel"):
    """One rANS pop across the batching engine's flattened ``slots x
    lanes`` rows: every row owns a byte stream (one row of ``buf``), its
    coder state and its candidate row, so the per-step kernel that serves
    one request's lanes serves the whole slot batch unchanged.

    ``buf`` is ``(rows, cap)`` uint8, row-major: B2 reads each row's
    window as one contiguous run, so this takes the layout B2 takes (the
    reference transposes to ``(cap, rows)`` once for its TPU kernel's
    lane-minor blocks).  ``s`` holds the uint32 states as int32 bit
    patterns and ``ptr`` int32 cursors (B2's convention); ``tbl`` has
    ``(rows, K)`` ``freq`` and ``(rows, K+1)`` ``cdf``; ``candidates`` an
    optional ``(rows, topk)`` plane.  ``backend="kernel"`` pops with B2
    (:func:`rans_decode_step`), ``"coder"`` with the pure-torch
    ``coder.decode_get``: symbols, probes and flags are identical.
    Returns ``(s', ptr', symbols, probes, under)``, all ``(rows,)`` int32,
    ``under`` 0/1 (this step read past the row's stream) on both
    backends."""
    if backend == "kernel":
        s2, ptr2, sym, probes, under = rans_decode_step(
            buf, s, ptr, tbl.freq, tbl.cdf, prob_bits=prob_bits,
            candidates=candidates)
        return s2, ptr2, sym, probes, (under > 0).to(torch.int32)
    if backend != "coder":
        raise ValueError(f"unknown step backend {backend!r}")
    st, sym, probes = coder.decode_get(
        coder.DecState(u32.value(s), ptr.to(torch.int64)), buf, tbl,
        prob_bits, candidates=candidates)
    i32 = torch.int32
    return (u32.bits(st.s), st.ptr.to(i32), sym.to(i32), probes.to(i32),
            st.underflow.to(i32))


def spc_quantize_tables(probs: torch.Tensor,
                        prob_bits: int = C.PROB_BITS) -> TableSet:
    """Kernel-backed SPC: ``(B, K)`` probabilities -> a full TableSet (B6,
    then :func:`~repro_torch.core.spc.build_tables`); equal to
    ``spc.tables_from_probs`` on every plane."""
    return build_tables(spc_quantize(probs, prob_bits), prob_bits)
