"""Chunk x lane placement of the chunked rANS codec over ranks.

Port of ``repro.parallel.chunked``.  The chunked streams of
``core.coder.encode_chunked`` are independent by construction (every chunk
has its own flush), so the chunk axis is an embarrassingly parallel axis:
:func:`encode_chunked` and :func:`decode_chunked` place the full chunks of
a ``(n_chunks, lanes, cap)`` stream on a ``("chunks",)`` mesh.  Each rank
runs the single-device program over its chunk slab (:func:`encode_slab`,
:func:`decode_slab`: functions of ``(rank, size)`` alone, so two ranks'
programs can also run in turn on one card and be stitched), then every
rank gathers every slab.  The ragged tail chunk, when present, is coded by
every rank itself, which needs no collective.

Fallback contract (the reference's): a ``None`` mesh, a mesh of another
axis, or a chunk count the mesh does not divide takes the single-device
program, with the same bytes and symbols.  A mesh of size 1 takes the
placed path.

:func:`lane_mesh` is the ``("lanes",)`` mesh of the sequential row-parallel
programs (the fused serve decode of ``serve.compress`` and the batching
engine): those are sequential over positions, so their parallel axis is
the lane, routed by :func:`lane_mesh_usable`.

Errors raise on every rank alike: exhaustion is decided on the gathered
flags, and refusals on arguments every rank shares, so no rank is left
waiting in a collective.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitstream, coder, constants as C
from repro_torch.core.bitstream import ChunkedLanes, ContainerSlab
from repro_torch.kernels import ops
from repro_torch.parallel import Mesh, gather, make_mesh

__all__ = ["chunk_mesh", "lane_mesh", "lane_mesh_usable", "encode_chunked",
           "decode_chunked", "encode_slab", "decode_slab"]

_BACKENDS = ("coder", "kernel")


def chunk_mesh(group=None, device=None) -> Mesh:
    """1-D ``("chunks",)`` mesh over ``group`` (default: the world)."""
    return make_mesh("chunks", group, device)


def lane_mesh(group=None, device=None) -> Mesh:
    """1-D ``("lanes",)`` mesh over ``group`` (default: the world): the
    placement axis of the fused serve decode and the batching engine.
    Each lane owns a private byte stream, rANS state and model row, so a
    rank runs the whole sequential program over its lane slab; lane counts
    the mesh does not divide take the single-device program."""
    return make_mesh("lanes", group, device)


def _usable(mesh: Mesh | None, n_full: int) -> bool:
    return (mesh is not None and mesh.axis == "chunks"
            and n_full > 0 and n_full % mesh.size == 0)


def lane_mesh_usable(mesh: Mesh | None, rows: int,
                     what: str = "fused serve decode") -> bool:
    """Route a ``("lanes",)`` mesh for an independent row axis: True places
    ``rows`` rows on the mesh, False takes the single-device program (no
    mesh, or a row count the mesh does not divide).  A mesh without a
    ``"lanes"`` axis raises: chunk meshes place the two-pass kernel
    replay."""
    if mesh is None:
        return False
    if mesh.axis != "lanes":
        raise ValueError(
            f"the {what} parallelizes over the lane axis: pass a "
            '("lanes",) mesh (parallel.chunked.lane_mesh).  Chunk meshes '
            "place the two-pass kernel replay — use backend='two_pass' "
            "with a ('chunks',) mesh instead")
    return rows > 0 and rows % mesh.size == 0


def _check_backend(backend: str, what: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown {what} backend {backend!r}")


def _slab_tables(tbl, per_position: bool, t0: int, t1: int):
    """Rows ``[t0, t1)`` of per-position tables; a static table whole.
    (Decode tables are per-position when ``freq`` has a leading T axis,
    ``(T, K)`` or ``(T, lanes, K)``; ``table_layout`` checks its length.)"""
    return coder.slice_tables(tbl, t0, t1) if per_position else tbl


def encode_slab(symbols: torch.Tensor, tbl, chunk_size: int, rank: int,
                size: int, cap: int | None = None,
                backend: str = "coder") -> ChunkedLanes:
    """Rank ``rank`` of ``size``'s program: its slab of the full chunks of
    ``symbols (lanes, T)``, per-position tables cut chunk-major with it.
    ``backend="kernel"`` is one encode-kernel launch over the whole slab
    (its chunk grid), ``"coder"`` the lane coder on the slab."""
    _check_backend(backend, "encode")
    t_len = symbols.shape[1]
    cap = coder.default_cap(min(chunk_size, t_len)) if cap is None else cap
    n_full = t_len // chunk_size
    c0, c1 = rank * n_full // size, (rank + 1) * n_full // size
    t0, t1 = c0 * chunk_size, c1 * chunk_size
    tb = _slab_tables(tbl, coder.is_per_position(tbl, t_len), t0, t1)
    sym = symbols[:, t0:t1]
    if backend == "kernel":
        return ops.rans_encode_chunked(sym, tb, chunk_size, cap=cap)
    return coder.encode_chunked(sym, tb, chunk_size, cap=cap)


def encode_chunked(symbols: torch.Tensor, tbl, chunk_size: int,
                   mesh: Mesh | None = None, cap: int | None = None,
                   backend: str = "coder") -> ChunkedLanes:
    """Chunked encode with the full chunks placed over ``mesh``'s ranks.

    Each rank encodes its chunk slab (:func:`encode_slab`), every rank
    gathers the ``(n_chunks, lanes, cap)`` planes and overflow flags, and
    codes the ragged tail itself.  The streams and flags are byte-identical
    across backends and mesh sizes; without a usable mesh this is
    ``ops.rans_encode_chunked`` (``kernel``) or ``coder.encode_chunked``.
    """
    _check_backend(backend, "encode")
    lanes, t_len = symbols.shape
    coder.num_chunks(t_len, chunk_size)     # validates chunk_size > 0
    n_full, tail_len = divmod(t_len, chunk_size)
    cap = coder.default_cap(min(chunk_size, t_len)) if cap is None else cap
    if not _usable(mesh, n_full):
        if backend == "kernel":
            return ops.rans_encode_chunked(symbols, tbl, chunk_size, cap=cap)
        return coder.encode_chunked(symbols, tbl, chunk_size, cap=cap)
    dev = mesh.device
    symbols = symbols.to(dev)
    tbl = type(tbl)(*(a.to(dev) for a in tbl))
    loc = encode_slab(symbols, tbl, chunk_size, mesh.rank, mesh.size, cap,
                      backend)
    enc = [gather(mesh, a, 0) for a in loc]
    if tail_len:
        t0 = n_full * chunk_size
        tb = _slab_tables(tbl, coder.is_per_position(tbl, t_len), t0, t_len)
        sym = symbols[:, t0:]
        tail = (ops.rans_encode(sym, tb, cap=cap) if backend == "kernel"
                else coder.encode(sym, tb, cap=cap))
        enc = [torch.cat([a, b[None]]) for a, b in zip(enc, tail)]
    return ChunkedLanes(*enc)


def decode_slab(chunks: ChunkedLanes, n_symbols: int, tbl, chunk_size: int,
                rank: int, size: int, prob_bits: int = C.PROB_BITS,
                use_lut: bool = False, predictor=None,
                backend: str = "coder",
                candidates: torch.Tensor | None = None):
    """Rank ``rank`` of ``size``'s program: decode its slab of the full
    chunks of the dense stream ``chunks``, with the slab's per-position
    table rows and ``(T, lanes, topk)`` candidate rows.  ``backend=
    "kernel"`` is one full-stream decode launch over the slab (B3's chunk
    grid).  Returns ``symbols (lanes, n_loc * chunk_size)`` int32 and the
    slab's per-(chunk, lane) probe counts (int64) and exhaustion flags; it
    never raises on exhaustion."""
    _check_backend(backend, "decode")
    lanes = chunks.buf.shape[1]
    n_full = n_symbols // chunk_size
    c0, c1 = rank * n_full // size, (rank + 1) * n_full // size
    t0, t1 = c0 * chunk_size, c1 * chunk_size
    tb = _slab_tables(tbl, tbl.freq.ndim > 1, t0, t1)
    cand = None if candidates is None else candidates[t0:t1]
    sub = ChunkedLanes(*(a[c0:c1] for a in chunks[:3]))
    if backend == "kernel":
        sym, _, cprobes, cunder = ops.rans_decode_chunked(
            sub, t1 - t0, tb, chunk_size, prob_bits=prob_bits,
            predictor=predictor, candidates=cand, chunk_probes=True,
            exhausted_flags=True)
        return sym.to(torch.int32), cprobes.to(torch.int64), cunder
    lut = coder._decode_lut(tb, coder.table_layout(tb.freq, t1 - t0, lanes),
                            cand, prob_bits, use_lut)
    sym, cprobes, cunder = coder.decode_grid(
        sub.buf, sub.start, t1 - t0, chunk_size, tb, prob_bits, predictor,
        cand, lut if predictor is None else None)
    return sym.to(torch.int32), cprobes, cunder > 0


def decode_chunked(chunks: ChunkedLanes | ContainerSlab, n_symbols: int,
                   tbl, chunk_size: int, mesh: Mesh | None = None,
                   prob_bits: int = C.PROB_BITS, use_lut: bool = False,
                   predictor=None, backend: str = "coder",
                   candidates: torch.Tensor | None = None,
                   lane_probes: bool = False):
    """Chunked decode with the full chunks placed over ``mesh``'s ranks.

    Each rank decodes its chunk slab (:func:`decode_slab`) with its
    chunk-major table and candidate rows; every rank gathers the symbols,
    the per-(chunk, lane) probe counts and the exhaustion flags, raises
    :class:`~repro_torch.core.coder.StreamExhaustedError` on the gathered
    flags (so every rank raises alike), then decodes the ragged tail
    itself.  ``chunks`` may be a :class:`ContainerSlab`: the placed path
    rebuilds the dense chunks on the device (``slab_to_chunked``), the
    single-device ``kernel`` path decodes straight off the payload (B4).
    Symbols and probe counts are identical across backends and mesh sizes.
    Returns ``(symbols (lanes, T) int32, avg_probes[, per-lane probes])``.
    """
    _check_backend(backend, "decode")
    slab_in = isinstance(chunks, ContainerSlab)
    n_have, lanes = (chunks.offset.shape if slab_in
                     else chunks.buf.shape[:2])
    coder.check_chunk_count(n_have, n_symbols, chunk_size)
    n_full, tail_len = divmod(n_symbols, chunk_size)
    if candidates is not None and candidates.shape[-1] == 0:
        candidates = None
    if candidates is not None:
        if tuple(candidates.shape[:2]) != (n_symbols, lanes):
            raise ValueError(
                f"candidate planes must be (T, lanes, topk)=({n_symbols}, "
                f"{lanes}, *); got {tuple(candidates.shape)}")
        candidates = candidates.to(torch.int32)
    if not _usable(mesh, n_full):
        if backend == "kernel":
            if slab_in:
                return ops.rans_decode_chunked(
                    n_symbols=n_symbols, tbl=tbl, chunk_size=chunk_size,
                    prob_bits=prob_bits, predictor=predictor,
                    candidates=candidates, lane_probes=lane_probes,
                    from_container=chunks)
            return ops.rans_decode_chunked(
                chunks, n_symbols, tbl, chunk_size, prob_bits=prob_bits,
                predictor=predictor, candidates=candidates,
                lane_probes=lane_probes)
        if slab_in:
            chunks = bitstream.slab_to_chunked(chunks, tbl.freq.device)
        return coder.decode_chunked(chunks, n_symbols, tbl, chunk_size,
                                    prob_bits=prob_bits, use_lut=use_lut,
                                    predictor=predictor,
                                    lane_probes=lane_probes,
                                    candidates=candidates)
    dev = mesh.device
    if slab_in:
        chunks = bitstream.slab_to_chunked(chunks, dev)
    chunks = ChunkedLanes(*(a.to(dev) for a in chunks[:3]))
    tbl = type(tbl)(*(a.to(dev) for a in tbl))
    if candidates is not None:
        candidates = candidates.to(dev)
    sym, cprobes, cunder = decode_slab(
        chunks, n_symbols, tbl, chunk_size, mesh.rank, mesh.size, prob_bits,
        use_lut, predictor, backend, candidates)
    sym = gather(mesh, sym, 1)
    cprobes = gather(mesh, cprobes, 0)
    cunder = gather(mesh, cunder, 0)
    coder._check_exhausted(cunder, "parallel.decode_chunked")
    per_lane = cprobes.sum(0)
    if tail_len:
        t0 = n_full * chunk_size
        enc = coder.chunk_encoded(chunks, n_full)
        tb = _slab_tables(tbl, tbl.freq.ndim > 1, t0, n_symbols)
        cand = None if candidates is None else candidates[t0:]
        if backend == "kernel":
            s_tail, _, p_tail = ops.rans_decode(
                enc, tail_len, tb, prob_bits=prob_bits, predictor=predictor,
                candidates=cand, lane_probes=True)
        else:
            s_tail, _, p_tail = coder.decode(
                enc, tail_len, tb, prob_bits, predictor=predictor,
                use_lut=use_lut, lane_probes=True, candidates=cand)
        sym = torch.cat([sym, s_tail.to(torch.int32)], 1)
        per_lane = per_lane + p_tail.to(torch.int64)
    out = (sym, per_lane.sum().to(torch.float32) / (lanes * n_symbols))
    return out + (per_lane,) if lane_probes else out
