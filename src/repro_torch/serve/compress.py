"""Lossless compression end to end: the LM path (the paper's Fig. 1/2)
and the static-table image path (Fig. 3 / Fig. 4(b)).

Port of ``repro.serve.compress``:

  compress    — a teacher-forced per-step ``decode_step`` scan prices every
                (position, lane); the SPC quantizes each distribution; the
                multi-lane encoder writes the streams.  With
                ``backend="kernel"`` the scan keeps every step's BF16
                probabilities, the SPC kernel quantizes all of them in one
                launch and the encode kernel writes the whole stream in
                one launch.
  decompress  — the same per-step scan, except each step's symbol comes
                out of the rANS decoder and is fed back into the model.
                ``backend="kernel"`` is the fused serve decode: every step
                runs the model, the SPC kernel (frequencies and CDF in one
                launch), the model top-k and one pop per lane with the
                decode-step kernel.
                ``backend="coder"`` pops with the pure-torch coder and
                quantizes with the plain SPC on both sides.
                ``backend="two_pass"`` is the differential reference: pass
                1 runs the coder scan and keeps every step's tables and
                top-k candidates, pass 2 re-decodes the whole stream in one
                launch of the full-stream decode kernel (straight off the
                payload slab when given a ``ContainerSlab``); its symbols
                and probes come from pass 2 only.
  histogram   — static-table rANS with an empirical histogram, decoded by
                the full-stream kernel with an optional predictor (the
                paper's image workload).

Both directions run the identical ``decode_step`` at the identical row
count, so the tables that price a stream are bit-for-bit the tables that
decode it.  Chunking changes only the coder framing: the model state and
the fed-back token carry across chunk boundaries, the coder state
re-initializes per chunk.

Placement (``mesh=``, :mod:`repro_torch.parallel`): on a ``("lanes",)``
mesh each rank prices, encodes or decodes its slab of the lanes as its
own model call and every rank gathers the whole result; on a
``("chunks",)`` mesh ``lm_compress_chunked`` encodes through
``parallel.encode_chunked`` and ``two_pass`` places pass 2 through
``parallel.decode_chunked``.  A container priced on a lane mesh of ``n``
ranks decodes bit-exactly on a lane mesh of ``n`` ranks; where a slab's
rows price as they do inside the whole batch, its bytes are the unplaced
container's.  Every rank calls with the same arguments.

A ``dense``, ``moe``, ``ssm`` or ``hybrid`` model placed for compute
(``parallel/sharding.place_model``) goes through every entry point as it
is, every backend and two-pass included: each step runs the rank's slab
of the lanes (``Placement.rows``: over the batch axes that divide them,
whole on the ranks of the rest) on its heads, channels, columns, experts
and shard of the state (the recurrent leaves carried across chunks on the
rank's shards); its logits are gathered into whole rows of every lane in
rank order (``Placement.whole_vocab``, then ``Placement.whole_rows``),
and the SPC and the coder run on all lanes on every rank, so every rank
gets the same tables, writes the same container and decodes the same
symbols.  A container priced under a placement decodes bit-exactly on the
same placement (the same mesh and config): another placement may round a
logit otherwise.  ``mesh=`` beside a placed model raises by name.

Entry points run on the card unless ``device`` says otherwise and raise
without one (:func:`repro_torch.device.resolve_device`); with a mesh they
run on the mesh's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitstream, coder, constants as C, spc, u32
from repro_torch.core.predictors import model_topk_candidates
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, spc_quantize
from repro_torch.models import decode_step, init_state
from repro_torch.parallel import chunked as pchunked, gather

BOS = 0


def step_probs(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Model logits (rows, Vpad) -> the SPC's input (rows, V): f32 softmax
    in BF16 storage."""
    return spc.store_bf16(torch.softmax(
        logits[:, :vocab].to(torch.float32), dim=-1))


def step_tables(logits: torch.Tensor, vocab: int,
                prob_bits: int) -> spc.TableSet:
    """Model logits (rows, Vpad) -> TableSet (rows, V): f32 softmax, BF16
    storage, mass correction, CDF and Barrett planes (the plain SPC)."""
    return spc.tables_from_probs(step_probs(logits, vocab), prob_bits)


def _step_freq_cdf(logits: torch.Tensor, vocab: int, prob_bits: int):
    """The fused decode's SPC: identical quantization minus the Barrett
    planes, one SPC kernel launch for frequencies and CDF on the card."""
    return spc_quantize.spc_freq_cdf(step_probs(logits, vocab), prob_bits)


def _step_logits(model, state, token, pos, memory=None) -> torch.Tensor:
    """One ``decode_step``'s logits as whole rows (B, Vpad) of the global
    batch ``token`` (B, 1): a placed model's vocabulary slabs gathered
    over ``model``, then its rows over the batch axes, in rank order."""
    lg = decode_step(model, state, token, pos, memory=memory)
    pl = getattr(model, "placement", None)
    if pl is None:
        return lg
    return pl.whole_rows(pl.whole_vocab(lg), token.shape[0])


def _check_placed(model, mesh) -> None:
    """Refuse ``mesh=`` beside a compute-placed model: its own mesh places
    the step."""
    if getattr(model, "placement", None) is not None and mesh is not None:
        raise ValueError(
            "mesh= with a placed model (parallel.sharding.place_model): the "
            "model's own mesh places the step; pass mesh=None, or a whole "
            "model with a lane or chunk mesh")


def teacher_forced_scan(model, tokens: torch.Tensor, max_len: int, step_fn,
                        memory: torch.Tensor | None = None):
    """Run ``decode_step`` over ``tokens`` (B, S) teacher-forced (against
    ``memory`` (B, M, D) for a model with cross attention), handing each
    step's logits (whole rows) to ``step_fn(logits, t)``; returns the
    state."""
    b, s = tokens.shape
    state = init_state(model, b, max_len)
    for t in range(s):
        step_fn(_step_logits(model, state, tokens[:, t:t + 1], t,
                             memory=memory), t)
    return state


def collect_tables(model, tokens: torch.Tensor,
                   prob_bits: int = C.PROB_BITS, backend: str = "coder"):
    """Teacher-forced pass: per-(position, lane) tables ``(T, lanes, K)``
    and the model cross entropy in bits/symbol.

    ``backend="coder"`` runs the plain SPC at every step.  ``"kernel"``
    keeps every step's BF16 probabilities in a ``(T, lanes, K)`` buffer and
    quantizes the whole buffer after the scan in one SPC kernel launch
    (:func:`~repro_torch.kernels.ops.spc_quantize_tables`); the tables are
    identical.
    """
    if backend not in ("coder", "kernel"):
        raise ValueError(f"unknown encode backend {backend!r}")
    vocab = model.cfg.vocab_size
    lanes, t_len = tokens.shape
    inputs = torch.cat([torch.full((lanes, 1), BOS, dtype=tokens.dtype,
                                   device=tokens.device), tokens[:, :-1]], 1)
    planes = None
    probs = (torch.empty((t_len, lanes, vocab), dtype=torch.bfloat16,
                         device=tokens.device) if backend == "kernel"
             else None)
    nll = torch.empty((t_len,), dtype=torch.float32, device=tokens.device)

    def per_step(lg, t):
        nonlocal planes
        if probs is not None:
            probs[t] = step_probs(lg, vocab)
        else:
            tbl = step_tables(lg, vocab, prob_bits)
            if planes is None:
                planes = [torch.empty((t_len,) + a.shape, dtype=a.dtype,
                                      device=a.device) for a in tbl]
            for dst, src in zip(planes, tbl):
                dst[t] = src
        lp = torch.log_softmax(lg[:, :vocab].to(torch.float32), dim=-1)
        nll[t] = -lp.gather(1, tokens[:, t:t + 1]).mean()

    teacher_forced_scan(model, inputs, t_len, per_step)
    if probs is not None:
        flat = ops.spc_quantize_tables(probs.reshape(t_len * lanes, vocab),
                                       prob_bits)
        planes = [a.reshape((t_len, lanes) + a.shape[1:]) for a in flat]
    return spc.TableSet(*planes), nll.mean() / math.log(2.0)


class CompressStats(NamedTuple):
    enc: bitstream.EncodedLanes
    bits_per_symbol: torch.Tensor
    model_xent_bits: torch.Tensor


class ChunkedCompressStats(NamedTuple):
    chunks: bitstream.ChunkedLanes
    chunk_size: int
    n_symbols: int
    bits_per_symbol: torch.Tensor
    model_xent_bits: torch.Tensor


def _on_device(model, device) -> torch.device:
    dev = resolve_device(device)
    have = next(model.parameters()).device
    if have.type != dev.type or (dev.index is not None
                                 and have.index != dev.index):
        raise ValueError(f"model lives on {have} but the call runs on {dev}:"
                         " move it with model.to(device)")
    return have


def _mesh_device(mesh, device):
    """The device of a call: the mesh's when one is given."""
    if mesh is None:
        return device
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device={device!r} but the mesh's rank runs on "
                         f"{mesh.device}")
    return mesh.device


# what ``parallel.chunked.lane_mesh_usable`` names when it refuses a mesh
_FUSED, _COMPRESS = "fused decode (backend='kernel')", "lane-placed compress"


def _gather_xent(mesh, xent_bits: torch.Tensor) -> torch.Tensor:
    """The lanes' cross entropy from every rank's slab (equal slabs: the
    mean of the ranks' means)."""
    return gather(mesh, xent_bits.reshape(1)).mean()


def lm_compress(model, tokens, prob_bits: int = C.PROB_BITS,
                backend: str = "coder", device=None,
                mesh=None) -> CompressStats:
    """tokens (lanes, T) -> one monolithic rANS stream per lane + stats.

    ``backend="kernel"`` quantizes through the SPC kernel and encodes
    through the encode kernel (one launch each), ``"coder"`` through the
    plain SPC and the pure-torch coder; the bytes are identical.  On a
    ``("lanes",)`` ``mesh`` each rank prices and encodes its lane slab (the
    container that ``lm_decompress(mesh=)`` on as many ranks decodes).
    """
    _check_placed(model, mesh)
    dev = _on_device(model, _mesh_device(mesh, device))
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                             device=dev)
    placed = pchunked.lane_mesh_usable(mesh, tokens.shape[0], _COMPRESS)
    toks = tokens[slice(*mesh.slab(tokens.shape[0]))] if placed else tokens
    tables, xent_bits = collect_tables(model, toks, prob_bits, backend)
    enc = (ops.rans_encode(toks, tables) if backend == "kernel"
           else coder.encode(toks, tables))
    if placed:
        enc = bitstream.EncodedLanes(*(gather(mesh, a) for a in enc))
        xent_bits = _gather_xent(mesh, xent_bits)
    bits = enc.length.to(torch.float32).mean() * 8.0 / tokens.shape[1]
    return CompressStats(enc=enc, bits_per_symbol=bits,
                         model_xent_bits=xent_bits)


def lm_compress_chunked(model, tokens, chunk_size: int,
                        prob_bits: int = C.PROB_BITS,
                        backend: str = "coder", cap: int | None = None,
                        device=None, mesh=None) -> ChunkedCompressStats:
    """tokens (lanes, T) -> chunked multi-lane bitstream + stats.

    ``backend="kernel"`` quantizes through the SPC kernel and encodes
    through the encode kernel's chunk grid, one launch each; ``"coder"``
    runs the plain SPC and the pure-torch lane coder.  ``cap`` bounds
    the per-(chunk, lane) bytes; outgrown cells come back flagged on
    ``chunks.overflow`` and refuse to pack.

    ``mesh``: on a ``("lanes",)`` mesh each rank prices and encodes its
    lane slab as its own model call and the ranks gather the planes; any
    other mesh prices every lane on every rank and encodes through
    ``parallel.encode_chunked`` (the chunk slabs placed on a ``("chunks",)``
    mesh).
    """
    _check_placed(model, mesh)
    dev = _on_device(model, _mesh_device(mesh, device))
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                             device=dev)
    lanes, t_len = tokens.shape
    placed = (mesh is not None and mesh.axis == "lanes"
              and pchunked.lane_mesh_usable(mesh, lanes, _COMPRESS))
    toks = tokens[slice(*mesh.slab(lanes))] if placed else tokens
    tables, xent_bits = collect_tables(model, toks, prob_bits, backend)
    chunks = pchunked.encode_chunked(toks, tables, chunk_size,
                                     mesh=None if placed else mesh, cap=cap,
                                     backend=backend)
    if placed:
        chunks = bitstream.ChunkedLanes(*(gather(mesh, a, 1)
                                          for a in chunks))
        xent_bits = _gather_xent(mesh, xent_bits)
    bits = chunks.length.to(torch.float32).sum() * 8.0 / (lanes * t_len)
    return ChunkedCompressStats(chunks=chunks, chunk_size=chunk_size,
                                n_symbols=t_len, bits_per_symbol=bits,
                                model_xent_bits=xent_bits)


def _decode_chunk(model, enc: bitstream.EncodedLanes, state, tok, t0: int,
                  n: int, prob_bits: int, topk: int, backend: str,
                  planes=None):
    """Decode positions [t0, t0+n) of one chunk with the carried model
    state and token.  Returns (tok, symbols (lanes, n), probe sums, under).
    ``planes`` (coder backend): ``(freq, cdf, candidates)`` tensors with a
    leading T axis that receive every step's rows for a second pass.
    """
    vocab = model.cfg.vocab_size
    lanes = enc.buf.shape[0]
    dec = coder.decoder_init(enc)
    under = dec.underflow
    syms = torch.empty((n, lanes), dtype=torch.int32, device=enc.buf.device)
    probe_sum = torch.zeros((lanes,), dtype=torch.int64,
                            device=enc.buf.device)
    if backend == "kernel":
        buf = enc.buf.contiguous()
        s, ptr = u32.bits(dec.s), dec.ptr.to(torch.int32)
    for i in range(n):
        lg = _step_logits(model, state, tok, t0 + i)
        cands = model_topk_candidates(lg[:, :vocab], topk)
        if backend == "kernel":
            freq, cdf = _step_freq_cdf(lg, vocab, prob_bits)
            s, ptr, sym, probes, u = ops.rans_decode_step(
                buf, s, ptr, freq, cdf, prob_bits=prob_bits,
                candidates=cands)
            under = under | (u > 0)
        else:
            tbl = step_tables(lg, vocab, prob_bits)
            dec, sym, probes = coder.decode_get(dec, enc.buf, tbl, prob_bits,
                                                candidates=cands)
            if planes is not None:
                for dst, src in zip(planes, (tbl.freq, tbl.cdf, cands)):
                    dst[t0 + i] = src
        syms[i] = sym
        probe_sum += probes
        tok = sym[:, None].to(torch.int64)
    if backend != "kernel":
        under = dec.underflow
    return tok, syms.T, probe_sum, under


def _plane_buffers(lanes: int, n_symbols: int, vocab: int, topk: int,
                   device):
    """Empty ``(T, lanes, K)`` freq, ``(T, lanes, K+1)`` cdf and ``(T,
    lanes, topk)`` candidate planes for the two-pass decode's pass 1."""
    def plane(width):
        return torch.empty((n_symbols, lanes, width), dtype=torch.int32,
                           device=device)
    return plane(vocab), plane(vocab + 1), plane(topk)


def _decoded(sym, lane_sum, lanes: int, n_symbols: int, lane_probes: bool):
    out = (sym, lane_sum.sum().to(torch.float32) / (lanes * n_symbols))
    return out + (lane_sum,) if lane_probes else out


def _placed_lanes(mesh, sym, lane_sum, under):
    """Every rank's lane slab of a fused decode's outputs, gathered."""
    return (gather(mesh, sym), gather(mesh, lane_sum), gather(mesh, under))


def lm_decompress(model, enc: bitstream.EncodedLanes, n_symbols: int,
                  prob_bits: int = C.PROB_BITS, topk: int = 4,
                  backend: str = "coder", lane_probes: bool = False,
                  device=None, mesh=None):
    """Monolithic bitstream -> tokens (bit-exact inverse of
    :func:`lm_compress`), with the model's top-k as trial symbols.

    ``backend`` is ``"coder"``, ``"kernel"`` (the fused decode) or
    ``"two_pass"`` (the coder scan collects tables and candidates, then
    one full-stream kernel launch re-decodes the stream; its symbols and
    probes come from that launch only).  ``mesh``: a ``("lanes",)`` mesh
    places the fused decode's lanes (``backend="kernel"`` only): each rank
    decodes its lane slab and the ranks gather symbols, per-lane probes
    and exhaustion flags.  Raises
    :class:`~repro_torch.core.coder.StreamExhaustedError` on a read past a
    lane's stream (on every rank alike).  Returns ``(tokens (lanes, T)
    int32, avg_probes[, per-lane probes])``.
    """
    if backend not in ("coder", "kernel", "two_pass"):
        raise ValueError(f"unknown decode backend {backend!r}")
    if mesh is not None and backend != "kernel":
        raise ValueError(
            "mesh= requires backend='kernel': only the fused program has "
            "an independent (lane) axis to place — the coder and two-pass "
            "reference paths are single-device")
    _check_placed(model, mesh)
    dev = _on_device(model, _mesh_device(mesh, device))
    enc = bitstream.EncodedLanes(*(a.to(dev) for a in enc[:3]))
    lanes = enc.buf.shape[0]
    placed = backend == "kernel" and pchunked.lane_mesh_usable(mesh, lanes,
                                                               _FUSED)
    if placed:
        enc = bitstream.EncodedLanes(*(a[slice(*mesh.slab(lanes))]
                                       for a in enc[:3]))
    rows = enc.buf.shape[0]
    state = init_state(model, rows, n_symbols)
    tok = torch.full((rows, 1), BOS, dtype=torch.int64, device=dev)
    if backend == "two_pass":
        planes = _plane_buffers(lanes, n_symbols, model.cfg.vocab_size,
                                topk, dev)
        _decode_chunk(model, enc, state, tok, 0, n_symbols, prob_bits, topk,
                      "coder", planes)
        return ops.rans_decode(enc, n_symbols, spc.FreqCdf(*planes[:2]),
                               prob_bits=prob_bits, candidates=planes[2],
                               lane_probes=lane_probes)
    _, sym, lane_sum, under = _decode_chunk(
        model, enc, state, tok, 0, n_symbols, prob_bits, topk, backend)
    if placed:
        sym, lane_sum, under = _placed_lanes(mesh, sym, lane_sum, under)
    coder._check_exhausted(under, "lm_decompress")
    return _decoded(sym, lane_sum, lanes, n_symbols, lane_probes)


def _walk_chunks(model, chunks, lanes: int, n_symbols: int, chunk_size: int,
                 prob_bits: int, topk: int, backend: str, planes, dev):
    """The sequential decode over the chunks of a ``ChunkedLanes`` or
    ``ContainerSlab``: the model state and token carry across chunks, the
    coder state resets per chunk (each chunk's window right-aligned on the
    device one chunk at a time).  Returns ``(symbols (lanes, T), per-lane
    probe sums, per-lane exhaustion flags)``."""
    slab_in = isinstance(chunks, bitstream.ContainerSlab)
    state = init_state(model, lanes, n_symbols)
    tok = torch.full((lanes, 1), BOS, dtype=torch.int64, device=dev)
    outs = []
    lane_sum = torch.zeros((lanes,), dtype=torch.int64, device=dev)
    under = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    for c, n in enumerate(coder.chunk_lengths(n_symbols, chunk_size)):
        if slab_in:
            enc = bitstream.chunk_encoded_from_slab(chunks, c, dev)
        else:
            enc = bitstream.EncodedLanes(
                *(a.to(dev) for a in coder.chunk_encoded(chunks, c)[:3]))
        tok, sym, probes, und = _decode_chunk(
            model, enc, state, tok, c * chunk_size, n, prob_bits, topk,
            backend, planes)
        outs.append(sym)
        lane_sum += probes
        under |= und
    return torch.cat(outs, dim=1), lane_sum, under


def lm_decompress_chunked(model, chunks, n_symbols: int, chunk_size: int,
                          prob_bits: int = C.PROB_BITS, topk: int = 4,
                          backend: str = "coder", lane_probes: bool = False,
                          device=None, mesh=None):
    """Chunked bitstream -> tokens (bit-exact inverse of
    :func:`lm_compress_chunked`).

    ``chunks`` is a :class:`~repro_torch.core.bitstream.ChunkedLanes` or a
    :class:`~repro_torch.core.bitstream.ContainerSlab` from
    ``parse_chunked``.  The ``coder`` and ``kernel`` backends right-align
    each chunk's window on the device one chunk at a time.  ``two_pass``
    walks the chunks with the coder scan collecting every step's tables
    and top-k candidates (pass 1; its symbols, probes and flags are
    discarded), then re-decodes the whole stream in ONE launch (pass 2):
    B4 straight off a ``ContainerSlab``'s payload, B3's chunk grid from
    ``ChunkedLanes``.

    ``mesh``: for ``backend="kernel"`` a ``("lanes",)`` mesh places the
    fused decode's lanes (each rank decodes its lane slab of the dense
    chunks, rebuilt from a ``ContainerSlab`` on the device, and the ranks
    gather); for ``backend="two_pass"`` a ``("chunks",)`` mesh places pass
    2 through ``parallel.decode_chunked`` (pass 1 runs on every rank), and
    ``lane_probes`` there requires ``mesh=None``.  Raises
    :class:`~repro_torch.core.coder.StreamExhaustedError` when a lane reads
    past its stream (on every rank alike).  Returns ``(tokens (lanes, T)
    int32, avg_probes[, per-lane probes])``.
    """
    if backend not in ("coder", "kernel", "two_pass"):
        raise ValueError(f"unknown decode backend {backend!r}")
    if mesh is not None and backend == "coder":
        raise ValueError(
            "mesh= requires backend='kernel' or 'two_pass': the coder "
            "backend decodes inside the sequential model scan, so there is "
            "neither a fused program nor a pass 2 to place on a mesh")
    if mesh is not None and backend == "two_pass" and lane_probes:
        raise ValueError(
            "lane_probes requires mesh=None: the sharded decode does not "
            "aggregate per-lane counters across devices")
    _check_placed(model, mesh)
    dev = _on_device(model, _mesh_device(mesh, device))
    slab_in = isinstance(chunks, bitstream.ContainerSlab)
    n_have, lanes = (chunks.offset.shape if slab_in
                     else chunks.buf.shape[:2])
    coder.check_chunk_count(n_have, n_symbols, chunk_size)
    if backend == "kernel" and pchunked.lane_mesh_usable(mesh, lanes, _FUSED):
        if slab_in:
            chunks = bitstream.slab_to_chunked(chunks, dev)
        r0, r1 = mesh.slab(lanes)
        local = bitstream.ChunkedLanes(*(a[:, r0:r1].to(dev)
                                         for a in chunks[:3]))
        out = _walk_chunks(model, local, r1 - r0, n_symbols, chunk_size,
                           prob_bits, topk, backend, None, dev)
        sym, lane_sum, under = _placed_lanes(mesh, *out)
        coder._check_exhausted(under, "lm_decompress_chunked")
        return _decoded(sym, lane_sum, lanes, n_symbols, lane_probes)
    if backend == "two_pass":
        planes = _plane_buffers(lanes, n_symbols, model.cfg.vocab_size, topk,
                                dev)
        _walk_chunks(model, chunks, lanes, n_symbols, chunk_size, prob_bits,
                     topk, "coder", planes, dev)
        # pass 2: B4 straight off a ContainerSlab, B3 on dense chunks, on
        # the chunk mesh when given
        if not slab_in:
            chunks = bitstream.ChunkedLanes(*(a.to(dev) for a in chunks[:3]))
        return pchunked.decode_chunked(
            chunks, n_symbols, spc.FreqCdf(*planes[:2]), chunk_size,
            mesh=mesh, prob_bits=prob_bits, backend="kernel",
            candidates=planes[2], lane_probes=lane_probes)
    sym, lane_sum, under = _walk_chunks(model, chunks, lanes, n_symbols,
                                        chunk_size, prob_bits, topk, backend,
                                        None, dev)
    coder._check_exhausted(under, "lm_decompress_chunked")
    return _decoded(sym, lane_sum, lanes, n_symbols, lane_probes)


# ---------------------------------------------------------------------------
# static-table path (classic rANS with an empirical histogram)
# ---------------------------------------------------------------------------

def histogram_compress(symbols, k: int, prob_bits: int = C.PROB_BITS,
                       device=None):
    """Symbols ``(lanes, T)`` (numpy or tensor) -> ``(EncodedLanes, static
    TableSet)``: +1-smoothed histogram tables, coder encode on ``device``
    (the card unless given)."""
    dev = resolve_device(device)
    symbols = np.asarray(symbols.cpu() if isinstance(symbols, torch.Tensor)
                         else symbols)
    counts = np.bincount(symbols.ravel(), minlength=k)
    tbl = spc.TableSet(*(a.to(dev) for a in spc.tables_from_counts_np(
        counts, prob_bits)))
    enc = coder.encode(torch.as_tensor(symbols, dtype=torch.int64,
                                       device=dev), tbl)
    return enc, tbl


def histogram_decompress(enc: bitstream.EncodedLanes, n_symbols: int, tbl,
                         prob_bits: int = C.PROB_BITS, predictor=None,
                         backend: str = "kernel", lane_probes: bool = False,
                         device=None):
    """Static-table decode on ``device`` (the card unless given): the
    full-stream kernel (B3) by default, the pure-torch coder with
    ``backend="coder"``; symbols and probes are identical.  ``enc``'s
    ``buf``/``start`` may be tensors or the numpy arrays of
    :func:`~repro_torch.core.bitstream.unpack`.  ``predictor`` enables the
    window-gated search (the paper's ``NeighborAverage`` for image rows).
    Returns ``(symbols, avg_probes[, per-lane probes])``."""
    dev = resolve_device(device)
    enc = bitstream.EncodedLanes(*(torch.as_tensor(a, device=dev)
                                   for a in enc[:2]), None)
    tbl = type(tbl)(*(a.to(dev) for a in tbl))
    if backend == "kernel":
        return ops.rans_decode(enc, n_symbols, tbl, prob_bits=prob_bits,
                               predictor=predictor, lane_probes=lane_probes)
    if backend == "coder":
        return coder.decode(enc, n_symbols, tbl, prob_bits,
                            predictor=predictor, lane_probes=lane_probes)
    raise ValueError(f"unknown decode backend {backend!r}")
