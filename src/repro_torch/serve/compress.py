"""LM-driven lossless compression, end to end (the paper's Fig. 1/2 path).

Port of the chunked half of ``repro.serve.compress``:

  compress    — a teacher-forced per-step ``decode_step`` scan prices every
                (position, lane); the SPC quantizes each distribution; the
                chunked multi-lane encoder writes the streams (one kernel
                launch for the whole stream with ``backend="kernel"``).
  decompress  — the same per-step scan, except each step's symbol comes
                out of the rANS decoder and is fed back into the model.
                ``backend="kernel"`` is the fused serve decode: every step
                runs the model, the SPC decode fast path, the model top-k
                and one pop per lane with the decode-step kernel.
                ``backend="coder"`` pops with the pure-torch coder.

Both directions run the identical ``decode_step`` at the identical row
count, so the tables that price a stream are bit-for-bit the tables that
decode it.  Chunking changes only the coder framing: the model state and
the fed-back token carry across chunk boundaries, the coder state
re-initializes per chunk.

Entry points run on the card unless ``device`` says otherwise and raise
without one (:func:`repro_torch.device.resolve_device`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitstream, coder, constants as C, spc, u32
from repro_torch.core.predictors import model_topk_candidates
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import decode_step, init_state

BOS = 0


def step_tables(logits: torch.Tensor, vocab: int,
                prob_bits: int) -> spc.TableSet:
    """Model logits (rows, Vpad) -> TableSet (rows, V): f32 softmax, BF16
    storage, mass correction, CDF and Barrett planes."""
    probs = torch.softmax(logits[:, :vocab].to(torch.float32), dim=-1)
    return spc.tables_from_probs(spc.store_bf16(probs), prob_bits)


def _step_freq_cdf(logits: torch.Tensor, vocab: int, prob_bits: int):
    """The decode-side SPC: identical quantization minus the Barrett
    planes."""
    probs = torch.softmax(logits[:, :vocab].to(torch.float32), dim=-1)
    return spc.freq_cdf_from_probs(spc.store_bf16(probs), prob_bits)


def teacher_forced_scan(model, tokens: torch.Tensor, max_len: int, step_fn):
    """Run ``decode_step`` over ``tokens`` (B, S) teacher-forced, handing
    each step's logits to ``step_fn(logits, t)``; returns the state."""
    b, s = tokens.shape
    state = init_state(model, b, max_len)
    for t in range(s):
        step_fn(decode_step(model, state, tokens[:, t:t + 1], t), t)
    return state


def collect_tables(model, tokens: torch.Tensor,
                   prob_bits: int = C.PROB_BITS):
    """Teacher-forced pass: per-(position, lane) tables ``(T, lanes, K)``
    and the model cross entropy in bits/symbol."""
    vocab = model.cfg.vocab_size
    lanes, t_len = tokens.shape
    inputs = torch.cat([torch.full((lanes, 1), BOS, dtype=tokens.dtype,
                                   device=tokens.device), tokens[:, :-1]], 1)
    planes = None
    nll = torch.empty((t_len,), dtype=torch.float32, device=tokens.device)

    def per_step(lg, t):
        nonlocal planes
        tbl = step_tables(lg, vocab, prob_bits)
        if planes is None:
            planes = [torch.empty((t_len,) + a.shape, dtype=a.dtype,
                                  device=a.device) for a in tbl]
        for dst, src in zip(planes, tbl):
            dst[t] = src
        lp = torch.log_softmax(lg[:, :vocab].to(torch.float32), dim=-1)
        nll[t] = -lp.gather(1, tokens[:, t:t + 1]).mean()

    teacher_forced_scan(model, inputs, t_len, per_step)
    return spc.TableSet(*planes), nll.mean() / math.log(2.0)


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


def lm_compress_chunked(model, tokens, chunk_size: int,
                        prob_bits: int = C.PROB_BITS,
                        backend: str = "coder", cap: int | None = None,
                        device=None) -> ChunkedCompressStats:
    """tokens (lanes, T) -> chunked multi-lane bitstream + stats.

    ``backend="kernel"`` encodes through the encode kernel's chunk grid in
    one launch; ``"coder"`` runs the pure-torch lane coder.  ``cap`` bounds
    the per-(chunk, lane) bytes; outgrown cells come back flagged on
    ``chunks.overflow`` and refuse to pack.
    """
    dev = _on_device(model, device)
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                             device=dev)
    lanes, t_len = tokens.shape
    tables, xent_bits = collect_tables(model, tokens, prob_bits)
    if backend == "kernel":
        chunks = ops.rans_encode_chunked(tokens, tables, chunk_size, cap=cap)
    elif backend == "coder":
        chunks = coder.encode_chunked(tokens, tables, chunk_size, cap=cap)
    else:
        raise ValueError(f"unknown encode backend {backend!r}")
    bits = chunks.length.to(torch.float32).sum() * 8.0 / (lanes * t_len)
    return ChunkedCompressStats(chunks=chunks, chunk_size=chunk_size,
                                n_symbols=t_len, bits_per_symbol=bits,
                                model_xent_bits=xent_bits)


def _decode_chunk(model, enc: bitstream.EncodedLanes, state, tok, t0: int,
                  n: int, prob_bits: int, topk: int, backend: str):
    """Decode positions [t0, t0+n) of one chunk with the carried model
    state and token.  Returns (tok, symbols (lanes, n), probe sums, under).
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
        lg = decode_step(model, state, tok, t0 + i)
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
        syms[i] = sym
        probe_sum += probes
        tok = sym[:, None].to(torch.int64)
    if backend != "kernel":
        under = dec.underflow
    return tok, syms.T, probe_sum, under


def lm_decompress_chunked(model, chunks, n_symbols: int, chunk_size: int,
                          prob_bits: int = C.PROB_BITS, topk: int = 4,
                          backend: str = "coder", lane_probes: bool = False,
                          device=None):
    """Chunked bitstream -> tokens (bit-exact inverse of
    :func:`lm_compress_chunked`).

    ``chunks`` is a :class:`~repro_torch.core.bitstream.ChunkedLanes` or a
    :class:`~repro_torch.core.bitstream.ContainerSlab` from
    ``parse_chunked``; each chunk's window is right-aligned on the device
    one chunk at a time.  Raises
    :class:`~repro_torch.core.coder.StreamExhaustedError` when a lane reads
    past its stream.  Returns ``(tokens (lanes, T) int32, avg_probes[,
    per-lane probes])``.
    """
    if backend not in ("coder", "kernel"):
        raise ValueError(f"unknown decode backend {backend!r}")
    dev = _on_device(model, device)
    slab_in = isinstance(chunks, bitstream.ContainerSlab)
    n_have = chunks.offset.shape[0] if slab_in else chunks.buf.shape[0]
    lanes = chunks.offset.shape[1] if slab_in else chunks.buf.shape[1]
    n_total = coder.num_chunks(n_symbols, chunk_size)
    if n_have != n_total:
        raise ValueError(
            f"stream has {n_have} chunks but n_symbols="
            f"{n_symbols} at chunk_size={chunk_size} implies {n_total}")
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
            backend)
        outs.append(sym)
        lane_sum += probes
        under |= und
    coder._check_exhausted(under, "lm_decompress_chunked")
    out = (torch.cat(outs, dim=1),
           lane_sum.sum().to(torch.float32) / (lanes * n_symbols))
    if lane_probes:
        out = out + (lane_sum,)
    return out
