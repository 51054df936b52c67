"""Craystack-style push/pop stack over the multi-lane rANS coder.

Port of ``repro.core.stack``.  The lane coder (:mod:`repro_torch.core.coder`)
is a batch codec; latent-variable compression (bits-back, Bit-Swap) needs
the coder as a **stack**: interleaved pushes and pops against one live
state, where a pop against the posterior recovers bits that a push against
the prior later pays back.

  * :class:`StackState` — per-lane rANS states (int64 uint32 values), the
    ``(lanes, cap)`` uint8 backward byte buffer, per-lane cursors (int64)
    and the per-lane ``underflow`` flag: a pop that reads past the stream
    end injects 0 and flags, as the coder's decode does;
  * a push lands the single-source :func:`~repro_torch.core.update.
    encode_step` records backward, its planes from
    :func:`~repro_torch.core.spc.barrett_planes`; a pop runs
    :func:`~repro_torch.core.search.find_symbol` and the guarded forward
    refill, or, with ``backend="kernel"``, B2
    (:func:`repro_torch.kernels.rans_decode.rans_decode_step`), which takes
    the stack's ``(lanes, cap)`` buffer as it is.  Both pop backends give
    the same integers;
  * codecs are ``(push, pop)`` pairs: :func:`NonUniform`, :func:`Uniform`,
    :func:`Categorical`, :func:`from_tableset`, :func:`DiagGaussian` and
    :func:`DiscretizedLogistic`, composed with :func:`serial` and
    :func:`substack`; :func:`push_symbols`/:func:`pop_symbols` run a
    ``(lanes, T)`` block through shared, per-position or
    per-position-per-lane tables.

States are values, as in the reference: no function changes a state it is
given (a push copies the buffer before writing; pops never write it).
Tables are int32 tensors (uint32 bit patterns, as ``core.spc`` makes
them).  The observation codecs quantize their probabilities with
:func:`freq_cdf`: B6 (``kernels.spc_quantize.spc_freq_cdf``) for a CUDA
tensor, its plain version for a CPU tensor.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import constants as C
from repro_torch.core import search, spc, u32, update
from repro_torch.core.bitstream import EncodedLanes
from repro_torch.core.coder import (StreamExhaustedError,  # noqa: F401
                                    _read_byte)
from repro_torch.core.search import take_gather as _gather
from repro_torch.device import resolve_device
from repro_torch.kernels import rans_decode, spc_quantize

_I64 = torch.int64
_I32 = torch.int32


class StackState(NamedTuple):
    """Bytes ``buf[lane, ptr[lane]:]`` are the stream (pushed backward,
    popped forward: the byte at ``ptr`` is the most recently pushed
    unconsumed byte)."""

    s: torch.Tensor          # (lanes,) int64 uint32 rANS states
    buf: torch.Tensor        # (lanes, cap) uint8 backward byte stack
    ptr: torch.Tensor        # (lanes,) int64: next pop reads buf[lane, ptr]
    underflow: torch.Tensor  # (lanes,) bool: a pop read past the stream end


class Codec(NamedTuple):
    """``push(state, symbol) -> state`` and ``pop(state) -> (state,
    symbol)``, exact inverses of each other."""

    push: Callable[[StackState, Any], StackState]
    pop: Callable[[StackState], tuple[StackState, Any]]


def _check_backend(backend: str, what: str) -> None:
    if backend not in ("coder", "kernel"):
        raise ValueError(f"unknown {what} backend {backend!r}")


# ---------------------------------------------------------------------------
# stack lifecycle: init / initial bits / flush / open
# ---------------------------------------------------------------------------

def stack_init(lanes: int, cap: int, device=None) -> StackState:
    """Empty stack at the rANS normalization floor: a pop from it reads
    past the (empty) stream and flags the lane's ``underflow``.  On the
    card unless ``device`` says otherwise."""
    device = resolve_device(device)
    return StackState(
        s=torch.full((lanes,), C.RANS_L, dtype=_I64, device=device),
        buf=torch.zeros((lanes, cap), dtype=torch.uint8, device=device),
        ptr=torch.full((lanes,), cap, dtype=_I64, device=device),
        underflow=torch.zeros((lanes,), dtype=torch.bool, device=device))


def stack_init_bits(lanes: int, cap: int, n_bytes: int = 64, seed: int = 0,
                    device=None) -> StackState:
    """Stack seeded with ``n_bytes`` uniform random bytes per lane and a
    random state in ``[RANS_L, 2**31)``: the initial bits a bits-back pop
    consumes.  numpy ``default_rng(seed)`` draws them in the reference's
    order, so the bytes and states equal the reference's.  On the card
    unless ``device`` says otherwise."""
    if n_bytes > cap:
        raise ValueError(f"n_bytes={n_bytes} exceeds stack cap={cap}")
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    buf = np.zeros((lanes, cap), np.uint8)
    if n_bytes:
        buf[:, cap - n_bytes:] = rng.integers(0, 256, (lanes, n_bytes),
                                              dtype=np.uint8)
    s = rng.integers(C.RANS_L, 1 << 31, (lanes,), dtype=np.uint32)
    return StackState(
        s=torch.as_tensor(s.astype(np.int64), device=device),
        buf=torch.as_tensor(buf, device=device),
        ptr=torch.full((lanes,), cap - n_bytes, dtype=_I64, device=device),
        underflow=torch.zeros((lanes,), dtype=torch.bool, device=device))


def stack_bytes(st: StackState) -> torch.Tensor:
    """Per-lane live size in bytes: the stream plus the 4-byte state header
    a :func:`stack_flush` would write.  A message's net cost is the growth
    of this (the initial bits are capital, not cost)."""
    return (st.buf.shape[1] - st.ptr) + 4


def _emit(buf, ptr, byte, cond):
    """Masked backward emit into ``buf`` in place: a lane that emits writes
    ``byte`` at ``ptr - 1`` unless that column is outside the buffer (a
    cursor past the head, or past the end after over-pops: those writes
    drop); every emitting lane's cursor decrements."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    col = torch.clamp(ptr - 1, 0, buf.shape[1] - 1)
    write = cond & (ptr > 0) & (ptr <= buf.shape[1])
    buf[rows, col] = torch.where(write, byte.to(torch.uint8), buf[rows, col])
    return ptr - cond.to(_I64)


def stack_flush(st: StackState) -> EncodedLanes:
    """Serialize the live stack: the 4-byte big-endian state header (read
    back first by :func:`stack_open`) and the streams as
    :class:`EncodedLanes`, byte-compatible with ``coder.encode``."""
    buf, ptr = st.buf.clone(), st.ptr
    true = torch.ones_like(st.underflow)
    for shift in (0, 8, 16, 24):
        ptr = _emit(buf, ptr, (st.s >> shift) & 0xFF, true)
    cap = buf.shape[1]
    return EncodedLanes(buf=buf, start=torch.clamp(ptr, min=0).to(_I32),
                        length=(cap - ptr).to(_I32), overflow=ptr < 0)


def stack_open(enc: EncodedLanes) -> StackState:
    """Inverse of :func:`stack_flush`: read the state header and resume.
    A header read past the stream end flags ``underflow``."""
    lanes, cap = enc.buf.shape
    lane_idx = torch.arange(lanes, device=enc.buf.device)
    s = torch.zeros((lanes,), dtype=_I64, device=enc.buf.device)
    ptr = enc.start.to(_I64)
    under = torch.zeros((lanes,), dtype=torch.bool, device=enc.buf.device)
    for _ in range(4):
        byte, oob = _read_byte(enc.buf, lane_idx, ptr, cap)
        under = under | oob
        s = ((s << 8) | byte) & C.U32_MASK
        ptr = ptr + 1
    return StackState(s=s, buf=enc.buf, ptr=ptr, underflow=under)


# ---------------------------------------------------------------------------
# primitive push / pop over (start, freq) in the fixed-point domain
# ---------------------------------------------------------------------------

def _push_into(s, buf, ptr, start, freq, prob_bits):
    """One push per lane, its renorm bytes written into ``buf`` in place;
    returns ``(s', ptr')``."""
    planes = spc.barrett_planes(freq, start, prob_bits)
    e = update.EncTables(*(u32.value(a) for a in planes))
    s, recs = update.encode_step(s, e)
    for byte, cond in recs:
        ptr = _emit(buf, ptr, byte, cond)
    return s, ptr


def push_with(st: StackState, start: torch.Tensor, freq: torch.Tensor,
              prob_bits: int = C.PROB_BITS) -> StackState:
    """Push one symbol per lane given its ``(start, freq)`` pair: the
    Barrett planes of :func:`~repro_torch.core.spc.barrett_planes`, then
    :func:`~repro_torch.core.update.encode_step`, its records landed
    backward."""
    buf = st.buf.clone()
    s, ptr = _push_into(st.s, buf, st.ptr, start, freq, prob_bits)
    return StackState(s, buf, ptr, st.underflow)


def _pop_update(s, ptr, under, buf, slot, start, freq, prob_bits):
    """The decoder update and guarded 2-step refill; returns ``(s', ptr',
    under')``."""
    lanes, cap = buf.shape
    lane_idx = torch.arange(lanes, device=buf.device)
    s = (u32.value(freq) * (s >> prob_bits) + slot
         - u32.value(start)) & C.U32_MASK
    for _ in range(C.MAX_RENORM_STEPS):
        cond = s < C.RANS_L
        byte, oob = _read_byte(buf, lane_idx, ptr, cap)
        under = under | (cond & oob)
        s = torch.where(cond, ((s << C.RENORM_SHIFT) | byte) & C.U32_MASK, s)
        ptr = ptr + cond.to(_I64)
    return s, ptr, under


def pop_update(st: StackState, slot: torch.Tensor, start: torch.Tensor,
               freq: torch.Tensor, prob_bits: int = C.PROB_BITS
               ) -> StackState:
    """Finish a pop once the symbol is known: the state update plus the
    guarded forward refill (a read past the stream end injects 0 and
    flags ``underflow``)."""
    s, ptr, under = _pop_update(st.s, st.ptr, st.underflow, st.buf, slot,
                                start, freq, prob_bits)
    return StackState(s, st.buf, ptr, under)


def stack_slot(st: StackState, prob_bits: int = C.PROB_BITS) -> torch.Tensor:
    """The per-lane low-bits slot the next pop inverts."""
    return st.s & ((1 << prob_bits) - 1)


def _kernel_pop(s, ptr, under, buf, freq, cdf, prob_bits):
    """One pop per lane through B2 (its plain version for CPU tensors);
    ``s``/``ptr`` in B2's int32 form.  Returns ``(s', ptr', under',
    symbol)``."""
    s, ptr, x, _, u = rans_decode.rans_decode_step(buf, s, ptr, freq, cdf,
                                                   prob_bits=prob_bits)
    return s, ptr, under | (u > 0), x.to(_I64)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def NonUniform(enc_statfun, dec_statfun,
               prob_bits: int = C.PROB_BITS) -> Codec:
    """Craystack's primitive codec over statfuns: ``enc_statfun(x) ->
    (start, freq)`` (mass ``2**prob_bits``) and ``dec_statfun(slot) -> x``.
    The pop re-derives ``(start, freq)`` through ``enc_statfun``."""
    def push(st: StackState, x) -> StackState:
        start, freq = enc_statfun(x)
        return push_with(st, start, freq, prob_bits)

    def pop(st: StackState):
        slot = stack_slot(st, prob_bits)
        x = dec_statfun(slot)
        start, freq = enc_statfun(x)
        return pop_update(st, slot, start, freq, prob_bits), x

    return Codec(push=push, pop=pop)


def Uniform(bits: int, prob_bits: int = C.PROB_BITS) -> Codec:
    """Table-free uniform codec over ``2**bits`` symbols, each owning a
    ``2**(prob_bits - bits)`` slice of the slot space."""
    if not 0 < bits <= prob_bits:
        raise ValueError(f"Uniform bits must be in (0, {prob_bits}], "
                         f"got {bits}")
    shift = prob_bits - bits

    def enc_statfun(x):
        x = x.to(_I64)
        return x << shift, torch.full_like(x, 1 << shift)

    def dec_statfun(slot):
        return slot >> shift

    return NonUniform(enc_statfun, dec_statfun, prob_bits)


def Categorical(freq: torch.Tensor, cdf: torch.Tensor,
                prob_bits: int = C.PROB_BITS,
                backend: str = "coder") -> Codec:
    """Codec over quantized ``(freq, cdf)`` rows, shared ``(K,)`` or
    per-lane ``(lanes, K)``.  ``backend="coder"`` inverts slots with
    :func:`~repro_torch.core.search.find_symbol`, ``"kernel"`` pops
    through B2; both give the same integers and flag exhaustion."""
    _check_backend(backend, "Categorical")
    k = freq.shape[-1]

    def enc_statfun(x):
        return _gather(cdf[..., :-1], x), _gather(freq, x)

    def push(st: StackState, x) -> StackState:
        start, f = enc_statfun(x)
        return push_with(st, start, f, prob_bits)

    if backend == "kernel":
        def pop(st: StackState):
            s, ptr, under, x = _kernel_pop(
                u32.bits(st.s), st.ptr.to(_I32), st.underflow, st.buf, freq,
                cdf, prob_bits)
            return StackState(u32.value(s), st.buf, ptr.to(_I64), under), x

        return Codec(push=push, pop=pop)

    def pop(st: StackState):
        slot = stack_slot(st, prob_bits)
        x, _ = search.find_symbol(cdf, k, slot)
        start, f = enc_statfun(x)
        return pop_update(st, slot, start, f, prob_bits), x

    return Codec(push=push, pop=pop)


def from_tableset(tbl: spc.TableSet, prob_bits: int = C.PROB_BITS,
                  backend: str = "coder") -> Codec:
    """Codec over a full :class:`~repro_torch.core.spc.TableSet`."""
    return Categorical(tbl.freq, tbl.cdf, prob_bits, backend=backend)


def serial(codecs) -> Codec:
    """Compose codecs: ``pop`` yields symbols in list order, so ``push``
    runs in reverse order (LIFO).  Symbols travel as a tuple."""
    codecs = list(codecs)

    def push(st: StackState, xs) -> StackState:
        if len(xs) != len(codecs):
            raise ValueError(f"serial push got {len(xs)} symbols for "
                             f"{len(codecs)} codecs")
        for codec, x in reversed(list(zip(codecs, xs))):
            st = codec.push(st, x)
        return st

    def pop(st: StackState):
        xs = []
        for codec in codecs:
            st, x = codec.pop(st)
            xs.append(x)
        return st, tuple(xs)

    return Codec(push=push, pop=pop)


def substack(codec: Codec, idx) -> Codec:
    """Run ``codec`` on the lane subset ``idx`` only; other lanes are
    untouched bit for bit."""
    def rows(st):
        return torch.as_tensor(idx, dtype=_I64, device=st.s.device)

    def view(st: StackState) -> StackState:
        i = rows(st)
        return StackState(st.s[i], st.buf[i], st.ptr[i], st.underflow[i])

    def merge(st: StackState, sub: StackState) -> StackState:
        i = rows(st)
        out = [a.clone() for a in st]
        for a, b in zip(out, sub):
            a[i] = b
        return StackState(*out)

    def push(st: StackState, x) -> StackState:
        return merge(st, codec.push(view(st), x))

    def pop(st: StackState):
        sub, x = codec.pop(view(st))
        return merge(st, sub), x

    return Codec(push=push, pop=pop)


# ---------------------------------------------------------------------------
# array codecs: a (lanes, T) symbol block through per-position tables
# ---------------------------------------------------------------------------

def _position_tables(freq: torch.Tensor, t_len: int) -> bool:
    """``(T, K)``/``(T, lanes, K)`` tables are per-position exactly when
    the leading dim matches the block length (the reference's rule)."""
    return freq.ndim >= 2 and freq.shape[0] == t_len


def push_symbols(st: StackState, x: torch.Tensor, freq: torch.Tensor,
                 cdf: torch.Tensor,
                 prob_bits: int = C.PROB_BITS) -> StackState:
    """Push a ``(lanes, T)`` block through shared ``(K,)``, per-position
    ``(T, K)`` or per-position-per-lane ``(T, lanes, K)`` tables, last
    position first, so :func:`pop_symbols` pops positions forward."""
    t_len = x.shape[1]
    per_position = _position_tables(freq, t_len)
    x = x.to(_I64)
    buf = st.buf.clone()
    s, ptr = st.s, st.ptr
    for t in range(t_len - 1, -1, -1):
        f_t, c_t = (freq[t], cdf[t]) if per_position else (freq, cdf)
        s, ptr = _push_into(s, buf, ptr, _gather(c_t[..., :-1], x[:, t]),
                            _gather(f_t, x[:, t]), prob_bits)
    return StackState(s, buf, ptr, st.underflow)


def pop_symbols(st: StackState, n: int, freq: torch.Tensor,
                cdf: torch.Tensor, prob_bits: int = C.PROB_BITS,
                backend: str = "coder"):
    """Pop ``n`` symbols per lane; returns ``(state, symbols (lanes, n)
    int64)``.  Table layouts as in :func:`push_symbols`.
    ``backend="kernel"`` runs B2 once per position (``n`` launches on the
    card); ``"coder"`` the pure-torch search and refill."""
    _check_backend(backend, "pop_symbols")
    per_position = _position_tables(freq, n)
    k = freq.shape[-1]
    buf, under = st.buf, st.underflow
    out = torch.empty((n, st.s.shape[0]), dtype=_I64, device=buf.device)
    if backend == "kernel":
        s, ptr = u32.bits(st.s), st.ptr.to(_I32)
    else:
        s, ptr = st.s, st.ptr
    for t in range(n):
        f_t, c_t = (freq[t], cdf[t]) if per_position else (freq, cdf)
        if backend == "kernel":
            s, ptr, under, out[t] = _kernel_pop(s, ptr, under, buf, f_t, c_t,
                                                prob_bits)
            continue
        slot = s & ((1 << prob_bits) - 1)
        x, _ = search.find_symbol(c_t, k, slot)
        s, ptr, under = _pop_update(s, ptr, under, buf, slot,
                                    _gather(c_t[..., :-1], x),
                                    _gather(f_t, x), prob_bits)
        out[t] = x
    if backend == "kernel":
        s, ptr = u32.value(s), ptr.to(_I64)
    return StackState(s, buf, ptr, under), out.T


# ---------------------------------------------------------------------------
# observation codecs: continuous densities -> fixed-point bin codecs
# ---------------------------------------------------------------------------

def freq_cdf(probs: torch.Tensor, prob_bits: int = C.PROB_BITS):
    """``(..., K)`` probabilities -> BF16 storage -> quantized ``(freq
    (..., K), cdf (..., K+1))`` int32: one B6 launch over all rows for a
    CUDA tensor (``spc_quantize.spc_freq_cdf``), its plain version
    (``spc.freq_cdf_from_probs``) for a CPU tensor."""
    k = probs.shape[-1]
    lead = probs.shape[:-1]
    f, c = spc_quantize.spc_freq_cdf(
        spc.store_bf16(probs).reshape(-1, k), prob_bits)
    return f.reshape(lead + (k,)), c.reshape(lead + (k + 1,))


def std_gaussian_bins(n_bins: int):
    """Equal-mass bins of the standard normal: ``n_bins - 1`` interior
    edges at the quantiles and the per-bin mass centres, float32 on the
    CPU.  A ``N(0, 1)`` prior over these bins is exactly uniform."""
    i = np.arange(1, n_bins) / n_bins
    edges = torch.special.ndtri(torch.as_tensor(i, dtype=torch.float32))
    centres = torch.special.ndtri(torch.as_tensor(
        (np.arange(n_bins) + 0.5) / n_bins, dtype=torch.float32))
    return edges, centres


def _bin_mass(cdf: torch.Tensor) -> torch.Tensor:
    """Interior CDF values -> per-bin mass, the end bins taking the
    tails."""
    ones = torch.ones(cdf.shape[:-1] + (1,), dtype=torch.float32,
                      device=cdf.device)
    cdf = torch.cat([torch.zeros_like(ones), cdf, ones], -1)
    return cdf[..., 1:] - cdf[..., :-1]


def gaussian_bin_probs(mu: torch.Tensor, sigma: torch.Tensor,
                       edges: torch.Tensor) -> torch.Tensor:
    """``N(mu, sigma)`` mass per bin of ``edges`` (batched over leading
    dims; bins on the trailing axis)."""
    z = (edges - mu[..., None]) / sigma[..., None]
    return _bin_mass(torch.special.ndtr(z.to(torch.float32)))


def DiagGaussian(mu: torch.Tensor, sigma: torch.Tensor, edges: torch.Tensor,
                 prob_bits: int = C.PROB_BITS,
                 backend: str = "coder") -> Codec:
    """Diagonal-Gaussian codec over fixed bin edges (the bits-back
    posterior codec); ``mu``/``sigma`` are per-lane ``(lanes,)``."""
    f, c = freq_cdf(gaussian_bin_probs(mu, sigma, edges), prob_bits)
    return Categorical(f, c, prob_bits, backend=backend)


def logistic_bin_probs(mu: torch.Tensor, log_s: torch.Tensor,
                       n_bins: int) -> torch.Tensor:
    """Discretized-logistic mass over ``n_bins`` equal pixel bins of
    ``[-1, 1]``: interior edges through the logistic CDF, the end bins
    taking the open tails."""
    i = np.arange(1, n_bins) / n_bins
    edges = torch.as_tensor(2.0 * i - 1.0, dtype=torch.float32,
                            device=mu.device)
    inv_s = torch.exp(-log_s.to(torch.float32))
    z = (edges - mu[..., None].to(torch.float32)) * inv_s[..., None]
    return _bin_mass(torch.sigmoid(z))


def DiscretizedLogistic(mu: torch.Tensor, log_s: torch.Tensor, n_bins: int,
                        prob_bits: int = C.PROB_BITS,
                        backend: str = "coder") -> Codec:
    """Discretized-logistic codec over ``n_bins`` pixel levels in
    ``[-1, 1]`` units (the bits-back VAE's ``p(x|z)``)."""
    f, c = freq_cdf(logistic_bin_probs(mu, log_s, n_bins), prob_bits)
    return Categorical(f, c, prob_bits, backend=backend)
