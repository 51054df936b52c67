"""Scalar numpy/python golden rANS — the definitional reference implementation.

A copy of ``repro.core.golden`` (the port imports nothing from the JAX
package): the same inputs give the same bytes and symbols.  This is the
"software pipeline" whose bitstream the accelerator must reproduce
*bit-exactly* (paper Sec. V-B: "RAS reproduces the exact bitstreams of the
reference implementation").  It uses plain Python integers, the
textbook while-loop renormalization and direct // and % — no tricks — so it
serves as the oracle for:

  * the vectorized multi-lane coder (core/coder.py),
  * the CUDA kernels and their plain versions (kernels/),
  * the Fig. 4(a) phase of chip_smoke.py.

It also holds the stack cases of the frozen corpus
(``tests/golden_vectors/generate.py``'s ``STACK_CASES``, ``run_stack_case``,
``pop_stack_case`` and ``pack_stack_case``), run on the port's
:mod:`repro_torch.core.stack`: the same seeds push the same bytes.

Encode follows Eq. (1):  s' = floor(s/f) * 2**n + (s mod f) + C(x),
processing symbols in *reverse* (rANS is LIFO) and emitting renorm bytes
backward so the decoder reads forward.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

import torch

from repro_torch.core import bitstream, search, spc, stack
from repro_torch.core import constants as C


def encode(symbols: Sequence[int],
           freq: np.ndarray,
           cdf: np.ndarray,
           prob_bits: int = C.PROB_BITS) -> bytes:
    """Encode one lane of symbols.  Returns the forward-readable stream."""
    C.check_prob_bits(prob_bits)
    scale = C.x_max_scale(prob_bits)
    freq = np.asarray(freq)
    cdf = np.asarray(cdf)
    s = C.RANS_L
    rev: list[int] = []  # bytes in emission order (reverse of read order)
    for x in reversed(list(symbols)):
        f = int(freq[x])
        c = int(cdf[x])
        assert f >= 1, "zero frequency symbol is unencodable"
        x_max = scale * f
        while s >= x_max:
            rev.append(s & C.BYTE_MASK)
            s >>= C.RENORM_SHIFT
        s = ((s // f) << prob_bits) + (s % f) + c  # Eq. (1)
        assert C.RANS_L <= s < C.STATE_UPPER, s
    # 4-byte big-endian state header, read first by the decoder.
    head = [(s >> 24) & 0xFF, (s >> 16) & 0xFF, (s >> 8) & 0xFF, s & 0xFF]
    return bytes(head + rev[::-1])


def decode(stream: bytes,
           n_symbols: int,
           freq: np.ndarray,
           cdf: np.ndarray,
           prob_bits: int = C.PROB_BITS) -> np.ndarray:
    """Decode ``n_symbols`` from a forward stream.  Inverse of :func:`encode`."""
    C.check_prob_bits(prob_bits)
    mask = (1 << prob_bits) - 1
    freq = np.asarray(freq)
    cdf = np.asarray(cdf)
    k = len(freq)
    s = int.from_bytes(stream[:4], "big")
    ptr = 4
    out = np.empty(n_symbols, np.int64)
    for t in range(n_symbols):
        slot = s & mask
        # textbook binary search: find x with cdf[x] <= slot < cdf[x+1]
        lo, hi = 0, k
        while hi - lo > 1:
            mid = (lo + hi) >> 1
            if int(cdf[mid]) <= slot:
                lo = mid
            else:
                hi = mid
        x = lo
        out[t] = x
        s = int(freq[x]) * (s >> prob_bits) + slot - int(cdf[x])
        while s < C.RANS_L:
            s = (s << C.RENORM_SHIFT) | stream[ptr]
            ptr += 1
    return out


def encode_per_position(symbols: Sequence[int],
                        freq: np.ndarray,   # (T, K)
                        cdf: np.ndarray,    # (T, K+1)
                        prob_bits: int = C.PROB_BITS) -> bytes:
    """Adaptive variant: position t uses its own table row (neural priors)."""
    C.check_prob_bits(prob_bits)
    scale = C.x_max_scale(prob_bits)
    s = C.RANS_L
    rev: list[int] = []
    for t in range(len(symbols) - 1, -1, -1):
        x = int(symbols[t])
        f = int(freq[t, x])
        c = int(cdf[t, x])
        x_max = scale * f
        while s >= x_max:
            rev.append(s & C.BYTE_MASK)
            s >>= C.RENORM_SHIFT
        s = ((s // f) << prob_bits) + (s % f) + c
    head = [(s >> 24) & 0xFF, (s >> 16) & 0xFF, (s >> 8) & 0xFF, s & 0xFF]
    return bytes(head + rev[::-1])


def decode_per_position(stream: bytes,
                        freq: np.ndarray,   # (T, K)
                        cdf: np.ndarray,    # (T, K+1)
                        prob_bits: int = C.PROB_BITS) -> np.ndarray:
    C.check_prob_bits(prob_bits)
    mask = (1 << prob_bits) - 1
    n_symbols, k = freq.shape
    s = int.from_bytes(stream[:4], "big")
    ptr = 4
    out = np.empty(n_symbols, np.int64)
    for t in range(n_symbols):
        slot = s & mask
        lo, hi = 0, k
        while hi - lo > 1:
            mid = (lo + hi) >> 1
            if int(cdf[t, mid]) <= slot:
                lo = mid
            else:
                hi = mid
        x = lo
        out[t] = x
        s = int(freq[t, x]) * (s >> prob_bits) + slot - int(cdf[t, x])
        while s < C.RANS_L:
            s = (s << C.RENORM_SHIFT) | stream[ptr]
            ptr += 1
    return out


# ---------------------------------------------------------------------------
# stack cases: flushed-stack streams of the push/pop interface (uniform,
# NonUniform statfun, serial, and a bits-back schedule drawing on initial
# bits), frozen as tests/golden_vectors/stack_*.ras
# ---------------------------------------------------------------------------

STACK_CASES = [
    dict(name="stack_uniform", seed=51, lanes=4, cap=256, bits=6, t=24,
         init_bytes=0),
    dict(name="stack_nonuniform", seed=52, lanes=4, cap=256, k=16, t=24,
         init_bytes=0),
    dict(name="stack_serial", seed=53, lanes=4, cap=256, k=16, t=10,
         init_bytes=0),
    dict(name="stack_bitsback", seed=54, lanes=4, cap=256, k=16, kx=32,
         t=12, init_bytes=48),
]


def _dirichlet_tables(rng, k: int, lanes: int | None = None, device="cpu"):
    """Seeded quantized ``(freq, cdf)`` through the BF16 storage path."""
    probs = rng.dirichlet(np.full(k, 0.5),
                          size=None if lanes is None else (lanes,))
    f, c = spc.freq_cdf_from_probs(spc.store_bf16(
        torch.as_tensor(probs.astype(np.float32))))
    return f.to(device), c.to(device)


def _nonuniform_codec(freq, cdf):
    """A statfun-driven codec (``stack.NonUniform``, not ``Categorical``)
    over quantized planes, so the statfun entry point is pinned too."""
    k = freq.shape[-1]

    def enc_statfun(x):
        return stack._gather(cdf[..., :-1], x), stack._gather(freq, x)

    def dec_statfun(slot):
        return search.find_symbol(cdf, k, slot)[0]

    return stack.NonUniform(enc_statfun, dec_statfun)


def _col(a: np.ndarray, i: int, device) -> torch.Tensor:
    return torch.as_tensor(a[:, i].astype(np.int64), device=device)


def run_stack_case(case: dict, backend: str = "coder", device="cpu"):
    """A stack case's push schedule.  Returns ``(st0, st, aux)``: the
    initial and the pushed stack, and the symbols and tables the pop
    schedule needs.  ``backend`` is how the bits-back case's encode-time
    pops run; both land the same bytes."""
    rng = np.random.default_rng(case["seed"])
    lanes, cap, t = case["lanes"], case["cap"], case["t"]
    st0 = (stack.stack_init_bits(lanes, cap, n_bytes=case["init_bytes"],
                                 seed=case["seed"], device=device)
           if case["init_bytes"] else stack.stack_init(lanes, cap, device))
    st = st0
    if case["name"] == "stack_uniform":
        x = rng.integers(0, 1 << case["bits"], (lanes, t)).astype(np.int32)
        codec = stack.Uniform(case["bits"])
        for i in reversed(range(t)):     # LIFO: push reversed, pop forward
            st = codec.push(st, _col(x, i, device))
        return st0, st, {"x": x}
    if case["name"] == "stack_nonuniform":
        freq, cdf = _dirichlet_tables(rng, case["k"], device=device)
        x = rng.integers(0, case["k"], (lanes, t)).astype(np.int32)
        codec = _nonuniform_codec(freq, cdf)
        for i in reversed(range(t)):
            st = codec.push(st, _col(x, i, device))
        return st0, st, {"x": x, "freq": freq, "cdf": cdf}
    if case["name"] == "stack_serial":
        freq, cdf = _dirichlet_tables(rng, case["k"], device=device)
        xa = rng.integers(0, 1 << 4, (lanes, t)).astype(np.int32)
        xb = rng.integers(0, case["k"], (lanes, t)).astype(np.int32)
        xc = rng.integers(0, 1 << 6, (lanes, t)).astype(np.int32)
        codec = stack.serial([stack.Uniform(4),
                              stack.Categorical(freq, cdf),
                              stack.Uniform(6)])
        for i in reversed(range(t)):
            st = codec.push(st, tuple(_col(v, i, device)
                                      for v in (xa, xb, xc)))
        return st0, st, {"x": (xa, xb, xc), "freq": freq, "cdf": cdf}
    # stack_bitsback: per step pop k ~ q (posterior, per-lane tables,
    # drawing on the initial bits), push x ~ p, push k ~ Uniform prior
    qf, qc = _dirichlet_tables(rng, case["k"], lanes=lanes, device=device)
    pf, pc = _dirichlet_tables(rng, case["kx"], device=device)
    x = rng.integers(0, case["kx"], (lanes, t)).astype(np.int32)
    bits = int(np.log2(case["k"]))
    q = stack.Categorical(qf, qc, backend=backend)
    p = stack.Categorical(pf, pc, backend=backend)
    u = stack.Uniform(bits)
    ks = []
    for i in range(t):
        st, k_i = q.pop(st)
        ks.append(k_i.cpu().numpy())
        st = p.push(st, _col(x, i, device))
        st = u.push(st, k_i)
    if bool(st.underflow.any()):
        raise RuntimeError("bits-back case under-seeded")
    return st0, st, {"x": x, "k": np.stack(ks, axis=1), "bits": bits,
                     "tables": (qf, qc, pf, pc)}


def pop_stack_case(case: dict, st, aux, backend: str = "coder"):
    """The matching pop schedule; returns ``(state, symbols)`` shaped like
    the aux record (numpy)."""
    t = case["t"]
    if case["name"] == "stack_uniform":
        codec = stack.Uniform(case["bits"])
    elif case["name"] == "stack_nonuniform":
        codec = (stack.Categorical(aux["freq"], aux["cdf"], backend="kernel")
                 if backend == "kernel"
                 else _nonuniform_codec(aux["freq"], aux["cdf"]))
    elif case["name"] == "stack_serial":
        codec = stack.serial([stack.Uniform(4),
                              stack.Categorical(aux["freq"], aux["cdf"],
                                                backend=backend),
                              stack.Uniform(6)])
    else:  # stack_bitsback: the exact reverse schedule restores the bits
        qf, qc, pf, pc = aux["tables"]
        q = stack.Categorical(qf, qc, backend=backend)
        p = stack.Categorical(pf, pc, backend=backend)
        u = stack.Uniform(aux["bits"])
        xs, ks = [], []
        for _ in range(t):
            st, k_i = u.pop(st)
            st, x_i = p.pop(st)
            st = q.push(st, k_i)
            xs.append(x_i.cpu().numpy())
            ks.append(k_i.cpu().numpy())
        return st, {"x": np.stack(xs[::-1], axis=1),
                    "k": np.stack(ks[::-1], axis=1)}
    xs = []
    for _ in range(t):
        st, x_i = codec.pop(st)
        xs.append(x_i)
    if case["name"] == "stack_serial":
        return st, tuple(np.stack([x[j].cpu().numpy() for x in xs], axis=1)
                         for j in range(3))
    return st, np.stack([x.cpu().numpy() for x in xs], axis=1)


def pack_stack_case(case: dict, backend: str = "coder") -> bytes:
    """Push schedule -> flushed stack -> v1 container bytes (the frozen
    wire artifact)."""
    _, st, _ = run_stack_case(case, backend)
    return bitstream.pack(*stack.stack_flush(st), n_symbols=case["t"])
