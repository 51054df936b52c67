"""rANS decode kernels and their plain versions.

Three TPU kernels of ``repro/kernels/rans_decode.py`` are ported here:

* **B2** :func:`rans_decode_step` (``csrc/rans_decode_step.cu``, replaces
  ``rans_decode_step``, body ``_decode_step_kernel``): one pop per lane
  with the coder state ``(s, ptr)`` held by the caller, the fused serve
  decode's building block, called once per position with that step's
  freshly quantized rows and model top-k candidates.  It takes ``buf
  (lanes, cap)`` uint8 lane-major streams (the reference takes ``(cap,
  lanes)``; outputs match), ``s`` int32 bit patterns of the uint32 states,
  ``ptr`` int32 cursors, ``freq`` ``(K,)`` or ``(lanes, K)`` and ``cdf``
  ``(K+1,)`` or ``(lanes, K+1)`` int32 rows and optional ``(lanes, topk)``
  candidates, and returns ``(s', ptr', symbols, probes, under)``, all
  ``(lanes,)`` int32; ``under`` counts active refills outside the lane's
  window.  Its kernel gives each lane a warp.  On rows of up to
  ``autotune.STEP_REG_K`` (380) entries the cdf row, the state and the two
  refill bytes are two dependent load levels, a ballot count over the row
  gives the symbol and the probes are replayed from it, so a step costs
  about twice the launch floor of a graph node (0.0021 against 0.0011 ms
  on an H100, ``PERF.md``), and the wrapper's host work is ten times that.
  Longer rows (the zoo's K = 32,064 to 50,280) run the reference's search
  itself, the warp loading the next five bisection levels' mids at once.
  ``f`` comes from the ``freq`` row on every path, as in the reference, so
  a pair whose ``freq`` is not the cdf's differences decodes as the
  reference decodes it.
* **B3** :func:`rans_decode_lanes` (``csrc/rans_decode_lanes.cu``, replaces
  ``rans_decode_lanes``, body ``_decode_kernel``): the whole stream in one
  launch, monolithic ``(lanes, cap)`` or chunked ``(n_chunks, lanes,
  cap)``, with static, per-position or per-lane tables, the in-kernel
  predictors and ``(T, lanes, topk)`` candidate planes.  Returns
  ``(symbols (lanes, T), probes (n_chunks, lanes), under (n_chunks,
  lanes))``, all int32.
* **B4** :func:`rans_decode_slab` (the same source, replaces
  ``rans_decode_slab``): B3 read straight off a packed container payload
  ``(S,)`` through per-(chunk, lane) windows ``base``/``wstart``/``wlen``
  that :func:`repro_torch.kernels.ops.slab_planes` derives.

Each wrapper runs its plain version for CPU tensors and launches its
kernel for CUDA tensors, counting the launch in
``repro_torch.kernels.LAUNCHES``; there is no fallback between the two.
The plain versions are built on :mod:`repro_torch.core.coder` (``pop`` and
``decode_grid``), so one implementation answers to the reference's tests.
B3 and B4 walk a serial chain per (chunk, lane) cell with few cells live,
so they are latency-bound (``PERF.md``).  Their kernel takes the symbol
from a slot table (static tables) or a warp-wide row count (rows in device
memory) and replays the probe count from it; a table with a zero frequency
runs the exact bisection instead.  B2 runs the warp row count or, on a row
with a zero frequency, the bisection, on rows in registers, and the
read-ahead bisection on longer rows.  Each launch of B2, B3 or B4 records
which of those code paths ran in ``repro_torch.kernels.BRANCHES``, read by
:func:`last_branches`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import constants as C
from repro_torch.core import coder, search, u32
from repro_torch.core.predictors import (LastValue, NeighborAverage,
                                         ZeroPredictor)
from repro_torch.core.spc import FreqCdf
from repro_torch.kernels import BRANCHES, LAUNCHES, autotune

# the kernels' window and K limits (kernels/autotune.py, the launch plan)
MAX_WINDOW = autotune.MAX_WINDOW
MAX_K = autotune.DECODE_MAX_K
# the Branch bits of csrc/rans_decode_lanes.cu (B2's rans_decode_step.cu
# uses the last two and one of its own): the slot-table path, the exact
# bisection on a static table in shared memory, the warp row search, the
# warp path's exact bisection of a row, and B2's bisection of a row too
# long for its registers, read ahead by the warp
BRANCH_BITS = {"slot_table": 1, "shared_bisect": 2, "warp_rows": 4,
               "warp_bisect": 8, "tree_bisect": 16}

_I64 = torch.int64
_I32 = torch.int32


def _check_shapes(buf, freq, cdf, candidates):
    lanes = buf.shape[0]
    k = freq.shape[-1]
    if freq.ndim == 2 and freq.shape[0] != lanes:
        raise ValueError(f"per-lane tables must be (lanes, K)=({lanes}, {k});"
                         f" got {tuple(freq.shape)}")
    if freq.ndim not in (1, 2) or cdf.shape != freq.shape[:-1] + (k + 1,):
        raise ValueError(f"freq/cdf rows must be (K,)/(K+1,) or "
                         f"(lanes, K)/(lanes, K+1); got {tuple(freq.shape)} "
                         f"and {tuple(cdf.shape)}")
    if candidates is not None and candidates.shape[0] != lanes:
        raise ValueError(f"candidate row must be (lanes, topk)=({lanes}, *);"
                         f" got {tuple(candidates.shape)}")
    return lanes, k


def rans_decode_step_plain(buf, s, ptr, freq, cdf,
                           prob_bits: int = C.PROB_BITS, candidates=None):
    """Plain PyTorch version of the kernel: the pure-torch coder's pop."""
    _check_shapes(buf, freq, cdf, candidates)
    s, ptr, x, probes, under = coder.pop(buf, u32.value(s), ptr.to(_I64),
                                         freq, cdf, prob_bits, candidates)
    return (u32.bits(s), ptr.to(_I32), x.to(_I32), probes.to(_I32),
            under.to(_I32))


_STEP_FNS = {}     # B2's resolved ctypes launchers, by entry point


def _step_fn(entry: str):
    if entry not in _STEP_FNS:
        from repro_torch.kernels import _build
        fn = getattr(_build.load("rans_decode_step"), entry)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, p, p, p, p, ll, ll, i, p, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
        _STEP_FNS[entry] = (fn, _build.check, _build.stream)
    return _STEP_FNS[entry]


def _launch(buf, s, ptr, freq, cdf, prob_bits, candidates,
            entry="rans_decode_step_launch"):
    lanes, k = _check_shapes(buf, freq, cdf, candidates)
    dev = buf.device
    for name, t, dt in (("buf", buf, torch.uint8), ("s", s, _I32),
                        ("ptr", ptr, _I32), ("freq", freq, _I32),
                        ("cdf", cdf, _I32), ("candidates", candidates, _I32)):
        if t is not None and (t.device != dev or t.dtype != dt
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev}; got {t.dtype} on {t.device}")
    topk = 0 if candidates is None else candidates.shape[1]
    per_lane = freq.ndim == 2
    fn, check, stream = _step_fn(entry)
    # rows s', ptr', symbols, probes, under and the path each lane ran
    out = torch.empty((6, lanes), dtype=_I32, device=dev)
    err = fn(buf.data_ptr(), buf.shape[1], s.data_ptr(), ptr.data_ptr(),
             freq.data_ptr(), cdf.data_ptr(), k if per_lane else 0,
             k + 1 if per_lane else 0, k,
             candidates.data_ptr() if topk else None, topk, lanes, prob_bits,
             search.ceil_log2(k), out.data_ptr(), stream(dev))
    check(err, entry)
    return out


def rans_decode_step_floor(buf, s, ptr, freq, cdf,
                           prob_bits: int = C.PROB_BITS, candidates=None):
    """Launch an empty kernel exactly as :func:`rans_decode_step` launches
    B2 (same checks, output allocation, grid, block and arguments; CUDA
    tensors only): the launch floor B2's time is measured against.  Not a
    kernel of the path, so it counts no launch."""
    _launch(buf, s, ptr, freq, cdf, prob_bits, candidates,
            "rans_decode_step_floor_launch")


def rans_decode_step(buf: torch.Tensor, s: torch.Tensor, ptr: torch.Tensor,
                     freq: torch.Tensor, cdf: torch.Tensor,
                     prob_bits: int = C.PROB_BITS,
                     candidates: torch.Tensor | None = None):
    """Pop one symbol per lane; the coder state lives with the caller."""
    if candidates is not None and candidates.shape[-1] == 0:
        candidates = None
    if buf.device.type == "cpu":
        return rans_decode_step_plain(buf, s, ptr, freq, cdf, prob_bits,
                                      candidates)
    if buf.device.type == "cuda":
        out = _launch(buf, s, ptr, freq, cdf, prob_bits, candidates)
        LAUNCHES["rans_decode_step"] += 1
        *rows, BRANCHES["rans_decode_step"] = out.unbind(0)
        return tuple(rows)
    raise ValueError(f"unsupported device {buf.device}")


# ---------------------------------------------------------------------------
# B3 and B4: the full-stream decode
# ---------------------------------------------------------------------------

def _chunk_geometry(n_chunks: int, t_len: int, chunk_size: int) -> int:
    """Check the stream's chunk count (the one check on the decode paths)
    and return the chunk length."""
    if t_len <= 0:
        raise ValueError("the full-stream decode needs t_len > 0 (ops "
                         "handles t_len == 0)")
    coder.check_chunk_count(n_chunks, t_len, chunk_size)
    return min(chunk_size, t_len)


def _stream3(buf, start, t_len, chunk_size):
    """Monolithic ``(lanes, cap)`` or chunked ``(n_chunks, lanes, cap)``
    streams -> the chunked form and its chunk length."""
    if buf.ndim == 2:
        if chunk_size is not None:
            raise ValueError("monolithic (lanes, cap) stream cannot take a "
                             "chunk_size; pass a (n_chunks, lanes, cap) buf")
        buf, start, chunk_size = buf[None], start.reshape(1, -1), t_len
    elif buf.ndim == 3:
        if chunk_size is None:
            raise ValueError("chunked (n_chunks, lanes, cap) stream needs "
                             "chunk_size")
    else:
        raise ValueError(f"unsupported stream rank {buf.ndim}")
    return buf, start, _chunk_geometry(buf.shape[0], t_len, chunk_size)


def _slab_windows(slab, base, wstart, wlen, cap):
    """The clamped per-cell windows of B4: column ``p`` of cell (c, l) is
    ``slab[base + p]`` inside the span ``[wstart, wstart + wlen)`` and 0
    outside it.  Returns ``(windows (n_chunks, lanes, cap), wstart,
    limit)`` with int64 ``wstart`` and ``limit = wstart + wlen``."""
    col = torch.arange(cap, dtype=_I64, device=slab.device)
    ws = wstart.to(_I64)
    limit = ws + wlen.to(_I64)
    live = (col >= ws[..., None]) & (col < limit[..., None])
    win = slab[base.to(_I64)[..., None] + col]
    return torch.where(live, win, torch.zeros_like(win)), ws, limit


def _plain_out(sym, probes, under):
    return sym.to(_I32), probes.to(_I32), under.to(_I32)


def rans_decode_lanes_plain(buf, start, freq, cdf, t_len: int,
                            chunk_size: int | None = None,
                            prob_bits: int = C.PROB_BITS, predictor=None,
                            candidates=None):
    """Plain PyTorch version of B3: the pure-torch coder's cell grid."""
    buf3, start2, chunk = _stream3(buf, start, t_len, chunk_size)
    return _plain_out(*coder.decode_grid(
        buf3, start2, t_len, chunk, FreqCdf(freq, cdf), prob_bits,
        predictor, candidates))


def rans_decode_slab_plain(slab, base, wstart, wlen, freq, cdf, *, cap: int,
                           t_len: int, chunk_size: int,
                           prob_bits: int = C.PROB_BITS, predictor=None,
                           candidates=None):
    """Plain PyTorch version of B4: the clamped windows built in torch,
    then the coder's cell grid with the per-cell limit ``wstart + wlen``."""
    chunk = _chunk_geometry(base.shape[0], t_len, chunk_size)
    win, ws, limit = _slab_windows(slab, base, wstart, wlen, cap)
    return _plain_out(*coder.decode_grid(
        win, ws, t_len, chunk, FreqCdf(freq, cdf), prob_bits, predictor,
        candidates, limit=limit))


def _predictor_args(predictor) -> tuple[int, int, int]:
    """A predictor config -> the kernel's ``(kind, window, delta)``."""
    if predictor is None:
        return 0, 0, 0
    if not -2 ** 31 < predictor.delta < 2 ** 31:
        raise ValueError(f"predictor delta {predictor.delta} does not fit "
                         "the CUDA decode kernel's int32")
    if isinstance(predictor, NeighborAverage):
        if not 1 <= predictor.window <= MAX_WINDOW:
            raise ValueError(
                f"NeighborAverage window {predictor.window} is outside the "
                f"CUDA decode kernel's [1, {MAX_WINDOW}]")
        return 1, predictor.window, predictor.delta
    if isinstance(predictor, LastValue):
        return 2, 1, predictor.delta
    if isinstance(predictor, ZeroPredictor):
        return 3, 0, predictor.delta
    raise TypeError(f"the CUDA decode kernel has no form of predictor "
                    f"{predictor!r}")


def _table_strides(layout: str, lanes: int, width: int) -> tuple[int, int]:
    return {"static": (0, 0), "perpos": (width, 0),
            "lane": (lanes * width, width)}[layout]


def _load_full(name: str):
    from repro_torch.kernels import _build
    fn = getattr(_build.load("rans_decode_lanes"), name + "_launch")
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        src = [p, p, i] if name == "rans_decode_lanes" else [p, p, p, p, i]
        fn.argtypes = src + [p, p, ll, ll, ll, ll, i, p, i, i, i, i, i, i,
                             i, i, i, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn, _build.check


def _launch_full(name, src_args, dev, lanes, t_len, chunk, n_chunks, freq,
                 cdf, prob_bits, predictor, candidates):
    """Launch B3 or B4 on ``src_args`` (pointer/int arguments of the byte
    source); tables, candidates and outputs are common."""
    layout = coder.table_layout(freq, t_len, lanes)
    k = freq.shape[-1]
    if k >= MAX_K:
        raise ValueError(f"alphabet of {k} symbols exceeds the CUDA decode "
                         f"kernel's {MAX_K - 1}")
    if tuple(cdf.shape) != tuple(freq.shape[:-1]) + (k + 1,):
        raise ValueError(f"cdf must be {tuple(freq.shape[:-1]) + (k + 1,)}; "
                         f"got {tuple(cdf.shape)}")
    for name_, t in (("freq", freq), ("cdf", cdf)):
        if t.device != dev or t.dtype != _I32 or not t.is_contiguous():
            raise ValueError(f"{name_} must be a contiguous int32 tensor on "
                             f"{dev}; got {t.dtype} on {t.device}")
    topk = 0
    if candidates is not None and candidates.shape[-1] > 0:
        if tuple(candidates.shape[:2]) != (t_len, lanes):
            raise ValueError(
                f"candidate planes must be (T, lanes, topk)=({t_len}, "
                f"{lanes}, *); got {tuple(candidates.shape)}")
        if candidates.device != dev:
            raise ValueError(f"candidates must be on {dev}")
        candidates = candidates.to(_I32).contiguous()
        topk = candidates.shape[-1]
    kind, window, delta = _predictor_args(predictor)
    fn, check = _load_full(name)
    sym = torch.empty((lanes, t_len), dtype=_I32, device=dev)
    probes = torch.empty((n_chunks, lanes), dtype=_I32, device=dev)
    under = torch.empty_like(probes)
    branch = torch.zeros((1,), dtype=_I32, device=dev)
    err = fn(*src_args, freq.data_ptr(), cdf.data_ptr(),
             *_table_strides(layout, lanes, k),
             *_table_strides(layout, lanes, k + 1), k,
             candidates.data_ptr() if topk else None, topk, lanes, t_len,
             chunk, n_chunks, prob_bits, search.ceil_log2(k), kind, window,
             delta, sym.data_ptr(), probes.data_ptr(), under.data_ptr(),
             branch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, name)
    LAUNCHES[name] += 1
    BRANCHES[name] = branch
    return sym, probes, under


def last_branches(name: str) -> set[str]:
    """The code paths (``BRANCH_BITS`` names) that the last launch of B2
    (``"rans_decode_step"``, one entry per lane), B3
    (``"rans_decode_lanes"``) or B4 (``"rans_decode_slab"``) ran; reading
    them waits for that launch."""
    bits = 0
    for v in BRANCHES[name].unique().tolist():
        bits |= v
    return {b for b, v in BRANCH_BITS.items() if bits & v}


def _device_of(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def rans_decode_lanes(buf: torch.Tensor, start: torch.Tensor,
                      freq: torch.Tensor, cdf: torch.Tensor, t_len: int,
                      chunk_size: int | None = None,
                      prob_bits: int = C.PROB_BITS, predictor=None,
                      candidates: torch.Tensor | None = None):
    """Decode ``t_len`` symbols per lane in one launch (B3).

    ``buf`` is ``(lanes, cap)`` (monolithic; no ``chunk_size``) or
    ``(n_chunks, lanes, cap)`` (every (chunk, lane) cell standalone) uint8
    with matching ``start``; tables static ``(K,)``, per-position ``(T, K)``
    or per-lane ``(T, lanes, K)`` int32 with ``cdf`` one wider; ``predictor``
    a :mod:`repro_torch.core.predictors` config; ``candidates`` an optional
    ``(T, lanes, topk)`` plane.  Returns int32 ``(symbols (lanes, T),
    probes (n_chunks, lanes), under (n_chunks, lanes))``.
    """
    if _device_of(buf) == "cpu":
        return rans_decode_lanes_plain(buf, start, freq, cdf, t_len,
                                       chunk_size, prob_bits, predictor,
                                       candidates)
    buf3, start2, chunk = _stream3(buf, start, t_len, chunk_size)
    n_chunks, lanes, cap = buf3.shape
    if buf3.dtype != torch.uint8:
        raise ValueError(f"buf must be uint8; got {buf3.dtype}")
    buf3 = buf3.contiguous()
    start2 = start2.to(device=buf.device, dtype=_I32).contiguous()
    return _launch_full("rans_decode_lanes",
                        (buf3.data_ptr(), start2.data_ptr(), cap),
                        buf.device, lanes, t_len, chunk, n_chunks, freq, cdf,
                        prob_bits, predictor, candidates)


def rans_decode_slab(slab: torch.Tensor, base: torch.Tensor,
                     wstart: torch.Tensor, wlen: torch.Tensor,
                     freq: torch.Tensor, cdf: torch.Tensor, *, cap: int,
                     t_len: int, chunk_size: int,
                     prob_bits: int = C.PROB_BITS, predictor=None,
                     candidates: torch.Tensor | None = None):
    """Decode a chunked stream straight off a packed payload slab (B4).

    ``slab`` ``(S,)`` uint8 with ``S >= cap``; ``base``/``wstart``/``wlen``
    ``(n_chunks, lanes)`` int32, ``base`` clipped to ``[0, S - cap]`` and
    ``wstart = offset - base`` (:func:`repro_torch.kernels.ops.slab_planes`
    derives all three from a validated container).  Cell (c, l) reads
    window column ``p`` as ``slab[base + p]`` inside its span ``[wstart,
    wstart + wlen)`` and as 0 outside it; reads at or past ``wstart +
    wlen`` count in ``under``.  Returns what :func:`rans_decode_lanes`
    returns.
    """
    if _device_of(slab) == "cpu":
        return rans_decode_slab_plain(
            slab, base, wstart, wlen, freq, cdf, cap=cap, t_len=t_len,
            chunk_size=chunk_size, prob_bits=prob_bits, predictor=predictor,
            candidates=candidates)
    n_chunks, lanes = base.shape
    chunk = _chunk_geometry(n_chunks, t_len, chunk_size)
    if slab.dtype != torch.uint8 or slab.ndim != 1 or slab.shape[0] < cap:
        raise ValueError(f"slab must be a (S >= cap={cap},) uint8 tensor; "
                         f"got {slab.dtype} {tuple(slab.shape)}")
    if slab.shape[0] >= 2 ** 31:
        raise ValueError(f"slab of {slab.shape[0]} bytes exceeds the int32 "
                         "index range of the slab decode")
    planes = []
    for name_, t in (("base", base), ("wstart", wstart), ("wlen", wlen)):
        if tuple(t.shape) != (n_chunks, lanes) or t.device != slab.device:
            raise ValueError(f"{name_} must be ({n_chunks}, {lanes}) on "
                             f"{slab.device}; got {tuple(t.shape)} on "
                             f"{t.device}")
        planes.append(t.to(_I32).contiguous())
    base, wstart, wlen = planes
    slab = slab.contiguous()
    return _launch_full("rans_decode_slab",
                        (slab.data_ptr(), base.data_ptr(), wstart.data_ptr(),
                         wlen.data_ptr(), cap),
                        slab.device, lanes, t_len, chunk, n_chunks, freq, cdf,
                        prob_bits, predictor, candidates)
