"""One rANS symbol pop per lane: the CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/rans_decode.py::rans_decode_step``
(body ``_decode_step_kernel``), the fused serve decode's building block:
the model is autoregressive over its own decoded tokens, so the serve loop
carries the coder state ``(s, ptr)`` and calls this once per position with
that step's just-quantized tables and model top-k candidates.

:func:`rans_decode_step` takes ``buf (lanes, cap)`` uint8 lane-major
streams (the reference takes ``(cap, lanes)``; outputs match), ``s`` int32
bit patterns of the uint32 states, ``ptr`` int32 cursors, ``freq`` ``(K,)``
or ``(lanes, K)`` and ``cdf`` ``(K+1,)`` or ``(lanes, K+1)`` int32 rows and
optional ``(lanes, topk)`` candidates.  It returns ``(s', ptr', symbols,
probes, under)``, all ``(lanes,)`` int32; ``under`` counts active refills
that read outside the lane's window: past the stream end for any state
``coder.decoder_init`` gives (the reference counts only reads past the end,
the same thing there).  A CPU tensor runs
:func:`rans_decode_step_plain`; a CUDA tensor launches
``csrc/rans_decode_step.cu`` and counts the launch in :data:`LAUNCHES`.

On this card one step is a few dozen dependent loads per lane, nanoseconds
of memory traffic, so the launch itself bounds it: one launch per position
dominates.  The kernel reads tables and stream bytes straight from global
memory; CUDA graphs or fusing the SPC and top-k into the step are later
work.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import constants as C
from repro_torch.core import coder, search, u32

LAUNCHES = 0

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


def _load():
    from repro_torch.kernels import _build
    lib = _build.load("rans_decode_step")
    fn = lib.rans_decode_step_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, p, p, p, p, ll, ll, i, p, i, i, i, i,
                       p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn, _build.check


def _launch(buf, s, ptr, freq, cdf, prob_bits, candidates):
    global LAUNCHES
    lanes, k = _check_shapes(buf, freq, cdf, candidates)
    dev = buf.device
    ins = {"buf": (buf, torch.uint8), "s": (s, _I32), "ptr": (ptr, _I32),
           "freq": (freq, _I32), "cdf": (cdf, _I32)}
    if candidates is not None:
        ins["candidates"] = (candidates, _I32)
    for name, (t, dt) in ins.items():
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev}; got {t.dtype} on {t.device}")
    topk = 0 if candidates is None else candidates.shape[1]
    per_lane = freq.ndim == 2
    fn, check = _load()
    outs = [torch.empty((lanes,), dtype=_I32, device=dev) for _ in range(5)]
    err = fn(buf.data_ptr(), buf.shape[1], s.data_ptr(), ptr.data_ptr(),
             freq.data_ptr(), cdf.data_ptr(), k if per_lane else 0,
             k + 1 if per_lane else 0, k,
             candidates.data_ptr() if topk else None, topk, lanes, prob_bits,
             search.ceil_log2(k), *(o.data_ptr() for o in outs),
             torch.cuda.current_stream(dev).cuda_stream)
    check(err, "rans_decode_step")
    LAUNCHES += 1
    return tuple(outs)


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
        return _launch(buf, s, ptr, freq, cdf, prob_bits, candidates)
    raise ValueError(f"unsupported device {buf.device}")
