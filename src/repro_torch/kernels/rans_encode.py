"""Multi-lane chunked rANS encode: the CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/rans_encode.py::rans_encode_lanes``
(body ``_encode_fused_kernel``).  :func:`rans_encode_lanes` takes ``(lanes,
T)`` symbols and a TableSet-like object (the five encoder planes, int32
bit patterns) in one of three layouts, static ``(K,)``, per-position
``(T, K)`` or per-lane ``(T, lanes, K)``, and returns the
``ChunkedLanes``-layout planes ``(buf (n_chunks, lanes, cap) uint8, start,
length (n_chunks, lanes) int32, overflow (n_chunks, lanes) bool)``.  Every
(chunk, lane) cell is a standalone stream: state and cursor reset per
chunk, writes past the head drop and are flagged, bytes outside the span
are 0.

It dispatches on the symbols' device: a CPU tensor runs
:func:`rans_encode_lanes_plain`, a CUDA tensor launches
``csrc/rans_encode.cu`` (built by ``kernels/_build.py``) and counts the
launch in :data:`LAUNCHES`.  There is no fallback between the two.

On this card the kernel is latency-bound: each thread runs a chain of
``chunk_size`` dependent steps and only ``n_chunks * lanes`` threads are
live (512 at the ras-pimc main-path shapes), while its byte bound is about
24 B gathered and at most 2 B written per (t, lane).  The design writes
bytes straight to global memory through the cursor: the TPU's one-hot
scatter, byte ring and VMEM autotuner have no role here.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import coder, update

LAUNCHES = 0



def _layout(tbl, lanes: int, t_len: int) -> str:
    """Validate the table layout; returns "static" | "perpos" | "lane"."""
    f = tbl.x_max
    k = f.shape[-1]
    if f.ndim == 1:
        return "static"
    if f.ndim == 2 and f.shape[0] == t_len:
        return "perpos"
    if f.ndim == 3 and f.shape[:2] == (t_len, lanes):
        return "lane"
    raise ValueError(
        f"encoder tables must be (K,), (T, K) or (T, lanes, K) with "
        f"T={t_len}, lanes={lanes}, K={k}; got {tuple(f.shape)}")


def _strides(layout: str, lanes: int, k: int) -> tuple[int, int]:
    """Element strides (per row t, per lane) of a plane, K contiguous."""
    return {"static": (0, 0), "perpos": (k, 0),
            "lane": (lanes * k, k)}[layout]


def _geometry(t_len: int, chunk_size: int | None) -> tuple[int, int]:
    chunk = t_len if chunk_size is None else chunk_size
    if chunk <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk}")
    chunk = min(chunk, t_len)
    return chunk, -(-t_len // chunk)


def rans_encode_lanes_plain(symbols: torch.Tensor, tbl, cap: int,
                            chunk_size: int | None = None):
    """Plain PyTorch version of the kernel: the pure-torch coder's chunked
    encode, with the kernel's symbol clip."""
    lanes, t_len = symbols.shape
    _layout(tbl, lanes, t_len)
    chunk, _ = _geometry(t_len, chunk_size)
    k = tbl.x_max.shape[-1]
    return tuple(coder.encode_chunked(symbols.clamp(0, k - 1), tbl, chunk,
                                      cap=cap))


def _load():
    from repro_torch.kernels import _build
    lib = _build.load("rans_encode")
    fn = lib.rans_encode_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, ll, ll, i, i, i, i, i, i,
                       p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn, _build.check


def _launch(symbols: torch.Tensor, tbl, cap: int, chunk_size: int | None):
    global LAUNCHES
    lanes, t_len = symbols.shape
    layout = _layout(tbl, lanes, t_len)
    chunk, n_chunks = _geometry(t_len, chunk_size)
    planes = update.encode_planes(tbl)
    k = planes.x_max.shape[-1]
    stride_t, stride_l = _strides(layout, lanes, k)
    dev = symbols.device
    for name, p in zip(planes._fields, planes):
        if p.device != dev or p.dtype != torch.int32 or not p.is_contiguous():
            raise ValueError(f"table plane {name} must be a contiguous int32 "
                             f"tensor on {dev}; got {p.dtype} on {p.device}")
    if symbols.dtype != torch.int32 or not symbols.is_contiguous():
        raise ValueError("symbols must be a contiguous int32 tensor")
    fn, check = _load()
    buf = torch.zeros((n_chunks, lanes, cap), dtype=torch.uint8, device=dev)
    start = torch.empty((n_chunks, lanes), dtype=torch.int32, device=dev)
    length = torch.empty_like(start)
    overflow = torch.empty((n_chunks, lanes), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(symbols.data_ptr(), *(p.data_ptr() for p in planes), stride_t,
             stride_l, k, lanes, t_len, chunk, n_chunks, cap, buf.data_ptr(),
             start.data_ptr(), length.data_ptr(), overflow.data_ptr(), stream)
    check(err, "rans_encode_lanes")
    LAUNCHES += 1
    return buf, start, length, overflow.bool()


def rans_encode_lanes(symbols: torch.Tensor, tbl, cap: int,
                      chunk_size: int | None = None):
    """Chunked multi-lane encode (one launch for the whole stream on CUDA).

    ``chunk_size=None`` encodes one chunk spanning all of ``T``.  Symbols
    outside ``[0, K)`` are clipped into it by both versions.
    """
    if cap <= 0:
        raise ValueError(f"cap must be positive, got {cap}")
    if symbols.shape[1] == 0:
        raise ValueError("rans_encode_lanes needs T > 0 (ops handles T == 0)")
    if symbols.device.type == "cpu":
        return rans_encode_lanes_plain(symbols, tbl, cap, chunk_size)
    if symbols.device.type == "cuda":
        return _launch(symbols, tbl, cap, chunk_size)
    raise ValueError(f"unsupported device {symbols.device}")
