"""Multi-lane chunked rANS encode: the CUDA kernels and their plain versions.

Two kernels share one source (``csrc/rans_encode.cu``) and one encode step:

* B1 :func:`rans_encode_lanes` replaces the TPU kernel
  ``repro/kernels/rans_encode.py::rans_encode_lanes`` (body
  ``_encode_fused_kernel``).  It returns the ``ChunkedLanes``-layout planes
  ``(buf (n_chunks, lanes, cap) uint8, start, length (n_chunks, lanes)
  int32, overflow (n_chunks, lanes) bool)``.  Every (chunk, lane) cell is a
  standalone stream: state and cursor reset per chunk, writes past the head
  drop and are flagged, bytes outside the span are 0.
* B5 :func:`rans_encode_records` replaces
  ``repro/kernels/rans_encode.py::rans_encode_records`` (body
  ``_encode_kernel``), the records *reference* datapath.  It returns the
  fixed-shape renorm record planes ``bytes``, ``mask`` ``(n_chunks,
  padded_chunk, 2, lanes)`` uint8 and the final ``states`` ``(n_chunks,
  lanes)`` (int32 bit patterns, see :mod:`repro_torch.core.u32`);
  :func:`repro_torch.core.bitstream.compact_records` turns them into the
  same streams as B1.

Both take ``(lanes, T)`` int32 symbols and a TableSet-like object (the
five encoder planes, int32 bit patterns) in one of three layouts, static
``(K,)``, per-position ``(T, K)`` or per-lane ``(T, lanes, K)``.  A symbol
outside ``[0, K)`` gathers zero from all five planes, as the reference's
one-hot gather does: both renorm steps emit and the state is otherwise
kept.  Each dispatches on the symbols' device: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel (built by ``kernels/_build.py``)
and counts the launch in ``repro_torch.kernels.LAUNCHES``.  There is no
fallback between the two.

On this card both kernels are latency-bound: each cell runs a chain of
``chunk_size`` dependent steps and only ``n_chunks * lanes`` cells exist
(512 at the ras-pimc main-path shapes), while the byte bound is about 24 B
gathered per (t, lane) and at most 2 B (B1) or 4 B of record planes (B5)
written.  The kernels look the planes up ahead of the state's chain (one
warp per 4 lanes of a chunk), and B1 writes bytes straight to global
memory through the cursor and zeroes each row's head itself, so a call is
one launch: the TPU's one-hot scatter, byte ring and VMEM autotuner have
no role here.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import coder, u32, update
from repro_torch.kernels import LAUNCHES


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
    if t_len == 0:
        raise ValueError("the encode kernels need T > 0 (ops handles T == 0)")
    chunk = t_len if chunk_size is None else chunk_size
    if chunk <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk}")
    chunk = min(chunk, t_len)
    return chunk, -(-t_len // chunk)


def _padded_chunk(chunk: int, t_block: int | None) -> int:
    """Rows per chunk of the record planes: ``chunk`` rounded up to whole
    ``t_block`` rows (as the reference's ``_encode_plan``)."""
    tb = chunk if t_block is None else max(1, min(t_block, chunk))
    return -(-chunk // tb) * tb


def _zero_outside(symbols: torch.Tensor, tbl):
    """``(symbols, tbl)`` as the reference's one-hot gather reads them: when
    a symbol lies outside ``[0, K)``, every plane gets a zero entry at index
    K and such symbols are sent there, so they gather zero from all five
    planes.  In-range inputs are returned as they are."""
    k = tbl.x_max.shape[-1]
    inside = (symbols >= 0) & (symbols < k)
    if bool(inside.all()):
        return symbols, tbl
    return (torch.where(inside, symbols, k),
            type(tbl)(*(torch.nn.functional.pad(a, (0, 1)) for a in tbl)))


def rans_encode_lanes_plain(symbols: torch.Tensor, tbl, cap: int,
                            chunk_size: int | None = None):
    """Plain PyTorch version of B1: the pure-torch coder's chunked encode,
    with the reference's zero entries for symbols outside ``[0, K)``."""
    lanes, t_len = symbols.shape
    _layout(tbl, lanes, t_len)
    chunk, _ = _geometry(t_len, chunk_size)
    return tuple(coder.encode_chunked(*_zero_outside(symbols, tbl), chunk,
                                      cap=cap))


_ARGTYPES = {
    "rans_encode_launch": "pppppplliiiiiipppp",
    "rans_encode_records_launch": "pppppplliiiiiippp",
}


def _load(name: str):
    from repro_torch.kernels import _build
    fn = getattr(_build.load("rans_encode"), name)
    if fn.argtypes is None:
        kinds = {"p": ctypes.c_void_p, "l": ctypes.c_longlong,
                 "i": ctypes.c_int}
        fn.argtypes = [kinds[c] for c in _ARGTYPES[name]] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn, _build.check, _build.stream


def _device_inputs(symbols: torch.Tensor, tbl):
    """Validate a CUDA call's inputs: ``(planes, stride_t, stride_l, k)``."""
    lanes, t_len = symbols.shape
    layout = _layout(tbl, lanes, t_len)
    planes = update.encode_planes(tbl)
    k = planes.x_max.shape[-1]
    dev = symbols.device
    for name, p in zip(planes._fields, planes):
        if p.device != dev or p.dtype != torch.int32 or not p.is_contiguous():
            raise ValueError(f"table plane {name} must be a contiguous int32 "
                             f"tensor on {dev}; got {p.dtype} on {p.device}")
    if symbols.dtype != torch.int32 or not symbols.is_contiguous():
        raise ValueError("symbols must be a contiguous int32 tensor")
    return (planes, *_strides(layout, lanes, k), k)


def _launch(symbols: torch.Tensor, tbl, cap: int, chunk_size: int | None):
    lanes, t_len = symbols.shape
    chunk, n_chunks = _geometry(t_len, chunk_size)
    planes, stride_t, stride_l, k = _device_inputs(symbols, tbl)
    dev = symbols.device
    fn, check, stream = _load("rans_encode_launch")
    # the kernel writes every byte of buf (zeros outside each cell's span)
    # and overflow as 0/1 bytes, so nothing is cleared or converted here
    buf = torch.empty((n_chunks, lanes, cap), dtype=torch.uint8, device=dev)
    start = torch.empty((n_chunks, lanes), dtype=torch.int32, device=dev)
    length = torch.empty_like(start)
    overflow = torch.empty((n_chunks, lanes), dtype=torch.bool, device=dev)
    err = fn(symbols.data_ptr(), *(p.data_ptr() for p in planes), stride_t,
             stride_l, k, lanes, t_len, chunk, n_chunks, cap, buf.data_ptr(),
             start.data_ptr(), length.data_ptr(), overflow.data_ptr(),
             stream(dev))
    check(err, "rans_encode_lanes")
    LAUNCHES["rans_encode_lanes"] += 1
    return buf, start, length, overflow


def rans_encode_lanes(symbols: torch.Tensor, tbl, cap: int,
                      chunk_size: int | None = None):
    """Chunked multi-lane encode (one launch for the whole stream on CUDA).

    ``chunk_size=None`` encodes one chunk spanning all of ``T``.  A symbol
    outside ``[0, K)`` gathers zero table entries in both versions, as in
    the reference.
    """
    if cap <= 0:
        raise ValueError(f"cap must be positive, got {cap}")
    if symbols.device.type == "cpu":
        return rans_encode_lanes_plain(symbols, tbl, cap, chunk_size)
    if symbols.device.type == "cuda":
        return _launch(symbols, tbl, cap, chunk_size)
    raise ValueError(f"unsupported device {symbols.device}")


def rans_encode_records_plain(symbols: torch.Tensor, tbl,
                              chunk_size: int | None = None,
                              t_block: int | None = None):
    """Plain PyTorch version of B5: the coder's records scan per chunk
    (:func:`repro_torch.core.coder.encode_record_planes`), with the
    reference's zero entries for symbols outside ``[0, K)``, laid into the
    padded chunk-major planes."""
    lanes, t_len = symbols.shape
    layout = _layout(tbl, lanes, t_len)
    chunk, n_chunks = _geometry(t_len, chunk_size)
    sym, planes = _zero_outside(symbols, update.encode_planes(tbl))
    dev = symbols.device
    shape = (n_chunks, _padded_chunk(chunk, t_block), 2, lanes)
    byts = torch.zeros(shape, dtype=torch.uint8, device=dev)
    mask = torch.zeros(shape, dtype=torch.uint8, device=dev)
    states = torch.empty((n_chunks, lanes), dtype=torch.int32, device=dev)
    for c, n in enumerate(coder.chunk_lengths(t_len, chunk)):
        t0 = c * chunk
        planes_c = (planes if layout == "static" else
                    update.EncTables(*(a[t0:t0 + n] for a in planes)))
        b, m, s = coder.encode_record_planes(sym[:, t0:t0 + n], planes_c)
        byts[c, :n], mask[c, :n], states[c] = b, m, u32.bits(s)
    return byts, mask, states


def _launch_records(symbols: torch.Tensor, tbl, chunk_size: int | None,
                    t_block: int | None):
    lanes, t_len = symbols.shape
    chunk, n_chunks = _geometry(t_len, chunk_size)
    padded = _padded_chunk(chunk, t_block)
    planes, stride_t, stride_l, k = _device_inputs(symbols, tbl)
    dev = symbols.device
    fn, check, stream = _load("rans_encode_records_launch")
    shape = (n_chunks, padded, 2, lanes)
    byts = torch.empty(shape, dtype=torch.uint8, device=dev)
    mask = torch.empty(shape, dtype=torch.uint8, device=dev)
    states = torch.empty((n_chunks, lanes), dtype=torch.int32, device=dev)
    err = fn(symbols.data_ptr(), *(p.data_ptr() for p in planes), stride_t,
             stride_l, k, lanes, t_len, chunk, n_chunks, padded,
             byts.data_ptr(), mask.data_ptr(), states.data_ptr(),
             stream(dev))
    check(err, "rans_encode_records")
    LAUNCHES["rans_encode_records"] += 1
    return byts, mask, states


def rans_encode_records(symbols: torch.Tensor, tbl,
                        chunk_size: int | None = None,
                        t_block: int | None = None):
    """Records-path encode (B5, one launch for the whole stream on CUDA).

    Returns ``(bytes, mask, states)``: ``(n_chunks, padded_chunk, 2,
    lanes)`` uint8 record planes and ``(n_chunks, lanes)`` int32 final
    states, with ``padded_chunk = ceil(chunk / t_block) * t_block``
    (``t_block=None``: no padding).  A record's byte is the state's low
    byte at that renorm step whatever its mask, as in the reference; the
    rows past a chunk's end are all zero.  ``chunk_size=None`` encodes one
    chunk spanning all of ``T``.  A symbol outside ``[0, K)`` gathers zero
    table entries in both versions, as the reference's one-hot gather
    does.  Compact with :func:`repro_torch.core.bitstream.compact_records`.
    """
    if symbols.device.type == "cpu":
        return rans_encode_records_plain(symbols, tbl, chunk_size, t_block)
    if symbols.device.type == "cuda":
        return _launch_records(symbols, tbl, chunk_size, t_block)
    raise ValueError(f"unsupported device {symbols.device}")
