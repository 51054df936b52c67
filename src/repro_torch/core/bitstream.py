"""Multi-lane stream representations and the v2 wire container.

Port of the parts of ``repro.core.bitstream`` the main path needs.  The
container is host-side numpy and byte-identical to the reference::

    header (24 bytes):
        magic "RAS2"(4) | version u8 = 2 | prob_bits u8 | flags u16
        | lanes u32 | n_symbols u32 | chunk_size u32 | n_chunks u32
    chunk index table (12 bytes per cell, 16 with FLAG_CHUNK_CRC32,
    chunk-major then lane):
        offset u64 | length u32 | crc32 u32 (only with FLAG_CHUNK_CRC32)
    payload: concatenated (chunk, lane) streams, chunk-major then lane

:func:`parse_chunked` is the validation-only front door: the same named
``ValueError``\\ s in the same order as the reference (truncated header,
index, payload span; overlapping or inflated spans; CRC mismatch naming the
(chunk, lane)), then a :class:`ContainerSlab` that indexes the payload in
place.  v1 blobs parse as one chunk.

The device-side forms :class:`EncodedLanes` ``(lanes, cap)`` and
:class:`ChunkedLanes` ``(n_chunks, lanes, cap)`` hold right-aligned
streams as torch tensors.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import constants as C


class EncodedLanes(NamedTuple):
    """``buf[lane, start[lane]:start[lane] + length[lane]]`` is lane
    ``lane``'s forward-readable stream; ``overflow`` flags lanes whose stream
    outgrew ``cap`` (truncated, never wrapped; ``length`` is the need)."""

    buf: torch.Tensor                     # (lanes, cap) uint8
    start: torch.Tensor                   # (lanes,) int32
    length: torch.Tensor                  # (lanes,) int32
    overflow: torch.Tensor | None = None  # (lanes,) bool


class ChunkedLanes(NamedTuple):
    """Chunk ``c`` of lane ``l`` is ``buf[c, l, start[c, l]:start[c, l] +
    length[c, l]]``, a standalone rANS stream with its own flush."""

    buf: torch.Tensor                     # (n_chunks, lanes, cap) uint8
    start: torch.Tensor                   # (n_chunks, lanes) int32
    length: torch.Tensor                  # (n_chunks, lanes) int32
    overflow: torch.Tensor | None = None  # (n_chunks, lanes) bool


MAGIC = b"RAS1"
MAGIC_V2 = b"RAS2"
FLAG_CHUNK_CRC32 = 1 << 0
_HEADER = struct.Struct("<4sBBHII")
_HEADER_V2 = struct.Struct("<4sBBHIIII")
_INDEX_V2_DT = np.dtype([("offset", "<u8"), ("length", "<u4")])
_INDEX_V2C_DT = np.dtype([("offset", "<u8"), ("length", "<u4"),
                          ("crc", "<u4")])


class ChunkedContainer(NamedTuple):
    prob_bits: int
    lanes: int
    n_symbols: int
    chunk_size: int
    n_chunks: int


class ContainerSlab(NamedTuple):
    """Zero-copy container handle: cell (c, l)'s stream is
    ``slab[offset[c, l] : offset[c, l] + length[c, l]]``."""

    slab: np.ndarray    # (S,) uint8 raw payload bytes (a view of the blob)
    offset: np.ndarray  # (n_chunks, lanes) int64
    length: np.ndarray  # (n_chunks, lanes) int64
    cap: int            # max cell length (the dense form's row stride)
    meta: ChunkedContainer


def _check_no_overflow(overflow) -> None:
    if overflow is not None and np.asarray(overflow).any():
        bad = np.argwhere(np.asarray(overflow)).tolist()
        raise ValueError(
            f"cannot pack overflowed streams (cells {bad}): the encoder ran "
            "out of buffer capacity and the payload is truncated — "
            "re-encode with a larger cap")


def _host(a) -> np.ndarray | None:
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _span_indices(start: np.ndarray, length: np.ndarray,
                  row_stride: int) -> np.ndarray:
    """Flat indices of every cell's ``[start, start+length)`` span in a
    dense ``(cells, row_stride)`` buffer, cell-major (``row_stride=0``
    indexes a flat region at per-cell offsets)."""
    start = np.asarray(start, np.int64)
    length = np.asarray(length, np.int64)
    total = int(length.sum())
    excl = np.cumsum(length) - length
    within = np.arange(total, dtype=np.int64) - np.repeat(excl, length)
    rows = np.repeat(np.arange(length.size, dtype=np.int64), length)
    return rows * row_stride + np.repeat(start, length) + within


def pack_chunked(buf, start, length, overflow=None, *,
                 chunk_size: int, n_symbols: int,
                 prob_bits: int = C.PROB_BITS,
                 checksums: bool = True) -> bytes:
    """ChunkedLanes arrays (tensors or numpy) -> container v2 bytes.

    Overflowed cells refuse to pack; ``checksums`` stores a CRC32 of every
    cell's payload (``FLAG_CHUNK_CRC32``).
    """
    _check_no_overflow(_host(overflow))
    buf = np.asarray(_host(buf), np.uint8)
    start = np.asarray(_host(start), np.int64)
    length = np.asarray(_host(length), np.int64)
    n_chunks, lanes = buf.shape[:2]
    flags = FLAG_CHUNK_CRC32 if checksums else 0
    out = bytearray()
    out += _HEADER_V2.pack(MAGIC_V2, 2, prob_bits, flags, lanes, n_symbols,
                           chunk_size, n_chunks)
    flat_len = length.reshape(-1)
    idx = _span_indices(start.reshape(-1), flat_len, buf.shape[2])
    payload = buf.reshape(-1)[idx]
    offsets = np.concatenate([[0], np.cumsum(flat_len)[:-1]]).astype(np.int64)
    index = np.empty(flat_len.size, _INDEX_V2C_DT if checksums
                     else _INDEX_V2_DT)
    index["offset"] = offsets
    index["length"] = flat_len
    if checksums:
        index["crc"] = np.fromiter(
            (zlib.crc32(payload[o:o + n])
             for o, n in zip(offsets, flat_len)),
            dtype=np.uint32, count=flat_len.size)
    out += index.tobytes()
    out += payload.tobytes()
    return bytes(out)


def _parse_v1(blob: bytes):
    """Validation-only v1 parse -> (payload view, offsets, length, meta)."""
    if blob[:4] != MAGIC:
        raise ValueError("not a RAS container")
    if len(blob) < _HEADER.size:
        raise ValueError(
            f"truncated container v1: header needs {_HEADER.size} bytes, "
            f"blob has {len(blob)}")
    _, version, prob_bits, _, lanes, n_symbols = _HEADER.unpack_from(blob)
    if version != 1:
        raise ValueError(f"unsupported container version {version}")
    off = _HEADER.size
    if off + 4 * lanes > len(blob):
        raise ValueError(
            f"truncated container v1: lane-length table needs bytes "
            f"[{off}, {off + 4 * lanes}) for {lanes} lanes, blob has "
            f"{len(blob)}")
    length = np.frombuffer(blob, np.uint32, lanes, off).astype(np.int64)
    off += 4 * lanes
    if off + int(length.sum()) > len(blob):
        bad = int(np.argmax(off + np.cumsum(length) > len(blob)))
        raise ValueError(
            f"truncated payload at lane {bad}: lane lengths claim "
            f"{int(length.sum())} payload bytes but blob has "
            f"{len(blob) - off}")
    payload = np.frombuffer(blob, np.uint8, int(length.sum()), off)
    offsets = np.cumsum(length) - length
    return payload, offsets, length, (prob_bits, lanes, n_symbols)


def parse_chunked(blob: bytes) -> ContainerSlab:
    """Validation-only container parse (v2 or v1) -> :class:`ContainerSlab`.

    No payload byte moves: the slab is a read-only view of the blob.
    """
    magic = blob[:4]
    if magic == MAGIC:
        payload, offsets, length, (prob_bits, lanes, n_symbols) = \
            _parse_v1(blob)
        return ContainerSlab(
            slab=payload, offset=offsets[None], length=length[None],
            cap=int(length.max()) if lanes else 0,
            meta=ChunkedContainer(prob_bits=prob_bits, lanes=lanes,
                                  n_symbols=n_symbols,
                                  chunk_size=max(n_symbols, 1), n_chunks=1))
    if magic != MAGIC_V2:
        raise ValueError("not a RAS container")
    if len(blob) < _HEADER_V2.size:
        raise ValueError(
            f"truncated container v2: header needs {_HEADER_V2.size} bytes, "
            f"blob has {len(blob)}")
    (_, version, prob_bits, flags, lanes, n_symbols, chunk_size,
     n_chunks) = _HEADER_V2.unpack_from(blob)
    if version != 2:
        raise ValueError(f"unsupported container version {version}")
    has_crc = bool(flags & FLAG_CHUNK_CRC32)
    off = _HEADER_V2.size
    cells = n_chunks * lanes
    index_dt = _INDEX_V2C_DT if has_crc else _INDEX_V2_DT
    base = off + cells * index_dt.itemsize
    if base > len(blob):
        raise ValueError(
            f"truncated container v2: chunk index table needs bytes "
            f"[{off}, {base}) for {n_chunks} chunks x {lanes} lanes, blob "
            f"has {len(blob)}")
    index = np.frombuffer(blob, index_dt, cells, off)
    offsets_u = index["offset"]                 # u64: validate before any
    length = index["length"].astype(np.int64)   # signed use
    payload_len = len(blob) - base
    oob = offsets_u > np.uint64(payload_len)
    spans = offsets_u.astype(np.int64) + length
    bad_cell = oob | (spans > payload_len)
    if cells and bad_cell.any():
        bad = int(np.argmax(bad_cell))
        c, lane = divmod(bad, lanes)
        raise ValueError(
            f"truncated payload at chunk {c}, lane {lane}: cell claims "
            f"payload bytes [{int(offsets_u[bad])}, "
            f"{int(offsets_u[bad]) + int(length[bad])}) but the payload "
            f"holds {payload_len}")
    offsets = offsets_u.astype(np.int64)
    if cells and int(length.sum()) > payload_len:
        raise ValueError(
            f"corrupt chunk index: cells claim {int(length.sum())} total "
            f"payload bytes but the payload holds {payload_len} — "
            "overlapping or inflated spans")
    payload = np.frombuffer(blob, np.uint8, payload_len, base)
    if has_crc and cells:
        got = np.fromiter(
            (zlib.crc32(payload[o:o + n])
             for o, n in zip(offsets, length)),
            dtype=np.uint32, count=cells)
        bad_crc = got != index["crc"]
        if bad_crc.any():
            bad = int(np.argmax(bad_crc))
            c, lane = divmod(bad, lanes)
            raise ValueError(
                f"container v2 checksum mismatch at chunk {c}, lane "
                f"{lane}: stored CRC32 0x{int(index['crc'][bad]):08x}, "
                f"computed 0x{int(got[bad]):08x} — chunk payload corrupt")
    meta = ChunkedContainer(prob_bits=prob_bits, lanes=lanes,
                            n_symbols=n_symbols, chunk_size=chunk_size,
                            n_chunks=n_chunks)
    return ContainerSlab(slab=payload,
                         offset=offsets.reshape(n_chunks, lanes),
                         length=length.reshape(n_chunks, lanes),
                         cap=int(length.max()) if cells else 0, meta=meta)


def slab_to_chunked(cs: ContainerSlab,
                    device: torch.device | str = "cpu") -> ChunkedLanes:
    """``ContainerSlab`` -> dense right-aligned :class:`ChunkedLanes` on
    ``device``: one gather, bytes outside a cell's span read 0."""
    if cs.slab.shape[0] >= 2 ** 31:
        raise ValueError(
            f"container payload of {cs.slab.shape[0]} bytes exceeds the "
            "int32 index range of the device slab paths")
    n_chunks, lanes = cs.offset.shape
    cap = cs.cap
    off = torch.as_tensor(cs.offset, dtype=torch.int64, device=device)
    ln = torch.as_tensor(cs.length, dtype=torch.int64, device=device)
    start = cap - ln
    if cap == 0 or cs.slab.shape[0] == 0:
        buf = torch.zeros((n_chunks, lanes, cap), dtype=torch.uint8,
                          device=device)
    else:
        slab = torch.as_tensor(np.array(cs.slab, np.uint8), device=device)
        col = torch.arange(cap, dtype=torch.int64, device=device)
        src = off[..., None] + (col - start[..., None])
        valid = col >= start[..., None]
        buf = torch.where(valid,
                          slab[torch.clamp(src, 0, slab.shape[0] - 1)],
                          torch.zeros((), dtype=torch.uint8, device=device))
    return ChunkedLanes(buf=buf, start=start.to(torch.int32),
                        length=ln.to(torch.int32))


def chunk_encoded_from_slab(cs: ContainerSlab, c: int,
                            device: torch.device | str = "cpu"
                            ) -> EncodedLanes:
    """Right-align ONE chunk's cells straight from the slab on ``device``
    (the serve loops consume chunks one at a time)."""
    one = ContainerSlab(slab=cs.slab, offset=cs.offset[c:c + 1],
                        length=cs.length[c:c + 1], cap=cs.cap,
                        meta=cs.meta._replace(n_chunks=1))
    ch = slab_to_chunked(one, device)
    return EncodedLanes(buf=ch.buf[0], start=ch.start[0], length=ch.length[0])

