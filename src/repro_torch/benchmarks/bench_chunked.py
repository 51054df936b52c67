"""Chunked streaming codec throughput against chunk size and lane count.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_chunked \
        [--device cpu] [--out chunked.json]

Port of ``benchmarks/bench_chunked.py``: the chunk-size x lane-count grid
through ``parallel.encode_chunked`` / ``parallel.decode_chunked``, on a
chunk mesh of every rank when a process group of more than one rank is up
(the reference's rule: more than one device visible) and on one device
otherwise, reporting Msym/s and the bits/symbol of the chunked streams
with the per-chunk flush overhead over one monolithic stream per lane
(a chunk of T or more is that stream, and is not encoded twice).
The bits are integer properties of the coder and equal the reference's.
On every point the encode kernel (B1; its plain version on the CPU) must
give the coder's chunks byte for byte.  ``devices`` is the mesh's size.
``--out`` writes the points as JSON; by default nothing is written.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import entry_device
from repro_torch.benchmarks import device_name, timed
from repro_torch.core import coder, spc
from repro_torch.data.pipeline import image_rows
from repro_torch.kernels import ops
from repro_torch.parallel import chunked as pchunked


def run(t: int = 2048, chunk_sizes=(128, 512, 2048), lane_counts=(8, 64, 256),
        seed: int = 0, device=None, warmup: bool = True) -> list[dict]:
    dev = torch.device("cuda" if device is None else device)
    mesh = (pchunked.chunk_mesh(device=dev) if dist.is_initialized()
            and dist.get_world_size() > 1 else None)
    counts = np.bincount(image_rows(8, 4096, seed=seed).ravel(),
                         minlength=256)
    tbl = spc.TableSet(*(a.to(dev) for a in spc.tables_from_counts_np(counts)))
    points = []
    for lanes in lane_counts:
        rows = torch.as_tensor(image_rows(lanes, t, seed=seed),
                               dtype=torch.int32, device=dev)
        first = len(points)
        for cs in chunk_sizes:
            dt_enc, enc = timed(
                lambda: pchunked.encode_chunked(rows, tbl, cs, mesh=mesh),
                dev, warmup)
            dt_dec, (dec, _) = timed(
                lambda: pchunked.decode_chunked(enc, t, tbl, cs, mesh=mesh),
                dev, warmup)
            if not torch.equal(dec, rows):
                raise AssertionError(f"l{lanes} c{cs}: round trip diverges")
            kenc = ops.rans_encode_chunked(rows, tbl, cs)
            if not all(torch.equal(a, b) for a, b in zip(enc, kenc)):
                raise AssertionError(
                    f"l{lanes} c{cs}: kernel/coder chunks diverge")
            bits = float(enc.length.sum()) * 8 / (lanes * t)
            if cs >= t:          # one chunk: the monolithic stream itself
                mono_bits = bits
            points.append({
                "name": f"chunked_l{lanes}_c{cs}",
                "lanes": lanes,
                "chunk_size": cs,
                "n_symbols": t,
                "n_chunks": coder.num_chunks(t, cs),
                "encode_Msym_s": lanes * t / dt_enc / 1e6,
                "decode_Msym_s": lanes * t / dt_dec / 1e6,
                "bits_per_symbol": bits,
                "devices": 1 if mesh is None else mesh.size,
                "device": device_name(dev),
                "kernel_byte_identical": True,
            })
        if all(cs < t for cs in chunk_sizes):
            mono_bits = float(coder.encode(rows, tbl).length.sum()) * 8 / (
                lanes * t)
        for p in points[first:]:
            p["flush_overhead_bits"] = p["bits_per_symbol"] - mono_bits
    return points


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="write the points here as JSON")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    pts = run(device=entry_device(args.device))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(pts, f, indent=2)
    for p in pts:
        print(f"{p['name']}: enc {p['encode_Msym_s']:.1f} "
              f"dec {p['decode_Msym_s']:.1f} Msym/s "
              f"({p['bits_per_symbol']:.3f} bits/sym) on {p['device']}")
    if args.out:
        print(f"wrote {len(pts)} points -> {args.out}")
    return pts


if __name__ == "__main__":
    main()
