"""Multi-lane scaling (paper Sec. III: "a simple multi-lane fabric ...
scales throughput"): encode and decode throughput against the lane count,
on both coder backends and through the v2 container round trip.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_lanes \
        [--device cpu] [--out lanes.json]

Port of ``benchmarks/bench_lanes.py``.  Per lane count the sweep encodes
one chunked stream with the pure-torch lane coder and with the encode
kernel (B1; the streams must be byte-identical), packs it into the v2
container and decodes it back two ways: the coder from the dense chunks,
and the slab decode kernel (B4) zero-copy off the packed payload
(``parse_chunked``); the symbols must come back exactly.  Rates are lanes
x T over host wall time (warm, then timed; on the card ending in a
synchronise).  On the CPU the kernel columns time the plain versions.
``--out`` writes the points as JSON; by default nothing is written.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import entry_device
from repro_torch.benchmarks import device_name, timed
from repro_torch.core import bitstream, coder, spc
from repro_torch.data.pipeline import image_rows
from repro_torch.kernels import ops


def run(t: int = 1024, lane_counts=(8, 32, 128), chunk_size: int = 256,
        seed: int = 0, kernel: bool = True, device=None,
        warmup: bool = True) -> list[dict]:
    dev = torch.device("cuda" if device is None else device)
    counts = np.bincount(image_rows(8, 4096, seed=seed).ravel(),
                         minlength=256)
    tbl = spc.TableSet(*(a.to(dev) for a in spc.tables_from_counts_np(counts)))
    points = []
    for lanes in lane_counts:
        rows = image_rows(lanes, t, seed=seed)
        syms = torch.as_tensor(rows, dtype=torch.int32, device=dev)

        enc_dt, ch = timed(
            lambda: coder.encode_chunked(syms, tbl, chunk_size), dev, warmup)
        dec_dt, (dec, _) = timed(
            lambda: coder.decode_chunked(ch, t, tbl, chunk_size), dev, warmup)
        if not np.array_equal(dec.cpu().numpy(), rows):
            raise AssertionError(f"lanes={lanes}: coder round trip diverges")

        point = {
            "lanes": int(lanes), "n_symbols": t, "chunk_size": chunk_size,
            "coder_encode_Msym_s": lanes * t / enc_dt / 1e6,
            "coder_decode_Msym_s": lanes * t / dec_dt / 1e6,
            "kernel_encode_Msym_s": None,
            "kernel_decode_zero_copy_Msym_s": None,
            "container_bytes": None,
            "backends_byte_identical": None,
            "device": device_name(dev),
        }

        if kernel:
            kenc_dt, kch = timed(
                lambda: ops.rans_encode_chunked(syms, tbl, chunk_size), dev,
                warmup)
            for a, b in zip(ch, kch):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"lanes={lanes}: kernel/coder streams diverge")
            blob = bitstream.pack_chunked(*kch, chunk_size=chunk_size,
                                          n_symbols=t)
            cs = bitstream.parse_chunked(blob)
            kdec_dt, (kdec, _) = timed(
                lambda: ops.rans_decode_chunked(
                    n_symbols=t, tbl=tbl, chunk_size=chunk_size,
                    from_container=cs), dev, warmup)
            if not np.array_equal(kdec.cpu().numpy(), rows):
                raise AssertionError(
                    f"lanes={lanes}: zero-copy container decode diverges")
            point.update({
                "kernel_encode_Msym_s": lanes * t / kenc_dt / 1e6,
                "kernel_decode_zero_copy_Msym_s": lanes * t / kdec_dt / 1e6,
                "container_bytes": len(blob),
                "backends_byte_identical": True,
            })
        points.append(point)
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
        print(f"lanes={p['lanes']}: coder enc "
              f"{p['coder_encode_Msym_s']:.2f} / dec "
              f"{p['coder_decode_Msym_s']:.2f} Msym/s, kernel enc "
              f"{p['kernel_encode_Msym_s']:.2f} / zero-copy dec "
              f"{p['kernel_decode_zero_copy_Msym_s']:.2f} Msym/s "
              f"(container {p['container_bytes']} B, "
              f"byte-identical={p['backends_byte_identical']}) "
              f"on {p['device']}")
    if args.out:
        print(f"wrote {len(pts)} points -> {args.out}")
    return pts


if __name__ == "__main__":
    main()
