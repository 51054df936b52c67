"""Image compression with the RAS fabric (the paper's image workload).

    PYTHONPATH=src python -m repro_torch.examples.compress_images \
        [--device cpu]

Port of ``examples/compress_images.py``: compresses a synthetic image with
the classical baselines (zlib; zstd when the ``zstandard`` package is
present), with static-histogram rANS, and measures the prediction-guided
decoder's search-step reduction (Fig. 3 / Fig. 4(b)(c)).  The same stream
then decodes through the full-stream decode kernel (B3: identical symbols
and probe counters) and encodes through the encode kernel (B1: a v1
container byte-identical to the coder's).  On the CPU both kernels run
their plain versions.
"""

from __future__ import annotations

import argparse
import zlib

import numpy as np
import torch

from repro_torch import entry_device
from repro_torch.core import bitstream, coder
from repro_torch.core.predictors import NeighborAverage
from repro_torch.data.pipeline import synthetic_image
from repro_torch.examples import require
from repro_torch.kernels import ops
from repro_torch.serve.compress import (histogram_compress,
                                        histogram_decompress)


def run(device) -> dict:
    dev = torch.device(device)
    img = synthetic_image(256, 256, seed=42)
    raw = img.tobytes()
    print(f"image: {img.shape}, {len(raw)} bytes")
    print(f"  zlib -9 : CR {len(raw) / len(zlib.compress(raw, 9)):.3f}")
    try:  # zstd is an optional baseline, not part of the locked deps
        import zstandard
        zc = zstandard.ZstdCompressor(level=19)
        print(f"  zstd-19 : CR {len(raw) / len(zc.compress(raw)):.3f}")
    except ImportError:
        print("  zstd-19 : skipped (zstandard not installed)")

    lanes = 32
    rows = img.reshape(lanes, -1).astype(np.int64)
    enc, tbl = histogram_compress(rows, 256, device=dev)
    require(not bool(enc.overflow.any()), "a lane outgrew default_cap")
    size = bitstream.compressed_size(enc.length)
    print(f"  rANS    : CR {len(raw) / size:.3f} (static histogram, "
          f"{lanes} lanes)")

    t = rows.shape[1]
    _, probes_base = coder.decode(enc, t, tbl)
    dec, probes = coder.decode(enc, t, tbl,
                               predictor=NeighborAverage(window=4, delta=8))
    require(np.array_equal(dec.cpu().numpy(), rows), "coder decode")
    print(f"  decoder CDF probes/symbol: {float(probes_base):.2f} -> "
          f"{float(probes):.2f} with the neighbour-average predictor "
          f"(paper: 7.00 -> 3.15)")

    # the same decode through the full-stream decode kernel: both consume
    # core/search.py, so symbols and probe counters match
    kdec, kprobes = histogram_decompress(enc, t, tbl,
                                         predictor=NeighborAverage(4, 8),
                                         backend="kernel", device=dev)
    require(np.array_equal(kdec.cpu().numpy(), rows), "kernel decode")
    require(float(kprobes) == float(probes), "kernel decode probes")
    print(f"  kernel decode: identical symbols, {float(kprobes):.2f} "
          "probes/symbol (same counters)")

    # the encode kernel's streams are the coder's byte for byte, so the
    # packed container bytes match too
    kenc = ops.rans_encode(torch.as_tensor(rows, dtype=torch.int32,
                                           device=dev), tbl)
    blob = bitstream.pack(*enc, n_symbols=t)
    kblob = bitstream.pack(*kenc, n_symbols=t)
    require(kblob == blob, "kernel and coder containers differ")
    print(f"  kernel encode: container byte-identical ({len(kblob)} bytes)")
    return dict(cr=len(raw) / size, blob_bytes=len(blob),
                probes=float(probes), probes_base=float(probes_base))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return run(entry_device(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
