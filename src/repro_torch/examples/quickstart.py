"""Quickstart: the RAS pipeline on the port.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Port of ``examples/quickstart.py``: builds mass-corrected fixed-point tables
(SPC), encodes a multi-lane symbol stream with the two-stage rANS coder,
decodes it with prediction-guided search, checks lane 0 byte for byte
against the scalar golden reference, and round-trips the chunked v2
container.  Any bitstream regression fails a check.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import entry_device
from repro_torch.core import bitstream, coder, golden, spc
from repro_torch.core import constants as C
from repro_torch.core.predictors import NeighborAverage
from repro_torch.data.pipeline import image_rows
from repro_torch.examples import require


def run(device) -> dict:
    dev = torch.device(device)
    # 1. a probability model (here: the histogram of an image-like stream)
    lanes, t = 16, 512
    rows = image_rows(lanes, t, seed=0)
    counts = np.bincount(rows.ravel(), minlength=256)
    tbl = spc.TableSet(*(a.to(dev) for a in spc.tables_from_counts_np(counts)))
    print(f"SPC: {tbl.freq.shape[-1]} symbols, mass = "
          f"{int(tbl.freq.sum())} (= 2^{C.PROB_BITS})")

    # 2. multi-lane encode (each lane is an independent rANS stream)
    syms = torch.as_tensor(rows, device=dev)
    enc = coder.encode(syms, tbl)
    blob = bitstream.pack(*enc, n_symbols=t)
    print(f"encoded {lanes * t} symbols -> {len(blob)} bytes "
          f"({len(blob) * 8 / (lanes * t):.2f} bits/symbol)")

    # 3. prediction-guided decode (neighbour average, +-8 window)
    _, probes_base = coder.decode(enc, t, tbl)
    dec, probes = coder.decode(enc, t, tbl,
                               predictor=NeighborAverage(window=4, delta=8))
    require(np.array_equal(dec.cpu().numpy(), rows), "roundtrip failed")
    print(f"decode OK; CDF probes/symbol: {float(probes_base):.2f} -> "
          f"{float(probes):.2f} with prediction "
          f"({1 - float(probes) / float(probes_base):.0%} fewer)")

    # 4. bit-exactness against the scalar golden reference
    buf, start, length = (a.cpu().numpy() for a in enc[:3])
    ref = golden.encode(rows[0], tbl.freq.cpu().numpy(),
                        tbl.cdf.cpu().numpy())
    require(buf[0, start[0]:start[0] + length[0]].tobytes() == ref,
            "lane 0 differs from the golden reference")
    print("lane 0 bitstream is byte-identical to the golden reference")

    # 5. chunked streaming compression: every `chunk` symbols the encoder
    # flushes, so each (chunk, lane) cell is a standalone stream; the v2
    # container indexes every cell for random access
    chunk = 128
    chunks = coder.encode_chunked(syms, tbl, chunk)
    blob_v2 = bitstream.pack_chunked(*chunks, chunk_size=chunk, n_symbols=t)
    cbuf, cstart, cmeta = bitstream.unpack_chunked(blob_v2)
    restored = bitstream.ChunkedLanes(
        torch.as_tensor(cbuf, device=dev), torch.as_tensor(cstart, device=dev),
        torch.as_tensor(cbuf.shape[-1] - cstart, device=dev))
    dec_chunked, _ = coder.decode_chunked(restored, t, tbl, chunk)
    require(np.array_equal(dec_chunked.cpu().numpy(), rows),
            "chunked roundtrip")
    print(f"chunked: {cmeta.n_chunks} chunks x {lanes} lanes -> "
          f"{len(blob_v2)} bytes (v2 container, "
          f"+{(len(blob_v2) - len(blob)) * 8 / (lanes * t):.3f} bits/symbol "
          f"flush overhead), decodes chunk-parallel")
    return dict(blob_bytes=len(blob), blob_v2_bytes=len(blob_v2),
                probes=float(probes), probes_base=float(probes_base))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return run(entry_device(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
