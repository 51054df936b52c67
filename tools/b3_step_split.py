#!/usr/bin/env python3
"""Split the full-stream decode's per-step time (B3) at the image point.

    git show 5daf755:src/repro_torch/csrc/rans_decode_lanes.cu \\
        > build/b3_parent.cu
    python3 tools/b3_step_split.py --parent build/b3_parent.cu [--repeats 3]

At the image path's shapes (a 2048 x 2048 ``synthetic_image(seed=42)`` as
256 lanes x 16,384 symbols, the static +1-smoothed histogram table, the
B1 encode) it builds the one-thread-per-cell source given as ``--parent``
(the bisection kernel at commit 5daf755, whose launcher takes no branch
output) twice: as it is, and with
its bisection replaced by a lookup in a slot -> symbol table that each
block builds in shared memory.  Each build is timed without a predictor
and with ``NeighborAverage(4, 8)``, so the per-step time splits into the
search, the predictor and the rest (state update, refill, loop).  The
repository's own kernel is timed at the same two points in the same run,
in turns with the parent (parent, repo, repo, parent).  Every time is the
kernel's device time inside a CUDA graph (``chip_smoke._device_ms``).
Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# the slot-table variant: each block fills lut[slot] by a bisection of the
# shared cdf, and the bisection gives way to one lookup
_LUT_DECL = ("    fr_base = smem;\n    cd_base = smem + k;\n  }\n")
_LUT_BUILD = """    fr_base = smem;
    cd_base = smem + k;
    uint16_t* lut_w = reinterpret_cast<uint16_t*>(smem + 2 * k + 1);
    for (int j = threadIdx.x; j < (1 << prob_bits); j += blockDim.x) {
      int lo = 0, hi = k;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (smem[k + mid] <= static_cast<uint32_t>(j)) lo = mid; else hi = mid;
      }
      lut_w[j] = static_cast<uint16_t>(lo);
    }
    __syncthreads();
  }
  const uint16_t* lut = reinterpret_cast<const uint16_t*>(smem + 2 * k + 1);
"""
_SEARCH_START = "    for (int it = 0; it < n_iter; ++it) {"
_SEARCH_END = "    const int x = lo;\n"
_SMEM = ("(2 * static_cast<size_t>(k) + 1) * sizeof(uint32_t)")
_SMEM_LUT = ("((2 * static_cast<size_t>(k) + 1) * sizeof(uint32_t) + "
             "(static_cast<size_t>(2) << prob_bits))")


def slot_variant(src: str) -> str:
    """The parent source with its bisection replaced by the slot table."""
    for anchor in (_LUT_DECL, _SEARCH_START, _SEARCH_END, _SMEM):
        if src.count(anchor) != 1:
            raise ValueError(f"parent source lacks the anchor {anchor!r}")
    src = src.replace(_LUT_DECL, _LUT_BUILD)
    a = src.index(_SEARCH_START)
    b = src.index(_SEARCH_END)
    src = src[:a] + "    (void)lo; (void)hi;\n    const int x = lut[slot];\n" \
        + src[b + len(_SEARCH_END):]
    return src.replace(_SMEM, _SMEM_LUT)


def build(src: Path, out: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(out),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(out)).rans_decode_lanes_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, i, p, p, ll, ll, ll, ll, i, p, i, i, i, i, i, i,
                   i, i, i, i, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="the one-thread-per-cell rans_decode_lanes.cu")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch
    from chip_smoke import _device_ms
    from repro_torch.core import spc
    from repro_torch.core.predictors import NeighborAverage
    from repro_torch.data.pipeline import synthetic_image
    from repro_torch.device import configure_cuda_numerics, resolve_device
    from repro_torch.core import search
    from repro_torch.kernels import ops, rans_decode

    configure_cuda_numerics()
    dev = resolve_device(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out_dir = ROOT / "build" / "b3_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    parent = args.parent.read_text()
    (out_dir / "slot.cu").write_text(slot_variant(parent))
    fns = {"parent": build(args.parent, out_dir / "libparent.so"),
           "parent + slot table": build(out_dir / "slot.cu",
                                        out_dir / "libslot.so")}

    rows = synthetic_image(2048, 2048, seed=42).reshape(256, -1).astype(
        np.int64)
    lanes, n = rows.shape
    k = 256
    tbl = spc.TableSet(*(a.to(dev) for a in spc.tables_from_counts_np(
        np.bincount(rows.ravel(), minlength=k))))
    enc = ops.rans_encode(torch.as_tensor(rows, dtype=torch.int32,
                                          device=dev), tbl)
    want = torch.as_tensor(rows, dtype=torch.int32, device=dev)
    buf, start = enc.buf.contiguous(), enc.start.to(torch.int32)
    cap = buf.shape[1]
    na = NeighborAverage(4, 8)

    def parent_call(fn, pred):
        kind, window, delta = (1, na.window, na.delta) if pred else (0, 0, 0)
        sym = torch.empty((lanes, n), dtype=torch.int32, device=dev)
        probes = torch.empty((1, lanes), dtype=torch.int32, device=dev)
        under = torch.empty_like(probes)
        err = fn(buf.data_ptr(), start.data_ptr(), cap, tbl.freq.data_ptr(),
                 tbl.cdf.data_ptr(), 0, 0, 0, 0, k, None, 0, lanes, n, n, 1,
                 14, search.ceil_log2(k), kind, window, delta,
                 sym.data_ptr(), probes.data_ptr(), under.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with cudaError {err}")
        return sym, probes, under

    def repo_call(pred):
        return rans_decode.rans_decode_lanes(
            buf, start, tbl.freq, tbl.cdf, n, predictor=na if pred else None)

    calls = {}
    for pred in (False, True):
        tag = "NeighborAverage(4, 8)" if pred else "no predictor"
        ref = repo_call(pred)
        for name, fn in fns.items():
            got = parent_call(fn, pred)
            torch.cuda.synchronize()
            if not torch.equal(got[0], want):
                raise RuntimeError(f"{name}, {tag}: symbols not exact")
            if name == "parent" and not all(map(torch.equal, got, ref)):
                raise RuntimeError(f"parent and repo kernels differ ({tag})")
            calls[f"{name}, {tag}"] = (lambda fn=fn, pred=pred:
                                       parent_call(fn, pred))
        calls[f"repo, {tag}"] = lambda pred=pred: repo_call(pred)
    order = [c for c in calls if not c.startswith("repo")]
    order = order + [c for c in calls if c.startswith("repo")] * 2 + order
    times: dict[str, list[float]] = {c: [] for c in calls}
    for name in order:
        times[name].append(_device_ms(calls[name], n=3,
                                      repeats=args.repeats))
    steps = n                     # each (lane) cell walks n dependent steps
    for name, ms in times.items():
        med = sorted(ms)[len(ms) // 2]
        print(f"{name}: {' / '.join(f'{m:.4f}' for m in ms)} ms device; "
              f"{med * 1e3 / steps:.4f} us per step ({lanes} cells x "
              f"{steps} steps)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
