#!/usr/bin/env python3
"""The decode-step kernel's (B2's) launch floor, beside the kernel itself.

    git show 73357c3:src/repro_torch/csrc/rans_decode_step.cu \\
        > build/b2_parent.cu
    python3 tools/b2_launch_floor.py --parent build/b2_parent.cu

At ``chip_smoke.py``'s B2 point (128 lanes, per-lane ``(lanes, K)`` rows
of K = 256, top-4 candidates, the first step of a B1-encoded stream) it
times, each as device time per call inside a CUDA graph of 100 calls
(``chip_smoke._device_ms``):

* the one-thread-per-lane kernel given as ``--parent`` (the source at
  commit 73357c3, whose launcher takes five output pointers), called
  through ``ctypes`` with preallocated outputs;
* an empty kernel with the parent's 19 kernel arguments, launched with the
  parent's geometry (one thread per lane, 128 a block) and with the
  repository kernel's (one warp per lane, four a block): the floor of one
  graph node on this card;
* the repository's kernel through its wrapper
  (``rans_decode.rans_decode_step``), whose outputs must equal the
  parent's, and the repository's own empty kernel
  (``rans_decode.rans_decode_step_floor``).

The parent and the empty kernels are timed first, then the repository's
kernel in turns with the parent (repo, repo, parent); the card's
name and power limit are printed first.  Last, the wrapper call's host
work is timed piece by piece (host wall per call, 2,000 calls a batch):
the checks, the output allocation, the stream lookup, the ctypes launch
and the views of the output.  Needs one CUDA card and ``nvcc``.
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

LANES, K, CHUNK, TOPK = 128, 256, 256, 4      # chip_smoke.py's B2 point

_EMPTY = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void empty_step_kernel(
    const uint8_t*, int, const uint32_t*, const int32_t*, const uint32_t*,
    const uint32_t*, long long, long long, int, const int32_t*, int, int,
    int, int, uint32_t*, int32_t*, int32_t*, int32_t*, int32_t*) {}
extern "C" int empty_step_launch(
    int grid, int block, const void* buf, int cap, const void* s_in,
    const void* ptr_in, const void* freq, const void* cdf, long long fs,
    long long cs, int k, const void* cands, int topk, int lanes,
    int prob_bits, int n_iter, void* s_out, void* ptr_out, void* sym_out,
    void* probes_out, void* under_out, void* stream) {
  empty_step_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), cap,
      static_cast<const uint32_t*>(s_in), static_cast<const int32_t*>(ptr_in),
      static_cast<const uint32_t*>(freq), static_cast<const uint32_t*>(cdf),
      fs, cs, k, static_cast<const int32_t*>(cands), topk, lanes, prob_bits,
      n_iter, static_cast<uint32_t*>(s_out), static_cast<int32_t*>(ptr_out),
      static_cast<int32_t*>(sym_out), static_cast<int32_t*>(probes_out),
      static_cast<int32_t*>(under_out));
  return static_cast<int>(cudaGetLastError());
}
"""


def _build(src: Path, out: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build as b
    subprocess.run([b._nvcc(), *b.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(out),
                    str(src)], check=True)
    return ctypes.CDLL(str(out))


def _host_ms(fn, n: int = 2000, repeats: int = 5) -> float:
    """Host wall time per call of ``fn`` (median over ``repeats`` batches
    of ``n`` calls, after a warm-up batch); the device keeps up, so this is
    the enqueue cost."""
    import statistics
    import time
    import torch
    times = []
    for r in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        if r:
            times.append((time.perf_counter() - t0) / n * 1e3)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="the one-thread-per-lane rans_decode_step.cu")
    args = ap.parse_args()

    import torch
    import chip_smoke
    from repro_torch.core import coder, search, spc, u32
    from repro_torch.core import constants as C
    from repro_torch.data.pipeline import token_stream
    from repro_torch.device import configure_cuda_numerics, resolve_device
    from repro_torch.kernels import _build as b, ops, rans_decode

    configure_cuda_numerics()
    dev = resolve_device(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    empty_src = b.BUILD_DIR / "b2_empty.cu"
    empty_src.write_text(_EMPTY)
    parent = _build(args.parent, b.BUILD_DIR / "libb2_parent.so")
    empty = _build(empty_src, b.BUILD_DIR / "libb2_empty.so")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    step_args = [p, i, p, p, p, p, ll, ll, i, p, i, i, i, i, p, p, p, p, p]
    parent_fn = parent.rans_decode_step_launch
    parent_fn.argtypes = step_args + [p]
    parent_fn.restype = i
    empty_fn = empty.empty_step_launch
    empty_fn.argtypes = [i, i] + step_args + [p]
    empty_fn.restype = i

    gen = torch.Generator(device=dev).manual_seed(1)
    logits = torch.randn((CHUNK, LANES, K), generator=gen, device=dev) * 3.0
    tables = spc.tables_from_probs(spc.store_bf16(torch.softmax(logits, -1)))
    syms = torch.as_tensor(token_stream(K, (LANES, CHUNK), seed=1),
                           dtype=torch.int32, device=dev)
    enc = ops.rans_encode(syms, tables)
    dec = coder.decoder_init(enc)
    buf = enc.buf.contiguous()
    s0, p0 = u32.bits(dec.s), dec.ptr.to(torch.int32)
    freq, cdf = tables.freq[0].contiguous(), tables.cdf[0].contiguous()
    cands = torch.topk(freq, TOPK, dim=-1).indices.to(torch.int32)
    outs = [torch.empty((LANES,), dtype=torch.int32, device=dev)
            for _ in range(5)]
    common = [buf.data_ptr(), buf.shape[1], s0.data_ptr(), p0.data_ptr(),
              freq.data_ptr(), cdf.data_ptr(), K, K + 1, K,
              cands.data_ptr(), TOPK, LANES, C.PROB_BITS, search.ceil_log2(K),
              *(o.data_ptr() for o in outs)]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def run_parent():
        b.check(parent_fn(*common, stream()), "parent rans_decode_step")

    def run_empty(grid, block):
        b.check(empty_fn(grid, block, *common, stream()), "empty kernel")

    def run_repo():
        return rans_decode.rans_decode_step(buf, s0, p0, freq, cdf,
                                            candidates=cands)

    run_parent()
    got = run_repo()
    torch.cuda.synchronize()
    for a, c in zip(got, outs):
        if not torch.equal(a, c):
            raise RuntimeError("the repository kernel and the parent differ")
    print(f"B2 point: {LANES} lanes, per-lane (lanes, {K}) rows, top-{TOPK};"
          " repository kernel == parent kernel on every output; branches "
          f"{sorted(rans_decode.last_branches('rans_decode_step'))}",
          flush=True)
    def run_floor():
        rans_decode.rans_decode_step_floor(buf, s0, p0, freq, cdf,
                                           candidates=cands)

    # the parent and the floor first, then the repository kernel in turns
    grid = (LANES + 3) // 4
    timed = [(name, chip_smoke._device_ms(fn, n=100)) for name, fn in (
        ("parent", run_parent),
        ("empty, parent geometry (1 x 128)", lambda: run_empty(1, 128)),
        (f"empty, repo geometry ({grid} x 128)",
         lambda: run_empty(grid, 128)),
        ("repo's floor entry (rans_decode_step_floor)", run_floor),
        ("repo", run_repo), ("repo", run_repo), ("parent", run_parent))]
    for name, v in timed:
        print(f"  {name:44s} {v:.6f} ms per call (CUDA graph of 100)",
              flush=True)

    # the wrapper call's host work, piece by piece
    fn = rans_decode._step_fn("rans_decode_step_launch")[0]
    out = torch.empty((6, LANES), dtype=torch.int32, device=dev)
    raw = [buf.data_ptr(), buf.shape[1], s0.data_ptr(), p0.data_ptr(),
           freq.data_ptr(), cdf.data_ptr(), 0, 0, K, cands.data_ptr(), TOPK,
           LANES, C.PROB_BITS, search.ceil_log2(K), out.data_ptr(),
           stream()]
    pieces = {
        "wrapper call (rans_decode_step)": run_repo,
        "floor wrapper call (same host work)": run_floor,
        "shape checks (_check_shapes)": lambda: rans_decode._check_shapes(
            buf, freq, cdf, cands),
        "torch.empty((6, lanes))": lambda: torch.empty(
            (6, LANES), dtype=torch.int32, device=dev),
        "current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "raw stream handle (_build.stream)": lambda: b.stream(dev),
        "ctypes launch, arguments ready": lambda: fn(*raw),
        "out.unbind(0)": lambda: out.unbind(0),
    }
    for name, f in pieces.items():
        print(f"  host {name:40s} {_host_ms(f):.6f} ms per call", flush=True)
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
