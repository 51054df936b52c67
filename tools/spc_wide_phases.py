#!/usr/bin/env python3
"""Where B6's cluster layout spends a row's time, phase by phase.

    python3 tools/spc_wide_phases.py [--source src/repro_torch/csrc/spc_quantize.cu]

Copies the source into ``build/`` with a ``%globaltimer`` stamp (thread 0
of each block, nanoseconds) at each phase boundary of
``spc_cluster_kernel``: the start, the keys derived, the mass exchanged,
each digit pass, the tie exchange, the final frequencies, their stores
(and the CDF's) and the exit (the wait on the cluster barrier whose arrival follows the
last remote read).  It builds that copy with ``nvcc``, launches it through
``ctypes`` at the zoo's B6 shapes (16 × K BF16 with the CDF, and the
batches 4,096 × 32,064 and 4,096 × 50,280, softmaxes of seeded logits),
checks its output against the plain SPC, and prints each phase's median
and largest time over the blocks, a block's span, the launch's span and
the blocks' mean residency (summed block spans over the span, against
the card's 132 SMs).  Pass 1's bins are built during the derive and
exchanged with the mass; a pass over bits that every key of the row
shares is skipped and has no stamp.  The stamps add a few instructions per phase; the
copy is not the kernel of the path.  Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SLOTS = 16
PHASES = ["derive", "mass exchange", "pass 1", "pass 2", "pass 3", "pass 4",
          "tie exchange", "final f", "stores", "exit wait"]
SHAPES = [(16, 32064, True), (16, 50280, True), (4096, 32064, False),
          (4096, 50280, False)]

_STAMP = ("if (threadIdx.x == 0) {{ unsigned long long t_; asm volatile("
          "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
          "g_stamp[static_cast<size_t>(blockIdx.x) * {slots} + ({n})] = t_; }}")

_READ = r"""
__device__ unsigned long long g_stamp[1 << 20];
extern "C" int spc_trace_read(void* dst, unsigned long long bytes) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamp, bytes));
}
extern "C" int spc_trace_clear() {
  static unsigned long long zero[1 << 20];
  return static_cast<int>(cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero)));
}
"""


def instrument(src: str) -> str:
    """The source with stamps at the cluster kernel's phase boundaries."""
    def stamp(n):
        return _STAMP.format(slots=SLOTS, n=n)
    k0 = src.index("spc_cluster_kernel(")
    head, body = src[:k0], src[k0:]
    end = body.index("\n}\n")
    kern, tail = body[:end], body[end:]
    marks = [
        ("  const int total = 1 << prob_bits;\n", 0, "after"),
        ("  const unsigned warp_mass = warp_sum(mass);\n", 1, "before"),
        ("  const long long delta = total - static_cast<long long>(rmass);\n",
         2, "after"),
        ("    acc = sh.chosen[1];\n", "3 + pass_no++", "after"),
        ("  long long tb = static_cast<long long>(", 7, "before"),
        ("  // staged through shared memory", 8, "before"),
        ("  cluster_wait();", 9, "before"),
    ]
    for text, n, where in marks:
        if kern.count(text) != 1:
            raise RuntimeError(f"anchor not found once: {text!r}")
        kern = kern.replace(text, text + stamp(n) + "\n" if where == "after"
                            else stamp(n) + "\n" + text)
    loop = "  for (int pass = 0; select && pass < kPasses; ++pass) {"
    kern = kern.replace(loop, "  int pass_no = 0;\n" + loop)
    kern += "\n" + stamp(10) + "\n"
    head = re.sub(r"namespace \{\n", _READ + "\nnamespace {\n", head, count=1)
    return head + kern + tail


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path,
                    default=ROOT / "src/repro_torch/csrc/spc_quantize.cu")
    args = ap.parse_args()

    import numpy as np
    import torch
    from repro_torch.core import spc
    from repro_torch.kernels import _build as b

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    copy = b.BUILD_DIR / "spc_phases.cu"
    copy.write_text(instrument(args.source.read_text()))
    lib_path = b.BUILD_DIR / "libspc_phases.so"
    subprocess.run([b._nvcc(), *b.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path),
                    str(copy)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.spc_quantize_launch
    fn.argtypes = [p, i, i, i, i, p, p, p]
    fn.restype = i
    lib.spc_trace_read.argtypes = [p, ctypes.c_ulonglong]
    lib.spc_trace_read.restype = i
    lib.spc_trace_clear.restype = i

    for rows, k, with_cdf in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(k)
        x = spc.store_bf16(torch.softmax(torch.randn(
            (rows, k), generator=gen, device=dev) * 3.0, -1))
        freq = torch.empty((rows, k), dtype=torch.int32, device=dev)
        cdf = torch.empty((rows, k + 1), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(2):                       # the second is traced
            b.check(lib.spc_trace_clear(), "clear")
            b.check(fn(x.data_ptr(), 1, rows, k, 16, freq.data_ptr(),
                       cdf.data_ptr() if with_cdf else None, stream),
                    "traced spc_quantize")
            torch.cuda.synchronize()
        want = spc.freq_cdf_from_probs(x, 16)
        if not torch.equal(freq, want[0]) or (
                with_cdf and not torch.equal(cdf, want[1])):
            raise RuntimeError(f"traced copy != plain at {rows} x {k}")
        c = -(-k // 8192)
        blocks = rows * c
        buf = np.zeros(blocks * SLOTS, np.uint64)
        b.check(lib.spc_trace_read(buf.ctypes.data, buf.nbytes), "read")
        st = buf.reshape(blocks, SLOTS).astype(np.float64)
        n_pass = int((st[:, 3:7] > 0).sum(1).max())
        cols = [0, 1, 2] + list(range(3, 3 + n_pass)) + [7, 8, 9, 10]
        names = ["derive", "mass exchange"] + PHASES[2:2 + n_pass] + \
            PHASES[6:]
        d = np.diff(st[:, cols], axis=1) / 1e3           # us
        span = (st[:, 10] - st[:, 0]) / 1e3
        wall = (st[:, 10].max() - st[:, 0].min()) / 1e3
        print(f"B6 {rows} x {k} BF16{' with the CDF' * with_cdf}: cluster "
              f"{c}, {blocks} blocks, {n_pass} digit passes; launch span "
              f"{wall:.2f} us, block span median {np.median(span):.2f} us "
              f"(max {span.max():.2f}); blocks resident on average "
              f"{span.sum() / wall:.1f} (132 SMs)", flush=True)
        for j, name in enumerate(names):
            print(f"  {name:14s} median {np.median(d[:, j]):8.3f} us, max "
                  f"{d[:, j].max():8.3f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
