#!/usr/bin/env python3
"""The encode kernels' (B1's and B5's) floors, beside the kernels.

    git show b7c1cc8:src/repro_torch/csrc/rans_encode.cu \\
        > build/b1_parent.cu
    python3 tools/b1_chain_floor.py --parent build/b1_parent.cu [--sass]

At three points (each as ``chip_smoke.py`` drives it):

* slice: 128 lanes x 1000 ``token_stream`` symbols, per-lane ``(T, lanes,
  K)`` tables of K = 256, chunk 256 (ragged tail of 232);
* Fig. 4(a): 128 lanes x 2048 ``image_rows(seed=0)``, the static
  ``tables_from_counts_np`` table;
* image: a 2048 x 2048 ``synthetic_image(seed=42)`` as 256 lanes x
  16,384, the static +1-smoothed histogram table, one chunk;

it times, each as device time per call inside a CUDA graph
(``chip_smoke._device_ms``):

* the one-thread-per-cell kernels given as ``--parent`` (the source at
  commit b7c1cc8), called through ``ctypes``: B1 as its wrapper ran it
  (a memset of the output, then the kernel) and alone, and B5;
* an empty kernel with B1's arguments, launched with the parent's
  geometry (one thread per cell, 128 a block) and with the repository's
  (a warp of 32 threads per 4 lanes of a chunk): the launch floor;
* the state chain alone, one warp a block: the same steps with the five
  plane entries held in registers and no symbol, so no load; as the bare
  chain, with B1's cursor and byte stores, and with B5's record stores;
  each with 32 cells a warp (one a thread) and with 4 (threads 0-3 store,
  the rest repeat their chains), the repository's geometry.  This is the
  floor no gather schedule can beat;
* the repository's B1 and B5 through their wrappers, whose outputs must
  equal the parent's, in turns with the parent (repo, repo, parent).

The card's name and power limit are printed first.  ``--sass`` writes
``cuobjdump -sass`` of the repository's encode library to
``build/b1_sass.txt`` and prints, per kernel, the count of branch,
copy, load, store and select instructions.  ``--ablate`` builds copies of
``csrc/rans_encode.cu`` with one part of B1's batch taken out (the
lookups, the kept state with the record stores, or the chain itself) and
with the lookup lead ``kAhead`` at 4
and 8 batches (the repository's is 6; 10 would not fit a 2,048-entry
static table in 48 KB of shared memory), and times each beside the
repository's build at the three points: their outputs are wrong, their
times say what each part costs.  Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

_FLOORS = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void empty_kernel(const void*, const void*, const void*,
                             const void*, const void*, const void*,
                             long long, long long, int, int, int, int, int,
                             int, void*, void*, void*, void*) {}

// kMode 0: the bare state chain; 1: with B1's cursor and byte stores;
// 2: with B5's four record stores.  The entry is held in registers.  A
// warp runs `cells` cells; thread t runs cell t % cells and threads below
// `cells` store.
template <int kMode>
__global__ void __launch_bounds__(32) chain_kernel(
    uint32_t rcp, uint32_t rshift, uint32_t bias, uint32_t cmpl,
    uint32_t xmax, int cells, int lanes, int t_len, int chunk, int n_chunks,
    int cap, uint8_t* __restrict__ out8, int32_t* __restrict__ out) {
  const int cell = blockIdx.x * cells + threadIdx.x % cells;
  const bool writer = threadIdx.x < cells;
  if (cell >= n_chunks * lanes) return;
  const int c = cell / lanes;
  const int lane = cell - c * lanes;
  const int n = min(chunk, t_len - c * chunk);
  uint8_t* row = out8 + static_cast<long long>(cell) * cap;
  uint8_t* rec = out8 + static_cast<long long>(c) * chunk * 4 * lanes + lane;
  uint32_t s = 1u << 23;
  int ptr = cap;
  for (int i = n - 1; i >= 0; --i) {
    const uint32_t s8 = s >> 8, s16 = s >> 16;
    const bool c1 = s >= xmax;
    const bool c2 = c1 && s8 >= xmax;
    const uint32_t s1 = c1 ? s8 : s;
    if (kMode == 1) {
      const int p1 = ptr - (c1 ? 1 : 0);
      const int p2 = p1 - (c2 ? 1 : 0);
      if (writer && c1 && p1 >= 0) row[p1] = static_cast<uint8_t>(s);
      if (writer && c2 && p2 >= 0) row[p2] = static_cast<uint8_t>(s1);
      ptr = p2;
    }
    if (kMode == 2 && writer) {
      uint8_t* at = rec + static_cast<long long>(i) * 4 * lanes;
      at[0] = static_cast<uint8_t>(s);
      at[lanes] = static_cast<uint8_t>(s1);
      at[2 * lanes] = c1;
      at[3 * lanes] = c2;
    }
    const uint32_t sr = c2 ? s16 : s1;
    s = sr + bias + (__umulhi(sr, rcp) >> rshift) * cmpl;
  }
  if (writer) out[cell] = static_cast<int32_t>(s) + ptr;
}

extern "C" int empty_launch(int grid, int block, const void* sym,
                            const void* rcp, const void* rshift,
                            const void* bias, const void* cmpl,
                            const void* xmax, long long st, long long sl,
                            int k, int lanes, int t_len, int chunk,
                            int n_chunks, int cap, void* buf, void* start,
                            void* length, void* overflow, void* stream) {
  empty_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      sym, rcp, rshift, bias, cmpl, xmax, st, sl, k, lanes, t_len, chunk,
      n_chunks, cap, buf, start, length, overflow);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chain_launch(int mode, int cells, unsigned rcp,
                            unsigned rshift, unsigned bias, unsigned cmpl,
                            unsigned xmax, int lanes, int t_len, int chunk,
                            int n_chunks, int cap, void* out8, void* out,
                            void* stream) {
  const int grid = (n_chunks * lanes + cells - 1) / cells;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o8 = static_cast<uint8_t*>(out8);
  auto* o = static_cast<int32_t*>(out);
  if (mode == 0) {
    chain_kernel<0><<<grid, 32, 0, s>>>(rcp, rshift, bias, cmpl, xmax, cells,
                                        lanes, t_len, chunk, n_chunks, cap,
                                        o8, o);
  } else if (mode == 1) {
    chain_kernel<1><<<grid, 32, 0, s>>>(rcp, rshift, bias, cmpl, xmax, cells,
                                        lanes, t_len, chunk, n_chunks, cap,
                                        o8, o);
  } else {
    chain_kernel<2><<<grid, 32, 0, s>>>(rcp, rshift, bias, cmpl, xmax, cells,
                                        lanes, t_len, chunk, n_chunks, cap,
                                        o8, o);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

# --ablate: (name, [(text in csrc/rans_encode.cu, its replacement)])
_LOOKUP = ("  if (kMain || (b + kAhead) * kBatch < cl.n) {\n"
           "    lookup<kStatic>(a, cl, tiles, ring, table, row0, b + kAhead, x, "
           "copy);\n  }\n")
_FLUSH = "  out.flush(cl, b);\n"
_KEEP = "      out.keep(j, s, e[j].xmax);\n"
_PUSH = "      s = push(s, e[j], c1, c2);\n"
# (Taking out the entry loads would leave registers unset, which lets the
# compiler delete the chain as well, so that part is not measured alone.)
_ABLATIONS = [
    ("no lookups", [(_LOOKUP, "")]),
    ("no kept state or record stores", [(_FLUSH, ""), (_KEEP, "")]),
    ("no chain", [(_PUSH, "      c1 = (s ^ e[j].xmax) & 1;\n"
                          "      c2 = false;\n      s += e[j].rcp;\n")]),
] + [(f"kAhead = {k}", [("constexpr int kAhead = 6;",
                         f"constexpr int kAhead = {k};")])
     for k in (4, 8)]

_SASS_KINDS = {"BRA": "branch", "LDGSTS": "cp.async", "LDS": "shared load",
               "LDG": "global load", "STG": "global store", "SEL": "select",
               "BSSY": "reconvergence", "IMAD.HI": "mulhi"}


def _build(src: Path, out: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build as b
    subprocess.run([b._nvcc(), *b.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(out),
                    str(src)], check=True)
    return ctypes.CDLL(str(out))


def _ablations(b) -> dict:
    """Build the --ablate copies of csrc/rans_encode.cu in parallel;
    returns their B1 entry points by name."""
    src = (b.CSRC / "rans_encode.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(_ABLATIONS):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"--ablate {name!r}: the source changed")
            text = text.replace(old, new)
        path = b.BUILD_DIR / f"b1_ablate_{i}.cu"
        path.write_text(text)
        out = b.BUILD_DIR / f"libb1_ablate_{i}.so"
        procs[name] = (out, subprocess.Popen(
            [b._nvcc(), *b.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", str(out), str(path)]))
    fns = {}
    for name, (out, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"--ablate {name!r} did not build")
        fn = ctypes.CDLL(str(out)).rans_encode_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _points(dev):
    """``{name: (symbols, tables, chunk)}`` at the three points."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core import spc
    from repro_torch.data.pipeline import image_rows, synthetic_image, \
        token_stream

    gen = torch.Generator(device=dev).manual_seed(1)     # encode_phase's
    logits = torch.randn((cs.T, cs.LANES, cs.K), generator=gen,
                         device=dev) * 3.0
    slice_tbl = spc.tables_from_probs(spc.store_bf16(torch.softmax(logits,
                                                                   -1)))
    del logits
    slice_syms = torch.as_tensor(token_stream(cs.K, (cs.LANES, cs.T),
                                              seed=1),
                                 dtype=torch.int32, device=dev)
    out = {"slice": (slice_syms, slice_tbl, cs.CHUNK)}
    fig = image_rows(cs.FIG4A_LANES, cs.FIG4A_T, seed=0)
    img = synthetic_image(cs.IMAGE_SIDE, cs.IMAGE_SIDE, seed=42).reshape(
        cs.IMAGE_LANES, -1)
    for name, rows in (("Fig. 4(a)", fig), ("image", img)):
        tbl = spc.tables_from_counts_np(np.bincount(rows.ravel(),
                                                    minlength=cs.K))
        out[name] = (torch.as_tensor(rows, dtype=torch.int32, device=dev),
                     spc.TableSet(*(a.to(dev) for a in tbl)), None)
    return out


def _sass(lib: Path, dest: Path) -> None:
    import os
    from repro_torch.kernels import _build as b
    tool = os.path.join(os.path.dirname(b._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(text)
    counts = collections.OrderedDict()
    name = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)",
                      line)
        if name and m:
            op = m.group(2)
            for prefix, kind in _SASS_KINDS.items():
                if op == prefix or op.startswith(prefix + "."):
                    counts[name][kind] += 1
            counts[name]["all"] += 1
    print(f"SASS of {lib.name} (full listing in {dest}):", flush=True)
    for name, c in counts.items():
        print(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in
                                         sorted(c.items())), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="the one-thread-per-cell rans_encode.cu")
    ap.add_argument("--sass", action="store_true",
                    help="dump and summarize the repository kernels' SASS")
    ap.add_argument("--ablate", action="store_true",
                    help="time B1 with parts of its batch taken out")
    args = ap.parse_args()

    import torch
    import chip_smoke
    from repro_torch.core import update
    from repro_torch.core.coder import default_cap
    from repro_torch.device import configure_cuda_numerics, resolve_device
    from repro_torch.kernels import _build as b, rans_encode

    configure_cuda_numerics()
    dev = resolve_device(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    floors_src = b.BUILD_DIR / "b1_floors.cu"
    floors_src.write_text(_FLOORS)
    parent = _build(args.parent, b.BUILD_DIR / "libb1_parent.so")
    floors = _build(floors_src, b.BUILD_DIR / "libb1_floors.so")
    p, i, ll, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_uint)
    b1_args = [p] * 6 + [ll, ll] + [i] * 6 + [p] * 4
    parent_b1 = parent.rans_encode_launch
    parent_b1.argtypes = b1_args + [p]
    parent_b5 = parent.rans_encode_records_launch
    parent_b5.argtypes = [p] * 6 + [ll, ll] + [i] * 6 + [p] * 3 + [p]
    empty = floors.empty_launch
    empty.argtypes = [i, i] + b1_args + [p]
    chain = floors.chain_launch
    chain.argtypes = [i, i] + [u] * 5 + [i] * 5 + [p, p, p]
    for fn in (parent_b1, parent_b5, empty, chain):
        fn.restype = i
    ablated = _ablations(b) if args.ablate else {}

    def stream():
        return b.stream(dev)

    for name, (syms, tbl, chunk_size) in _points(dev).items():
        lanes, t_len = syms.shape
        chunk, n_chunks = rans_encode._geometry(t_len, chunk_size)
        padded = chunk
        cap = default_cap(chunk)
        planes, stride_t, stride_l, k = rans_encode._device_inputs(syms, tbl)
        head = [syms.data_ptr(), *(q.data_ptr() for q in planes), stride_t,
                stride_l, k, lanes, t_len, chunk, n_chunks]
        buf = torch.empty((n_chunks, lanes, cap), dtype=torch.uint8,
                          device=dev)
        start = torch.empty((n_chunks, lanes), dtype=torch.int32, device=dev)
        length = torch.empty_like(start)
        ovf = torch.empty((n_chunks, lanes), dtype=torch.uint8, device=dev)
        rec = [torch.empty((n_chunks, padded, 2, lanes), dtype=torch.uint8,
                           device=dev) for _ in range(2)]
        states = torch.empty((n_chunks, lanes), dtype=torch.int32,
                             device=dev)
        b1_out = [buf.data_ptr(), start.data_ptr(), length.data_ptr(),
                  ovf.data_ptr()]

        def run_parent_b1(memset=True):
            if memset:
                buf.zero_()
            b.check(parent_b1(*head, cap, *b1_out, stream()), "parent B1")

        def run_parent_b5():
            b.check(parent_b5(*head, padded, rec[0].data_ptr(),
                              rec[1].data_ptr(), states.data_ptr(),
                              stream()), "parent B5")

        def run_empty(cells):
            grid = n_chunks * -(-lanes // cells) if cells == 4 else \
                -(-n_chunks * lanes // 128)
            b.check(empty(grid, 32 if cells == 4 else 128, *head, cap,
                          *b1_out, stream()), "empty kernel")

        # one typical entry (the most frequent symbol of the first row)
        e = update.encode_planes(tbl)
        x = int(torch.mode(syms[0]).values)
        entry = [int(a.reshape(-1, a.shape[-1])[0, x]) & 0xFFFFFFFF
                 for a in e]
        chain_out8 = torch.empty((n_chunks * max(cap, 4 * chunk) * lanes,),
                                 dtype=torch.uint8, device=dev)
        chain_out = torch.empty((n_chunks * lanes,), dtype=torch.int32,
                                device=dev)

        def run_chain(mode, cells):
            b.check(chain(mode, cells, *entry, lanes, t_len, chunk,
                          n_chunks, cap,
                          chain_out8.data_ptr(), chain_out.data_ptr(),
                          stream()), "chain kernel")

        def run_repo_b1():
            return rans_encode.rans_encode_lanes(syms, tbl, cap, chunk_size)

        def run_repo_b5():
            return rans_encode.rans_encode_records(syms, tbl, chunk_size)

        n = 20 if t_len <= 2048 else 3
        kind = ("static" if stride_t == stride_l == 0 else
                "per-lane" if stride_l else "per-position")
        print(f"{name}: {lanes} lanes x {t_len}, chunk {chunk} "
              f"({n_chunks} chunks, {n_chunks * lanes} cells), K = {k}, "
              f"{kind} table; device ms per call (CUDA graph of {n}):",
              flush=True)

        def show(runs):
            for label, fn in runs:
                v = chip_smoke._device_ms(fn, n=n)
                print(f"  {label:44s} {v:.6f} ms ({v * 1e6 / chunk:.1f} ns "
                      "a step)", flush=True)

        # step 0: the parent and the floors, before the repository's kernels
        show([("parent B1, memset + kernel (its wrapper)", run_parent_b1),
              ("parent B1, kernel alone", lambda: run_parent_b1(False)),
              ("parent B5", run_parent_b5),
              ("empty kernel, parent geometry (128 a block)",
               lambda: run_empty(1)),
              ("empty kernel, repo geometry (4 cells a warp)",
               lambda: run_empty(4))]
             + [(f"state chain{what}, {cells} cells a warp",
                 lambda mode=mode, cells=cells: run_chain(mode, cells))
                for cells in (32, 4)
                for mode, what in ((0, " alone"),
                                   (1, " + B1 cursor and byte stores"),
                                   (2, " + B5 record stores"))])
        run_parent_b1()
        run_parent_b5()
        got1, got5 = run_repo_b1(), run_repo_b5()
        torch.cuda.synchronize()
        for a, c in zip(got1, (buf, start, length, ovf.bool())):
            if not torch.equal(a, c):
                raise RuntimeError(f"{name}: repository B1 != parent B1")
        for a, c in zip(got5, (*rec, states)):
            if not torch.equal(a, c):
                raise RuntimeError(f"{name}: repository B5 != parent B5")
        print(f"{name}: repository B1 and B5 == parent's; in turns:",
              flush=True)
        show([("repo B1 (wrapper)", run_repo_b1),
              ("repo B5 (wrapper)", run_repo_b5),
              ("repo B1 (wrapper)", run_repo_b1),
              ("repo B5 (wrapper)", run_repo_b5),
              ("parent B1, memset + kernel (its wrapper)", run_parent_b1),
              ("parent B5", run_parent_b5)])
        if ablated:
            print(f"{name}: B1 with parts taken out (outputs not valid):",
                  flush=True)
            show([("repo B1 (wrapper)", run_repo_b1)]
                 + [(f"B1, {label}", lambda fn=fn: b.check(
                     fn(*head, cap, *b1_out, stream()), "ablated B1"))
                    for label, fn in ablated.items()])
    if args.sass:
        _sass(b.BUILD_DIR / "librans_encode.so",
              b.BUILD_DIR.parent / "b1_sass.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
