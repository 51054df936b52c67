#!/usr/bin/env python3
"""B6's cluster layout and B2's read-ahead bisection at the zoo's wide K,
each against its plain version and timed beside the parent's kernels.

    mkdir -p build
    git show b32b606:src/repro_torch/csrc/spc_quantize.cu \\
        > build/spc_parent.cu
    git show b32b606:src/repro_torch/csrc/rans_decode_step.cu \\
        > build/step_parent.cu
    python3 tools/wide_kernels.py --parent-spc build/spc_parent.cu \\
        --parent-step build/step_parent.cu [--check-only]

Checks, every one against the plain PyTorch version on the card (all
outputs equal):

* B6 (``spc_quantize.spc_freq_cdf`` and ``spc_quantize``) at K = 16,385,
  32,064, 32,768, 50,280 and 65,536, ``prob_bits=16``, on 1, 16 and 4,096
  rows in BF16 (and float32 up to 16 rows): a uniform row (one tie run),
  the 1/3 row (the waterfill, every key tied), a two-level row, a
  near-uniform row, then softmaxes of seeded logits;
* B2 (``rans_decode.rans_decode_step``) at K = 32,064, 32,768 and 50,280
  on 1, 16 and 128 lanes of random states: per-lane SPC rows, a shared
  row, zero frequencies in every third lane and a freq that is not the
  cdf's differences, with top-4 candidates (out-of-range and duplicate
  ids among them) and without; every launch on its plan's path.

Then (without ``--check-only``) it times, as device time per call inside
a CUDA graph (``chip_smoke._device_ms``), the parent's kernel (the source
given, built with ``nvcc`` and called through ``ctypes``) and the
repository's in turns (parent, repo, repo, parent) at the zoo slices'
shapes: B6 at 16 × K with the CDF and on the batch (4,096 × 32,064, 8,192
× 32,768, 4,096 × 50,280), B2 at 16 lanes of per-lane rows with top-4
candidates, and both at the slice's narrow point (128 × 256), with each
shape's bound (``chip_smoke._spc_bound``, ``_b2_bound``).  The card's name
and power limit come first.  Needs one CUDA card and ``nvcc``.
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

BITS = 16
SPC_KS = (16385, 32064, 32768, 50280, 65536)
SPC_ROWS = (1, 16, 4096)
STEP_KS = (32064, 32768, 50280)
STEP_LANES = (1, 16, 128)
BATCH = {32064: 4096, 32768: 8192, 50280: 4096}   # the zoo's B6 batches
TOPK = 4


def _build(src: Path, out: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build as b
    subprocess.run([b._nvcc(), *b.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I", str(b.CSRC),
                    "-o", str(out), str(src)], check=True)
    return ctypes.CDLL(str(out))


def _probs(k: int, rows: int, dev, seed: int):
    """(rows, K) float32: the tie and waterfill rows first, then seeded
    softmaxes."""
    import torch
    head = [torch.full((k,), 1.0 / k),
            torch.full((k,), 1.0 / 3),
            torch.cat([torch.full((k // 2,), 3e-6),
                       torch.full((k - k // 2,), 1.5e-5)]),
            (1 + 1e-3 * torch.randn(k, generator=torch.Generator().
                                    manual_seed(seed))) / k]
    x = torch.stack(head[:rows]).to(dev)
    if rows > x.shape[0]:
        gen = torch.Generator(device=dev).manual_seed(seed)
        fill = torch.softmax(torch.randn((rows - x.shape[0], k),
                                         generator=gen, device=dev) * 3.0, -1)
        x = torch.cat([x, fill])
    return x


def _same(got, want, what: str) -> None:
    import torch
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            raise RuntimeError(f"{what}: kernel != plain "
                               f"({int((a != b).sum())} entries differ)")


def check_spc(dev) -> int:
    import torch
    from repro_torch.core import spc
    from repro_torch.kernels import autotune, spc_quantize
    n = 0
    for k in SPC_KS:
        for rows in SPC_ROWS:
            x = _probs(k, rows, dev, seed=k + rows)
            for xt in ((spc.store_bf16(x), x) if rows <= 16
                       else (spc.store_bf16(x),)):
                what = f"B6 {rows} x {k} {xt.dtype}"
                _same(spc_quantize.spc_freq_cdf(xt, BITS),
                      spc.freq_cdf_from_probs(xt, BITS), what)
                _same((spc_quantize.spc_quantize(xt, BITS),),
                      (spc.quantize_probs(xt, BITS),), what)
                n += 2
            plan = autotune.spc_plan(rows, k)
            print(f"B6 {rows} x {k}: kernel == plain (BF16"
                  f"{' and float32' if rows <= 16 else ''}, with and "
                  f"without the CDF); plan {plan.path}, cluster "
                  f"{plan.cluster}, grid {plan.grid} x {plan.block}",
                  flush=True)
    torch.cuda.synchronize()
    return n


def _step_case(k: int, lanes: int, dev, seed: int, bits: int = BITS):
    """Random states over random bytes, per-lane SPC rows and top-4
    candidates with out-of-range and duplicate ids."""
    import torch
    from repro_torch.core import spc
    gen = torch.Generator(device=dev).manual_seed(seed)
    cap = 64
    buf = torch.randint(0, 256, (lanes, cap), generator=gen, device=dev,
                        dtype=torch.uint8)
    s = torch.randint(1 << 23, 1 << 31, (lanes,), generator=gen, device=dev,
                      dtype=torch.int64).to(torch.int32)
    ptr = torch.randint(-1, cap + 1, (lanes,), generator=gen, device=dev,
                        dtype=torch.int32)
    probs = torch.softmax(torch.randn((lanes, k), generator=gen,
                                      device=dev) * 3.0, -1)
    tt = spc.tables_from_probs(spc.store_bf16(probs), bits)
    cands = torch.topk(tt.freq, TOPK, dim=-1).indices.to(torch.int32)
    cands[::2, 1] = -5
    cands[::3, 2] = k + 3
    cands[::4, 3] = cands[::4, 0]
    return buf, s, ptr, tt, cands


def check_step(dev) -> int:
    import torch
    from repro_torch.core import spc
    from repro_torch.kernels import autotune, rans_decode
    n = 0
    for k in STEP_KS:
        for lanes in STEP_LANES:
            buf, s, ptr, tt, cands = _step_case(k, lanes, dev, seed=k + lanes)
            zf = tt.freq.clone()
            zf[::3, 128] += zf[::3, 3:7].sum(-1)
            zf[::3, 3:7] = 0
            zt = spc.build_tables(zf, BITS)
            bent = tt.freq + torch.randint(
                0, 3, tt.freq.shape, device=dev, dtype=tt.freq.dtype,
                generator=torch.Generator(device=dev).manual_seed(k))
            want = autotune.decode_step_plan(k, lanes).branches()
            for name, f, c in (("per-lane", tt.freq, tt.cdf),
                               ("shared", tt.freq[0], tt.cdf[0]),
                               ("zero-frequency", zt.freq, zt.cdf),
                               ("mismatched", bent, tt.cdf)):
                for cand in (cands, None):
                    args = (buf, s, ptr, f.contiguous(), c.contiguous())
                    what = (f"B2 {lanes} x {k} {name} "
                            f"{'top-4' if cand is not None else 'no cands'}")
                    _same(rans_decode.rans_decode_step(
                        *args, BITS, candidates=cand),
                        rans_decode.rans_decode_step_plain(
                            *args, BITS, candidates=cand), what)
                    got = rans_decode.last_branches("rans_decode_step")
                    if got != want:
                        raise RuntimeError(f"{what}: ran {sorted(got)}, "
                                           f"planned {sorted(want)}")
                    n += 1
            print(f"B2 {lanes} lanes x {k}: kernel == plain on per-lane, "
                  "shared, zero-frequency and mismatched rows, with and "
                  f"without candidates; paths {sorted(want)}", flush=True)
    torch.cuda.synchronize()
    return n


def time_turns(dev, spc_src: Path, step_src: Path) -> None:
    import torch
    import chip_smoke
    from repro_torch.core import search, spc
    from repro_torch.kernels import _build as b, rans_decode, spc_quantize

    spc_lib = _build(spc_src, b.BUILD_DIR / "libspc_parent.so")
    step_lib = _build(step_src, b.BUILD_DIR / "libstep_parent.so")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    spc_fn = spc_lib.spc_quantize_launch
    spc_fn.argtypes = [p, i, i, i, i, p, p, p]
    spc_fn.restype = i
    step_fn = step_lib.rans_decode_step_launch
    step_fn.argtypes = [p, i, p, p, p, p, ll, ll, i, p, i, i, i, i, p, p]
    step_fn.restype = i

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def turns(what, parent, repo, n, bound):
        ms = [chip_smoke._device_ms(fn, n=n)
              for fn in (parent, repo, repo, parent)]
        print(f"{what}: parent {ms[0]:.4f} / {ms[3]:.4f} ms, repo "
              f"{ms[1]:.4f} / {ms[2]:.4f} ms (parent, repo, repo, parent; "
              f"{min(ms[0], ms[3]) / min(ms[1], ms[2]):.1f}x), bound "
              f"{bound[0]:.6f} ms by {bound[1]}", flush=True)

    spc_shapes = [(16, k, True) for k in STEP_KS] + \
        [(BATCH[k], k, False) for k in STEP_KS] + [(128, 256, True)]
    for rows, k, with_cdf in spc_shapes:
        bits = BITS if k > 256 else 14
        x = spc.store_bf16(torch.softmax(torch.randn(
            (rows, k), generator=torch.Generator(device=dev).manual_seed(k),
            device=dev) * 3.0, -1))
        freq = torch.empty((rows, k), dtype=torch.int32, device=dev)
        cdf = torch.empty((rows, k + 1), dtype=torch.int32, device=dev)

        def parent(x=x, freq=freq, cdf=cdf, rows=rows, k=k, bits=bits,
                   with_cdf=with_cdf):
            b.check(spc_fn(x.data_ptr(), 1, rows, k, bits, freq.data_ptr(),
                           cdf.data_ptr() if with_cdf else None, stream()),
                    "parent spc_quantize")

        def repo(x=x, bits=bits, with_cdf=with_cdf):
            return (spc_quantize.spc_freq_cdf(x, bits) if with_cdf
                    else spc_quantize.spc_quantize(x, bits))

        parent()
        got = repo()
        _same((freq, cdf) if with_cdf else (freq,),
              got if with_cdf else (got,), f"B6 parent {rows} x {k}")
        turns(f"B6 {rows} x {k} BF16{' with the CDF' * with_cdf}", parent,
              repo, 20 if rows <= 256 else 3,
              chip_smoke._spc_bound(rows, k, 2, with_cdf))
    for lanes, k in [(16, k) for k in STEP_KS] + [(128, 256)]:
        bits = BITS if k > 256 else 14
        buf, s, ptr, tt, cands = _step_case(k, lanes, dev, 7 * k, bits)
        f, c = tt.freq.contiguous(), tt.cdf.contiguous()
        out = torch.empty((6, lanes), dtype=torch.int32, device=dev)

        def parent(buf=buf, s=s, ptr=ptr, f=f, c=c, cands=cands, out=out,
                   lanes=lanes, k=k, bits=bits):
            b.check(step_fn(buf.data_ptr(), buf.shape[1], s.data_ptr(),
                            ptr.data_ptr(), f.data_ptr(), c.data_ptr(), k,
                            k + 1, k, cands.data_ptr(), TOPK, lanes, bits,
                            search.ceil_log2(k), out.data_ptr(), stream()),
                    "parent rans_decode_step")

        def repo(buf=buf, s=s, ptr=ptr, f=f, c=c, cands=cands, bits=bits):
            return rans_decode.rans_decode_step(buf, s, ptr, f, c, bits,
                                                candidates=cands)

        parent()
        got = repo()
        _same(got, tuple(out[:5]), f"B2 parent {lanes} x {k}")
        one = rans_decode.rans_decode_step_plain(buf, s, ptr, f, c, bits,
                                                 candidates=cands)
        bound = chip_smoke._b2_bound(one, ptr, TOPK)
        turns(f"B2 {lanes} lanes x {k} (per-lane rows, top-{TOPK}; paths "
              f"{sorted(rans_decode.last_branches('rans_decode_step'))})",
              parent, repo, 50, bound[:2])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-spc", type=Path)
    ap.add_argument("--parent-step", type=Path)
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()

    import torch
    from repro_torch.device import configure_cuda_numerics, resolve_device
    from repro_torch.kernels import _build as b

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    configure_cuda_numerics()
    dev = resolve_device(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    print(f"build {b.build_all(verbose=True):.1f} s", flush=True)
    n = check_spc(dev) + check_step(dev)
    print(f"{n} launches equal their plain versions", flush=True)
    if not args.check_only:
        time_turns(dev, args.parent_spc, args.parent_step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
