#!/usr/bin/env python3
"""Where one position's time goes in the port's slice, on the card.

    python3 tools/profile_slice.py [--arch ras-pimc] [--layers N]
                                   [--lanes 128] [--max-len 1000]
                                   [--steps 50] [--trace-steps 10]

At ``--arch``'s full width (``ras-pimc`` by default; ``mamba2-130m`` at
``--lanes 16 --max-len 256`` or ``mixtral-8x22b --layers 4 --lanes 16
--max-len 512``, their ``chip_smoke.py`` slices; random seeded weights
drawn on the card, a KV ring of ``--max-len`` slots (the window's where
it is shorter) where the model has attention; ``--layers`` cuts the
depth) it times each layer of one compress position (model
step, the BF16 probabilities stored for the SPC kernel, cross entropy;
the per-run SPC kernel batch over ``--max-len`` x lanes rows, and its
share per position) and one decompress position (model step, the SPC
kernel's frequencies and CDF, top-k, the decode-step kernel), beside the
plain SPC that the ``coder`` backend runs: host clock around work that
ends in ``torch.cuda.synchronize()``, median over ``--steps`` positions.  Then it traces ``--trace-steps`` whole decompress positions
with ``torch.profiler`` and prints the device busy share of the traced
window and the device time by kernel.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _median_wall_ms(fn, steps: int) -> float:
    import torch
    times = []
    for i in range(steps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="ras-pimc",
                    help="a ported arch id (configs.registry.PORTED)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the "
                         "config's)")
    ap.add_argument("--lanes", type=int, default=128)
    ap.add_argument("--max-len", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--trace-steps", type=int, default=10)
    args = ap.parse_args()

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import constants as C
    from repro_torch.core.predictors import model_topk_candidates
    from repro_torch.device import configure_cuda_numerics, resolve_device
    from repro_torch.kernels import ops
    from repro_torch.core import spc
    from repro_torch.models import decode_step, init_model, init_state
    from repro_torch.serve import compress

    configure_cuda_numerics()
    dev = resolve_device(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    CONFIG = get_config(args.arch)
    if args.layers is not None:
        CONFIG = CONFIG.with_(n_layers=args.layers)
    lanes, vocab = args.lanes, CONFIG.vocab_size
    # The default precision, raised until the vocabulary fills at most
    # half of the mass (every symbol keeps a nonzero frequency, and no
    # table is forced flat): 14 for ras-pimc, 16 for mamba2 and mixtral,
    # the chip_smoke.py slices' precisions.
    bits = max(C.PROB_BITS, vocab.bit_length())
    model = init_model(CONFIG, seed=0, device=dev, draw="device")
    state = init_state(model, lanes, args.max_len)
    gen = torch.Generator(device=dev).manual_seed(0)
    tok = torch.randint(0, vocab, (lanes, 1), generator=gen, device=dev)
    pos = args.max_len // 2
    lg = decode_step(model, state, tok, pos)
    buf = torch.randint(0, 256, (lanes, 520), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.uint8)
    s = torch.full((lanes,), C.RANS_L, dtype=torch.int32, device=dev)
    ptr = torch.full((lanes,), 4, dtype=torch.int32, device=dev)
    freq, cdf = compress._step_freq_cdf(lg, vocab, bits)
    cands = model_topk_candidates(lg[:, :vocab], 4)

    def xent(_):
        lp = torch.log_softmax(lg[:, :vocab].float(), -1)
        return -lp.gather(1, tok).mean()

    def decompress_position(i):
        out = decode_step(model, state, tok, pos + i % 8)
        f, c = compress._step_freq_cdf(out, vocab, bits)
        k = model_topk_candidates(out[:, :vocab], 4)
        return ops.rans_decode_step(buf, s, ptr, f, c, prob_bits=bits,
                                    candidates=k)

    batch = torch.empty((args.max_len, lanes, vocab), dtype=torch.bfloat16,
                        device=dev)
    batch[:] = compress.step_probs(lg, vocab)

    def store_probs(i):
        batch[i % args.max_len] = compress.step_probs(lg, vocab)

    def spc_batch(_):
        return ops.spc_quantize_tables(batch.reshape(-1, vocab), bits)

    layers = {
        "model decode_step": lambda i: decode_step(model, state, tok,
                                                   pos + i % 8),
        "SPC probs to buffer (compress)": store_probs,
        "cross entropy (compress)": xent,
        "SPC freq/cdf, B6 (decompress)": lambda i: compress._step_freq_cdf(
            lg, vocab, bits),
        "plain step_tables (coder)": lambda i: compress.step_tables(
            lg, vocab, bits),
        "plain freq/cdf (coder)": lambda i: spc.freq_cdf_from_probs(
            compress.step_probs(lg, vocab), bits),
        "model top-k (decompress)": lambda i: model_topk_candidates(
            lg[:, :vocab], 4),
        "rans_decode_step wrapper": lambda i: ops.rans_decode_step(
            buf, s, ptr, freq, cdf, prob_bits=bits, candidates=cands),
        "whole decompress position": decompress_position,
    }
    print(f"{args.arch} full width, {CONFIG.n_layers} layers, {lanes} "
          f"lanes, ring {state.length}, "
          f"prob_bits {bits}: median host wall per call over {args.steps} "
          "calls")
    for name, fn in layers.items():
        print(f"  {name:32s} {_median_wall_ms(fn, args.steps):9.3f} ms")
    whole = _median_wall_ms(spc_batch, 5)
    print(f"  {'SPC batch, B6 + build_tables':32s} {whole:9.3f} ms per run "
          f"of {args.max_len} positions ({whole / args.max_len:.4f} ms per "
          "position; compress)")

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.trace_steps):
            decompress_position(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "cuda" in str(e.device_type).lower()]
    if not events:        # kernels are reported as CPU-keyed with device time
        events = list(prof.key_averages())

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_ms = sum(dev_us(e) for e in events) / 1e3
    n_kernels = sum(e.count for e in events if dev_us(e) > 0)
    print(f"trace: {args.trace_steps} decompress positions, {wall_ms:.3f} ms "
          f"wall, {busy_ms:.3f} ms device busy ({100 * busy_ms / wall_ms:.1f}"
          f"% busy), {n_kernels / args.trace_steps:.0f} device ops per "
          "position")
    top = sorted(events, key=dev_us, reverse=True)[:15]
    for e in top:
        if dev_us(e) > 0:
            print(f"  {dev_us(e) / 1e3 / args.trace_steps:8.4f} ms/pos "
                  f"x{e.count // args.trace_steps:4d}  {e.key[:70]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
