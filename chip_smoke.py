#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the RAS pipeline on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero):

1. print the card's name and power limit (``nvidia-smi``) and build every
   kernel from ``src/repro_torch/csrc/*.cu`` (one ``nvcc`` per source, in
   parallel);
2. kernel phases: the encode kernel (B1) and the decode-step kernel (B2)
   against their plain PyTorch versions on the card at the main-path
   shapes (128 lanes, K = 256, per-lane ``(T, lanes, K)`` tables, chunk 256
   with a ragged tail, plus an overflow case): outputs must be identical.
   Each is timed with CUDA events (median of repeats) beside its bound
   computed from this run's inputs;
3. a small-input reference check: the model's logits on the card agree
   with the same model's logits on the CPU;
4. the slice: ``ras-pimc`` at full width, 128 lanes x 1000 tokens, chunk
   256, through ``lm_compress_chunked(backend="kernel")`` ->
   ``pack_chunked`` -> ``parse_chunked`` ->
   ``lm_decompress_chunked(backend="kernel")`` with launch counters reset
   just before and read just after; then the ``coder`` backend on the card
   must give a byte-identical container and equal per-lane probes.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Exits nonzero without CUDA or outside
a checkout of the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

LANES, T, K, CHUNK, TOPK = 128, 1000, 256, 256, 4
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
ALU32_OPS_PER_S = 67e12          # H100 SXM 32-bit rate outside tensor cores


def _median_ms(fn, repeats: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn, n: int, repeats: int = 5) -> float:
    """Device time per call: ``n`` calls captured in one CUDA graph, the
    graph replayed between two events (median of ``repeats``), over ``n``.
    Host work of the wrapper is outside the graph, so this is the kernel's
    own time (plus any allocation or memset nodes the wrapper issues)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return _median_ms(graph.replay, repeats, warmup=1) / n


def _check(ok, what: str) -> None:
    """Fail the run (kept under ``python -O``, unlike ``assert``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _max_abs_err(got, ref) -> int:
    """Max |kernel - plain| over all outputs; the outputs must be equal."""
    err = 0
    for a, b in zip(got, ref):
        _check(a.shape == b.shape, f"output shapes {tuple(a.shape)} vs "
               f"{tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    _check(err == 0, f"kernel and plain version disagree (max abs err {err})")
    return err


def encode_phase(dev):
    import torch
    from repro_torch.core import spc
    from repro_torch.data.pipeline import token_stream
    from repro_torch.kernels import rans_encode
    from repro_torch.core.coder import default_cap

    gen = torch.Generator(device=dev).manual_seed(1)
    logits = torch.randn((T, LANES, K), generator=gen, device=dev) * 3.0
    tables = spc.tables_from_probs(
        spc.store_bf16(torch.softmax(logits, -1)))
    syms = torch.as_tensor(token_stream(K, (LANES, T), seed=1),
                           dtype=torch.int32, device=dev)
    cap = default_cap(CHUNK)

    def call(c):
        return rans_encode.rans_encode_lanes(syms, tables, c, CHUNK)

    def plain(c):
        return rans_encode.rans_encode_lanes_plain(syms, tables, c, CHUNK)

    got, ref = call(cap), plain(cap)
    torch.cuda.synchronize()
    err = _max_abs_err(got, ref)
    _check(not bool(ref[3].any()), "default cap overflowed")
    small = cap // 3                 # overflow case: some cells outgrow it
    ovf_got, ovf_ref = call(small), plain(small)
    torch.cuda.synchronize()
    err = max(err, _max_abs_err(ovf_got, ovf_ref))
    _check(bool(ovf_ref[3].any()), "overflow case did not overflow")
    print(f"B1 encode: kernel == plain at ({LANES} lanes, T={T}, K={K}, "
          f"chunk {CHUNK}, cap {cap}) and at cap {small} "
          f"({int(ovf_ref[3].sum())} overflowed cells flagged)", flush=True)
    ms = _device_ms(lambda: call(cap), n=10)
    call_ms = _median_ms(lambda: call(cap), repeats=30)
    plain_ms = _median_ms(lambda: plain(cap), repeats=3, warmup=1)
    n_chunks = ref[0].shape[0]
    moved = (LANES * T * (4 + 5 * 4)           # symbol + five gathered planes
             + n_chunks * LANES * (cap + 9))   # streams + start/len/overflow
    ops = LANES * T * 10                        # ~10 integer ops per step
    bound_ms = max(moved / HBM_BYTES_PER_S, ops / ALU32_OPS_PER_S) * 1e3
    print(f"B1 encode: {ms:.4f} ms kernel on the device ({call_ms:.4f} ms "
          f"per wrapper call), {plain_ms:.2f} ms plain, bound "
          f"{bound_ms:.6f} ms ({moved} B moved); one thread per "
          f"(chunk, lane) walks {CHUNK} dependent steps: latency-bound",
          flush=True)
    return dict(name="rans_encode_lanes", route="cuda",
                source="src/repro_torch/csrc/rans_encode.cu",
                replaces="src/repro/kernels/rans_encode.py:469",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None,
                call_ms=call_ms), (syms, tables, got)


def decode_phase(dev, encoded):
    import torch
    from repro_torch.core import coder, u32
    from repro_torch.core.bitstream import ChunkedLanes
    from repro_torch.kernels import rans_decode

    syms, tables, enc_out = encoded
    enc = coder.chunk_encoded(ChunkedLanes(*enc_out), 0)
    buf = enc.buf.contiguous()
    dec = coder.decoder_init(enc)
    s0, p0 = u32.bits(dec.s), dec.ptr.to(torch.int32)
    cands = torch.topk(tables.freq[:CHUNK], TOPK, dim=-1).indices.to(
        torch.int32)                         # (CHUNK, lanes, topk)
    err = 0
    sk, pk, sp, pp = s0, p0, s0, p0
    for t in range(CHUNK):
        args = (tables.freq[t], tables.cdf[t])
        got = rans_decode.rans_decode_step(buf, sk, pk, *args,
                                           candidates=cands[t])
        ref = rans_decode.rans_decode_step_plain(buf, sp, pp, *args,
                                                 candidates=cands[t])
        err = max(err, _max_abs_err(got, ref))
        _check(torch.equal(ref[2], syms[:, t]), "plain decode lost a symbol")
        sk, pk, sp, pp = got[0], got[1], ref[0], ref[1]
    torch.cuda.synchronize()
    _check(int(ref[4].sum()) == 0 and torch.equal(
        pp.long(), (enc.start + enc.length).long()),
        "decode did not end exactly at the stream ends")
    print(f"B2 decode step: kernel == plain at every one of {CHUNK} steps "
          f"over a {LANES}-lane stream (per-lane (lanes, K) rows, top-{TOPK}"
          " candidates)", flush=True)
    step_args = (buf, s0, p0, tables.freq[0], tables.cdf[0])
    def step():
        return rans_decode.rans_decode_step(*step_args, candidates=cands[0])

    ms = _device_ms(step, n=100)
    call_ms = _median_ms(step, repeats=200, warmup=10)
    plain_ms = _median_ms(lambda: rans_decode.rans_decode_step_plain(
        *step_args, candidates=cands[0]), repeats=20)
    one = rans_decode.rans_decode_step_plain(*step_args, candidates=cands[0])
    # a lane pays min(probes, topk) candidate checks (cdf[c], cdf[c+1]) and
    # the rest as bisection probes (cdf[mid]); cdf[x] is read by then
    cand_probes = int(one[3].clamp(max=TOPK).sum())
    bisect_probes = int(one[3].sum()) - cand_probes
    read = int((one[1] - p0).sum())
    moved = (LANES * (8 + 4 * TOPK + 4 + 20)  # s, ptr, cands, f[x], outputs
             + 8 * cand_probes + 4 * bisect_probes + read)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"B2 decode step: {ms:.4f} ms kernel on the device "
          f"({call_ms:.4f} ms per wrapper call), {plain_ms:.3f} ms plain, "
          f"bound {bound_ms:.8f} ms ({moved} B moved); launch-bound",
          flush=True)
    return dict(name="rans_decode_step", route="cuda",
                source="src/repro_torch/csrc/rans_decode_step.cu",
                replaces="src/repro/kernels/rans_decode.py:560",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None,
                call_ms=call_ms)


def reference_check(dev):
    """The model on the card vs the same model on the CPU, small input."""
    import torch
    from repro_torch.configs.ras_pimc import SMOKE
    from repro_torch.models import decode_step, init_model, init_state

    toks = torch.randint(0, 256, (4, 8),
                         generator=torch.Generator().manual_seed(0))
    worst = 0.0
    models = [init_model(SMOKE, seed=3, device=d) for d in ("cpu", dev)]
    states = [init_state(m, 4, 8) for m in models]
    for t in range(8):
        lg = [decode_step(m, st, toks[:, t:t + 1].to(m.embedding.device), t)
              for m, st in zip(models, states)]
        _check(bool(torch.isfinite(lg[1]).all()), "non-finite logits")
        worst = max(worst, float((lg[1].cpu() - lg[0]).abs().max()))
    _check(worst <= 1e-4, f"card logits differ from CPU logits by {worst}")
    print(f"reference check: smoke-model logits, card vs CPU, 8 steps: max "
          f"abs diff {worst:.3e} (tolerance 1e-4)", flush=True)


def main_path(dev):
    import numpy as np
    import torch
    from repro_torch.configs.ras_pimc import CONFIG
    from repro_torch.core import bitstream
    from repro_torch.data.pipeline import token_stream
    from repro_torch.kernels import rans_decode, rans_encode
    from repro_torch.models import init_model
    from repro_torch.serve import compress

    model = init_model(CONFIG, seed=0, device=dev)
    tokens = token_stream(CONFIG.vocab_size, (LANES, T), seed=0)
    rans_encode.LAUNCHES = 0
    rans_decode.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = compress.lm_compress_chunked(model, tokens, CHUNK, backend="kernel")
    torch.cuda.synchronize()
    t_comp = time.perf_counter() - t0
    blob = bitstream.pack_chunked(*st.chunks, chunk_size=CHUNK, n_symbols=T)
    cs = bitstream.parse_chunked(blob)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sym, avg, lane_probes = compress.lm_decompress_chunked(
        model, cs, T, CHUNK, backend="kernel", lane_probes=True)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches = {"rans_encode_lanes": rans_encode.LAUNCHES,
                "rans_decode_step": rans_decode.LAUNCHES}
    _check(launches == {"rans_encode_lanes": 1, "rans_decode_step": T},
           f"launch counts {launches}")
    _check(np.array_equal(sym.cpu().numpy(), tokens), "round trip not exact")
    print(f"slice: {CONFIG.name} ({CONFIG.n_layers} layers, d_model "
          f"{CONFIG.d_model}), {LANES} lanes x {T} tokens, chunk {CHUNK}: "
          f"round trip bit-exact; launches {launches}", flush=True)
    print(f"slice: bits/symbol {float(st.bits_per_symbol):.4f}, model xent "
          f"{float(st.model_xent_bits):.4f} bits, avg probes/symbol "
          f"{float(avg):.4f}, container {len(blob)} bytes", flush=True)
    print(f"slice: compress {LANES * T / t_comp:.1f} symbols/s "
          f"({t_comp:.3f} s), decompress {LANES * T / t_dec:.1f} symbols/s "
          f"({t_dec:.3f} s); idle gaps not measured", flush=True)

    st_c = compress.lm_compress_chunked(model, tokens, CHUNK, backend="coder")
    blob_c = bitstream.pack_chunked(*st_c.chunks, chunk_size=CHUNK,
                                    n_symbols=T)
    _check(blob_c == blob, "coder and kernel containers differ")
    sym_c, avg_c, lane_probes_c = compress.lm_decompress_chunked(
        model, cs, T, CHUNK, backend="coder", lane_probes=True)
    _check(np.array_equal(sym_c.cpu().numpy(), tokens),
           "coder round trip not exact")
    _check(torch.equal(lane_probes_c, lane_probes), "per-lane probes differ")
    print("slice: coder backend on the card: byte-identical container, "
          "equal per-lane probes", flush=True)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.device import configure_cuda_numerics, resolve_device
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    configure_cuda_numerics()
    dev = resolve_device(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from repro_torch.kernels import _build
    secs = _build.build_all(verbose=True)
    print(f"build: {secs:.2f} s for {len(list(_build.CSRC.glob('*.cu')))} "
          "sources", flush=True)

    b1, encoded = encode_phase(dev)
    b2 = decode_phase(dev, encoded)
    del encoded
    torch.cuda.empty_cache()
    reference_check(dev)
    launches = main_path(dev)
    for rec in (b1, b2):
        rec["launches"] = launches[rec["name"]]
    print(json.dumps({"kernels": [b1, b2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
