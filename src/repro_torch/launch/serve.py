"""Serving / compression launcher (the paper's deployment direction).

    python -m repro_torch.launch.serve --arch ras-pimc --mode compress \
        --lanes 8 --symbols 256 --backend kernel
    python -m repro_torch.launch.serve --mode engine --streams 6 --slots 2 \
        --arrival-rate 0.5 --backend kernel

Port of ``repro.launch.serve``; it runs on the card unless ``--device
cpu``.  ``--mode compress`` runs one stream end to end: SPC, multi-lane
rANS encode, prediction-guided decode, bit-exactness check.  ``--mode
generate`` runs a greedy rollout.  ``--mode engine`` drives the batched
multi-stream engine: ``--streams`` compress requests with seeded Poisson
arrivals (``--arrival-rate`` per virtual tick) continuously batched into
``--slots`` slots; every blob is checked byte-identical to the
single-request ``lm_compress_chunked`` path and per-request latency
(admission wait included) is reported in ticks.  Like the reference, the
launcher serves the arch's smoke config: on seeded random weights, or with
``--ckpt <dir>`` on the newest complete step of a checkpoint that either
package's ``launch.train`` wrote (``restored checkpoint step N``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import entry_device
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core import bitstream
from repro_torch.data.pipeline import token_stream
from repro_torch.models import init_model, state_spec
from repro_torch.serve.compress import (lm_compress, lm_compress_chunked,
                                        lm_decompress)
from repro_torch.serve.engine import BatchEngine, generate
from repro_torch.train import checkpoint
from repro_torch.train.train_loop import init_train_state


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _engine(args, model, cfg, dev) -> None:
    if args.backend == "two_pass":
        raise SystemExit("--mode engine steps with --backend coder or "
                         "kernel (two_pass is a single-request decode)")
    rng = np.random.default_rng(args.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                         size=args.streams))
    streams = [np.asarray(token_stream(cfg.vocab_size,
                                       (args.lanes, args.symbols),
                                       seed=100 + i), np.int64)
               for i in range(args.streams)]
    eng = BatchEngine(model, slots=args.slots, lanes=args.lanes,
                      chunk_size=args.chunk_size, max_len=args.symbols,
                      topk=args.topk, step_backend=args.backend, device=dev)
    rids = [eng.submit_compress(s, arrival=float(a))
            for s, a in zip(streams, arrivals)]
    t0 = time.time()
    res = eng.run(clock="virtual")
    _sync(dev)
    wall = time.time() - t0
    lat = []
    for rid, toks in zip(rids, streams):
        r = res[rid]
        if not r.ok:
            raise SystemExit(f"request {rid} failed: {r.error}")
        stats = lm_compress_chunked(model, toks, args.chunk_size,
                                    backend=args.backend, device=dev)
        ref = bitstream.pack_chunked(*stats.chunks,
                                     chunk_size=args.chunk_size,
                                     n_symbols=args.symbols)
        if r.blob != ref:
            raise SystemExit(f"request {rid}: engine blob diverged from the "
                             "single-request path")
        lat.append(r.completed_at - r.arrival)
    lat = np.sort(np.asarray(lat))
    print(f"engine: {args.streams} streams x {args.lanes} lanes x "
          f"{args.symbols} symbols through {args.slots} slots "
          f"({eng.prefill_cycles} prefill cycles)")
    print(f"  wall {wall:.2f}s  throughput "
          f"{args.streams / wall:.2f} streams/s")
    print(f"  virtual latency (ticks): p50 {np.percentile(lat, 50):.1f} "
          f" p99 {np.percentile(lat, 99):.1f}")
    print(f"  all {args.streams} blobs byte-identical to the "
          "single-request path")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ras-pimc", metavar="ARCH",
                    help="a registered arch id (configs.registry.ARCH_IDS)")
    ap.add_argument("--mode", choices=["compress", "generate", "engine"],
                    default="compress",
                    help="compress = one stream end to end; generate = "
                         "greedy rollout; engine = batched multi-stream "
                         "serving (continuous batching, Poisson arrivals)")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--symbols", type=int, default=256)
    ap.add_argument("--streams", type=int, default=6,
                    help="[engine] number of concurrent compress requests")
    ap.add_argument("--slots", type=int, default=2,
                    help="[engine] co-batched request slots (rows = slots "
                         "* lanes)")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="[engine] Poisson arrival rate per virtual tick "
                         "(one tick ~= one chunk cycle)")
    ap.add_argument("--chunk-size", type=int, default=16,
                    help="[engine] symbols per lane per scheduling chunk")
    ap.add_argument("--seed", type=int, default=0,
                    help="[engine] arrival-process seed (schedules are "
                         "deterministic per seed)")
    ap.add_argument("--ckpt", default=None,
                    help="a checkpoint directory (either package's "
                         "launch.train writes one): the newest complete "
                         "step is served; without one, seeded random "
                         "weights")
    ap.add_argument("--topk", type=int, default=4)
    ap.add_argument("--backend", choices=["coder", "kernel", "two_pass"],
                    default="coder",
                    help="rANS datapath: 'coder' = the plain SPC and the "
                         "pure-torch lane coder; 'kernel' = the CUDA "
                         "kernels (the fused decode; the engine's B2/B6/B1 "
                         "steps); 'two_pass' = the coder scan, then one "
                         "full-stream decode kernel launch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    if args.arch not in ARCH_IDS:
        ap.error(f"unknown --arch {args.arch!r}; registered ids: "
                 f"{', '.join(ARCH_IDS)}")
    dev = entry_device(args.device)
    try:
        cfg = get_smoke_config(args.arch)
    except KeyError as e:
        ap.error(str(e))
    spec = state_spec(cfg)
    state_kind = ("ring+recurrent" if spec.ring and spec.recurrent
                  else "recurrent" if spec.recurrent else "ring")
    print(f"arch={args.arch} family={cfg.family} kinds={spec.kinds} "
          f"state={state_kind} device={dev}")
    model = init_model(cfg, seed=0, device=dev)
    if args.ckpt:
        step = checkpoint.latest_step(args.ckpt)
        if step is not None:
            checkpoint.restore(args.ckpt, step, init_train_state(
                model, moment_dtype="float32"))
            print(f"restored checkpoint step {step}")

    if args.mode == "engine":
        _engine(args, model, cfg, dev)
        return

    if args.mode == "generate":
        prompt = torch.as_tensor(token_stream(cfg.vocab_size, (2, 16),
                                              seed=1), device=dev)
        out = generate(model, prompt, 32, max_len=64)
        print("generated:", out.cpu().numpy())
        return

    toks = np.asarray(token_stream(cfg.vocab_size, (args.lanes, args.symbols),
                                   seed=7), np.int64)
    t0 = time.time()
    enc_backend = "coder" if args.backend == "coder" else "kernel"
    stats = lm_compress(model, toks, backend=enc_backend, device=dev)
    _sync(dev)
    t_enc = time.time() - t0
    blob = bitstream.pack(*stats.enc, n_symbols=args.symbols)
    t0 = time.time()
    dec, probes = lm_decompress(model, stats.enc, args.symbols,
                                topk=args.topk, backend=args.backend,
                                device=dev)
    _sync(dev)
    t_dec = time.time() - t0
    exact = bool(np.array_equal(dec.cpu().numpy(), toks))
    raw = args.lanes * args.symbols
    print(f"lanes={args.lanes} symbols/lane={args.symbols} "
          f"backend={args.backend}")
    print(f"  bits/symbol     : {float(stats.bits_per_symbol):.3f} "
          f"(model bound {float(stats.model_xent_bits):.3f})")
    print(f"  container bytes : {len(blob)} (raw {raw})  "
          f"CR={raw / len(blob):.3f}")
    print(f"  encode {t_enc:.2f}s  decode {t_dec:.2f}s  "
          f"avg CDF probes/symbol {float(probes):.2f}")
    print(f"  bit-exact roundtrip: {exact}")
    if not exact:
        raise SystemExit("round trip not bit-exact")


if __name__ == "__main__":
    main()
