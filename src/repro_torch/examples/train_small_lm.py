"""End to end: train a compact probability model, then compress with it
(the paper's hardware-software codesign loop, Fig. 1).

    PYTHONPATH=src python -m repro_torch.examples.train_small_lm \
        [--steps 300] [--device cpu]

Port of ``examples/train_small_lm.py``:

1. trains ``ras-pimc`` on a synthetic token stream with the fault-tolerant
   loop (``RestartManager``: checkpoints and restart);
2. compresses held-out streams with the trained model on the kernel
   backend (the SPC kernel B6, the encode kernel B1);
3. decompresses them with the fused decode (B6 and the per-step decode
   kernel B2 at every position, the model's top-k as trial symbols),
   checks the round trip bit-exact and the kernel container
   byte-identical to the coder backend's;
4. compares the compression ratio with the static histogram's.

``run(cfg, steps, device)`` holds the body: ``__main__`` runs the smoke
config, as the reference does; a caller may pass the full ``CONFIG``, a
checkpoint cadence and a step at which to inject one fault.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import entry_device
from repro_torch.configs.ras_pimc import SMOKE
from repro_torch.core import bitstream
from repro_torch.data.pipeline import token_stream
from repro_torch.examples import require
from repro_torch.models import init_model
from repro_torch.serve.compress import (histogram_compress, lm_compress,
                                        lm_decompress)
from repro_torch.train.fault_tolerance import RestartManager
from repro_torch.train.train_loop import init_train_state, make_train_step

BATCH, SEQ, LR = 16, 128, 3e-3
LANES, T = 8, 256               # the held-out streams


def batch_fn(cfg, i: int) -> dict:
    toks = token_stream(cfg.vocab_size, (BATCH, SEQ + 1), seed=1000 + i)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def train(cfg, steps: int, device, ckpt_dir: str, *, save_every: int = 100,
          fault_at: int | None = None):
    """``steps`` train steps of a seeded ``cfg`` model under a
    ``RestartManager`` saving into ``ckpt_dir``; with ``fault_at`` one
    fault is raised before that step's first run.  Returns ``(state,
    manager, losses, step seconds)``, one loss and time per step run
    (replayed steps included)."""
    cfg = cfg.with_(grad_accum=1)
    state = init_train_state(init_model(cfg, seed=0, device=device))
    step_fn = make_train_step(cfg, base_lr=LR)
    losses, secs = [], []

    def wrapped(st, batch):
        t0 = time.perf_counter()
        st, m = step_fn(st, batch)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
        if int(st.step) % 50 == 0:
            print(f"  step {int(st.step):4d} loss "
                  f"{losses[-1] / np.log(2):.3f} bits/sym", flush=True)
        return st, m

    pending = [] if fault_at is None else [fault_at]

    def fault_hook(i):
        if pending and i == pending[0]:
            pending.pop()
            raise RuntimeError(f"injected fault before step {i}")

    mgr = RestartManager(ckpt_dir, save_every=save_every)
    state = mgr.run(state, wrapped, lambda i: batch_fn(cfg, i), steps,
                    fault_hook=fault_hook)
    return state, mgr, losses, secs


def compress_heldout(model, device) -> dict:
    """Held-out ``(LANES, T)`` tokens through the kernel backend and back;
    the checks of the reference plus kernel == coder container."""
    vocab = model.cfg.vocab_size
    test = token_stream(vocab, (LANES, T), seed=9)
    raw_bytes = LANES * T             # symbols are bytes-scale (vocab 256)
    enc_h, _ = histogram_compress(test, vocab, device=device)
    cr_hist = raw_bytes / bitstream.compressed_size(enc_h.length)

    t0 = time.perf_counter()
    stats = lm_compress(model, test, backend="kernel", device=device)
    blob = bitstream.pack(*stats.enc, n_symbols=T)
    t_enc = time.perf_counter() - t0
    cr_lm = raw_bytes / len(blob)
    print(f"\ncompression ratio: static-histogram {cr_hist:.3f} -> "
          f"trained neural {cr_lm:.3f} "
          f"(model entropy {float(stats.model_xent_bits):.2f} bits/sym)")

    t0 = time.perf_counter()
    dec, probes = lm_decompress(model, stats.enc, T, backend="kernel",
                                device=device)
    exact = np.array_equal(dec.cpu().numpy(), test)
    t_dec = time.perf_counter() - t0
    print(f"decompression bit-exact: {exact}; "
          f"avg CDF probes/symbol {float(probes):.2f} "
          f"(model-top-k speculation)")
    coder_blob = bitstream.pack(
        *lm_compress(model, test, backend="coder", device=device).enc,
        n_symbols=T)
    require(exact and cr_lm > cr_hist, f"round trip exact {exact}, CR "
            f"{cr_lm:.4f} against the histogram's {cr_hist:.4f}")
    require(coder_blob == blob, "kernel and coder containers differ")
    print("OK: neural rANS beats the classical static table, bit-exactly "
          "(kernel and coder containers byte-identical).")
    return dict(cr_hist=cr_hist, cr_lm=cr_lm, blob_bytes=len(blob),
                bits_per_symbol=float(stats.bits_per_symbol),
                model_xent_bits=float(stats.model_xent_bits),
                probes=float(probes), compress_s=t_enc, decompress_s=t_dec)


def run(cfg, steps: int, device, *, save_every: int = 100,
        fault_at: int | None = None) -> dict:
    """Train ``cfg`` for ``steps`` steps (checkpoints in a temporary
    directory), then :func:`compress_heldout`.  Returns its record with
    the train state, the restart count, the losses and step seconds."""
    print(f"training {cfg.name} for {steps} steps ...", flush=True)
    with tempfile.TemporaryDirectory() as ckpt:
        state, mgr, losses, secs = train(cfg, steps, device, ckpt,
                                         save_every=save_every,
                                         fault_at=fault_at)
    return dict(compress_heldout(state.model, device), state=state,
                failures=mgr.failures, losses=losses, step_s=secs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    return run(SMOKE, args.steps, entry_device(args.device))


if __name__ == "__main__":
    main()
