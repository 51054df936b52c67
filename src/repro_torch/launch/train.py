"""Training launcher.

    python -m repro_torch.launch.train --arch ras-pimc --steps 200 \
        --batch 8 --seq 128 --ckpt ./ckpt

Port of ``repro.launch.train``: the full fault-tolerant loop
(``RestartManager`` + ``StragglerMonitor`` + periodic checkpoints in the
reference's layout) on the smoke config of the chosen arch, with seeded
random initial weights and ``data.pipeline.train_batch`` batches.  It runs
on the card unless ``--device cpu``.  Like the reference, it starts from
step 0 (a directory's older steps are overwritten as the run reaches
them).  Serve the result with ``python -m repro_torch.launch.serve --ckpt
<dir>``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import entry_device
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import train_batch
from repro_torch.models import init_model
from repro_torch.train.fault_tolerance import RestartManager
from repro_torch.train.train_loop import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ras-pimc")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = entry_device(args.device)
    cfg = get_smoke_config(args.arch).with_(grad_accum=1)
    model = init_model(cfg, seed=0, device=dev)
    state = init_train_state(model, moment_dtype="float32")  # as JAX's
    step_fn = make_train_step(cfg, base_lr=args.lr)

    last_loss = [None]

    def wrapped(state, batch):
        state, metrics = step_fn(state, batch)
        last_loss[0] = float(metrics["loss"])
        if int(state.step) % 10 == 0:
            print(f"step {int(state.step):5d} loss {last_loss[0]:.4f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        return state, metrics

    def batch_fn(i):
        return train_batch(cfg, args.batch, args.seq, step=i)

    mgr = RestartManager(args.ckpt, save_every=args.save_every)
    state = mgr.run(state, wrapped, batch_fn, args.steps)
    loss = "n/a" if last_loss[0] is None else f"{last_loss[0]:.4f}"
    print(f"done: {int(state.step)} steps, final loss {loss}, "
          f"{len(mgr.monitor.slow_steps)} straggler steps, "
          f"{mgr.failures} restarts")
    return state


if __name__ == "__main__":
    main()
