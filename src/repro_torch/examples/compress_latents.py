"""Bits-back latent compression over the rANS stack.

    PYTHONPATH=src python -m repro_torch.examples.compress_latents \
        [--steps 600] [--device cpu]

Port of ``examples/compress_latents.py``: trains the small Bit-Swap
hierarchical VAE (``models/vae.py``) on synthetic image patches, then codes
a held-out image with bits-back over the stack (``core/stack.py``): latent
bins pop against the posterior, pixels and latents push against the
generative model, and the posterior's recovered bits pay the latent
overhead back.  Checks: a bit-exact round trip on both pop backends (the
pure-torch coder and the per-step decode kernel, B2), the stack's initial
bits restored exactly (the bits-back identity), byte-identical stacks from
the two backends, and a net rate below the static-histogram rANS
baseline's.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import entry_device
from repro_torch.core import stack
from repro_torch.data.pipeline import synthetic_image
from repro_torch.examples import require
from repro_torch.models import vae
from repro_torch.serve.compress import histogram_compress

LANES, D_X = 64, 64       # 64 patches of 8x8 pixels per image
CAP = 4096


def patches(img: np.ndarray) -> np.ndarray:
    """64x64 image -> (64 patches, 64 pixels) rows (8x8 tiles)."""
    return img.reshape(8, 8, 8, 8).transpose(0, 2, 1, 3).reshape(LANES, D_X)


def _same(a: stack.StackState, b: stack.StackState) -> bool:
    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def run(steps: int, device) -> dict:
    dev = torch.device(device)
    cfg = vae.VAEConfig(d_x=D_X)
    params, loss = vae.train_vae(
        cfg, lambda i: patches(synthetic_image(64, 64, seed=i)).astype(
            np.int64), steps=steps, lr=1e-2, seed=0, device=dev)
    print(f"VAE trained: ELBO {loss / np.log(2) / D_X:.3f} bits/pixel")

    x = torch.as_tensor(patches(synthetic_image(64, 64, seed=999)),
                        dtype=torch.int64, device=dev)
    n_pixels = LANES * D_X

    # bits-back encode onto a stack seeded with initial bits; the message's
    # net cost is the stack's byte growth (the initial bits are capital,
    # and the decode side's pushes restore them exactly)
    st0 = stack.stack_init_bits(LANES, CAP, n_bytes=64, seed=7, device=dev)
    bytes0 = stack.stack_bytes(st0)
    st = vae.bb_encode(st0, params, x, cfg)
    net = int((stack.stack_bytes(st) - bytes0).sum())
    print(f"bits-back: {net} net bytes for {n_pixels} pixels "
          f"({net * 8 / n_pixels:.3f} bpp)")

    # decode is the exact reverse schedule: the pixels and the initial
    # stack both come back bit for bit
    st_d, x_d = vae.bb_decode(st, params, cfg)
    require(torch.equal(x_d, x), "bb_decode pixels")
    require(torch.equal(st_d.s, st0.s) and torch.equal(st_d.ptr, st0.ptr),
            "bb_decode did not restore the initial stack")
    require(not bool(st_d.underflow.any()), "bb_decode underflowed")
    print("round trip: pixels bit-exact, initial stack bits restored")

    # the same schedule with every pop through the per-step decode kernel:
    # a byte-identical stack, so the kernel is a drop-in
    st_k = vae.bb_encode(st0, params, x, cfg, backend="kernel")
    require(torch.equal(st_k.buf, st.buf) and torch.equal(st_k.s, st.s),
            "kernel and coder stacks differ")
    st_kd, x_kd = vae.bb_decode(st_k, params, cfg, backend="kernel")
    require(torch.equal(x_kd, x) and torch.equal(st_kd.s, st0.s),
            "kernel bb_decode")
    print("kernel pop backend: byte-identical stack, same round trip")

    # a flushed stack rides the container tooling
    st_r = stack.stack_open(stack.stack_flush(st))
    require(torch.equal(st_r.s, st.s), "stack_open of stack_flush")

    # baseline: static-histogram rANS over the same pixels
    hist_enc, _ = histogram_compress(x, 256, device=dev)
    hist = int(hist_enc.length.sum())
    print(f"histogram baseline: {hist} bytes ({hist * 8 / n_pixels:.3f} bpp)")
    require(net < hist, f"bits-back ({net} B) should beat the histogram "
            f"baseline ({hist} B)")
    print(f"bits-back beats histogram by {(1 - net / hist) * 100:.1f}%")
    return dict(net_bytes=net, hist_bytes=hist,
                elbo_bits_per_pixel=loss / np.log(2) / D_X)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600,
                    help="VAE training steps (the reference's 600)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    return run(args.steps, entry_device(args.device))


if __name__ == "__main__":
    main()
