"""PyTorch/CUDA port of the RAS neural lossless compression pipeline.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/``, ``models/``, ``serve/``, ``configs/``, ``data/``)
and never imports ``jax`` or ``repro``.  The two TPU kernels on the main
path are hand-written CUDA kernels for ``sm_90a`` under ``csrc/``; each sits
beside a plain PyTorch version of the same arithmetic, which runs for CPU
tensors (the CPU test tier) and is the kernel's yardstick on the card.

Entry points (``models.init_model``, ``serve.compress``) run on the card
unless the caller passes ``device="cpu"``; without CUDA and without an
explicit device they raise.  A process that runs them on the card calls
:func:`configure_cuda_numerics` once at its start.
"""

from repro_torch.device import configure_cuda_numerics, resolve_device

__all__ = ["configure_cuda_numerics", "resolve_device"]
