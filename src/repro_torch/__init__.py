"""PyTorch/CUDA port of the RAS neural lossless compression pipeline.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/``, ``models/``, ``serve/``, ``configs/``, ``data/``,
``train/``, ``launch/``; the reference's ``examples/`` and its lane and
chunk sweeps under ``examples/`` and ``benchmarks/``)
and never imports ``jax`` or ``repro``.  Each of the reference's six TPU
kernels is a hand-written CUDA kernel for ``sm_90a`` under ``csrc/``: the
fused and the records encode (``rans_encode.cu``), the per-step decode
(``rans_decode_step.cu``), the full-stream and slab decodes
(``rans_decode_lanes.cu``) and the SPC quantizer (``spc_quantize.cu``).
Each sits beside a plain PyTorch version of the same arithmetic, which
runs for CPU tensors (the CPU test tier) and is the kernel's yardstick on
the card.

Entry points (``models.init_model``, ``serve.compress``) run on the card
unless the caller passes ``device="cpu"``; without CUDA and without an
explicit device they raise.  A process that runs them on the card calls
:func:`configure_cuda_numerics` once at its start.
"""

from repro_torch.device import (configure_cuda_numerics, entry_device,
                                resolve_device)

__all__ = ["configure_cuda_numerics", "entry_device", "resolve_device"]
