"""SPC quantization (BF16 probabilities -> fixed point): the CUDA kernel
and its plain version.

Replaces the TPU kernel ``repro/kernels/spc_quantize.py::spc_quantize``
(body ``_spc_quantize_kernel``).  :func:`spc_quantize` takes ``(B, K)``
float probabilities and returns ``(B, K)`` int32 frequencies, each row
summing to ``2**prob_bits`` with every entry ``>= 1``: ``f0 = max(1,
round(bf16(p) * 2**n))``, then the stable largest-remainder top-up or the
smallest-residual waterfill.  The plain version is
:func:`repro_torch.core.spc.quantize_probs`.

It dispatches on the probabilities' device: a CPU tensor runs the plain
version, a CUDA tensor launches ``csrc/spc_quantize.cu`` (one block per
row, built by ``kernels/_build.py``) and counts the launch in
``repro_torch.kernels.LAUNCHES``.  There is no fallback between the two.

On this card the kernel is operation-bound: it keeps the TPU kernel's dense
pairwise ranking, O(K**2) compares per row, against a byte bound of 8 B
per entry.  Its exact 64-bit sums replace the TPU kernel's float32 prefix
sum, which is exact only below 2**24.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import constants as C
from repro_torch.core import spc
from repro_torch.kernels import LAUNCHES

# the kernel's shared-memory layout holds 12 B per symbol: resid, f0 and
# rank_asc (kMaxK in csrc/spc_quantize.cu)
MAX_K = 16384


def spc_quantize_plain(probs: torch.Tensor,
                       prob_bits: int = C.PROB_BITS) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the sort-based
    :func:`~repro_torch.core.spc.quantize_probs` on float32 inputs."""
    return spc.quantize_probs(probs.to(torch.float32), prob_bits)


def _load():
    from repro_torch.kernels import _build
    fn = _build.load("spc_quantize").spc_quantize_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn, _build.check


def _launch(probs: torch.Tensor, prob_bits: int) -> torch.Tensor:
    fn, check = _load()
    b, k = probs.shape
    p = probs.to(torch.float32).contiguous()
    freq = torch.empty((b, k), dtype=torch.int32, device=probs.device)
    stream = torch.cuda.current_stream(probs.device).cuda_stream
    check(fn(p.data_ptr(), b, k, prob_bits, freq.data_ptr(), stream),
          "spc_quantize")
    LAUNCHES["spc_quantize"] += 1
    return freq


def spc_quantize(probs: torch.Tensor,
                 prob_bits: int = C.PROB_BITS) -> torch.Tensor:
    """Batched BF16 -> fixed-point quantization (B6, one launch on CUDA).

    ``probs`` is ``(B, K)`` float with any ``B >= 1`` (the TPU kernel's
    ``batch_block`` divisibility is a TPU tiling rule and is dropped); the
    values go through float32, then BF16.  Returns ``(B, K)`` int32
    frequencies, equal to :func:`~repro_torch.core.spc.quantize_probs`.
    Raises ``ValueError`` for a rank other than 2, an empty batch, ``K >
    2**prob_bits``, and a ``K`` beyond the kernel's shared-memory layout
    (:data:`MAX_K`), on either device.
    """
    C.check_prob_bits(prob_bits)
    if probs.ndim != 2:
        raise ValueError(f"spc_quantize takes (B, K) probabilities; got "
                         f"shape {tuple(probs.shape)}")
    b, k = probs.shape
    if b < 1 or k < 1:
        raise ValueError(f"spc_quantize needs B >= 1 and K >= 1; got "
                         f"{tuple(probs.shape)}")
    if k > 1 << prob_bits:
        raise ValueError(f"alphabet size {k} exceeds 2**prob_bits="
                         f"{1 << prob_bits}; raise prob_bits")
    if k > MAX_K:
        raise ValueError(f"alphabet size {k} exceeds the spc_quantize "
                         f"kernel's shared-memory layout (K <= {MAX_K})")
    if probs.device.type == "cpu":
        return spc_quantize_plain(probs, prob_bits)
    if probs.device.type == "cuda":
        return _launch(probs, prob_bits)
    raise ValueError(f"unsupported device {probs.device}")
