"""SPC quantization (BF16 probabilities -> fixed point): the CUDA kernel
and its plain versions.

Replaces the TPU kernel ``repro/kernels/spc_quantize.py::spc_quantize``
(body ``_spc_quantize_kernel``).  :func:`spc_quantize` takes ``(B, K)``
float32 or bfloat16 probabilities and returns ``(B, K)`` int32
frequencies, each row summing to ``2**prob_bits`` with every entry ``>=
1``: ``f0 = max(1, round(bf16(p) * 2**n))``, then the stable
largest-remainder top-up or the smallest-residual waterfill.
:func:`spc_freq_cdf` also returns the ``(B, K+1)`` CDF rows, from the same
launch: the fused LM decode's per-position SPC.  The plain versions are
:func:`repro_torch.core.spc.quantize_probs` and
:func:`repro_torch.core.spc.freq_cdf_from_probs`.

It dispatches on the probabilities' device: a CPU tensor runs the plain
version, a CUDA tensor launches ``csrc/spc_quantize.cu`` (one warp per row
up to K = 1024, a block of 512 threads per row up to 16,384, and above, up
to the SPC's ceiling of 65,536 at ``prob_bits=16``, a thread-block cluster
per row that exchanges its totals through distributed shared memory;
built by ``kernels/_build.py``) and counts the launch in
``repro_torch.kernels.LAUNCHES``.  There is no fallback between the two.

The kernel replaces the reference's sort (and the TPU kernel's O(K**2)
pairwise ranking) by a radix select over an order-preserving key of the
residuals, index as the tiebreak, weighted by each entry's cap on the
waterfill: 32 group counts per row, so it is operation-bound at the
slice's K = 256 (``PERF.md``).  Its sums are exact 64-bit integers, where
the TPU kernel's float32 prefix sum is exact only below 2**24.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import constants as C
from repro_torch.core import spc
from repro_torch.kernels import LAUNCHES, autotune

# the cluster layout's eight blocks hold up to 65,536 entries
# (kernels/autotune.py, the launch plan): every K that 2**prob_bits admits
MAX_K = autotune.SPC_MAX_K

_FN = []          # the resolved ctypes launcher, once loaded


def _input(probs: torch.Tensor) -> torch.Tensor:
    """The kernel's input: bfloat16 as it is, anything else as float32
    (bf16 -> float32 -> bf16 is exact, so both give the same tables)."""
    if probs.dtype == torch.bfloat16:
        return probs
    return probs.to(torch.float32)


def spc_quantize_plain(probs: torch.Tensor,
                       prob_bits: int = C.PROB_BITS) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the sort-based
    :func:`~repro_torch.core.spc.quantize_probs` on the kernel's input."""
    return spc.quantize_probs(_input(probs), prob_bits)


def spc_freq_cdf_plain(probs: torch.Tensor, prob_bits: int = C.PROB_BITS):
    """Plain PyTorch version of :func:`spc_freq_cdf`:
    :func:`~repro_torch.core.spc.freq_cdf_from_probs`."""
    return spc.freq_cdf_from_probs(_input(probs), prob_bits)


def _fn():
    if not _FN:
        from repro_torch.kernels import _build
        fn = _build.load("spc_quantize").spc_quantize_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
        _FN.append((fn, _build.check, _build.stream))
    return _FN[0]


def _launch(probs: torch.Tensor, prob_bits: int, with_cdf: bool):
    fn, check, stream = _fn()
    b, k = probs.shape
    p = _input(probs).contiguous()
    dev = probs.device
    freq = torch.empty((b, k), dtype=torch.int32, device=dev)
    cdf = (torch.empty((b, k + 1), dtype=torch.int32, device=dev)
           if with_cdf else None)
    check(fn(p.data_ptr(), int(p.dtype == torch.bfloat16), b, k, prob_bits,
             freq.data_ptr(), cdf.data_ptr() if with_cdf else None,
             stream(dev)), "spc_quantize")
    LAUNCHES["spc_quantize"] += 1
    return freq, cdf


def _check(probs: torch.Tensor, prob_bits: int) -> str:
    """The named errors of both entry points; returns the device type."""
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
    if probs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {probs.device}")
    return probs.device.type


def spc_quantize(probs: torch.Tensor,
                 prob_bits: int = C.PROB_BITS) -> torch.Tensor:
    """Batched BF16 -> fixed-point quantization (B6, one launch on CUDA).

    ``probs`` is ``(B, K)`` float with any ``B >= 1`` (the TPU kernel's
    ``batch_block`` divisibility is a TPU tiling rule and is dropped);
    bfloat16 is read as it is, other types go through float32, then BF16.
    Returns ``(B, K)`` int32 frequencies, equal to
    :func:`~repro_torch.core.spc.quantize_probs`.  Raises ``ValueError``
    for a rank other than 2, an empty batch and ``K > 2**prob_bits``, on
    either device (the kernel's layouts cover every ``K <= 2**16``,
    :data:`MAX_K`).
    """
    if _check(probs, prob_bits) == "cpu":
        return spc_quantize_plain(probs, prob_bits)
    return _launch(probs, prob_bits, with_cdf=False)[0]


def spc_freq_cdf(probs: torch.Tensor, prob_bits: int = C.PROB_BITS):
    """:func:`spc_quantize` plus the CDF rows, in one launch on CUDA.

    Returns ``(freq (B, K), cdf (B, K+1))`` int32 with ``cdf[:, K] ==
    2**prob_bits``, equal to
    :func:`~repro_torch.core.spc.freq_cdf_from_probs` bit for bit; raises
    what :func:`spc_quantize` raises.
    """
    if _check(probs, prob_bits) == "cpu":
        return spc_freq_cdf_plain(probs, prob_bits)
    return _launch(probs, prob_bits, with_cdf=True)
