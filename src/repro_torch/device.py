"""Device resolution and the card's numeric settings.

Entry points take ``device=None`` to mean "the card": they never carry on
quietly on the CPU.  On CUDA the model path needs TF32 off and
deterministic algorithms, so that the per-step logits that price a stream
are the logits that decode it (the same code at the same shapes must round
identically run to run).  Those settings belong to the whole process, so
the caller makes them once, at its start, with
:func:`configure_cuda_numerics`; a CUDA entry point refuses to run without
them instead of changing them behind the caller's back.
"""

from __future__ import annotations

import os

import torch

_CUBLAS_WORKSPACES = (":4096:8", ":16:8")


def configure_cuda_numerics() -> None:
    """Full-float32 matmuls (no TF32) and deterministic algorithms, for the
    whole process.  Call it before the first CUDA call: cuBLAS reads
    ``CUBLAS_WORKSPACE_CONFIG`` when it starts.  An op without a
    deterministic CUDA implementation then raises.  The port writes every
    tensor it reads, so the fill of uninitialized memory that deterministic
    mode adds to each ``torch.empty`` is turned off."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", _CUBLAS_WORKSPACES[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False


def _check_cuda_numerics() -> None:
    unset = [name for name, bad in (
        ("TF32 matmuls off", torch.backends.cuda.matmul.allow_tf32),
        ("TF32 convolutions off", torch.backends.cudnn.allow_tf32),
        ("deterministic algorithms, raising",
         not torch.are_deterministic_algorithms_enabled()
         or torch.is_deterministic_algorithms_warn_only_enabled()),
        ("CUBLAS_WORKSPACE_CONFIG",
         os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in _CUBLAS_WORKSPACES),
    ) if bad]
    if unset:
        raise RuntimeError(
            f"the card's numeric settings are not in force ({', '.join(unset)}"
            "): call repro_torch.configure_cuda_numerics() once at process "
            "start, before the first CUDA call")


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given.
    A CUDA device also needs :func:`configure_cuda_numerics` in force."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch entry points run on the card by "
                "default; pass device='cpu' to run the plain PyTorch path")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        _check_cuda_numerics()
    return device
