"""Architecture registry: the reference's ids and their configs.

Port of ``repro.configs.registry``'s lookup surface.  Every id the
reference registers is listed in :data:`ARCH_IDS` and ported
(:data:`PORTED`), each resolving from its own module here; an unknown id
raises the reference's unknown-arch ``KeyError``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "llama-3.2-vision-11b",
    "qwen1.5-4b",
    "qwen3-4b",
    "qwen3-32b",
    "llama3-405b",
    "mixtral-8x22b",
    "phi3.5-moe-42b-a6.6b",
    "mamba2-130m",
    "seamless-m4t-large-v2",
    "recurrentgemma-2b",
    # the paper's own compact image-probability model (extra, not in the grid)
    "ras-pimc",
)

# the ids whose configs this package holds: every registered id
PORTED = ARCH_IDS

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}

# the archs whose smoke configs the reference wires end to end through the
# serve stack, one per state shape: pure ring (dense), pure recurrent
# (ssm), and ring + recurrent hybrid
SERVE_SMOKE_ARCHS = ("ras-pimc", "mamba2-130m", "recurrentgemma-2b")


def _module(arch: str) -> str:
    try:
        mod = _MODULES[arch]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch!r}: registered ids are "
            f"{', '.join(ARCH_IDS)}") from None
    return mod


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_module(arch)}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_module(arch)}")
    return mod.SMOKE


def get_protocol(arch: str):
    """The arch's :class:`repro_torch.models.protocol.ModelProtocol`."""
    from repro_torch.models import get_protocol as _by_cfg
    return _by_cfg(get_config(arch))
