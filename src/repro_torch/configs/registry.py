"""Architecture registry: the reference's ids and their configs.

Port of ``repro.configs.registry``.  Every id the reference registers
is listed in :data:`ARCH_IDS` and ported (:data:`PORTED`), each resolving
from its own module here; an unknown id raises the reference's
unknown-arch ``KeyError``.  :data:`SHAPES` is the reference's table of
input shapes and :func:`grid` its (arch x shape) cells of the dry-run
(``launch/dryrun.py``).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

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


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


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


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped): full quadratic attention does not
    take the 524k-token context."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full quadratic attention at 524k context; "
                       "sub-quadratic archs only (DESIGN.md "
                       "§Arch-applicability)")
    return True, ""


def grid():
    """All 40 (arch, shape, runnable, reason) cells: every id but
    ``ras-pimc`` against every shape."""
    for arch in ARCH_IDS:
        if arch == "ras-pimc":
            continue
        cfg = get_config(arch)
        for sname, sh in SHAPES.items():
            ok, why = shape_applicable(cfg, sh)
            yield arch, sname, ok, why
