"""Roofline analysis of a traced dry-run cell at the H100's published
peaks.

Port of ``repro.analysis.roofline``.  The reference's machine is the TPU
v5e; the port's is one NVIDIA H100 SXM (80 GB HBM3, 700 W), and these
constants are the port's one source of the card's peaks (``chip_smoke.py``'s
kernel bounds read them):

  * compute: 989 TFLOP/s dense BF16 (tensor cores) and 67 TFLOP/s float32
    (outside the tensor cores: ``configure_cuda_numerics`` turns TF32
    off), NVIDIA H100 data sheet, SXM;
  * memory: 3.35 TB/s HBM3 and 80 GB, the same data sheet;
  * integers: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (the coders'
    kernels do integer work; the float32 rate counts an FMA as two
    operations and runs on twice the lanes);
  * interconnect: 450 GB/s a direction inside one 8-GPU node (fourth
    generation NVLink, 900 GB/s per GPU in both directions, the data
    sheet), 50 GB/s a direction between nodes (one 400 Gb/s ConnectX-7
    port per GPU, NVIDIA DGX H100 data sheet).

The three terms of a cell (:func:`analyze`), per rank:

    compute_s    = traced FLOPs / the peak of cfg.dtype
    memory_s     = traced bytes / HBM rate
    collective_s = sum over collectives of bytes / the rate of its axes

These are reckonings at published peaks, not measurements.  The trace
(``analysis/hlo.py``) runs every layer and microbatch of the step, so
:func:`scan_multiplier` (the reference's loop-trip correction for
XLA:CPU's cost analysis, which counts a loop body once) is kept for the
reference's numbers and not applied here.  MODEL_FLOPS is 6·N·D (train),
2·N·D (prefill), 2·N·B (decode), N the active parameters; under the
compute placement each rank computes its own share of them.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass

from repro_torch.analysis.hlo import StepTrace
from repro_torch.configs.registry import ShapeSpec
from repro_torch.models.config import ModelConfig

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
INT32_OPS_PER_S = 132 * 64 * 1.98e9
NVLINK_BYTES_PER_S = 450e9
NETWORK_BYTES_PER_S = 50e9
NODE_GPUS = 8
# per-block shared memory: single-sourced from the kernels' launch plan so
# the machine model and the kernels' geometry cannot disagree (tests pin
# the re-export; kernels/autotune.py owns the number)
from repro_torch.kernels.autotune import SMEM_BYTES  # noqa: E402,F401


def kernel_bound(moved: int, ops: int) -> tuple[float, str]:
    """The least time for a kernel's work, in ms, and what bounds it: the
    bytes moved over the memory rate or the integer operations over the
    INT32 rate, whichever is larger."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def link_rate(mesh, axes) -> float:
    """Bytes/s a direction for a collective over ``axes`` of ``mesh``
    (ranks laid out row-major over the axes, ``NODE_GPUS`` a node): NVLink
    when every axis stays inside one node, else the network."""
    names = list(mesh.axis_names)
    for a in axes:
        i = names.index(a)
        stride = math.prod(mesh.shape[b] for b in names[i + 1:])
        span = stride * mesh.shape[a]
        if span > NODE_GPUS or NODE_GPUS % span:
            return NETWORK_BYTES_PER_S
    return NVLINK_BYTES_PER_S


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    traced_flops_per_chip: float
    traced_bytes_per_chip: float
    collective_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_total: float
    model_flops_per_chip: float
    useful_flops_ratio: float     # MODEL / traced per chip
    roofline_s: float             # max of the three terms
    bound_fraction: float         # dominant / sum  (how bound we are)
    peak_fraction: float          # model-useful compute / roofline time
    peak_flops: float             # the compute peak used (cfg.dtype)
    collectives: dict | None = None
    memory_per_chip_bytes: float | None = None
    scan_multiplier: float = 1.0  # loop-trip correction applied (none)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    n = cfg.active_param_count_estimate()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one new token per sequence
    return 2.0 * n * shape.global_batch


def scan_multiplier(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """The reference's loop-trip correction: its CPU cost analysis counts
    each scanned layer stack (and the grad-accumulation scan) once.  The
    port's trace counts every layer and microbatch, so :func:`analyze`
    does not apply it."""
    reps = sum(r for _, r in cfg.stages)
    mult = float(max(reps, 1))
    if shape.kind == "train":
        mult *= max(cfg.grad_accum, 1)
    return mult


def analyze(rec: StepTrace, coll: dict, cfg: ModelConfig, shape: ShapeSpec,
            arch: str, mesh, mesh_name: str,
            memory_bytes: float | None = None) -> RooflineReport:
    """The three terms of one rank's traced step ``rec`` with the
    collective bytes ``coll`` (``hlo.collective_stats``), the compute peak
    picked by ``cfg.dtype``."""
    chips = mesh.size
    peak = PEAK_FLOPS[cfg.dtype]
    compute_s = rec.flops / peak
    memory_s = rec.bytes_moved / HBM_BYTES_PER_S
    collective_s = sum(b / link_rate(mesh, [a for a in axes.split(",") if a])
                       for axes, b in coll["by_axes"].items() if axes)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    mf_chip = mf / chips
    roof = max(terms.values())
    total = sum(terms.values()) or 1.0
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        traced_flops_per_chip=rec.flops, traced_bytes_per_chip=rec.bytes_moved,
        collective_bytes_per_chip=coll["total_bytes"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        model_flops_total=mf, model_flops_per_chip=mf_chip,
        useful_flops_ratio=(mf_chip / rec.flops) if rec.flops else 0.0,
        roofline_s=roof,
        bound_fraction=roof / total,
        peak_fraction=(mf_chip / peak) / roof if roof else 0.0,
        peak_flops=peak,
        collectives={k: v for k, v in coll.items() if k != "total_bytes"},
        memory_per_chip_bytes=memory_bytes,
    )


def markdown_row(r: RooflineReport) -> str:
    mem_gb = (r.memory_per_chip_bytes or 0) / 1e9
    return (f"| {r.arch} | {r.shape} | {r.mesh} | "
            f"{r.compute_s*1e3:.2f} | {r.memory_s*1e3:.2f} | "
            f"{r.collective_s*1e3:.2f} | **{r.dominant}** | "
            f"{r.useful_flops_ratio:.2f} | {r.peak_fraction:.2%} | "
            f"{mem_gb:.2f} |")


MD_HEADER = ("| arch | shape | mesh | compute ms | memory ms | coll ms | "
             "dominant | useful/traced | peak frac | GB/card |\n"
             "|---|---|---|---|---|---|---|---|---|---|")
