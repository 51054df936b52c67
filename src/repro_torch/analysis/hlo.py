"""A traced step's op counts, FLOPs, bytes and activation memory, and the
bytes its placement moves between ranks.

Port of ``repro.analysis.hlo``.  The reference reads a compiled module's
HLO text.  The port has no HLO: :func:`trace` runs one rank's step on the
meta device (nothing is allocated or computed) under a
``TorchDispatchMode`` and records, for every aten op the step issues:

  * its name, for :func:`op_histogram`;
  * its FLOPs, from ``torch.utils.flop_counter``'s formula registry
    (matmuls, convolutions, attention; elementwise ops count none);
  * the bytes it reads and writes: its tensor inputs once and its outputs
    once, views none (eager PyTorch runs op by op, so this is what the
    step moves through memory, not a fused program's);
  * the live bytes of the storages the step has made, whose peak is the
    step's transient memory; and, through
    ``torch.autograd.graph.saved_tensors_hooks``, the bytes saved for
    backward (the step's own storages only, so not the parameters or the
    batch), the largest over its microbatches.

The trace runs every layer and every microbatch of the step (the port
unrolls depth in Python), so its counts need no loop-trip correction.

:func:`collective_stats` is the reference's third roofline term: the
bytes a rank receives per step under its placement
(``parallel/sharding.py``) — the FSDP all-gather over ``data`` of each
placed parameter before its layer runs (again in the backward), the
gradient reduce over the data-parallel axes, and the model-axis
collectives the cell's step recorded
(``parallel.tensor.RecordingComm``: the tensor- and sequence-parallel
all-reduces, gathers and reduce-scatters, the vocabulary-parallel loss's
reductions) — split into ``entry_bytes`` (embedding, head, final norms,
the loss) and ``body_bytes`` (the layers), as the reference splits entry
and loop-body collectives.
"""

from __future__ import annotations

import math
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.parallel.sharding import (batch_spec, model_shard_spec,
                                           shard_shape, spec_axes)


@dataclass
class StepTrace:
    ops: dict = field(default_factory=lambda: defaultdict(int))
    flops: float = 0.0
    bytes_moved: float = 0.0
    saved_bytes: int = 0           # the largest saved-for-backward set
    peak_live_bytes: int = 0       # the step's own storages at their peak


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Tracer(TorchDispatchMode):
    def __init__(self, rec: StepTrace):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.rec, self.flop_registry = rec, flop_registry
        self.live: dict[int, int] = {}     # storage key -> bytes
        self.live_bytes = 0
        self.saved: dict[int, int] = {}    # this forward's saved storages

    def _forget(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rec = self.rec
        rec.ops[str(func.overloadpacket.__name__)] += 1
        packet = func._overloadpacket
        if packet in self.flop_registry:
            rec.flops += self.flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not func.is_view:
            rec.bytes_moved += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self.live:
                continue
            self.live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            weakref.finalize(st, self._forget, key)
        rec.peak_live_bytes = max(rec.peak_live_bytes, self.live_bytes)
        return out

    def pack(self, t: torch.Tensor):
        key = t.untyped_storage()._cdata
        if key in self.live:
            self.saved[key] = self.live[key]
        return t

    def unpack(self, t: torch.Tensor):
        self.close_forward()
        return t

    def close_forward(self) -> None:
        if self.saved:
            self.rec.saved_bytes = max(self.rec.saved_bytes,
                                       sum(self.saved.values()))
            self.saved = {}


def trace(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), StepTrace)``: the call run under the
    tracer (meta tensors in, so nothing is computed)."""
    rec = StepTrace()
    tracer = _Tracer(rec)
    with torch.autograd.graph.saved_tensors_hooks(tracer.pack,
                                                  tracer.unpack):
        with tracer:
            out = fn(*args, **kwargs)
    tracer.close_forward()
    rec.ops = dict(rec.ops)
    return out, rec


def op_histogram(rec: StepTrace, top: int = 15) -> list[tuple[str, int]]:
    """Aten op frequency, the most frequent first."""
    return sorted(rec.ops.items(), key=lambda kv: -kv[1])[:top]


def _is_layer(name: str) -> bool:
    return name.startswith(("blocks.", "encoder.blocks."))


def gathered_shape(cell, shape, spec) -> tuple:
    """The shape a rank gathers a parameter to before its layer runs: its
    model shard (the FSDP shards gathered over ``data``)."""
    return shard_shape(shape, model_shard_spec(spec), cell.mesh)


def collective_stats(cell) -> dict:
    """The bytes one rank receives per step of ``cell``
    (``launch.specs.Cell``) under its placement: ``{op: {"count",
    "bytes"}, "by_axes": {axes: bytes}, "total_bytes", "body_bytes",
    "entry_bytes"}``.  A ring all-gather of a leaf brings ``whole -
    shard`` bytes to each rank; a ring all-reduce over ``n`` ranks moves
    ``2 (n - 1) / n`` of its bytes, a reduce-scatter half that."""
    mesh, cfg = cell.mesh, cell.cfg
    train = cell.shape.kind == "train"
    passes = 2 * max(cfg.grad_accum, 1) if train else 1
    stats: dict = defaultdict(lambda: {"count": 0, "bytes": 0.0})
    by_axes: dict = defaultdict(float)
    split = {"body_bytes": 0.0, "entry_bytes": 0.0}

    def add(op, name, axes, nbytes, count=1):
        if not nbytes:
            return
        stats[op]["count"] += count
        stats[op]["bytes"] += nbytes
        by_axes[",".join(axes)] += nbytes
        split["body_bytes" if _is_layer(name) else "entry_bytes"] += nbytes

    for name, (shape, dt, spec) in cell.params.items():
        whole = math.prod(gathered_shape(cell, shape, spec)) * dt.itemsize
        local = math.prod(shard_shape(shape, spec, mesh)) * dt.itemsize
        placed = tuple(a for e in spec for a in spec_axes(e))
        gathered = tuple(a for a in placed if a != "model")
        add("all-gather", name, gathered, (whole - local) * passes, passes)
        if not train:
            continue
        dp = batch_spec(mesh, cell.shape.global_batch, 1)[0] or ()
        n = math.prod(mesh.shape[a] for a in dp)
        if n == 1:
            continue
        gdt = dt if cfg.grad_accum <= 1 else getattr(torch, cfg.grad_dtype)
        # the rank reduces the part of the gradient it keeps over model
        model_parts = math.prod(mesh.shape[a] for a in placed
                                if a not in dp)
        part = math.prod(shape) * gdt.itemsize / model_parts
        if set(dp) & set(placed):
            add("reduce-scatter", name, dp, part * (n - 1) / n)
        else:
            add("all-reduce", name, dp, 2 * part * (n - 1) / n)
    # a decode rank steps its shard of the state (the context-parallel
    # combine's gathers are among the recorded collectives)
    for op, axis, nbytes, scope in cell.recorded:
        if axis == "model":
            add(op, "blocks." if scope == "body" else "", ("model",), nbytes)
    out = {k: dict(v) for k, v in stats.items()}
    out["by_axes"] = dict(by_axes)
    out["total_bytes"] = sum(v["bytes"] for v in stats.values())
    out.update(split)
    return out
