"""Dry-run cells: (arch x shape x mesh) -> the step one rank runs,
on the meta device, with every tensor's per-rank placement.

Port of ``repro.launch.specs``.  Nothing here allocates: the model, the
optimizer state, the batch and the decode state are meta tensors at the
width the rank computes, and the placement says what each rank stores.
The reference lowers the whole (GSPMD-sharded) program.  The port runs
one rank's program under the compute placement (``parallel/
sharding.py``): the rank's placed model (``sharding.place_model`` on a
``parallel.tensor.RecordingComm``, the stand-in that records each
collective instead of running it), its data slab of the batch (and of a
memory or encoder inputs), its shares of the heads (self and cross
attention, the encoder's), MLP columns, experts (or every expert's
columns), SSM and RG-LRU channels and vocabulary, the expert fold's sums
over ``model`` among its records, residuals under ``cfg.act_pspec`` (the
reference's default ``(batch axes, None, None)`` when none is set, but
for a decode cell, which the reference leaves unconstrained), and in a
decode cell its shard of the state (the KV rings by
``sharding.ring_layout``, the recurrent leaves' last dim over ``model``;
a batch the data axes do not divide, ``long_500k``'s one row, on every
data rank).

The steps:

  * train   — ``train_loop.make_train_step(cfg)`` on the slab's
              ``global_batch / dp`` rows (``cfg.grad_accum`` microbatches),
              AdamW moments in ``cfg.moment_dtype``, checkpointed units
              under ``cfg.remat``: ``make_train_step(cfg,
              device_mesh=...)`` on the global batch;
  * prefill — ``LM.forward`` and the logits (BF16), the compression
              direction's per-position distributions;
  * decode  — ``LM.decode_step`` of one token against a ``seq_len`` state
              (the global batch's token and memory, the rank's state).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.configs.registry import SHAPES, ShapeSpec, get_config
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import meta_model
from repro_torch.models.transformer import LM, encoder_block, torch_dtype
from repro_torch.parallel.sharding import (batch_spec, param_specs,
                                           place_model, ring_layout,
                                           shard_shape)
from repro_torch.parallel.tensor import RecordingComm
from repro_torch.train import train_loop
from repro_torch.train.optimizer import as_dtype


def tune_for_shape(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Shape-dependent framework defaults (fit requirements, not tuning),
    the reference's."""
    if shape.kind == "prefill" and shape.seq_len >= 32_768 \
            and cfg.attn_impl == "naive":
        # a naive (B,H,32k,32k) score tensor cannot exist on any chip
        cfg = cfg.with_(attn_impl="blockwise", attn_block=2048)
    if shape.kind != "train":
        cfg = cfg.with_(grad_accum=1)
    elif cfg.grad_accum < 8:
        # fit requirement, not tuning: the remat stash (each checkpointed
        # unit's input) scales with the local microbatch; microbatch 32
        # divides both the 16-way and 32-way DP extents
        cfg = cfg.with_(grad_accum=8)
    return cfg


def _dp_parts(mesh, global_batch: int) -> int:
    axes = batch_spec(mesh, global_batch, ndim=1)[0] or ()
    return math.prod(mesh.shape[a] for a in axes)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """The training batch's planes: name -> ((shape), dtype) of the global
    batch, and name -> placement per dim."""
    b, s = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg)
    specs = {"tokens": ((b, s), torch.int64), "labels": ((b, s), torch.int64)}
    if cfg.family == "vlm":
        specs["memory"] = ((b, cfg.memory_tokens, cfg.d_model), dt)
    if cfg.is_encdec:
        specs["enc_inputs"] = ((b, cfg.memory_tokens, cfg.d_model), dt)
    place = {k: batch_spec(mesh, b, len(sh)) for k, (sh, _) in specs.items()}
    return specs, place


def cache_specs(cfg: ModelConfig, mesh, leaves: dict,
                global_batch: int) -> dict:
    """Name-aware state placement (leaves by shape, ``(layers, B, ...)``):
    batch over DP; the KV rings' heads over model when divisible, else
    their *slot* dim over model (decode context parallelism, the
    reference's llama3-405b 32k fit lever; ``sharding.ring_layout``); a
    recurrent leaf's feature dim over model when it divides."""
    model_n = mesh.shape["model"]
    b_axes = batch_spec(mesh, global_batch, ndim=1)[0]

    def spec(name, shape):
        dims: list = [None] * len(shape)
        if len(shape) >= 2:
            dims[1] = b_axes           # (layer_stack, batch, ...)
        if name in ("k", "v") and len(shape) == 5:
            layout = ring_layout(cfg, shape[2], model_n)
            if layout == "kv_heads":
                dims[3] = "model"
            elif layout == "slots":
                dims[2] = "model"      # context-parallel cache
        elif name.rsplit(".", 1)[-1] in ("h", "conv"):
            if shape[-1] % model_n == 0:
                dims[-1] = "model"
        return tuple(dims)

    return {k: spec(k, tuple(s)) for k, s in leaves.items()}


@dataclass
class Cell:
    """One dry-run cell as a rank runs it.  ``run()`` runs the step on the
    meta device and returns what it returns; ``params``/``optimizer``/
    ``state``/``batch`` map names to ``(shape, dtype, placement)`` with
    the global shape, and ``rows`` is the rank's batch slab.  A train
    cell under ``cfg.remat`` holds in ``units`` one call for each
    distinct checkpointed unit: its forward at a microbatch's shapes,
    which backward runs again.  ``comm`` is the recording stand-in, and
    ``recorded`` holds the collectives of the last ``run()``."""

    arch: str
    shape: ShapeSpec
    mesh: MeshShape
    cfg: ModelConfig
    fsdp: bool
    model: LM
    rows: int
    params: dict
    optimizer: dict
    state: dict
    batch: dict
    run: object
    units: tuple = ()
    comm: RecordingComm | None = None
    recorded: list | None = None

    def local_bytes(self, records: dict) -> int:
        """Per-rank bytes of ``records`` under their placements."""
        return sum(math.prod(shard_shape(sh, spec, self.mesh)) * dt.itemsize
                   for sh, dt, spec in records.values())


def _meta(shape, dtype):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _unit_runs(model: LM, rows: int, seq: int) -> tuple:
    """The forward of each distinct checkpointed unit on ``rows`` rows of
    meta inputs: each stage's first pattern repetition over ``seq``
    positions (a placed rank's sequence slab under sequence
    parallelism), and an encoder block over the memory's."""
    cfg, dt = model.cfg, model.embedding.dtype
    pl = model.placement
    if pl is not None and pl.sp:
        seq //= pl.tp
    x = _meta((rows, seq, cfg.d_model), dt)
    mem = None
    if cfg.memory_tokens:
        mem = _meta((rows, cfg.memory_tokens, cfg.d_model), dt)
    firsts: dict = {}
    for unit in model.units:
        firsts.setdefault(model.layout[unit[0]][0], unit)
    runs = [functools.partial(model.unit_forward, u, x, mem)
            for u in firsts.values()]
    if model.encoder is not None:
        runs.append(functools.partial(encoder_block, model, 0, mem))
    return tuple(runs)


def build_cell(arch: str, shape, mesh: MeshShape, *, fsdp: bool = True,
               overrides: dict | None = None) -> Cell:
    """The cell of ``arch`` at ``shape`` (a :data:`SHAPES` name or a
    :class:`ShapeSpec`) on ``mesh``; ``overrides`` replace config fields
    after :func:`tune_for_shape`."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = tune_for_shape(get_config(arch), shape)
    if overrides:
        cfg = cfg.with_(**overrides)
    b, s = shape.global_batch, shape.seq_len
    cfg = _placed_pspec(cfg, mesh, b, shape.kind != "decode")
    model = meta_model(cfg)
    pspec = param_specs(model, mesh, fsdp=fsdp)
    params = {k: (tuple(p.shape), p.dtype, pspec[k])
              for k, p in model.named_parameters()}
    rows = b // _dp_parts(mesh, b)
    dt = torch_dtype(cfg)
    planes, place = batch_specs(cfg, shape, mesh)
    batch = {k: (sh, d, place[k]) for k, (sh, d) in planes.items()}
    local = {k: _meta((rows,) + sh[1:], d) for k, (sh, d) in planes.items()}
    whole = {k: _meta(sh, d) for k, (sh, d) in planes.items()}
    optimizer, state, units = {}, {}, ()
    comm, recorded = RecordingComm(mesh), []
    model = place_model(model, comm, fsdp=fsdp)

    def recording(fn):
        """``fn`` with the collectives it records kept in ``recorded``."""
        def run():
            comm.records.clear()
            out = fn()
            recorded[:] = comm.records
            return out
        return run

    if shape.kind == "train":
        mdt = as_dtype(cfg.moment_dtype)
        optimizer = {f"{m}.{k}": (sh, mdt, spec)
                     for m in ("m", "v")
                     for k, (sh, _, spec) in params.items()}
        step = train_loop.make_train_step(cfg, device_mesh=comm)
        if cfg.remat:
            units = _unit_runs(model, rows // cfg.grad_accum, s)

        @recording
        def run():
            st = train_loop.init_train_state(model)
            return step(st, whole)
    elif shape.kind == "prefill":
        local.pop("labels")
        batch.pop("labels")

        @recording
        def run():
            with torch.no_grad():
                x, _ = model(local["tokens"], memory=local.get("memory"),
                             enc_inputs=local.get("enc_inputs"))
                return model._logits(x).to(torch.bfloat16)
    else:
        with torch.device("meta"):
            st0 = model.init_state(b, s)
            # the state's whole leaves, by the unplaced model's shapes
            whole_state = meta_model(cfg).init_state(rows, s)
        glob = {k: (t.shape[0], b) + tuple(t.shape[2:])
                for k, t in whole_state.leaves().items()}
        cspec = cache_specs(cfg, mesh, glob, b)
        state = {k: (glob[k], t.dtype, cspec[k])
                 for k, t in whole_state.leaves().items()}
        token = _meta((b, 1), torch.int64)
        memory = None
        batch = {}
        if cfg.family == "vlm" or cfg.is_encdec:
            memory = _meta((b, cfg.memory_tokens, cfg.d_model), dt)
            batch = {"memory": ((b, cfg.memory_tokens, cfg.d_model), dt,
                                batch_spec(mesh, b, 3))}

        @recording
        def run():
            with torch.no_grad():
                return model.decode_step(st0, token, s - 1, memory=memory)

    return Cell(arch=arch, shape=shape, mesh=mesh, cfg=cfg, fsdp=fsdp,
                model=model, rows=rows, params=params, optimizer=optimizer,
                state=state, batch=batch, run=run, units=units, comm=comm,
                recorded=recorded)


def _placed_pspec(cfg: ModelConfig, mesh, global_batch: int,
                  default: bool = True) -> ModelConfig:
    """The reference's ``act_pspec`` for a cell: the
    config's own without the ``pod`` axis on a single pod, else
    ``(batch axes, None, None)`` (unless not ``default``: the reference
    constrains no decode cell's residuals)."""
    if cfg.act_pspec is not None:
        if "pod" in mesh.axis_names:
            return cfg
        return cfg.with_(act_pspec=tuple(
            tuple(a for a in ax if a != "pod") if isinstance(ax, tuple)
            else ax for ax in cfg.act_pspec))
    if not default:
        return cfg
    return cfg.with_(act_pspec=(batch_spec(mesh, global_batch, 1)[0], None,
                                None))

