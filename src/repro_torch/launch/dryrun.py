"""Multi-pod dry-run: trace every (arch x shape) cell as one rank of the
production mesh runs it, and record its per-rank memory and roofline.

Port of ``repro.launch.dryrun``.  The reference forces 512 placeholder
devices and lowers and compiles each cell with GSPMD.  The port runs one
rank's step on the meta device (``launch/specs.build_cell``,
``analysis/hlo.trace``): no card, no process group and no allocation, so
nothing here runs on the CPU in the card's place.  The mesh is a shape
(``launch/mesh.production_mesh_shape``).  A rank holds its shard of
every parameter, gradient and moment under the reference's rules, and
computes under the compute placement (``launch/specs.py``): its data
slab with its shares of the heads (self and cross attention, the
encoder's), SSM and RG-LRU channels, MLP columns, experts or expert
columns and vocabulary, and in a decode cell its shard of the state.

In place of the compiler's ``memory_analysis`` a record holds per-rank
bytes: parameters, gradients (and their float32 accumulator under
``grad_accum``), AdamW moments, activations (train: the tensors saved for
backward, the largest microbatch's, and under ``cfg.remat`` the largest
checkpointed unit's saved tensors when backward recomputes it, apart in
``recompute_bytes``; prefill: the forward's peak of live
tensors; decode: the rank's state), the largest layer's FSDP gather over ``data``
(twice in a train cell: weights and gradients), their total and ``fits``
against the card's 80 GB.  A cell that does not fit is a finding, not a
failure.  The roofline terms are reckoned at the H100's published peaks
(``analysis/roofline.py``); they are not measurements.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --arch mixtral-8x22b --mesh both
  python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun

``--arch`` without ``--shape`` runs every shape of the arch.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.analysis import hlo, roofline
from repro_torch.configs.registry import (SHAPES, get_config, grid,
                                          shape_applicable)
from repro_torch.launch.mesh import MeshShape, production_mesh_shape
from repro_torch.launch.specs import build_cell
from repro_torch.parallel.sharding import shard_shape


def _mesh_name(mesh: MeshShape) -> str:
    if mesh == production_mesh_shape(multi_pod=True):
        return "pod2x16x16"
    if mesh == production_mesh_shape():
        return "pod16x16"
    return "x".join(map(str, mesh.sizes))


def _layer(name: str) -> str | None:
    parts = name.split(".")
    if parts[0] == "blocks":
        return ".".join(parts[:2])
    if parts[:2] == ["encoder", "blocks"]:
        return ".".join(parts[:3])
    return None


def memory(cell, rec: hlo.StepTrace) -> dict:
    """Per-rank bytes of ``cell`` (``launch.specs.Cell``) with its traced
    step ``rec``."""
    cfg, mesh = cell.cfg, cell.mesh
    train = cell.shape.kind == "train"
    param = cell.local_bytes(cell.params)
    grad = accum = opt = 0
    if train:
        gdt = (next(iter(cell.params.values()))[1] if cfg.grad_accum <= 1
               else getattr(torch, cfg.grad_dtype))
        grad = cell.local_bytes({k: (sh, gdt, sp)
                                 for k, (sh, _, sp) in cell.params.items()})
        if cfg.grad_accum > 1:
            accum = cell.local_bytes({k: (sh, torch.float32, sp) for k, (
                sh, _, sp) in cell.params.items()})
        opt = cell.local_bytes(cell.optimizer)
    recompute = 0
    if train:
        # a checkpointed unit saves its tensors again when backward runs
        # it, through checkpoint's own hooks: the largest unit's set
        # rides on the stash the trace saw
        recompute = max((hlo.trace(u)[1].saved_bytes for u in cell.units),
                        default=0)
        act = rec.saved_bytes + recompute
    elif cell.shape.kind == "prefill":
        act = rec.peak_live_bytes
    else:
        act = cell.local_bytes(cell.state)
    gathered: dict = {}
    for name, (shape, dt, spec) in cell.params.items():
        layer = _layer(name)
        if layer is not None:
            gathered[layer] = gathered.get(layer, 0) + (
                math.prod(hlo.gathered_shape(cell, shape, spec))
                - math.prod(shard_shape(shape, spec, mesh))) * dt.itemsize
    gather = max(gathered.values(), default=0) * (2 if train else 1)
    total = param + grad + accum + opt + act + gather
    return {"param_bytes": param, "grad_bytes": grad,
            "grad_accum_bytes": accum, "optimizer_bytes": opt,
            "activation_bytes": act, "recompute_bytes": recompute,
            "gathered_layer_bytes": gather,
            "total_bytes": total,
            "total_per_chip_gb": round(total / 1e9, 3),
            "hbm_bytes": roofline.HBM_BYTES,
            "fits": total <= roofline.HBM_BYTES}


def run_cell(arch: str, shape_name, multi_pod: bool = False,
             out_dir: str | None = None, verbose: bool = True,
             fsdp: bool = True, overrides: dict | None = None,
             tag: str = "", mesh: MeshShape | None = None) -> dict:
    """Trace one cell and record it; ``shape_name`` is a :data:`SHAPES`
    name or a ``ShapeSpec``, ``mesh`` replaces the production mesh."""
    mesh = mesh or production_mesh_shape(multi_pod=multi_pod)
    mesh_name = _mesh_name(mesh)
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    ok, why = shape_applicable(get_config(arch), shape)
    if not ok:
        rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
               "status": "SKIP", "reason": why}
        _emit(rec, out_dir, verbose)
        return rec

    t0 = time.time()
    try:
        cell = build_cell(arch, shape, mesh, fsdp=fsdp, overrides=overrides)
        _, tr = hlo.trace(cell.run)
        t_trace = time.time() - t0
        mem = memory(cell, tr)
        coll = hlo.collective_stats(cell)
        rep = roofline.analyze(tr, coll, cell.cfg, shape, arch, mesh,
                               mesh_name, mem["total_bytes"])
        rec = {
            "arch": arch, "shape": shape.name, "mesh": mesh_name,
            "status": "OK", "tag": tag,
            "fsdp": fsdp, "overrides": overrides,
            "act_pspec": cell.cfg.act_pspec, "rows_per_rank": cell.rows,
            "grad_accum": cell.cfg.grad_accum,
            "trace_s": round(t_trace, 2),
            "memory": mem,
            "trace": {"n_ops": sum(tr.ops.values()), "flops": tr.flops,
                      "bytes": tr.bytes_moved,
                      "saved_bytes": tr.saved_bytes,
                      "peak_live_bytes": tr.peak_live_bytes,
                      "op_histogram": hlo.op_histogram(tr)},
            "roofline": json.loads(rep.to_json()),
        }
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
               "status": "FAIL", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    _emit(rec, out_dir, verbose)
    return rec


def _emit(rec: dict, out_dir: str | None, verbose: bool):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{rec['tag']}" if rec.get("tag") else ""
        path = os.path.join(
            out_dir,
            f"{rec['mesh']}__{rec['arch']}__{rec['shape']}{suffix}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        if rec["status"] == "OK":
            r = rec["roofline"]
            m = rec["memory"]
            print(f"[OK]   {rec['mesh']:12s} {rec['arch']:24s} "
                  f"{rec['shape']:12s} mem={m['total_per_chip_gb']:8.2f}GB "
                  f"{'fits' if m['fits'] else 'OVER'} "
                  f"compute={r['compute_s']*1e3:9.2f}ms "
                  f"mem={r['memory_s']*1e3:9.2f}ms "
                  f"coll={r['collective_s']*1e3:9.2f}ms "
                  f"dom={r['dominant']}", flush=True)
        elif rec["status"] == "SKIP":
            print(f"[SKIP] {rec['mesh']:12s} {rec['arch']:24s} "
                  f"{rec['shape']:12s} ({rec['reason'][:60]})", flush=True)
        else:
            print(f"[FAIL] {rec['mesh']:12s} {rec['arch']:24s} "
                  f"{rec['shape']:12s} {rec['error'][:200]}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-fsdp", action="store_true",
                    help="replicate weights over data (inference mode)")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value")
    ap.add_argument("--tag", default="", help="suffix for output json")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "false"):
            v = v == "true"
        overrides[k] = v

    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    fails = 0
    if args.all:
        for multi in meshes:
            for arch, shape_name, ok, why in grid():
                rec = run_cell(arch, shape_name, multi, args.out,
                               fsdp=not args.no_fsdp,
                               overrides=overrides or None, tag=args.tag)
                fails += rec["status"] == "FAIL"
    else:
        if not args.arch:
            ap.error("--arch [--shape], or --all")
        shapes = [args.shape] if args.shape else list(SHAPES)
        for multi in meshes:
            for shape_name in shapes:
                rec = run_cell(args.arch, shape_name, multi, args.out,
                               fsdp=not args.no_fsdp,
                               overrides=overrides or None, tag=args.tag)
                fails += rec["status"] == "FAIL"
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
