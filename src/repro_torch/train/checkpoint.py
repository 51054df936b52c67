"""Step-addressed npz checkpoints with a json manifest.

Port of ``repro.train.checkpoint``, in its layout: ``save`` writes
``<dir>/step_%08d/host0.npz`` and ``manifest.json`` (``step``, ``time``,
``keys``, ``hosts``) into ``step_%08d.tmp0`` and publishes the directory
with one atomic ``os.replace``, so a crash never leaves a half checkpoint
visible; ``latest_step`` and ``restore`` read it back.  The keys, shapes
and dtypes are the reference's, so a checkpoint written by either package
restores in the other:

* a port :class:`~repro_torch.train.train_loop.TrainState` is written as
  the reference's ``TrainState(params, opt, step)``: ``params.<path>``,
  ``opt.step``, ``opt.m.<path>``, ``opt.v.<path>`` and ``step`` (int32
  scalars), each ``<path>`` a leaf of the reference's parameter tree
  (``params.stages.s0.b0_attn.attn.wq`` of shape ``(reps, D, H, Dh)``),
  mapped from the port's parameter names by
  :func:`repro_torch.models.convert.leaf_paths`; a state with the
  cross-pod step's residuals (``TrainState.error``) adds
  ``error.<path>`` (float32), as the reference writes its ``error`` tree;
* any other tree of tensors or arrays (dicts, tuples, NamedTuples) is
  flattened as the reference flattens it.

Each leaf keeps its dtype.  A bfloat16 leaf goes to disk as its 2-byte
pattern with dtype ``|V2``, which is what ``np.savez`` writes for JAX's
bfloat16 arrays; ``restore`` reads a ``|V2`` leaf back by bit pattern into
a bfloat16 tensor.  (JAX's own ``restore`` refuses ``|V2``, so it cannot
read a bfloat16 checkpoint, its own included.)

``save`` copies every tensor to host memory before it returns; with
``blocking=False`` only the file write runs on a thread, so the caller may
update its state in place at once.  ``restore`` fills an existing state's
tensors in place and returns that state.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models.convert import leaf_paths, to_reference
from repro_torch.train.train_loop import TrainState

_V2 = np.dtype("V2")


class _RefState(NamedTuple):
    """The reference's ``TrainState``; an ``error`` of None is skipped."""

    params: dict
    opt: "_RefOpt"
    step: np.ndarray
    error: dict | None = None


class _RefOpt(NamedTuple):
    step: np.ndarray
    m: dict
    v: dict


def _host(t) -> np.ndarray:
    """A leaf as a host numpy copy in its own dtype; bfloat16 as ``|V2``."""
    if not isinstance(t, torch.Tensor):
        return np.array(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(_V2)
    return t.to("cpu", copy=True).numpy()


def _flatten(tree, prefix=""):
    """``(path, leaf)`` pairs in the reference's order: dict keys sorted,
    sequences and NamedTuples in order, None skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)) or hasattr(tree, "_fields"):
        items = (tree._asdict().items() if hasattr(tree, "_asdict")
                 else enumerate(tree))
        for k, v in items:
            yield from _flatten(v, f"{prefix}{k}/")
    elif tree is None:
        return
    else:
        yield prefix[:-1], tree


def _key(path: str) -> str:
    return path.replace("/", ".")


def _reference_tree(state) -> _RefState:
    model, opt = state.model, state.opt
    return _RefState(
        params=to_reference(model, host=_host),
        opt=_RefOpt(step=_host(opt.step),
                    m=to_reference(model, opt.m, host=_host),
                    v=to_reference(model, opt.v, host=_host)),
        step=_host(state.step),
        error=(None if state.error is None
               else to_reference(model, state.error, host=_host)))


def save(ckpt_dir: str, step: int, tree, *, host_id: int = 0,
         blocking: bool = True) -> str:
    """Write ``<ckpt_dir>/step_<n>/`` with the shard file and manifest;
    returns its path.  ``tree`` is a port ``TrainState`` or any tree of
    tensors or arrays.  Every leaf is on the host when this returns."""
    out = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = out + f".tmp{host_id}"
    os.makedirs(tmp, exist_ok=True)
    ref = _reference_tree(tree) if isinstance(tree, TrainState) else tree
    arrays = {_key(k): _host(v) for k, v in _flatten(ref)}

    def write():
        np.savez(os.path.join(tmp, f"host{host_id}.npz"), **arrays)
        manifest = {"step": step, "time": time.time(),
                    "keys": sorted(arrays), "hosts": 1}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(out):
            shutil.rmtree(out)
        os.replace(tmp, out)      # atomic publish

    if blocking:
        write()
    else:
        threading.Thread(target=write, daemon=True).start()
    return out


def latest_step(ckpt_dir: str) -> int | None:
    """The newest published step under ``ckpt_dir`` (a ``step_*``
    directory with a ``manifest.json``, not host 0's ``.tmp0``), or
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp0"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _targets(like) -> dict:
    """Flat key -> ``[(tensor, r)]``: the tensors of ``like`` that each
    checkpoint leaf fills, ``r`` the index on the leaf's leading axis (None
    for the whole leaf)."""
    if not isinstance(like, TrainState):
        out = {}
        for k, v in _flatten(like):
            if not isinstance(v, torch.Tensor):
                raise TypeError(f"restore fills tensors in place; leaf {k!r} "
                                f"is a {type(v).__name__}")
            out[_key(k)] = [(v, None)]
        return out
    model = like.model
    out = {"opt.step": [(like.opt.step, None)], "step": [(like.step, None)]}
    params = dict(model.named_parameters())
    trees = [("params", params), ("opt.m", like.opt.m),
             ("opt.v", like.opt.v)]
    if like.error is not None:
        trees.append(("error", like.error))
    for name, (path, r) in leaf_paths(model).items():
        leaf = ".".join(path)
        for prefix, tensors in trees:
            out.setdefault(f"{prefix}.{leaf}", []).append((tensors[name], r))
    return out


def _as_tensor(arr: np.ndarray, like: torch.Tensor, key: str) -> torch.Tensor:
    """A checkpoint leaf as a CPU tensor of ``like``'s dtype, read by bit
    pattern where it is bfloat16 (``|V2``, or ``ml_dtypes``' bfloat16)."""
    if arr.dtype == _V2 or arr.dtype.name == "bfloat16":
        if like.dtype != torch.bfloat16:
            raise ValueError(f"checkpoint leaf {key!r} holds bfloat16 bits, "
                             f"the state's tensor is {like.dtype}")
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    t = torch.from_numpy(np.array(arr))
    if t.dtype != like.dtype:
        raise ValueError(f"checkpoint leaf {key!r} is {arr.dtype}, the "
                         f"state's tensor is {like.dtype}")
    return t


@torch.no_grad()
def restore(ckpt_dir: str, step: int, like):
    """Load step ``step`` into ``like`` (a port ``TrainState`` or a tree of
    tensors) in place and return it.  The checkpoint's keys must be
    exactly the state's, each leaf of the state's shape and dtype."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "host0.npz")
    targets = _targets(like)
    with np.load(path) as data:
        if set(data.files) != set(targets):
            missing = sorted(set(targets) - set(data.files))
            extra = sorted(set(data.files) - set(targets))
            raise KeyError(f"checkpoint {path} does not fit the state: "
                           f"missing {missing[:4]}, unexpected {extra[:4]}")
        for key, dsts in targets.items():
            arr = data[key]
            dst0, r0 = dsts[0]
            want = tuple(dst0.shape) if r0 is None else (
                len(dsts),) + tuple(dst0.shape)
            if arr.shape != want:
                raise ValueError(f"checkpoint leaf {key!r} has shape "
                                 f"{arr.shape}, the state wants {want}")
            for dst, r in dsts:
                dst.copy_(_as_tensor(arr if r is None else arr[r], dst, key))
    return like
