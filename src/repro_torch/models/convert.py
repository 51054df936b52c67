"""Reference parameters <-> port model.

``from_reference(tree, cfg)`` takes the parameter tree of
``repro.models.init_model`` as nested dicts of numpy arrays (the caller
converts with ``np.asarray``; this module never imports JAX) and returns an
:class:`~repro_torch.models.transformer.LM` holding the same weights.  The
reference stacks each stage's blocks on a leading ``reps`` axis:
``tree["stages"]["s1"]["b0_rec"]["rec"]["w_x"][r]`` is the ``w_x`` of the
first block of stage 1's ``r``-th repeat (an ``attn_moe`` block's
experts: ``["ffn"]["wi_gate"][r]``, ``(E, D, F)``; a ``cross`` block's
cross attention ``["cross"]["wq"][r]``, a ``dec`` block's also
``["ln_cross"]["scale"][r]``); an untied head is
``tree["tok"]["lm_head"]``; an encoder-decoder's encoder is
``tree["encoder"]["stack"]["b0_attn"]``, its blocks stacked over
``encoder_layers``, and ``tree["encoder"]["final_norm"]``.  A bfloat16
tree (numpy's ``bfloat16`` from ``ml_dtypes``) is read by bit pattern.
``to_reference(model)`` is the inverse: the model's parameters, or any
tensors keyed by its parameter names (gradients, updated values), as that
tree of numpy float32 arrays (or of what its ``host`` makes of each
tensor: the checkpoint keeps each dtype).  Both directions read one map,
:func:`leaf_paths`: parameter name -> (reference key path, repeat).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM, torch_dtype


def _path(name: str) -> tuple[str, str]:
    """A block parameter's name -> its (subtree, leaf) in the reference
    block: ``ln1`` -> ``("ln1", "scale")``, ``ssm.A_log`` -> ``("ssm",
    "A_log")``."""
    top, _, leaf = name.partition(".")
    return top, leaf or "scale"


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, np.float32))


def _check_stages(tree: dict, cfg: ModelConfig) -> None:
    if ("encoder" in tree) != cfg.is_encdec:
        raise KeyError(f"tree {'holds' if 'encoder' in tree else 'lacks'} "
                       f"an encoder, config encoder_layers = "
                       f"{cfg.encoder_layers}")
    stages = tree["stages"]
    if len(stages) != len(cfg.stages):
        raise ValueError(f"tree holds {len(stages)} stages, config "
                         f"{len(cfg.stages)}")
    for i, (pat, reps) in enumerate(cfg.stages):
        unit = stages[f"s{i}"]
        want = {f"b{j}_{kind}" for j, kind in enumerate(pat)}
        if set(unit) != want:
            raise KeyError(f"stage s{i} holds blocks {sorted(unit)}, config "
                           f"{sorted(want)}")
        for key in want:
            got = np.asarray(unit[key]["ln1"]["scale"]).shape[0]
            if got != reps:
                raise ValueError(f"stage s{i} block {key} stacks {got} "
                                 f"repeats, config {reps}")


@torch.no_grad()
def from_reference(tree: dict, cfg: ModelConfig,
                   device: torch.device | str | None = None) -> LM:
    dev = resolve_device(device)
    model = LM(cfg).to(torch_dtype(cfg))
    _check_stages(tree, cfg)

    def put(param, t):
        if tuple(param.shape) != tuple(t.shape):
            raise ValueError(f"shape {tuple(t.shape)} does not fit "
                             f"parameter {tuple(param.shape)}")
        param.copy_(t)

    paths, stacks = leaf_paths(model), {}
    for name, param in model.named_parameters():
        path, r = paths[name]
        if path not in stacks:
            leaf = tree
            for key in path:
                leaf = leaf[key]
            stacks[path] = _tensor(leaf)
        put(param, stacks[path] if r is None else stacks[path][r])
    return model.to(dev)


def leaf_paths(model: LM) -> dict:
    """Each parameter name (``named_parameters``) -> ``(path, r)``: the
    key path of its leaf in the reference's tree and its index ``r`` on
    that leaf's leading ``reps`` axis (None for an unstacked leaf).
    ``blocks.3.attn.wq`` of a 4-layer dense model is ``(("stages", "s0",
    "b0_attn", "attn", "wq"), 3)``."""
    out = {"embedding": (("tok", "embedding"), None),
           "final_norm": (("final_norm", "scale"), None)}
    if model.lm_head is not None:
        out["lm_head"] = (("tok", "lm_head"), None)
    units = [(f"blocks.{n}", blk, ("stages", f"s{i}", key), r)
             for n, (blk, (i, key, r)) in enumerate(zip(model.blocks,
                                                        model.layout))]
    if model.encoder is not None:
        out["encoder.final_norm"] = (("encoder", "final_norm", "scale"),
                                     None)
        units += [(f"encoder.blocks.{n}", blk, ("encoder", "stack",
                                                "b0_attn"), n)
                  for n, blk in enumerate(model.encoder.blocks)]
    for prefix, blk, unit, r in units:
        for name, _ in blk.named_parameters():
            out[f"{prefix}.{name}"] = (unit + _path(name), r)
    return out


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def to_reference(model: LM, tensors: dict | None = None, host=_f32) -> dict:
    """The reference's parameter tree of numpy arrays: one
    ``stages/s{i}/b{j}_{kind}`` subtree per block of each stage's pattern,
    stacked over its repeats (and the ``encoder`` tree of an
    encoder-decoder).  ``tensors`` maps the model's parameter names
    (``named_parameters``) to tensors of their shapes, for example
    gradients; the default is the parameters.  ``host`` turns one tensor
    into a numpy array: float32 by default."""
    vals = dict(model.named_parameters()) if tensors is None else tensors
    leaves: dict = {}
    for name, (path, r) in leaf_paths(model).items():
        leaves.setdefault(path, {})[r] = host(vals[name])
    tree: dict = {}
    for path, reps in leaves.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (reps[None] if None in reps
                          else np.stack([reps[r] for r in range(len(reps))]))
    return tree
