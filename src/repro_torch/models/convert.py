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
tree of numpy float32 arrays.
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

    put(model.embedding, _tensor(tree["tok"]["embedding"]))
    if model.lm_head is not None:
        put(model.lm_head, _tensor(tree["tok"]["lm_head"]))
    put(model.final_norm, _tensor(tree["final_norm"]["scale"]))
    units = [(blk, tree["stages"][f"s{i}"][key], r)
             for blk, (i, key, r) in zip(model.blocks, model.layout)]
    if model.encoder is not None:
        enc = tree["encoder"]
        put(model.encoder.final_norm, _tensor(enc["final_norm"]["scale"]))
        units += [(blk, enc["stack"]["b0_attn"], r)
                  for r, blk in enumerate(model.encoder.blocks)]
    for blk, sub, r in units:
        for name, param in blk.named_parameters():
            top, leaf = _path(name)
            put(param, _tensor(sub[top][leaf])[r])
    return model.to(dev)


def to_reference(model: LM, tensors: dict | None = None) -> dict:
    """The reference's parameter tree of numpy float32 arrays: one
    ``stages/s{i}/b{j}_{kind}`` subtree per block of each stage's pattern,
    stacked over its repeats (and the ``encoder`` tree of an
    encoder-decoder).  ``tensors`` maps the model's parameter names
    (``named_parameters``) to tensors of their shapes, for example
    gradients; the default is the parameters."""
    vals = dict(model.named_parameters()) if tensors is None else tensors

    def np_(name):
        return vals[name].detach().to("cpu", torch.float32).numpy().copy()

    def stack(blocks, prefix: str, keys) -> dict:
        """``{group: {key: {top: {leaf: (reps, ...)}}}}`` of ``blocks``,
        block ``n`` into ``keys[n]`` = (group, key)."""
        out: dict = {}
        for n, (blk, (group, key)) in enumerate(zip(blocks, keys)):
            unit = out.setdefault(group, {}).setdefault(key, {})
            for name, _ in blk.named_parameters():
                top, leaf = _path(name)
                unit.setdefault(top, {}).setdefault(leaf, []).append(
                    np_(f"{prefix}.{n}.{name}"))
        return {g: {key: {top: {leaf: np.stack(reps)
                                for leaf, reps in sub.items()}
                          for top, sub in unit.items()}
                    for key, unit in units.items()}
                for g, units in out.items()}

    tok = {"embedding": np_("embedding")}
    if model.lm_head is not None:
        tok["lm_head"] = np_("lm_head")
    tree = {"tok": tok, "final_norm": {"scale": np_("final_norm")},
            "stages": stack(model.blocks, "blocks",
                            [(f"s{i}", key) for i, key, _ in model.layout])}
    if model.encoder is not None:
        enc = model.encoder.blocks
        tree["encoder"] = {
            **stack(enc, "encoder.blocks", [("stack", "b0_attn")] * len(enc)),
            "final_norm": {"scale": np_("encoder.final_norm")}}
    return tree
