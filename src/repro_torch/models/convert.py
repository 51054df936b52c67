"""Reference parameters -> port model.

``from_reference(tree, cfg)`` takes the parameter tree of
``repro.models.init_model`` as nested dicts of numpy arrays (the caller
converts with ``np.asarray``; this module never imports JAX) and returns a
:class:`DenseLM` holding the same weights.  The reference stacks each
stage's layers on a leading ``reps`` axis:
``tree["stages"]["s0"]["b0_attn"]["attn"]["wq"][r]`` is layer ``r``'s
``wq``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import DenseLM


def _layers(tree: dict):
    """Yield each layer's block subtree in depth order."""
    stages = tree["stages"]
    for i in range(len(stages)):
        unit = stages[f"s{i}"]
        keys = sorted(unit, key=lambda k: int(k[1:].split("_")[0]))
        reps = np.asarray(unit[keys[0]]["ln1"]["scale"]).shape[0]
        for r in range(reps):
            for key in keys:
                if not key.endswith("_attn"):
                    raise KeyError(f"layer kind of {key!r} is not ported")
                yield {name: {leaf: np.asarray(a)[r]
                              for leaf, a in sub.items()}
                       for name, sub in unit[key].items()}


@torch.no_grad()
def from_reference(tree: dict, cfg: ModelConfig,
                   device: torch.device | str | None = None) -> DenseLM:
    dev = resolve_device(device)
    model = DenseLM(cfg)

    def put(param, arr):
        arr = np.asarray(arr, np.float32)
        if tuple(param.shape) != arr.shape:
            raise ValueError(f"shape {arr.shape} does not fit parameter "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(arr.copy()))

    put(model.embedding, tree["tok"]["embedding"])
    put(model.final_norm, tree["final_norm"]["scale"])
    layers = list(_layers(tree))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.n_layers}")
    for blk, p in zip(model.blocks, layers):
        put(blk.ln1, p["ln1"]["scale"])
        put(blk.ln2, p["ln2"]["scale"])
        for name in ("wq", "wk", "wv", "wo"):
            put(getattr(blk.attn, name), p["attn"][name])
        for name in ("wi_gate", "wi_up", "wo"):
            put(getattr(blk.ffn, name), p["ffn"][name])
    return model.to(dev)
