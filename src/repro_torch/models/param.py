"""Parameter records: each parameter's logical axes, shape and dtype.

Port of ``repro.models.param``.  The reference declares a tree of
``ParamDef`` (shape, logical axis names, init rule) and derives the
arrays, their abstract stand-ins and their partition specs from it.  The
port's ``nn.Module`` s own their parameters, so it has no ``ParamDef``:
each module class declares its leaves' logical axes beside them, in a
static ``axes(cfg)`` table copied from the reference's defs
(``Attention.axes`` from ``make_attn_defs``, ``MoE``, ``SSM``, ``RGLRU``,
``MLP``, the blocks' norms, ``LM``'s embedding and head; the VAE's in
``models.vae.param_axes``).  From those:

  * :func:`param_axes`      — parameter name -> logical axes,
  * :func:`abstract_params` — name -> (shape, dtype) of a model built on
                              the meta device (nothing is allocated),
  * :func:`pspec_tree`      — name -> mesh axes per dim under a rule set
                              (``parallel/sharding.logical_rules``).

The reference stacks a stage's repeats on a leading ``layers`` axis,
which no rule shards; the port keeps one parameter per block, whose
index on that axis is the ``r`` of :func:`repro_torch.models.convert.
leaf_paths`.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM, torch_dtype


def param_axes(model: torch.nn.Module) -> dict:
    """Each parameter's logical axes (one name or None per dim), by its
    ``named_parameters`` name, from the ``axes(cfg)`` table of the module
    that owns it.  Raises if a parameter has none or its rank differs."""
    cfg = model.cfg
    out = {}
    for prefix, mod in model.named_modules():
        table = type(mod).axes(cfg) if hasattr(type(mod), "axes") else {}
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{prefix}.{leaf}" if prefix else leaf
            axes = table.get(leaf)
            if axes is None or len(axes) != p.ndim:
                raise ValueError(f"parameter {name} {tuple(p.shape)} has "
                                 f"no logical axes of its rank ({axes})")
            out[name] = tuple(axes)
    return out


def meta_model(cfg: ModelConfig) -> LM:
    """An :class:`LM` of ``cfg`` on the meta device in ``cfg.dtype``: its
    parameters have shapes and dtypes and no storage."""
    with torch.device("meta"):
        return LM(cfg).to(torch_dtype(cfg))


def abstract_params(cfg: ModelConfig) -> dict:
    """name -> (shape, dtype) of every parameter: the dry-run's weights,
    which it never allocates."""
    return {k: (tuple(p.shape), p.dtype)
            for k, p in meta_model(cfg).named_parameters()}


def pspec_tree(axes: dict, rules: dict) -> dict:
    """Logical axes -> mesh axes per dim via ``rules`` (names the rules
    lack replicate, as None)."""
    return {k: tuple(rules.get(a) if a is not None else None for a in ax)
            for k, ax in axes.items()}


def param_count(model: torch.nn.Module) -> int:
    return sum(math.prod(p.shape) for p in model.parameters())
