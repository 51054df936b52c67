"""Logical-axis -> mesh-axis placement rules (DP / FSDP storage).

Port of ``repro.parallel.sharding``.  The reference places the model by
GSPMD on the ``(data=16, model=16)`` mesh a pod (a leading ``pod`` axis
across pods):

  * batch           -> (pod, data)            [DP; hierarchical reduce]
  * vocab/heads/mlp/ssm_inner/ssm_state -> model   [Megatron TP]
  * kv_heads        -> model iff divisible, else replicate ("kv_heads_repl")
  * experts         -> model when n_experts % tp == 0 (EP; phi3.5),
                       else per-expert TP on mlp (mixtral)
  * embed           -> data under FSDP (the default), None otherwise
  * layers          -> never sharded

The port has no tensor-parallel compute, so it places the same rules as
**storage**: each rank holds exactly the reference's shard of every
parameter (:func:`shard_params`, a ``narrow`` at the rank's mesh
coordinates), computes its data-parallel slab of the batch
(:func:`batch_spec`) at full width, and gathers each layer's shards
before the layer runs (:func:`unshard`: an ``all_gather`` per placed
axis, bitwise the whole tensor).  The ranks of one ``model`` row hold one
batch slab and compute the same slab: the model axis divides memory, not
work.  A mesh here is anything with ``axis_names`` and a ``shape``
mapping (``launch.mesh.MeshShape``, or a JAX mesh in the tests); the
placement functions take the ``torch.distributed`` ``DeviceMesh``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.models.config import ModelConfig
from repro_torch.models.param import param_axes, pspec_tree


def dp_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def logical_rules(cfg: ModelConfig, *, multi_pod: bool = False,
                  fsdp: bool = True) -> dict:
    rules = {
        "batch": dp_axes(multi_pod),
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "kv_heads_repl": None,
        "embed": "data" if fsdp else None,
        "mlp": "model",
        "experts": None,
        "ssm_inner": "model",
        "ssm_state": "model",
        "layers": None,
    }
    if cfg.n_experts and cfg.n_experts % cfg.tp == 0:
        rules["experts"] = "model"   # true EP (phi3.5: E == tp)
        rules["mlp"] = None          # expert-internal ff replicated over model
    return rules


def param_specs(model, mesh, *, fsdp: bool = True) -> dict:
    """Each parameter's mesh axes per dim (None, an axis name, or a tuple
    of names), by ``named_parameters`` name."""
    rules = logical_rules(model.cfg, multi_pod="pod" in mesh.axis_names,
                          fsdp=fsdp)
    return pspec_tree(param_axes(model), rules)


def spec_axes(entry) -> tuple:
    """The mesh axes of one dim's placement (None, a name or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec, mesh) -> tuple:
    """The per-rank shape of a ``shape`` tensor placed by ``spec``: each
    dim divided by the product of its axes' sizes.  As in JAX, a dim the
    axes do not divide raises."""
    sizes = mesh.shape
    out = []
    for d, (n, entry) in enumerate(zip(shape, spec)):
        parts = math.prod(sizes[a] for a in spec_axes(entry))
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} is placed on "
                             f"{entry} ({parts} parts), which does not "
                             f"divide {n}")
        out.append(n // parts)
    return tuple(out)


def _coord(device_mesh, axes: tuple) -> tuple[int, int]:
    """This rank's index and the part count of a dim placed on ``axes``
    (major first, as JAX orders a tuple of axes)."""
    idx, parts = 0, 1
    for a in axes:
        n = device_mesh.size(device_mesh.mesh_dim_names.index(a))
        idx, parts = idx * n + device_mesh.get_local_rank(a), parts * n
    return idx, parts


def shard_params(tensors: dict, specs: dict, device_mesh) -> dict:
    """This rank's shard of every tensor: a ``narrow`` of each placed dim
    at the rank's coordinates on its axes (a view; placed dims must
    divide)."""
    out = {}
    for k, t in tensors.items():
        for d, entry in enumerate(specs[k]):
            idx, parts = _coord(device_mesh, spec_axes(entry))
            if t.shape[d] % parts:
                raise ValueError(f"{k}: dim {d} of {tuple(t.shape)} does "
                                 f"not divide into {parts} parts")
            n = t.shape[d] // parts
            t = t.narrow(d, idx * n, n)
        out[k] = t
    return out


def unshard(local: dict, specs: dict, device_mesh) -> dict:
    """The whole tensors back from every rank's shards: an ``all_gather``
    over each placed axis (the minor axis first), concatenated in rank
    order; bitwise the tensors :func:`shard_params` cut."""
    out = {}
    for k, t in local.items():
        t = t.contiguous()
        for d, entry in enumerate(specs[k]):
            for a in reversed(spec_axes(entry)):
                group = device_mesh.get_group(a)
                parts = [torch.empty_like(t)
                         for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, t, group=group)
                t = torch.cat(parts, dim=d)
        out[k] = t
    return out


def batch_spec(mesh, global_batch: int, ndim: int = 2) -> tuple:
    """Dim 0 (batch) over as many DP axes as divide it; the rest
    replicated.  ``long_500k`` (batch 1) replicates: single-stream decode
    does not data-parallelize."""
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    use = []
    prod = 1
    for a in axes:
        n = mesh.shape[a]
        if global_batch % (prod * n) == 0:
            use.append(a)
            prod *= n
    spec = tuple(use) if use else None
    return (spec,) + (None,) * (ndim - 1)


def cache_specs(cfg: ModelConfig, mesh, leaves: dict,
                global_batch: int) -> dict:
    """State placement, name -> mesh axes per dim, for leaves given by
    shape (``(layers, B, ...)``): batch over the DP axes; a KV leaf's head
    dim over ``model`` when the heads are sharded."""
    b_axes = batch_spec(mesh, global_batch, ndim=1)[0]

    def spec_for(shape):
        dims = [None] * len(shape)
        dims[1] = b_axes  # leading dim is the layer stack
        if (len(shape) == 5 and cfg.n_kv_heads and
                shape[3] == cfg.n_kv_heads and cfg.kv_sharded):
            dims[3] = "model"
        return tuple(dims)

    return {k: spec_for(tuple(s)) for k, s in leaves.items()}


def count_collective_free(mesh) -> int:
    return int(math.prod(mesh.shape.values()))
