"""The train step: microbatch gradient accumulation, global-norm clip,
cosine learning rate and AdamW.

Port of ``repro.train.train_loop``.
``make_train_step(cfg)`` returns ``step(state, batch) -> (state,
metrics)``; the step runs where the model lives (the card, unless the
model was built on the CPU), moves the batch there, and writes the updated
parameters into the model in place.

``compress_crosspod=True`` with ``mesh=parallel.collectives.pod_mesh()``
is the cross-pod step, SPMD over the pod ranks: every rank is called with
the same global batch, computes its pod's gradients on its slab of the
batch rows, and reduces them with the int8 error-feedback
``compressed_psum_tree``, one scale per leaf of the reference's tree
(:func:`crosspod_groups`: a stage's blocks at one place of its pattern
share their stacked leaf's scale); the residuals ride by parameter in
``TrainState.error``, and the loss is the ranks' mean.  Clip, learning
rate and AdamW then run as in the plain step, on every rank alike.

``make_train_step(cfg, device_mesh=mesh)`` is the dense and MoE
families' step under the compute placement (``parallel/sharding.
place_model``), SPMD over the mesh's ranks, each called with the same
global batch and the state of its placed model: the rank computes its
data slab of each microbatch's loss and gradients on its heads, MLP
columns, experts (or expert columns) and vocabulary shard; the gradients of
parameters placed on ``data`` are reduce-scattered by their FSDP
gathers' backward, every other gradient is summed over the batch axes,
and the gradients that are each model rank's part are summed over
``model`` once (``Placement.reduce_grads``), all before the
``grad_dtype`` cast; the clip's norm counts each entry of the mesh once
and AdamW updates the rank's shards.  The loss is the global mean on every
rank.  A microbatch the batch axes do not divide lies over those that
divide it and whole on the ranks of the rest (the reference's
``batch_pspec``).  Both at once, on a ``("pod", "data", "model")`` mesh,
is the reference's ``pod_step``: each pod's gradients placed within the
pod, then the int8 ring over ``pod`` on every rank's shards.
"""

from __future__ import annotations

import contextlib
from dataclasses import fields, replace
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import leaf_paths
from repro_torch.models.transformer import LM, loss_fn
from repro_torch.parallel.collectives import (compressed_psum_tree,
                                              init_error_tree, pmean)
from repro_torch.parallel.tensor import comm_of
from repro_torch.train.optimizer import (AdamWState, adamw_init,
                                         adamw_update, as_dtype,
                                         clip_by_global_norm, cosine_lr)


class TrainState(NamedTuple):
    model: LM               # its parameters are the trained parameters
    opt: AdamWState
    step: torch.Tensor      # () int32
    error: dict | None = None   # compression error-feedback residuals


def init_train_state(model: LM, moment_dtype=None,
                     with_error: bool = False) -> TrainState:
    """AdamW moments in ``moment_dtype`` (default: the model config's
    ``moment_dtype``) and step 0; ``with_error`` adds the cross-pod step's
    float32 error-feedback residuals (zeros, by parameter name)."""
    if moment_dtype is None:
        moment_dtype = model.cfg.moment_dtype
    params = dict(model.named_parameters())
    opt = adamw_init(params, moment_dtype)
    return TrainState(model=model, opt=opt, step=torch.zeros_like(opt.step),
                      error=init_error_tree(params) if with_error else None)


def _on_model(model: LM, batch: dict) -> dict:
    """The batch's arrays as tensors on the model's device: ``tokens`` and
    ``labels`` int64, the float planes (``memory``, ``enc_inputs``) in the
    model's dtype."""
    p = model.embedding

    def put(k, v):
        t = torch.as_tensor(v if isinstance(v, torch.Tensor)
                            else np.asarray(v), device=p.device)
        return t.to(torch.int64 if k in ("tokens", "labels") else p.dtype)

    return {k: put(k, v) for k, v in batch.items()}


def _value_and_grad(model: LM, batch: dict):
    """The loss and its gradients; a placed rank's are those of its data
    slab's share of the global mean (``1 / dp`` of its loss), before
    the reduces."""
    params = dict(model.named_parameters())
    loss = loss_fn(model, batch)
    seed = None if model.placement is None else torch.full_like(
        loss, 1.0 / model.placement.dp)
    grads = torch.autograd.grad(loss, list(params.values()),
                                grad_outputs=seed)
    return loss.detach(), dict(zip(params, grads))


def _grads(model: LM, batch: dict, n: int):
    """:func:`grads_fn` over ``n`` microbatches.  A placed rank takes its
    rows of each microbatch of the global batch, the reference's split:
    a microbatch's MoE load-balance loss spans its rows on every data
    rank."""
    batch = _on_model(model, batch)
    pl = model.placement

    def local(mb):
        # a microbatch the batch axes do not divide lies whole on the
        # ranks of those it replicates over (the reference's batch_pspec);
        # their gradients, each 1 / dp of the slab's, then sum to one
        # slab's in reduce_grads, and batch_mean averages equal terms
        return mb if pl is None else {k: pl.rows(v) for k, v in mb.items()}

    if n <= 1:
        loss, grads = _value_and_grad(model, local(batch))
        if pl is None:
            return loss, grads
        return pl.batch_mean(loss), pl.reduce_grads(grads)
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into grad_accum={n} "
                         "microbatches")
    total = torch.zeros((), dtype=torch.float32,
                        device=model.embedding.device)
    gsum = None
    for i in range(n):
        mb = {k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
        loss, g = _value_and_grad(model, local(mb))
        total = total + loss
        gsum = ({k: x.to(torch.float32) for k, x in g.items()} if gsum is None
                else {k: gsum[k] + x for k, x in g.items()})
    if pl is not None:
        total, gsum = pl.batch_mean(total), pl.reduce_grads(gsum)
    scale = 1.0 / n
    gdt = as_dtype(model.cfg.grad_dtype)
    return total * scale, {k: (g * scale).to(gdt) for k, g in gsum.items()}


def grads_fn(model: LM, batch: dict):
    """``(loss, grads)`` by parameter name.  Under ``model.cfg.grad_accum
    = n > 1`` the batch (every plane, the memory's too) splits into n
    equal microbatches along its first axis; loss and gradients are their
    means (accumulated in float32, the gradients then cast to
    ``model.cfg.grad_dtype``).  A placed model (``sharding.place_model``)
    takes the global batch, and gives the global mean loss and this rank's
    shards of its gradients."""
    return _grads(model, batch, model.cfg.grad_accum)


def crosspod_groups(model: LM) -> dict:
    """Each parameter name -> the key path of its leaf in the reference's
    tree (``convert.leaf_paths``), the cross-pod reduce's groups: the
    blocks of a stage at one place of its pattern (the encoder's blocks)
    share the leaf that stacks them over the stage's repeats, and so one
    int8 scale, as the reference's ``pod_step`` quantizes its tree's
    leaves; ``embedding``, ``final_norm`` and an untied ``lm_head`` are
    each a group of their own."""
    return {k: path for k, (path, _) in leaf_paths(model).items()}


def _check_step_cfg(cfg: ModelConfig, model_cfg: ModelConfig) -> None:
    """The step's config may differ from the model's only in
    ``grad_accum``: the model's config is what its forward reads."""
    if replace(cfg, grad_accum=model_cfg.grad_accum) != model_cfg:
        diff = sorted(f.name for f in fields(cfg) if f.name != "grad_accum"
                      and getattr(cfg, f.name) != getattr(model_cfg, f.name))
        raise ValueError(f"train step config differs from the model's in "
                         f"{diff}: only grad_accum may differ")


@contextlib.contextmanager
def within_pod(model: LM):
    """The model's placement, while the block runs, as one pod sees it
    (``Placement.within_pod``): the pod's rows over ``data``, the reduces
    stopping at the pod."""
    pl = model.placement
    if pl is not None:
        model.placement = pl.within_pod()
    try:
        yield
    finally:
        model.placement = pl


def _pod_shard(batch: dict, mesh) -> dict:
    """This pod's rows of every batch plane (the batch's first axis cut
    into ``mesh.size`` equal slabs)."""
    b = next(iter(batch.values())).shape[0]
    if b % mesh.size:
        raise ValueError(f"batch {b} does not split over {mesh.size} pods")
    r0, r1 = mesh.slab(b)
    return {k: v[r0:r1] for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, *, base_lr: float = 3e-4,
                    max_grad_norm: float = 1.0,
                    compress_crosspod: bool = False, mesh=None,
                    device_mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)`` with
    metrics ``{"loss", "grad_norm", "lr"}`` as device scalars (no host
    sync).  ``cfg`` must be the model's config, its ``grad_accum`` aside
    (the step splits the batch into ``cfg.grad_accum`` microbatches);
    the step raises otherwise.  The learning rate of step ``i`` is
    ``cosine_lr(i)`` (zero at step 0, the reference's warmup).

    ``compress_crosspod=True`` needs ``mesh``, a ``("pod",)`` mesh
    (``parallel.collectives.pod_mesh``), and a state with ``error``
    (``init_train_state(model, with_error=True)``); the model lives on the
    mesh's device.  Every pod rank calls the step with the same batch.

    ``device_mesh`` (a ``(data, model)`` ``DeviceMesh``) is the compute
    placement's step: the state's model must be placed on that mesh
    (``parallel.sharding.place_model``), and every rank calls the step
    with the same global batch.  With ``compress_crosspod`` too, the
    device mesh is ``("pod", "data", "model")`` and ``mesh`` its ``pod``
    group's pod mesh: each pod computes its rows' gradients placed over
    its ``data`` and ``model`` ranks, reduced within the pod alone, then
    the int8 ring over ``pod`` reduces each rank's shards with the whole
    groups' scales (``Placement.shard_max``); the clip's norm counts each
    entry of a pod once.  Both cross-pod steps quantize in the groups of
    :func:`crosspod_groups` of the state's model: one scale per leaf of
    the reference's tree."""
    if compress_crosspod and (mesh is None or mesh.axis != "pod"):
        raise ValueError("compress_crosspod requires the multi-pod mesh: "
                         "pass mesh=parallel.collectives.pod_mesh()")
    comm = None if device_mesh is None else comm_of(device_mesh)
    if compress_crosspod and comm is not None and (
            "pod" not in comm.axis_names or comm.size("pod") != mesh.size):
        raise ValueError(
            "compress_crosspod under the compute placement needs a "
            "device_mesh with a 'pod' axis of the pod mesh's size: "
            "pass mesh=parallel.collectives.pod_mesh(group="
            "device_mesh.get_group('pod'))")

    def train_step(state: TrainState, batch: dict):
        _check_step_cfg(cfg, state.model.cfg)
        pl = state.model.placement
        if (pl is None) != (device_mesh is None) or (
                pl is not None and pl.mesh is not device_mesh):
            raise ValueError(
                "the step's device_mesh and the model's placement differ: "
                "place the model with parallel.sharding.place_model(model, "
                "device_mesh) and pass the same mesh to make_train_step")
        if compress_crosspod:
            if state.error is None:
                raise ValueError(
                    "compress_crosspod keeps error-feedback residuals in "
                    "TrainState.error: build the state with "
                    "init_train_state(model, with_error=True)")
            with within_pod(state.model):
                loss, grads = _grads(state.model, _pod_shard(batch, mesh),
                                     cfg.grad_accum)
            grads, error = compressed_psum_tree(
                grads, mesh, state.error,
                shard_max=None if pl is None else pl.shard_max,
                groups=crosspod_groups(state.model))
            loss = pmean(loss, mesh)
        else:
            loss, grads = _grads(state.model, batch, cfg.grad_accum)
            error = state.error
        grads, gnorm = clip_by_global_norm(
            grads, max_grad_norm, total=None if pl is None
            else pl.sum_squares)
        lr = cosine_lr(state.step, base_lr=base_lr)
        params = dict(state.model.named_parameters())
        new_params, opt = adamw_update(grads, state.opt, params, lr)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_params[k])
        return (TrainState(state.model, opt, state.step + 1, error),
                {"loss": loss, "grad_norm": gnorm, "lr": lr})

    return train_step
