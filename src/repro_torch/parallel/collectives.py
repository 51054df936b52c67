"""Distributed-optimization collectives over ``torch.distributed``.

Port of ``repro.parallel.collectives``.

``compressed_psum_tree`` is the int8 error-feedback gradient reduce of the
cross-pod hop: each pod quantizes its gradients to int8 with one f32 scale
per group of leaves (``groups=``; the train step's groups are the
reference's leaves, a stage's stack of blocks sharing one scale, as the
reference's quantizer reads its stacked tree), the int8 payload crosses
the wire as a ring of ``size - 1`` point-to-point hops
(``dist.batch_isend_irecv``) with the groups' scales riding along, and
each rank dequantizes the sum and keeps its quantization residual by leaf
(error feedback), so the bias cancels over steps.  It is not an
``all_reduce`` of an upcast tensor: that would move four times the bytes
(and sum the scales in another order).  Each rank sums the scales in the
reference's hop order (its own, then its ring predecessors'), so the
result is the reference's bit for bit on every rank; with more than two
pods the ranks' results can differ in the last bit, as the reference's
do.  Used by ``train.train_loop.make_train_step(compress_crosspod=True,
mesh=pod_mesh())``.

``hierarchical_psum`` is the explicit two-level reduce: an ``all_reduce``
within the inner group, then across the outer.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel import Mesh, make_mesh

__all__ = ["pod_mesh", "quantize_int8", "dequantize_int8", "compressed_psum",
           "compressed_psum_tree", "init_error_tree", "hierarchical_psum",
           "pmean"]


def pod_mesh(group=None, device=None) -> Mesh:
    """1-D ``("pod",)`` mesh over ``group`` (default: the world): one rank
    per pod, the axis of the cross-pod gradient reduce."""
    return make_mesh("pod", group, device)


def quantize_int8(x: torch.Tensor, amax: torch.Tensor | None = None):
    """Symmetric per-tensor int8 quantization (scale in f32).  ``amax``:
    the largest ``|x|`` of the whole tensor when ``x`` is a shard of it
    (default: ``x``'s own)."""
    xf = x.to(torch.float32)
    if amax is None:
        amax = xf.abs().max()
    scale = _scale(amax)
    return _codes(xf, scale), scale


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / 127.0


def _codes(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _ring_hop(mesh: Mesh, bufs: list[torch.Tensor]) -> list[torch.Tensor]:
    """One hop of the ring: every rank sends ``bufs`` to its successor and
    receives its predecessor's."""
    dst = mesh.global_rank((mesh.rank + 1) % mesh.size)
    src = mesh.global_rank((mesh.rank - 1) % mesh.size)
    outs = [torch.empty_like(b) for b in bufs]
    ops = ([dist.P2POp(dist.isend, b, dst, mesh.group) for b in bufs]
           + [dist.P2POp(dist.irecv, o, src, mesh.group) for o in outs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def _ring_sum(mesh: Mesh, q: torch.Tensor, scale: torch.Tensor):
    """The int32 sum of every rank's int8 ``q`` and the f32 sum of their
    ``scale`` (elementwise), the scales added in hop order."""
    acc = q.to(torch.int32)
    scale_sum = scale
    buf, sbuf = q.contiguous(), scale.contiguous()
    for _ in range(mesh.size - 1):
        buf, sbuf = _ring_hop(mesh, [buf, sbuf])      # int8 on the wire
        acc = acc + buf.to(torch.int32)
        scale_sum = scale_sum + sbuf
    return acc, scale_sum


def _mean(acc: torch.Tensor, scale_sum: torch.Tensor, n: int):
    # each shard used its own scale; the shared-mean-scale approximation's
    # residual also lands in the error feedback next step
    return acc.to(torch.float32) * (scale_sum / n) / n


def compressed_psum(x: torch.Tensor, mesh: Mesh, error: torch.Tensor):
    """int8 error-feedback mean-reduce of ``x`` over ``mesh``'s ranks.
    Returns ``(mean f32 tensor, new local error residual)``."""
    xf = x.to(torch.float32) + error
    q, scale = quantize_int8(xf)
    new_error = xf - dequantize_int8(q, scale)
    acc, scale_sum = _ring_sum(mesh, q, scale.reshape(1))
    return _mean(acc, scale_sum[0], mesh.size), new_error


def compressed_psum_tree(tree: dict, mesh: Mesh, error_tree: dict,
                         shard_max=None, groups: dict | None = None):
    """:func:`compressed_psum` of the tensors of ``tree`` (a dict by name,
    ``error_tree`` its residuals), each output cast back to its leaf's
    dtype.

    ``groups`` maps each leaf's name to the key of its group (default:
    every leaf its own group, as the reference's function reduces the
    leaves of whatever tree it is given).  A group's members quantize
    with one scale, the largest ``|x + e|`` over all of them / 127: the
    reduce of the leaf that stacks them.  The leaves travel together: one
    ring of ``size - 1`` hops of the concatenated int8 payload and the
    vector of the groups' scales, and each member's mean takes its
    group's sum of scales.  The residuals stay by leaf.

    ``shard_max``: where each leaf is this rank's shard of a placed
    gradient, a function taking the vector of the groups' local ``|x|``
    maxima to the whole groups' (a max all-reduce of the vector over the
    pod's axes, ``Placement.shard_max``), so that each shard quantizes
    with its whole group's scale; the ring then runs on the shards, the
    residuals stay the rank's."""
    names = list(tree)
    xf = {k: tree[k].to(torch.float32) + error_tree[k] for k in names}
    group = {k: k if groups is None else groups[k] for k in names}
    members: dict = {}
    for k in names:
        members.setdefault(group[k], []).append(xf[k].abs().max())
    gid = {g: i for i, g in enumerate(members)}
    amax = torch.stack([torch.stack(m).max() for m in members.values()])
    if shard_max is not None:
        amax = shard_max(amax)
    scales = _scale(amax)
    qs, errs = [], {}
    for k in names:
        scale = scales[gid[group[k]]]
        q = _codes(xf[k], scale)
        errs[k] = xf[k] - dequantize_int8(q, scale)
        qs.append(q.reshape(-1))
    acc, scale_sum = _ring_sum(mesh, torch.cat(qs), scales)
    out, i = {}, 0
    for k in names:
        n = tree[k].numel()
        mean = _mean(acc[i:i + n], scale_sum[gid[group[k]]], mesh.size)
        out[k] = mean.reshape(tree[k].shape).to(tree[k].dtype)
        i += n
    return out, errs


def init_error_tree(grads_tree: dict) -> dict:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads_tree.items()}


def pmean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``x`` over ``mesh``'s ranks (``psum / size``)."""
    y = x.clone()
    dist.all_reduce(y, group=mesh.group)
    return y / mesh.size


def hierarchical_psum(x: torch.Tensor, inner: Mesh,
                      outer: Mesh) -> torch.Tensor:
    """Reduce within the pod (``inner``), then across pods (``outer``)."""
    y = x.clone()
    dist.all_reduce(y, group=inner.group)
    dist.all_reduce(y, group=outer.group)
    return y
