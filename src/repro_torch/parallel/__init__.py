"""Placement over ``torch.distributed``: the port's form of a device mesh.

Every mesh of the reference here is a 1-D axis with no collectives inside
the program: ``("chunks",)`` (:func:`~repro_torch.parallel.chunked.
chunk_mesh`), ``("lanes",)`` (:func:`~repro_torch.parallel.chunked.
lane_mesh`) and the ``"pod"`` axis of the cross-pod gradient reduce
(:func:`~repro_torch.parallel.collectives.pod_mesh`).  ``shard_map`` runs
one program on every device over its slab of the placed axis; the port
runs SPMD instead, one process per rank: every rank calls the same entry
point with the same arguments, takes its slab by rank, runs the
single-device program on it and gathers the outputs, so that every rank
returns the whole result.  A host-bound loop (every LM path) scales over
cards only so: one process per card.

Process groups belong to the caller, as the card's numeric settings do
(:func:`repro_torch.configure_cuda_numerics`): start one with
``torch.distributed.init_process_group`` (``torchrun``, or a
``FileStore``), NCCL for ranks on the card and gloo for ranks on the CPU.
A mesh constructor without one raises :class:`MeshError`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["Mesh", "MeshError", "gather", "make_mesh"]


class MeshError(RuntimeError):
    """A mesh was asked for without a usable process group."""


@dataclass(frozen=True)
class Mesh:
    """One placed axis over a process group.

    ``size`` ranks share the axis; this process is ``rank`` (its index in
    ``group``) and computes on ``device``.  ``size`` stands where the
    reference reads ``mesh.shape[axis]``."""

    axis: str
    group: object
    size: int
    rank: int
    device: torch.device

    def slab(self, n: int) -> tuple[int, int]:
        """This rank's ``[i0, i1)`` of ``n`` items cut into ``size`` equal
        slabs (callers check that ``size`` divides ``n``)."""
        return self.rank * n // self.size, (self.rank + 1) * n // self.size

    def global_rank(self, rank: int) -> int:
        """The world rank of this group's rank ``rank``."""
        return dist.get_global_rank(self.group, rank)


def make_mesh(axis: str, group=None, device=None) -> Mesh:
    """A 1-D ``(axis,)`` mesh over ``group`` (default: the world) with this
    rank computing on ``device`` (the card unless given).  NCCL serves a
    rank on the card and gloo a rank on the CPU."""
    if not (dist.is_available() and dist.is_initialized()):
        raise MeshError(
            f"a ({axis!r},) mesh needs an initialized process group: call "
            "torch.distributed.init_process_group first (NCCL for ranks on "
            "the card, gloo for ranks on the CPU; torchrun, or a FileStore "
            "and each rank's rank and world size)")
    group = dist.group.WORLD if group is None else group
    dev = resolve_device(device)
    backend = str(dist.get_backend(group))
    want = "nccl" if dev.type == "cuda" else "gloo"
    if want not in backend:
        raise MeshError(
            f"a rank on {dev} needs a {want} process group; this group's "
            f"backend is {backend!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(axis=axis, group=group, size=dist.get_world_size(group),
                rank=dist.get_rank(group), device=dev)


def gather(mesh: Mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (all of one shape) concatenated in rank order
    along ``dim``, on every rank.  Bool tensors travel as uint8."""
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if t.dtype == torch.bool else out
