"""Production mesh constructors over ``torch.distributed``.

Port of ``repro.launch.mesh``.  The reference's production mesh is 16 x 16
TPU chips a pod, ``("data", "model")``, with a leading ``"pod"`` axis of 2
across pods.  Here it is a ``torch.distributed`` :class:`DeviceMesh` of
the same shape and axis names, one rank per card, built from the caller's
process group as :func:`repro_torch.parallel.make_mesh` builds the 1-D
meshes (NCCL for ranks on the card, gloo on the CPU): a constructor without a
group, or with a world of another size, raises :class:`MeshError`.

Each rank holds the reference's shard of every parameter
(``parallel/sharding.py``); a ``dense`` model placed on the mesh
(``sharding.place_model``) computes its share of the heads, MLP columns
and vocabulary on its data slab, every other family its data slab at
full width.
Each axis's group (``device_mesh.get_group(axis)``) builds the port's
existing 1-D meshes: ``pod_mesh(group=...)`` on ``"pod"``,
``chunk_mesh``/``lane_mesh`` on ``"data"``, so the placement code runs on
an axis of the production mesh unchanged.

:class:`MeshShape` is a mesh's axis names and sizes without a process
group: what the dry-run (``launch/dryrun.py``) and the sharding rules
read, with nothing allocated and no rank started.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.parallel import MeshError


@dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes, major first; ``shape`` maps each name to its
    size, as a JAX mesh's ``shape`` does."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """16 x 16 cards a pod; 2 pods when ``multi_pod`` (512 in all)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def mesh_shape_for(devices: int, model_parallel: int = 16) -> MeshShape:
    """The largest ``(data, model)`` shape for a survivor set: ``model``
    the largest divisor of ``devices`` up to ``model_parallel``."""
    model = min(model_parallel, devices)
    while devices % model:
        model -= 1
    return MeshShape(("data", "model"), (devices // model, model))


def mesh_shape_of(device_mesh) -> MeshShape:
    """A :class:`DeviceMesh`'s axis names and sizes."""
    return MeshShape(tuple(device_mesh.mesh_dim_names),
                     tuple(device_mesh.shape))


def _device_mesh(shape: MeshShape, device=None):
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise MeshError(
            f"a {shape.axis_names} mesh needs an initialized process group:"
            " call torch.distributed.init_process_group first (NCCL for "
            "ranks on the card, gloo for ranks on the CPU)")
    world = dist.get_world_size()
    if world != shape.size:
        raise MeshError(f"a {shape.shape} mesh needs {shape.size} ranks; "
                        f"the process group has {world}")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, shape.sizes,
                            mesh_dim_names=shape.axis_names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production :class:`DeviceMesh` over the caller's process group
    of 256 (512 with ``multi_pod``) ranks, on ``device`` (the card unless
    given)."""
    return _device_mesh(production_mesh_shape(multi_pod=multi_pod), device)


def make_mesh_for(devices: int, model_parallel: int = 16, device=None):
    """Elastic helper: the :class:`DeviceMesh` of :func:`mesh_shape_for`
    over a process group of ``devices`` ranks."""
    return _device_mesh(mesh_shape_for(devices, model_parallel), device)

