"""The model-axis and data-axis collectives of tensor-parallel compute, as
``torch.autograd.Function`` s over the axes of a ``(data, model)`` mesh.

The reference computes its placed steps under GSPMD, which inserts the
collectives itself; the port runs SPMD, one process a rank, and inserts
them by hand, in Megatron's pairs:

  :func:`copy_to`      identity forward, all-reduce backward: the input of
                       a column-parallel product (each rank's product
                       reads the whole activation, so the activation's
                       gradient is the sum of every rank's part);
  :func:`reduce_from`  all-reduce forward, identity backward: the output of
                       a row-parallel product (each rank holds a partial
                       sum), and the vocabulary-parallel lookup;
  :func:`gather_from`  all-gather along ``dim`` forward, reduce-scatter
                       backward: sequence-parallel residuals entering a
                       column-parallel product, FSDP's gather of a
                       parameter placed on ``data`` before its layer runs,
                       and the SSM's ``B``/``C`` slabs, whole for every
                       rank's channels;
  :func:`scatter_to`   reduce-scatter along ``dim`` forward, all-gather
                       backward: a row-parallel output leaving for
                       sequence-parallel residuals.

``reduce_from(copy_to(x))`` all-reduces both ways: a sum every rank
reads for its own part (the data slabs' loss mean, the SSM's gated norm
over its channels).  Decode runs under ``no_grad``, so its one collective
of its own is a plain function: :func:`softmax_combine`, the
context-parallel combine of each rank's softmax partials over its slab
of a KV ring's slots.

An axis of size 1 is the identity both ways, with no collective.  The
collectives run on a *comm*: :class:`MeshComm` over a ``torch.distributed``
``DeviceMesh`` (gloo on the CPU, NCCL on the card), or, for the dry-run
alone (``launch/specs.py``), :class:`RecordingComm`, a stand-in on meta
tensors that records each collective's op, axis and the bytes one rank
receives instead of running it (a ring all-gather over ``n`` ranks brings
``(n - 1) / n`` of its output, a reduce-scatter ``(n - 1) / n`` of its
input, an all-reduce twice that).  A real mesh never reaches the stand-in.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class MeshComm:
    """Collectives over the named axes of a ``DeviceMesh``.  ``scope``
    tags the dry-run's records; here it is unused."""

    def __init__(self, device_mesh):
        self.mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape))
        self.scope = "entry"

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def rank(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis)

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        out = t.contiguous().clone()
        dist.all_reduce(out, op=getattr(dist.ReduceOp, op.upper()),
                        group=self.mesh.get_group(axis))
        return out

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((self.size(axis) * src.shape[0],)
                            + src.shape[1:])
        dist.all_gather_into_tensor(out, src,
                                    group=self.mesh.get_group(axis))
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, t: torch.Tensor, axis: str,
                       dim: int) -> torch.Tensor:
        n = self.size(axis)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"divide over the {n} ranks of {axis!r}")
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=self.mesh.get_group(axis))
        return out.movedim(0, dim).contiguous()


class RecordingComm:
    """The dry-run's stand-in for a mesh's groups: rank 0 on every axis of
    ``mesh`` (a ``launch.mesh.MeshShape``), meta tensors in and out, and a
    record ``(op, axis, bytes received, scope)`` for each collective in
    :attr:`records`.  ``scope`` is ``"body"`` while a placed layer runs
    (its backward collectives keep the scope of their forward), else
    ``"entry"``."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axis_names = tuple(mesh.axis_names)
        self.shape = dict(mesh.shape)
        self.scope = "entry"
        self.records: list = []

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def rank(self, axis: str) -> int:
        return 0

    def _record(self, op: str, axis: str, nbytes: float) -> None:
        self.records.append((op, axis, nbytes, self.scope))

    def all_reduce(self, t, axis, op="sum"):
        n = self.size(axis)
        self._record("all-reduce", axis, 2 * _nbytes(t) * (n - 1) / n)
        return t.clone()

    def all_gather(self, t, axis, dim):
        n = self.size(axis)
        shape = list(t.shape)
        shape[dim] *= n
        out = t.new_empty(shape)
        self._record("all-gather", axis, _nbytes(out) * (n - 1) / n)
        return out

    def reduce_scatter(self, t, axis, dim):
        n = self.size(axis)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"divide over the {n} ranks of {axis!r}")
        shape = list(t.shape)
        shape[dim] //= n
        self._record("reduce-scatter", axis, _nbytes(t) * (n - 1) / n)
        return t.new_empty(shape)


def comm_of(mesh):
    """The comm of ``mesh``: a ``DeviceMesh`` gets a :class:`MeshComm`; a
    comm is itself."""
    if isinstance(mesh, (MeshComm, RecordingComm)):
        return mesh
    return MeshComm(mesh)


class Scoped:
    """A context in which ``comm``'s collectives carry ``scope``: a
    backward's collective under the scope of its forward, a placed
    layer's under ``"body"``."""

    def __init__(self, comm, scope: str):
        self.comm, self.scope = comm, scope

    def __enter__(self):
        self.prev, self.comm.scope = self.comm.scope, self.scope

    def __exit__(self, *exc):
        self.comm.scope = self.prev


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis, ctx.scope = comm, axis, comm.scope
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with Scoped(ctx.comm, ctx.scope):
            return ctx.comm.all_reduce(g, ctx.axis), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        return comm.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, dim):
        ctx.comm, ctx.axis, ctx.dim, ctx.scope = comm, axis, dim, comm.scope
        return comm.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        with Scoped(ctx.comm, ctx.scope):
            return (ctx.comm.reduce_scatter(g, ctx.axis, ctx.dim), None,
                    None, None)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, dim):
        ctx.comm, ctx.axis, ctx.dim, ctx.scope = comm, axis, dim, comm.scope
        return comm.reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        with Scoped(ctx.comm, ctx.scope):
            return (ctx.comm.all_gather(g, ctx.axis, ctx.dim), None, None,
                    None)


def copy_to(x: torch.Tensor, comm, axis: str) -> torch.Tensor:
    """Identity forward, all-reduce over ``axis`` backward."""
    return x if comm.size(axis) == 1 else _Copy.apply(x, comm, axis)


def reduce_from(x: torch.Tensor, comm, axis: str) -> torch.Tensor:
    """All-reduce (sum) over ``axis`` forward, identity backward."""
    return x if comm.size(axis) == 1 else _Reduce.apply(x, comm, axis)


def gather_from(x: torch.Tensor, comm, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``axis`` concatenated along ``dim`` in rank
    order forward; the gradient's reduce-scatter along ``dim`` backward."""
    return x if comm.size(axis) == 1 else _Gather.apply(x, comm, axis, dim)


def scatter_to(x: torch.Tensor, comm, axis: str, dim: int) -> torch.Tensor:
    """The sum over ``axis`` of every rank's ``x``, this rank's slab of it
    along ``dim`` forward; the gradient's all-gather backward."""
    return x if comm.size(axis) == 1 else _Scatter.apply(x, comm, axis, dim)


def all_reduce(t: torch.Tensor, comm, axes, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over each of ``axes`` in turn (no autograd): the
    gradients' reduces, the loss's mean and the global norm."""
    for a in axes:
        if comm.size(a) > 1:
            t = comm.all_reduce(t, a, op)
    return t


def softmax_combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                    comm, axis: str) -> torch.Tensor:
    """A softmax-weighted sum over keys split between the ranks of
    ``axis``, from each rank's partials over its keys (float32): the row
    max ``m`` (..., 1), the sum of ``exp(score - m)`` ``l`` (..., 1) and
    the sum of those weights times the values ``acc`` (..., Dh).  One
    all-gather of the packed partials, then, in rank order, the largest
    max and each rank's partials rescaled by ``exp(m_r - max)`` and summed
    from zero: every rank computes the same ops on the same gathered bits,
    so every rank gets the same result.  Returns ``acc / l`` (..., Dh)."""
    n = comm.size(axis)
    part = torch.cat([m, l, acc], -1)[None]
    if n > 1:
        part = comm.all_gather(part, axis, 0)
    ms, ls, accs = part[..., :1], part[..., 1:2], part[..., 2:]
    top = ms[0]
    for r in range(1, n):
        top = torch.maximum(top, ms[r])
    den = torch.zeros_like(ls[0])
    num = torch.zeros_like(accs[0])
    for r in range(n):
        w = torch.exp(ms[r] - top)
        den = den + ls[r] * w
        num = num + accs[r] * w
    return num / den
