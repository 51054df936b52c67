"""Logical-axis -> mesh-axis placement rules, and every family's placed
model: tensor-parallel compute over ``model`` (expert parallelism, or
per-expert tensor parallelism; the SSM and RG-LRU channels; cross
attention and the encoder), FSDP over ``data``.

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

Each rank holds exactly the reference's shard of every parameter
(:func:`shard_params`, a ``narrow`` at the rank's mesh coordinates;
:func:`unshard` is the way back, an ``all_gather`` per placed axis,
bitwise the whole tensor).  What a rank computes depends on the family:

* ``dense`` (:func:`place_model`): the reference's **compute** placement.
  A rank computes its data slab of the batch (:meth:`Placement.rows`)
  with its share of the query heads, of the MLP's columns and of the
  vocabulary, Megatron's column- and row-parallel pairs over ``model``
  (``parallel/tensor.py``), and gathers each layer's FSDP shards over
  ``data`` inside the layer's checkpointed unit.  Residuals follow
  ``cfg.act_pspec``: sequence-parallel over ``model`` when its sequence
  entry is ``"model"``, else whole on every rank of a ``model`` row.
  Parameters replicated over ``model`` whose gradient is each rank's
  part (the q/k norms, K/V projections replicated over ``kv_heads_repl``,
  the norms under sequence parallelism) are all-reduced over ``model``
  once a step (:meth:`Placement.reduce_grads`).  It also serves: the
  decode state is the rank's shard (:meth:`Placement.place_state`), its
  KV rings laid out by :func:`ring_layout` (the reference's
  ``cache_shardings``), and a step's logits are the rank's vocabulary
  slab of its rows (:meth:`Placement.whole_vocab` gathers whole rows,
  :meth:`Placement.whole_rows` every rank's rows).  A batch the batch
  axes do not divide lies over those that divide it and whole on the
  ranks of the rest (the reference's ``batch_pspec``), in training and in
  serving alike.  The cross-pod step sees one pod's placement
  (:meth:`Placement.within_pod`) and quantizes each shard with its whole
  group's scale (:meth:`Placement.shard_max`; a group is a leaf of the
  reference's tree, a stage's blocks stacked).
* ``moe`` (:func:`place_model` too): the same placement of the
  attention, the vocabulary and the residuals, and the expert FFN by the
  reference's rule (:func:`logical_rules`): expert parallelism when
  ``n_experts % cfg.tp == 0`` (phi3.5-moe: a rank runs its
  ``n_experts / tp`` experts from ``Placement.expert_start``,
  ``Placement.moe_rule == "experts"``), else per-expert
  tensor parallelism (mixtral: every expert on the rank's ``d_ff / tp``
  columns).  Every model rank of a data row routes the same tokens to
  the same experts, so no all-to-all is needed: the rank's experts (or
  columns) run on the whole sequence and their fold is summed over
  ``model`` (``models/moe.py``).
* ``ssm`` and ``hybrid`` (:func:`place_model` too): the reference's
  rules ``ssm_inner -> model`` and ``ssm_state -> model``.  The Mamba2
  mixer (``models/ssm.py``) runs the rank's ``ssm_inner`` channels after
  gathering the small ``B``/``C`` planes of its ``ssm_state`` slab over
  ``model``, its gated norm summing its squares over ``model`` and
  ``out_proj`` row-parallel; the per-head ``wdt``, ``A_log``, ``D`` and
  ``dt_bias`` are whole on every rank, each rank's gradient of them its
  channels' part.  The RG-LRU block (``models/rglru.py``) is
  self-contained on the rank's channels: ``w_x``/``w_y`` column-parallel,
  the convolution, gates and scan local, ``w_out`` row-parallel.  The
  hybrid's local-attention blocks and MLPs are the dense family's.  The
  serving state is the reference's serving cell's
  (``launch/specs.cache_shardings``): the last dim of every ``h`` and
  ``conv`` leaf over ``model`` (the reference's rule wherever it divides,
  which :func:`place_model`'s checks make every case); the SSM step runs
  on that layout (``ssm.ssm_decode_step``).
* ``vlm`` and ``audio`` (:func:`place_model` too): cross attention's
  weights by the same ``heads`` rules as self attention's, its queries
  on the rank's heads of the residual stream and its K/V on the rank's
  kv heads of the memory (the memory's rows are the rank's data slab,
  whole along M on every model rank, :meth:`Placement.enter_memory`);
  the encoder's blocks placed as the decoder's, its residual stream
  whole along M (the reference constrains no encoder activation).

A mesh here is anything with ``axis_names`` and a ``shape`` mapping
(``launch.mesh.MeshShape``, or a JAX mesh in the tests); the placement
functions take the ``torch.distributed`` ``DeviceMesh`` (or the dry-run's
``parallel.tensor.RecordingComm``).
"""

from __future__ import annotations

import copy
import math
from types import SimpleNamespace

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.models.attention import kv_head_map, ring_slots
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import param_axes, pspec_tree
from repro_torch.models.rglru import rglru_width
from repro_torch.models.ssm import ssm_dims
from repro_torch.models.transformer import LM, ModelState
from repro_torch.parallel import tensor as tpc


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
    comm = tpc.comm_of(device_mesh)
    idx, parts = 0, 1
    for a in axes:
        n = comm.size(a)
        idx, parts = idx * n + comm.rank(a), parts * n
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


def ring_layout(cfg: ModelConfig, n_slots: int, model_n: int) -> str:
    """How a decode state's KV rings of ``n_slots`` (tile-padded) slots
    lie over a ``model`` axis of ``model_n`` ranks, the reference's rule
    (``src/repro/launch/specs.py`` ``cache_shardings``): ``"kv_heads"``
    (the kv heads divided) when ``cfg.kv_sharded``, else ``"slots"`` (each
    rank a slab of the ring's slots: decode context parallelism) when the
    slots divide, else ``"replicated"``."""
    if cfg.kv_sharded:
        return "kv_heads"
    return "slots" if n_slots % model_n == 0 else "replicated"


def count_collective_free(mesh) -> int:
    return int(math.prod(mesh.shape.values()))


# ---------------------------------------------------------------------------
# the placed model (dense, moe, ssm, hybrid): tensor-parallel compute
# ---------------------------------------------------------------------------

def model_shard_spec(spec: tuple) -> tuple:
    """``spec`` with only its ``model`` placements: the tensor a rank
    computes with once it has gathered its FSDP shards over ``data``."""
    return tuple("model" if "model" in spec_axes(e) else None for e in spec)


def _placed_axes(spec: tuple) -> set:
    return {a for e in spec for a in spec_axes(e)}


def _state_map(state: ModelState, fn) -> ModelState:
    """``state`` with ``fn(name, leaf)`` applied to every leaf."""
    return ModelState(
        k=None if state.k is None else fn("k", state.k),
        v=None if state.v is None else fn("v", state.v),
        length=state.length,
        recurrent={k: fn(k, t) for k, t in state.recurrent.items()})


class Placement:
    """What one rank of a placed model needs beside its parameter shards:
    the comm over the mesh's axes, the parameters' specs, its coordinates
    and the layout of the residual stream.  Built by :func:`place_model`;
    the model code calls its methods where a collective belongs."""

    def __init__(self, cfg: ModelConfig, mesh, specs: dict, device, *,
                 slots_at_one: bool = False):
        comm = tpc.comm_of(mesh)
        self.cfg, self.mesh, self.comm, self.specs = cfg, mesh, comm, specs
        self.slots_at_one = slots_at_one
        self.batch_axes = tuple(a for a in ("pod", "data")
                                if a in comm.axis_names)
        self.dp = math.prod(comm.size(a) for a in self.batch_axes)
        self.tp, self.tp_rank = comm.size("model"), comm.rank("model")
        pspec = cfg.act_pspec
        self.sp = pspec is not None and len(pspec) > 1 and \
            pspec[1] == "model"
        self.vocab_start = self.tp_rank * cfg.vocab_padded // self.tp
        hp = cfg.n_heads_padded // self.tp
        self.heads = hp
        # the kv head each of this rank's query heads reads, as an index
        # into the K/V heads the rank computes (its shard when the kv heads
        # are placed on model, else all of them); None when that is the
        # grouping j // (heads / kv) and the unplaced attend reads the
        # config as grouped too (no padded heads: attention._heads), so
        # that on one model rank the attend is the unplaced one op for op;
        # None without attention.  The first attention block's K
        # projection says how the kv heads lie (a hybrid's is not block 0)
        wk = sorted((k for k in specs if k.startswith("blocks.")
                     and k.endswith(".attn.wk")),
                    key=lambda k: int(k.split(".")[1]))
        kv_placed = bool(wk) and "model" in spec_axes(specs[wk[0]][1])
        self.kv_index = None
        if wk:
            gmap = kv_head_map(cfg)[self.tp_rank * hp:(self.tp_rank + 1)
                                    * hp]
            kv = cfg.n_kv_heads
            if kv_placed:
                kv //= self.tp
                gmap = gmap - self.tp_rank * kv
                if bool(((gmap < 0) | (gmap >= kv)).any()):
                    raise ValueError(
                        f"{cfg.name}: query heads of model rank "
                        f"{self.tp_rank} read kv heads of another rank's "
                        "shard")
            unplaced = (cfg.n_heads_padded == cfg.n_heads
                        and cfg.n_heads % cfg.n_kv_heads == 0)
            grouped = unplaced and hp % kv == 0 and torch.equal(
                gmap, torch.arange(hp) // (hp // kv))
            self.kv_index = None if grouped else gmap.to(device)
        # the MoE FFN's rule: "experts" (EP: this rank's experts
        # [expert_start, + n_experts / tp)) or "mlp" (per-expert TP: every
        # expert on this rank's columns); None without experts
        self.moe_rule, self.expert_start = None, 0
        if cfg.n_experts:
            ep = "model" in spec_axes(specs["blocks.0.ffn.wi_gate"][0])
            self.moe_rule = "experts" if ep else "mlp"
            if ep:
                self.expert_start = self.tp_rank * cfg.n_experts // self.tp
        # gradients that are each model rank's part: replicated over model,
        # applied to this rank's heads or channels or to its slab of the
        # sequence (the router routes the rank's slab under sequence
        # parallelism; the SSM's per-head leaves act on its channels)
        partial = ("q_norm", "k_norm", "wdt", "A_log", "D", "dt_bias")
        if not kv_placed:
            partial += ("wk", "wv", "bk", "bv")
        # the norms and the router under sequence parallelism (the
        # encoder's residual stream is whole on every rank, never split)
        seq = ("ln1", "ln_cross", "ln2", "final_norm", "router") \
            if self.sp else ()
        self.partial = {k for k in specs
                        if k.rsplit(".", 1)[-1] in partial
                        or (k.rsplit(".", 1)[-1] in seq
                            and not k.startswith("encoder."))}

    # -- the batch and the residual stream ---------------------------------

    def _slab_axes(self, b: int) -> tuple:
        """The batch axes a global batch of ``b`` rows lies over, the
        reference's ``batch_pspec``: as many as divide it (major first);
        it is replicated over the rest (``long_500k``'s one row on every
        rank)."""
        use, n = [], 1
        for a in self.batch_axes:
            if b % (n * self.comm.size(a)) == 0:
                use.append(a)
                n *= self.comm.size(a)
        return tuple(use)

    def _slab(self, b: int) -> tuple:
        """``(index, parts)`` of this rank's data slab of a global batch of
        ``b`` rows (:meth:`_slab_axes`)."""
        return _coord(self.comm, self._slab_axes(b))

    def rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's data slab of a global batch plane (rows on
        ``dim``; :meth:`_slab`)."""
        idx, parts = self._slab(t.shape[dim])
        n = t.shape[dim] // parts
        return t.narrow(dim, idx * n, n)

    def whole_rows(self, t: torch.Tensor, b: int,
                   dim: int = 0) -> torch.Tensor:
        """The global batch of ``b`` rows back from every rank's slab
        ``t`` (rows on ``dim``; :meth:`rows`' inverse): all-gathered over
        the axes the slab lies on, the minor first, in rank order; over
        the axes it is replicated on, nothing moves.  A gather moves bits,
        so every rank gets the same rows."""
        for a in reversed(self._slab_axes(b)):
            if self.comm.size(a) > 1:
                t = self.comm.all_gather(t, a, dim)
        return t

    def within_pod(self) -> "Placement":
        """This placement as one pod of the cross-pod step sees it: the
        batch over ``data`` alone (the pod's rows are its batch; the
        gradients' and the loss's reduces stop at the pod, where the int8
        ring over ``pod`` takes over), the reference's ``pod_step`` with
        ``pod`` dropped from ``act_pspec``.  Without a ``pod`` axis, this
        placement itself."""
        if "pod" not in self.batch_axes:
            return self
        view = copy.copy(self)
        view.batch_axes = tuple(a for a in self.batch_axes if a != "pod")
        view.dp = math.prod(self.comm.size(a) for a in view.batch_axes)
        return view

    def shard_max(self, t: torch.Tensor) -> torch.Tensor:
        """Each entry of ``t`` (the local maxima of this rank's gradient
        shards, one a group of leaves) maxed over the ranks of its pod
        (every axis but ``pod``): the whole groups' maxima, as the
        reference's quantizer reads the whole stacked leaf.  A leaf
        replicated over an axis holds the same bits on each of its ranks
        there, so the max over every axis of the pod is each leaf's over
        the axes it is placed on."""
        return tpc.all_reduce(t, self.comm, tuple(
            a for a in self.comm.axis_names if a != "pod"), "max")

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream (B, S|S/tp, D) into a column-parallel
        product: the whole sequence on every model rank."""
        if self.sp:
            return tpc.gather_from(x, self.comm, "model", 1)
        return tpc.copy_to(x, self.comm, "model")

    def enter_memory(self, mem: torch.Tensor) -> torch.Tensor:
        """A memory (B, M, D) into a column-parallel product (cross
        attention's K/V): it lies whole along M on every model rank, so
        it enters as it is, and each rank's gradient of it, its kv heads'
        part, is summed over ``model`` backward (``copy_to``; never the
        sequence gather of :meth:`enter`)."""
        return tpc.copy_to(mem, self.comm, "model")

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial sums (B, S, D) back into the
        residual stream: summed over model, this rank's sequence slab
        under sequence parallelism."""
        if self.sp:
            return tpc.scatter_to(y, self.comm, "model", 1)
        return tpc.reduce_from(y, self.comm, "model")

    def whole_stream(self) -> "Placement":
        """This placement with the residual stream whole along the
        sequence on every model rank (no sequence parallelism): the
        encoder's, whose activations the reference leaves unconstrained,
        and a serving step's (:meth:`serving`)."""
        view = copy.copy(self)
        view.sp = False
        return view

    def body(self) -> "tpc.Scoped":
        """A context in which the collectives are a layer's (``comm.scope
        = "body"``, the dry-run's records)."""
        return tpc.Scoped(self.comm, "body")

    def whole_sequence(self, t: torch.Tensor) -> torch.Tensor:
        """A per-token tensor (B, S|S/tp, ...) of the residual stream as it
        lies, whole over the sequence on every model rank: under sequence
        parallelism every rank's slab gathered in rank order.  What reads
        the whole (the MoE routing) computes the same on every model rank,
        so each rank's gradient of it is the whole gradient, not a part:
        the other ranks' slabs are spliced in without a gradient, and the
        backward keeps this rank's slab of it alone, with no collective."""
        if not self.sp or self.tp == 1:
            return t
        n, r = t.shape[1], self.tp_rank
        whole = self.comm.all_gather(t.detach(), "model", 1)
        return torch.cat([whole[:, :r * n], t, whole[:, (r + 1) * n:]], 1)

    def fold(self, w: torch.Tensor) -> torch.Tensor:
        """The MoE router's weights (N, k) as they enter the fold of this
        rank's experts' (or columns') outputs: each rank's gradient of
        them is its part (its own picks, or its partial products), so
        the backward sums them over ``model`` (``copy_to``)."""
        return tpc.copy_to(w, self.comm, "model")

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        return tpc.reduce_from(t, self.comm, "model")

    def model_total(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ``model`` of every rank's ``t``, all-reduced both
        ways (``copy_to`` then ``reduce_from``): a sum each rank reads for
        its own part, so its gradient is summed too (the SSM's gated
        norm's sum of squares over its channels)."""
        return tpc.reduce_from(tpc.copy_to(t, self.comm, "model"),
                               self.comm, "model")

    def model_max(self, t: torch.Tensor) -> torch.Tensor:
        return tpc.all_reduce(t.detach(), self.comm, ("model",), "max")

    def model_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every model rank's ``t`` concatenated along ``dim`` in rank
        order."""
        return tpc.gather_from(t, self.comm, "model", dim)

    def model_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over ``model`` of every rank's ``t``, this rank's slab
        of it along ``dim``."""
        return tpc.scatter_to(t, self.comm, "model", dim)

    def combine(self, m, l, acc) -> torch.Tensor:
        """The context-parallel softmax partials of every model rank
        joined in rank order (:func:`parallel.tensor.softmax_combine`)."""
        return tpc.softmax_combine(m, l, acc, self.comm, "model")

    # -- serving: the decode state and the logits ---------------------------

    def ring_layout(self, length: int) -> str:
        """The layout of a state's KV rings of ring length ``length``
        (:func:`ring_layout` over this mesh's ``model`` axis)."""
        return ring_layout(self.cfg, ring_slots(length), self.tp)

    def _ring_dim(self, length: int):
        """The dim of a KV leaf ``(A, B, slots, KV, Dh)`` placed on
        ``model``, or None (replicated)."""
        return {"kv_heads": 3, "slots": 2}.get(self.ring_layout(length))

    def _leaf_dim(self, name: str, ndim: int, length: int):
        """The dim of the ``ndim``-dim state leaf ``name`` (ring length
        ``length``) placed on ``model``, or None: a KV ring's
        (:meth:`_ring_dim`), or a recurrent leaf's last dim (the
        reference's ``cache_shardings`` places it where it divides, and
        :func:`place_model` holds ``d_in``, ``ssm_state`` and the RG-LRU
        width to dividing)."""
        if name in ("k", "v"):
            return self._ring_dim(length)
        return ndim - 1

    def serving(self, length: int) -> "Placement":
        """This placement as a serving step reads it, for a state of ring
        length ``length``: one position a call, so the residual stream is
        whole on every model rank (no sequence parallelism), and the ring's
        layout (``ring``) with this rank's slab of the slots (``slab_start``
        and ``slab``; the whole ring unless ``ring == "slots"``).  On a
        ``model`` axis of 1 the one rank's slab is the whole ring, so its
        step attends as the unplaced step does, op for op (``ring`` is
        ``"replicated"`` there): a placed model's containers are then the
        whole model's, byte for byte.  A placement made with
        ``slots_at_one`` keeps the ``slots`` step there instead."""
        step = self.whole_stream()
        step.ring = self.ring_layout(length)
        if step.ring == "slots" and self.tp == 1 and not self.slots_at_one:
            step.ring = "replicated"
        n = ring_slots(length)
        step.slab = n // self.tp if step.ring == "slots" else n
        step.slab_start = self.tp_rank * step.slab if step.ring == "slots" \
            else 0
        return step

    def state_shape(self, name: str, shape: tuple, length: int) -> tuple:
        """The rank's shape of the whole state leaf ``name`` of ``shape``
        (rows on dim 1) and ring length ``length``: its data slab of the
        rows and its part of the leaf's dim on ``model``
        (:meth:`_leaf_dim`)."""
        out = list(shape)
        out[1] //= self._slab(out[1])[1]
        dim = self._leaf_dim(name, len(shape), length)
        if dim is not None:
            out[dim] //= self.tp
        return tuple(out)

    def place_state(self, state: ModelState) -> ModelState:
        """This rank's shards of a whole decode ``state`` (a copy): its
        data slab of the rows and, on the KV rings, its kv heads or its
        slab of the slots (:meth:`ring_layout`), on a recurrent leaf its
        slab of the last dim (:meth:`_leaf_dim`)."""
        def local(name, t):
            dim = self._leaf_dim(name, t.ndim, state.length)
            t = self.rows(t, 1)
            if dim is not None:
                n = t.shape[dim] // self.tp
                t = t.narrow(dim, self.tp_rank * n, n)
            return t.clone()

        return _state_map(state, local)

    def unplace_state(self, state: ModelState,
                      rows: int | None = None) -> ModelState:
        """The whole decode state of ``rows`` global rows back from every
        rank's shards (:meth:`place_state`'s inverse, bitwise):
        all-gathered over ``model`` on the leaf's placed dim, then over
        the batch axes its rows lie on (:meth:`whole_rows`).  ``rows``
        None: the rows split over every batch axis."""
        def whole(name, t):
            dim = self._leaf_dim(name, t.ndim, state.length)
            if dim is not None and self.tp > 1:
                t = self.comm.all_gather(t, "model", dim)
            return self.whole_rows(t, t.shape[1] * self.dp
                                   if rows is None else rows, 1)

        return _state_map(state, whole)

    def whole_vocab(self, lg: torch.Tensor) -> torch.Tensor:
        """A serving step's logits, this rank's vocabulary slab ``(...,
        Vpad / tp)`` from ``vocab_start``, gathered into whole rows
        ``(..., Vpad)`` over ``model`` in rank order: every rank gets the
        same bits (a gather moves bits, it sums nothing), as a caller that
        prices symbols needs."""
        if self.tp == 1:
            return lg
        return self.comm.all_gather(lg, "model", lg.ndim - 1)

    # -- parameters and gradients -----------------------------------------

    def gather(self, p: torch.Tensor, name: str) -> torch.Tensor:
        """Parameter ``name``'s FSDP shards gathered over ``data``."""
        for d, entry in enumerate(self.specs[name]):
            if "data" in spec_axes(entry):
                p = tpc.gather_from(p, self.comm, "data", d)
        return p

    def gathered(self, module: nn.Module, prefix: str):
        """``module``'s parameters gathered over ``data``, as attributes
        of nested namespaces (``.attn.wq``, ``.ffn.wo``, ``.ln1``)."""
        root = SimpleNamespace()
        for name, p in module.named_parameters():
            *path, leaf = name.split(".")
            node = root
            for key in path:
                if not hasattr(node, key):
                    setattr(node, key, SimpleNamespace())
                node = getattr(node, key)
            setattr(node, leaf, self.gather(p, f"{prefix}.{name}"))
        return root

    def reduce_grads(self, grads: dict) -> dict:
        """Each gradient summed over the batch axes it is not placed on
        (those it is placed on were reduce-scattered by its FSDP gather's
        backward) and, once, over ``model`` where it is each rank's part;
        one all-reduce per set of axes, of the flattened gradients."""
        buckets: dict = {}
        for k, g in grads.items():
            placed = _placed_axes(self.specs[k])
            axes = tuple(a for a in self.batch_axes if a not in placed)
            if k in self.partial:
                axes += ("model",)
            if any(self.comm.size(a) > 1 for a in axes):
                buckets.setdefault((axes, g.dtype), []).append(k)
        out = dict(grads)
        for (axes, _), names in buckets.items():
            flat = tpc.all_reduce(torch.cat([grads[k].reshape(-1)
                                             for k in names]),
                                  self.comm, axes)
            for k, part in zip(names, flat.split(
                    [grads[k].numel() for k in names])):
                out[k] = part.view_as(grads[k])
        return out

    def batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the data slabs of a per-slab mean ``t`` (the loss,
        or the MoE load-balance loss's expert shares), differentiable: an
        all-reduce over the batch axes forward and backward, so that each
        slab's gradient holds every rank's share of the one global term
        (the reference's means span the ``data`` axis)."""
        if self.dp == 1:
            return t
        for a in self.batch_axes:
            t = tpc.reduce_from(tpc.copy_to(t, self.comm, a), self.comm, a)
        return t / self.dp

    def sum_squares(self, sq: dict) -> torch.Tensor:
        """The global sum of per-shard sums of squares ``sq`` (by name):
        each distinct entry of the mesh counted once, by summing every
        parameter over the axes it is placed on and no other."""
        groups: dict = {}
        for k, v in sq.items():
            axes = tuple(a for a in self.comm.axis_names
                         if a in _placed_axes(self.specs[k]))
            groups.setdefault(axes, []).append(v)
        return sum(tpc.all_reduce(torch.sum(torch.stack(vs)), self.comm,
                                  axes)
                   for axes, vs in sorted(groups.items()))


def place_model(model: LM, mesh, *, fsdp: bool = True,
                slots_at_one: bool = False) -> LM:
    """Rank-local copy of the whole ``model`` placed for compute on
    ``mesh``, a ``DeviceMesh`` with ``data`` and ``model`` axes (and
    optionally ``pod``): an :class:`LM` whose parameters are this rank's
    shards (:func:`shard_params` at its coordinates) and whose
    ``placement`` (:class:`Placement`) its forward, ``loss_fn`` and
    ``make_train_step(cfg, device_mesh=mesh)`` read.  Every rank calls it
    with the same whole model (``unshard`` gives the whole tensors back).

    The placed model trains (``loss_fn``, the train step), prefills
    (``forward``) and serves: ``init_state`` allocates the rank's shards of
    the decode state (:meth:`Placement.state_shape`), and ``decode_step``
    and ``prefill_chunk`` take the global batch, run the rank's rows and
    return the rank's ``(rows / dp, Vpad / tp)`` logits
    (:meth:`Placement.whole_vocab` and :meth:`Placement.whole_rows` gather
    every rank's).

    A ``moe`` model places its experts by the reference's rule
    (:func:`logical_rules` of ``cfg.tp``): over ``model`` when ``cfg.tp``
    divides ``n_experts`` (expert parallelism), else each expert's
    ``d_ff`` columns (per-expert tensor parallelism).  An ``ssm`` or
    ``hybrid`` model places its SSM channels, SSM state and RG-LRU
    channels over ``model`` (``ssm_inner`` and ``ssm_state``), its
    recurrent state leaves by their last dim.  A ``vlm`` or ``audio``
    model places its cross attention's and its encoder's heads by the
    same rules as self attention's (the reference's ``make_attn_defs(cfg,
    cross=True)``): the memory, whole along M on every model rank, feeds
    the rank's kv heads, and the encoder's residual stream is whole along
    M (``models.transformer.encode_memory``).

    On a ``model`` axis of 1 a ``slots`` ring's one slab is the whole
    ring, and the serving steps attend it as the unplaced steps do, op for
    op (:meth:`Placement.serving`), so their containers are the whole
    model's.  ``slots_at_one`` keeps the context-parallel step there (the
    masked slab write, the slab's softmax partials, the combine over
    ``model``): the only way one card runs that path, its logits within
    rounding of the whole model's, not bitwise.

    A ``model`` size that does not divide the padded query heads, the
    padded vocabulary, ``d_ff`` (where ``mlp`` is placed on ``model``),
    ``n_experts`` (under expert parallelism), (when ``cfg.kv_sharded``)
    the kv heads, the SSM's ``d_in`` or ``ssm_state`` or the RG-LRU
    width, or a ``data`` size that does not divide ``d_model`` under
    FSDP, raises a ``ValueError`` naming the dim, as JAX does."""
    cfg = model.cfg
    if model.placement is not None:
        raise ValueError("the model is placed already: place the whole "
                         "model")
    comm = tpc.comm_of(mesh)
    if not {"data", "model"} <= set(comm.axis_names):
        raise ValueError(f"a compute placement needs a mesh with 'data' and "
                         f"'model' axes; this one has {comm.axis_names}")
    pspec = cfg.act_pspec
    if pspec is not None and len(pspec) > 2 and pspec[2] is not None:
        raise NotImplementedError(f"act_pspec {pspec}: only the batch and "
                                  "sequence of the residuals are placed")
    tp, dp = comm.size("model"), comm.size("data")
    dims = {"n_heads_padded": cfg.n_heads_padded,
            "vocab_padded": cfg.vocab_padded}
    rules = logical_rules(cfg)
    if rules["mlp"] == "model":
        dims["d_ff"] = cfg.d_ff
    if "ssm" in model.kinds:
        d_in, _, groups = ssm_dims(cfg)
        dims["d_in (ssm_expand * d_model)"] = d_in
        dims["ssm_state (groups * ssm_state)"] = groups * cfg.ssm_state
    if "rec" in model.kinds:
        dims["lru_width"] = rglru_width(cfg)
    if rules["experts"] == "model":
        dims["n_experts"] = cfg.n_experts
    if cfg.kv_sharded:
        dims["n_kv_heads"] = cfg.n_kv_heads
    for name, n in dims.items():
        if n % tp:
            raise ValueError(f"{cfg.name}: {name} = {n} does not divide "
                             f"over the mesh's model axis of {tp}")
    if fsdp and cfg.d_model % dp:
        raise ValueError(f"{cfg.name}: d_model = {cfg.d_model} does not "
                         f"divide over the mesh's data axis of {dp}")
    specs = param_specs(model, comm, fsdp=fsdp)
    local = shard_params({k: p.detach() for k, p in
                          model.named_parameters()}, specs, comm)
    with torch.device("meta"):
        placed = LM(cfg)
    for name, t in local.items():
        prefix, _, leaf = name.rpartition(".")
        mod = placed.get_submodule(prefix) if prefix else placed
        setattr(mod, leaf, nn.Parameter(t.clone()))
    placed.placement = Placement(cfg, mesh, specs, model.embedding.device,
                                 slots_at_one=slots_at_one)
    return placed
