"""Language models as an ``nn.Module``: the layer-kind pattern/stage
assembly (with cross attention and an encoder), its serving direction and
the training forward.

Port of ``repro.models.transformer``.  A model is a sequence of stages,
each a layer-kind pattern repeated ``reps`` times (``cfg.stages``; a tail
partial pattern is its own stage), laid out here as one list of blocks in
depth order.  Layer kinds:

    attn      RoPE grouped-query self-attention + gated SiLU MLP (dense;
              the hybrid's local-window attention)
    attn_moe  the same attention + the top-k MoE FFN   (mixtral, phi3.5)
    ssm       Mamba2 SSD mixer, no FFN                 (mamba2)
    rec       RG-LRU recurrent block + gated MLP       (recurrentgemma)
    cross     cross attention over the memory + MLP    (llama-3.2-vision)
    dec       self-attention + cross attention + MLP   (seamless decoder)

A final RMSNorm and the logits over the padded vocabulary (tied to the
embedding, or through ``lm_head`` when ``cfg.tie_embeddings`` is false)
close the model.  Weight layouts match the reference (``wq (d, Hp,
Dh)``, ``wo (Hp, Dh, d)``, ``wi_gate (d, ff)``, the experts' ``(E, d,
ff)``, the SSM's and RG-LRU's leaves), so ``models.convert`` copies a JAX
parameter tree over unchanged.

The ``cross`` and ``dec`` kinds read a memory (B, M, D) in the model's
dtype: the ``vlm`` family's precomputed patch embeddings, or the
``audio`` family's encoder output (:func:`encode_memory`: ``encoder_layers``
blocks of bidirectional self-attention without RoPE, the reference's
cross attention of a sequence against itself, and their final norm).
``forward``, ``decode_step`` and ``loss_fn`` take it as ``memory``
(``forward`` and ``loss_fn`` also as ``enc_inputs``, encoded first).  A
model with such blocks raises a named ``ValueError`` when it runs without
a memory, or with one of another dtype, batch or width; the reference
runs a ``cross`` block without memory as causal self-attention over its
cross weights (ROADMAP C).  Cross attention keeps no state: each decode
step projects the memory's K and V anew, as the reference does.

Serving runs one token at a time through :meth:`LM.decode_step` against a
:class:`ModelState`, which the step updates in place: the attention
blocks' KV rings and the recurrent blocks' ``(conv, h)`` leaves.  A
teacher-forced chunk of positions runs through :meth:`LM.prefill_chunk`
(all-attention patterns only), bitwise the same steps: the MoE FFN runs
per position at the step's shapes (:func:`~repro_torch.models.moe.
moe_step`), so no token of a chunk is dropped, where the reference's
capacity dispatch over the chunk drops some.  Training runs
:meth:`LM.forward` over whole sequences (the MoE FFN through the
configured capacity or dense schedule, the recurrent kinds through their
sequence scans) and :func:`loss_fn`.  As in the reference, training
attention masks by ``cfg.sliding_window`` only: the hybrid's attention
blocks train with full causal attention and serve through their
``local_window`` ring, so its ``forward`` is not its own step scan past
the window.  Under ``cfg.remat`` (the reference's default), while
autograd records, the forward runs each repetition of a stage's pattern
(:attr:`LM.units`) and each encoder block as one checkpointed unit
(:func:`remat`): backward keeps each unit's input, runs the unit again
and reads the tensors it saves then.  The graph is the same, and so are
the loss and every gradient, bit for bit; decoding and ``prefill_chunk``
record no graph and never checkpoint.

A model of any family placed for compute on a ``(data, model)`` mesh
(``parallel/sharding.place_model``: its parameters are one rank's
shards, :attr:`LM.placement` set) trains and prefills on its rank's
share: the forward takes the rank's rows (of the tokens and of the
memory or encoder inputs), each checkpointed unit gathers its blocks'
FSDP shards over ``data`` (:meth:`LM.unit_forward`, one body with the
unplaced forward), the attention (self and cross), the SSM and RG-LRU
mixers (``models/ssm.py``, ``models/rglru.py``: the rank's channels) and
the MLP run column- then row-parallel over ``model``, the MoE FFN on the
rank's experts (expert parallelism) or on every expert's columns
(per-expert tensor parallelism) after routing the whole sequence alike
on every model rank (``models/moe.py``), the residuals follow
``cfg.act_pspec`` and the logits and the loss are vocabulary-parallel;
the aux loss is the reference's global one, its expert shares averaged
over the data slabs.  Cross attention's queries are the rank's heads of
the residual stream, its K/V the rank's kv heads of the memory, which is
whole along M on every model rank (the encoder's residuals too:
:func:`encode_memory`).  It serves the same way: :meth:`LM.init_state`
allocates the rank's shards of the state (its rows, its kv heads or
its slab of the ring's slots, ``sharding.ring_layout``, and its slab of
each recurrent leaf's last dim), and
:meth:`LM.decode_step` and :meth:`LM.prefill_chunk` take the global
batch (and memory), run the rank's rows at one position a call (the
residual stream whole on every model rank; the MoE step on the rank's
experts or columns), gather each block's FSDP shards over ``data`` and
return the rank's ``(rows / dp, Vpad / tp)`` logits.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.attention import (Attention, attn_cross,
                                         attn_decode, attn_forward,
                                         attn_prefill, ring_slots)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (chunked_xent_loss, embed, logits, mlp,
                                       rmsnorm, xent_loss)
from repro_torch.models.moe import MoE, moe, moe_step
from repro_torch.models.rglru import (RGLRU, init_rglru_cache,
                                      rglru_decode_step, rglru_forward)
from repro_torch.models.ssm import (SSM, init_ssm_cache, ssm_decode_step,
                                    ssm_forward)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# the state each layer kind keeps: a KV ring ("attn"), recurrent leaves,
# or none (``cross`` reads the memory)
_STATE = {"attn": "attn", "attn_moe": "attn", "dec": "attn", "ssm": "ssm",
          "rec": "rec", "cross": None}
KINDS = tuple(_STATE)


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """The config's parameter and activation type."""
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype {cfg.dtype!r} is not ported (float32 or "
                         "bfloat16)")
    return getattr(torch, cfg.dtype)


@dataclass
class ModelState:
    """The serving state, every leaf with the rows on axis 1.

    ``k``/``v``: the attention blocks' KV rings (A, B, Rp, KV, Dh) in depth
    order, with the slot axis padded to whole attention tiles (None when
    the pattern has no attention); ``length`` is the ring length.
    ``recurrent``: the recurrent blocks' leaves by ``"<kind>.<leaf>"``
    (``ssm.conv``, ``ssm.h``, ``rec.conv``, ``rec.h``), each stacked over
    the blocks of its kind in depth order.  The reference classifies its
    state tree's leaves by path the same way (``"kv"`` vs ``"ssm"``/
    ``"rec"``)."""

    k: torch.Tensor | None
    v: torch.Tensor | None
    length: int
    recurrent: dict = field(default_factory=dict)

    def leaves(self) -> dict:
        """Every state tensor by name (``k``, ``v``, then the recurrent
        leaves)."""
        ring = {} if self.k is None else {"k": self.k, "v": self.v}
        return {**ring, **self.recurrent}


_NORM = ("embed",)      # an RMSNorm scale's logical axes (make_rmsnorm)


class MLP(nn.Module):
    @staticmethod
    def axes(cfg: ModelConfig) -> dict:
        """Each leaf's logical axes (``make_mlp``)."""
        return {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"),
                "wo": ("mlp", "embed")}

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.wi_gate = nn.Parameter(torch.empty(d, ff))
        self.wi_up = nn.Parameter(torch.empty(d, ff))
        self.wo = nn.Parameter(torch.empty(ff, d))


class Block(nn.Module):
    """An ``attn`` block: self-attention and the gated MLP (``attn_moe``:
    the MoE FFN)."""

    @staticmethod
    def axes(cfg: ModelConfig) -> dict:
        """The norms' logical axes (``make_block_defs``; the submodules
        declare their own)."""
        return {"ln1": _NORM, "ln_cross": _NORM, "ln2": _NORM}

    def __init__(self, cfg: ModelConfig, ffn=MLP):
        super().__init__()
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model))
        self.attn = Attention(cfg)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model))
        self.ffn = ffn(cfg)


class SSMBlock(nn.Module):
    """An ``ssm`` block: the Mamba2 mixer, no FFN."""

    axes = staticmethod(Block.axes)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model))
        self.ssm = SSM(cfg)


class RecBlock(nn.Module):
    """A ``rec`` block: the RG-LRU recurrent block and the gated MLP."""

    axes = staticmethod(Block.axes)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model))
        self.rec = RGLRU(cfg)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model))
        self.ffn = MLP(cfg)


class CrossBlock(nn.Module):
    """A ``cross`` block: cross attention over the memory and the gated
    MLP."""

    axes = staticmethod(Block.axes)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model))
        self.cross = Attention(cfg)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model))
        self.ffn = MLP(cfg)


class DecBlock(nn.Module):
    """A ``dec`` block: self-attention, cross attention over the memory
    (after its own norm ``ln_cross``) and the gated MLP."""

    axes = staticmethod(Block.axes)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model))
        self.attn = Attention(cfg)
        self.ln_cross = nn.Parameter(torch.ones(cfg.d_model))
        self.cross = Attention(cfg)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model))
        self.ffn = MLP(cfg)


class Encoder(nn.Module):
    """The encoder-decoder's encoder: ``encoder_layers`` ``attn`` blocks
    (run bidirectionally by :func:`encode_memory`) and their final norm."""

    @staticmethod
    def axes(cfg: ModelConfig) -> dict:
        return {"final_norm": _NORM}

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.blocks = nn.ModuleList(Block(cfg)
                                    for _ in range(cfg.encoder_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model))


_BLOCKS = {"attn": Block, "attn_moe": lambda cfg: Block(cfg, MoE),
           "ssm": SSMBlock, "rec": RecBlock, "cross": CrossBlock,
           "dec": DecBlock}
# leaves initialised to a constant, by leaf name; every other matrix and
# the RG-LRU's gate weights are normal(0, scale), every other vector 1
_INIT = {**Attention.INIT, **SSM.INIT, **RGLRU.INIT}
_NORMAL_VECTORS = ("gate_a_w", "gate_i_w")


class LM(nn.Module):
    """The reference's families (``dense``, ``moe``, ``ssm``, ``hybrid``,
    ``vlm``, ``audio``): the embedding, the blocks of ``cfg.stages`` in
    depth order, the final norm and (untied) ``lm_head``, and for an
    encoder-decoder the :class:`Encoder`, the parameters in
    ``cfg.dtype``."""

    @staticmethod
    def axes(cfg: ModelConfig) -> dict:
        """The embedding's, head's and final norm's logical axes
        (``make_embedding``)."""
        return {"embedding": ("vocab", "embed"), "lm_head": ("embed", "vocab"),
                "final_norm": _NORM}

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r} (config "
                             f"{cfg.name!r}); families: {FAMILIES}")
        kinds = tuple(k for pat, reps in cfg.stages for _ in range(reps)
                      for k in pat)
        for kind in kinds:
            if kind not in KINDS:
                raise ValueError(f"unknown layer kind {kind!r} of config "
                                 f"{cfg.name!r}; layer kinds: {KINDS}")
        self.cfg = cfg
        self.kinds = kinds
        # (stage, block key, rep) of each block, the reference's tree path
        self.layout = tuple((i, f"b{j}_{kind}", r)
                            for i, (pat, reps) in enumerate(cfg.stages)
                            for r in range(reps)
                            for j, kind in enumerate(pat))
        # each block's index among the blocks keeping its kind of state
        # (its row of the KV rings or of the recurrent leaves)
        states = [_STATE[k] for k in kinds]
        self._index = tuple(states[:i].count(st)
                            for i, st in enumerate(states))
        # the blocks of each repetition of a stage's pattern, in depth
        # order: the reference's checkpointed unit
        units: dict = {}
        for b, (i, _, r) in enumerate(self.layout):
            units.setdefault((i, r), []).append(b)
        self.units = tuple(map(tuple, units.values()))
        self.embedding = nn.Parameter(torch.empty(cfg.vocab_padded,
                                                  cfg.d_model))
        self.blocks = nn.ModuleList(_BLOCKS[k](cfg) for k in kinds)
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model))
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab_padded))
        self.encoder = Encoder(cfg) if cfg.is_encdec else None
        # a rank's parallel.sharding.Placement when its parameters are
        # shards of a compute-placed model (sharding.place_model)
        self.placement = None

    def _vocab(self, pl):
        """``(embedding, lm_head)`` as the logits read them: placed (``pl``),
        the vocabulary shards gathered over ``data``."""
        if pl is None:
            return self.embedding, self.lm_head
        head = None if self.lm_head is None else pl.gather(self.lm_head,
                                                            "lm_head")
        return pl.gather(self.embedding, "embedding"), head

    def _head(self, x: torch.Tensor):
        """``(embedding, lm_head, x)`` as the logits read them: placed, the
        vocabulary shards gathered over ``data`` and the whole sequence of
        ``x`` on every model rank."""
        pl = self.placement
        return *self._vocab(pl), (x if pl is None else pl.enter(x))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Logits over the padded vocabulary (placed: this rank's shard,
        (B, S, Vpad / tp), of the whole sequence)."""
        emb, head, x = self._head(x)
        return logits(emb, x, head)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         scale: float = 0.02) -> "LM":
        """Seeded init, the reference's rule (its random bits differ):
        normal(0, scale) matrices (the experts' and the router's, the
        untied head), embeddings and RG-LRU gate weights, the reference's
        constants for the SSM's and RG-LRU's biases and scales, unit norm
        scales; padded query heads are zero.  Each draw is float32 from
        ``generator``, on its device, then rounded into the parameter."""
        cfg = self.cfg
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _INIT:
                p.fill_(_INIT[leaf])
            elif p.ndim == 1 and leaf not in _NORMAL_VECTORS:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device) * scale)
        for m in self.modules():
            if isinstance(m, Attention):
                m.wq[:, cfg.n_heads:] = 0.0
                m.wo[cfg.n_heads:] = 0.0
        return self

    def _memory(self, memory, rows: int):
        """``memory`` checked against what the model's ``cross``/``dec``
        blocks read: None for a model without them (the reference ignores
        a memory there), else a (rows, M, D) tensor in the model's
        dtype."""
        if not {"cross", "dec"} & set(self.kinds):
            return None
        cfg, dt = self.cfg, self.embedding.dtype
        if memory is None:
            raise ValueError(
                f"config {cfg.name!r} has cross-attention blocks: pass "
                "memory= (for an encoder-decoder, encode_memory's output, "
                "or enc_inputs= to forward)")
        if memory.dtype != dt:
            raise ValueError(f"memory is {memory.dtype}, the model "
                             f"{cfg.name!r} is {dt}: cast it first")
        if (memory.ndim != 3 or memory.shape[0] != rows
                or memory.shape[2] != cfg.d_model):
            raise ValueError(f"memory of shape {tuple(memory.shape)} does "
                             f"not fit ({rows}, M, {cfg.d_model})")
        return memory

    def forward(self, tokens: torch.Tensor,
                memory: torch.Tensor | None = None,
                enc_inputs: torch.Tensor | None = None):
        """tokens (B,S) -> (final-normed hidden states (B,S,D), aux loss):
        the sum of the MoE blocks' load-balance losses (0.0 without
        one).  ``memory`` (B,M,D) feeds the ``cross``/``dec`` blocks; an
        encoder-decoder given ``enc_inputs`` (B,M,D) encodes them into the
        memory first (:func:`encode_memory`).  Under ``cfg.remat``, while
        autograd records, each of :attr:`units` runs checkpointed
        (:func:`remat`).

        A placed model (:attr:`placement`) takes its rank's rows of the
        batch (``placement.rows`` of the tokens and of ``memory`` or
        ``enc_inputs``) and returns the residual stream as it
        lies on the rank: (B/dp, S/tp, D) under sequence parallelism,
        else (B/dp, S, D)."""
        cfg, pl = self.cfg, self.placement
        if cfg.is_encdec and enc_inputs is not None:
            memory = encode_memory(self, enc_inputs)
        if pl is None:
            x = embed(self.embedding, tokens)
            final_norm = self.final_norm
        else:
            x = embed(pl.gather(self.embedding, "embedding"), tokens, pl)
            final_norm = pl.gather(self.final_norm, "final_norm")
        memory = self._memory(memory, x.shape[0])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for unit in self.units:
            x, a = remat(cfg, self.unit_forward, unit, x, memory)
            aux = aux + a
        return rmsnorm(final_norm, x, cfg.norm_eps), aux

    def unit_forward(self, unit: tuple, x: torch.Tensor,
                     memory: torch.Tensor | None = None):
        """The blocks ``unit`` (indices into :attr:`blocks`, one of
        :attr:`units`) over x (B,S,D) -> (x, the unit's summed aux loss),
        the reference's ``stage_forward`` unit.

        Placed (:attr:`placement`), each block's FSDP shards are gathered
        over ``data`` here, inside the checkpointed unit (so that backward
        gathers them again), the norms run on the residual stream as it
        lies and the attention (self and cross), SSM and RG-LRU mixers,
        MLP and MoE FFN on this rank's heads, channels, columns and
        experts (each mixer enters the whole sequence and leaves as the
        stream lies; the memory enters whole, ``Placement.enter_memory``);
        the aux loss is the same on every rank."""
        cfg, pl = self.cfg, self.placement
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        with contextlib.nullcontext() if pl is None else pl.body():
            for b in unit:
                kind, w = self.kinds[b], self._block(b, pl)
                h = rmsnorm(w.ln1, x, cfg.norm_eps)
                if kind == "ssm":
                    x = x + ssm_forward(w.ssm, h, cfg, place=pl)
                    continue
                if kind == "rec":
                    x = x + rglru_forward(w.rec, h, cfg, place=pl)
                elif kind == "cross":
                    x = x + attn_forward(w.cross, h, cfg, mem=memory,
                                         place=pl)
                else:
                    x = x + attn_forward(w.attn, h, cfg, place=pl)
                if kind == "dec":
                    h = rmsnorm(w.ln_cross, x, cfg.norm_eps)
                    x = x + attn_forward(w.cross, h, cfg, mem=memory,
                                         place=pl)
                h = rmsnorm(w.ln2, x, cfg.norm_eps)
                f = w.ffn
                if kind == "attn_moe":
                    h, a = moe(f, h, cfg, place=pl)
                    aux = aux + a
                else:
                    h = mlp(f.wi_gate, f.wi_up, f.wo, h, place=pl)
                x = x + h
        return x, aux

    def init_state(self, batch: int, max_len: int) -> ModelState:
        """All-zero state for ``batch`` rows: KV rings of ``min(max_len,
        window)`` slots (``max_len`` without a window) and the recurrent
        blocks' leaves.  A placed model allocates the rank's shards of the
        state of ``batch`` global rows (``Placement.state_shape``)."""
        cfg, pl = self.cfg, self.placement
        p = self.embedding
        win = cfg.window
        ring = min(max_len, win) if win else max_len
        k = v = None
        n = sum(_STATE[kind] == "attn" for kind in self.kinds)
        if n:
            shape = (n, batch, ring_slots(ring), cfg.n_kv_heads,
                     cfg.head_dim_)
            if pl is not None:
                shape = pl.state_shape("k", shape, ring)
            k, v = (torch.zeros(shape, dtype=p.dtype, device=p.device)
                    for _ in range(2))
        recurrent = {}
        for kind, init in (("ssm", init_ssm_cache), ("rec", init_rglru_cache)):
            n = self.kinds.count(kind)
            if not n:
                continue
            leaves = init(cfg, batch, p.dtype,
                          p.device if pl is None else "meta", layers=n)
            if pl is not None:
                leaves = {leaf: torch.zeros(
                    pl.state_shape(f"{kind}.{leaf}", t.shape, ring),
                    dtype=t.dtype, device=p.device)
                    for leaf, t in leaves.items()}
            recurrent.update({f"{kind}.{leaf}": t
                              for leaf, t in leaves.items()})
        return ModelState(k=k, v=v, length=ring, recurrent=recurrent)

    def _serving(self, state: ModelState):
        """The placement as the serving steps read it for ``state``
        (``Placement.serving``), or None unplaced."""
        pl = self.placement
        return None if pl is None else pl.serving(state.length)

    def _serving_weights(self, pl):
        """``(embedding, lm_head, final_norm)`` as a serving step reads
        them: placed, gathered over ``data``."""
        if pl is None:
            return self.embedding, self.lm_head, self.final_norm
        return *self._vocab(pl), pl.gather(self.final_norm, "final_norm")

    def _block(self, b: int, pl):
        """Block ``b``'s parameters: placed, its FSDP shards gathered over
        ``data``."""
        blk = self.blocks[b]
        return blk if pl is None else pl.gathered(blk, f"blocks.{b}")

    def _step(self, state: ModelState, token, pos, memory=None,
              pl=None) -> torch.Tensor:
        """The step of ``token`` against ``state`` (updated in place), its
        rows' ``memory``; placed (``pl``, :meth:`_serving`), on the rank's
        shards."""
        cfg, st, length = self.cfg, state.leaves(), state.length
        emb, head, final_norm = self._serving_weights(pl)
        x = embed(emb, token, pl)
        for b, (kind, i) in enumerate(zip(self.kinds, self._index)):
            blk = self._block(b, pl)
            h = rmsnorm(blk.ln1, x, cfg.norm_eps)
            if kind == "ssm":
                x = x + ssm_decode_step(blk.ssm, h, {
                    "conv": st["ssm.conv"][i], "h": st["ssm.h"][i]}, cfg,
                    place=pl)
                continue
            if kind == "rec":
                x = x + rglru_decode_step(blk.rec, h, {
                    "conv": st["rec.conv"][i], "h": st["rec.h"][i]}, cfg,
                    place=pl)
            elif kind == "cross":
                x = x + attn_cross(blk.cross, h, memory, cfg, place=pl)
            else:
                x = x + attn_decode(blk.attn, h, st["k"][i], st["v"][i],
                                    length, pos, cfg, place=pl)
            if kind == "dec":
                x = x + attn_cross(blk.cross,
                                   rmsnorm(blk.ln_cross, x, cfg.norm_eps),
                                   memory, cfg, place=pl)
            x = x + self._ffn(kind, blk, x, pl)
        x = rmsnorm(final_norm, x, cfg.norm_eps)
        return logits(emb, x, head)[:, 0]

    def _ffn(self, kind: str, blk, x1: torch.Tensor,
             pl=None) -> torch.Tensor:
        """A block's FFN on one position (B,1,D): the gated MLP, or the
        MoE FFN in its fixed-shape step form (placed, on the rank's
        columns or experts)."""
        h = rmsnorm(blk.ln2, x1, self.cfg.norm_eps)
        if kind == "attn_moe":
            return moe_step(blk.ffn, h, self.cfg, place=pl)
        f = blk.ffn
        return mlp(f.wi_gate, f.wi_up, f.wo, h, place=pl)

    @torch.no_grad()
    def decode_step(self, state: ModelState, token: torch.Tensor, pos,
                    memory=None) -> torch.Tensor:
        """token (B,1) int -> logits (B, Vpad); ``state`` advances in
        place.  ``pos`` is an int shared by all rows or a ``(B,)`` int64
        device tensor of per-row positions (only attention reads it).
        ``memory`` (B,M,D): what the ``cross``/``dec`` blocks attend
        (required there).

        Placed: ``token``, per-row ``pos`` and ``memory`` are the global
        batch, of which the rank runs its rows (``Placement.rows``) against
        its shards of ``state`` (:meth:`init_state`); the logits are the
        rank's ``(B / dp, Vpad / tp)`` vocabulary slab
        (``Placement.whole_vocab`` gathers whole rows)."""
        pl = self._serving(state)
        if pl is not None:
            token = pl.rows(token)
            if not isinstance(pos, int):
                pos = pl.rows(pos)
            if memory is not None:
                memory = pl.rows(memory)
        memory = self._memory(memory, token.shape[0])
        return self._step(state, token, pos, memory, pl)

    def _prefill(self, state: ModelState, tokens, pos0, n_valid, pl=None):
        """:meth:`prefill_chunk` on the rank's rows: (B,S) -> (B,S,Vpad)."""
        cfg, ck, cv, length = self.cfg, state.k, state.v, state.length
        s_len = tokens.shape[1]
        emb, head, final_norm = self._serving_weights(pl)

        def per_position(fn, xs):
            return torch.stack([fn(xs[t][:, None])[:, 0]
                                for t in range(s_len)])

        xs = embed(emb, tokens.T, pl)                   # (S, B, D)
        for i, kind in enumerate(self.kinds):
            blk = self._block(i, pl)
            hs = [rmsnorm(blk.ln1, xs[t][:, None], cfg.norm_eps)
                  for t in range(s_len)]
            xs = xs + attn_prefill(blk.attn, hs, ck[i], cv[i], length, pos0,
                                   n_valid, cfg, place=pl)
            xs = xs + per_position(
                lambda x1, kind=kind, blk=blk: self._ffn(kind, blk, x1, pl),
                xs)
        return per_position(lambda x1: logits(
            emb, rmsnorm(final_norm, x1, cfg.norm_eps), head),
            xs).transpose(0, 1)

    @torch.no_grad()
    def prefill_chunk(self, state: ModelState, tokens: torch.Tensor,
                      pos0: torch.Tensor,
                      n_valid: torch.Tensor) -> torch.Tensor:
        """Teacher-forced chunk: tokens (B,S) at per-row positions ``pos0 +
        [0, S)`` -> logits (B,S,Vpad), ``state`` updated in place.  Every
        block must be ``attn`` or ``attn_moe`` (the protocol's
        ``can_prefill``).

        Bitwise equal to S :meth:`decode_step` calls at positions ``pos0 +
        min(t, n_valid)`` on every live position (``t < n_valid``) and on
        every ring slot the live steps write, when the chunk stays inside
        the ring (``pos0 + n_valid <= length``).  Rows past ``n_valid``
        write nothing; their logits are not the step path's (the step path
        writes the clamped position's slot, the next chunk's first step
        overwrites it).  Only the embedding, the RoPE and the residual adds
        (elementwise) run over all S positions at once: every norm, GEMM,
        attend and MoE FFN runs per position at the step path's shapes,
        since cuBLAS's GEMMs and PyTorch's row reductions may order a sum
        otherwise at another row count (and a MoE chunk would drop
        tokens).  Placed, as :meth:`decode_step`: the global ``tokens``,
        ``pos0`` and ``n_valid``, the rank's rows, shards and ``(B / dp,
        S, Vpad / tp)`` logits; each position's collectives run at the
        step's sizes, so the chunk is bitwise the placed steps."""
        if not set(self.kinds) <= {"attn", "attn_moe"}:
            raise ValueError(f"prefill_chunk runs attention blocks only; "
                             f"this model has {sorted(set(self.kinds))}")
        pl = self._serving(state)
        if pl is not None:
            tokens, pos0, n_valid = (pl.rows(t) for t in (tokens, pos0,
                                                          n_valid))
        return self._prefill(state, tokens, pos0.to(torch.int64),
                             n_valid.to(torch.int64), pl)


def encode_memory(model: LM, enc_inputs: torch.Tensor) -> torch.Tensor:
    """The encoder over stub frontend embeddings ``enc_inputs`` (B,M,D),
    cast to the model's dtype as the reference casts them: each block's
    self-attention is bidirectional, without RoPE (the reference's cross
    attention of the sequence against itself), then the final norm ->
    the memory (B,M,D).  Under ``cfg.remat``, while autograd records,
    each block runs checkpointed (:func:`remat`).

    Placed, ``enc_inputs`` are the rank's rows and so is the memory,
    whole along M on every model rank (the reference constrains no
    encoder activation): each block runs on the rank's heads and columns
    (:func:`encoder_block`) and the final norm is gathered over
    ``data``."""
    cfg, pl = model.cfg, model.placement
    if model.encoder is None:
        raise ValueError(f"config {cfg.name!r} has no encoder "
                         "(encoder_layers = 0)")
    if enc_inputs.ndim != 3 or enc_inputs.shape[2] != cfg.d_model:
        raise ValueError(f"enc_inputs of shape {tuple(enc_inputs.shape)} "
                         f"do not fit (B, M, {cfg.d_model})")
    x = enc_inputs.to(model.embedding.dtype)
    for i in range(len(model.encoder.blocks)):
        x = remat(cfg, encoder_block, model, i, x)
    norm = model.encoder.final_norm
    if pl is not None:
        norm = pl.gather(norm, "encoder.final_norm")
    return rmsnorm(norm, x, cfg.norm_eps)


def encoder_block(model: LM, i: int, x: torch.Tensor) -> torch.Tensor:
    """Encoder block ``i`` of ``model`` over x (B,M,D): bidirectional
    self-attention without RoPE, then the MLP; the reference's
    checkpointed encoder unit.  Placed, the block's FSDP shards are
    gathered over ``data`` here (inside the checkpointed unit), and the
    attention and MLP run on the rank's heads and columns with the
    residual stream whole along M on every model rank
    (``Placement.whole_stream``)."""
    cfg, pl = model.cfg, model.placement
    blk = model.encoder.blocks[i]
    if pl is not None:
        pl = pl.whole_stream()
    with contextlib.nullcontext() if pl is None else pl.body():
        if pl is not None:
            blk = pl.gathered(blk, f"encoder.blocks.{i}")
        h = rmsnorm(blk.ln1, x, cfg.norm_eps)
        x = x + attn_forward(blk.attn, h, cfg, mem=h, place=pl)
        h = rmsnorm(blk.ln2, x, cfg.norm_eps)
        f = blk.ffn
        return x + mlp(f.wi_gate, f.wi_up, f.wo, h, place=pl)


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``; under ``cfg.remat``, while autograd records, as one
    checkpointed unit, the reference's ``jax.checkpoint``: autograd keeps
    only the arguments for backward and runs ``fn`` again there for the
    tensors its backward reads.  The forward draws no random numbers, so
    the RNG state is not saved, and the recomputation gives the same
    tensors."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def loss_fn(model: LM, batch: dict) -> torch.Tensor:
    """Next-token cross entropy of ``batch`` (``tokens``/``labels`` (B,S)
    tensors on the model's device, and the ``memory`` or ``enc_inputs``
    (B,M,D) of a model that reads one) plus 0.01 x the aux loss.
    ``model.cfg.logits_chunk`` > 0 runs the chunked loss.  A placed model
    takes its rank's rows and gives their mean: the vocabulary-parallel
    cross entropy of the whole sequence, gathered once after the final
    norm under sequence parallelism, plus 0.01 x the global aux loss (the
    same on every rank)."""
    cfg, pl = model.cfg, model.placement
    x, aux = model(batch["tokens"], memory=batch.get("memory"),
                   enc_inputs=batch.get("enc_inputs"))
    emb, head, x = model._head(x)
    if cfg.logits_chunk:
        ce = chunked_xent_loss(emb, x, batch["labels"], cfg.vocab_size,
                               cfg.logits_chunk, head, pl)
    else:
        ce = xent_loss(logits(emb, x, head), batch["labels"],
                       cfg.vocab_size, pl)
    return ce + 0.01 * aux


def init_model(cfg: ModelConfig, seed: int = 0,
               device: torch.device | str | None = None, *,
               draw: str = "cpu") -> LM:
    """Seeded random weights on ``device`` (the card when None), in
    ``cfg.dtype``.

    Two draws, because a seed must give the same model on every device
    for the card-against-CPU checks, and a host draw does not scale:

    * ``draw="cpu"`` (the default) draws in float32 on the CPU, then casts
      and moves: the same weights on every device, so a check builds its
      CPU and card models from the seed alone.
    * ``draw="device"`` draws each parameter in float32 from a generator
      on ``device``, straight into its storage: no float32 host copy, and
      seconds instead of minutes for a full-width MoE model, but on the
      card other bits than the CPU's (a comparison across devices then
      copies the weights with ``load_state_dict``).  On the CPU it gives
      the bits of ``"cpu"``."""
    dev = resolve_device(device)
    if draw == "cpu":
        model = LM(cfg).reset_parameters(torch.Generator().manual_seed(seed))
        return model.to(device=dev, dtype=torch_dtype(cfg))
    if draw != "device":
        raise ValueError(f"unknown draw {draw!r} (expected 'cpu' or "
                         "'device')")
    with torch.device("meta"):
        model = LM(cfg)
    model = model.to(dtype=torch_dtype(cfg)).to_empty(device=dev)
    return model.reset_parameters(
        torch.Generator(device=dev).manual_seed(seed))
