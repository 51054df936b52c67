"""The model-state protocol surface ``serve/`` drives.

Port of ``repro.models.protocol``: serving code calls :func:`init_state`,
:func:`decode_step` and :func:`prefill_chunk` and never touches an
architecture module, and :func:`state_spec` classifies a config's serving
state (KV ring or recurrent leaves) for the batching engine's geometry
(:func:`ring_length`, :func:`wrap_length`, :func:`can_prefill`).  Every
family of the reference (``dense``, ``moe``, ``ssm``, ``hybrid``,
``vlm``, ``audio``) runs through the pattern/stage model
:class:`~repro_torch.models.transformer.LM`; another family raises a
named ``KeyError``.  ``moe`` is a ring family (mixtral's ring is its
``sliding_window``) with a prefill.  ``vlm`` advertises a prefill, but
its configs hold ``cross`` blocks, so ``can_prefill`` is False for them;
``audio`` (the encoder-decoder) has none.  Both step with ``memory=``:
the ``vlm`` caller's patch embeddings, or the ``audio`` caller's
``encode_memory`` output.  :func:`recurrent_state_tree` marks a
state's recurrent leaves (the reference's path classification).
A ``dense`` model placed for compute (``parallel/sharding.place_model``)
passes through the same three calls: its state is the rank's shard and
its logits the rank's vocabulary slab (``LM.decode_step``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import FAMILIES, LM, ModelState


class PrefillUnsupportedError(RuntimeError):
    """The family's state is sequential: no block-parallel prefill.

    Raised when a caller asks for ``prefill_chunk`` on a config whose
    pattern holds a recurrent, cross or encoder-decoder kind: the only
    bit-exact program there is the sequential ``decode_step`` scan.  The
    engine's ``prefill="auto"`` steps down silently; ``prefill="force"``
    surfaces this error.
    """


# layer kinds whose per-block state is a position-addressed KV ring vs a
# position-free recurrence ("cross" caches nothing)
_RING_KINDS = ("attn", "attn_moe", "dec")
_RECURRENT_KINDS = ("ssm", "rec")


class StateSpec(NamedTuple):
    """Static classification of a config's serving state.

    ``kinds``       — deduped layer kinds, stage order.
    ``ring``        — any position-addressed KV-ring leaves.
    ``recurrent``   — any position-free recurrent leaves (ssm/rec).
    ``ring_window`` — 0: no ring at all; > 0: the ring is bounded at this
                      window whatever the stream length; -1: unbounded
                      full attention (the ring is ``max_len`` and wrapping
                      it changes the conditioning).
    """
    kinds: tuple[str, ...]
    ring: bool
    recurrent: bool
    ring_window: int


def state_spec(cfg: ModelConfig) -> StateSpec:
    kinds = tuple(dict.fromkeys(k for pat, _ in cfg.stages for k in pat))
    ring = any(k in _RING_KINDS for k in kinds)
    recurrent = any(k in _RECURRENT_KINDS for k in kinds)
    if not ring:
        window = 0
    else:
        window = cfg.window or -1
    return StateSpec(kinds=kinds, ring=ring, recurrent=recurrent,
                     ring_window=window)


def ring_length(cfg: ModelConfig, max_len: int) -> int:
    """Ring slots a serving loop must reason about: ``min(max_len,
    window)`` for a windowed config, ``max_len`` otherwise."""
    spec = state_spec(cfg)
    if spec.ring_window > 0:
        return min(max_len, spec.ring_window)
    return max_len


def wrap_length(cfg: ModelConfig, max_len: int) -> int | None:
    """Stream length above which serving at ``max_len`` diverges from the
    single-request path (the ring wraps a shorter-than-native window), or
    ``None`` when no length does: no ring, or a bounded window with
    ``max_len >= window``; otherwise ``max_len``."""
    spec = state_spec(cfg)
    if not spec.ring:
        return None
    if spec.ring_window > 0:
        return None if max_len >= spec.ring_window else max_len
    return max_len


def _kinds_prefill(cfg: ModelConfig) -> bool:
    """Every block is a self-attention kind (no sequential state)."""
    return not cfg.is_encdec and all(
        kind in ("attn", "attn_moe")
        for pat, _reps in cfg.stages for kind in pat)


class ModelProtocol(NamedTuple):
    """One family's serving entry points (``prefill_chunk`` optional)."""
    family: str
    init_state: Callable
    decode_step: Callable
    prefill_chunk: Callable | None
    state_spec: Callable[[ModelConfig], StateSpec]


def _init_state(model: LM, batch: int, max_len: int) -> ModelState:
    return model.init_state(batch, max_len)


def _decode_step(model: LM, state, token, pos, memory=None):
    return model.decode_step(state, token, pos, memory)


def _prefill_chunk(model: LM, state, tokens, pos0, n_valid):
    return model.prefill_chunk(state, tokens, pos0, n_valid)


def _shared(family: str, prefillable: bool) -> ModelProtocol:
    return ModelProtocol(family, _init_state, _decode_step,
                         _prefill_chunk if prefillable else None,
                         state_spec)


# every family composes the shared assembler; the recurrent ones and the
# encoder-decoder have no block-parallel prefill (a vlm config with cross
# layers steps down through can_prefill)
FAMILY_PROTOCOLS: dict[str, ModelProtocol] = {
    "dense": _shared("dense", prefillable=True),
    "moe": _shared("moe", prefillable=True),
    "vlm": _shared("vlm", prefillable=True),
    "audio": _shared("audio", prefillable=False),
    "ssm": _shared("ssm", prefillable=False),
    "hybrid": _shared("hybrid", prefillable=False),
}


def get_protocol(cfg: ModelConfig) -> ModelProtocol:
    try:
        return FAMILY_PROTOCOLS[cfg.family]
    except KeyError:
        raise KeyError(
            f"no model protocol for family {cfg.family!r} (config "
            f"{cfg.name!r}): families are {FAMILIES}") from None


def can_prefill(cfg: ModelConfig) -> bool:
    """True when the teacher-forced chunk is bitwise the step scan for this
    config (all-self-attention patterns of a family with a prefill)."""
    return (get_protocol(cfg).prefill_chunk is not None
            and _kinds_prefill(cfg))


# ---------------------------------------------------------------------------
# the dispatching surface (what serve/ imports)
# ---------------------------------------------------------------------------

def init_state(model, batch: int, max_len: int) -> ModelState:
    """All-zero serving state for ``batch`` rows and a ``max_len`` ring."""
    return get_protocol(model.cfg).init_state(model, batch, max_len)


def decode_step(model, state: ModelState, token, pos, memory=None):
    """One serving step: token (B,1) -> logits (B, Vpad); state in place.
    ``pos`` is an int or a ``(B,)`` int64 device tensor; ``memory``
    (B,M,D) what the ``cross``/``dec`` blocks attend."""
    return get_protocol(model.cfg).decode_step(model, state, token, pos,
                                               memory)


def prefill_chunk(model, state: ModelState, tokens, pos0, n_valid):
    """Teacher-forced chunk (B,S) -> logits (B,S,Vpad); named error when
    the config cannot prefill bitwise."""
    cfg = model.cfg
    if not can_prefill(cfg):
        raise PrefillUnsupportedError(
            f"config {cfg.name!r} (family {cfg.family!r}, kinds "
            f"{state_spec(cfg).kinds}) carries sequential state: "
            "prefill_chunk would not be bitwise the decode_step scan; run "
            "the sequential step program instead")
    return get_protocol(cfg).prefill_chunk(model, state, tokens, pos0,
                                           n_valid)


def recurrent_state_tree(state: ModelState) -> dict[str, bool]:
    """Each state leaf's name -> True on recurrent leaves (``ssm.*``,
    ``rec.*``: position-free, changed by every step), False on the KV
    rings (position-addressed)."""
    return {name: name.split(".")[0] in _RECURRENT_KINDS
            for name in state.leaves()}


def has_recurrent_state(state: ModelState) -> bool:
    return any(recurrent_state_tree(state).values())
