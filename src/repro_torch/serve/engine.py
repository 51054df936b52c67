"""Serving engine: single-stream generation and the batched multi-stream
service.

Port of ``repro.serve.engine``.  Two layers live here:

* the single-stream primitives: ``make_serve_step`` (one new token against
  a ring cache of ``max_len``; a cache shorter than the sequence wraps),
  ``prefill`` (the teacher-forced scan of ``serve.compress``) and
  ``generate`` (greedy, or sampled through an explicit
  ``torch.Generator``), each with the ``memory`` a ``vlm`` or ``audio``
  model's cross attention reads (for ``audio``, the caller runs
  ``models.encode_memory`` first);

* :class:`BatchEngine`, the request-level continuous-batching engine
  (DESIGN.md §11).  Concurrent compress and decompress requests are
  admitted into ``slots``; the batch is ``slots * lanes`` rows, each slot
  with its own model state (KV rings and recurrent leaves), its own
  per-row positions and per-row rANS state.  Requests join and retire
  at chunk boundaries.  Every per-request output is byte-identical to the
  single-request ``serve.compress`` paths: the engine is a scheduler, not
  a new coder.

On the card the engine runs the kernels of the single-request kernel
path: every step pops all rows with B2 (``ops.rans_decode_step_rows``)
against frequencies and CDF from B6 (``spc_quantize.spc_freq_cdf``); a
cycle's compress rows get whole TableSets from their buffered BF16
probabilities through B6 (``ops.spc_quantize_tables``, one launch a
cycle) and each slot's chunk is encoded by B1 (``ops.rans_encode``).
``step_backend="coder"`` runs the plain SPC and the pure-torch coder
instead (the single-request ``backend="coder"``), with identical bytes.

Byte identity on the card: cuBLAS chooses a GEMM's kernel, and with it
the order of each output's sum, from the GEMM's shape, so the same rows
inside a larger batch can round differently (``PERF.md`` §7).  The engine
therefore runs the model once per live slot, the single-request call
itself: each slot's state is made at admission as the single-request path
makes it (``lanes`` rows, a ring of the request's own length), so its
GEMMs have ``lanes`` rows and its attention runs over that ring.

Placement: on a ``("lanes",)`` mesh (``parallel.chunked.lane_mesh``) each
rank owns whole slots, slot ``i`` on rank ``i * size // slots``, and
keeps only their states; every rank runs the same admission and gathers
each retiring request's result from its owner, so ``run()`` returns the
same results on every rank.  A model placed for compute
(``parallel/sharding.place_model``) serves every slot on every rank as
the placed single-request path runs it: each slot's state is the rank's
shards of its ``lanes`` rows, its steps run the rank's slab of those
lanes, and its logits come back whole (every lane, the whole vocabulary)
before the SPC and the coder, which run on every row on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import bitstream, coder, constants as C, spc, u32
from repro_torch.core.predictors import model_topk_candidates
from repro_torch.kernels import ops, spc_quantize
from repro_torch.models import (PrefillUnsupportedError, can_prefill,
                                decode_step, init_state, prefill_chunk,
                                ring_length, state_spec, wrap_length)
from repro_torch.parallel.chunked import lane_mesh_usable
from repro_torch.serve.compress import (BOS, _mesh_device, _on_device,
                                        step_probs, teacher_forced_scan)

__all__ = ["BOS", "MODE_IDLE", "MODE_COMPRESS", "MODE_DECOMPRESS",
           "BatchEngine", "EngineQueueFullError", "RequestOverflowError",
           "RequestResult", "generate", "make_serve_step", "prefill"]


def make_serve_step(model):
    """Returns ``serve_step(state, token, pos, memory=None)``: one token
    (B,1) at ``pos`` (an int, or a ``(B,)`` int64 device tensor) -> logits
    (B, Vpad), the state updated in place."""

    def serve_step(state, token, pos, memory=None):
        return decode_step(model, state, token, pos, memory=memory)

    return serve_step


def prefill(model, tokens: torch.Tensor, max_len: int,
            memory: torch.Tensor | None = None):
    """Teacher-forced scan of ``decode_step`` over the prompt (B, S).

    Returns ``(state, last_logits)``.  Prefilling through the step path
    keeps serving numerics identical to stepwise decode, the property
    LM-driven lossless compression depends on."""
    last = []
    state = teacher_forced_scan(
        model, tokens, max_len,
        lambda lg, t: last.append(lg) if t == tokens.shape[1] - 1 else None,
        memory)
    return state, last[0]


def generate(model, prompt: torch.Tensor, n_new: int, max_len: int,
             memory: torch.Tensor | None = None, temperature: float = 0.0,
             generator: torch.Generator | None = None,
             return_logits: bool = False):
    """Greedy (or sampled) generation; returns (B, n_new) int64 tokens.

    ``temperature > 0`` samples from ``softmax(logits / temperature)``
    with ``generator`` (on the logits' device; the default generator when
    None).  ``return_logits`` also returns the per-step logits ``(B, n_new,
    Vpad)`` that produced each token.  Position contract: the prompt fills
    positions ``[0, S)`` and the first generated token is consumed at
    position ``S``."""
    vocab = model.cfg.vocab_size
    s_len = prompt.shape[1]
    state, last = prefill(model, prompt, max_len, memory)

    def pick(lg):
        lg = lg[:, :vocab]
        if temperature <= 0.0:
            return torch.argmax(lg, -1)
        p = torch.softmax(lg.to(torch.float32) / temperature, -1)
        return torch.multinomial(p, 1, generator=generator)[:, 0]

    out, lgs = [pick(last)], [last]
    for i in range(n_new - 1):
        lg = decode_step(model, state, out[-1][:, None], s_len + i,
                         memory=memory)
        lgs.append(lg)
        out.append(pick(lg))
    out = torch.stack(out, 1)
    if return_logits:
        return out, torch.stack(lgs, 1)
    return out


# ---------------------------------------------------------------------------
# batched multi-stream engine (continuous batching over slots x lanes rows)
# ---------------------------------------------------------------------------

MODE_IDLE, MODE_COMPRESS, MODE_DECOMPRESS = 0, 1, 2


class EngineQueueFullError(RuntimeError):
    """Admission queue at capacity: the graceful-degradation backstop."""


class RequestOverflowError(RuntimeError):
    """A request's per-request byte budget (cap) overflowed mid-stream."""


@dataclasses.dataclass
class RequestResult:
    """Terminal state of one engine request.

    ``ok`` requests carry ``blob`` (compress) or ``tokens`` (decompress);
    failed requests carry the named ``error`` instead.  A failure retires
    its slot and never perturbs co-batched streams.  ``probes`` is the
    request's total CDF-probe count (decompress; the Fig. 4(b)
    accounting), ``lane_probes`` its per-lane counts.
    """
    rid: int
    kind: str
    ok: bool
    blob: bytes | None = None
    tokens: np.ndarray | None = None
    error: Exception | None = None
    n_symbols: int = 0
    probes: int = 0
    lane_probes: np.ndarray | None = None
    slot: int = -1
    arrival: float = 0.0
    admitted_at: float = 0.0
    completed_at: float = 0.0


@dataclasses.dataclass
class _Req:
    rid: int
    kind: str                       # "compress" | "decompress"
    arrival: float
    n_symbols: int
    cap: int                        # per-request byte budget (compress)
    tokens: np.ndarray | None = None            # (lanes, T) compress input
    slab: bitstream.ContainerSlab | None = None  # decompress input
    # live-slot state
    slot: int = -1
    admitted_at: float = 0.0
    pos: int = 0                    # symbols dispatched so far
    enc_chunks: list = dataclasses.field(default_factory=list)
    out_syms: list = dataclasses.field(default_factory=list)
    probes: np.ndarray | None = None


@dataclasses.dataclass
class _Cycle:
    """One cycle's inputs (rows-form numpy, then device tensors)."""
    spec: list             # (rid, slot, chunk, n_c, last) per live slot
    mine: tuple            # (slot, n_c) per live slot this rank owns
    fresh: list            # slots admitted at this cycle
    comp: list             # live compress slots
    prefill: bool
    steps: int             # the longest chunk of the cycle
    host: dict


class BatchEngine:
    """Continuous-batching compress/decompress service.

    ``slots`` concurrent requests of ``lanes`` rANS lanes, each slot with
    its own model state (made at admission, its ring the request's length
    up to ``max_len``'s ring), per-row positions and per-row coder state.
    Requests join and retire at chunk boundaries.  The run loop keeps one cycle
    in flight: cycle ``k+1`` is enqueued on the card before cycle ``k``'s
    outputs are read, so the host half (container windows, ``pack``)
    overlaps the device half.  A cycle's device half makes no host
    synchronization (``check_sync`` runs it under
    ``torch.cuda.set_sync_debug_mode("error")`` to prove it).

    Byte-identity contract: a request of T <= ``max_len`` symbols produces
    output byte-identical to ``lm_compress_chunked`` /
    ``lm_decompress_chunked`` at the same ``chunk_size``/``prob_bits``/
    ``topk`` and the matching backend, whatever traffic it is batched
    with: its slot runs the single-request path's model call on a state of
    the single-request path's shape, its rows are independent in every
    other op, and the per-chunk coder is the same code.  A longer
    request would wrap the ring and is refused with a named error unless
    ``allow_wrap=True`` (it then round-trips through an engine of the same
    geometry); a config whose state never wraps at ``max_len``
    (``models.wrap_length`` is None: pure recurrent state, or a local
    window no wider than ``max_len``) takes streams of any length.

    Admission: FIFO by ``(arrival, rid)``, at most ``max_queue`` waiting
    requests (``submit_*`` raises :class:`EngineQueueFullError` beyond).
    Failures (cap overflow, a decode over-read) retire their own slot with
    a named error; co-batched rows are untouched.

    ``prefill``: ``"auto"`` serves cycles whose live slots are all
    unwrapped compress requests with ``prefill_chunk`` (the teacher-forced
    chunk, bitwise the step path) and the rest with the step loop;
    ``"off"`` runs every cycle on the step loop; ``"force"`` raises
    :class:`~repro_torch.models.PrefillUnsupportedError` at construction
    when the config cannot prefill (the recurrent families: ``"auto"``
    steps down to the step loop there).  ``prefill_cycles`` counts prefill
    cycles.  ``device`` is the model's device (the card unless given,
    raising without one); the reference's ``interpret`` (TPU) has no
    counterpart here.

    ``model`` may be placed for compute (``parallel.sharding.
    place_model``): every rank of its mesh submits the same requests and
    gets the same results, each slot's blobs those of the placed
    ``lm_compress_chunked`` on the same placement.

    ``mesh``: an optional ``("lanes",)`` mesh placing whole slots over its
    ranks (slot ``i`` on rank ``i * size // slots``): each rank steps only
    its slots, keeping only their states, on the mesh's device, and the
    owner of a retiring request sends its result to every rank.  The mesh is used only where
    ``slots % size == 0`` (the reference's ``rows % size`` would split a
    slot's lanes, whose GEMMs then price at another row count); otherwise
    the single-device program runs.  Every rank submits the same requests
    and calls ``run()``; with ``clock="wall"`` rank 0's clock decides.
    """

    def __init__(self, model, *, slots: int = 4, lanes: int = 8,
                 chunk_size: int = 64, max_len: int | None = None,
                 cap: int | None = None, prob_bits: int = C.PROB_BITS,
                 topk: int = 4, max_queue: int = 64,
                 step_backend: str = "coder", prefill: str = "auto",
                 device=None, mesh=None):
        if step_backend not in ("coder", "kernel"):
            raise ValueError(f"unknown step backend {step_backend!r}")
        if prefill not in ("auto", "off", "force"):
            raise ValueError(f"unknown prefill policy {prefill!r} "
                             "(expected 'auto', 'off' or 'force')")
        cfg = model.cfg
        # a compute-placed model's placement: every slot on every rank
        self._pl = getattr(model, "placement", None)
        if self._pl is not None and mesh is not None:
            raise ValueError(
                "mesh= with a placed model (parallel.sharding.place_model): "
                "the model's own mesh places its steps; pass mesh=None, or "
                "a whole model with a lane mesh")
        if prefill == "force" and not can_prefill(cfg):
            raise PrefillUnsupportedError(
                f"prefill='force' on config {cfg.name!r} (family "
                f"{cfg.family!r}, kinds {state_spec(cfg).kinds}): this "
                "family carries sequential state and has no block-parallel "
                "prefill; use prefill='auto' (steps down to the step loop) "
                "or 'off'")
        placed = lane_mesh_usable(
            mesh, slots * lanes,
            what="batched engine (its slots x lanes rows)") and \
            slots % mesh.size == 0
        self.mesh = mesh if placed else None
        self.device = _on_device(model, _mesh_device(mesh, device))
        self.model = model
        self.cfg = cfg
        self.slots = slots
        self.lanes = lanes
        self.rows = slots * lanes
        # this rank's slots [s0, s1) and their rows of the cycle's inputs
        self._s0, self._s1 = (self.mesh.slab(slots) if placed
                              else (0, slots))
        self.local_rows = (self._s1 - self._s0) * lanes
        self.chunk_size = chunk_size
        self.max_len = 4 * chunk_size if max_len is None else max_len
        # every decompress chunk cell must fit this stream window
        # (validated at submit); compress caps are per request
        self.cap = coder.default_cap(chunk_size) if cap is None else cap
        self.prob_bits = prob_bits
        self.topk = topk
        self.max_queue = max_queue
        self.step_backend = step_backend
        self.check_sync = False
        self.state_spec = state_spec(cfg)
        self.ring_len = ring_length(cfg, self.max_len)
        self._wrap_len = wrap_length(cfg, self.max_len)
        # each slot's model state, made when a request is admitted to it
        self._states: list = [None] * slots
        self._tok = torch.full((self.local_rows, 1), BOS, dtype=torch.int64,
                               device=self.device)
        self._slots: list[_Req | None] = [None] * slots
        self._queue: list[_Req] = []
        self._next_rid = 0
        # (rid, slot, cycle) per admission
        self.admission_log: list[tuple[int, int, int]] = []
        self.prefill_cycles = 0
        self._prefill = prefill in ("auto", "force") and can_prefill(cfg)

    def _owns(self, s: int) -> bool:
        return self._s0 <= s < self._s1

    def _row0(self, s: int) -> int:
        """Slot ``s``'s first row in this rank's state."""
        return (s - self._s0) * self.lanes

    # -- admission --------------------------------------------------------

    def _submit(self, req: _Req) -> int:
        if len(self._queue) >= self.max_queue:
            raise EngineQueueFullError(
                f"engine admission queue is full ({self.max_queue} waiting "
                "requests): drain with run() or raise max_queue; rejecting "
                "at the door keeps in-flight streams untouched")
        self._queue.append(req)
        return req.rid

    def _check_len(self, t_len: int, allow_wrap: bool, what: str):
        if t_len < 1:
            raise ValueError(f"{what} must cover at least 1 symbol")
        if self._wrap_len is not None and t_len > self._wrap_len \
                and not allow_wrap:
            raise ValueError(
                f"request of {t_len} symbols exceeds the engine ring "
                f"({self.ring_len} slots at max_len={self.max_len}): the "
                "shared cache would wrap and condition on a sliding window "
                "narrower than the single-request path's; pass "
                "allow_wrap=True to accept windowed conditioning "
                "(round-trips through this engine, but is no longer "
                "byte-identical to the single-request path), or build the "
                "engine with a larger max_len")

    def submit_compress(self, tokens, arrival: float = 0.0,
                        cap: int | None = None,
                        allow_wrap: bool = False) -> int:
        """Queue a compress request: tokens (lanes, T) -> container blob.

        ``cap`` is the per-request per-(chunk, lane) byte budget (default
        ``coder.default_cap`` of the chunk length, the single-request
        default).  An undersized cap fails only this request
        (:class:`RequestOverflowError` in its result).
        """
        tokens = np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor)
                            else tokens, np.int64)
        if tokens.ndim != 2 or tokens.shape[0] != self.lanes:
            raise ValueError(
                f"compress tokens must be (lanes={self.lanes}, T), got "
                f"{tokens.shape}: the engine's rows are slots x lanes")
        t_len = int(tokens.shape[1])
        self._check_len(t_len, allow_wrap, "a compress request")
        cap = (coder.default_cap(min(self.chunk_size, t_len))
               if cap is None else int(cap))
        rid = self._next_rid
        self._next_rid += 1
        return self._submit(_Req(rid=rid, kind="compress", arrival=arrival,
                                 n_symbols=t_len, cap=cap, tokens=tokens))

    def submit_decompress(self, blob: bytes, arrival: float = 0.0,
                          allow_wrap: bool = False) -> int:
        """Queue a decompress request: container v2 blob -> tokens.

        The blob is parsed and validated here (``bitstream.parse_chunked``'s
        named errors surface at submit) and must match the engine's
        geometry: same ``lanes``, ``chunk_size`` and ``prob_bits``, every
        cell within the engine's stream window.
        """
        slab = bitstream.parse_chunked(blob)
        meta = slab.meta
        if meta.lanes != self.lanes:
            raise ValueError(
                f"container has {meta.lanes} lanes but the engine is "
                f"shaped for lanes={self.lanes}")
        if meta.chunk_size != self.chunk_size:
            raise ValueError(
                f"container chunk_size {meta.chunk_size} != engine "
                f"chunk_size {self.chunk_size}: the engine decodes at its "
                "chunk granularity; build a matching engine")
        if meta.prob_bits != self.prob_bits:
            raise ValueError(
                f"container prob_bits {meta.prob_bits} != engine "
                f"prob_bits {self.prob_bits}")
        max_cell = int(np.max(slab.length)) if slab.length.size else 0
        if max_cell > self.cap:
            raise ValueError(
                f"container cell of {max_cell} bytes exceeds the engine's "
                f"stream window (cap={self.cap}): build the engine with "
                f"cap >= {max_cell}")
        self._check_len(int(meta.n_symbols), allow_wrap,
                        "a decompress request")
        rid = self._next_rid
        self._next_rid += 1
        return self._submit(_Req(rid=rid, kind="decompress", arrival=arrival,
                                 n_symbols=int(meta.n_symbols), cap=self.cap,
                                 slab=slab))

    # -- one scheduling cycle --------------------------------------------

    def _admit(self, now: float, cycle: int):
        self._queue.sort(key=lambda r: (r.arrival, r.rid))
        for s in range(self.slots):
            if self._slots[s] is not None:
                continue
            pick = next((r for r in self._queue if r.arrival <= now), None)
            if pick is None:
                break
            self._queue.remove(pick)
            pick.slot, pick.admitted_at = s, now
            self._slots[s] = pick
            self.admission_log.append((pick.rid, s, cycle))

    def _build_cycle(self) -> _Cycle | None:
        """Host half of a cycle: rows-form inputs for every live slot this
        rank owns (every rank advances every live slot's schedule).

        Decompress slots right-align the chunk's per-lane spans straight
        out of the parsed payload slab into the stream window.  Returns
        None when no slot has steps to run."""
        B, S, cap = self.local_rows, self.chunk_size, self.cap
        host = dict(pos0=np.zeros(B, np.int64), mode=np.zeros(B, np.int64),
                    n_valid=np.zeros(B, np.int64),
                    tf=np.zeros((B, S), np.int64),
                    buf=np.zeros((B, cap), np.uint8),
                    start=np.zeros(B, np.int32))
        spec, mine, fresh, comp = [], [], [], []
        prefillable = self._prefill
        for s, req in enumerate(self._slots):
            if req is None or req.pos >= req.n_symbols:
                continue
            # decompress rows feed decoded symbols back step to step, and a
            # wrapping request overwrites ring slots still visible inside
            # the chunk: both take the step loop
            if req.kind != "compress" or req.n_symbols > self.ring_len:
                prefillable = False
            n_c = min(S, req.n_symbols - req.pos)
            c = req.pos // S
            spec.append((req.rid, s, c, n_c, req.pos + n_c >= req.n_symbols))
            if not self._owns(s):
                req.pos += n_c
                continue
            r0 = self._row0(s)
            r1 = r0 + self.lanes
            if req.pos == 0:
                fresh.append(s)
            mine.append((s, n_c))
            host["pos0"][r0:r1] = req.pos
            host["n_valid"][r0:r1] = n_c
            if req.kind == "compress":
                comp.append(s)
                host["mode"][r0:r1] = MODE_COMPRESS
                host["tf"][r0:r1, :n_c] = req.tokens[:, req.pos:req.pos + n_c]
            else:
                host["mode"][r0:r1] = MODE_DECOMPRESS
                slab = req.slab
                payload = np.asarray(slab.slab, np.uint8)
                for lane in range(self.lanes):
                    o, n = int(slab.offset[c, lane]), int(slab.length[c, lane])
                    host["buf"][r0 + lane, cap - n:] = payload[o:o + n]
                    host["start"][r0 + lane] = cap - n
            req.pos += n_c
        if not spec:
            return None
        return _Cycle(spec=spec, mine=tuple(mine), fresh=fresh, comp=comp,
                      prefill=prefillable,
                      steps=max((n for _, n in mine), default=0), host=host)

    def _upload(self, host: dict) -> dict:
        """Host arrays -> device tensors without waiting for the card: from
        pinned memory, asynchronously, on the card."""
        if self.device.type != "cuda":
            return {k: torch.from_numpy(v) for k, v in host.items()}
        return {k: torch.from_numpy(v).pin_memory().to(self.device,
                                                       non_blocking=True)
                for k, v in host.items()}

    def _launch(self, cyc: _Cycle):
        """Device half: enqueue the cycle (the prefill chunk when every live
        slot is an unwrapped compress request, the step loop otherwise),
        then the compress slots' tables and chunk encodes.  Nothing here
        waits for the card.  A rank that owns no live slot of the cycle
        enqueues nothing."""
        if cyc.prefill:
            self.prefill_cycles += 1
        if not cyc.mine:
            return cyc.spec, None, {}
        dev = self._upload(cyc.host)
        guard = (torch.cuda.set_sync_debug_mode if self.check_sync
                 and self.device.type == "cuda" else None)
        with _sync_debug(guard):
            L = self.lanes
            for s in cyc.fresh:   # a fresh admit: the single-request state
                self._states[s] = init_state(self.model, L, min(
                    self._slots[s].n_symbols, self.ring_len))
                r0 = self._row0(s)
                self._tok[r0:r0 + L] = BOS
            if cyc.prefill:
                probs, out = self._prefill_body(cyc, dev)
            else:
                probs, out = self._step_body(cyc, dev)
            encs = self._encode(cyc, dev, probs)
        return cyc.spec, out, encs

    def _per_slot(self, cyc: _Cycle, t: int, fn, shape: tuple):
        """``fn(state, rows)`` for each slot this rank owns whose chunk is
        longer than ``t``: the slot's own state and its rows of the
        cycle's inputs.  Each slot's logits (a placed model's gathered
        whole: every lane, the whole vocabulary) go into its rows of a
        zero tensor of ``shape``; the other rows stay zero."""
        pl, out = self._pl, self.model.embedding.new_zeros(shape)
        for s, n_c in cyc.mine:
            if t < n_c:
                r = slice(self._row0(s), self._row0(s) + self.lanes)
                lg = fn(self._states[s], r)
                out[r] = lg if pl is None else pl.whole_rows(
                    pl.whole_vocab(lg), self.lanes)
        return out

    def _step_body(self, cyc: _Cycle, dev: dict):
        """The step loop, as many steps as the cycle's longest chunk: step
        ``t`` runs the model on the slots whose chunk is longer than ``t``
        (per-row positions ``pos0 + t``), then the SPC and the pop on all
        rows; rows past ``n_valid`` hold their coder state and token.

        A slot past its ``n_valid`` (only a request's last chunk is short)
        is not stepped, so its state is frozen: its recurrent leaves keep
        their values bit for bit, as the reference's ``_freeze`` select
        does, and its ring rows are not written (the reference writes the
        clamped position's slot, which nothing reads before the request
        retires).  Returns the compress rows' BF16 probabilities ``(S, B,
        V)`` (or None) and the decode outputs ``(syms, probes, unders,
        header under)`` (or None)."""
        S, vocab, pb = cyc.steps, self.cfg.vocab_size, self.prob_bits
        kernel = self.step_backend == "kernel"
        n_valid, pos0, tf = dev["n_valid"], dev["pos0"], dev["tf"]
        has_dec = len(cyc.comp) < len(cyc.spec)
        probs_buf = (torch.empty((S, self.local_rows, vocab),
                                 dtype=torch.bfloat16,
                                 device=self.device) if cyc.comp else None)
        out = None
        if has_dec:
            buf = dev["buf"]
            dec = coder.decoder_init(bitstream.EncodedLanes(
                buf, dev["start"], None))
            s, ptr = u32.bits(dec.s), dec.ptr.to(torch.int32)
            is_comp = (dev["mode"] == MODE_COMPRESS)[:, None]
            syms, probes, unders = (torch.zeros((S, self.local_rows),
                                                dtype=torch.int32,
                                                device=self.device)
                                    for _ in range(3))
        tok, vpad = self._tok, self.cfg.vocab_padded
        for t in range(S):
            active = n_valid > t
            pos = pos0 + t
            lg = self._per_slot(cyc, t, lambda st, r: decode_step(
                self.model, st, tok[r], pos[r]), (self.local_rows, vpad))
            probs = step_probs(lg, vocab)
            if probs_buf is not None:
                probs_buf[t] = probs
            nxt = tf[:, t:t + 1]
            if has_dec:
                cands = model_topk_candidates(lg[:, :vocab], self.topk)
                tbl = spc.FreqCdf(*(spc_quantize.spc_freq_cdf(probs, pb)
                                    if kernel else
                                    spc.freq_cdf_from_probs(probs, pb)))
                s2, p2, sym, pr, u = ops.rans_decode_step_rows(
                    buf, s, ptr, tbl, pb, candidates=cands,
                    backend=self.step_backend)
                s = torch.where(active, s2, s)
                ptr = torch.where(active, p2, ptr)
                syms[t], probes[t] = sym, pr
                unders[t] = (active & (u > 0)).to(torch.int32)
                nxt = torch.where(is_comp, nxt, sym.to(torch.int64)[:, None])
            tok = torch.where(active[:, None], nxt, tok)
        self._tok = tok
        if has_dec:
            out = (syms, probes, unders, dec.underflow)
        return probs_buf, out

    def _prefill_body(self, cyc: _Cycle, dev: dict):
        """All-compress cycle: one teacher-forced ``prefill_chunk`` in place
        of the step loop (compress rows know their inputs up front).  The
        step loop feeds the previous token at each step, so the inputs are
        the carried token followed by all but the last teacher-forced
        token."""
        S, vocab = cyc.steps, self.cfg.vocab_size
        n_valid, tf = dev["n_valid"], dev["tf"]
        inputs = torch.cat([self._tok, tf[:, :S - 1]], 1)
        pos0 = dev["pos0"]
        lgs = self._per_slot(cyc, 0, lambda st, r: prefill_chunk(
            self.model, st, inputs[r], pos0[r], n_valid[r]),
            tuple(inputs.shape) + (self.cfg.vocab_padded,))
        # each position's SPC input at the step loop's (B, V) shape
        probs = torch.stack([step_probs(lgs[:, t], vocab) for t in range(S)])
        last = tf.gather(1, torch.clamp(n_valid - 1, 0, S - 1)[:, None])
        self._tok = torch.where((n_valid > 0)[:, None], last, self._tok)
        return probs, None

    def _encode(self, cyc: _Cycle, dev: dict, probs):
        """The cycle's compress chunks: one SPC over every compress slot's
        buffered probabilities (B6 and ``build_tables`` on the kernel
        backend, the plain SPC on the coder backend), then each slot's
        chunk encoded against its ``(n_c, lanes, K)`` tables (B1 or the
        coder).  Returns ``{slot: EncodedLanes}`` on the device."""
        if not cyc.comp:
            return {}
        L, vocab, pb = self.lanes, self.cfg.vocab_size, self.prob_bits
        kernel = self.step_backend == "kernel"
        r0 = {s: self._row0(s) for s in cyc.comp}
        rows = torch.stack([probs[:, r0[s]:r0[s] + L] for s in cyc.comp])
        flat = rows.reshape(-1, vocab)
        tables = (ops.spc_quantize_tables(flat, pb) if kernel
                  else spc.tables_from_probs(flat, pb))
        planes = [a.reshape(rows.shape[:3] + a.shape[1:]) for a in tables]
        n_of = {s: n_c for _, s, _, n_c, _ in cyc.spec}
        encs = {}
        for j, s in enumerate(cyc.comp):
            n_c = n_of[s]
            tbl = spc.TableSet(*(a[j, :n_c] for a in planes))
            sym = dev["tf"][r0[s]:r0[s] + L, :n_c]
            cap = self._slots[s].cap
            encs[s] = (ops.rans_encode(sym, tbl, cap=cap) if kernel
                       else coder.encode(sym, tbl, cap=cap))
        return encs

    def _finalize(self, inflight, now: float, results: dict):
        """Harvest a finished cycle: collect per-slot outputs (reading them
        waits for this cycle only).  A cap overflow or a decode over-read
        retires its request with a named error; the slot frees, an
        already-enqueued follow-up chunk of the failed request is dropped
        at its own finalize, and no other row is touched.  On a mesh each
        rank harvests its own slots, then every rank takes every
        retirement from its owner."""
        spec, out, encs = inflight
        host = None
        retired: dict[int, RequestResult] = {}
        for rid, s, c, n_c, last in spec:
            req = self._slots[s]
            if req is None or req.rid != rid or rid in results \
                    or not self._owns(s):
                continue        # retired mid-flight, or another rank's slot
            r0 = self._row0(s)
            r1 = r0 + self.lanes
            if req.kind == "compress":
                enc = bitstream.EncodedLanes(
                    *(a.cpu().numpy() for a in encs[s]))
                if enc.overflow.any():
                    cells = np.nonzero(enc.overflow)[0].tolist()
                    retired[rid] = self._result(req, now, RequestOverflowError(
                        f"request {rid}: encode overflow in chunk {c} "
                        f"(lanes {cells}): the per-request byte budget "
                        f"(cap={req.cap}) truncated the stream; resubmit "
                        "with a larger cap"))
                    continue
                req.enc_chunks.append(enc)
            else:
                if host is None:
                    host = [a.cpu().numpy() for a in out]
                syms, probes, unders, head = host
                und = unders[:n_c, r0:r1].any(0) | head[r0:r1]
                if und.any():
                    retired[rid] = self._result(
                        req, now, coder.StreamExhaustedError(
                            f"request {rid}: decode over-read in chunk {c} "
                            f"(lanes {np.nonzero(und)[0].tolist()}): a "
                            "lane's stream ran out of bytes mid-decode; the "
                            "container is truncated or was produced with a "
                            "different geometry"))
                    continue
                req.out_syms.append(syms[:n_c, r0:r1].T.astype(np.int32))
                lp = probes[:n_c, r0:r1].sum(0, dtype=np.int64)
                req.probes = lp if req.probes is None else req.probes + lp
            if last:
                retired[rid] = self._result(req, now)
        if self.mesh is not None and self.mesh.size > 1:
            parts = [None] * self.mesh.size
            dist.all_gather_object(parts, retired, group=self.mesh.group)
            retired = {k: v for part in parts for k, v in part.items()}
        for rid, res in retired.items():
            results[rid] = res
            self._slots[res.slot] = None

    def _result(self, req: _Req, now: float,
                error: Exception | None = None) -> RequestResult:
        res = RequestResult(rid=req.rid, kind=req.kind, ok=error is None,
                            error=error, n_symbols=req.n_symbols,
                            probes=0 if req.probes is None
                            else int(req.probes.sum()),
                            lane_probes=req.probes, slot=req.slot,
                            arrival=req.arrival, admitted_at=req.admitted_at,
                            completed_at=now)
        if error is None:
            if req.kind == "compress":
                ch = [np.stack(xs) for xs in zip(*req.enc_chunks)]
                res.blob = bitstream.pack_chunked(
                    *ch, chunk_size=self.chunk_size, n_symbols=req.n_symbols,
                    prob_bits=self.prob_bits)
            else:
                res.tokens = np.concatenate(req.out_syms, axis=1)
        return res

    def _clock(self, t0: float, wall: bool, vnow: float) -> float:
        """The cycle's time: the cycle clock, or the wall clock since the
        run began (rank 0's on a mesh, so every rank admits alike)."""
        if not wall:
            return vnow
        now = time.monotonic() - t0
        if self.mesh is not None and self.mesh.size > 1:
            box = [now]
            dist.broadcast_object_list(box, src=self.mesh.global_rank(0),
                                       group=self.mesh.group)
            now = box[0]
        return now

    # -- run loop ---------------------------------------------------------

    def run(self, *, clock: str = "virtual") -> dict[int, RequestResult]:
        """Drain the queue; returns {rid: RequestResult} for every request.

        ``clock="virtual"``: time is the cycle counter, fully
        deterministic: arrivals are in cycle units and the loop jumps idle
        gaps.  ``clock="wall"``: arrivals are seconds relative to run
        start; the loop sleeps through idle gaps and stamps real
        latencies.

        One cycle: admit -> build inputs (host) -> enqueue (device) ->
        finalize the previous cycle (host, waiting only for that cycle).
        When a retire is pending and requests wait, the in-flight cycle is
        finalized first, so the freed slot refills at once.
        """
        if clock not in ("virtual", "wall"):
            raise ValueError(f"unknown clock {clock!r}")
        results: dict[int, RequestResult] = {}
        t0 = time.monotonic()
        wall = clock == "wall"
        vnow, cycle = 0.0, 0
        inflight = None
        while self._queue or any(self._slots) or inflight is not None:
            now = self._clock(t0, wall, vnow)
            if inflight is not None and self._queue \
                    and any(last for *_, last in inflight[0]):
                self._finalize(inflight, now, results)
                inflight = None
            self._admit(now, cycle)
            built = self._build_cycle()
            nxt = self._launch(built) if built is not None else None
            if inflight is not None:
                now = self._clock(t0, wall, vnow)
                self._finalize(inflight, now, results)
            inflight = nxt
            if nxt is None and inflight is None and self._queue:
                gap = min(r.arrival for r in self._queue)
                if wall:
                    time.sleep(max(0.0, gap - (time.monotonic() - t0)))
                else:
                    vnow = max(vnow + 1.0, gap)
            else:
                vnow += 1.0
            cycle += 1
        return results


@contextlib.contextmanager
def _sync_debug(set_mode):
    """Run the block under ``set_sync_debug_mode("error")`` (restoring the
    previous mode) when ``set_mode`` is given."""
    if set_mode is None:
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    set_mode("error")
    try:
        yield
    finally:
        set_mode(before)
