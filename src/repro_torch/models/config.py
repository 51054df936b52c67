"""ModelConfig: the fields of ``repro.models.config`` that the ported
families read.

Field names and derived quantities match the reference so a config reads
the same in both packages.  The dense, ``moe`` (Mixtral, Phi-3.5-MoE),
``ssm`` (Mamba2), ``hybrid`` (RecurrentGemma), ``vlm`` (Llama-3.2-Vision:
cross-attention layers over a memory) and ``audio`` (SeamlessM4T: an
encoder-decoder) families are ported; the family-dependent layer-kind
``pattern`` and its ``stages``
drive the model's assembly (``models.transformer``) and the serving
protocol's state classification (``models.protocol``).  ``local_window``
(the hybrid's) or ``sliding_window`` (mixtral's) bounds the attention
ring and its mask (:attr:`ModelConfig.window`).  ``cross_attn_every``
(vlm: one ``cross`` layer per N), ``encoder_layers`` (audio: a
bidirectional encoder before the ``dec`` layers) and ``memory_tokens``/
``memory_dim`` (the stub frontends' sequence length and width) describe
the memory the cross attention reads.  ``dtype`` is the
parameters' and
activations' type (``"float32"`` or ``"bfloat16"``).  ``qkv_bias`` and
``qk_norm`` (the Qwen models) add the attention's biases and its per-head
q/k norms.  The training fields (``attn_impl``: ``"naive"`` or
``"blockwise"`` over ``attn_block`` keys, ``remat``, ``logits_chunk``,
``grad_accum``, ``moment_dtype``, ``grad_dtype``) carry the reference's
defaults.  ``remat`` (activation checkpointing, the reference's
``jax.checkpoint``) keeps only each pattern repetition's input, and each
encoder block's, for backward and recomputes the rest there
(``models.transformer``).  ``act_pspec`` is the reference's placement
of the residual stream on the ``(data, model)`` mesh: ``(batch axes,
"model", None)`` keeps the residuals sequence-parallel over ``model``
(``llama3-405b``'s fit lever); unplaced paths never read it
(``parallel/sharding.place_model``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int | None = None      # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tp: int = 1                      # q heads are padded to a multiple

    # MoE
    n_experts: int = 0
    topk_experts: int = 2
    moe_impl: str = "capacity"       # capacity | dense
    capacity_factor: float = 1.25

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128             # training-side chunk
    conv_width: int = 4

    # hybrid (recurrentgemma): layer-kind pattern, tiled over depth
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    local_window: int = 0            # local attention window (0 = full)
    sliding_window: int = 0          # sliding-window attention (0 = full)
    rglru_c: float = 8.0

    # encoder-decoder (seamless) / cross attention (vlm)
    encoder_layers: int = 0
    cross_attn_every: int = 0        # vlm: 1 cross layer per N
    memory_tokens: int = 0           # stub modality frontend length
    memory_dim: int = 0              # frontend embedding dim (= d_model)

    dtype: str = "float32"           # float32 | bfloat16

    # training
    attn_impl: str = "naive"         # naive | blockwise
    attn_block: int = 1024           # kv-chunk for blockwise attention
    remat: bool = True               # checkpoint each pattern repetition
    logits_chunk: int = 0            # 0 = unchunked loss
    grad_accum: int = 1
    moment_dtype: str = "float32"    # AdamW moments
    grad_dtype: str = "float32"      # accumulated gradients (grad_accum > 1)
    act_pspec: tuple | None = None   # residual stream placement (batch,
                                     # sequence, feature): "model" on the
                                     # sequence = sequence parallelism

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def window(self) -> int:
        """The attention window of a decode step (0 = full): the hybrid's
        ``local_window`` or the dense ``sliding_window``, as the
        reference's ``attn_decode`` reads them."""
        return self.local_window or self.sliding_window

    @property
    def n_heads_padded(self) -> int:
        if self.n_heads == 0:
            return 0
        return math.ceil(self.n_heads / self.tp) * self.tp

    @property
    def kv_sharded(self) -> bool:
        """Whether the KV heads divide over the model axis (``tp``);
        otherwise they replicate there (``parallel/sharding.py``)."""
        return self.n_kv_heads > 0 and self.n_kv_heads % self.tp == 0

    @property
    def vocab_padded(self) -> int:
        return math.ceil(self.vocab_size / 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def pattern(self) -> tuple[str, ...]:
        """Layer-kind pattern unit; defaults per family."""
        if self.block_pattern:
            return self.block_pattern
        if self.family == "ssm":
            return ("ssm",)
        if self.family == "moe":
            return ("attn_moe",)
        if self.family == "vlm" and self.cross_attn_every:
            return ("attn",) * (self.cross_attn_every - 1) + ("cross",)
        return ("attn",)

    @property
    def stages(self) -> tuple[tuple[tuple[str, ...], int], ...]:
        """(pattern, repeats) stages covering n_layers; the tail partial
        pattern becomes its own stage."""
        pat = self.pattern
        full, rem = divmod(self.n_layers, len(pat))
        out = []
        if full:
            out.append((pat, full))
        if rem:
            out.append((pat[:rem], 1))
        return tuple(out)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def param_count_estimate(self) -> int:
        """The reference's rough parameter count, the N of the model
        FLOPs (``analysis/roofline.model_flops``)."""
        d, dh = self.d_model, self.head_dim_
        h, kv = self.n_heads, self.n_kv_heads
        attn = d * dh * (h + 2 * kv) + h * dh * d
        if self.qkv_bias:
            attn += dh * (h + 2 * kv)
        mlp = 3 * d * self.d_ff
        moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        ssm_inner = self.ssm_expand * d
        ssm = (d * (2 * ssm_inner + 2 * self.ssm_state
                    + ssm_inner // max(self.ssm_headdim, 1))
               + ssm_inner * d) if self.family == "ssm" else 0
        per_kind = {
            "attn": attn + mlp,
            "attn_moe": attn + moe,
            "cross": 2 * attn + mlp,
            "ssm": ssm,
            "rec": (d * 3 * ssm_inner + ssm_inner * d) + mlp,
        }
        total = 0
        for pat, reps in self.stages:
            total += reps * sum(per_kind.get(k, attn + mlp) for k in pat)
        if self.is_encdec:
            total += self.encoder_layers * (attn + mlp)
        total += self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count_estimate(self) -> int:
        """MoE: experts count only at topk/n_experts duty cycle."""
        if self.n_experts == 0:
            return self.param_count_estimate()
        full = self.param_count_estimate()
        moe_part = (self.n_layers * self.n_experts * 3 * self.d_model
                    * self.d_ff)
        active_part = (self.n_layers * self.topk_experts * 3 * self.d_model
                       * self.d_ff)
        return full - moe_part + active_part
