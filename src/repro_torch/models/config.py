"""ModelConfig: the dense-transformer fields of ``repro.models.config``.

Field names and derived quantities match the reference so a config reads
the same in both packages.  Only the dense family is ported so far, in
float32 (the reference's ``dtype`` field is therefore absent).  The window
fields and the layer-kind ``pattern``/``stages`` are here for the serving
protocol's state classification (``models.protocol``); no ported model
reads a window yet (``DenseLM`` refuses one).  The training fields
(``attn_impl``, ``logits_chunk``, ``grad_accum``, ``moment_dtype``,
``grad_dtype``) carry the reference's defaults; only ``attn_impl="naive"``
is ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int | None = None      # default d_model // n_heads
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tp: int = 1                      # q heads are padded to a multiple
    local_window: int = 0            # local attention window (0 = full)
    sliding_window: int = 0          # sliding-window attention (0 = full)

    # training
    attn_impl: str = "naive"         # naive | blockwise (not ported)
    logits_chunk: int = 0            # 0 = unchunked loss
    grad_accum: int = 1
    moment_dtype: str = "float32"    # AdamW moments
    grad_dtype: str = "float32"      # accumulated gradients (grad_accum > 1)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def n_heads_padded(self) -> int:
        if self.n_heads == 0:
            return 0
        return math.ceil(self.n_heads / self.tp) * self.tp

    @property
    def vocab_padded(self) -> int:
        return math.ceil(self.vocab_size / 256) * 256

    @property
    def is_encdec(self) -> bool:
        """The dense family has no encoder."""
        return False

    @property
    def pattern(self) -> tuple[str, ...]:
        """Layer-kind pattern unit: the dense family's is one attention
        block."""
        return ("attn",)

    @property
    def stages(self) -> tuple[tuple[tuple[str, ...], int], ...]:
        """(pattern, repeats) stages covering n_layers."""
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
