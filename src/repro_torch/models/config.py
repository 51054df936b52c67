"""ModelConfig: the dense-transformer fields of ``repro.models.config``.

Field names and derived quantities match the reference so a config reads
the same in both packages.  Only the dense family is ported so far, in
float32 (the reference's ``dtype`` field is therefore absent).
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

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)
