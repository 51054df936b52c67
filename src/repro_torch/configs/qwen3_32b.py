"""qwen3-32b [dense]: 64L d=5120 64H (GQA kv=8) ff=25600 v=151936, qk_norm.
[hf:Qwen/Qwen3-8B; hf]

Same values as ``repro.configs.qwen3_32b``.  Its vocabulary exceeds the
SPC's ceiling of 2**16, so only ``SMOKE`` can be coded.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=80,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tp=16,
    dtype="bfloat16",
    grad_accum=8,
)

SMOKE = ModelConfig(
    name="qwen3-32b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    head_dim=8,
    qk_norm=True,
    tp=1,
    dtype="float32",
    remat=False,
)
