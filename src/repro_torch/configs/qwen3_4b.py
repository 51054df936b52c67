"""qwen3-4b [dense]: 36L d=2560 32H (GQA kv=8) ff=9728 v=151936, qk_norm.

Its query heads are wider than the model (32 x 128 = 4,096 against
d_model 2,560).  [hf:Qwen/Qwen3-8B; hf]

Same values as ``repro.configs.qwen3_4b``.  Its vocabulary exceeds the
SPC's ceiling of 2**16, so only ``SMOKE`` can be coded.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tp=16,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="qwen3-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    qk_norm=True,
    tp=1,
    dtype="float32",
    remat=False,
)
