"""qwen1.5-4b [dense]: 40L d=2560 20H (GQA kv=20) ff=6912 v=151936, QKV bias.

The 20 query heads pad to 32 (``tp=16``, zero-initialised extras) over 20
kv heads: the padded heads read kv head 0 (``attention.kv_head_map``).
[hf:Qwen/Qwen1.5-0.5B; hf]

Same values as ``repro.configs.qwen1_5_4b``.  Its vocabulary exceeds the
SPC's ceiling of 2**16, so only ``SMOKE`` can be coded.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tp=16,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="qwen1.5-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    qkv_bias=True,
    tp=1,
    dtype="float32",
    remat=False,
)
