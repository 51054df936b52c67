"""mamba2-130m [ssm]: 24L d=768 (attn-free) v=50280, ssm_state=128, SSD.

Sub-quadratic: runs the long_500k shape (O(1)-state decode).
[arXiv:2405.21060; unverified]

Same values as ``repro.configs.mamba2_130m``.  Its vocabulary fits the
SPC's ceiling of 2**16 at ``prob_bits=16``, so the full width is coded.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
    tie_embeddings=True,
    tp=16,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=16,
    ssm_chunk=8,
    tie_embeddings=True,
    tp=1,
    dtype="float32",
    remat=False,
)
