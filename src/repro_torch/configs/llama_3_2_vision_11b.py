"""llama-3.2-vision-11b [vlm]: 40L d=4096 32H (GQA kv=8) ff=14336 v=128256.

Cross-attention image layers: 1 per 5 (8 cross layers over 40).  The vision
frontend is a STUB: the caller supplies precomputed patch embeddings
(B, memory_tokens, d_model) as the cross-attention memory.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Same values as ``repro.configs.llama_3_2_vision_11b``.  The vocabulary
(128,256) exceeds the SPC's 2**16 ceiling, so it serves and trains but
is not coded.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    cross_attn_every=5,
    memory_tokens=4096,        # stub patch-embedding sequence
    memory_dim=4096,
    tp=16,
    dtype="bfloat16",
    grad_accum=8,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-11b-smoke",
    family="vlm",
    n_layers=5,                # one full (4 self + 1 cross) pattern
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    cross_attn_every=5,
    memory_tokens=8,
    memory_dim=64,
    tp=1,
    dtype="float32",
    remat=False,
)
