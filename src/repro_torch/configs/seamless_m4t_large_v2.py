"""seamless-m4t-large-v2 [audio]: 24L d=1024 16H (kv=16) ff=8192 v=256206,
enc-dec, multimodal.

The audio frontend is a STUB: the caller supplies precomputed frame
embeddings (B, memory_tokens, d_model), which a 24-layer bidirectional
encoder turns into the memory of the text decoder's cross attention.
[arXiv:2308.11596; hf]

Same values as ``repro.configs.seamless_m4t_large_v2``.  The vocabulary
(256,206) exceeds the SPC's 2**16 ceiling, so it serves and trains but
is not coded.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,                 # decoder layers (self + cross + MLP)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    encoder_layers=24,
    memory_tokens=1024,          # stub speech-frame sequence
    memory_dim=1024,
    block_pattern=("dec",),
    tp=16,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="seamless-m4t-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    encoder_layers=2,
    memory_tokens=8,
    memory_dim=64,
    block_pattern=("dec",),
    tp=1,
    dtype="float32",
    remat=False,
)
