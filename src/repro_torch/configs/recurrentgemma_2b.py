"""recurrentgemma-2b [hybrid]: 26L d=2560 10H (MQA kv=1) ff=7680 v=256000,
RG-LRU + local attention 1:2 (pattern rec,rec,attn).

Sub-quadratic: runs long_500k (RG-LRU O(1) state + ring-buffer local-attn
cache of 2048).  TP: 10 q heads pad to 16; the single kv head replicates.
[arXiv:2402.19427; hf]

Same values as ``repro.configs.recurrentgemma_2b``.  The full width's
vocabulary (256,000) exceeds the SPC's ceiling of 2**16 at any
``prob_bits``, as in the reference, so only ``SMOKE`` is coded.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    tie_embeddings=True,
    tp=16,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke",
    family="hybrid",
    n_layers=4,                  # one (rec,rec,attn) pattern + 1 tail rec
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    block_pattern=("rec", "rec", "attn"),
    local_window=16,
    tie_embeddings=True,
    tp=1,
    dtype="float32",
    remat=False,
)
