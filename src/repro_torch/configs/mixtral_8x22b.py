"""mixtral-8x22b [moe]: 56L d=6144 48H (GQA kv=8) ff=16384 v=32768,
MoE 8e top-2, SWA.

EP note: 8 experts < tp=16, so experts replicate across model and each
expert's FFN shards over model (per-expert TP); capacity-based dispatch.
[arXiv:2401.04088; hf]

Same values as ``repro.configs.mixtral_8x22b``.  The vocabulary (32,768)
fits the SPC's 2**16 ceiling, so the full width can be coded (at
``prob_bits=16``); an untied ``lm_head`` and a 4,096-position sliding
window.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    n_experts=8,
    topk_experts=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    tp=16,
    dtype="bfloat16",
    grad_accum=8,
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    n_experts=4,
    topk_experts=2,
    sliding_window=16,
    tp=1,
    dtype="float32",
    remat=False,
)
