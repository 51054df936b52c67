"""phi3.5-moe-42b-a6.6b [moe]: 32L d=4096 32H (GQA kv=8) ff=6400 v=32064,
MoE 16e top-2.

EP note: 16 experts == tp, so the expert dim shards exactly over the model
axis (expert parallelism); dispatch/combine lower to the EP all-to-all.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]

Same values as ``repro.configs.phi3_5_moe_42b_a6_6b``: full attention (no
window) and an untied ``lm_head``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    head_dim=128,
    n_experts=16,
    topk_experts=2,
    tp=16,
    dtype="bfloat16",
    grad_accum=8,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    head_dim=16,
    n_experts=8,
    topk_experts=2,
    tp=1,
    dtype="float32",
    remat=False,
)
