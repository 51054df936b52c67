"""llama3-405b [dense]: 126L d=16384 128H (GQA kv=8) ff=53248 v=128256.

Trained with gradient accumulation, BF16 moments and gradients, and
blockwise attention (an online softmax over ``attn_block`` keys); its
``SMOKE`` also chunks the loss.  [arXiv:2407.21783; unverified]

Same values as ``repro.configs.llama3_405b``, its sequence-parallel
``act_pspec`` included (``scan_layers`` has no port counterpart).  Its
vocabulary exceeds the SPC's ceiling of 2**16, so only ``SMOKE`` can be
coded.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    tp=16,
    dtype="bfloat16",
    grad_accum=8,
    moment_dtype="bfloat16",
    grad_dtype="bfloat16",
    attn_impl="blockwise",
    act_pspec=(("pod", "data"), "model", None),  # SP residuals
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke",
    family="dense",
    n_layers=3,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=16,
    tp=1,
    dtype="float32",
    grad_accum=2,
    logits_chunk=8,
    attn_impl="blockwise",
    attn_block=8,
    remat=False,
)
