"""ras-pimc: the paper's compact autoregressive probability model over
8-bit symbols (alphabet 256), feeding the SPC + rANS fabric.  Same values
as ``repro.configs.ras_pimc``."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="ras-pimc",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=256,
    head_dim=64,
    tie_embeddings=True,
    tp=1,
)

SMOKE = CONFIG.with_(name="ras-pimc-smoke", n_layers=2, d_model=64,
                     d_ff=128, head_dim=16)
