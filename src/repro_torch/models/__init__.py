"""The model surface ``serve/`` imports: config, protocol, construction."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.protocol import decode_step, init_state
from repro_torch.models.transformer import DenseLM, KVState, init_model

__all__ = ["ModelConfig", "DenseLM", "KVState", "decode_step", "init_model",
           "init_state"]
