"""The model surface ``serve/`` and ``train/`` import: config, protocol,
construction, the training loss."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.protocol import (FAMILY_PROTOCOLS, ModelProtocol,
                                         PrefillUnsupportedError, StateSpec,
                                         can_prefill, decode_step,
                                         get_protocol, has_recurrent_state,
                                         init_state, prefill_chunk,
                                         recurrent_state_tree, ring_length,
                                         state_spec, wrap_length)
from repro_torch.models.transformer import (LM, ModelState, encode_memory,
                                            init_model, loss_fn)

# the reference's alias: the protocol's name is init_state (the state need
# not be a transformer "cache")
init_cache = init_state

__all__ = ["ModelConfig", "LM", "ModelState",
           "FAMILY_PROTOCOLS", "ModelProtocol", "PrefillUnsupportedError",
           "StateSpec", "can_prefill", "decode_step", "encode_memory",
           "get_protocol", "has_recurrent_state", "init_cache", "init_model",
           "init_state", "loss_fn", "prefill_chunk", "recurrent_state_tree",
           "ring_length", "state_spec", "wrap_length"]
