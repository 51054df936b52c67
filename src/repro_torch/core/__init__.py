"""Integer codec core: SPC tables, encode update, CDF search, lane coder,
wire container, and the scalar oracles (``golden``, ``python_baseline``).

The package re-exports the reference's public surface
(``repro.core.__init__``):

  spc        — BF16 probabilities or logits -> fixed-point tables
  coder      — multi-lane two-stage rANS encode/decode, chunked streams
  search     — the prediction-guided CDF search and its Fig. 4(b) probes
  update     — the two-stage encode update and its renorm records
  predictors — the prediction-guided decoding anchors
"""

from repro_torch.core import constants, search, update
from repro_torch.core.coder import (ChunkedLanes, DecState, EncodedLanes,
                                    EncState, chunk_encoded, chunk_lengths,
                                    decode, decode_chunked, decode_get,
                                    decoder_init, default_cap, encode,
                                    encode_chunked, encode_put,
                                    encoder_flush, encoder_init, find_symbol,
                                    num_chunks)
from repro_torch.core.predictors import (LastValue, NeighborAverage,
                                         Prediction, ZeroPredictor,
                                         model_topk_candidates)
from repro_torch.core.spc import (TableSet, build_tables, decode_lut,
                                  quantize_probs, store_bf16,
                                  tables_from_logits, tables_from_probs)
from repro_torch.core.update import barrett_div, umulhi32

__all__ = [
    "constants", "search", "update", "TableSet", "build_tables",
    "quantize_probs",
    "tables_from_logits", "tables_from_probs", "decode_lut", "store_bf16",
    "EncState", "DecState", "EncodedLanes", "ChunkedLanes", "encode",
    "decode", "encode_chunked", "decode_chunked", "encode_put", "decode_get",
    "encoder_init", "encoder_flush", "decoder_init", "find_symbol",
    "umulhi32", "barrett_div", "default_cap", "num_chunks", "chunk_lengths",
    "chunk_encoded",
    "NeighborAverage", "LastValue", "ZeroPredictor", "Prediction",
    "model_topk_candidates",
]
