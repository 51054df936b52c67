"""Model configurations ported so far, and the registry's lookups."""

from repro_torch.configs import (llama3_405b, llama_3_2_vision_11b,
                                 mamba2_130m, mixtral_8x22b,
                                 phi3_5_moe_42b_a6_6b, qwen1_5_4b, qwen3_4b,
                                 qwen3_32b, ras_pimc, recurrentgemma_2b,
                                 seamless_m4t_large_v2)
from repro_torch.configs.registry import (ARCH_IDS, PORTED,
                                          SERVE_SMOKE_ARCHS, SHAPES,
                                          ShapeSpec, get_config,
                                          get_protocol, get_smoke_config,
                                          grid, shape_applicable)

__all__ = ["ARCH_IDS", "PORTED", "SERVE_SMOKE_ARCHS", "SHAPES", "ShapeSpec",
           "get_config", "get_protocol", "get_smoke_config", "grid",
           "shape_applicable", "llama3_405b",
           "llama_3_2_vision_11b", "mamba2_130m", "mixtral_8x22b",
           "phi3_5_moe_42b_a6_6b", "qwen1_5_4b", "qwen3_4b", "qwen3_32b",
           "ras_pimc", "recurrentgemma_2b", "seamless_m4t_large_v2"]
