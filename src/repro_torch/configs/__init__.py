"""Model configurations ported so far."""

from repro_torch.configs import ras_pimc

__all__ = ["ras_pimc"]
