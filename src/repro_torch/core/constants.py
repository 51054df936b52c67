"""Fixed-point / rANS constants shared by every layer of the RAS pipeline.

A copy of ``repro.core.constants`` (the port imports nothing from the JAX
package).  The paper (Sec. IV-A/B) fixes:
  - rANS state: 32-bit unsigned integer
  - re-normalization radix R = 2**PROB_BITS (probability total)
  - byte-level re-normalization (radix-256 emission)
  - state invariant  s in [RANS_L, 256 * RANS_L)

With RANS_L = 2**23 and PROB_BITS <= 16 at most ``MAX_RENORM_STEPS`` bytes
move per symbol per direction, so the renorm loop is a fixed 2-step masked
pipeline.
"""

from __future__ import annotations

import math

# Probability precision: frequencies sum to 2**PROB_BITS exactly.
PROB_BITS: int = 14
# Lower bound of the canonical state interval [L, 256L).
RANS_L: int = 1 << 23
# Byte renormalization: base-256 digits.
RENORM_SHIFT: int = 8
RENORM_BASE: int = 1 << RENORM_SHIFT
BYTE_MASK: int = RENORM_BASE - 1
# State is uint32; the canonical upper bound 256*L = 2**31 < 2**32.
STATE_BITS: int = 32
STATE_UPPER: int = RANS_L * RENORM_BASE  # exclusive
U32_MASK: int = (1 << 32) - 1

# Provable bound on byte moves per symbol per direction (DESIGN.md §4).
MAX_RENORM_STEPS: int = 2

# Default lane count of the multi-lane fabric.
DEFAULT_LANES: int = 128


def x_max_scale(prob_bits: int) -> int:
    """Per-unit-frequency renorm threshold: x_max(f) = x_max_scale * f."""
    return (RANS_L >> prob_bits) << RENORM_SHIFT


def check_prob_bits(prob_bits: int) -> None:
    if not (8 <= prob_bits <= 16):
        raise ValueError(f"PROB_BITS must be in [8, 16], got {prob_bits}")
    scale = x_max_scale(prob_bits)
    need = max(0, math.ceil((31 - math.floor(math.log2(scale))) / 8))
    assert need <= MAX_RENORM_STEPS, (prob_bits, scale, need)
