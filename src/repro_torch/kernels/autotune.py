"""The kernels' launch plans: path, grid, block and dynamic shared memory
from the shapes of a call.

Port of ``repro.kernels.autotune``.  The reference sizes its Pallas
blocks (``lane_block``, ``t_block``, the encode ring) by a VMEM occupancy
model of the TPU core, which has no meaning on the card.  What it decides
has: each kernel's geometry.  On the H100 that is chosen on the host by
the launchers in ``csrc/``, and this module is their plan in Python — the
one home of the constants the wrappers mirror, each named after the
``constexpr`` it copies (``tests/test_torch_launch.py`` parses the
sources and holds them equal):

  * B1/B5 (``rans_encode.cu`` ``geometry``): one warp a block, one block
    per ``ENCODE_CELLS`` lanes of a chunk; a static table of up to
    ``ENCODE_SMEM_TABLE_MAX`` entries is staged in shared memory, other
    tables are read from device memory.
  * B3/B4 (``rans_decode_lanes.cu`` ``launch``): the slot table (a static
    table with K up to ``SLOT_TABLE_MAX`` and prob_bits up to
    ``MAX_SLOT_BITS``, its layout within ``SMEM_BYTES``; one cell a
    thread) or the warp row count (one cell a warp, rows through a ring in
    shared memory).
  * B2 (``rans_decode_step.cu``): one warp a lane; rows of up to
    ``STEP_REG_K`` entries are held in registers, longer rows are
    bisected in device memory, ``STEP_TREE_LEVELS`` levels read ahead a
    round.
  * B6 (``spc_quantize.cu`` ``launch``): a warp a row for K up to 1,024
    (``E`` entries a lane), a block of ``SPC_BLOCK_WARPS`` warps a row up
    to ``SPC_REG_MAX_K``, and above, up to ``SPC_MAX_K``, a thread-block
    cluster a row (``ceil(K / SPC_WIDE_SEG)`` blocks of
    ``SPC_WIDE_WARPS`` warps, ``SPC_WIDE_E`` entries a thread, a radix
    select of ``SPC_DIGIT_BITS``-bit digits).

B2, B3 and B4 report the code paths a launch ran
(``rans_decode.last_branches``); :meth:`LaunchPlan.branches` is what the
plan expects them to report.  B1, B5 and B6 choose their path on the host
from the shapes alone and report none.
"""

from __future__ import annotations

from dataclasses import dataclass

SMEM_BYTES = 232_448          # kMaxSmem: 227 KB a block may use

# B1/B5, csrc/rans_encode.cu
ENCODE_PLANES = 5             # kPlanes: rcp, rshift, bias, cmpl, x_max
ENCODE_SMEM_TABLE_MAX = 2048  # kSmemTableMax
ENCODE_CELLS = 4              # kCells: lanes a warp owns
ENCODE_BATCH = 8              # kBatch
ENCODE_AHEAD = 6              # kAhead
ENCODE_TILE = 32              # kTile
ENCODE_TILES = 4              # kTiles

# B3/B4, csrc/rans_decode_lanes.cu
MAX_WINDOW = 16               # kMaxWindow
SLOT_TABLE_MAX = 4096         # kSlotTableMax
MAX_SLOT_BITS = 16            # kMaxSlotBits
SLOT_BLOCK = 32               # kSlotBlock
WARP_BLOCK = 128              # kWarpBlock
WIN_TAB = 64                  # kWinTab
ROW_RING = 4                  # kRowRing
ROW_WORDS = 260 + 260 + 36    # kCdfWords + kFreqWords + kCandWords
# the decode kernels' 32-bit NeighborAverage mean is exact below this K
DECODE_MAX_K = 1 << 24

# B2, csrc/rans_decode_step.cu
STEP_WARPS = 4                # kWarps: lanes a block
STEP_REG_K = 4 * 32 * 3 - 4   # kRegK: 380
STEP_TREE_LEVELS = 5          # kTreeLevels

# B6, csrc/spc_quantize.cu
SPC_MAX_K = 1 << 16           # kMaxK
SPC_REG_MAX_K = 16384         # kRegMaxK
SPC_ROW_WARPS = 4             # kRowWarps
SPC_BLOCK_WARPS = 16          # kBlockWarps
SPC_WIDE_WARPS = 16           # kWideWarps
SPC_WIDE_E = 16               # kWideE
SPC_WIDE_SEG = 32 * SPC_WIDE_WARPS * SPC_WIDE_E   # kWideSeg: 8,192
SPC_MAX_CLUSTER = 8           # kMaxCluster
SPC_DIGIT_BITS = 8            # kDigitBits

# each path's search, and its exact bisection where a table has a zero
# frequency (the read-ahead bisection is exact on any row)
_BRANCH = {"slot_table": ("slot_table", "shared_bisect"),
           "warp_rows": ("warp_rows", "warp_bisect"),
           "register_row": ("warp_rows", "warp_bisect"),
           "tree_bisect": ("tree_bisect", "tree_bisect")}


@dataclass(frozen=True)
class LaunchPlan:
    kernel: str
    path: str
    grid: int
    block: int
    smem: int          # dynamic shared memory, bytes
    cluster: int = 1   # blocks a thread-block cluster

    def branches(self, zero_freq: bool = False) -> set:
        """The ``rans_decode.BRANCH_BITS`` names a B2/B3/B4 launch of this
        plan reports: its search, or its exact bisection where a table
        has a zero frequency."""
        return {_BRANCH[self.path][1 if zero_freq else 0]}


def _align16(v: int) -> int:
    return (v + 15) & ~15


def encode_plan(k: int, lanes: int, n_chunks: int,
                layout: str) -> LaunchPlan:
    """B1 (and B5, whose launcher shares its geometry) on ``layout``
    ("static", "perpos" or "lane") tables of K symbols."""
    static = layout == "static" and k <= ENCODE_SMEM_TABLE_MAX
    words = (ENCODE_TILES * ENCODE_TILE * ENCODE_CELLS
             + ENCODE_AHEAD * ENCODE_CELLS * ENCODE_BATCH * ENCODE_PLANES
             + (ENCODE_PLANES * (k + 1) if static else 0))
    return LaunchPlan("rans_encode_lanes",
                      "static_smem" if static else "device_rows",
                      n_chunks * -(-lanes // ENCODE_CELLS), 32, 4 * words)


def _slot_smem(k: int, prob_bits: int) -> int:
    lut_bytes = 1 if k <= 256 else 2
    full = _align16((k + 1) * 8)
    win = _align16(full + k * 2)
    ring = _align16(win + WIN_TAB * WIN_TAB * 2)
    nbytes = _align16(ring + MAX_WINDOW * SLOT_BLOCK * 4)
    lut = nbytes + 4 * 16 * SLOT_BLOCK
    return _align16(lut + (lut_bytes << prob_bits))


def _warp_smem(k: int, tables: bool) -> int:
    rings = (WARP_BLOCK // 32) * ROW_RING * ROW_WORDS * 4
    if not tables:
        return rings
    return _align16(rings + k * 2) + WIN_TAB * WIN_TAB * 2


def decode_plan(k: int, cells: int, layout: str, prob_bits: int,
                window: int | None = None, delta: int = 0,
                kernel: str = "rans_decode_lanes") -> LaunchPlan:
    """B3 (or B4, ``kernel="rans_decode_slab"``) over ``cells`` (chunk,
    lane) cells on ``layout`` tables; ``window`` is the predictor's window
    (None without a predictor) and ``delta`` its search half-width."""
    widest = min(2 * delta + 1, k - 1)
    tables = k <= SLOT_TABLE_MAX and (window is None or widest < WIN_TAB)
    slot = (layout == "static" and tables
            and 1 <= prob_bits <= MAX_SLOT_BITS
            and _slot_smem(k, prob_bits) <= SMEM_BYTES)
    if slot:
        return LaunchPlan(kernel, "slot_table", -(-cells // SLOT_BLOCK),
                          SLOT_BLOCK, _slot_smem(k, prob_bits))
    return LaunchPlan(kernel, "warp_rows", -(-cells // (WARP_BLOCK // 32)),
                      WARP_BLOCK, _warp_smem(k, tables))


def decode_step_plan(k: int, lanes: int) -> LaunchPlan:
    """B2: the row in registers up to ``STEP_REG_K`` entries, else the
    read-ahead bisection of the row in device memory."""
    return LaunchPlan("rans_decode_step",
                      "register_row" if k <= STEP_REG_K else "tree_bisect",
                      -(-lanes // STEP_WARPS), 32 * STEP_WARPS, 0)


def spc_plan(b: int, k: int) -> LaunchPlan:
    """B6 on ``b`` rows of K probabilities."""
    if k > SPC_MAX_K:
        raise ValueError(f"K = {k} exceeds the kernel's {SPC_MAX_K}")
    if k <= 1024:
        e = max(1, -(-k // 32))
        e = 1 << (e - 1).bit_length()
        return LaunchPlan("spc_quantize", f"warp_e{e}",
                          -(-b // SPC_ROW_WARPS), 32 * SPC_ROW_WARPS, 0)
    if k <= SPC_REG_MAX_K:
        return LaunchPlan("spc_quantize", "block", b,
                          32 * SPC_BLOCK_WARPS, 0)
    c = -(-k // SPC_WIDE_SEG)
    # kWideSmem: a segment's keys and f0, 4 bytes each
    return LaunchPlan("spc_quantize", "cluster", b * c, 32 * SPC_WIDE_WARPS,
                      8 * SPC_WIDE_SEG, cluster=c)
