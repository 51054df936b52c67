"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

The build module ``_build`` is imported lazily by the CUDA branches only.
:data:`LAUNCHES` counts each kernel's launches: a wrapper adds one where
it launches its kernel and nowhere else, so a run can show which kernels
its path went through.  :data:`BRANCHES` keeps, per kernel that reports
one, the device tensor into which its last launch ORed the bits of the
code paths it ran (read without a host sync until someone looks).
"""

LAUNCHES = {"rans_encode_lanes": 0, "rans_decode_step": 0,
            "rans_decode_lanes": 0, "rans_decode_slab": 0,
            "rans_encode_records": 0, "spc_quantize": 0}

BRANCHES: dict = {}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
