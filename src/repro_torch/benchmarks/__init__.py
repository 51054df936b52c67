"""The reference's lane and chunk sweeps on the port, each a module with
``run()`` (the reference's signature and defaults, plus ``device``) and
``main(argv=None)``:

    python -m repro_torch.benchmarks.bench_lanes [--device cpu] [--out X]
    python -m repro_torch.benchmarks.bench_chunked [--device cpu] [--out X]
"""

import time

import torch


def timed(fn, dev: torch.device, warmup: bool = True):
    """``(seconds, result)`` of one call of ``fn``, after one untimed call
    when ``warmup`` (the reference's warm-then-time); on the card the time
    ends in ``torch.cuda.synchronize()``."""
    def call():
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out

    if warmup:
        call()
    t0 = time.perf_counter()
    out = call()
    return time.perf_counter() - t0, out


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
