#!/usr/bin/env python3
"""The LM slice's compress and decompress rates of two checkouts, in turns.

    git archive <commit> | tar -x -C build/parent
    python3 tools/slice_turns.py build/parent .

For each checkout given (its ``src/`` on the path, its kernels built into
its own ``build/``), a fresh process drives ``chip_smoke.py``'s slice: the
full-width ``ras-pimc`` model (random seeded weights), 128 lanes x 1000
``token_stream`` tokens, chunk 256, ``lm_compress_chunked`` ->
``pack_chunked`` -> ``parse_chunked`` -> ``lm_decompress_chunked`` with
``backend="kernel"``, twice, and reports the second run's rates (host
wall around work ending in ``torch.cuda.synchronize()``).  The checkouts
run in turns (A, B, B, A), all on one card in one call, and every run's
container bytes must agree.  Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

LANES, T, CHUNK = 128, 1000, 256


def worker() -> None:
    import torch
    from repro_torch.configs.ras_pimc import CONFIG
    from repro_torch.core import bitstream
    from repro_torch.data.pipeline import token_stream
    from repro_torch.device import configure_cuda_numerics, resolve_device
    from repro_torch.models import init_model
    from repro_torch.serve import compress

    configure_cuda_numerics()
    dev = resolve_device(None)
    model = init_model(CONFIG, seed=0, device=dev)
    tokens = token_stream(CONFIG.vocab_size, (LANES, T), seed=0)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = compress.lm_compress_chunked(model, tokens, CHUNK,
                                          backend="kernel")
        torch.cuda.synchronize()
        t_comp = time.perf_counter() - t0
        blob = bitstream.pack_chunked(*st.chunks, chunk_size=CHUNK,
                                      n_symbols=T)
        cs = bitstream.parse_chunked(blob)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sym, _ = compress.lm_decompress_chunked(model, cs, T, CHUNK,
                                                backend="kernel")
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        if not (sym.cpu().numpy() == tokens).all():
            raise RuntimeError("slice round trip not exact")
    print(json.dumps({"compress": LANES * T / t_comp,
                      "decompress": LANES * T / t_dec,
                      "blob_sha256": hashlib.sha256(blob).hexdigest()}))


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        worker()
        return 0
    trees = [Path(a).resolve() for a in sys.argv[1:]]
    if len(trees) != 2:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    digests = set()
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker"],
            cwd=tree, env={**os.environ, "PYTHONPATH": str(tree / "src")},
            capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"{tree}: slice run failed\n{out.stderr}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        digests.add(res.pop("blob_sha256"))
        print(f"{tree}: compress {res['compress']:.1f} symbols/s, "
              f"decompress {res['decompress']:.1f} symbols/s", flush=True)
    if len(digests) != 1:
        raise RuntimeError("the checkouts' containers differ")
    print("every run's container is byte-identical", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
