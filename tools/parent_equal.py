#!/usr/bin/env python3
"""The unplaced outputs of two checkouts, byte for byte, on the CPU.

    git archive <commit> | tar -x -C build/parent
    python3 tools/parent_equal.py build/parent .

For each checkout given (its ``src/`` on the path), a fresh process runs
the ``ras-pimc`` SMOKE model (seeded random weights) on the CPU and
hashes what it puts out:

- the v2 containers of ``lm_compress_chunked`` (4 lanes x 40 tokens,
  chunk 16: a short last chunk) on the ``kernel`` and ``coder`` backends,
  and the tokens and per-lane probes of their ``lm_decompress_chunked``
  on the same backend and on ``two_pass``;
- the blobs, tokens and probes of a ``BatchEngine`` (2 slots, chunk 8,
  ``max_len`` 32) on both step backends, with prefill and without, over
  three requests of 29, 17 and 32 tokens and their decompress;
- the logits of 20 ``decode_step`` positions on a ring of 8 slots (it
  wraps twice), 3 rows;
- the unplaced training path of the SMOKE archs of every family in
  ``TRAIN_ARCHS`` (``qwen3-4b``, ``recurrentgemma-2b`` and the vlm and
  audio archs also under ``remat``, phi3.5-moe also with the dense
  schedule): ``forward``'s hidden states and logits, ``grads_fn``'s loss
  and gradients, and two ``make_train_step`` steps' metrics and
  parameters, on a 4 x 16 ``train_batch`` (with its memory or encoder
  inputs), torch on one thread; for an arch of another family than
  ``dense`` also the logits of 20 ``decode_step`` positions of 3 rows on
  a ring of 8 slots (against the batch's memory, or the memory encoded
  from its encoder inputs) and the final state's leaves;
- on a world-1 gloo pod mesh, the int8 ``compressed_psum_tree`` of seeded
  leaves with residuals and three cross-pod steps of ``ras-pimc`` SMOKE.

It prints each checkout's digests and exits nonzero unless every one
agrees.  ``--changed KEY`` (repeatable) names a digest that a change
alters on purpose: it must differ, and every other must agree.  A change
of the cross-pod step's quantization alters ``"cross-pod step"`` alone
(``"int8 reduce"``, the reduce of leaves each their own group, stays):

    python3 tools/parent_equal.py build/parent . --changed "cross-pod step"

Needs no card and no ``nvcc``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

LANES, T, CHUNK = 4, 40, 16
TRAIN_ARCHS = (("ras-pimc", {}), ("qwen1.5-4b", {}), ("qwen3-4b", {}),
               ("qwen3-4b", {"remat": True}), ("llama3-405b", {}),
               ("mixtral-8x22b", {}), ("phi3.5-moe-42b-a6.6b", {}),
               ("phi3.5-moe-42b-a6.6b", {"moe_impl": "dense"}),
               ("mamba2-130m", {}), ("recurrentgemma-2b", {}),
               ("recurrentgemma-2b", {"remat": True}),
               ("llama-3.2-vision-11b", {}),
               ("llama-3.2-vision-11b", {"remat": True}),
               ("seamless-m4t-large-v2", {}),
               ("seamless-m4t-large-v2", {"remat": True}))


def _digest(*arrays) -> str:
    import numpy as np
    h = hashlib.sha256()
    for a in arrays:
        h.update(a if isinstance(a, bytes) else np.ascontiguousarray(a)
                 .tobytes())
    return h.hexdigest()[:16]


def worker() -> None:
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import bitstream
    from repro_torch.data.pipeline import token_stream
    from repro_torch.models import decode_step, init_model, init_state
    from repro_torch.serve import compress
    from repro_torch.serve.engine import BatchEngine

    cfg = get_smoke_config("ras-pimc")
    model = init_model(cfg, seed=0, device="cpu")
    tokens = token_stream(cfg.vocab_size, (LANES, T), seed=0)
    out = {}
    for backend in ("kernel", "coder"):
        st = compress.lm_compress_chunked(model, tokens, CHUNK,
                                          backend=backend, device="cpu")
        blob = bitstream.pack_chunked(*st.chunks, chunk_size=CHUNK,
                                      n_symbols=T)
        out[f"container {backend}"] = _digest(blob)
        for dec in (backend, "two_pass"):
            sym, _, probes = compress.lm_decompress_chunked(
                model, bitstream.parse_chunked(blob), T, CHUNK,
                backend=dec, lane_probes=True, device="cpu")
            out[f"decode {dec} of {backend}"] = _digest(
                sym.cpu().numpy(), np.asarray(probes.cpu()))

    reqs = [token_stream(cfg.vocab_size, (LANES, n), seed=1 + i)
            for i, n in enumerate((29, 17, 32))]
    for step_backend in ("coder", "kernel"):
        for prefill in ("auto", "off"):
            eng = BatchEngine(model, slots=2, lanes=LANES, chunk_size=8,
                              max_len=32, step_backend=step_backend,
                              prefill=prefill, device="cpu")
            rids = [eng.submit_compress(t) for t in reqs]
            res = eng.run(clock="virtual")
            blobs = [res[r].blob for r in rids]
            rids = [eng.submit_decompress(b) for b in blobs]
            res = eng.run(clock="virtual")
            out[f"engine {step_backend} prefill={prefill}"] = _digest(
                *blobs, *(res[r].tokens for r in rids),
                *(res[r].lane_probes for r in rids))

    state = init_state(model, 3, 8)
    tok = torch.zeros((3, 1), dtype=torch.int64)
    logits = []
    for pos in range(20):
        lg = decode_step(model, state, tok, pos)
        logits.append(lg.float().numpy())
        tok = lg.argmax(-1, keepdim=True)
    out["wrapped-ring logits"] = _digest(*logits)
    out.update(train_digests())
    out.update(crosspod_digests())
    print(json.dumps(out))


def crosspod_digests() -> dict:
    """The unplaced int8 reduce and cross-pod step on a world-1 gloo pod
    mesh: ``compressed_psum_tree`` of seeded leaves with residuals, and
    three steps of ``ras-pimc`` SMOKE from step 100 (metrics, parameters,
    residuals)."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import train_batch
    from repro_torch.models import init_model
    from repro_torch.parallel import collectives as col
    from repro_torch.train import train_loop

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", store=dist.FileStore(f"{d}/s", 1),
                                rank=0, world_size=1)
        try:
            pod = col.pod_mesh(device="cpu")
            rng = np.random.default_rng(7)
            tree = {k: torch.as_tensor(rng.normal(size=s).astype(
                np.float32) * 10.0 ** -i) for i, (k, s) in enumerate(
                    (("a", (5, 7)), ("b", (33,)), ("c", (2, 3, 4))))}
            err = {k: torch.as_tensor(rng.normal(size=tuple(v.shape))
                                      .astype(np.float32) * 1e-3)
                   for k, v in tree.items()}
            red, new = col.compressed_psum_tree(tree, pod, err)
            out = {"int8 reduce": _digest(
                *(t.numpy() for t in red.values()),
                *(t.numpy() for t in new.values()))}
            cfg = get_smoke_config("ras-pimc").with_(grad_accum=1)
            model = init_model(cfg, seed=0, device="cpu")
            state = train_loop.init_train_state(model, with_error=True)
            state = state._replace(step=torch.full_like(state.step, 100))
            step = train_loop.make_train_step(cfg, base_lr=3e-3,
                                              compress_crosspod=True,
                                              mesh=pod)
            metrics = []
            for i in range(3):
                state, m = step(state, train_batch(cfg, 4, 16, step=i))
                metrics += [m["loss"], m["grad_norm"]]
            out["cross-pod step"] = _digest(
                *(t.numpy() for t in metrics),
                *(p.detach().numpy() for p in model.parameters()),
                *(e.numpy() for e in state.error.values()))
        finally:
            dist.destroy_process_group()
    return out


def train_digests() -> dict:
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import train_batch
    from repro_torch.models import encode_memory, init_model
    from repro_torch.train import train_loop

    torch.set_num_threads(1)
    out = {}
    for arch, over in TRAIN_ARCHS:
        cfg = get_smoke_config(arch).with_(**over)
        model = init_model(cfg, seed=0, device="cpu")
        batch = train_batch(cfg, 4, 16, step=0)
        mem = {k: torch.as_tensor(batch[k]) for k in ("memory", "enc_inputs")
               if k in batch}
        with torch.no_grad():
            x, _ = model(torch.as_tensor(batch["tokens"],
                                         dtype=torch.int64), **mem)
            lg = model._logits(x)
        loss, grads = train_loop.grads_fn(model, batch)
        state = train_loop.init_train_state(model)
        step = train_loop.make_train_step(cfg, base_lr=3e-3)
        metrics = []
        for i in (1, 2):
            state, m = step(state, train_batch(cfg, 4, 16, step=i))
            metrics += [m["loss"], m["grad_norm"]]
        out[f"train {arch} {over}"] = _digest(
            x.numpy(), lg.numpy(), loss.numpy(),
            *(g.numpy() for g in grads.values()),
            *(t.numpy() for t in metrics),
            *(p.detach().numpy() for p in model.parameters()))
        if cfg.family != "dense":
            memory = None
            if "memory" in mem:
                memory = mem["memory"][:3]
            elif "enc_inputs" in mem:
                with torch.no_grad():
                    memory = encode_memory(model, mem["enc_inputs"][:3])
            st = model.init_state(3, 8)
            tok = torch.ones((3, 1), dtype=torch.int64)
            logits = []
            for pos in range(20):
                lg = model.decode_step(st, tok, pos, memory=memory)
                logits.append(lg.numpy())
                tok = lg.argmax(-1, keepdim=True)
            out[f"decode {arch} {over}"] = _digest(
                *logits, *(t.numpy() for t in st.leaves().values()))
    return out


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] == "--worker":
        worker()
        return 0
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=(
        argparse.RawDescriptionHelpFormatter))
    ap.add_argument("trees", nargs=2, type=Path)
    ap.add_argument("--changed", action="append", default=[])
    args = ap.parse_args()
    trees, changed = [p.resolve() for p in args.trees], set(args.changed)
    got = []
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        r = subprocess.run([sys.executable, __file__, "--worker"], env=env,
                           cwd=tree, capture_output=True, text=True,
                           timeout=900)
        if r.returncode != 0:
            print(r.stdout + r.stderr, file=sys.stderr)
            return 1
        got.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(f"{tree}: {json.dumps(got[-1])}")
    if changed - set(got[0]):
        ap.error(f"no such digest: {sorted(changed - set(got[0]))}")
    ok = set(got[0]) == set(got[1])
    for key in got[0]:
        same = got[0][key] == got[1].get(key)
        ok &= same != (key in changed)
        mark = "equal" if same else "DIFFER"
        print(f"  {key}: {mark}"
              + (" (changed on purpose)" if key in changed else ""))
    print("every output as expected" if ok else "outputs differ")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
