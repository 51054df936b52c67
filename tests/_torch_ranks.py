"""Rank workers of the port's multi-rank CPU tests: torch and the port
only, never JAX.

    python tests/_torch_ranks.py <suite> <rank> <world> <store> <out>

Each rank pins torch to one thread, joins a gloo group of ``world`` ranks
over the ``FileStore`` at ``store`` (no TCP store: gloo's own pairs run over
loopback) with a 60 s timeout, runs the suite and writes its results to
``<out>/rank<rank>.npz``: the arrays every rank returns, and for each case
that must raise, the error as ``"<type>: <message>"``.  The test files
spawn the ranks with :class:`RankJob`, which waits with a timeout and kills them all if any rank fails or hangs, then compare the ranks' results
with each other and with JAX's on the same seeded inputs (built here with
numpy, so both sides see the same cases).  A suite can also run in the
test's own process on a world-1 group: call it with ``rank=0, world=1``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "src"

# the chunked cases: 4 full chunks of 16 and a ragged tail of 6
K, LANES, T, CHUNK, TOPK = 40, 4, 70, 16, 2
LAYOUTS = ("static", "perpos", "lane")
# a small bench_chunked grid: 4 and 2 full chunks, and one ragged chunk
BENCH_POINT = dict(t=256, chunk_sizes=(64, 128, 512), lane_counts=(8,))
# the LM cases: ras-pimc SMOKE, 4 lanes x 40 tokens, chunk 16
LM_LANES, LM_T, LM_CHUNK = 4, 40, 16


def chunk_case(layout: str, seed: int, t: int = T):
    """Seeded ``(probs, symbols (lanes, t), candidates (t, lanes, TOPK))``:
    probabilities for a static ``(K,)``, per-position ``(t, K)`` or
    per-lane ``(t, lanes, K)`` table."""
    from repro_torch.data.pipeline import candidate_planes
    rng = np.random.default_rng(seed)
    shape = {"static": (), "perpos": (t,), "lane": (t, LANES)}[layout]
    probs = rng.dirichlet(np.full(K, 0.5), size=shape or None).astype(
        np.float32)
    syms = rng.integers(0, K, (LANES, t)).astype(np.int32)
    return probs, syms, candidate_planes(syms, K, TOPK, 0.6, seed=seed)


def truncate_last_chunk(buf, start, length, d: int):
    """Drop ``d`` tail bytes from every lane of the last chunk (the bytes
    its decode reads last), keeping the right-aligned layout."""
    buf, start, length = (np.array(np.asarray(a)) for a in
                          (buf, start, length))
    c, cap = buf.shape[0] - 1, buf.shape[2]
    for lane in range(buf.shape[1]):
        row = buf[c, lane].copy()
        buf[c, lane] = 0
        buf[c, lane, start[c, lane] + d:] = row[start[c, lane]:cap - d]
    start[c] += d
    length[c] -= d
    return buf, start, length


def _np(t):
    return t.detach().cpu().numpy()


def _error(fn) -> np.ndarray:
    """``"<type>: <message>"`` of what ``fn()`` raises, ``""`` if nothing."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test reads the type
        return np.array(f"{type(e).__name__}: {e}")
    return np.array("")


def _put(res: dict, key: str, out) -> None:
    """A decode's ``(symbols, avg[, lane probes])`` or an encode's planes
    under ``key/<field>``."""
    names = (out._fields if hasattr(out, "_fields")
             else ("sym", "avg", "lane_probes")[:len(out)])
    for name, a in zip(names, out):
        res[f"{key}/{name}"] = _np(a)


# ---------------------------------------------------------------------------
# suites
# ---------------------------------------------------------------------------

def chunked_suite(rank: int, world: int) -> dict:
    """``parallel.encode_chunked`` / ``decode_chunked`` on a chunk mesh of
    ``world`` ranks: each layout and backend, with candidates, from dense
    chunks and from a ``ContainerSlab``, a predictor, an indivisible chunk
    count, an undersized cap and a truncated stream; ``bench_chunked``
    with a process group up."""
    import torch
    from repro_torch.benchmarks import bench_chunked
    from repro_torch.core import bitstream, predictors, spc
    from repro_torch.parallel import chunked as pc

    mesh = pc.chunk_mesh(device="cpu")
    res = {"size": np.array(mesh.size), "rank": np.array(mesh.rank)}
    for i, layout in enumerate(LAYOUTS):
        probs, syms, cands = chunk_case(layout, 70 + i)
        tbl = spc.tables_from_probs(torch.as_tensor(probs))
        sym_t, cand_t = torch.as_tensor(syms), torch.as_tensor(cands)
        for be in ("coder", "kernel"):
            key = f"{layout}/{be}"
            ch = pc.encode_chunked(sym_t, tbl, CHUNK, mesh=mesh, backend=be)
            _put(res, f"{key}/enc", ch)
            _put(res, f"{key}/dec", pc.decode_chunked(
                ch, T, tbl, CHUNK, mesh=mesh, backend=be,
                candidates=cand_t, lane_probes=True))
            blob = bitstream.pack_chunked(*ch, chunk_size=CHUNK,
                                          n_symbols=T)
            _put(res, f"{key}/slab", pc.decode_chunked(
                bitstream.parse_chunked(blob), T, tbl, CHUNK, mesh=mesh,
                backend=be, candidates=cand_t, lane_probes=True))
    probs, syms, _ = chunk_case("static", 80)
    tbl = spc.tables_from_probs(torch.as_tensor(probs))
    sym_t = torch.as_tensor(syms)
    for be in ("coder", "kernel"):
        ch = pc.encode_chunked(sym_t, tbl, CHUNK, mesh=mesh, backend=be)
        _put(res, f"predictor/{be}/dec", pc.decode_chunked(
            ch, T, tbl, CHUNK, mesh=mesh, backend=be, lane_probes=True,
            predictor=predictors.NeighborAverage(2, 4)))
        # 3 full chunks of 20: placed on one rank only, else the fallback
        ch = pc.encode_chunked(sym_t, tbl, 20, mesh=mesh, backend=be)
        _put(res, f"indivisible/{be}/enc", ch)
        _put(res, f"indivisible/{be}/dec", pc.decode_chunked(
            ch, T, tbl, 20, mesh=mesh, backend=be, lane_probes=True))
        _put(res, f"overflow/{be}/enc", pc.encode_chunked(
            sym_t, tbl, CHUNK, mesh=mesh, cap=12, backend=be))
    # 4 full chunks, the last one truncated by 2 bytes a lane
    probs, syms, _ = chunk_case("static", 81, t=64)
    tbl = spc.tables_from_probs(torch.as_tensor(probs))
    for be in ("coder", "kernel"):
        ch = pc.encode_chunked(torch.as_tensor(syms), tbl, CHUNK, mesh=mesh,
                               backend=be)
        _put(res, f"truncated/{be}/dec", pc.decode_chunked(
            ch, 64, tbl, CHUNK, mesh=mesh, backend=be))
        cut = bitstream.ChunkedLanes(*(torch.as_tensor(a) for a in
                                       truncate_last_chunk(*ch[:3], 2)))
        res[f"truncated/{be}/error"] = _error(lambda: pc.decode_chunked(
            cut, 64, tbl, CHUNK, mesh=mesh, backend=be))
    for p in bench_chunked.run(**BENCH_POINT, device="cpu", warmup=False):
        res[f"bench/{p['name']}/devices"] = np.array(p["devices"])
        res[f"bench/{p['name']}/bits"] = np.array(p["bits_per_symbol"])
    return res


def _smoke_model():
    from repro_torch.configs.ras_pimc import SMOKE
    from repro_torch.models import init_model
    return init_model(SMOKE, seed=0, device="cpu")


def lm_tokens(seed: int = 17) -> np.ndarray:
    from repro_torch.configs.ras_pimc import SMOKE
    from repro_torch.data.pipeline import token_stream
    return token_stream(SMOKE.vocab_size, (LM_LANES, LM_T), seed=seed)


def engine_tokens() -> list[np.ndarray]:
    from repro_torch.configs.ras_pimc import SMOKE
    from repro_torch.data.pipeline import token_stream
    return [token_stream(SMOKE.vocab_size, (2, t), seed=50 + i)
            for i, t in enumerate((20, 12, 16))]


def lm_suite(rank: int, world: int) -> dict:
    """The LM paths on a lane mesh and a chunk mesh of ``world`` ranks:
    compress priced per lane slab (monolithic and chunked), the fused
    decode of those containers and of the unplaced container, two-pass
    pass 2 on the chunk mesh, the reference's refusals, a truncated
    container, and ``BatchEngine(mesh=)`` (placed at ``slots=2``, the
    fallback at ``slots=1``; the cycle clock and the wall clock)."""
    import torch
    from repro_torch.core import bitstream
    from repro_torch.parallel import chunked as pc
    from repro_torch.serve import compress
    from repro_torch.serve.engine import BatchEngine

    model = _smoke_model()
    lane, chunk = pc.lane_mesh(device="cpu"), pc.chunk_mesh(device="cpu")
    toks = lm_tokens()
    res = {}
    whole = compress.lm_compress_chunked(model, toks, LM_CHUNK,
                                         backend="kernel", device="cpu")
    _put(res, "whole", whole.chunks)
    for be in ("coder", "kernel"):
        st = compress.lm_compress_chunked(model, toks, LM_CHUNK, backend=be,
                                          mesh=lane)
        _put(res, f"placed/{be}", st.chunks)
        res[f"placed/{be}/bits"] = _np(st.bits_per_symbol)
    placed = compress.lm_compress_chunked(model, toks, LM_CHUNK,
                                          backend="kernel", mesh=lane).chunks
    _put(res, "fused/placed", compress.lm_decompress_chunked(
        model, placed, LM_T, LM_CHUNK, backend="kernel", mesh=lane,
        lane_probes=True))
    blob = bitstream.pack_chunked(*whole.chunks, chunk_size=LM_CHUNK,
                                  n_symbols=LM_T)
    _put(res, "fused/whole_slab", compress.lm_decompress_chunked(
        model, bitstream.parse_chunked(blob), LM_T, LM_CHUNK,
        backend="kernel", mesh=lane, lane_probes=True))
    _put(res, "two_pass/chunks", compress.lm_decompress_chunked(
        model, whole.chunks, LM_T, LM_CHUNK, backend="two_pass", mesh=chunk))
    mono = compress.lm_compress(model, toks, backend="kernel", mesh=lane)
    _put(res, "mono/enc", mono.enc)
    _put(res, "mono/dec", compress.lm_decompress(
        model, mono.enc, LM_T, backend="kernel", mesh=lane,
        lane_probes=True))
    cut = bitstream.ChunkedLanes(*(torch.as_tensor(a) for a in
                                   truncate_last_chunk(*placed[:3], 3)))
    res["truncated/error"] = _error(lambda: compress.lm_decompress_chunked(
        model, cut, LM_T, LM_CHUNK, backend="kernel", mesh=lane))
    for key, kw in (("lane_probes", dict(backend="two_pass", mesh=chunk,
                                         lane_probes=True)),
                    ("chunk_mesh_fused", dict(backend="kernel", mesh=chunk)),
                    ("coder_mesh", dict(backend="coder", mesh=chunk))):
        res[f"refuse/{key}"] = _error(lambda: compress.lm_decompress_chunked(
            model, whole.chunks, LM_T, LM_CHUNK, **kw))
    res["refuse/mono_coder_mesh"] = _error(lambda: compress.lm_decompress(
        model, mono.enc, LM_T, backend="coder", mesh=lane))
    # the engine: two slots of 2 lanes, three compress requests (a ragged
    # tail among them), then the first blob decompressed
    for slots, clock in ((2, "virtual"), (2, "wall"), (1, "virtual")):
        eng = BatchEngine(model, slots=slots, lanes=2, chunk_size=8,
                          max_len=24, step_backend="kernel", mesh=lane)
        key = f"engine/s{slots}/{clock}"
        res[f"{key}/placed"] = np.array(eng.mesh is not None)
        res[f"{key}/local_rows"] = np.array(eng.local_rows)
        rids = [eng.submit_compress(t, arrival=float(i))
                for i, t in enumerate(engine_tokens())]
        out = eng.run(clock=clock)
        for i, rid in enumerate(rids):
            res[f"{key}/blob{i}"] = np.frombuffer(out[rid].blob, np.uint8)
        dec = eng.submit_decompress(out[rids[0]].blob)
        got = eng.run()[dec]
        res[f"{key}/tokens"] = got.tokens
        res[f"{key}/lane_probes"] = got.lane_probes
        res[f"{key}/prefill_cycles"] = np.array(eng.prefill_cycles)
        if clock == "virtual" and slots == 2:
            st = eng._states[eng._s0]        # the rank's one slot
            res[f"{key}/state_k"], res[f"{key}/state_v"] = _np(st.k), _np(
                st.v)
    return res


def collectives_suite(rank: int, world: int) -> dict:
    """``compressed_psum`` / ``compressed_psum_tree`` with this rank's
    seeded inputs (the tree's leaves alone and in groups), ``pmean``, and
    (4 ranks) ``hierarchical_psum`` over 2 x 2 groups."""
    import torch
    import torch.distributed as dist
    from repro_torch.parallel import collectives as col, make_mesh

    pod = col.pod_mesh(device="cpu")
    res = {}
    x, err = psum_inputs(rank)
    out, new_err = col.compressed_psum(torch.as_tensor(x), pod,
                                       torch.as_tensor(err))
    res["psum/out"], res["psum/err"] = _np(out), _np(new_err)
    tree, etree = tree_inputs(rank)
    out, errs = col.compressed_psum_tree(
        {k: torch.as_tensor(v) for k, v in tree.items()}, pod,
        {k: torch.as_tensor(v) for k, v in etree.items()})
    for k in tree:
        res[f"tree/out/{k}"], res[f"tree/err/{k}"] = _np(out[k]), _np(
            errs[k])
    tree, etree, groups = group_inputs(rank)
    out, errs = col.compressed_psum_tree(
        {k: torch.as_tensor(v) for k, v in tree.items()}, pod,
        {k: torch.as_tensor(v) for k, v in etree.items()}, groups=groups)
    for k in tree:
        res[f"groups/out/{k}"], res[f"groups/err/{k}"] = _np(out[k]), _np(
            errs[k])
    res["pmean"] = _np(col.pmean(torch.tensor(float(rank) + 0.5), pod))
    if world == 4:
        inner = [dist.new_group([0, 1]), dist.new_group([2, 3])][rank // 2]
        outer = [dist.new_group([0, 2]), dist.new_group([1, 3])][rank % 2]
        h = col.hierarchical_psum(
            torch.arange(6, dtype=torch.float32) * (rank + 1),
            make_mesh("data", inner, "cpu"), make_mesh("pod", outer, "cpu"))
        res["hier"] = _np(h)
    return res


def psum_inputs(rank: int):
    rng = np.random.default_rng(300 + rank)
    return (rng.normal(size=(257,)).astype(np.float32),
            (rng.normal(size=(257,)) * 1e-2).astype(np.float32))


def tree_inputs(rank: int):
    rng = np.random.default_rng(400 + rank)
    shapes = {"a": (3, 5), "b": (17,), "c": (2, 2, 3)}
    tree = {k: (rng.normal(size=s) * 10.0 ** -i).astype(np.float32)
            for i, (k, s) in enumerate(shapes.items())}
    err = {k: (rng.normal(size=s) * 1e-3).astype(np.float32)
           for k, s in shapes.items()}
    return tree, err


def group_inputs(rank: int):
    """Leaves in groups, as a stage's blocks lie in the port's tree:
    ``s.0``, ``s.1``, ``s.2`` (the repeats of one stacked leaf ``s``, each
    ten times the last, so the group's scale is the last one's) and ``u``
    alone; their residuals and the groups."""
    rng = np.random.default_rng(500 + rank)
    tree = {f"s.{r}": (rng.normal(size=(4, 6)) * 10.0 ** (r - 2)).astype(
        np.float32) for r in range(3)}
    tree["u"] = rng.normal(size=(9,)).astype(np.float32)
    err = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
           for k, v in tree.items()}
    return tree, err, {k: k.split(".")[0] for k in tree}


def train_suite(rank: int, world: int) -> dict:
    """The cross-pod train step on a pod mesh of ``world`` ranks: three
    steps of ras-pimc SMOKE; this rank's parameters, residuals and losses,
    its first step's pod gradients and their reduce, and whether the step
    equals its composition (grads on the pod's rows, the reduce in the
    reference's leaves' groups, clip, lr, AdamW) bitwise."""
    import torch
    from repro_torch.configs.ras_pimc import SMOKE
    from repro_torch.data.pipeline import train_batch
    from repro_torch.parallel import collectives as col
    from repro_torch.train import optimizer, train_loop

    pod = col.pod_mesh(device="cpu")
    cfg = SMOKE.with_(grad_accum=1)
    model = _smoke_model()
    ref = _smoke_model()
    state = train_loop.init_train_state(model, with_error=True)
    step = train_loop.make_train_step(cfg, base_lr=1e-2,
                                      compress_crosspod=True, mesh=pod)
    res = {}
    batch = train_batch(cfg, 4, 16)
    # the composition, on a twin model
    r0, r1 = pod.slab(4)
    shard = {k: v[r0:r1] for k, v in batch.items()}
    loss, grads = train_loop.grads_fn(ref, shard)
    for k, g in grads.items():
        res[f"grads/{k}"] = _np(g)
    red, err = col.compressed_psum_tree(
        grads, pod, col.init_error_tree(grads),
        groups=train_loop.crosspod_groups(ref))
    for k, g in red.items():
        res[f"reduced/{k}"] = _np(g)
    clipped, _ = optimizer.clip_by_global_norm(red, 1.0)
    params = dict(ref.named_parameters())
    ref_state = train_loop.init_train_state(ref)
    want, _ = optimizer.adamw_update(
        clipped, ref_state.opt, params,
        optimizer.cosine_lr(ref_state.step, base_lr=1e-2))
    state, m = step(state, batch)
    got = dict(model.named_parameters())
    res["composition_equal"] = np.array(
        all(torch.equal(got[k], want[k]) for k in want)
        and all(torch.equal(state.error[k], err[k]) for k in err)
        and bool(m["loss"] == col.pmean(loss, pod)))
    losses = [float(m["loss"])]
    for i in (1, 2):
        state, m = step(state, train_batch(cfg, 4, 16, step=i))
        losses.append(float(m["loss"]))
    res["losses"] = np.array(losses)
    for k, p in model.named_parameters():
        res[f"params/{k}"] = _np(p)
        res[f"error/{k}"] = _np(state.error[k])
    return res


def mesh_suite(rank: int, world: int) -> dict:
    """The production mesh's machinery on 4 ranks: a ``("data",
    "model")`` mesh from ``make_mesh_for`` with ``shard_params`` then
    ``unshard`` of the SMOKE models in ``MESH_ARCHS`` (each rank's shard
    shapes and whether the round trip is bitwise); a ``("pod", "data")``
    device mesh whose ``"pod"`` group carries ``compressed_psum`` (this
    rank's inputs by its pod index) and whose ``"data"`` group a chunk
    mesh's static-table encode."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import spc
    from repro_torch.launch.mesh import make_mesh_for, mesh_shape_of
    from repro_torch.models import init_model
    from repro_torch.parallel import chunked as pc, collectives as col
    from repro_torch.parallel import sharding

    dm = make_mesh_for(world, model_parallel=2, device="cpu")
    res = {"mesh": np.array(mesh_shape_of(dm).sizes)}
    for arch in MESH_ARCHS:
        model = init_model(get_smoke_config(arch), seed=5, device="cpu")
        full = {k: p.detach() for k, p in model.named_parameters()}
        specs = sharding.param_specs(model, mesh_shape_of(dm))
        local = sharding.shard_params(full, specs, dm)
        back = sharding.unshard(local, specs, dm)
        res[f"{arch}/bitwise"] = np.array(all(
            torch.equal(back[k], full[k]) for k in full))
        for k, t in local.items():
            res[f"{arch}/shard/{k}"] = np.array(t.shape)
    pd = init_device_mesh("cpu", (2, world // 2),
                          mesh_dim_names=("pod", "data"))
    pod = col.pod_mesh(group=pd.get_group("pod"), device="cpu")
    res["pod"] = np.array([pod.rank, pod.size])
    x, err = psum_inputs(pod.rank)
    out, new_err = col.compressed_psum(torch.as_tensor(x), pod,
                                       torch.as_tensor(err))
    res["psum/out"], res["psum/err"] = _np(out), _np(new_err)
    chunks = pc.chunk_mesh(group=pd.get_group("data"), device="cpu")
    probs, syms, _ = chunk_case("static", 70)
    tbl = spc.tables_from_probs(torch.as_tensor(probs))
    _put(res, "chunks/enc", pc.encode_chunked(
        torch.as_tensor(syms), tbl, CHUNK, mesh=chunks, backend="kernel"))
    return res


# the SMOKE models the mesh suite places: a dense one, and experts placed
# on the model axis
MESH_ARCHS = ("ras-pimc", "phi3.5-moe-42b-a6.6b")

# the compute placement's cases: name -> (SMOKE arch, config overrides,
# (data, model) mesh); every case runs a 4 x 16 batch on 4 ranks
SP = (("data",), "model", None)
TP_CASES = {
    "qwen3_tp2": ("qwen3-4b", {"tp": 2}, (2, 2)),             # kv sharded
    "qwen3_tp4": ("qwen3-4b", {"tp": 4}, (1, 4)),             # kv replicated
    "padded": ("qwen1.5-4b", {"n_heads": 6, "n_kv_heads": 3, "tp": 4,
                              "head_dim": 16, "qkv_bias": True}, (1, 4)),
    "llama_sp": ("llama3-405b", {"tp": 2, "act_pspec": SP}, (2, 2)),
    "llama_sp_remat": ("llama3-405b", {"tp": 2, "act_pspec": SP,
                                       "remat": True}, (2, 2)),
    "pimc_tp2": ("ras-pimc", {"tp": 2}, (2, 2)),
    # the MoE family: expert parallelism where cfg.tp divides n_experts,
    # else every expert's d_ff columns over model (per-expert TP)
    "phi_ep2": ("phi3.5-moe-42b-a6.6b", {"tp": 2}, (2, 2)),
    "phi_ep4": ("phi3.5-moe-42b-a6.6b", {"tp": 4}, (1, 4)),
    "mixtral_etp": ("mixtral-8x22b", {"tp": 2, "n_experts": 3}, (2, 2)),
    "mixtral_etp_sp": ("mixtral-8x22b", {"tp": 4, "n_experts": 6,
                                         "act_pspec": SP, "remat": True},
                       (1, 4)),
    "phi_dense": ("phi3.5-moe-42b-a6.6b", {"tp": 2, "moe_impl": "dense"},
                  (2, 2)),
    # the recurrent families: the SSM's channels and state and the RG-LRU's
    # channels over model; mamba2_split's 32 channels a rank are half of a
    # 64-wide head (mamba2-130m's 96 a rank at tp 16 are 1.5 heads)
    "mamba2_tp2": ("mamba2-130m", {"tp": 2}, (2, 2)),
    "mamba2_split": ("mamba2-130m", {"tp": 4, "ssm_headdim": 64}, (1, 4)),
    "rgemma_tp2": ("recurrentgemma-2b", {"tp": 2}, (2, 2)),
    "rgemma_sp_remat": ("recurrentgemma-2b", {"tp": 4, "act_pspec": SP,
                                              "remat": True}, (1, 4)),
    # cross attention and the encoder-decoder: the memory's rows over data,
    # whole along M on every model rank; the vlm's 2 kv heads sharded at
    # tp 2 and replicated at tp 4, the audio model's 4 sharded at tp 4
    "vlm_tp2": ("llama-3.2-vision-11b", {"tp": 2}, (2, 2)),
    "audio_tp4": ("seamless-m4t-large-v2", {"tp": 4}, (1, 4)),
    "vlm_sp_remat": ("llama-3.2-vision-11b", {"tp": 4, "act_pspec": SP,
                                              "remat": True}, (1, 4)),
}
TP_BATCH, TP_SEQ, TP_LR = 4, 16, 3e-3
# the placed train step on batches the batch axes do not divide (the
# reference's batch_pspec: over the axes that divide them, whole on the
# ranks of the rest): name -> (SMOKE arch, config overrides, mesh (data,
# model) or (pod, data, model), batch rows)
TP_ROWS = {
    "pimc_rows3": ("ras-pimc", {"tp": 2}, (2, 2), 3),   # whole on data
    "phi_rows3": ("phi3.5-moe-42b-a6.6b", {"tp": 2}, (2, 2), 3),  # the aux
    # microbatches of 3 rows; the residuals unconstrained (the reference's
    # default act_pspec, the global batch's ("data",), would pin each
    # microbatch's 3 rows over data 2, where JAX's GSPMD step gives wrong
    # embedding gradients)
    "qwen3_accum": ("qwen3-4b", {"tp": 2, "grad_accum": 2,
                                 "act_pspec": (None, None, None)}, (2, 2), 6),
    "pimc_pod": ("ras-pimc", {"tp": 2}, (2, 2, 1), 2),  # over pod alone
}
# leaves moved off their constant inits (zeros and ones), so they matter:
# the SSM's per-head leaves differ between heads, so a channel reading
# another head's dt, decay or D shows
TP_MOVED = ("bq", "bk", "bv", "q_norm", "k_norm", "ln1", "ln2",
            "ln_cross", "final_norm", "A_log", "D", "dt_bias", "norm_scale", "conv_x_b",
            "conv_b_b", "conv_c_b", "conv_b", "gate_a_b", "gate_i_b", "lam")


def tp_case(name: str) -> tuple:
    """``(arch, overrides, mesh dims, batch rows)`` of a case of
    :data:`TP_CASES` (``TP_BATCH`` rows), :data:`TP_ROWS` or
    :data:`CROSSPOD` (``CROSSPOD_BATCH`` rows)."""
    if name in TP_ROWS:
        return TP_ROWS[name]
    if name in CROSSPOD:
        return CROSSPOD[name] + (CROSSPOD_BATCH,)
    return TP_CASES[name] + (TP_BATCH,)


def mesh_names(dims: tuple) -> tuple:
    return ("pod", "data", "model")[-len(dims):]


def case_mesh(dims: tuple, world: int):
    """The ``DeviceMesh`` of a case's dims on ``world`` gloo ranks:
    ``make_mesh_for``'s ``(data, model)``, or ``(pod, data, model)``."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import make_mesh_for
    if len(dims) == 2:
        dm = make_mesh_for(world, model_parallel=dims[1], device="cpu")
        assert tuple(dm.shape) == tuple(dims), dm.shape
        return dm
    return init_device_mesh("cpu", dims, mesh_dim_names=mesh_names(dims))


def tp_config(name: str):
    from repro_torch.configs.registry import get_smoke_config
    arch, over = tp_case(name)[:2]
    return get_smoke_config(arch).with_(**over)


def tp_model(name: str):
    """The case's whole model on the CPU: seeded weights, the biases and
    norm scales moved by normal(0, 0.1) draws."""
    import torch
    from repro_torch.models import init_model
    model = init_model(tp_config(name), seed=11, device="cpu")
    rng = np.random.default_rng(12)
    with torch.no_grad():
        for k, p in model.named_parameters():
            if k.rsplit(".", 1)[-1] in TP_MOVED:
                p.add_(torch.as_tensor(rng.normal(0, 0.1, tuple(p.shape)),
                                       dtype=p.dtype))
    return model


def flat_tree(tree, prefix: str, out: dict) -> None:
    """A nested dict's leaves into ``out`` by ``prefix/<path>``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat_tree(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(tree)


def as_reference(name: str, res: dict) -> dict:
    """The port's results of a case keyed as the reference's flattened
    outputs (gradients and parameters by the reference's tree path)."""
    from repro_torch.models.convert import to_reference
    model = tp_model(name)
    out = {}
    for group in ("grads", "params"):
        tensors = {k[len(group) + 1:]: v for k, v in res.items()
                   if k.startswith(f"{group}/")}
        flat_tree(to_reference(model, tensors, host=np.asarray), group, out)
    for k, v in res.items():
        if not k.startswith(("grads/", "params/", "shard/")):
            out[k] = v
    return out


def close(got: np.ndarray, want: np.ndarray, what: str,
          rel: float = 1e-5) -> None:
    """``got`` within ``rel`` of ``want``'s largest entry."""
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=0,
        atol=rel * max(float(np.abs(want).max()), 1e-12), err_msg=what)


def tp_batch(name: str, step: int) -> dict:
    from repro_torch.data.pipeline import train_batch
    return train_batch(tp_config(name), tp_case(name)[3], TP_SEQ, step=step)


def tp_outputs(model, name: str, device_mesh=None) -> dict:
    """The case's loss and gradients (``grads_fn``) and prefill logits on
    batch 0; two train steps' losses and grad norms (batches 1 and 2) and
    the parameters after them (the first step runs at the warmup's zero
    learning rate and fills AdamW's moments, the second moves the
    parameters: Adam's first update ``g / (|g| + eps)`` would turn
    gradients of eps's size, which float rounding moves by their own size,
    into steps of any size), of the whole model
    (``device_mesh`` None) or of its placement on ``device_mesh``, whose
    gradients, parameters and logits come back whole.  Also the shapes of
    this rank's parameter shards and, for a MoE model, the expert ids each
    block routed batch 0's tokens to in the prefill forward (whole: every
    data slab's, ``(blocks, B x S, k)``)."""
    import torch
    from repro_torch.parallel import sharding
    from repro_torch.train import train_loop
    cfg = tp_config(name)
    batch, *steps = (tp_batch(name, i) for i in range(3))
    if device_mesh is not None:
        model = sharding.place_model(model, device_mesh)
    pl = model.placement

    def back(tensors):
        if pl is None:
            return tensors
        return sharding.unshard(tensors, pl.specs, device_mesh)

    res = {}
    loss, grads = train_loop.grads_fn(model, batch)
    res["loss"] = _np(loss)
    for k, g in back(grads).items():
        res[f"grads/{k}"] = _np(g)
    tokens = torch.as_tensor(batch["tokens"], dtype=torch.int64)
    mem = {k: torch.as_tensor(batch[k]) for k in ("memory", "enc_inputs")
           if k in batch}
    with torch.no_grad(), routed() as ids:
        if pl is None:
            x, _ = model(tokens, **mem)
            lg = model._logits(x)
        else:
            x, _ = model(pl.rows(tokens),
                         **{k: pl.rows(v) for k, v in mem.items()})
            b = tokens.shape[0]
            lg = pl.whole_rows(model._logits(x), b)
            lg = pl.comm.all_gather(lg, "model", 2)
            for k, p in model.named_parameters():
                res[f"shard/{k}"] = np.array(p.shape)
            ids = [pl.whole_rows(i, b) for i in ids]
    res["logits"] = _np(lg)
    if ids:
        res["ids"] = _np(torch.stack(ids))
    state = train_loop.init_train_state(model)
    step = train_loop.make_train_step(cfg, base_lr=TP_LR,
                                      device_mesh=device_mesh)
    for i, b in enumerate(steps):
        state, m = step(state, b)
        res[f"step{i}/loss"] = _np(m["loss"])
        res[f"step{i}/grad_norm"] = _np(m["grad_norm"])
    for k, p in back({k: p.detach() for k, p in
                      model.named_parameters()}).items():
        res[f"params/{k}"] = _np(p)
    return res


class routed:
    """A context that records the expert ids of every MoE routing call
    (``models.moe._pick``) made inside it, in call order."""

    def __enter__(self):
        from repro_torch.models import moe
        self.ids, self._pick = [], moe._pick

        def pick(logits, cfg, dtype):
            out = self._pick(logits, cfg, dtype)
            self.ids.append(out[2])
            return out

        moe._pick = pick
        return self.ids

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._pick = self._pick


def tp_suite(rank: int, world: int) -> dict:
    """Every case of :data:`TP_CASES` placed on its ``(data, model)``
    mesh of ``world`` ranks (:func:`tp_outputs`)."""
    from repro_torch.launch.mesh import make_mesh_for
    res = {}
    for name, (_, _, (dp, tp)) in TP_CASES.items():
        dm = make_mesh_for(world, model_parallel=tp, device="cpu")
        assert tuple(dm.shape) == (dp, tp), dm.shape
        for k, v in tp_outputs(tp_model(name), name, dm).items():
            res[f"{name}/{k}"] = v
    return res


# the placed decode's cases: name -> (TP_CASES geometry, per-row
# positions, ring length, steps); each decodes TP_BATCH rows of seeded
# tokens, and prefills the first TP_PREFILL of them into a fresh state
TP_DECODE = {
    "qwen3_tp2": ("qwen3_tp2", False, 32, 24),          # kv heads sharded
    "qwen3_tp4": ("qwen3_tp4", False, 32, 24),          # slots sharded
    "padded": ("padded", False, 32, 24),                # padded heads
    "pimc_tp2": ("pimc_tp2", False, 32, 24),
    "qwen3_tp4_rows": ("qwen3_tp4", True, 24, 30),      # per-row; wraps
    "phi_ep4": ("phi_ep4", False, 32, 24),              # EP; slots
    "mixtral_etp": ("mixtral_etp", False, 32, 24),      # kv heads; its
                                                        # window wraps
    "mamba2_tp2": ("mamba2_tp2", False, 32, 24),        # h, conv sharded
    "mamba2_split": ("mamba2_split", True, 24, 30),     # half a head a rank
    "rgemma": ("rgemma_tp2", False, 32, 24),            # its 16-slot window
                                                        # wraps
    "vlm": ("vlm_tp2", False, 32, 24),                  # the memory's
                                                        # rows over data
    "audio": ("audio_tp4", True, 24, 30),               # dec; per-row;
}                                                       # wraps
TP_PREFILL = 8
TP_ROW_OFFSETS = (0, 5, 2, 7)


def tp_decode_inputs(name: str):
    """The case's ``(tokens (B, steps) int64, each step's positions: an
    int or a (B,) int64 array, prefill pos0 (B,), the memory (B, M, D)
    float32 of a model with cross attention, else None)``."""
    tp_name, rows, _, steps = TP_DECODE[name]
    cfg = tp_config(tp_name)
    rng = np.random.default_rng(21)
    tokens = rng.integers(0, cfg.vocab_size,
                          (TP_BATCH, steps)).astype(np.int64)
    off = np.array(TP_ROW_OFFSETS if rows else (0,) * TP_BATCH, np.int64)
    pos = [off + t if rows else t for t in range(steps)]
    memory = None
    if cfg.memory_tokens:
        memory = (rng.standard_normal((TP_BATCH, cfg.memory_tokens,
                                       cfg.d_model)) * 0.5).astype(
                                           np.float32)
    return tokens, pos, off, memory


def tp_decode_outputs(model, name: str, device_mesh=None) -> dict:
    """The case's step scan (each step's logits, whole rows of the global
    batch; every leaf of the final state, whole) and, for a model of
    attention blocks, its prefill: ``prefill_chunk`` of the first
    ``TP_PREFILL`` tokens at ``pos0`` into a fresh state (the logits,
    whole, and whether the rank's logits and state shards are bitwise the
    step scan's after as many steps), of the whole model or of its
    placement on ``device_mesh``; placed, also the shape of this rank's
    shard of every state leaf, the ring layout (``"none"`` without
    attention), and whether ``place_state`` of the whole final state
    gives back the rank's shards bitwise."""
    import torch
    from repro_torch.parallel import sharding
    _, _, length, steps = TP_DECODE[name]
    tokens, pos, pos0, memory = tp_decode_inputs(name)
    if memory is not None:
        memory = torch.as_tensor(memory)
    if device_mesh is not None:
        model = sharding.place_model(model, device_mesh)
    pl = model.placement

    def whole(lg):
        if pl is None:
            return lg
        lg = pl.whole_vocab(lg)
        return pl.comm.all_gather(lg, "data", 0) if pl.dp > 1 else lg

    tok = torch.as_tensor(tokens)
    state = model.init_state(TP_BATCH, length)
    res, local, snap = {}, [], None
    for t in range(steps):
        p = pos[t] if isinstance(pos[t], int) else torch.as_tensor(pos[t])
        local.append(model.decode_step(state, tok[:, t:t + 1], p,
                                       memory=memory))
        if t + 1 == TP_PREFILL and state.k is not None:
            snap = (state.k.clone(), state.v.clone())
    res["logits"] = _np(torch.stack([whole(lg) for lg in local]))
    final = state if pl is None else pl.unplace_state(state)
    for k, t in final.leaves().items():
        res[f"state/{k}"] = _np(t)
    if tp_prefills(name):
        fresh = model.init_state(TP_BATCH, length)
        n_valid = torch.full((TP_BATCH,), TP_PREFILL, dtype=torch.int64)
        lg = model.prefill_chunk(fresh, tok[:, :TP_PREFILL],
                                 torch.as_tensor(pos0), n_valid)
        res["prefill_logits"] = _np(whole(lg))
        res["prefill_bitwise"] = np.array(
            torch.equal(lg, torch.stack(local[:TP_PREFILL], 1))
            and torch.equal(fresh.k, snap[0])
            and torch.equal(fresh.v, snap[1]))
    if pl is not None:
        for k, t in state.leaves().items():
            res[f"shard/{k}"] = np.array(t.shape)
        res["layout"] = np.array("none" if model.cfg.is_attention_free
                                 else pl.ring_layout(length))
        back = pl.place_state(final)
        res["place_state_bitwise"] = np.array(all(
            torch.equal(back.leaves()[k], t)
            for k, t in state.leaves().items()))
    return res


def tp_prefills(name: str) -> bool:
    """Whether a :data:`TP_DECODE` case's model runs ``prefill_chunk``
    (attention blocks only, the protocol's ``can_prefill``)."""
    cfg = tp_config(TP_DECODE[name][0])
    return cfg.family not in ("ssm", "hybrid", "vlm", "audio")


def tp_decode_suite(rank: int, world: int) -> dict:
    """Every case of :data:`TP_DECODE` placed on its geometry's ``(data,
    model)`` mesh of ``world`` ranks (:func:`tp_decode_outputs`), and a
    placed compress over a ``data`` axis of 2."""
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.parallel import sharding
    from repro_torch.serve import compress
    res, meshes = {}, {}
    for name, (tp_name, *_) in TP_DECODE.items():
        dims = TP_CASES[tp_name][2]
        if dims not in meshes:
            meshes[dims] = make_mesh_for(world, model_parallel=dims[1],
                                         device="cpu")
        for k, v in tp_decode_outputs(tp_model(tp_name), name,
                                      meshes[dims]).items():
            res[f"{name}/{k}"] = v
    placed = sharding.place_model(tp_model("pimc_tp2"), meshes[2, 2])
    st = compress.lm_compress_chunked(placed, lm_tokens()[:, :8], 4,
                                      device="cpu")
    _put(res, "data/enc", st.chunks)
    _put(res, "data/dec", compress.lm_decompress_chunked(
        placed, st.chunks, 8, 4, device="cpu"))
    return res


# the placed compress: name -> (SMOKE arch, overrides, the rings' layout,
# the MoE rule), on a (1, world) mesh: LM_LANES lanes of TP_COMPRESS_T
# tokens, chunk LM_CHUNK; phi's 8 experts divide over model 2, mixtral's 3
# do not (and its 16-slot window wraps)
TP_COMPRESS = {
    "kv_heads": ("ras-pimc", {"tp": 2}, "kv_heads", None),
    "slots": ("ras-pimc", {"tp": 8}, "slots", None),
    "phi_ep": ("phi3.5-moe-42b-a6.6b", {"tp": 2}, "kv_heads", "experts"),
    "mixtral_etp": ("mixtral-8x22b", {"tp": 2, "n_experts": 3}, "kv_heads",
                    "mlp"),
    # no rings: the SSM state's h and conv leaves carried across chunks
    "mamba2": ("mamba2-130m", {"tp": 2}, "none", None),
}
TP_COMPRESS_T = 24


def tp_compress_suite(rank: int, world: int) -> dict:
    """``lm_compress_chunked`` and ``lm_decompress_chunked`` of the
    placed SMOKE models of :data:`TP_COMPRESS` on a ``(1, world)`` mesh
    (``ras-pimc`` with its KV rings kv-head-sharded and slot-sharded, the
    MoE family under either rule, and mamba2's SSM state): each backend's
    container, decoded tokens and per-lane probes, the monolithic pair's
    on the kernel backend, the ring layout and the MoE rule; the refusal
    of ``mesh=`` beside a placed model."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import init_model
    from repro_torch.parallel import chunked as pc, sharding
    from repro_torch.serve import compress
    dm = make_mesh_for(world, model_parallel=world, device="cpu")
    toks = lm_tokens()[:, :TP_COMPRESS_T]
    res = {}
    for name, (arch, over, _, _) in TP_COMPRESS.items():
        model = sharding.place_model(init_model(
            get_smoke_config(arch).with_(**over), seed=0, device="cpu"), dm)
        res[f"{name}/layout"] = np.array(
            "none" if model.cfg.is_attention_free
            else model.placement.ring_layout(TP_COMPRESS_T))
        res[f"{name}/rule"] = np.array(str(model.placement.moe_rule))
        for be in ("coder", "kernel"):
            st = compress.lm_compress_chunked(model, toks, LM_CHUNK,
                                              backend=be, device="cpu")
            _put(res, f"{name}/{be}/enc", st.chunks)
            _put(res, f"{name}/{be}/dec", compress.lm_decompress_chunked(
                model, st.chunks, TP_COMPRESS_T, LM_CHUNK, backend=be,
                lane_probes=True, device="cpu"))
        mono = compress.lm_compress(model, toks, backend="kernel",
                                    device="cpu")
        _put(res, f"{name}/mono/enc", mono.enc)
        _put(res, f"{name}/mono/dec", compress.lm_decompress(
            model, mono.enc, TP_COMPRESS_T, backend="kernel",
            lane_probes=True, device="cpu"))
    res["refuse/mesh"] = _error(lambda: compress.lm_compress_chunked(
        model, toks, LM_CHUNK, mesh=pc.lane_mesh(device="cpu")))
    return res


# the cross-pod step under the compute placement: name -> (SMOKE arch,
# overrides, (pod, data, model) mesh); CROSSPOD_BATCH rows, each pod's half
# over its data ranks; pod_ep's experts lie over model (expert
# parallelism), so a stacked expert leaf's scale spans both model ranks
CROSSPOD = {
    "pod_model": ("ras-pimc", {"tp": 2, "grad_accum": 1}, (2, 1, 2)),
    "pod_data": ("ras-pimc", {"tp": 2, "grad_accum": 1}, (2, 2, 1)),
    "pod_ep": ("phi3.5-moe-42b-a6.6b", {"tp": 2, "grad_accum": 1},
               (2, 1, 2)),
}
CROSSPOD_BATCH = 4


def crosspod_outputs(name: str, world: int) -> dict:
    """The placed cross-pod step of a :data:`CROSSPOD` case: the pod's
    gradients of batch 0 (whole: gathered over ``data`` and ``model``),
    their int8 reduce (whole), the scale of each group of
    ``crosspod_groups`` (``scale/<the reference leaf's path>``: its whole
    stacked leaf's ``|max| / 127``), whether the step on batch 0 equals
    its composition bitwise (the pod's placed gradients, the grouped
    sharded-scale ring, the clip over the pod's shards, lr, AdamW; the
    residuals and the loss too), the step's residuals (whole), the
    losses and grad norms of two steps (batches 0 and 1) and the
    parameters after the first (the warmup's zero learning rate)."""
    import torch
    from repro_torch.parallel import collectives as col, sharding
    from repro_torch.train import optimizer, train_loop
    dm = case_mesh(CROSSPOD[name][2], world)
    pod = col.pod_mesh(group=dm.get_group("pod"), device="cpu")
    cfg = tp_config(name)
    whole = tp_model(name)
    model, twin = (sharding.place_model(whole, dm) for _ in range(2))
    pl = twin.placement
    groups = train_loop.crosspod_groups(twin)

    def back(tensors):
        return sharding.unshard(tensors, pl.specs, dm)

    res = {"pod": np.array(pod.rank)}
    batch = tp_batch(name, 0)
    r0, r1 = pod.slab(CROSSPOD_BATCH)
    with train_loop.within_pod(twin):
        loss, grads = train_loop.grads_fn(twin, {k: v[r0:r1] for k, v in
                                                 batch.items()})
    for k, g in back(grads).items():
        res[f"grads/{k}"] = _np(g)
    maxima: dict = {}
    for k, g in grads.items():
        maxima.setdefault(groups[k], []).append(g.to(torch.float32).abs()
                                                .max())
    amax = pl.shard_max(torch.stack([torch.stack(m).max()
                                     for m in maxima.values()]))
    for path, a in zip(maxima, amax):
        res["scale/" + "/".join(path)] = _np(torch.clamp(a, min=1e-12)
                                             / 127.0)
    red, err = col.compressed_psum_tree(grads, pod, col.init_error_tree(
        grads), shard_max=pl.shard_max, groups=groups)
    for k, g in back(red).items():
        res[f"reduced/{k}"] = _np(g)
    clipped, _ = optimizer.clip_by_global_norm(red, 1.0,
                                               total=pl.sum_squares)
    params = dict(twin.named_parameters())
    st0 = train_loop.init_train_state(twin)
    want, _ = optimizer.adamw_update(clipped, st0.opt, params,
                                     optimizer.cosine_lr(st0.step,
                                                         base_lr=TP_LR))
    state = train_loop.init_train_state(model, with_error=True)
    step = train_loop.make_train_step(cfg, base_lr=TP_LR,
                                      compress_crosspod=True, mesh=pod,
                                      device_mesh=dm)
    state, m = step(state, batch)
    got = dict(model.named_parameters())
    res["composition_equal"] = np.array(
        all(torch.equal(got[k], want[k]) for k in want)
        and all(torch.equal(state.error[k], err[k]) for k in err)
        and bool(m["loss"] == col.pmean(loss, pod)))
    for k, p in back({k: p.detach() for k, p in got.items()}).items():
        res[f"params/{k}"] = _np(p)
    for k, e in back(state.error).items():
        res[f"error/{k}"] = _np(e)
    metrics = [m, step(state, tp_batch(name, 1))[1]]
    for i, m in enumerate(metrics):
        res[f"step{i}/loss"] = _np(m["loss"])
        res[f"step{i}/grad_norm"] = _np(m["grad_norm"])
    return res


def data_train_suite(rank: int, world: int) -> dict:
    """The placed train step of every case of :data:`TP_ROWS`
    (:func:`tp_outputs`) and the placed cross-pod step of every case of
    :data:`CROSSPOD` (:func:`crosspod_outputs`), on ``world`` ranks."""
    res = {}
    for name, (_, _, dims, _) in TP_ROWS.items():
        for k, v in tp_outputs(tp_model(name), name,
                               case_mesh(dims, world)).items():
            res[f"{name}/{k}"] = v
    for name in CROSSPOD:
        for k, v in crosspod_outputs(name, world).items():
            res[f"{name}/{k}"] = v
    return res


# the placed compress over data: name -> (SMOKE arch, overrides, (data,
# model) mesh, lanes), TP_COMPRESS_T tokens of LM_LANES lanes or fewer,
# chunk LM_CHUNK; 3 lanes do not divide over data 2 and lie whole on both
# data ranks
DATA_COMPRESS = {
    "pimc_22": ("ras-pimc", {"tp": 2}, (2, 2), LM_LANES),
    "pimc_41": ("ras-pimc", {"tp": 2}, (4, 1), LM_LANES),
    "pimc_22_lanes3": ("ras-pimc", {"tp": 2}, (2, 2), 3),
}
# the placed engine: the SMOKE models it serves (slots of 2 lanes, so a
# slot's lanes split over data 2), on a (1, world) mesh at 1 and 2 ranks
# and a (2, 2) mesh at 4
DATA_ENGINE = ("ras-pimc", "mamba2-130m")


def _placed_smoke(arch: str, dm, over: dict | None = None):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import init_model
    from repro_torch.parallel import sharding
    whole = init_model(get_smoke_config(arch).with_(**(over or {})), seed=0,
                       device="cpu")
    return whole, sharding.place_model(whole, dm)


def _engine_run(model) -> dict:
    """``BatchEngine`` of 2 slots of 2 lanes serving
    :func:`engine_tokens`' three compress requests (a ragged tail among
    them), then the first blob's decompress: the blobs, the tokens and
    per-lane probes."""
    from repro_torch.serve.engine import BatchEngine
    eng = BatchEngine(model, slots=2, lanes=2, chunk_size=8, max_len=24,
                      step_backend="kernel", device="cpu")
    rids = [eng.submit_compress(t, arrival=float(i))
            for i, t in enumerate(engine_tokens())]
    out = eng.run()
    res = {f"blob{i}": np.frombuffer(out[r].blob, np.uint8)
           for i, r in enumerate(rids)}
    dec = eng.submit_decompress(out[rids[0]].blob)
    got = eng.run()[dec]
    res["tokens"], res["lane_probes"] = got.tokens, got.lane_probes
    res["prefill_cycles"] = np.array(eng.prefill_cycles)
    return res


def data_serve_suite(rank: int, world: int) -> dict:
    """Compress and the engine with a model placed over ``data``.  On 4
    ranks: every case of :data:`DATA_COMPRESS` through
    ``lm_compress_chunked``/``lm_decompress_chunked`` (coder and kernel
    backends, and two-pass), the monolithic kernel pair, and whether the
    container is the whole model's bytes; then the engine on a (2, 2)
    mesh, and a placed decode state of 3 rows (whole on both data ranks)
    through ``unplace_state``/``place_state``.  On 2 ranks the engine on
    (1, 2), on 1 rank on (1, 1), beside
    the unplaced engine there.  Each engine's blobs beside the placed
    single-request ``lm_compress_chunked``'s of the same requests."""
    import torch
    from repro_torch.core import bitstream, coder
    from repro_torch.serve import compress
    res = {}
    if world == 4:
        for name, (arch, over, dims, lanes) in DATA_COMPRESS.items():
            whole, model = _placed_smoke(arch, case_mesh(dims, world), over)
            toks = lm_tokens()[:lanes, :TP_COMPRESS_T]
            for be in ("coder", "kernel"):
                st = compress.lm_compress_chunked(model, toks, LM_CHUNK,
                                                  backend=be, device="cpu")
                _put(res, f"{name}/{be}/enc", st.chunks)
                _put(res, f"{name}/{be}/dec", compress.lm_decompress_chunked(
                    model, st.chunks, TP_COMPRESS_T, LM_CHUNK, backend=be,
                    lane_probes=True, device="cpu"))
            _put(res, f"{name}/two_pass/dec", compress.lm_decompress_chunked(
                model, st.chunks, TP_COMPRESS_T, LM_CHUNK,
                backend="two_pass", lane_probes=True, device="cpu"))
            _put(res, f"{name}/whole/enc", compress.lm_compress_chunked(
                whole, toks, LM_CHUNK, backend="kernel",
                device="cpu").chunks)
            # the placed container read by the whole model
            try:
                sym = compress.lm_decompress_chunked(
                    whole, st.chunks, TP_COMPRESS_T, LM_CHUNK,
                    backend="kernel", device="cpu")[0]
                res[f"{name}/whole/decodes"] = np.array(
                    np.array_equal(_np(sym), toks))
            except coder.StreamExhaustedError:
                res[f"{name}/whole/decodes"] = np.array(False)
            mono = compress.lm_compress(model, toks, backend="kernel",
                                        device="cpu")
            _put(res, f"{name}/mono/enc", mono.enc)
            _put(res, f"{name}/mono/dec", compress.lm_decompress(
                model, mono.enc, TP_COMPRESS_T, backend="kernel",
                lane_probes=True, device="cpu"))
    if world == 4:
        # a decode state of 3 rows on (2, 2): whole on both data ranks
        whole, model = _placed_smoke("ras-pimc", case_mesh((2, 2), world),
                                     {"tp": 2})
        pl = model.placement
        states = [m.init_state(3, 8) for m in (whole, model)]
        tok = torch.as_tensor(lm_tokens()[:3, :6])
        for t in range(6):
            for m, st in zip((whole, model), states):
                m.decode_step(st, tok[:, t:t + 1], t)
        back = pl.unplace_state(states[1], 3)
        again = pl.place_state(back)
        res["rows3/place_state_bitwise"] = np.array(all(
            torch.equal(again.leaves()[k], v)
            for k, v in states[1].leaves().items()))
        for k, v in back.leaves().items():
            res[f"rows3/state/{k}"] = _np(v)
            res[f"rows3/whole/{k}"] = _np(states[0].leaves()[k])
    dims = (2, 2) if world == 4 else (1, world)
    for arch in DATA_ENGINE:
        whole, model = _placed_smoke(arch, case_mesh(dims, world))
        for k, v in _engine_run(model).items():
            res[f"engine/{arch}/{k}"] = v
        for i, t in enumerate(engine_tokens()):
            st = compress.lm_compress_chunked(model, t, 8, backend="kernel",
                                              device="cpu")
            res[f"engine/{arch}/single{i}"] = np.frombuffer(
                bitstream.pack_chunked(*st.chunks, chunk_size=8,
                                       n_symbols=t.shape[1]), np.uint8)
        if world == 1:
            for k, v in _engine_run(whole).items():
                res[f"engine/{arch}/unplaced/{k}"] = v
    return res


SUITES = {"chunked": chunked_suite, "lm": lm_suite,
          "collectives": collectives_suite, "train": train_suite,
          "mesh": mesh_suite, "tp": tp_suite, "tp_decode": tp_decode_suite,
          "tp_compress": tp_compress_suite, "data_train": data_train_suite,
          "data_serve": data_serve_suite}


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

class RankJob:
    """``world`` ranks of ``suite`` running as child processes."""

    def __init__(self, suite: str, world: int, tmp: Path):
        self.suite, self.world = suite, world
        self.out = Path(tmp) / f"{suite}{world}"
        self.out.mkdir(parents=True)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")]
                                     if p]))
        self._logs = [open(self.out / f"rank{r}.log", "w")
                      for r in range(world)]
        self._procs = [subprocess.Popen(
            [sys.executable, __file__, suite, str(r), str(world),
             str(self.out / "store"), str(self.out)], env=env,
            stdout=self._logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]

    def results(self, timeout: float = 150.0) -> list[dict]:
        """Wait for every rank (killing them all if one fails or the time
        runs out) and return each rank's results."""
        import time
        procs = self._procs
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(
                        p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in self._logs:
                f.close()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            text = "\n".join(f"--- rank {r} (rc {procs[r].returncode})\n"
                             + (self.out / f"rank{r}.log").read_text()[-3000:]
                             for r in bad)
            raise RuntimeError(
                f"{self.suite} on {self.world} ranks failed:\n{text}")
        results = []
        for r in range(self.world):
            with np.load(self.out / f"rank{r}.npz") as z:
                results.append({k: z[k] for k in z.files})
        return results


def in_process(suite: str, tmp: Path) -> dict:
    """``suite`` on a world-1 gloo group in this process (destroyed after)."""
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(tmp) / f"{suite}.store"), 1),
        rank=0, world_size=1, timeout=timedelta(seconds=60))
    try:
        return SUITES[suite](0, 1)
    finally:
        dist.destroy_process_group()


def main(argv: list[str]) -> int:
    suite, rank, world, store, out = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        res = SUITES[suite](rank, world)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
