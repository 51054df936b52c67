"""Tensor-parallel compute over the model axis (every family), port vs
the reference's GSPMD-placed step (CPU, gloo ranks, no card).

The cases are ``_torch_ranks.TP_CASES``, each a SMOKE config on a 4-rank
``(data, model)`` mesh: ``qwen3-4b`` at ``tp=2`` on (2, 2) (kv heads
sharded, ``qk_norm``) and at ``tp=4`` on (1, 4) (kv heads replicated); 6
query heads padded to 8 over 3 replicated kv heads with ``qkv_bias`` on
(1, 4); ``llama3-405b`` with sequence-parallel residuals, ``grad_accum``
2, ``logits_chunk`` 8 and blockwise attention on (2, 2), with and
without ``remat``; tied ``ras-pimc`` on (2, 2); the MoE family under
expert parallelism and per-expert TP; ``mamba2-130m`` on (2, 2) and with
half a 64-wide head a rank on (1, 4); ``recurrentgemma-2b`` on (2, 2)
and sequence-parallel with ``remat`` on (1, 4); ``llama-3.2-vision-11b``
(cross attention over a memory) on (2, 2) and sequence-parallel with
``remat`` on (1, 4), and ``seamless-m4t-large-v2`` (the encoder and the
``dec`` blocks) on (1, 4).  Both sides take the same
seeded weights (biases and norm scales moved off their inits) and
``train_batch`` batches, built here with the port and handed to JAX as
numpy arrays (``models.convert.to_reference``).

* The port's side: 4 gloo ranks (``tests/_torch_ranks.py``, suite
  ``tp``), each holding only its shards (``sharding.place_model``): the
  loss and ``unshard``-ed gradients of ``grads_fn``, two
  ``make_train_step(device_mesh=)`` steps (the first at the warmup's zero
  learning rate, the second moving the parameters), the parameters after
  them, and the prefill logits gathered over both axes.
* The reference's side: one JAX process with 4 forced CPU devices
  (``tests/_torch_tp_ref.py``), its placed ``grads_fn``, steps and
  logits under ``jax.jit`` with ``param_shardings`` and ``batch_pspec``.
* The port's one-rank (unplaced) step on the same inputs.

Every leaf within 1e-5 of its largest entry of both.  Also: the named
errors of meshes that do not divide and of paths not placed; at a (1, 1)
mesh the placed blocks and steps of every family are the unplaced ones
op for op; the unplaced step is the composition of the unplaced layers,
op for op; every dry-run cell compute-placed, a placed cell's traced
matmul FLOPs against a count by hand, and its recorded model-axis
collectives.

The placed decode (``-k decode``): the cases of ``_torch_ranks.
TP_DECODE`` (kv-head-sharded, slot-sharded, padded heads, ``ras-pimc``,
per-row positions on a ring shorter than the stream, the MoE rules, the
SSM on the reference's state shards, the hybrid's window wrapping, the
vlm's and the audio model's cross attention over a memory) on the same 4
gloo ranks (suite ``tp_decode``), against JAX's ``decode_step`` and
``prefill_chunk`` jitted with ``param_shardings`` and
``repro.launch.specs.cache_shardings`` (``_torch_tp_ref.py decode``) and
against the port's one-rank step: each step's logits, gathered whole,
and every leaf of the final state within 1e-5 of the largest entry;
each rank's state shards; the placed ``prefill_chunk`` of an attention
model bitwise the placed steps.  The
placed compress (suite ``tp_compress``, 2 ranks, a ``(1, 2)`` mesh):
the same container on both ranks, decoded exactly on the same
placement; ``mesh=`` beside a placed model refused by name.
"""

import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ranks as R
from repro_torch.configs import registry
from repro_torch.launch import dryrun, mesh, specs
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import encode_memory, init_model, moe, param, \
    rglru, ssm
from repro_torch.models.convert import to_reference
from repro_torch.models.layers import embed, logits, mlp, rmsnorm, xent_loss
from repro_torch.models.attention import attn_cross, attn_forward
from repro_torch.models.transformer import remat
from repro_torch.parallel import Mesh, sharding
from repro_torch.parallel.sharding import batch_spec
from repro_torch.parallel.tensor import RecordingComm
from repro_torch.serve.engine import BatchEngine
from repro_torch.analysis import hlo
from repro_torch.train import train_loop

HERE = Path(__file__).resolve().parent
# the reference's placed step gives one answer per config: a remat
# variant is held against the same JAX run, where the plain case exists
JAX_CASE = {name: name.removesuffix("_remat")
            if name.removesuffix("_remat") in R.TP_CASES else name
            for name in R.TP_CASES}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_inputs(path: Path) -> None:
    inp = {}
    for name in sorted(set(JAX_CASE.values())):
        R.flat_tree(to_reference(R.tp_model(name)), f"{name}/w", inp)
        for i in range(3):
            for plane, a in R.tp_batch(name, i).items():
                inp[f"{name}/b{i}/{plane}"] = a
    np.savez(path, **inp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, JAX's results, the one-rank results by case):
    the JAX process and the 4 ranks run at once, the one-rank steps here
    meanwhile."""
    tmp = tmp_path_factory.mktemp("tp")
    _reference_inputs(tmp / "in.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               TP_REF_JAX_CACHE=str(HERE.parent / ".pytest_cache" / "jax"),
               PYTHONPATH=os.pathsep.join(
                   [str(R.SRC)] + [p for p in [os.environ.get(
                       "PYTHONPATH")] if p]))
    log = open(tmp / "jax.log", "w")
    ref = subprocess.Popen([sys.executable, str(HERE / "_torch_tp_ref.py"),
                            str(tmp / "in.npz"), str(tmp / "out.npz")],
                           env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        job = R.RankJob("tp", 4, tmp)
        one = {name: R.tp_outputs(R.tp_model(name), name)
               for name in R.TP_CASES}
        ranks = job.results(timeout=240)
        ref.wait(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
        log.close()
    if ref.returncode:
        raise RuntimeError("the reference's placed steps failed:\n"
                           + (tmp / "jax.log").read_text()[-4000:])
    with np.load(tmp / "out.npz") as z:
        jax_out = {k: z[k] for k in z.files}
    return ranks, jax_out, one


_as_reference, _close = R.as_reference, R.close


@pytest.mark.parametrize("name", list(R.TP_CASES))
def test_placed_step_matches_reference_and_one_rank(runs, name):
    ranks, jax_out, one = runs
    placed = {k[len(name) + 1:]: v for k, v in ranks[0].items()
              if k.startswith(f"{name}/")}
    got = _as_reference(name, placed)
    jname = JAX_CASE[name]
    want_jax = {k[len(jname) + 1:]: v for k, v in jax_out.items()
                if k.startswith(f"{jname}/")}
    want_one = _as_reference(name, one[name])
    if "ids" in want_one:       # the routing first: a differing pick is a
        np.testing.assert_array_equal(   # routing difference
            got.pop("ids"), want_one.pop("ids"),
            err_msg=f"{name}: placed routing differs from one rank's")
    assert set(want_jax) == set(got) == set(want_one)
    for k in sorted(got):
        _close(got[k], want_jax[k], f"{name} {k}: placed port vs JAX")
        _close(got[k], want_one[k], f"{name} {k}: placed vs one rank")
    for r in range(1, 4):   # every rank returns the same whole results
        for k in placed:
            if not k.startswith("shard/"):
                np.testing.assert_array_equal(ranks[r][f"{name}/{k}"],
                                              placed[k], err_msg=k)


@pytest.mark.parametrize("name", list(R.TP_CASES))
def test_each_rank_holds_only_its_shards(runs, name):
    """A rank's parameters have the shapes of its shards, and the ranks'
    shards together hold each parameter once per rank it replicates
    on."""
    ranks = runs[0]
    _, _, (dp, tp) = R.TP_CASES[name]
    ms = MeshShape(("data", "model"), (dp, tp))
    model = R.tp_model(name)
    spec = sharding.param_specs(model, ms)
    for k, p in model.named_parameters():
        want = sharding.shard_shape(tuple(p.shape), spec[k], ms)
        for r in range(4):
            assert tuple(ranks[r][f"{name}/shard/{k}"]) == want, (k, r)
        placed = {a for e in spec[k] for a in sharding.spec_axes(e)}
        assert math.prod(want) * math.prod(
            ms.shape[a] for a in placed) == p.numel(), k
    assert sum(math.prod(ranks[0][f"{name}/shard/{k}"]) for k in spec) < \
        param.param_count(model)


def _drops(name: str, ids: np.ndarray) -> int:
    """The picks the capacity dispatch drops, from each block's expert ids
    ``(blocks, B x S, k)`` of a case's batch: ranked within their batch
    row token-major, beyond ``moe_capacity``'s capacity."""
    cfg = R.tp_config(name)
    if cfg.moe_impl == "dense":
        return 0
    e, k, s = cfg.n_experts, cfg.topk_experts, R.TP_SEQ
    cap = int(math.ceil(k * s / e * cfg.capacity_factor))
    cap = max(4, -(-cap // 4) * 4)
    eid = ids.reshape(ids.shape[0], R.TP_BATCH, s * k)
    onehot = np.eye(e, dtype=np.int64)[eid]
    rank = ((np.cumsum(onehot, 2) - onehot) * onehot).sum(-1)
    return int((rank >= cap).sum())


MOE_CASES = [n for n in R.TP_CASES if R.tp_config(n).family == "moe"]


def test_moe_cases_route_alike_and_drop_tokens(runs):
    """Every rank of a MoE case routes batch 0 as the one-rank model does
    (the same ids), and the capacity dispatch drops picks in at least one
    case, so the drop path runs placed; the dense schedule drops none."""
    ranks, _, one = runs
    drops = {}
    for name in MOE_CASES:
        for r in range(4):
            np.testing.assert_array_equal(ranks[r][f"{name}/ids"],
                                          one[name]["ids"], err_msg=name)
        drops[name] = _drops(name, one[name]["ids"])
    print("dropped picks by case:", drops)
    assert drops["phi_dense"] == 0
    assert sum(drops.values()) > 0, drops


def _comm(dp: int, tp: int) -> RecordingComm:
    return RecordingComm(MeshShape(("data", "model"), (dp, tp)))


@pytest.mark.parametrize("over,dims,dim", [
    ({"n_heads": 6}, (1, 4), "n_heads_padded"),
    ({"d_ff": 130}, (1, 4), "d_ff"),
    ({"tp": 2}, (1, 4), "n_kv_heads"),
    ({"d_model": 66, "head_dim": 16}, (4, 1), "d_model"),
    # expert parallelism (6 experts over cfg.tp 2) on a model axis of 4
    ({"arch": "phi3.5-moe-42b-a6.6b", "n_experts": 6, "tp": 2}, (1, 4),
     "n_experts"),
    # per-expert TP (3 experts over cfg.tp 2): every expert's d_ff
    ({"arch": "mixtral-8x22b", "n_experts": 3, "tp": 2, "d_ff": 129},
     (1, 2), "d_ff"),
    # the SSM's channels (d_in 192 over 128) and state (24 over 16)
    ({"arch": "mamba2-130m", "d_model": 96}, (1, 128), "d_in"),
    ({"arch": "mamba2-130m", "ssm_state": 24}, (1, 16), "ssm_state"),
    # the RG-LRU's channels (d_model 96 over 64)
    ({"arch": "recurrentgemma-2b", "d_model": 96, "n_heads": 64,
      "head_dim": 4, "d_ff": 64, "vocab_size": 256, "tp": 64}, (1, 64),
     "lru_width"),
])
def test_meshes_that_do_not_divide_raise_by_name(over, dims, dim):
    over = dict(over)
    arch = over.pop("arch", "qwen3-4b")
    cfg = registry.get_smoke_config(arch).with_(**over)
    model = init_model(cfg, device="cpu")
    with pytest.raises(ValueError, match=dim):
        sharding.place_model(model, _comm(*dims))


@pytest.mark.parametrize("arch,batch", [("qwen3-4b", 3),
                                        ("mamba2-130m", 1)])
def test_placed_rows_follow_batch_pspec(arch, batch):
    """A batch the data axis does not divide (a train step's, or a decode
    state's rows, ``long_500k``'s one) lies whole on every data rank, as
    the reference's ``batch_pspec`` places it, and ``whole_rows`` moves
    nothing back; one it divides, the rank's slab.  (The train step on
    such batches is held against JAX in ``test_torch_data_placement``.)"""
    cfg = registry.get_smoke_config(arch).with_(tp=2)
    model = sharding.place_model(init_model(cfg, device="cpu"), _comm(2, 2))
    pl = model.placement
    for rows, axes in ((batch, ()), (2 * batch, ("data",))):
        tokens = torch.arange(rows * 8).reshape(rows, 8)
        assert pl._slab_axes(rows) == axes
        assert tuple(pl.rows(tokens).shape) == (rows // 2 ** len(axes), 8)
        assert batch_spec(MeshShape(("data", "model"), (2, 2)), rows)[0] \
            == (axes or None)
    tokens = torch.arange(batch * 8).reshape(batch, 8)
    assert torch.equal(pl.whole_rows(pl.rows(tokens), batch), tokens)
    with torch.device("meta"):
        whole = param.meta_model(cfg).init_state(batch, 8)
    for k, t in whole.leaves().items():
        assert pl.state_shape(k, tuple(t.shape), 8)[1] == batch, k


# ---------------------------------------------------------------------------
# the placed decode
# ---------------------------------------------------------------------------

def _decode_inputs(path: Path) -> None:
    inp = {}
    for name, (tp_name, rows, _, _) in R.TP_DECODE.items():
        R.flat_tree(to_reference(R.tp_model(tp_name)), f"{name}/w", inp)
        tokens, pos, pos0, memory = R.tp_decode_inputs(name)
        inp[f"{name}/tokens"], inp[f"{name}/pos0"] = tokens, pos0
        if rows:
            inp[f"{name}/pos"] = np.stack(pos)
        if memory is not None:
            inp[f"{name}/memory"] = memory
    np.savez(path, **inp)


@pytest.fixture(scope="module")
def decode_runs(tmp_path_factory):
    """(the ranks' results, JAX's results, the one-rank results by case)
    of the placed decode: the JAX process and the 4 ranks at once, the
    one-rank steps here meanwhile."""
    tmp = tmp_path_factory.mktemp("tp_decode")
    _decode_inputs(tmp / "in.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               TP_REF_JAX_CACHE=str(HERE.parent / ".pytest_cache" / "jax"),
               PYTHONPATH=os.pathsep.join(
                   [str(R.SRC)] + [p for p in [os.environ.get(
                       "PYTHONPATH")] if p]))
    log = open(tmp / "jax.log", "w")
    ref = subprocess.Popen([sys.executable, str(HERE / "_torch_tp_ref.py"),
                            str(tmp / "in.npz"), str(tmp / "out.npz"),
                            "decode"],
                           env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        job = R.RankJob("tp_decode", 4, tmp)
        one = {name: R.tp_decode_outputs(R.tp_model(tp_name), name)
               for name, (tp_name, *_) in R.TP_DECODE.items()}
        ranks = job.results(timeout=240)
        ref.wait(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
        log.close()
    if ref.returncode:
        raise RuntimeError("the reference's placed decode failed:\n"
                           + (tmp / "jax.log").read_text()[-4000:])
    with np.load(tmp / "out.npz") as z:
        jax_out = {k: z[k] for k in z.files}
    return ranks, jax_out, one


@pytest.mark.parametrize("name", list(R.TP_DECODE))
def test_placed_decode_matches_reference_and_one_rank(decode_runs, name):
    """Each step's logits (whole rows of the global batch) and the
    prefill's within 1e-5 of the largest entry of JAX's GSPMD-placed
    serving step and of the port's one-rank step; the final state
    (unplaced, the ring's tile padding cut to JAX's slots) within 1e-5 of
    each leaf's largest entry; every rank returns the same whole
    results."""
    ranks, jax_out, one = decode_runs
    got = {k[len(name) + 1:]: v for k, v in ranks[0].items()
           if k.startswith(f"{name}/")}
    want = {k[len(name) + 1:]: v for k, v in jax_out.items()
            if k.startswith(f"{name}/")}
    tp_name, _, length, _ = R.TP_DECODE[name]
    cfg = R.tp_config(tp_name)
    ring = min(length, cfg.window) if cfg.window else length
    for t in range(len(got["logits"])):
        _close(got["logits"][t], want["logits"][t],
               f"{name} step {t}: placed port vs JAX")
        _close(got["logits"][t], one[name]["logits"][t],
               f"{name} step {t}: placed vs one rank")
    shared = ["logits"]
    if R.tp_prefills(name):
        if cfg.family != "moe":     # JAX's MoE prefill drops tokens
            _close(got["prefill_logits"], want["prefill_logits"],
                   f"{name} prefill: placed port vs JAX")
        _close(got["prefill_logits"], one[name]["prefill_logits"],
               f"{name} prefill: placed vs one rank")
        shared.append("prefill_logits")
    leaves = sorted(k for k in want if k.startswith("state/"))
    assert leaves == sorted(k for k in got if k.startswith("state/"))
    for k in leaves:
        cut = got[k][:, :, :ring] if k in ("state/k", "state/v") else got[k]
        _close(cut, want[k], f"{name} {k}: placed port vs JAX")
        _close(got[k], one[name][k], f"{name} {k}: placed vs one rank")
    for r in range(1, 4):
        for k in shared + leaves:
            np.testing.assert_array_equal(ranks[r][f"{name}/{k}"], got[k],
                                          err_msg=f"{name} rank {r} {k}")


@pytest.mark.parametrize("name", list(R.TP_DECODE))
def test_placed_decode_state_shards_and_prefill(decode_runs, name):
    """Each rank holds only its shard of every state leaf, the
    reference's (``launch/specs.cache_specs``: the ring's kv heads when
    ``cfg.kv_sharded``, else its slots; a recurrent ``h`` or ``conv``
    leaf's last dim), ``place_state`` of the whole state gives it back
    bitwise, and the placed ``prefill_chunk`` of an attention model is
    bitwise the placed step scan (its logits and the rank's state shards
    after as many positions)."""
    ranks = decode_runs[0]
    tp_name, _, length, _ = R.TP_DECODE[name]
    cfg = R.tp_config(tp_name)
    dp, tp = R.TP_CASES[tp_name][2]
    layout = ("none" if cfg.is_attention_free
              else "kv_heads" if cfg.kv_sharded else "slots")
    ms = MeshShape(("data", "model"), (dp, tp))
    with torch.device("meta"):
        whole = param.meta_model(cfg).init_state(R.TP_BATCH, length)
    leaves = {k: tuple(t.shape) for k, t in whole.leaves().items()}
    spec = specs.cache_specs(cfg, ms, leaves, R.TP_BATCH)
    if layout == "kv_heads":
        assert spec["k"][3] == "model"
    elif layout == "slots":
        assert spec["k"][2] == "model"
    for k in leaves:
        if k not in ("k", "v"):
            assert spec[k][-1] == "model", k
    for r in range(4):
        res = ranks[r]
        assert str(res[f"{name}/layout"]) == layout
        for k, sh in leaves.items():
            assert tuple(res[f"{name}/shard/{k}"]) == sharding.shard_shape(
                sh, spec[k], ms), (k, r)
        assert bool(res[f"{name}/place_state_bitwise"]), r
        if R.tp_prefills(name):
            assert bool(res[f"{name}/prefill_bitwise"]), r


@pytest.fixture(scope="module")
def compress_runs(tmp_path_factory):
    return R.RankJob("tp_compress", 2,
                     tmp_path_factory.mktemp("tp_compress")).results()


@pytest.mark.parametrize("name", list(R.TP_COMPRESS))
def test_placed_compress_round_trip(compress_runs, name):
    """A placed SMOKE on a ``(1, 2)`` mesh: ``ras-pimc`` with its rings
    kv-head-sharded (``tp = 2``) and slot-sharded (``tp = 8``, 4 heads
    padded to 8), phi3.5-moe under expert parallelism (8 experts over 2
    ranks), mixtral under per-expert tensor parallelism (3 experts, its
    window wrapping) and mamba2 (its SSM channels, state and conv state
    over model, carried across chunks): both ranks write the same
    container, the coder and kernel backends the same bytes, and the
    decode on the same placement returns the tokens exactly, with the
    same per-lane probes on both backends and ranks; the monolithic
    ``lm_compress``/``lm_decompress`` pair round-trips too."""
    a, b = compress_runs
    _, _, layout, rule = R.TP_COMPRESS[name]
    assert str(a[f"{name}/layout"]) == layout
    assert str(a[f"{name}/rule"]) == str(rule)
    toks = R.lm_tokens()[:, :R.TP_COMPRESS_T]
    for k in a:
        if k.startswith(f"{name}/"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for field in ("buf", "start", "length", "overflow"):
        np.testing.assert_array_equal(a[f"{name}/coder/enc/{field}"],
                                      a[f"{name}/kernel/enc/{field}"])
    for be in ("coder", "kernel", "mono"):
        np.testing.assert_array_equal(a[f"{name}/{be}/dec/sym"], toks)
    np.testing.assert_array_equal(a[f"{name}/coder/dec/lane_probes"],
                                  a[f"{name}/kernel/dec/lane_probes"])


def test_placed_compress_over_data_and_mesh_refusal(decode_runs,
                                                    compress_runs):
    """A placed model on a ``data`` axis of 2 compresses: every rank
    writes the same container and decodes its tokens exactly (the cases
    of ``test_torch_data_placement`` hold it further); ``mesh=`` beside a
    placed model raises a named ``ValueError``."""
    ranks = decode_runs[0]
    toks = R.lm_tokens()[:, :8]
    for res in ranks:
        np.testing.assert_array_equal(res["data/dec/sym"], toks)
        for k in ("data/enc/buf", "data/enc/length"):
            np.testing.assert_array_equal(res[k], ranks[0][k])
    err = str(compress_runs[0]["refuse/mesh"])
    assert err.startswith("ValueError") and "mesh=" in err


def test_other_families_and_paths_refuse_by_name():
    # every family is placed: the vlm and audio models too, their decode
    # at a (1, 1) mesh the whole model's, bit for bit
    for arch in ("llama-3.2-vision-11b", "seamless-m4t-large-v2"):
        cfg = registry.get_smoke_config(arch)
        whole = init_model(cfg, seed=2, device="cpu")
        placed = sharding.place_model(whole, _comm(1, 1))
        memory = torch.as_tensor(np.random.default_rng(3).normal(
            size=(2, cfg.memory_tokens, cfg.d_model)), dtype=torch.float32)
        state, wstate = placed.init_state(2, 8), whole.init_state(2, 8)
        for t in range(10):
            tok = torch.full((2, 1), 3 * t + 1, dtype=torch.int64)
            assert torch.equal(
                placed.decode_step(state, tok, t, memory=memory),
                whole.decode_step(wstate, tok, t, memory=memory)), (arch, t)
    cfg = registry.get_smoke_config("ras-pimc")
    whole = init_model(cfg, device="cpu")
    placed = sharding.place_model(whole, _comm(1, 1))
    assert whole.placement is None and placed.placement is not None
    with pytest.raises(ValueError, match="placed already"):
        sharding.place_model(placed, _comm(1, 1))
    # a placed dense model serves: at a (1, 1) mesh every collective is
    # the identity and ras-pimc's rings are kv-head-sharded, so its steps
    # are the whole model's, bit for bit
    state, wstate = placed.init_state(2, 8), whole.init_state(2, 8)
    for t in range(10):
        tok = torch.full((2, 1), 3 * t + 1, dtype=torch.int64)
        assert torch.equal(placed.decode_step(state, tok, t),
                           whole.decode_step(wstate, tok, t)), t
    assert torch.equal(state.k, wstate.k) and torch.equal(state.v, wstate.v)
    lanes = Mesh("lanes", None, 1, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="mesh= with a placed model"):
        BatchEngine(placed, slots=1, lanes=2, device="cpu", mesh=lanes)
    batch = R.tp_batch("pimc_tp2", 0)
    with pytest.raises(ValueError, match="device_mesh"):
        train_loop.make_train_step(cfg)(train_loop.init_train_state(placed),
                                        batch)
    with pytest.raises(ValueError, match="device_mesh"):
        train_loop.make_train_step(cfg, device_mesh=_comm(1, 1))(
            train_loop.init_train_state(placed), batch)
    with pytest.raises(ValueError, match="'pod' axis"):
        train_loop.make_train_step(cfg, compress_crosspod=True,
                                   mesh=SimpleNamespace(axis="pod", size=1),
                                   device_mesh=_comm(1, 1))


@pytest.mark.parametrize("arch,over,rule", [
    ("phi3.5-moe-42b-a6.6b", {"tp": 4}, "experts"),     # the slots layout
    ("phi3.5-moe-42b-a6.6b", {"moe_impl": "dense"}, "experts"),
    ("mixtral-8x22b", {"n_experts": 3, "tp": 2}, "mlp"),
])
def test_moe_placed_at_one_rank_is_the_unplaced_op_for_op(arch, over, rule):
    """On a (1, 1) mesh a placed MoE block's FFN is the unplaced one op
    for op: the training schedule's output, aux loss and gradients, and
    the serving step's output, bitwise; so are the placed model's decode
    steps and state (what makes its containers the whole model's), its
    ring kv-head-sharded or, at ``tp = 4``, slot-sharded (one rank's slab
    is the whole ring)."""
    cfg = registry.get_smoke_config(arch).with_(**over)
    whole = init_model(cfg, seed=4, device="cpu")
    placed = sharding.place_model(whole, _comm(1, 1))
    pl = placed.placement
    assert (pl.moe_rule, pl.expert_start) == (rule, 0)
    assert pl.ring_layout(8) == ("kv_heads" if cfg.kv_sharded else "slots")
    p = whole.blocks[0].ffn
    x = torch.as_tensor(np.random.default_rng(5).normal(
        size=(2, 16, cfg.d_model)), dtype=torch.float32)
    outs = []
    for place in (None, pl):
        xi = x.clone().requires_grad_()
        y, aux = moe.moe(p, xi, cfg, place=place)
        grads = torch.autograd.grad((y * y).sum() + aux,
                                    [xi] + list(p.parameters()))
        outs.append((y, aux, *grads, moe.moe_step(p, x[:, :1], cfg, place)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    state, wstate = placed.init_state(2, 8), whole.init_state(2, 8)
    for t in range(10):
        tok = torch.full((2, 1), 5 * t + 2, dtype=torch.int64)
        assert torch.equal(placed.decode_step(state, tok, t),
                           whole.decode_step(wstate, tok, t)), t
    assert torch.equal(state.k, wstate.k) and torch.equal(state.v, wstate.v)


@pytest.mark.parametrize("arch,over,attr", [
    ("mamba2-130m", {}, "ssm"),
    ("mamba2-130m", {"ssm_headdim": 64, "ssm_chunk": 4}, "ssm"),
    ("recurrentgemma-2b", {}, "rec"),
    ("recurrentgemma-2b", {"tp": 4}, "rec"),            # the slots layout
])
def test_recurrent_placed_at_one_rank_is_the_unplaced_op_for_op(arch, over,
                                                                attr):
    """On a (1, 1) mesh a placed SSM or RG-LRU mixer is the unplaced one
    op for op: the training mixer's output and gradients and the serving
    step's output and state, bitwise; so are the placed model's decode
    steps and every state leaf (what makes its containers the whole
    model's), the hybrid's ring kv-head-sharded or, at ``tp = 4``,
    slot-sharded (one rank's slab is the whole ring)."""
    cfg = registry.get_smoke_config(arch).with_(**over)
    whole = init_model(cfg, seed=4, device="cpu")
    placed = sharding.place_model(whole, _comm(1, 1))
    pl = placed.placement
    fwd, step = ((ssm.ssm_forward, ssm.ssm_decode_step) if attr == "ssm"
                 else (rglru.rglru_forward, rglru.rglru_decode_step))
    p = getattr(whole.blocks[0], attr)
    x = torch.as_tensor(np.random.default_rng(5).normal(
        size=(2, 16, cfg.d_model)), dtype=torch.float32)
    outs = []
    for place in (None, pl.serving(8)):
        xi = x.clone().requires_grad_()
        y = fwd(p, xi, cfg, place=place)
        grads = torch.autograd.grad((y * y).sum(), [xi] + list(p.parameters()))
        st = placed.init_state(2, 8) if place else whole.init_state(2, 8)
        cache = {k.split(".")[1]: t[0] for k, t in st.recurrent.items()
                 if k.startswith(attr)}
        with torch.no_grad():
            y1 = [step(p, x[:, t:t + 1], cache, cfg, place=place)
                  for t in range(3)]
        outs.append((y, *grads, *y1, *cache.values()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    state, wstate = placed.init_state(2, 8), whole.init_state(2, 8)
    for t in range(10):
        tok = torch.full((2, 1), 5 * t + 2, dtype=torch.int64)
        assert torch.equal(placed.decode_step(state, tok, t),
                           whole.decode_step(wstate, tok, t)), t
    for k, t in wstate.leaves().items():
        assert torch.equal(state.leaves()[k], t), k


@pytest.mark.parametrize("arch,over", [
    ("llama-3.2-vision-11b", {}),
    ("llama-3.2-vision-11b", {"tp": 4, "remat": True}),   # kv replicated
    ("seamless-m4t-large-v2", {}),
    ("seamless-m4t-large-v2", {"tp": 4, "remat": True}),  # kv sharded
])
def test_cross_placed_at_one_rank_is_the_unplaced_op_for_op(arch, over):
    """On a (1, 1) mesh a placed model's training unit with cross
    attention (the vlm's (attn x 4, cross) pattern, the audio model's
    ``dec`` block) and its encoder are the unplaced ones op for op: the
    unit's output and the gradients of its input, of the memory (or the
    encoder inputs it was encoded from) and of every parameter, bitwise;
    so is the serving step's cross attention (``attn_cross``)."""
    cfg = registry.get_smoke_config(arch).with_(**over)
    whole = init_model(cfg, seed=4, device="cpu")
    placed = sharding.place_model(whole, _comm(1, 1))
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(2, 16, cfg.d_model)),
                        dtype=torch.float32)
    m = torch.as_tensor(rng.normal(size=(2, cfg.memory_tokens,
                                         cfg.d_model)), dtype=torch.float32)
    outs = []
    for model in (whole, placed):
        xi, mi = x.clone().requires_grad_(), m.clone().requires_grad_()
        mem = encode_memory(model, mi) if cfg.is_encdec else mi
        y, _ = remat(cfg, model.unit_forward, model.units[0], xi, mem)
        ps = list(model.parameters())
        grads = torch.autograd.grad((y * y).sum(), [xi, mi] + ps,
                                    allow_unused=True)
        b = model.kinds.index("cross" if arch.startswith("llama")
                              else "dec")
        pl = model.placement
        with torch.no_grad():
            step = attn_cross(model.blocks[b].cross, x[:, :1], m, cfg,
                              place=None if pl is None else pl.serving(8))
        outs.append((y, step, *grads))
    assert outs[0][3] is not None     # the memory's gradient
    for a, b in zip(*outs):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("slots_at_one", (False, True))
@pytest.mark.parametrize("arch", ("qwen3-4b", "phi3.5-moe-42b-a6.6b"))
def test_slots_ring_on_one_model_rank(arch, slots_at_one):
    """A ``slots`` ring on a (1, 1) mesh: by default the serving step
    attends the one slab, the whole ring, as the unplaced step does,
    bitwise; ``slots_at_one`` keeps the context-parallel step (the masked
    slab write, the slab's partials, the combine), its logits and state
    within 1e-5 of the whole model's largest entry."""
    cfg = registry.get_smoke_config(arch).with_(tp=4)
    whole = init_model(cfg, seed=6, device="cpu")
    placed = sharding.place_model(whole, _comm(1, 1),
                                  slots_at_one=slots_at_one)
    pl = placed.placement
    assert pl.ring_layout(8) == "slots"
    step = pl.serving(8)
    assert step.ring == ("slots" if slots_at_one else "replicated")
    state, wstate = placed.init_state(2, 8), whole.init_state(2, 8)
    assert (step.slab_start, step.slab) == (0, wstate.k.shape[2])
    for t in range(12):
        tok = torch.full((2, 1), 7 * t + 3, dtype=torch.int64)
        got, want = (placed.decode_step(state, tok, t),
                     whole.decode_step(wstate, tok, t))
        if slots_at_one:
            _close(got.numpy(), want.numpy(), f"{arch} step {t}")
        else:
            assert torch.equal(got, want), t
    for got, want in ((state.k, wstate.k), (state.v, wstate.v)):
        if slots_at_one:
            _close(got.numpy(), want.numpy(), f"{arch} state")
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ("ras-pimc", "qwen1.5-4b"))
def test_unplaced_loss_is_the_unplaced_layers(arch):
    """The unplaced forward and loss run the unplaced layer functions op
    for op: ``loss_fn`` and its gradients are bitwise their composition
    here (the placed forms never reached without a placement)."""
    cfg = registry.get_smoke_config(arch)
    model = init_model(cfg, seed=3, device="cpu")
    batch = R.tp_batch("pimc_tp2", 1)
    loss, grads = train_loop.grads_fn(model, batch)
    params = dict(model.named_parameters())
    tokens = torch.as_tensor(batch["tokens"], dtype=torch.int64)
    x = embed(model.embedding, tokens)
    for blk in model.blocks:
        x = x + attn_forward(blk.attn, rmsnorm(blk.ln1, x, cfg.norm_eps),
                             cfg)
        f = blk.ffn
        x = x + mlp(f.wi_gate, f.wi_up, f.wo,
                    rmsnorm(blk.ln2, x, cfg.norm_eps))
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    want = xent_loss(logits(model.embedding, x, model.lm_head),
                     torch.as_tensor(batch["labels"]), cfg.vocab_size)
    want = want + 0.01 * torch.zeros((), dtype=torch.float32)
    wgrads = torch.autograd.grad(want, list(params.values()))
    assert torch.equal(loss, want.detach())
    for k, g in zip(params, wgrads):
        assert torch.equal(grads[k], g), k


# ---------------------------------------------------------------------------
# the dry-run under the compute placement
# ---------------------------------------------------------------------------

def test_dryrun_places_compute_for_dense_train_and_prefill():
    """Every cell of the grid on the production mesh is compute-placed
    (a recording stand-in, the rank's shards as its parameters and its
    decode state, the reference's ``act_pspec``: none on a decode cell
    but the config's own; phi3.5-moe's 16 experts one a rank, mixtral's 8
    each on 1/16 of ``d_ff``; the vlm's and audio model's cross attention
    and encoder on the rank's heads, their memory the rank's rows); a
    decode cell's recurrent leaves have their last dim on ``model`` and
    its ring layout is the reference's (the kv heads where ``tp = 16``
    divides them, ``ras-pimc``'s and ``seamless-m4t-large-v2``'s, else
    the ring's slots), and it records the context-parallel combine's
    gathers over ``model``, or the SSM step's gathers and
    reduce-scatter."""
    ms = mesh.production_mesh_shape()
    for arch, shape, ok, _ in registry.grid():
        if not ok:
            continue
        cell = specs.build_cell(arch, shape, ms)
        family = registry.get_config(arch).family
        if family == "moe":
            pl, ffn = cell.model.placement, cell.model.blocks[0].ffn
            ep = arch == "phi3.5-moe-42b-a6.6b"
            assert pl.moe_rule == ("experts" if ep else "mlp"), arch
            assert tuple(ffn.wi_gate.shape[::2]) == (
                (1, cell.cfg.d_ff) if ep else (8, cell.cfg.d_ff // 16))
        assert cell.comm is not None, (arch, shape)
        for k, p in cell.model.named_parameters():
            sh, _, spec = cell.params[k]
            assert tuple(p.shape) == sharding.shard_shape(sh, spec, ms), k
        decode = registry.SHAPES[shape].kind == "decode"
        want = ((("data",), "model", None) if arch == "llama3-405b"
                else None if decode else (("data",), None, None))
        assert cell.cfg.act_pspec == want, arch
        if not decode:
            continue
        pl = cell.model.placement
        sh = registry.SHAPES[shape]
        with torch.device("meta"):
            st = cell.model.init_state(sh.global_batch, sh.seq_len)
        for k, t in st.leaves().items():
            gsh, _, spec = cell.state[k]
            assert tuple(t.shape) == sharding.shard_shape(gsh, spec, ms), k
        for k, (gsh, _, spec) in cell.state.items():
            if k not in ("k", "v"):     # a recurrent leaf's last dim
                assert spec[-1] == "model", (arch, k)
        if family in ("vlm", "audio"):
            assert cell.batch["memory"][0][0] == sh.global_batch, arch
        cell.run()
        ops = {(op, axis) for op, axis, _, _ in cell.recorded}
        assert ("all-reduce", "model") in ops
        if family == "ssm":     # the step gathers [x | B | C], the taps and
            assert {("all-gather", "model"),        # the convolved vector,
                    ("reduce-scatter", "model")} <= ops  # scatters y
            continue
        layout = pl.ring_layout(sh.seq_len)
        assert layout == ("kv_heads" if arch in (
            "ras-pimc", "seamless-m4t-large-v2") else "slots"), arch
        assert (("all-gather", "model") in ops) == (layout == "slots")
    cell = specs.build_cell("llama3-405b", "train_4k",
                            mesh.production_mesh_shape(multi_pod=True))
    assert cell.cfg.act_pspec == (("pod", "data"), "model", None)


@pytest.mark.parametrize("arch,remat", [("ras-pimc", False),
                                        ("ras-pimc", True),
                                        ("llama3-405b", False),
                                        ("phi3.5-moe-42b-a6.6b", False),
                                        ("mixtral-8x22b", False)])
def test_placed_cell_flops_match_hand_count(arch, remat, monkeypatch):
    """A placed SMOKE train cell on a (2, 2) mesh: the traced matmul
    FLOPs of one rank are its shares, counted by hand: its data slab's
    tokens through its query heads, kv heads (sharded at ``tp=2``), MLP
    columns and vocabulary rows; ``llama3-405b`` gathers its
    sequence-parallel residuals before every product, so its counts are
    the whole sequence's.  A MoE cell: the router over every expert, then
    the capacity dispatch's slots (``cap`` a batch row and expert) of the
    rank's 4 of phi's 8 experts at full ``d_ff`` (expert parallelism), or
    of mixtral's 3 experts on half of ``d_ff`` (per-expert tensor
    parallelism)."""
    monkeypatch.setattr(specs, "get_config", registry.get_smoke_config)
    ms = MeshShape(("data", "model"), (2, 2))
    shape = registry.ShapeSpec("t", 16, 8, "train")
    over = {"tp": 2, "remat": remat, "grad_accum": 2}
    if arch == "llama3-405b":
        over["act_pspec"] = R.SP    # CONFIG's, which its SMOKE lacks
    if arch == "mixtral-8x22b":
        over["n_experts"] = 3       # 3 % 2: per-expert TP
    cell = specs.build_cell(arch, shape, ms, overrides=over)
    _, tr = hlo.trace(cell.run)
    cfg = cell.cfg
    tp, b, s = 2, shape.global_batch // 2, shape.seq_len
    n, d, dh = b * s, cfg.d_model, cfg.head_dim_
    hp, kv, ff, v = (cfg.n_heads_padded // tp, cfg.n_kv_heads // tp,
                     cfg.d_ff // tp, cfg.vocab_padded // tp)
    ffn = 3 * 2 * n * d * ff
    if cfg.family == "moe":
        e, k = cfg.n_experts, cfg.topk_experts
        cap = max(4, -(-math.ceil(k * s / e * cfg.capacity_factor) // 4) * 4)
        ep = cell.model.placement.moe_rule == "experts"
        assert ep == (arch == "phi3.5-moe-42b-a6.6b")
        el, fl = (e // tp, cfg.d_ff) if ep else (e, cfg.d_ff // tp)
        ffn = 2 * n * d * e + 3 * 2 * b * el * cap * d * fl
    layer = (2 * n * d * (hp + 2 * kv) * dh + 2 * n * hp * dh * d
             + 2 * 2 * b * hp * s * s * dh + ffn)
    forward = cfg.n_layers * layer + 2 * n * d * v
    recompute = cfg.n_layers * (layer - 2 * n * ff * d) if remat else 0
    assert tr.flops == 3 * forward + recompute
    ops = {op for op, axis, _, _ in cell.recorded if axis == "model"}
    want = {"all-reduce"} | ({"all-gather", "reduce-scatter"}
                             if arch == "llama3-405b" else set())
    assert ops == want
    rec = dryrun.run_cell(arch, shape, mesh=ms, verbose=False,
                          overrides=over)
    assert rec["status"] == "OK"
    coll = rec["roofline"]["collectives"]
    assert coll["by_axes"]["model"] == pytest.approx(sum(
        nb for _, axis, nb, _ in cell.recorded if axis == "model"))
    assert coll["body_bytes"] > 0 and coll["entry_bytes"] > 0
