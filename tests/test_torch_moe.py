"""The MoE family on the port against the JAX reference (CPU).

Both sides run the reference's ``mixtral-8x22b`` (4 experts, top-2, a
16-slot sliding window, untied head) and ``phi3.5-moe-42b-a6.6b`` (8
experts, full attention) SMOKE configs, the port holding JAX's parameters
through ``models.convert.from_reference``; every input is made with
numpy from a seed and handed to both.  JAX's model steps run under
``jax.jit``, as its serving code runs them.

* ``_route``, ``moe_dense`` and ``moe_capacity`` against JAX's at S = 1
  and S = 16 (where the capacity dispatch drops tokens), and the port's
  fixed-shape ``moe_step`` against JAX's capacity and dense schedules at
  S = 1; router ties built on purpose (equal router columns, so equal
  probabilities) pick JAX's expert ids;
* ``decode_step`` over 64 steps (mixtral's 16-slot ring wraps 4 times):
  float32 logits and every ring within atol 1e-5 / rtol 1e-4; bfloat16
  logits within atol 3e-2, see below;
* ``prefill_chunk`` bitwise equal to the port's own step scan (pos0 > 0,
  a ragged row), and within 1e-5 of JAX's step scan at a chunk where
  JAX's own ``prefill_chunk`` drops tokens; that drop gap (> 1e-2) is
  asserted too, so the reference's property stays pinned;
* ``to_reference`` inverts ``from_reference`` (the experts, the router and
  the untied ``lm_head``), a bfloat16 tree by bit pattern;
* ``forward`` (hidden states and the summed load-balance loss) and
  ``loss_fn`` (cross entropy + 0.01 x aux) against JAX's in float32, and
  the sliding window's training mask;
* the serve stack on the port: ``lm_compress_chunked`` on the kernel and
  coder backends byte-identical, the kernel, coder and two-pass decodes
  bit-exact with equal probes; the engine's blobs byte-identical to the
  single-request path with ``prefill="auto"`` (prefill cycles run) and
  ``"off"``; the window's wrap rules at the engine's door; the protocol
  geometry and ``can_prefill`` equal JAX's; the launcher serves both
  archs.

bfloat16: the two frameworks round the bfloat16 products and sums at
different places, so a router whose k-th and (k+1)-th probabilities lie
within rounding of each other can pick a different expert on each side,
and that token's FFN output then differs by more than rounding.  The test
records both sides' expert ids at every MoE block (JAX's through
``jax.debug.callback``): on every step where they agree the logits stay
within atol 3e-2 (four bfloat16 ulps at the logits' magnitude, the
recurrent families' bfloat16 bound), and every step where they differ
must be such a near tie in JAX's own probabilities (at each rank where
the picks differ, the two experts within 2**-7 of each other, relative;
a swap of the top two with the same experts changes no output and is
held to the tolerance).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models.moe as jmoe
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import can_prefill as j_can_prefill
from repro.models import decode_step as j_decode_step
from repro.models import init_model as j_init_model
from repro.models import init_state as j_init_state
from repro.models import loss_fn as j_loss_fn
from repro.models import prefill_chunk as j_prefill_chunk
from repro.models import ring_length as j_ring_length
from repro.models import state_spec as j_state_spec
from repro.models import wrap_length as j_wrap_length
from repro.models.attention import attn_forward as j_attn_forward
from repro.models.transformer import forward as j_forward
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import bitstream
from repro_torch.data.pipeline import token_stream
from repro_torch.launch import serve as launcher
from repro_torch.models import (can_prefill, decode_step, init_model,
                                init_state, loss_fn, moe, prefill_chunk,
                                ring_length, state_spec, wrap_length)
from repro_torch.models.attention import attn_forward
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.serve import compress
from repro_torch.serve.engine import BatchEngine

jax.config.update("jax_platforms", "cpu")

ARCHS = ("mixtral-8x22b", "phi3.5-moe-42b-a6.6b")
TOL = dict(atol=1e-5, rtol=1e-4)
CHUNK = 8


def _pair(arch: str, dtype: str = "float32", seed: int = 0):
    """(JAX config, JAX params, the port's model holding them)."""
    jcfg = j_get_smoke_config(arch).with_(dtype=dtype)
    params = j_init_model(jcfg, jax.random.PRNGKey(seed))
    model = from_reference(jax.tree.map(np.asarray, params),
                           get_smoke_config(arch).with_(dtype=dtype),
                           device="cpu")
    return jcfg, params, model


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one CPU thread: its SMOKE ops are small, and
    beside other busy test processes torch's idle worker threads spin for
    the cores (the serve tests ran ~15x slower on a loaded 8-core host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def zoo():
    return {arch: _pair(arch) for arch in ARCHS}


@functools.lru_cache(maxsize=None)
def _jstep(jcfg):
    return jax.jit(lambda p, s, tok, pos: j_decode_step(p, s, tok, pos,
                                                        jcfg))


def _ffn(params, model, layer: int = 0):
    """Block ``layer``'s MoE FFN: JAX's parameter dict and the port's."""
    p = jax.tree.map(lambda a: a[layer],
                     params["stages"]["s0"]["b0_attn_moe"]["ffn"])
    return p, model.blocks[layer].ffn


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _x(shape, seed, dtype=np.float32):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.as_tensor(x).to(
        getattr(torch, jnp.dtype(dtype).name))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    """CONFIG and SMOKE hold the reference's values on every field the
    port has, with the same stages, pattern and window."""
    for port, ref in ((get_config(arch), j_get_config(arch)),
                      (get_smoke_config(arch), j_get_smoke_config(arch))):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert port.stages == ref.stages and port.pattern == ("attn_moe",)
        assert port.window == ref.sliding_window
        assert not port.tie_embeddings


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch, dtype):
    jcfg, params, model = _pair(arch, dtype)
    p, blk = _ffn(params, model)
    jx, tx = _x((24, jcfg.d_model), 1, jnp.dtype(dtype))
    jw, jids, jaux = jmoe._route(p, jx, jcfg)
    with torch.no_grad():
        w, ids, aux = moe._route(blk, tx, model.cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    tol = TOL if dtype == "float32" else dict(atol=2 ** -8, rtol=0)
    _close(w, jw.astype(jnp.float32), **tol)
    assert w.dtype == tx.dtype
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("pattern", [
    (0.5, 0.2, 0.2, 0.1),          # 2nd and 3rd tie: the lower id runs
    (0.3, 0.3, 0.3, 0.1),          # three-way tie for 1st
    (0.25, 0.25, 0.25, 0.25),      # every expert ties
    (0.1, 0.2, 0.2, 0.5)])         # tie below the 1st, higher ids
def test_topk_ties_pick_the_reference_experts(pattern):
    """Router columns built so their logits are equal on every row: the
    port's top-k picks JAX's expert ids (the lower id first among
    equals), in float32 and in bfloat16."""
    jcfg, params, model = _pair("mixtral-8x22b")
    p, _ = _ffn(params, model)
    rng = np.random.default_rng(2)
    base = rng.normal(size=(jcfg.d_model,)).astype(np.float32)
    # column e = base * log(pattern[e]) / |base|^2 -> logit = log p_e on
    # the row x = base; a shuffled row keeps the equal columns equal
    router = np.stack([base * np.log(q) / float(base @ base)
                       for q in pattern], 1).astype(np.float32)
    xs = np.stack([base * s for s in (1.0, 2.0, 0.5)])
    for dt in (jnp.float32, jnp.bfloat16):
        pj = dict(p, router=jnp.asarray(router).astype(dt))
        tdt = getattr(torch, jnp.dtype(dt).name)
        tp = types.SimpleNamespace(router=torch.as_tensor(router).to(tdt))
        _, ids, _ = moe._route(tp, torch.as_tensor(xs).to(tdt), model.cfg)
        _, jids, _ = jmoe._route(pj, jnp.asarray(xs).astype(dt), jcfg)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    probs = torch.tensor([pattern, pattern[::-1]])
    w, ids = moe.topk_first(probs, 3)
    jw, jids = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


@pytest.mark.parametrize("s", [1, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_schedules_match_reference(arch, s):
    """``moe_dense`` and ``moe_capacity`` (outputs and aux) at S = 1 and
    at S = 16.  Each row's tokens share a component, so they route alike
    and overflow their experts' slots: at S = 16 the capacity dispatch
    drops tokens (12 slots an expert for mixtral's 32 picks a row, 8 for
    phi3.5's)."""
    jcfg, params, model = _pair(arch)
    p, blk = _ffn(params, model)
    rng = np.random.default_rng(3)
    x = (3 * rng.normal(size=(3, 1, jcfg.d_model))
         + 0.1 * rng.normal(size=(3, s, jcfg.d_model))).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    with torch.no_grad():
        for jfn, fn in ((jmoe.moe_dense, moe.moe_dense),
                        (jmoe.moe_capacity, moe.moe_capacity)):
            jy, jaux = jfn(p, jx, jcfg)
            y, aux = fn(blk, tx, model.cfg)
            _close(y, jy, **TOL)
            np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
        dropped = (moe.moe_capacity(blk, tx, model.cfg)[0]
                   - moe.moe_dense(blk, tx, model.cfg)[0]).abs().max()
    assert (float(dropped) > 1e-3) == (s > 1)


@pytest.mark.parametrize("impl", ["capacity", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_step_matches_reference(arch, impl):
    """The serving step's all-experts form at S = 1 against the configured
    JAX schedule, float32 and bfloat16 (3e-2)."""
    for dtype, tol in (("float32", TOL), ("bfloat16", dict(atol=3e-2,
                                                          rtol=0))):
        jcfg, params, model = _pair(arch, dtype)
        jcfg = jcfg.with_(moe_impl=impl)
        cfg = model.cfg.with_(moe_impl=impl)
        p, blk = _ffn(params, model)
        jx, tx = _x((16, 1, jcfg.d_model), 4, jnp.dtype(dtype))
        jy, _ = jmoe.moe(p, jx, jcfg)
        with torch.no_grad():
            y = moe.moe_step(blk, tx, cfg)
        assert y.dtype == tx.dtype and y.shape == tx.shape
        _close(y, jy, **tol)


def _ring_pairs(model, state, jstate):
    for r in range(model.cfg.n_layers):
        jc = jstate["s0"]["b0_attn_moe"]["kv"]
        ring = jc["k"].shape[2]
        yield state.k[r][:, :ring], jc["k"][r]
        yield state.v[r][:, :ring], jc["v"][r]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(zoo, arch):
    """64 steps at max_len 64 (mixtral's ring is min(64, 16) = 16 slots, so
    it wraps 4 times): logits and both layers' rings."""
    jcfg, params, model = zoo[arch]
    rows, steps = 3, 64
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size,
                                             (rows, steps))
    jstate = j_init_state(jcfg, rows, steps)
    state = init_state(model, rows, steps)
    assert state.length == {"mixtral-8x22b": 16,
                            "phi3.5-moe-42b-a6.6b": 64}[arch]
    step = _jstep(jcfg)
    for t in range(steps):
        jlg, jstate = step(params, jstate,
                           jnp.asarray(toks[:, t:t + 1], jnp.int32),
                           jnp.int32(t))
        lg = decode_step(model, state, torch.as_tensor(toks[:, t:t + 1]), t)
        assert lg.shape == (rows, model.cfg.vocab_padded)
        _close(lg, jlg, **TOL)
    for got, want in _ring_pairs(model, state, jstate):
        _close(got, want, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_decode_step_tracks_reference(arch, monkeypatch):
    """64 bfloat16 steps: within 3e-2 wherever both sides route alike;
    every routing difference is a near tie of JAX's probabilities, and at
    most 4 steps route differently."""
    jcfg, params, model = _pair(arch, "bfloat16")
    rows, steps = 3, 64
    seen = {"jax": [], "port": []}

    def j_route(p, x2, cfg):
        w, ids, aux = _j_route(p, x2, cfg)
        probs = jax.nn.softmax(jnp.einsum("nd,de->ne", x2, p["router"])
                               .astype(jnp.float32), axis=-1)
        jax.debug.callback(lambda i, q: seen["jax"].append(
            (np.asarray(i), np.asarray(q))), ids, probs, ordered=True)
        return w, ids, aux

    def t_gate(p, x2, cfg):
        probs, w, ids = _t_gate(p, x2, cfg)
        seen["port"].append(ids.numpy())
        return probs, w, ids

    _j_route, _t_gate = jmoe._route, moe._gate
    monkeypatch.setattr(jmoe, "_route", j_route)
    monkeypatch.setattr(moe, "_gate", t_gate)
    step = jax.jit(lambda p, s, tok, pos: j_decode_step(p, s, tok, pos,
                                                        jcfg))
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size,
                                             (rows, steps))
    jstate = j_init_state(jcfg, rows, steps)
    state = init_state(model, rows, steps)
    agreed = 0
    for t in range(steps):
        seen["jax"].clear()
        seen["port"].clear()
        jlg, jstate = step(params, jstate,
                           jnp.asarray(toks[:, t:t + 1], jnp.int32),
                           jnp.int32(t))
        jax.effects_barrier()
        lg = decode_step(model, state, torch.as_tensor(toks[:, t:t + 1]), t)
        assert lg.dtype == torch.bfloat16
        assert len(seen["jax"]) == len(seen["port"]) == jcfg.n_layers
        same = True
        for (jids, probs), ids in zip(seen["jax"], seen["port"]):
            for r, j in zip(*np.nonzero(jids != ids)):
                # JAX's pick and the port's at rank j: a near tie
                pa, pb = probs[r, jids[r, j]], probs[r, ids[r, j]]
                assert abs(pa - pb) <= 2 ** -7 * max(pa, pb), (
                    t, jids[r], ids[r], probs[r])
                same &= set(jids[r]) == set(ids[r])
        if same:        # the same experts (perhaps in another order)
            agreed += 1
            np.testing.assert_allclose(lg.float().numpy(),
                                       np.asarray(jlg, np.float32),
                                       atol=3e-2, rtol=0)
    assert agreed >= steps - 4


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_equals_step_scan(zoo, arch):
    """Two chunks of 12 (pos0 = 0 and 12, row 1 ragged at 7 live steps in
    the second) against 24 single steps: every live logit and the rings
    bitwise equal (each MoE FFN runs per position at the step's
    shapes)."""
    _, _, model = zoo[arch]
    rows, s_len, max_len = 3, 12, 24
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, model.cfg.vocab_size, (rows, 2 * s_len)))
    st_p = init_state(model, rows, max_len)
    st_s = init_state(model, rows, max_len)
    for c, nv in enumerate(([12, 12, 12], [12, 7, 12])):
        pos0 = torch.full((rows,), c * s_len, dtype=torch.int64)
        n_valid = torch.as_tensor(nv)
        lp = prefill_chunk(model, st_p, toks[:, c * s_len:(c + 1) * s_len],
                           pos0, n_valid)
        for t in range(s_len):
            live = torch.as_tensor(nv) > t
            pos = pos0 + torch.minimum(torch.tensor(t), n_valid)
            before = (st_s.k.clone(), st_s.v.clone())
            ls = decode_step(model, st_s, toks[:, c * s_len + t:
                                               c * s_len + t + 1], pos)
            assert torch.equal(lp[live, t], ls[live])
            for new, old in zip((st_s.k, st_s.v), before):
                new[:, ~live] = old[:, ~live]    # frozen rows write nothing
    assert torch.equal(st_p.k, st_s.k) and torch.equal(st_p.v, st_s.v)


def test_prefill_matches_reference_step_scan_where_jax_drops():
    """mixtral SMOKE, 4 rows x 16 positions: JAX's own ``prefill_chunk``
    ranks 16 tokens a row into 12 slots an expert and drops some, so it
    differs from JAX's step scan by more than 1e-2; the port's prefill
    (no drops) matches JAX's step scan within 1e-5."""
    jcfg, params, model = _pair("mixtral-8x22b")
    rows, s_len = 4, 16
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size,
                                             (rows, s_len))
    step = _jstep(jcfg)
    jstate = j_init_state(jcfg, rows, s_len)
    jsteps = []
    for t in range(s_len):
        jlg, jstate = step(params, jstate,
                           jnp.asarray(toks[:, t:t + 1], jnp.int32),
                           jnp.int32(t))
        jsteps.append(np.asarray(jlg))
    jsteps = np.stack(jsteps, 1)
    zeros = jnp.zeros((rows,), jnp.int32)
    jpre, _ = jax.jit(lambda *a: j_prefill_chunk(*a, jcfg))(
        params, j_init_state(jcfg, rows, s_len),
        jnp.asarray(toks, jnp.int32), zeros, zeros + s_len)
    gap = np.abs(np.asarray(jpre) - jsteps).max()
    assert gap > 1e-2
    lp = prefill_chunk(model, init_state(model, rows, s_len),
                       torch.as_tensor(toks), torch.zeros(rows, dtype=
                                                          torch.int64),
                       torch.full((rows,), s_len, dtype=torch.int64))
    _close(lp, jsteps, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_to_reference_inverts_from_reference(zoo, arch):
    jcfg, params, model = zoo[arch]
    want = jax.tree.map(np.asarray, params)
    back = to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    assert set(back["tok"]) == {"embedding", "lm_head"}
    assert back["stages"]["s0"]["b0_attn_moe"]["ffn"]["wi_gate"].shape == (
        jcfg.n_layers, jcfg.n_experts, jcfg.d_model, jcfg.d_ff)
    jax.tree.map(np.testing.assert_array_equal, back, want)


def test_bfloat16_moe_tree_converts_by_bit_pattern():
    jcfg = j_get_smoke_config("mixtral-8x22b").with_(dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        j_init_model(jcfg, jax.random.PRNGKey(3)))
    model = from_reference(tree, get_smoke_config("mixtral-8x22b").with_(
        dtype="bfloat16"), device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    for got, want in ((model.blocks[1].ffn.wo,
                       tree["stages"]["s0"]["b0_attn_moe"]["ffn"]["wo"][1]),
                      (model.lm_head, tree["tok"]["lm_head"])):
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16),
            want.view(np.uint16))
    back = to_reference(model)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a, np.asarray(b, np.float32)), back, tree)


@pytest.mark.parametrize("impl", ["capacity", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(zoo, arch, impl):
    """Hidden states and the summed aux over 2 x 32 tokens (mixtral's
    window of 16 masks the training attention), and ``loss_fn`` with its
    0.01 x aux, against JAX's."""
    jcfg, params, _ = zoo[arch]
    jcfg = jcfg.with_(moe_impl=impl)
    model = from_reference(jax.tree.map(np.asarray, params),
                           get_smoke_config(arch).with_(moe_impl=impl),
                           device="cpu")
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jcfg.vocab_size, (2, 32))
    labels = rng.integers(0, jcfg.vocab_size, (2, 32))
    jx, jaux = j_forward(params, jnp.asarray(toks, jnp.int32), jcfg)
    with torch.no_grad():
        x, aux = model(torch.as_tensor(toks))
    _close(x, jx, **TOL)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    jl = j_loss_fn(params, {"tokens": jnp.asarray(toks, jnp.int32),
                            "labels": jnp.asarray(labels, jnp.int32)}, jcfg)
    loss = loss_fn(model, {"tokens": torch.as_tensor(toks),
                           "labels": torch.as_tensor(labels)})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)


def test_sliding_window_training_mask_matches_reference(zoo):
    """``attn_forward`` under mixtral's 16-position window over 40
    positions, against JAX's (keys older than the window masked)."""
    jcfg, params, model = zoo["mixtral-8x22b"]
    p = jax.tree.map(lambda a: a[0],
                     params["stages"]["s0"]["b0_attn_moe"]["attn"])
    a = model.blocks[0].attn
    jx, tx = _x((2, 40, jcfg.d_model), 10)
    with torch.no_grad():
        y = attn_forward(a, tx, model.cfg)
        full = attn_forward(a, tx, model.cfg.with_(sliding_window=0))
    _close(y, j_attn_forward(p, jx, jcfg), **TOL)
    assert torch.equal(y[:, :16], full[:, :16])
    assert float((y[:, 16:] - full[:, 16:]).abs().max()) > 1e-4


def _blob(model, toks, backend="coder"):
    st = compress.lm_compress_chunked(model, toks, CHUNK, backend=backend,
                                      device="cpu")
    return bitstream.pack_chunked(*st.chunks, chunk_size=CHUNK,
                                  n_symbols=toks.shape[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_roundtrip_bit_exact(zoo, arch):
    """2 lanes x 36 tokens (mixtral's ring wraps twice): kernel and coder
    containers byte-identical, the three decodes exact, probes equal."""
    model = zoo[arch][2]
    toks = token_stream(model.cfg.vocab_size, (2, 36), seed=3)
    blob = _blob(model, toks, "kernel")
    assert blob == _blob(model, toks, "coder")
    slab = bitstream.parse_chunked(blob)
    probes = []
    for backend in ("kernel", "coder", "two_pass"):
        sym, _, lp = compress.lm_decompress_chunked(
            model, slab, 36, CHUNK, backend=backend, lane_probes=True,
            device="cpu")
        np.testing.assert_array_equal(sym.numpy(), toks)
        probes.append(lp.numpy())
    np.testing.assert_array_equal(probes[0], probes[1])
    np.testing.assert_array_equal(probes[0], probes[2])


@pytest.mark.parametrize("arch", ARCHS)
def test_state_geometry_equals_reference(arch):
    cfg, jcfg = get_smoke_config(arch), j_get_smoke_config(arch)
    assert tuple(state_spec(cfg)) == tuple(j_state_spec(jcfg))
    assert can_prefill(cfg) == j_can_prefill(jcfg) is True
    for max_len in (8, 16, 32, 4096):
        assert ring_length(cfg, max_len) == j_ring_length(jcfg, max_len)
        assert wrap_length(cfg, max_len) == j_wrap_length(jcfg, max_len)


@pytest.mark.parametrize("mode", ["auto", "off"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_byte_identical(zoo, arch, mode):
    """2 slots x 2 lanes at max_len 32: requests of 16 and 12 tokens (they
    fit mixtral's 16-slot ring, so "auto" runs them as prefill cycles),
    then a longer one (40 tokens wrap mixtral's window; phi3.5's full
    attention takes 28) beside a decompress, on the step loop; every blob
    equals the single-request path's and decodes exactly."""
    model = zoo[arch][2]
    eng = BatchEngine(model, slots=2, lanes=2, chunk_size=CHUNK, max_len=32,
                      prefill=mode, step_backend="kernel", device="cpu")
    a, b = (token_stream(model.cfg.vocab_size, (2, n), seed=s)
            for n, s in ((16, 11), (12, 12)))
    rids = [eng.submit_compress(x) for x in (a, b)]
    res = eng.run()
    assert (eng.prefill_cycles > 0) == (mode == "auto")
    for rid, x in zip(rids, (a, b)):
        assert res[rid].ok and res[rid].blob == _blob(model, x)
    n_long = 40 if model.cfg.window else 28
    long_toks = token_stream(model.cfg.vocab_size, (2, n_long), seed=13)
    n_prefill = eng.prefill_cycles
    rid = eng.submit_compress(long_toks)
    did = eng.submit_decompress(res[rids[0]].blob)
    out = eng.run()
    if model.cfg.window:            # longer than the ring: never prefilled
        assert eng.prefill_cycles == n_prefill
    assert out[rid].ok and out[rid].blob == _blob(model, long_toks)
    np.testing.assert_array_equal(out[did].tokens, a)


def test_engine_window_wrap_rules(zoo):
    """mixtral's window against the engine's ring: at max_len 8 (< the
    16-position window) a 12-token request would wrap a ring narrower than
    the single-request path's and is refused unless ``allow_wrap``; at
    max_len 16 a 40-token one is admitted (the ring is the window on both
    paths), runs on the step loop and equals the single-request blob."""
    model = zoo["mixtral-8x22b"][2]
    toks = token_stream(model.cfg.vocab_size, (2, 12), seed=14)
    eng = BatchEngine(model, slots=1, lanes=2, chunk_size=CHUNK, max_len=8,
                      device="cpu")
    assert (eng.ring_len, eng._wrap_len) == (8, 8)
    with pytest.raises(ValueError, match="exceeds the engine ring"):
        eng.submit_compress(toks)
    rid = eng.submit_compress(toks, allow_wrap=True)
    blob = eng.run()[rid].blob
    did = eng.submit_decompress(blob, allow_wrap=True)
    np.testing.assert_array_equal(eng.run()[did].tokens, toks)
    eng = BatchEngine(model, slots=1, lanes=2, chunk_size=CHUNK, max_len=16,
                      device="cpu")
    assert (eng.ring_len, eng._wrap_len) == (16, None)
    long_toks = token_stream(model.cfg.vocab_size, (2, 40), seed=15)
    rid = eng.submit_compress(long_toks)
    assert eng.run()[rid].blob == _blob(model, long_toks)
    assert eng.prefill_cycles == 0


@pytest.mark.parametrize("mode,want", [
    ("compress", "bit-exact roundtrip: True"),
    ("engine", "byte-identical to the single-request path")])
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_moe(arch, mode, want, capsys):
    launcher.main(["--arch", arch, "--mode", mode, "--device", "cpu",
                   "--lanes", "2", "--symbols", "24", "--streams", "3",
                   "--backend", "kernel"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "family=moe" in out and want in out


def test_init_model_draws_on_the_device_alike_on_the_cpu():
    """``draw="device"`` (the full-width card path) builds the same model
    as the default draw when the device is the CPU."""
    cfg = get_smoke_config("mixtral-8x22b").with_(dtype="bfloat16")
    a = init_model(cfg, seed=5, device="cpu")
    b = init_model(cfg, seed=5, device="cpu", draw="device")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert x.dtype == y.dtype == torch.bfloat16 and torch.equal(x, y), n
    with pytest.raises(ValueError, match="unknown draw"):
        init_model(cfg, device="cpu", draw="host")
