"""Port step path with per-row positions, ``prefill_chunk``, the protocol
surface, the registry and ``ops.rans_decode_step_rows`` against the JAX
reference (CPU).

* ``decode_step`` with a ``(B,)`` vector of per-row positions matches
  JAX's within atol/rtol 1e-4 (the frameworks' reduction orders differ),
  and in the port an int position gives logits and cache bitwise equal to
  a constant vector;
* ``prefill_chunk`` matches JAX's within 1e-4, and is bitwise the port's
  own sequential steps (``pos0`` 0 and > 0; ragged ``n_valid`` on the
  live positions); the batching engine keeps each slot's state bitwise
  the single-request path's;
* ``state_spec``/``ring_length``/``wrap_length``/``can_prefill`` equal
  JAX's; the registry's named errors;
* ``rans_decode_step_rows`` is integer-identical to JAX's on both
  backends (the Pallas kernel in interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import models as jmodels
from repro.configs import registry as jregistry
from repro.configs.ras_pimc import CONFIG as J_CONFIG
from repro.configs.ras_pimc import SMOKE as J_SMOKE
from repro.core import spc as jspc
from repro.data.pipeline import token_stream
from repro.kernels import ops as jops
from repro.models.transformer import (decode_step as j_decode_step,
                                      init_cache as j_init_cache,
                                      prefill_chunk as j_prefill_chunk)
from repro_torch import configs as registry
from repro_torch import models
from repro_torch.configs.ras_pimc import CONFIG, SMOKE
from repro_torch.core import spc, u32
from repro_torch.kernels import ops
from repro_torch.models.convert import from_reference
from repro_torch.serve import compress
from repro_torch.serve.engine import BatchEngine

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one CPU thread: its ops are small, and beside
    other busy test processes torch's idle worker threads spin for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def converted():
    params = jmodels.init_model(J_SMOKE, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, params)
    return params, from_reference(tree, SMOKE, device="cpu")


def _toks(b, s, seed):
    return np.asarray(token_stream(SMOKE.vocab_size, (b, s), seed=seed),
                      np.int64)


def test_per_row_positions_match_reference(converted):
    """Rows at different positions (a slot admitted later than another)
    step through one call: logits within 1e-4 of JAX's vector path."""
    params, model = converted
    b, steps, max_len = 4, 6, 16
    offs = np.asarray([0, 2, 5, 0])          # row r starts at position offs[r]
    toks = _toks(b, steps + 5, 21)
    jcache = j_init_cache(J_SMOKE, b, max_len)
    state = model.init_state(b, max_len)
    for t in range(steps + 5):
        live = t >= offs
        pos = np.where(live, t - offs, 0)
        tok = toks[:, t:t + 1]
        jlg, jcache = j_decode_step(params, jcache,
                                    jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(pos, jnp.int32), J_SMOKE)
        lg = models.decode_step(model, state, torch.as_tensor(tok),
                                torch.as_tensor(pos))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("max_len", [16, 6])     # linear cache and a ring
def test_scalar_position_is_a_constant_vector_bitwise(converted, max_len):
    _, model = converted
    b, steps = 3, 9
    toks = torch.as_tensor(_toks(b, steps, 22))
    sa, sb = model.init_state(b, max_len), model.init_state(b, max_len)
    for t in range(steps):
        la = models.decode_step(model, sa, toks[:, t:t + 1], t)
        lb = models.decode_step(model, sb, toks[:, t:t + 1],
                                torch.full((b,), t, dtype=torch.int64))
        assert torch.equal(la, lb)
    assert torch.equal(sa.k, sb.k) and torch.equal(sa.v, sb.v)


def _warm(model, toks, warm, max_len):
    state = model.init_state(toks.shape[0], max_len)
    for t in range(warm):
        models.decode_step(model, state, toks[:, t:t + 1], t)
    return state


def _clone(state):
    return type(state)(state.k.clone(), state.v.clone(), state.length)


def test_prefill_chunk_matches_reference(converted):
    params, model = converted
    b, s, warm, max_len = 4, 8, 3, 16
    toks = _toks(b, warm + s, 9)
    jcache = j_init_cache(J_SMOKE, b, max_len)
    for t in range(warm):
        _, jcache = j_decode_step(params, jcache,
                                  jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                  t, J_SMOKE)
    pos0 = np.full((b,), warm, np.int32)
    nv = np.full((b,), s, np.int32)
    jlg, _ = j_prefill_chunk(params, jcache, jnp.asarray(toks[:, warm:]),
                             jnp.asarray(pos0), jnp.asarray(nv), J_SMOKE)
    state = _warm(model, torch.as_tensor(toks), warm, max_len)
    lg = models.prefill_chunk(model, state, torch.as_tensor(toks[:, warm:]),
                              torch.as_tensor(pos0), torch.as_tensor(nv))
    assert lg.shape == (b, s, SMOKE.vocab_padded)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("warm", [0, 3])
def test_prefill_chunk_bitwise_matches_decode_steps(converted, warm):
    """One prefill chunk (pos0 = ``warm``, ragged n_valid) == S steps at
    positions ``pos0 + min(t, n_valid)``: bitwise on every live logit and
    on every ring slot but the frozen rows' clamped one (which the step
    path writes and the next chunk's first step overwrites)."""
    _, model = converted
    b, s, max_len = 6, 8, 16
    toks = torch.as_tensor(_toks(b, warm + s, 9))
    nv = torch.as_tensor([8, 8, 5, 1, 0, 8])
    pos0 = torch.full((b,), warm, dtype=torch.int64)
    step = _warm(model, toks, warm, max_len)
    pf = _clone(step)
    ref = []
    for t in range(s):
        pos = pos0 + torch.clamp(nv, max=t)
        ref.append(models.decode_step(model, step,
                                      toks[:, warm + t:warm + t + 1], pos))
    ref = torch.stack(ref, 1)
    lg = models.prefill_chunk(model, pf, toks[:, warm:], pos0, nv)
    for r in range(b):
        n = int(nv[r])
        assert torch.equal(lg[r, :n], ref[r, :n]), r
        keep = torch.ones(pf.k.shape[2], dtype=torch.bool)
        if n < s:
            keep[warm + n] = False
        for a, c in ((pf.k, step.k), (pf.v, step.v)):
            assert torch.equal(a[:, r][:, keep], c[:, r][:, keep]), r


@pytest.mark.parametrize("prefill", ["off", "auto"])
def test_engine_slots_keep_the_single_request_state(converted, prefill):
    """Two slots of 3 lanes serving requests of 10 and 7 symbols in a
    24-slot ring: each slot's state after the run is bitwise the
    single-request path's after the same tokens (the same ring length),
    through the step loop and through prefill chunks."""
    _, model = converted
    lanes, lengths = 3, (10, 7)
    eng = BatchEngine(model, slots=2, lanes=lanes, chunk_size=4, max_len=24,
                      prefill=prefill, device="cpu")
    toks = [_toks(lanes, n, 23 + n) for n in lengths]
    rids = [eng.submit_compress(t) for t in toks]
    res = eng.run()
    assert eng.prefill_cycles == (0 if prefill == "off" else 3)
    for rid, t in zip(rids, toks):
        assert res[rid].ok
        inputs = torch.cat([torch.full((lanes, 1), compress.BOS),
                            torch.as_tensor(t[:, :-1]).long()], 1)
        alone = compress.teacher_forced_scan(model, inputs, t.shape[1],
                                             lambda lg, i: None)
        st = eng._states[res[rid].slot]
        assert st.length == alone.length == t.shape[1]
        assert torch.equal(st.k, alone.k) and torch.equal(st.v, alone.v)


@pytest.mark.parametrize("cfg_pair", [(CONFIG, J_CONFIG), (SMOKE, J_SMOKE)])
def test_state_geometry_matches_reference(cfg_pair):
    cfg, jcfg = cfg_pair
    assert tuple(models.state_spec(cfg)) == tuple(jmodels.state_spec(jcfg))
    assert models.can_prefill(cfg) == jmodels.can_prefill(jcfg)
    for max_len in (1, 16, 64, 1000, 1024):
        assert models.ring_length(cfg, max_len) == jmodels.ring_length(
            jcfg, max_len)
        assert models.wrap_length(cfg, max_len) == jmodels.wrap_length(
            jcfg, max_len)
    for window in (8, 4096):     # the protocol classifies windows already
        for field in ("sliding_window", "local_window"):
            a, b = cfg.with_(**{field: window}), jcfg.with_(**{field: window})
            assert tuple(models.state_spec(a)) == tuple(
                jmodels.state_spec(b))
            for max_len in (16, 8192):
                assert models.wrap_length(a, max_len) == jmodels.wrap_length(
                    b, max_len)
                assert models.ring_length(a, max_len) == jmodels.ring_length(
                    b, max_len)


def test_registry_and_protocol_named_errors():
    """The registry's and the protocol's named errors; a dense
    ``sliding_window`` masks its ring as JAX's does (20 steps of an
    8-position window, logits within 1e-4)."""
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    assert registry.SERVE_SMOKE_ARCHS == jregistry.SERVE_SMOKE_ARCHS
    assert registry.get_config("ras-pimc") == CONFIG
    assert registry.get_smoke_config("ras-pimc") == SMOKE
    assert registry.get_protocol("ras-pimc").family == "dense"
    assert registry.PORTED == jregistry.ARCH_IDS     # every id resolves
    assert registry.get_config("llama-3.2-vision-11b").family == "vlm"
    with pytest.raises(KeyError, match="unknown arch 'gpt-9'"):
        registry.get_smoke_config("gpt-9")
    with pytest.raises(KeyError, match="family 'gpt'"):
        models.get_protocol(CONFIG.with_(family="gpt"))
    jcfg = J_SMOKE.with_(sliding_window=8)
    params = jmodels.init_model(jcfg, jax.random.PRNGKey(4))
    model = from_reference(jax.tree.map(np.asarray, params),
                           SMOKE.with_(sliding_window=8), device="cpu")
    b, steps = 2, 20
    toks = _toks(b, steps, 23)
    jcache = j_init_cache(jcfg, b, steps)
    state = model.init_state(b, steps)
    assert state.length == models.ring_length(model.cfg, steps) == 8
    step = jax.jit(lambda c, tok, pos: j_decode_step(params, c, tok, pos,
                                                     jcfg))
    for t in range(steps):
        jlg, jcache = step(jcache, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                           jnp.int32(t))
        lg = models.decode_step(model, state, torch.as_tensor(
            toks[:, t:t + 1]), t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("backend", ["coder", "kernel"])
def test_decode_step_rows_matches_reference(backend):
    """One pop over 3 slots x 4 lanes of rows, each row its own stream,
    state and candidates: symbols, states, cursors, probes and flags are
    integer-identical to JAX's (the Pallas kernel in interpret mode),
    over a few steps, one row truncated so it over-reads."""
    rng = np.random.default_rng(31)
    rows, k, cap, steps = 12, 64, 24, 6
    probs = rng.dirichlet(np.full(k, 0.5), size=(steps, rows)).astype(
        np.float32)
    jt = jspc.tables_from_probs(jnp.asarray(probs))
    tt = spc.tables_from_probs(torch.as_tensor(probs))
    np.testing.assert_array_equal(tt.freq.numpy(), np.asarray(jt.freq))
    buf = rng.integers(0, 256, (rows, cap)).astype(np.uint8)
    buf[5, 10:] = 0                             # zeros, then read past cap
    s = rng.integers(1 << 23, 1 << 31, rows).astype(np.uint32)
    ptr = rng.integers(4, cap - 4, rows).astype(np.int32)
    ptr[5] = cap - 1
    cands = rng.integers(0, k, (steps, rows, 3)).astype(np.int32)
    js, jp = jnp.asarray(s), jnp.asarray(ptr)
    ts = u32.bits(torch.as_tensor(s.astype(np.int64)))
    tp = torch.as_tensor(ptr)
    for t in range(steps):
        jout = jops.rans_decode_step_rows(
            jnp.asarray(buf.T), js, jp, jspc.TableSet(*(a[t] for a in jt)),
            candidates=jnp.asarray(cands[t]), backend=backend,
            interpret=True)
        tout = ops.rans_decode_step_rows(
            torch.as_tensor(buf), ts, tp, spc.FreqCdf(tt.freq[t], tt.cdf[t]),
            candidates=torch.as_tensor(cands[t]), backend=backend)
        np.testing.assert_array_equal(u32.value(tout[0]).numpy(),
                                      np.asarray(jout[0]).astype(np.int64))
        for a, b in zip(tout[1:], jout[1:]):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        js, jp, ts, tp = jout[0], jout[1], tout[0], tout[1]
    assert int(tout[4].sum()) > 0           # the truncated row over-read
    with pytest.raises(ValueError, match="unknown step backend"):
        ops.rans_decode_step_rows(torch.as_tensor(buf), ts, tp,
                                  spc.FreqCdf(tt.freq[0], tt.cdf[0]),
                                  backend="pallas")
