"""Port batching engine: continuous batching + the byte-identity contract
(CPU, plain versions of the kernels).

Every engine blob must equal the port's single-request
``lm_compress_chunked`` + ``pack_chunked`` blob, and every decompress
request the single-request ``lm_decompress_chunked`` tokens and per-lane
probes, whatever the co-batched traffic: the ``tests/test_engine_batch.py``
cases (but the mesh one) with the port's path as the byte oracle, plus a
truncated container retiring alone.  The scheduler is held to the JAX
engine's: the same seeded Poisson workload under the virtual clock gives
the same admission log and prefill cycle count.  The B1-routed chunk
encode equals ``coder.encode``, overflow included, and greedy ``generate``
matches JAX's logits within 1e-4.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.ras_pimc import SMOKE as J_SMOKE
from repro.models import init_model as j_init_model
from repro.serve import engine as jengine
from repro_torch.configs.ras_pimc import SMOKE
from repro_torch.core import bitstream, coder, spc
from repro_torch.data.pipeline import token_stream
from repro_torch.kernels import ops
from repro_torch.models import decode_step, init_model, init_state
from repro_torch.models.convert import from_reference
from repro_torch.serve import engine
from repro_torch.serve.compress import (lm_compress_chunked,
                                        lm_decompress_chunked)
from repro_torch.serve.engine import (BatchEngine, EngineQueueFullError,
                                      RequestOverflowError)

jax.config.update("jax_platforms", "cpu")

LANES = 4

_GEN_PATH = os.path.join(os.path.dirname(__file__), "golden_vectors")
sys.path.insert(0, _GEN_PATH)
from generate import CASES, build_case  # noqa: E402


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
def model():
    return init_model(SMOKE, seed=2, device="cpu")


def _tokens(t_len, seed):
    return np.asarray(token_stream(SMOKE.vocab_size, (LANES, t_len),
                                   seed=seed), np.int64)


def _engine(model, **kw):
    kw.setdefault("slots", 2)
    return BatchEngine(model, lanes=LANES, device="cpu", **kw)


def _ref_blob(model, toks, chunk_size, backend="coder"):
    """The single-request reference: lm_compress_chunked -> container."""
    st = lm_compress_chunked(model, toks, chunk_size, backend=backend,
                             device="cpu")
    return bitstream.pack_chunked(*st.chunks, chunk_size=chunk_size,
                                  n_symbols=toks.shape[1])


def _truncated(blob):
    """The same container with the last 3 bytes cut from every cell."""
    cs = bitstream.parse_chunked(blob)
    ch = bitstream.slab_to_chunked(cs, "cpu")
    return bitstream.pack_chunked(
        ch.buf[..., :-3], ch.start, ch.length - 3,
        chunk_size=cs.meta.chunk_size, n_symbols=cs.meta.n_symbols)


def test_ragged_join_retire_byte_identity(model):
    """Three ragged requests through two slots: the third admits once a
    slot frees, and every blob equals its single-request reference."""
    eng = _engine(model, chunk_size=8, max_len=32)
    toks = [_tokens(20, 3), _tokens(16, 4), _tokens(9, 5)]
    rids = [eng.submit_compress(t) for t in toks]
    res = eng.run()
    for rid, t in zip(rids, toks):
        assert res[rid].ok, res[rid].error
        assert res[rid].blob == _ref_blob(model, t, 8)
    cycles = {rid: cyc for rid, _slot, cyc in eng.admission_log}
    assert cycles[rids[0]] == 0 and cycles[rids[1]] == 0
    assert cycles[rids[2]] > 0


@pytest.mark.parametrize("backend", ["coder", "kernel"])
def test_mixed_compress_decompress_cobatch(model, backend):
    """Compress and decompress requests share the step loop; decoded
    tokens and per-lane probes equal the single-request decode's."""
    t_a, t_b = _tokens(16, 6), _tokens(12, 7)
    blob_b = _ref_blob(model, t_b, 8, backend)
    eng = _engine(model, chunk_size=8, max_len=32, step_backend=backend)
    rc = eng.submit_compress(t_a)
    rd = eng.submit_decompress(blob_b)
    res = eng.run()
    assert res[rc].ok and res[rc].blob == _ref_blob(model, t_a, 8, backend)
    assert res[rd].ok, res[rd].error
    np.testing.assert_array_equal(res[rd].tokens, t_b)
    sym, _, lane_probes = lm_decompress_chunked(
        model, bitstream.parse_chunked(blob_b), t_b.shape[1], 8,
        backend=backend, lane_probes=True, device="cpu")
    np.testing.assert_array_equal(res[rd].tokens, sym.numpy())
    np.testing.assert_array_equal(res[rd].lane_probes, lane_probes.numpy())
    assert res[rd].probes == int(lane_probes.sum())
    assert eng.prefill_cycles == 0


def test_golden_vector_corpus_identity(model):
    """The golden-vector symbol payloads (lanes=4, k < vocab) compress
    through the engine byte-identically to the single-request path."""
    eng = _engine(model, chunk_size=16, max_len=64)
    payloads, rids = [], []
    for case in CASES:
        _tbl, syms = build_case(case)
        payloads.append(np.asarray(syms, np.int64))
        rids.append(eng.submit_compress(payloads[-1]))
    res = eng.run()
    for rid, toks in zip(rids, payloads):
        assert res[rid].ok, res[rid].error
        assert res[rid].blob == _ref_blob(model, toks, 16)


def test_poisson_admission_matches_reference(model):
    """Seeded Poisson arrivals on the virtual clock: the port schedules as
    the JAX engine does (admission log and prefill cycles), two runs are
    identical, and every blob equals the single-request reference."""
    rng = np.random.default_rng(17)
    arrivals = np.cumsum(rng.exponential(2.0, size=5))
    toks = [_tokens(12 + 4 * (i % 2), 20 + i) for i in range(5)]

    def run_once():
        eng = _engine(model, chunk_size=8, max_len=16)
        rids = [eng.submit_compress(t, arrival=float(a))
                for t, a in zip(toks, arrivals)]
        res = eng.run(clock="virtual")
        return eng, [res[r].blob for r in rids]

    eng1, blobs1 = run_once()
    eng2, blobs2 = run_once()
    assert eng1.admission_log == eng2.admission_log and blobs1 == blobs2
    for t, b in zip(toks, blobs1):
        assert b == _ref_blob(model, t, 8)
    jeng = jengine.BatchEngine(j_init_model(J_SMOKE, jax.random.PRNGKey(2)),
                               J_SMOKE, slots=2, lanes=LANES, chunk_size=8,
                               max_len=16)
    for t, a in zip(toks, arrivals):
        jeng.submit_compress(t.astype(np.int32), arrival=float(a))
    jeng.run(clock="virtual")
    assert eng1.admission_log == jeng.admission_log
    assert eng1.prefill_cycles == jeng.prefill_cycles > 0


def test_overflow_isolation(model):
    """A request whose byte budget overflows dies with a named error; the
    co-batched neighbour's blob is untouched."""
    t_small_cap, t_ok = _tokens(16, 30), _tokens(16, 31)
    eng = _engine(model, chunk_size=8, max_len=16, step_backend="kernel")
    r_bad = eng.submit_compress(t_small_cap, cap=5)
    r_ok = eng.submit_compress(t_ok)
    res = eng.run()
    assert not res[r_bad].ok
    assert isinstance(res[r_bad].error, RequestOverflowError)
    assert "cap=5" in str(res[r_bad].error)
    assert res[r_ok].ok
    assert res[r_ok].blob == _ref_blob(model, t_ok, 8)


def test_truncated_decompress_retires_alone(model):
    """A container cut short over-reads: its request retires with
    StreamExhaustedError and its neighbours stay byte-identical."""
    t_a, t_b, t_c = _tokens(16, 32), _tokens(16, 33), _tokens(12, 34)
    blob_b = _ref_blob(model, t_b, 8)
    eng = _engine(model, slots=3, chunk_size=8, max_len=16,
                  step_backend="kernel")
    rc = eng.submit_compress(t_a)
    rbad = eng.submit_decompress(_truncated(blob_b))
    rd = eng.submit_decompress(_ref_blob(model, t_c, 8))
    res = eng.run()
    assert not res[rbad].ok
    assert isinstance(res[rbad].error, coder.StreamExhaustedError)
    assert res[rc].ok and res[rc].blob == _ref_blob(model, t_a, 8)
    assert res[rd].ok
    np.testing.assert_array_equal(res[rd].tokens, t_c)
    with pytest.raises(coder.StreamExhaustedError):
        lm_decompress_chunked(model,
                              bitstream.parse_chunked(_truncated(blob_b)),
                              16, 8, device="cpu")


def test_queue_full_rejects_at_the_door(model):
    eng = _engine(model, slots=1, chunk_size=8, max_len=16, max_queue=1)
    eng.submit_compress(_tokens(8, 40))
    with pytest.raises(EngineQueueFullError):
        eng.submit_compress(_tokens(8, 41))


def test_kernel_step_backend_parity(model):
    """The kernel step backend (B6 + B2 + B1 wrappers) and the coder step
    backend are the same codec: identical blobs and tokens."""
    toks = _tokens(12, 50)
    blob = _ref_blob(model, toks, 8)
    out = {}
    for backend in ("coder", "kernel"):
        eng = _engine(model, slots=2, chunk_size=8, max_len=16,
                      step_backend=backend, prefill="off")
        rc = eng.submit_compress(toks)
        rd = eng.submit_decompress(blob)
        res = eng.run()
        assert res[rc].ok and res[rd].ok
        out[backend] = (res[rc].blob, res[rd].tokens, res[rd].lane_probes)
    assert out["coder"][0] == out["kernel"][0] == blob
    for a, b in zip(out["coder"][1:], out["kernel"][1:]):
        np.testing.assert_array_equal(a, b)


def test_prefill_fast_path_byte_identity(model):
    """Compress-only cycles take ``prefill_chunk``; every blob equals both
    the ``prefill="off"`` step loop and the single-request reference."""
    toks = [_tokens(20, 70), _tokens(16, 71), _tokens(9, 72)]
    blobs, pf = {}, {}
    for mode in ("auto", "off"):
        eng = _engine(model, chunk_size=8, max_len=32, prefill=mode,
                      step_backend="kernel")
        rids = [eng.submit_compress(t) for t in toks]
        res = eng.run()
        for rid in rids:
            assert res[rid].ok, res[rid].error
        blobs[mode] = [res[r].blob for r in rids]
        pf[mode] = eng.prefill_cycles
    assert pf["auto"] > 0 and pf["off"] == 0
    assert blobs["auto"] == blobs["off"]
    for t, b in zip(toks, blobs["auto"]):
        assert b == _ref_blob(model, t, 8)


def test_prefill_steps_down_for_wrap_and_decode(model):
    """Wrapped streams and decompress rows take the step loop:
    ``prefill_cycles`` stays 0 and the outputs stay exact."""
    eng = _engine(model, slots=1, chunk_size=8, max_len=16)
    rid = eng.submit_compress(_tokens(24, 73), allow_wrap=True)
    res = eng.run()
    assert res[rid].ok, res[rid].error
    assert eng.prefill_cycles == 0
    t_b = _tokens(12, 74)
    eng2 = _engine(model, slots=1, chunk_size=8, max_len=16)
    rd = eng2.submit_decompress(_ref_blob(model, t_b, 8))
    res2 = eng2.run()
    assert res2[rd].ok, res2[rd].error
    assert eng2.prefill_cycles == 0
    np.testing.assert_array_equal(res2[rd].tokens, t_b)


def test_wrap_rejected_then_allowed_roundtrip(model):
    """seq > max_len is refused with a named error by default; with
    allow_wrap=True the stream conditions on the ring window and an engine
    of the same geometry round-trips it exactly."""
    toks = _tokens(24, 60)
    eng = _engine(model, slots=1, chunk_size=8, max_len=16)
    with pytest.raises(ValueError, match="allow_wrap"):
        eng.submit_compress(toks)
    rid = eng.submit_compress(toks, allow_wrap=True)
    res = eng.run()
    assert res[rid].ok, res[rid].error
    eng2 = _engine(model, slots=1, chunk_size=8, max_len=16)
    rid2 = eng2.submit_decompress(res[rid].blob, allow_wrap=True)
    res2 = eng2.run()
    assert res2[rid2].ok, res2[rid2].error
    np.testing.assert_array_equal(res2[rid2].tokens, toks)


def test_engine_arguments_and_device(model):
    with pytest.raises(ValueError, match="step backend"):
        _engine(model, step_backend="pallas")
    with pytest.raises(ValueError, match="prefill policy"):
        _engine(model, prefill="sometimes")
    assert _engine(model, prefill="force").prefill_cycles == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchEngine(model, lanes=LANES)
    eng = _engine(model, chunk_size=8, max_len=16)
    with pytest.raises(ValueError, match="lanes=4"):
        eng.submit_compress(np.zeros((3, 8), np.int64))
    with pytest.raises(ValueError, match="chunk_size 16"):
        eng.submit_decompress(_ref_blob(model, _tokens(8, 1), 16))


@pytest.mark.parametrize("cap", [None, 9])
def test_b1_chunk_encode_matches_coder(cap):
    """The engine's compress chunk is encoded by B1 (``ops.rans_encode`` on
    ``(n_c, lanes, K)`` tables) where the reference runs ``coder.encode``:
    equal streams and overflow flags, here on B1's plain version."""
    rng = np.random.default_rng(5)
    n_c, k = 11, 256
    probs = rng.dirichlet(np.full(k, 0.3), size=(n_c, LANES)).astype(
        np.float32)
    tbl = ops.spc_quantize_tables(torch.as_tensor(probs).reshape(-1, k))
    tbl = spc.TableSet(*(a.reshape((n_c, LANES) + a.shape[1:]) for a in tbl))
    sym = torch.as_tensor(rng.integers(0, k, (LANES, n_c)))
    got = ops.rans_encode(sym, tbl, cap=cap)
    want = coder.encode(sym, tbl, cap=cap)
    for a, b in zip(got, want):
        assert torch.equal(a.to(b.dtype), b)
    assert bool(got.overflow.any()) == (cap is not None)


def test_generate_matches_reference():
    """Greedy generate: tokens equal JAX's and logits within 1e-4; the
    first generated token is consumed at position S (the rollout below
    writes every position out); sampling is reproducible per generator."""
    jparams = j_init_model(J_SMOKE, jax.random.PRNGKey(2))
    model = from_reference(jax.tree.map(np.asarray, jparams), SMOKE,
                           device="cpu")
    prompt = np.asarray(token_stream(SMOKE.vocab_size, (2, 12), seed=5),
                        np.int64)
    jout, jlgs = jengine.generate(jparams, J_SMOKE,
                                  jnp.asarray(prompt, jnp.int32), 8,
                                  max_len=32, return_logits=True)
    out, lgs = engine.generate(model, torch.as_tensor(prompt), 8,
                               max_len=32, return_logits=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_allclose(lgs.numpy(), np.asarray(jlgs), atol=1e-4,
                               rtol=1e-4)
    state = init_state(model, 2, 32)
    toks = torch.as_tensor(prompt)
    for t in range(12):
        lg = decode_step(model, state, toks[:, t:t + 1], t)
    for i in range(8):
        assert torch.equal(lg, lgs[:, i])
        lg = decode_step(model, state, out[:, i:i + 1], 12 + i)
    sampled = [engine.generate(model, toks, 6, max_len=32, temperature=0.8,
                               generator=torch.Generator().manual_seed(4))
               for _ in range(2)]
    assert torch.equal(sampled[0], sampled[1])
    state, last = engine.prefill(model, toks, 16)
    assert torch.equal(last, lgs[:, 0])
    assert torch.equal(engine.make_serve_step(model)(
        state, out[:, :1], 12), lgs[:, 1])
