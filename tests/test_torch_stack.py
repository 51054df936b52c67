"""The port's bits-back stack and VAE against JAX (CPU).

* Every push and pop of ``repro_torch.core.stack`` leaves the same
  integers as ``repro.core.stack`` on the same integer tables: states,
  cursors, the whole byte buffer and the underflow flags, compared after
  each operation, for ``Categorical`` (shared and per-lane rows),
  ``Uniform``, ``NonUniform``, ``serial``, ``substack``, the array codecs
  on every table layout, initial bits, flush and open, over-pops and
  pushes past the cap.  The port's ``backend="kernel"`` pops through B2's
  plain version; JAX's coder pops are the yardstick (its own tests hold
  its kernel pops to them).
* Floats within tolerance: ``std_gaussian_bins``, ``gaussian_bin_probs``
  and ``logistic_bin_probs`` (rtol 1e-5, atol 1e-6: ``ndtri``/``ndtr`` and
  the logistic in two frameworks), ``elbo_loss`` and its gradients with
  JAX's reparameterization noise fed in (rtol 1e-5 on the loss; every
  gradient leaf within 1e-4 of its largest entry).
* The port's own bits-back round trip on a tiny VAE, on both pop
  backends with byte-identical stacks, and the frozen stack corpus
  ``tests/golden_vectors/stack_*.ras``: re-pushed byte for byte by
  ``repro_torch.core.golden`` and popped back on both backends.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import search as jsearch
from repro.core import spc as jspc
from repro.core import stack as jstack
from repro.models import vae as jvae
from repro_torch.core import bitstream, coder, golden, search, spc, stack
from repro_torch.core import constants as C
from repro_torch.models import vae

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

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_vectors")
LANES, CAP = 4, 512
BACKENDS = ["coder", "kernel"]


def _tables(k, seed, lanes=None, t=None):
    """JAX-quantized ``(freq, cdf)`` and the same integers as port
    tensors."""
    rng = np.random.default_rng(seed)
    size = tuple(d for d in (t, lanes) if d is not None) or None
    probs = rng.dirichlet(np.full(k, 0.5), size=size)
    jf, jc = jspc.freq_cdf_from_probs(
        jspc.store_bf16(jnp.asarray(probs, jnp.float32)))
    return (jf, jc), (torch.as_tensor(np.asarray(jf).astype(np.int32)),
                      torch.as_tensor(np.asarray(jc).astype(np.int32)))


def _syms(k, t, seed, lanes=LANES):
    return np.random.default_rng(seed).integers(0, k, (lanes, t)).astype(
        np.int32)


def _pair(lanes, cap, n_bytes=0, seed=0):
    if n_bytes:
        return (jstack.stack_init_bits(lanes, cap, n_bytes, seed),
                stack.stack_init_bits(lanes, cap, n_bytes, seed, "cpu"))
    return jstack.stack_init(lanes, cap), stack.stack_init(lanes, cap, "cpu")


def _same(jst, st):
    """The port's state holds the reference's integers, whole buffer
    included."""
    np.testing.assert_array_equal(st.s.numpy(),
                                  np.asarray(jst.s).astype(np.int64))
    np.testing.assert_array_equal(st.ptr.numpy(), np.asarray(jst.ptr))
    np.testing.assert_array_equal(st.buf.numpy(), np.asarray(jst.buf))
    np.testing.assert_array_equal(st.underflow.numpy(),
                                  np.asarray(jst.underflow))


def _restored(st, st0):
    """``st`` is ``st0`` again: state, cursor, flags and the live bytes
    ``buf[lane, ptr:]`` (bytes below the cursor are dead: pops never clear
    them)."""
    assert torch.equal(st.s, st0.s) and torch.equal(st.ptr, st0.ptr)
    assert torch.equal(st.underflow, st0.underflow)
    for lane, p in enumerate(st0.ptr.tolist()):
        assert torch.equal(st.buf[lane, p:], st0.buf[lane, p:])


def _sym_eq(x, jx):
    np.testing.assert_array_equal(np.asarray(x).astype(np.int64),
                                  np.asarray(jx).astype(np.int64))


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lanes,cap,n_bytes,seed",
                         [(4, 512, 0, 0), (4, 512, 24, 5), (7, 64, 64, 9)])
def test_init_and_bytes_match_reference(lanes, cap, n_bytes, seed):
    jst, st = _pair(lanes, cap, n_bytes, seed)
    _same(jst, st)
    np.testing.assert_array_equal(stack.stack_bytes(st).numpy(),
                                  np.asarray(jstack.stack_bytes(jst)))
    with pytest.raises(ValueError, match="exceeds stack cap"):
        stack.stack_init_bits(lanes, 16, n_bytes=32, device="cpu")


@pytest.mark.parametrize("make", [
    lambda: stack.stack_init(LANES, CAP),
    lambda: stack.stack_init_bits(LANES, CAP, n_bytes=8),
    lambda: vae.init_vae(vae.VAEConfig())], ids=["init", "init_bits", "vae"])
def test_entry_points_default_to_the_card(make):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_flush_open_match_reference_and_short_header_flags():
    jst, st = _pair(LANES, CAP, 16, 22)
    (jf, jc), (f, c) = _tables(16, 3)
    x = _syms(16, 1, 4)[:, 0]
    jst = jstack.Categorical(jf, jc).push(jst, jnp.asarray(x))
    st = stack.Categorical(f, c).push(st, torch.as_tensor(x))
    jenc, enc = jstack.stack_flush(jst), stack.stack_flush(st)
    for a, b in zip(enc, jenc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _same(jstack.stack_open(jenc), stack.stack_open(enc))
    short = bitstream.EncodedLanes(
        buf=enc.buf, start=torch.full((LANES,), CAP - 2, dtype=torch.int32),
        length=torch.full((LANES,), 2, dtype=torch.int32))
    assert bool(stack.stack_open(short).underflow.all())


# ---------------------------------------------------------------------------
# every push and pop in lockstep with the reference
# ---------------------------------------------------------------------------

def _codecs(backend, per_lane):
    """(JAX codec, port codec) pairs over the same integer tables."""
    (jf, jc), (f, c) = _tables(16, 7, lanes=LANES if per_lane else None)
    (jf2, jc2), (f2, c2) = _tables(256, 8)

    def j_enc(x):
        return jstack._gather(jc2[..., :-1], x), jstack._gather(jf2, x)

    def enc(x):
        return stack._gather(c2[..., :-1], x), stack._gather(f2, x)

    return [
        (jstack.Categorical(jf, jc), stack.Categorical(f, c,
                                                       backend=backend), 16),
        (jstack.Uniform(6), stack.Uniform(6), 64),
        (jstack.NonUniform(j_enc, lambda s: jsearch.find_symbol(
            jc2, 256, s)[0]),
         stack.NonUniform(enc, lambda s: search.find_symbol(c2, 256, s)[0]),
         256),
        (jstack.Categorical(jf2, jc2), stack.Categorical(f2, c2,
                                                         backend=backend),
         256),
    ]


@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "lane"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("cap,n_bytes,p_push", [(CAP, 12, 0.3),
                                                (24, 0, 0.75)],
                         ids=["overpop", "overflow"])
def test_every_push_and_pop_matches_reference(backend, per_lane, cap,
                                              n_bytes, p_push):
    """A seeded schedule of pushes and pops through every codec: mostly
    pops (they run past the stream end and flag), or, at a 24-byte cap,
    mostly pushes (past the head: dropped writes, negative cursor)."""
    rng = np.random.default_rng(30 + per_lane)
    pairs = _codecs(backend, per_lane)
    jst, st = _pair(LANES, cap, n_bytes, 31)
    for op in range(60):
        jc, c, k = pairs[rng.integers(len(pairs))]
        if rng.random() < p_push:
            x = rng.integers(0, k, LANES).astype(np.int32)
            jst = jc.push(jst, jnp.asarray(x))
            st = c.push(st, torch.as_tensor(x))
        else:
            jst, jx = jc.pop(jst)
            st, x = c.pop(st)
            _sym_eq(x, jx)
        _same(jst, st)
    assert bool(st.underflow.any() if p_push < 0.5 else (st.ptr < 0).any())


@pytest.mark.parametrize("backend", BACKENDS)
def test_serial_and_substack_match_reference(backend):
    (jf, jc), (f, c) = _tables(16, 10)
    jser = jstack.serial([jstack.Uniform(4), jstack.Categorical(jf, jc)])
    ser = stack.serial([stack.Uniform(4),
                        stack.Categorical(f, c, backend=backend)])
    jsub = jstack.substack(jstack.Categorical(jf, jc), jnp.asarray([0, 2]))
    sub = stack.substack(stack.Categorical(f, c, backend=backend), [0, 2])
    jst, st = _pair(LANES, CAP, 16, 11)
    xa, xb = _syms(16, 1, 8)[:, 0], _syms(16, 1, 9)[:, 0]
    jst = jser.push(jst, (jnp.asarray(xa), jnp.asarray(xb)))
    st = ser.push(st, (torch.as_tensor(xa), torch.as_tensor(xb)))
    _same(jst, st)
    jst = jsub.push(jst, jnp.asarray([3, 9], jnp.int32))
    st = sub.push(st, torch.as_tensor([3, 9]))
    _same(jst, st)
    jst, jx = jsub.pop(jst)
    st, x = sub.pop(st)
    _sym_eq(x, jx)
    _same(jst, st)
    jst, (ja, jb) = jser.pop(jst)
    st, (a, b) = ser.pop(st)
    _sym_eq(a, ja)
    _sym_eq(b, jb)
    _same(jst, st)
    with pytest.raises(ValueError, match="serial push"):
        ser.push(st, (torch.as_tensor(xa),))
    with pytest.raises(ValueError, match="Uniform bits"):
        stack.Uniform(C.PROB_BITS + 1)
    with pytest.raises(ValueError, match="backend"):
        stack.Categorical(f, c, backend="gpu")


@pytest.mark.parametrize("layout", ["static", "perpos", "perlane"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_array_codecs_match_reference(layout, backend):
    t, k = 12, 16
    (jf, jc), (f, c) = _tables(k, 14, t=None if layout == "static" else t,
                               lanes=LANES if layout == "perlane" else None)
    syms = _syms(k, t, 15)
    jst, st = _pair(LANES, CAP, 8, 16)
    jst = jstack.push_symbols(jst, jnp.asarray(syms), jf, jc)
    st = stack.push_symbols(st, torch.as_tensor(syms), f, c)
    _same(jst, st)
    jst, jx = jstack.pop_symbols(jst, t, jf, jc)
    st, x = stack.pop_symbols(st, t, f, c, backend=backend)
    _sym_eq(x, jx)
    _same(jst, st)
    # then past the end of the initial bits: the flags must agree too
    (jf0, jc0), (f0, c0) = _tables(k, 17)
    jst, jx = jstack.pop_symbols(jst, 40, jf0, jc0)
    st, x = stack.pop_symbols(st, 40, f0, c0, backend=backend)
    _sym_eq(x, jx)
    _same(jst, st)
    assert bool(st.underflow.all())
    with pytest.raises(ValueError, match="backend"):
        stack.pop_symbols(st, t, f, c, backend="tpu")


def test_push_symbols_flush_equals_batch_coder():
    """stack_init + push_symbols + stack_flush is the port's coder.encode,
    byte for byte."""
    t, k = 20, 16
    probs = np.random.default_rng(12).dirichlet(np.full(k, 0.5), size=(t,))
    tbl = spc.tables_from_probs(torch.as_tensor(probs.astype(np.float32)))
    syms = torch.as_tensor(_syms(k, t, 13))
    ref = coder.encode(syms, tbl)
    st = stack.stack_init(LANES, CAP, "cpu")
    enc = stack.stack_flush(stack.push_symbols(st, syms, tbl.freq, tbl.cdf))
    for lane in range(LANES):
        assert torch.equal(enc.buf[lane, enc.start[lane]:],
                           ref.buf[lane, ref.start[lane]:])


# ---------------------------------------------------------------------------
# observation codecs: floats within tolerance, the port's own round trip
# ---------------------------------------------------------------------------

def test_bin_probabilities_match_reference():
    rng = np.random.default_rng(23)
    je, jc = jstack.std_gaussian_bins(16)
    e, c = stack.std_gaussian_bins(16)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    mu = rng.normal(0, 1, (3, LANES)).astype(np.float32)
    sig = rng.uniform(0.05, 3.0, (3, LANES)).astype(np.float32)
    g = stack.gaussian_bin_probs(torch.as_tensor(mu), torch.as_tensor(sig), e)
    jg = jstack.gaussian_bin_probs(jnp.asarray(mu), jnp.asarray(sig), je)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    log_s = rng.uniform(-7, 1, (3, LANES)).astype(np.float32)
    lp = stack.logistic_bin_probs(torch.as_tensor(mu * 0.3),
                                  torch.as_tensor(log_s), 256)
    jlp = jstack.logistic_bin_probs(jnp.asarray(mu * 0.3),
                                    jnp.asarray(log_s), 256)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-6)
    mass = stack.gaussian_bin_probs(torch.zeros(()), torch.ones(()), e)
    np.testing.assert_allclose(mass.numpy(), np.full(16, 1 / 16), atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_observation_codecs_roundtrip(backend):
    rng = np.random.default_rng(23)
    edges, _ = stack.std_gaussian_bins(16)
    mu = torch.as_tensor(rng.normal(0, 1, LANES), dtype=torch.float32)
    sig = torch.as_tensor(rng.uniform(0.5, 2.0, LANES), dtype=torch.float32)
    g = stack.DiagGaussian(mu, sig, edges, backend=backend)
    dl = stack.DiscretizedLogistic(mu * 0.1, mu * 0.0 - 2.0, 256,
                                   backend=backend)
    st0 = stack.stack_init_bits(LANES, CAP, n_bytes=32, seed=24,
                                device="cpu")
    kz = torch.as_tensor(rng.integers(0, 16, LANES))
    px = torch.as_tensor(rng.integers(0, 256, LANES))
    st = dl.push(g.push(st0, kz), px)
    st, got_px = dl.pop(st)
    st, got_kz = g.pop(st)
    assert torch.equal(got_px, px) and torch.equal(got_kz, kz)
    _restored(st, st0)


# ---------------------------------------------------------------------------
# the VAE
# ---------------------------------------------------------------------------

def test_vae_tree_and_elbo_match_reference():
    cfg = vae.VAEConfig(d_x=16, d_h=16)
    jcfg = jvae.VAEConfig(d_x=16, d_h=16)
    key = jax.random.PRNGKey(4)
    jparams = jvae.init_vae(jcfg, key)
    tree = jax.tree.map(np.asarray, jparams)
    params = vae.from_reference(tree, device="cpu")
    back = vae.to_reference(params)
    assert (jax.tree.structure(back) == jax.tree.structure(tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert set(params) == set(vae.init_vae(cfg, 0, "cpu"))
    x = np.random.default_rng(5).integers(0, 256, (LANES, 16))
    jl, jg = jax.value_and_grad(jvae.elbo_loss)(
        jparams, jnp.asarray(x, jnp.int32), jcfg, key)
    # JAX's draws: split the key, one normal per level
    k1, k2 = jax.random.split(key)
    noise = tuple(torch.as_tensor(np.array(jax.random.normal(kk, (
        LANES, cfg.d_z)))) for kk in (k1, k2))
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    loss = vae.elbo_loss(leaves, torch.as_tensor(x), cfg, noise=noise)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jgrads = vae.from_reference(jax.tree.map(np.asarray, jg), device="cpu")
    for name, g in grads.items():
        ref = jgrads[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-6),
                                   err_msg=name)


@pytest.fixture(scope="module")
def tiny_vae():
    cfg = vae.VAEConfig(d_x=16, d_h=16)
    params, loss = vae.train_vae(
        cfg, lambda i: np.random.default_rng(i).integers(
            0, cfg.x_bins, (LANES, cfg.d_x)),
        steps=3, lr=1e-3, seed=0, device="cpu")
    assert np.isfinite(loss)
    return cfg, params


def test_bitsback_roundtrip_both_backends(tiny_vae):
    """Pixels bit-exact, the initial stack restored, no underflow, and the
    coder and kernel pops evolve byte-identical stacks."""
    cfg, params = tiny_vae
    x = torch.as_tensor(np.random.default_rng(25).integers(
        0, cfg.x_bins, (LANES, cfg.d_x)))
    st0 = stack.stack_init_bits(LANES, 2048, n_bytes=64, seed=26,
                                device="cpu")
    encoded = {}
    for backend in BACKENDS:
        st = vae.bb_encode(st0, params, x, cfg, backend=backend)
        assert not bool(st.underflow.any())
        encoded[backend] = st
        st_d, x_d = vae.bb_decode(st, params, cfg, backend=backend)
        assert torch.equal(x_d, x)
        _restored(st_d, st0)
    for a, b in zip(*encoded.values()):
        assert torch.equal(a, b)
    assert int((stack.stack_bytes(encoded["coder"])
                - stack.stack_bytes(st0)).sum()) > 0


# ---------------------------------------------------------------------------
# the frozen stack corpus
# ---------------------------------------------------------------------------

_IDS = [c["name"] for c in golden.STACK_CASES]


def _stored(case):
    with open(os.path.join(GOLDEN, case["name"] + ".ras"), "rb") as f:
        return f.read()


def _open_stored(case):
    buf, start, _ = bitstream.unpack(_stored(case))
    enc = bitstream.EncodedLanes(torch.as_tensor(buf),
                                 torch.as_tensor(start),
                                 torch.as_tensor(buf.shape[1] - start))
    return stack.stack_open(enc)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", golden.STACK_CASES, ids=_IDS)
def test_golden_stack_blob_repushed(case, backend):
    assert golden.pack_stack_case(case, backend) == _stored(case)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", golden.STACK_CASES, ids=_IDS)
def test_golden_stack_blob_pops(case, backend):
    st0, st_ref, aux = golden.run_stack_case(case)
    st = _open_stored(case)
    assert not bool(st.underflow.any())
    assert torch.equal(st.s, st_ref.s)
    st, got = golden.pop_stack_case(case, st, aux, backend=backend)
    if case["name"] == "stack_bitsback":
        np.testing.assert_array_equal(got["x"], aux["x"])
        np.testing.assert_array_equal(got["k"], aux["k"])
        assert torch.equal(st.s, st0.s)      # the initial stack restored
    elif case["name"] == "stack_serial":
        for g, x in zip(got, aux["x"]):
            np.testing.assert_array_equal(g, x)
    else:
        np.testing.assert_array_equal(got, aux["x"])
    assert not bool(st.underflow.any())


@pytest.mark.parametrize("backend", BACKENDS)
def test_golden_stack_overpop_flags(backend):
    case = next(c for c in golden.STACK_CASES
                if c["name"] == "stack_nonuniform")
    _, _, aux = golden.run_stack_case(case)
    st = _open_stored(case)
    codec = stack.Categorical(aux["freq"], aux["cdf"], backend=backend)
    for _ in range(case["t"]):
        st, _x = codec.pop(st)
    assert not bool(st.underflow.any())
    for _ in range(24):                    # drain well past the stream end
        st, _x = codec.pop(st)
    assert bool(st.underflow.all())
