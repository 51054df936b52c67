"""The recurrent families' training path, port vs the JAX reference (CPU).

Both sides run the reference's ``SMOKE`` configs of ``mamba2-130m`` and
``recurrentgemma-2b`` in float32, the port holding JAX's parameters
through ``models.convert.from_reference``; every input is made with numpy
from a seed and handed to both.

* ``layers.causal_conv`` against JAX's ``_causal_conv``, and its last
  position against the decode path's ``conv_step``;
* ``ssd_chunked`` against JAX's ``ssd_chunked`` (values and the gradients
  of a weighted sum) and against the port's own ``ssd_sequential``, at a
  length that is a multiple of the chunk and one that is not (the
  zero-padded path);
* ``rglru.linear_scan`` against a sequential loop;
* ``ssm_forward`` and ``rglru_forward`` of one block;
* ``LM.forward``, ``loss_fn`` and every gradient leaf against
  ``jax.value_and_grad`` of the reference's ``loss_fn``;
* two ``make_train_step`` steps against the reference's (loss, grad norm,
  lr and every updated parameter);
* the hybrid's training attention: JAX's own ``forward`` is not its step
  scan past ``local_window`` (it trains its attention blocks with full
  causal attention), and the port's ``forward`` is JAX's ``forward``.

Tolerances are the dense family's (``tests/test_torch_train.py``): the
loss within rtol 1e-5, each gradient leaf and updated parameter within
1e-5 of the reference leaf's largest entry, hidden states within atol
1e-5 / rtol 1e-4 (the two frameworks' reduction orders in the
projections, the chunk einsums and the scans).  The scans needed no
looser bound: the largest relative gradient error measured was 2.0e-6
(``mamba2-130m``, ``ssm.D``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data import pipeline as jpipeline
from repro.models import decode_step as j_decode_step
from repro.models import init_model as j_init_model
from repro.models import init_state as j_init_state
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models.transformer import forward as j_forward
from repro.models.transformer import loss_fn as j_loss_fn
from repro.train import train_loop as jtrain_loop
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers, loss_fn, rglru, ssm
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.train import train_loop

jax.config.update("jax_platforms", "cpu")

ARCHS = ("mamba2-130m", "recurrentgemma-2b")
TOL = dict(atol=1e-5, rtol=1e-4)
B, S = 4, 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one CPU thread: its SMOKE ops are small, and
    beside other busy test processes torch's idle worker threads spin for
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def zoo():
    """JAX smoke params and the port's model holding them, per arch."""
    out = {}
    for arch in ARCHS:
        jcfg = j_get_smoke_config(arch)
        params = j_init_model(jcfg, jax.random.PRNGKey(0))
        model = from_reference(jax.tree.map(np.asarray, params),
                               get_smoke_config(arch), device="cpu")
        out[arch] = (jcfg, params, model)
    return out


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _leaves_close(got: dict, ref, rel: float):
    """Every leaf of two reference-layout trees within ``rel`` of the
    reference leaf's largest entry."""
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, ref)))
    assert len(flat_got) == len(flat_ref)
    for path, g in flat_got:
        r = flat_ref[path]
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=rel * max(np.abs(r).max(), 1e-12),
                                   err_msg=jax.tree_util.keystr(path))


def _pair(*arrays):
    """numpy float32 arrays -> (JAX arrays, torch tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.as_tensor(a) for a in arrays])


@pytest.mark.parametrize("s", [1, 3, 17])
def test_causal_conv_matches_reference(s):
    rng = np.random.default_rng(s)
    x, w, b = (rng.normal(size=shape).astype(np.float32)
               for shape in ((2, s, 24), (4, 24), (24,)))
    (jx, jw, jb), (tx, tw, tb) = _pair(x, w, b)
    y = layers.causal_conv(tx, tw, tb)
    _close(y, jssm._causal_conv(jx, jw, jb), atol=1e-6, rtol=1e-6)
    hist = torch.nn.functional.pad(tx, (0, 0, 3, 0))[:, -4:]
    _close(y[:, -1], layers.conv_step(hist, tw, tb), atol=1e-6, rtol=1e-6)


def _ssd_inputs(s: int, seed: int):
    rng = np.random.default_rng(seed)
    b, h, p, g, n = 2, 4, 8, 1, 16
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a = (-np.exp(rng.normal(size=(h,)) * 0.5)).astype(np.float32)
    bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    w = rng.normal(size=(b, s, h, p)).astype(np.float32)
    return x, dt, a, bm, cm, w


@pytest.mark.parametrize("s", [32, 29])
def test_ssd_chunked_matches_reference_and_sequential(s):
    """Chunk 8: four whole chunks, or 29 positions zero-padded to 32; the
    values and the gradients of ``sum(w * y)`` with respect to x, dt, B
    and C (the masked decay's backward stays finite)."""
    x, dt, a, bm, cm, w = _ssd_inputs(s, seed=s)
    jargs, targs = _pair(x, dt, a, bm, cm)
    targs = [t.requires_grad_(i != 2) for i, t in enumerate(targs)]
    y = ssm.ssd_chunked(*targs, chunk=8)
    _close(y, jssm.ssd_chunked(*jargs, chunk=8), **TOL)
    with torch.no_grad():
        _close(y, ssm.ssd_sequential(*targs), **TOL)
    grads = torch.autograd.grad((y * torch.as_tensor(w)).sum(),
                                [targs[i] for i in (0, 1, 3, 4)])
    jgrads = jax.grad(lambda x, dt, bm, cm: jnp.sum(
        jnp.asarray(w) * jssm.ssd_chunked(x, dt, jargs[2], bm, cm, 8)),
        argnums=(0, 1, 2, 3))(jargs[0], jargs[1], jargs[3], jargs[4])
    for got, want in zip(grads, jgrads):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("s", [1, 5, 64, 100])
def test_linear_scan_matches_sequential_loop(s):
    rng = np.random.default_rng(s)
    a = torch.as_tensor(rng.uniform(0.0, 1.0, (2, s, 6)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(2, s, 6)).astype(np.float32))
    h, want = torch.zeros(2, 6), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(rglru.linear_scan(a, b), torch.stack(want, 1), atol=1e-6,
           rtol=1e-5)


def _block(model, params, key: str):
    """Block ``key`` of stage 0, repeat 0: JAX's parameter dict and the
    port's block."""
    sub = jax.tree.map(lambda a: a[0], params["stages"]["s0"][key])
    return sub, model.blocks[model.layout.index((0, key, 0))]


def test_ssm_forward_matches_reference(zoo):
    """20 positions over chunk 8: the padded path inside the mixer."""
    jcfg, params, model = zoo["mamba2-130m"]
    p, blk = _block(model, params, "b0_ssm")
    x = np.random.default_rng(2).normal(size=(2, 20, jcfg.d_model))
    (jx,), (tx,) = _pair(x.astype(np.float32))
    with torch.no_grad():
        y = ssm.ssm_forward(blk.ssm, tx, model.cfg)
    _close(y, jssm.ssm_forward(p["ssm"], jx, jcfg), **TOL)


def test_rglru_forward_matches_reference(zoo):
    jcfg, params, model = zoo["recurrentgemma-2b"]
    p, blk = _block(model, params, "b0_rec")
    x = np.random.default_rng(3).normal(size=(2, 40, jcfg.d_model))
    (jx,), (tx,) = _pair(x.astype(np.float32))
    with torch.no_grad():
        y = rglru.rglru_forward(blk.rec, tx, model.cfg)
    _close(y, jrglru.rglru_forward(p["rec"], jx, jcfg), **TOL)


def _batch(jcfg, seed: int):
    return jpipeline.train_batch(jcfg, B, S, step=seed)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_reference(zoo, arch):
    jcfg, params, model = zoo[arch]
    batch = _batch(jcfg, 1)
    jx, _ = j_forward(params, jnp.asarray(batch["tokens"]), jcfg)
    with torch.no_grad():
        x, aux = model(torch.as_tensor(batch["tokens"]).long())
    assert float(aux) == 0.0
    _close(x, jx, **TOL)
    jl, jg = jax.value_and_grad(j_loss_fn)(
        params, jax.tree.map(jnp.asarray, batch), jcfg)
    loss, grads = train_loop.grads_fn(model, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _leaves_close(to_reference(model, grads), jg, 1e-5)
    direct = loss_fn(model, {k: torch.as_tensor(v).long()
                             for k, v in batch.items()})
    np.testing.assert_allclose(float(direct.detach()), float(jl), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    jcfg = j_get_smoke_config(arch)
    params = j_init_model(jcfg, jax.random.PRNGKey(8))
    model = from_reference(jax.tree.map(np.asarray, params),
                           get_smoke_config(arch), device="cpu")
    jstate = jtrain_loop.init_train_state(params)
    state = train_loop.init_train_state(model)
    jstep = jax.jit(jtrain_loop.make_train_step(jcfg, base_lr=3e-3))
    step = train_loop.make_train_step(model.cfg, base_lr=3e-3)
    for i in range(2):       # step 0 has lr 0 (warmup); step 1 moves
        batch = _batch(jcfg, i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
    assert int(state.step) == 2
    _leaves_close(to_reference(state.model), jstate.params, 1e-5)


def test_hybrid_forward_is_not_its_step_scan_past_the_window(zoo):
    """recurrentgemma-2b SMOKE (local window 16), 2 rows x 40 tokens: JAX's
    ``forward`` logits equal its own step scan's within 1e-4 on the first
    16 positions and differ by more than 1e-3 past them (its training
    attention is full causal, its decode the local ring; measured: at most
    2.4e-7 inside the window, at least 4.5e-2 past it); the port's
    ``forward`` logits equal JAX's ``forward`` logits."""
    jcfg, params, model = zoo["recurrentgemma-2b"]
    assert jcfg.local_window == 16 and not jcfg.sliding_window
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 40))
    jx, _ = j_forward(params, jnp.asarray(toks, jnp.int32), jcfg)
    jfwd = np.asarray(jnp.einsum("bsd,vd->bsv", jx,
                                 params["tok"]["embedding"]))
    jstate = j_init_state(jcfg, 2, 64)
    jstep = jax.jit(lambda p, st, tok, pos: j_decode_step(p, st, tok, pos,
                                                          jcfg))
    scan = []
    for t in range(40):
        lg, jstate = jstep(params, jstate,
                           jnp.asarray(toks[:, t:t + 1], jnp.int32),
                           jnp.int32(t))
        scan.append(np.asarray(lg))
    gap = np.abs(jfwd - np.stack(scan, 1)).max(axis=(0, 2))
    assert gap[:16].max() <= 1e-4
    assert gap[16:].min() > 1e-3
    with torch.no_grad():
        x, _ = model(torch.as_tensor(toks))
        fwd = model._logits(x)
    _close(fwd, jfwd, atol=1e-4, rtol=1e-4)
