"""Cross attention and the encoder-decoder on the port against the JAX
reference (CPU, the SMOKE width).

Both sides run the reference's ``llama-3.2-vision-11b`` (``vlm``: four
``attn`` blocks and one ``cross`` block over a memory of patch
embeddings) and ``seamless-m4t-large-v2`` (``audio``: two bidirectional
encoder blocks, two ``dec`` blocks) SMOKE configs, the port holding JAX's
parameters through ``models.convert.from_reference``; every input is
made with numpy from a seed and handed to both.  JAX's steps run under
``jax.jit``.

* the registry's configs field for field, the protocol's geometry,
  ``can_prefill`` False and the named ``PrefillUnsupportedError``;
* ``train_batch``'s ``memory`` and ``enc_inputs`` planes bit for bit;
* a JAX tree through ``from_reference`` and ``to_reference`` unchanged
  (float32 exactly, bfloat16 by bit pattern);
* ``encode_memory`` and ``forward`` with ``memory``/``enc_inputs``:
  float32, within atol 1e-5 / rtol 1e-4 (two frameworks' reduction
  orders in matmul, softmax and rsqrt);
* a 12-step ``decode_step`` scan with memory against JAX's scan (atol
  1e-5 / rtol 1e-4) and against the port's own ``forward`` (atol 2e-4,
  the reference's ``test_prefill_decode_consistency`` bound: the step's
  tiled attention sums in another order); ``generate(return_logits=True)``
  against JAX's (tokens equal, logits atol 1e-5 / rtol 1e-4);
* ``loss_fn`` within rtol 1e-5 and every gradient leaf (the encoder's and
  the cross attention's included) within 1e-5 of the leaf's largest
  entry; ``grad_accum = 2`` on a memory batch: ``grads_fn`` within the
  same bounds, and one ``make_train_step`` step (loss, grad norm and lr
  within rtol 1e-5, the updated parameters within 1e-5 of each leaf's
  largest entry wherever the gradient's sign is clear, see the test);
* the named ``ValueError`` s: no memory, a memory of another dtype, batch
  or width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data import pipeline as jpipeline
from repro.models import can_prefill as j_can_prefill
from repro.models import decode_step as j_decode_step
from repro.models import init_model as j_init_model
from repro.models import init_state as j_init_state
from repro.models import ring_length as j_ring_length
from repro.models import state_spec as j_state_spec
from repro.models import wrap_length as j_wrap_length
from repro.models.layers import logits as j_logits
from repro.models.transformer import encode_memory as j_encode_memory
from repro.models.transformer import forward as j_forward
from repro.models.transformer import loss_fn as j_loss_fn
from repro.serve import engine as jengine
from repro.train import train_loop as jtrain_loop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import pipeline
from repro_torch.models import (PrefillUnsupportedError, can_prefill,
                                decode_step, encode_memory, init_model,
                                init_state, loss_fn, prefill_chunk,
                                ring_length, state_spec, wrap_length)
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.serve import engine
from repro_torch.train import train_loop

jax.config.update("jax_platforms", "cpu")

ARCHS = ("llama-3.2-vision-11b", "seamless-m4t-large-v2")
TOL = dict(atol=1e-5, rtol=1e-4)
B, S, STEPS = 2, 12, 12


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one CPU thread: its SMOKE ops are small, and
    beside other busy test processes torch's idle worker threads spin for
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch: str, dtype: str = "float32", seed: int = 0, **kw):
    """(JAX config, JAX params, the port's model holding them); ``kw``
    changes both configs."""
    jcfg = j_get_smoke_config(arch).with_(dtype=dtype, **kw)
    params = j_init_model(jcfg, jax.random.PRNGKey(seed))
    model = from_reference(jax.tree.map(np.asarray, params),
                           get_smoke_config(arch).with_(dtype=dtype, **kw),
                           device="cpu")
    return jcfg, params, model


@pytest.fixture(scope="module")
def zoo():
    return {arch: _pair(arch) for arch in ARCHS}


def _batch(cfg, b: int = B, s: int = S, step: int = 0) -> dict:
    return pipeline.train_batch(cfg, b, s, step=step, seed=5)


def _memory(jcfg, params, model, batch):
    """The memory each side's cross attention reads: the batch's patch
    embeddings (vlm), or JAX's and the port's encoder outputs (audio)."""
    if "memory" in batch:
        return jnp.asarray(batch["memory"]), torch.as_tensor(batch["memory"])
    with torch.no_grad():
        mem = encode_memory(model, torch.as_tensor(batch["enc_inputs"]))
    return (j_encode_memory(params, jnp.asarray(batch["enc_inputs"]), jcfg),
            mem)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_and_protocol(arch):
    """Configs field for field (every field the port has), the state
    classification, ring and wrap lengths and ``can_prefill`` equal JAX's;
    ``prefill_chunk`` and ``BatchEngine(prefill="force")`` raise the named
    error, ``"auto"`` steps down."""
    for get, jget in ((get_config, j_get_config),
                      (get_smoke_config, j_get_smoke_config)):
        cfg, jcfg = get(arch), jget(arch)
        for f in cfg.__dataclass_fields__:
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert cfg.pattern == jcfg.pattern and cfg.stages == jcfg.stages
        assert cfg.is_encdec == jcfg.is_encdec
        assert tuple(state_spec(cfg)) == tuple(j_state_spec(jcfg))
        assert can_prefill(cfg) is j_can_prefill(jcfg) is False
        for max_len in (1, 16, 1024):
            assert ring_length(cfg, max_len) == j_ring_length(jcfg, max_len)
            assert wrap_length(cfg, max_len) == j_wrap_length(jcfg, max_len)
    cfg = get_smoke_config(arch)
    assert state_spec(cfg).kinds == {"llama-3.2-vision-11b": ("attn", "cross"),
                                     "seamless-m4t-large-v2": ("dec",)}[arch]
    model = init_model(cfg, device="cpu")
    state = init_state(model, B, 16)
    # a cross block keeps no ring row: 4 rings for vlm, 2 for audio
    assert state.k.shape[0] == sum(k != "cross" for k in model.kinds)
    assert not state.recurrent
    with pytest.raises(PrefillUnsupportedError, match=cfg.name):
        prefill_chunk(model, state, torch.zeros((B, 4), dtype=torch.int64),
                      torch.zeros(B, dtype=torch.int64),
                      torch.full((B,), 4, dtype=torch.int64))
    with pytest.raises(PrefillUnsupportedError, match="force"):
        engine.BatchEngine(model, slots=1, lanes=B, chunk_size=8,
                           max_len=16, prefill="force", device="cpu")
    eng = engine.BatchEngine(model, slots=1, lanes=B, chunk_size=8,
                             max_len=16, prefill="auto", device="cpu")
    assert not eng._prefill


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch,seq,step,host,seed",
                         [(2, 8, 0, 0, 0), (3, 5, 4, 1, 7)])
def test_train_batch_planes_bit_equal(arch, batch, seq, step, host, seed):
    got = pipeline.train_batch(get_smoke_config(arch), batch, seq, step=step,
                               host=host, seed=seed)
    ref = jpipeline.train_batch(j_get_smoke_config(arch), batch, seq,
                                step=step, host=host, seed=seed)
    plane = {"llama-3.2-vision-11b": "memory",
             "seamless-m4t-large-v2": "enc_inputs"}[arch]
    assert set(got) == set(ref) == {"tokens", "labels", plane}
    for k in got:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])
    assert got[plane].shape == (batch, 8, 64)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip(arch, dtype):
    """JAX tree -> port -> JAX tree unchanged (a bfloat16 tree compared by
    value after the float32 widening, which is exact)."""
    _, params, model = _pair(arch, dtype, seed=2)
    back = to_reference(model)
    ref = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(ref))
    jax.tree.map(np.testing.assert_array_equal, back, ref)
    assert model.encoder is not None or arch == "llama-3.2-vision-11b"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["naive", "blockwise"])
def test_encode_memory_and_forward(zoo, arch, impl):
    """``encode_memory`` (audio) and ``forward``'s hidden states and
    logits, with ``memory`` and (audio) with ``enc_inputs``; the naive
    schedule, and the blockwise one over 5 keys a chunk (the 12 tokens
    and the 8 memory slots padded to whole chunks; cross attention and
    the encoder unmasked)."""
    jcfg, params, model = (zoo[arch] if impl == "naive" else _pair(
        arch, seed=1, attn_impl="blockwise", attn_block=5))
    batch = _batch(jcfg)
    jtok, tok = jnp.asarray(batch["tokens"]), torch.as_tensor(batch["tokens"])
    jmem, mem = _memory(jcfg, params, model, batch)
    if "enc_inputs" in batch:
        np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), **TOL)
        with torch.no_grad():
            x_enc, _ = model(tok, enc_inputs=torch.as_tensor(
                batch["enc_inputs"]))
        jx_enc, _ = j_forward(params, jtok, jcfg,
                              enc_inputs=jnp.asarray(batch["enc_inputs"]))
        np.testing.assert_allclose(x_enc.numpy(), np.asarray(jx_enc), **TOL)
    with torch.no_grad():
        x, aux = model(tok, memory=mem)
        lg = model._logits(x)
    jx, _ = j_forward(params, jtok, jcfg, memory=jmem)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **TOL)
    assert float(aux) == 0.0
    np.testing.assert_allclose(lg.numpy(),
                               np.asarray(j_logits(params["tok"], jx, jcfg)),
                               **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_scan_with_memory(zoo, arch):
    """12 ``decode_step`` s against JAX's jitted step scan, and against
    the port's own ``forward`` on the same tokens."""
    jcfg, params, model = zoo[arch]
    batch = _batch(jcfg, step=1)
    jmem, mem = _memory(jcfg, params, model, batch)
    toks = batch["tokens"]
    jstep = jax.jit(lambda c, t, pos: j_decode_step(params, c, t, pos, jcfg,
                                                    memory=jmem))
    jcache = j_init_state(jcfg, B, STEPS)
    state = init_state(model, B, STEPS)
    steps = []
    for t in range(STEPS):
        jlg, jcache = jstep(jcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.int32(t))
        lg = decode_step(model, state, torch.as_tensor(toks[:, t:t + 1]), t,
                         memory=mem)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        steps.append(lg)
    with torch.no_grad():
        fwd = model._logits(model(torch.as_tensor(toks[:, :STEPS]),
                                  memory=mem)[0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), fwd.numpy(),
                               atol=2e-4, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_logits(zoo, arch):
    """Greedy ``generate`` over a 6-token prompt, 6 new tokens: the same
    tokens as JAX's and the per-step logits that chose them."""
    jcfg, params, model = zoo[arch]
    batch = _batch(jcfg, step=2)
    jmem, mem = _memory(jcfg, params, model, batch)
    prompt = batch["tokens"][:, :6]
    jout, jlgs = jengine.generate(params, jcfg, jnp.asarray(prompt), 6,
                                  max_len=16, memory=jmem,
                                  return_logits=True)
    out, lgs = engine.generate(model, torch.as_tensor(prompt), 6, max_len=16,
                               memory=mem, return_logits=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_allclose(lgs.numpy(), np.asarray(jlgs), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(zoo, arch):
    jcfg, params, model = zoo[arch]
    batch = _batch(jcfg, step=3)
    jloss, jgrads = jax.value_and_grad(j_loss_fn)(
        params, jax.tree.map(jnp.asarray, batch), jcfg)
    loss = loss_fn(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    tree = to_reference(model, dict(zip(named, grads)))
    _leaves_close(tree, jgrads, 1e-5)
    # the leaves that only this family has carry gradient
    key = {"llama-3.2-vision-11b": ("stages", "s0", "b4_cross", "cross",
                                    "wk"),
           "seamless-m4t-large-v2": ("encoder", "stack", "b0_attn", "attn",
                                     "wq")}[arch]
    leaf = tree
    for k in key:
        leaf = leaf[k]
    assert np.abs(leaf).max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_grad_accum_on_a_memory_batch(arch):
    """``grad_accum = 2`` (the memory planes split along the batch with the
    tokens): ``grads_fn`` against JAX's (loss, every gradient leaf), then
    one ``make_train_step`` step from the end of the warmup (loss, grad
    norm, lr, and the updated parameters).  AdamW's first step moves an
    entry by about ``lr * sign(g)``, so an entry whose gradient is at the
    two frameworks' rounding can step either way: the parameters are held
    where the reference's gradient is at least 1e-3 of its leaf's largest
    entry, 100x the gradients' tolerance."""
    jcfg, params, model = _pair(arch, seed=6)
    jcfg, cfg = jcfg.with_(grad_accum=2), model.cfg.with_(grad_accum=2)
    batch = _batch(jcfg, b=4, step=4)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jloss, jgrads = jtrain_loop.grads_fn(params, jbatch, jcfg)
    loss, grads = train_loop.grads_fn(
        from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu"),
        batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _leaves_close(to_reference(model, grads), jgrads, 1e-5)
    jstate = jtrain_loop.init_train_state(params)._replace(step=jnp.int32(50))
    jstate, jm = jax.jit(jtrain_loop.make_train_step(jcfg, base_lr=3e-3))(
        jstate, jbatch)
    state = train_loop.init_train_state(model)
    state = state._replace(step=torch.full_like(state.step, 50))
    state, m = train_loop.make_train_step(cfg, base_lr=3e-3)(state, batch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(m["lr"]) > 0
    flat_g = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jgrads)))
    for path, new in jax.tree_util.tree_leaves_with_path(
            to_reference(state.model)):
        ref, g = np.asarray(_at(jstate.params, path)), flat_g[path]
        clear = np.abs(g) >= 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(new[clear], ref[clear], rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=jax.tree_util.keystr(path))


def _at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _error_cases(model):
    d = model.cfg.d_model
    mem = torch.zeros((B, 8, d))
    return {
        "no memory": (None, "pass memory="),
        "dtype": (mem.to(torch.bfloat16), "memory is torch.bfloat16"),
        "batch": (torch.zeros((B + 1, 8, d)), "does not fit"),
        "width": (torch.zeros((B, 8, d + 1)), "does not fit"),
    }


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["no memory", "dtype", "batch", "width"])
def test_named_errors(zoo, arch, case):
    """A model with ``cross``/``dec`` blocks refuses to step or run forward
    without a memory, or with one of another dtype, batch or width; the
    memory's length is free."""
    model = zoo[arch][2]
    memory, match = _error_cases(model)[case]
    tok = torch.zeros((B, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match=match):
        decode_step(model, init_state(model, B, 4), tok, 0, memory=memory)
    with pytest.raises(ValueError, match=match):
        model(tok, memory=memory)
    with pytest.raises(ValueError, match=match):
        loss_fn(model, {"tokens": tok, "labels": tok, "memory": memory})
    # a memory of any length fits
    lg = decode_step(model, init_state(model, B, 4), tok, 0,
                     memory=torch.zeros((B, 3, model.cfg.d_model)))
    assert lg.shape == (B, model.cfg.vocab_padded)
    if case == "width" and model.cfg.is_encdec:
        with pytest.raises(ValueError, match="enc_inputs"):
            encode_memory(model, memory)
    if case == "no memory" and not model.cfg.is_encdec:
        with pytest.raises(ValueError, match="no encoder"):
            encode_memory(model, torch.zeros((B, 8, model.cfg.d_model)))
