"""The port's training path against JAX (CPU, float32, the smoke width).

* ``data.pipeline.train_batch`` equals ``repro.data.pipeline.train_batch``
  integer for integer.
* ``loss_fn`` and every gradient leaf (``models.convert.to_reference``
  lays the port's gradients out as the reference's tree) against
  ``jax.value_and_grad(repro.models.transformer.loss_fn)`` on converted
  parameters: the plain loss, ``logits_chunk`` and a config whose padded
  vocabulary is wider than its vocabulary (the -1e30 tail).  Tolerance:
  the loss within rtol 1e-5, each gradient leaf within 1e-5 of its largest
  entry (two frameworks' reduction orders in matmul, softmax and rsqrt).
* ``LM.forward``'s last-position logits against the port's
  ``decode_step`` scan over the same tokens (atol 1e-4, rtol 1e-4: the
  decode path's tiled attention sums in another order).
* Three ``adamw_update`` steps with float32 and bfloat16 moments,
  ``clip_by_global_norm`` and ``cosine_lr`` against JAX (rtol 1e-5; the
  bfloat16 moments bit for bit, since they are rounded where JAX rounds
  them).
* Two ``make_train_step`` steps against JAX's (loss, grad norm, lr and
  every updated parameter), and ``grad_accum = 2`` against the full batch
  (``grad_dtype`` and ``moment_dtype`` taken from the config), in
  ``grads_fn`` and in a step whose config differs from the model's only
  there (any other difference raises).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.ras_pimc import SMOKE as J_SMOKE
from repro.data import pipeline as jpipeline
from repro.models import init_model as j_init_model
from repro.models.transformer import loss_fn as j_loss_fn
from repro.train import optimizer as joptimizer
from repro.train import train_loop as jtrain_loop
from repro_torch.configs.ras_pimc import SMOKE
from repro_torch.data import pipeline
from repro_torch.models import decode_step, init_model, init_state, loss_fn
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.train import optimizer, train_loop

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

B, S = 4, 32


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


def _pair(jcfg, seed=3):
    params = j_init_model(jcfg, jax.random.PRNGKey(seed))
    return params, jax.tree.map(np.asarray, params)


def _port_cfg(jcfg):
    return SMOKE.with_(vocab_size=jcfg.vocab_size,
                       logits_chunk=jcfg.logits_chunk,
                       grad_accum=jcfg.grad_accum)


def _tensors(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("batch,seq,step,host,seed",
                         [(4, 32, 0, 0, 0), (2, 17, 5, 1, 3), (1, 1, 9, 2, 7)])
def test_train_batch_integer_identical(batch, seq, step, host, seed):
    got = pipeline.train_batch(SMOKE, batch, seq, step=step, host=host,
                               seed=seed)
    ref = jpipeline.train_batch(J_SMOKE, batch, seq, step=step, host=host,
                                seed=seed)
    assert set(got) == set(ref) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], ref[k])
    # a vlm config's memory plane too (tests/test_torch_encdec.py holds
    # the vlm and audio SMOKE configs' planes)
    vlm = dict(family="vlm", memory_tokens=3)
    got = pipeline.train_batch(SMOKE.with_(**vlm), batch, seq, step=step,
                               host=host, seed=seed)
    ref = jpipeline.train_batch(J_SMOKE.with_(**vlm), batch, seq, step=step,
                                host=host, seed=seed)
    assert got["memory"].shape == (batch, 3, SMOKE.d_model)
    np.testing.assert_array_equal(got["memory"], ref["memory"])


@pytest.mark.parametrize("variant", ["plain", "chunked", "padded_vocab"])
def test_loss_and_every_gradient_match_reference(variant):
    jcfg = {"plain": J_SMOKE, "chunked": J_SMOKE.with_(logits_chunk=8),
            "padded_vocab": J_SMOKE.with_(vocab_size=200)}[variant]
    cfg = _port_cfg(jcfg)
    assert (cfg.vocab_padded > cfg.vocab_size) == (variant == "padded_vocab")
    params, tree = _pair(jcfg)
    batch = jpipeline.train_batch(jcfg, B, S, step=1)
    jl, jg = jax.value_and_grad(j_loss_fn)(
        params, jax.tree.map(jnp.asarray, batch), jcfg)
    model = from_reference(tree, cfg, device="cpu")
    loss, grads = train_loop.grads_fn(model, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _leaves_close(to_reference(model, grads), jg, 1e-5)
    direct = loss_fn(model, _tensors(batch))
    np.testing.assert_allclose(float(direct.detach()), float(jl), rtol=1e-5)


def test_forward_last_position_matches_decode_step():
    _, tree = _pair(J_SMOKE)
    model = from_reference(tree, SMOKE, device="cpu")
    toks = torch.as_tensor(pipeline.token_stream(256, (3, 12), seed=4))
    with torch.no_grad():
        hidden, aux = model(toks)
        fwd = hidden[:, -1] @ model.embedding.T
    assert float(aux) == 0.0
    state = init_state(model, 3, 12)
    for t in range(12):
        lg = decode_step(model, state, toks[:, t:t + 1], t)
    np.testing.assert_allclose(fwd.numpy(), lg.numpy(), atol=1e-4, rtol=1e-4)


def test_unported_training_options_raise():
    model = init_model(SMOKE.with_(attn_impl="flash"), device="cpu")
    batch = _tensors(pipeline.train_batch(SMOKE, 1, 4))
    with pytest.raises(ValueError, match="attn_impl='flash'"):
        loss_fn(model, batch)
    # the cross-pod step is ported (tests/test_torch_collectives.py); as
    # in the reference it needs the pod mesh
    with pytest.raises(ValueError, match="multi-pod mesh"):
        train_loop.make_train_step(SMOKE, compress_crosspod=True)
    # a memory is ported (tests/test_torch_encdec.py); a model without
    # cross attention ignores it, as the reference does
    dense = init_model(SMOKE, device="cpu")
    assert torch.equal(loss_fn(dense, dict(batch, memory=torch.zeros(1, 2,
                                                                     64))),
                       loss_fn(dense, batch))


def test_to_reference_inverts_from_reference():
    _, tree = _pair(J_SMOKE, seed=5)
    back = to_reference(from_reference(tree, SMOKE, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_clip_and_schedule_match_reference(moment_dtype):
    rng = np.random.default_rng(6)
    shapes = {"a": (5, 3), "b": (7,)}
    p = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jst = joptimizer.adamw_init(jp, jnp.dtype(moment_dtype))
    st = optimizer.adamw_init(tp, moment_dtype)
    for i in range(3):
        g = {k: (rng.normal(0, 3, s)).astype(np.float32)
             for k, s in shapes.items()}
        jg, jn = joptimizer.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
        tg, n = optimizer.clip_by_global_norm(
            {k: torch.as_tensor(v) for k, v in g.items()}, 1.0)
        np.testing.assert_allclose(float(n), float(jn), rtol=1e-5)
        lr = 1e-2 * (i + 1)
        jp, jst = joptimizer.adamw_update(jg, jst, jp, lr)
        tp, st = optimizer.adamw_update(tg, st, tp, lr)
        assert int(st.step) == int(jst.step) == i + 1
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7)
            for got, ref in ((st.m[k], jst.m[k]), (st.v[k], jst.v[k])):
                assert str(got.dtype).endswith(moment_dtype)
                ref = np.asarray(ref, np.float32)
                if moment_dtype == "bfloat16":
                    # rounded where the reference rounds: the same bits
                    np.testing.assert_array_equal(got.float().numpy(), ref)
                else:
                    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                               atol=1e-12)
    for step in (0, 1, 50, 99, 100, 101, 5000, 10_000, 20_000):
        got = optimizer.cosine_lr(torch.tensor(step, dtype=torch.int32),
                                  base_lr=3e-3)
        ref = joptimizer.cosine_lr(jnp.int32(step), base_lr=3e-3)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6,
                                   atol=1e-12)


def test_train_step_matches_reference():
    jcfg = J_SMOKE.with_(grad_accum=1)
    params, tree = _pair(jcfg, seed=8)
    model = from_reference(tree, SMOKE, device="cpu")
    jstate = jtrain_loop.init_train_state(params)
    state = train_loop.init_train_state(model)
    jstep = jax.jit(jtrain_loop.make_train_step(jcfg, base_lr=3e-3))
    step = train_loop.make_train_step(SMOKE, base_lr=3e-3)
    for i in range(2):       # step 0 has lr 0 (warmup); step 1 moves
        batch = jpipeline.train_batch(jcfg, B, S, step=i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
    assert int(state.step) == 2
    _leaves_close(to_reference(state.model), jstate.params, 1e-5)


def test_grad_accum_two_equals_full_batch():
    _, tree = _pair(J_SMOKE, seed=9)

    def model(**kw):
        return from_reference(tree, SMOKE.with_(**kw), device="cpu")

    batch = pipeline.train_batch(SMOKE, B, S, step=2)
    full_loss, full = train_loop.grads_fn(model(), batch)
    acc_loss, acc = train_loop.grads_fn(model(grad_accum=2), batch)
    np.testing.assert_allclose(float(acc_loss), float(full_loss), rtol=1e-6)
    for k, g in full.items():
        assert acc[k].dtype == torch.float32
        np.testing.assert_allclose(acc[k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-6 * float(g.abs().max()),
                                   err_msg=k)
    bf = train_loop.grads_fn(model(grad_accum=2, grad_dtype="bfloat16"),
                             batch)[1]
    assert all(g.dtype == torch.bfloat16 for g in bf.values())
    bf_state = train_loop.init_train_state(init_model(
        SMOKE.with_(moment_dtype="bfloat16"), device="cpu"))
    assert all(m.dtype == torch.bfloat16 for m in bf_state.opt.m.values())
    with pytest.raises(ValueError, match="grad_accum"):
        train_loop.grads_fn(model(grad_accum=2),
                            pipeline.train_batch(SMOKE, 3, S))


def test_train_step_takes_only_grad_accum_beside_the_model_config():
    """The step's config may differ from the model's only in
    ``grad_accum``, which splits the batch: two microbatches step the
    parameters as the whole batch does."""
    _, tree = _pair(J_SMOKE, seed=10)
    batch = pipeline.train_batch(SMOKE, B, S, step=3)
    out = []
    for n in (1, 2):
        state = train_loop.init_train_state(
            from_reference(tree, SMOKE, device="cpu"))
        step = train_loop.make_train_step(SMOKE.with_(grad_accum=n),
                                          base_lr=3e-3)
        for _ in range(2):
            state, m = step(state, batch)
        out.append((float(m["loss"]), to_reference(state.model)))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    _leaves_close(out[1][1], out[0][1], 1e-5)
    step = train_loop.make_train_step(SMOKE.with_(logits_chunk=8))
    with pytest.raises(ValueError, match="logits_chunk"):
        step(train_loop.init_train_state(
            from_reference(tree, SMOKE, device="cpu")), batch)
