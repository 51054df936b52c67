"""The recurrent families' model steps, port vs the JAX reference (CPU).

Both sides run the reference's ``SMOKE`` configs in float32 (and
``mamba2-130m`` at full width with ``dtype="float32"``), the port holding
JAX's parameters through ``models.convert.from_reference``; every input
is made with numpy from a seed and handed to both.

* ``ssm_decode_step`` and ``rglru_decode_step`` over 12 steps of one
  block: outputs and both cache leaves (the convolution history and the
  state) agree within atol 1e-5 / rtol 1e-4;
* the hybrid's local-window ``attn_decode`` over 40 steps of a 16-slot
  ring (it wraps twice), MQA (one kv head): outputs and the ring within
  atol 1e-5 / rtol 1e-4;
* whole ``decode_step`` of both SMOKE models over 40 steps (the hybrid's
  two stages, ``(rec, rec, attn) x 1`` and the ``(rec,)`` tail):
  logits within atol 1e-4 / rtol 1e-4 and every state leaf of both
  stages within atol 1e-4 / rtol 1e-3;
* ``mamba2-130m`` at full width (24 layers, d_model 768, state 128,
  vocab 50,280) in float32, 2 rows x 3 steps: logits within atol 1e-4 /
  rtol 1e-4;
* ``to_reference`` inverts ``from_reference`` exactly for both families,
  and a bfloat16 tree converts bit for bit;
* both SMOKE models in bfloat16 (the dtype ``mamba2-130m`` runs in), 24
  steps: bfloat16 logits within atol 3e-2 of JAX's, four bfloat16 ulps
  at the logits' magnitude (below 2): the two frameworks round the
  bfloat16 products and sums at different places.

The tolerances cover the two frameworks' different summation orders in
the projections, the convolution's four taps, the state contraction and
the norms (float32 throughout); the state leaves accumulate over 40 steps
and get the looser relative bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import decode_step as j_decode_step
from repro.models import init_model as j_init_model
from repro.models import init_state as j_init_state
from repro.models.attention import attn_decode as j_attn_decode
from repro.models.attention import init_kv_cache as j_init_kv_cache
from repro.models.rglru import init_rglru_cache as j_init_rglru_cache
from repro.models.rglru import rglru_decode_step as j_rglru_decode_step
from repro.models.ssm import init_ssm_cache as j_init_ssm_cache
from repro.models.ssm import ssm_decode_step as j_ssm_decode_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import (decode_step, init_model, init_state,
                                loss_fn, attention, rglru, ssm)
from repro_torch.models.convert import from_reference, to_reference

jax.config.update("jax_platforms", "cpu")

ARCHS = ("mamba2-130m", "recurrentgemma-2b")
TOL = dict(atol=1e-5, rtol=1e-4)


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


def _block(model, stage: int, key: str, rep: int = 0):
    return model.blocks[model.layout.index((stage, key, rep))]


def _sub(params, stage: int, key: str, rep: int = 0):
    return jax.tree.map(lambda a: a[rep], params["stages"][f"s{stage}"][key])


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    """CONFIG and SMOKE hold the reference's values on every field the
    port has, and derive the same stages and pattern."""
    for port, ref in ((get_config(arch), j_get_config(arch)),
                      (get_smoke_config(arch), j_get_smoke_config(arch))):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert port.stages == ref.stages and port.pattern == ref.pattern
        assert port.supports_long_context == ref.supports_long_context


def test_ssm_decode_step_matches_reference(zoo):
    jcfg, params, model = zoo["mamba2-130m"]
    cfg = model.cfg
    p, blk = _sub(params, 0, "b0_ssm")["ssm"], _block(model, 0, "b0_ssm").ssm
    rows = 3
    jcache = j_init_ssm_cache(jcfg, rows, jnp.float32)
    cache = {k: v[0] for k, v in
             ssm.init_ssm_cache(cfg, rows, torch.float32, "cpu").items()}
    xs = np.random.default_rng(1).normal(size=(12, rows, 1, cfg.d_model))
    for x in xs.astype(np.float32):
        jy, jcache = j_ssm_decode_step(p, jnp.asarray(x), jcache, jcfg)
        with torch.no_grad():
            y = ssm.ssm_decode_step(blk, torch.as_tensor(x), cache, cfg)
        _close(y, jy, **TOL)
        _close(cache["conv"], jcache["conv"], **TOL)
        _close(cache["h"], jcache["h"], **TOL)


def test_rglru_decode_step_matches_reference(zoo):
    jcfg, params, model = zoo["recurrentgemma-2b"]
    cfg = model.cfg
    p, blk = _sub(params, 0, "b0_rec"), _block(model, 0, "b0_rec").rec
    rows = 3
    jcache = j_init_rglru_cache(jcfg, rows, jnp.float32)
    cache = {k: v[0] for k, v in
             rglru.init_rglru_cache(cfg, rows, torch.float32, "cpu").items()}
    xs = np.random.default_rng(2).normal(size=(12, rows, 1, cfg.d_model))
    for x in xs.astype(np.float32):
        jy, jcache = j_rglru_decode_step(p["rec"], jnp.asarray(x), jcache,
                                         jcfg)
        with torch.no_grad():
            y = rglru.rglru_decode_step(blk, torch.as_tensor(x), cache, cfg)
        _close(y, jy, **TOL)
        _close(cache["conv"], jcache["conv"], **TOL)
        _close(cache["h"], jcache["h"], **TOL)


def test_rglru_gelu_is_the_tanh_approximation(zoo):
    """``jax.nn.gelu``'s default: the exact erf GeLU would miss by ~1e-4."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.as_tensor(x), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.as_tensor(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_windowed_attn_decode_matches_reference(zoo):
    """40 steps against a 16-slot ring with window 16 (MQA: one kv head,
    four query heads): the ring wraps twice and ages out old entries."""
    jcfg, params, model = zoo["recurrentgemma-2b"]
    cfg = model.cfg
    assert cfg.local_window == 16 and cfg.n_kv_heads == 1
    p, a = _sub(params, 0, "b2_attn")["attn"], _block(model, 0,
                                                      "b2_attn").attn
    rows, steps, ring = 2, 40, 16
    jcache = j_init_kv_cache(jcfg, rows, ring, jnp.float32)
    n = attention.ring_slots(ring)
    ck = torch.zeros((rows, n, cfg.n_kv_heads, cfg.head_dim_))
    cv = torch.zeros_like(ck)
    xs = np.random.default_rng(3).normal(size=(steps, rows, 1, cfg.d_model))
    for t, x in enumerate(xs.astype(np.float32)):
        jy, jcache = j_attn_decode(p, jnp.asarray(x), jcache, jnp.int32(t),
                                   jcfg)
        with torch.no_grad():
            y = attention.attn_decode(a, torch.as_tensor(x), ck, cv, ring,
                                      t, cfg)
        _close(y, jy, **TOL)
        _close(ck[:, :ring], jcache["k"], **TOL)
        _close(cv[:, :ring], jcache["v"], **TOL)


def _state_pairs(model, state, jstate):
    """(port leaf, JAX leaf) for every state leaf of every stage: the
    port stacks each kind's blocks in depth order, JAX per stage block
    with a leading reps axis."""
    seen = {kind: 0 for kind in ("attn", "ssm", "rec")}
    for (i, key, r), kind in zip(model.layout, model.kinds):
        j = seen[kind]
        seen[kind] += 1
        jc = jstate[f"s{i}"][key]
        if kind == "attn":
            ring = jc["kv"]["k"].shape[2]
            yield state.k[j][:, :ring], jc["kv"]["k"][r]
            yield state.v[j][:, :ring], jc["kv"]["v"][r]
        else:
            for leaf in ("conv", "h"):
                yield state.recurrent[f"{kind}.{leaf}"][j], jc[kind][leaf][r]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(zoo, arch):
    """The whole step over 40 steps at max_len 64 (the hybrid's ring is
    min(64, 16) = 16 slots): logits and every state leaf of both stages."""
    jcfg, params, model = zoo[arch]
    rows, steps, max_len = 3, 40, 64
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size,
                                             (rows, steps))
    jstate = j_init_state(jcfg, rows, max_len)
    state = init_state(model, rows, max_len)
    for t in range(steps):
        jlg, jstate = j_decode_step(params, jstate,
                                    jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                    jnp.int32(t), jcfg)
        lg = decode_step(model, state, torch.as_tensor(toks[:, t:t + 1]), t)
        _close(lg, jlg, atol=1e-4, rtol=1e-4)
    pairs = list(_state_pairs(model, state, jstate))
    assert len(pairs) == {"mamba2-130m": 4, "recurrentgemma-2b": 8}[arch]
    for got, want in pairs:
        _close(got, want, atol=1e-4, rtol=1e-3)


def test_mamba2_full_width_float32_matches_reference():
    """The real shapes (24 layers, d_model 768, d_inner 1536, 24 heads x
    64, state 128, vocab 50,280) in float32, 2 rows x 3 steps."""
    jcfg = j_get_config("mamba2-130m").with_(dtype="float32")
    cfg = get_config("mamba2-130m").with_(dtype="float32")
    params = j_init_model(jcfg, jax.random.PRNGKey(1))
    model = from_reference(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    rows, steps = 2, 3
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             (rows, steps))
    jstate = j_init_state(jcfg, rows, steps)
    state = init_state(model, rows, steps)
    for t in range(steps):
        jlg, jstate = j_decode_step(params, jstate,
                                    jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                    jnp.int32(t), jcfg)
        lg = decode_step(model, state, torch.as_tensor(toks[:, t:t + 1]), t)
        assert lg.shape == (rows, cfg.vocab_padded)
        _close(lg, jlg, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_to_reference_inverts_from_reference(zoo, arch):
    jcfg, params, model = zoo[arch]
    want = jax.tree.map(np.asarray, params)
    back = to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, back, want)


def test_bfloat16_tree_converts_by_bit_pattern():
    """A bfloat16 JAX tree lands in a bfloat16 model with every leaf's bits
    unchanged."""
    jcfg = j_get_smoke_config("mamba2-130m").with_(dtype="bfloat16")
    params = j_init_model(jcfg, jax.random.PRNGKey(2))
    tree = jax.tree.map(np.asarray, params)
    model = from_reference(tree, get_smoke_config("mamba2-130m").with_(
        dtype="bfloat16"), device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    bits = tree["stages"]["s0"]["b0_ssm"]["ssm"]["A_log"].view(np.uint16)
    got = _block(model, 0, "b0_ssm", 1).ssm.A_log
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), bits[1])
    back = to_reference(model)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a, np.asarray(b, np.float32)), back, tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_decode_step_tracks_reference(arch):
    jcfg = j_get_smoke_config(arch).with_(dtype="bfloat16")
    params = j_init_model(jcfg, jax.random.PRNGKey(0))
    model = from_reference(jax.tree.map(np.asarray, params),
                           get_smoke_config(arch).with_(dtype="bfloat16"),
                           device="cpu")
    rows, steps = 3, 24
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size,
                                             (rows, steps))
    jstate = j_init_state(jcfg, rows, 64)
    state = init_state(model, rows, 64)
    for t in range(steps):
        jlg, jstate = j_decode_step(params, jstate,
                                    jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                    jnp.int32(t), jcfg)
        lg = decode_step(model, state, torch.as_tensor(toks[:, t:t + 1]), t)
        assert lg.dtype == torch.bfloat16
        np.testing.assert_allclose(lg.float().numpy(),
                                   np.asarray(jlg, np.float32), atol=3e-2,
                                   rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_scans_are_named_gaps(arch):
    """The training scans run: the seeded SMOKE model's ``forward`` and
    ``loss_fn`` over 2 x 20 tokens (20 is not a multiple of mamba2's chunk
    of 8) are finite, and so is every gradient.
    ``tests/test_torch_recurrent_train.py`` holds them against JAX."""
    model = init_model(get_smoke_config(arch), device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (2, 21)))
    x, aux = model(toks[:, :-1])
    assert x.shape == (2, 20, model.cfg.d_model) and float(aux) == 0.0
    loss = loss_fn(model, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("kind", ["cross", "dec"])
def test_unported_kinds_raise(kind):
    """The cross-attention kinds (ported since the vlm and audio
    families) build in a recurrent pattern, and a step without the memory
    they read raises the named error; with one it steps.
    ``tests/test_torch_encdec.py`` holds them against JAX."""
    cfg = get_smoke_config("recurrentgemma-2b").with_(
        block_pattern=("rec", kind))
    model = init_model(cfg, device="cpu")
    state = init_state(model, 2, 8)
    tok = torch.zeros((2, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="pass memory="):
        decode_step(model, state, tok, 0)
    lg = decode_step(model, state, tok, 0,
                     memory=torch.zeros((2, 3, cfg.d_model)))
    assert lg.shape == (2, cfg.vocab_padded) and bool(torch.isfinite(
        lg).all())
