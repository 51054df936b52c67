"""The rest of the dense zoo, and the first-index top-k, port vs the JAX
reference (CPU).

``qwen1.5-4b`` (QKV bias, 20 heads padded to 32 over 20 kv heads),
``qwen3-4b`` and ``qwen3-32b`` (per-head QK norm) and ``llama3-405b``
(blockwise attention, ``grad_accum`` 2 and a chunked loss at SMOKE).
Both sides run the reference's ``SMOKE`` configs in float32, the port
holding JAX's parameters through ``models.convert.from_reference``; the
biases and norm scales are moved off their inits (zeros and ones) so they
matter.  Every input is made with numpy from a seed and handed to both.

* CONFIG and SMOKE hold the reference's values;
* ``forward``, 12 ``decode_step`` positions and a 12-position
  ``prefill_chunk``: hidden states within atol 1e-5 / rtol 1e-4, logits
  within atol 1e-4 / rtol 1e-4 (the decode path's tiles sum in another
  order);
* ``loss_fn`` within rtol 1e-5 and every gradient leaf within 1e-5 of its
  largest entry (the dense family's tolerances, ``test_torch_train.py``);
* blockwise attention against JAX's ``_blockwise_attn`` and the port's
  naive schedule, with ``S % attn_block != 0`` and a ``sliding_window``;
* ``qwen1.5-4b``'s head geometry at SMOKE width (5 heads padded to 8 over
  5 kv heads, ``qkv_bias``) with nonzero padded heads: the head map is the
  reference's (padded heads read kv head 0), and forward and decode match;
* a padded head count that is a multiple of the kv heads (6 heads padded
  to 8 over 2): JAX's decode groups the heads otherwise than its forward,
  and the port follows ``kv_head_map`` in both (its decode is JAX's
  forward);
* ``to_reference`` inverts ``from_reference`` with the new leaves;
* the SMOKE round trips of ``qwen3-4b`` and ``llama3-405b`` on the coder
  backend are bit-exact, and the full vocabulary (151,936) meets the SPC's
  named error;
* ``model_topk_candidates`` is ``jax.lax.top_k`` on built ties (all-zero
  rows, integer-valued rows at K = 256, 4096 and 32,768, rows with
  ``-inf``), and ``topk_first`` routes as the repeated-``argmax`` rule it
  replaced.
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
from repro.models import prefill_chunk as j_prefill_chunk
from repro.models.attention import attn_forward as j_attn_forward
from repro.models.attention import kv_head_map as j_kv_head_map
from repro.models.transformer import forward as j_forward
from repro.models.transformer import loss_fn as j_loss_fn
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import bitstream
from repro_torch.core.predictors import model_topk_candidates, topk_first
from repro_torch.data.pipeline import token_stream
from repro_torch.models import (decode_step, init_model, init_state,
                                prefill_chunk)
from repro_torch.models.attention import attn_forward, kv_head_map
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.serve import compress
from repro_torch.train import train_loop

jax.config.update("jax_platforms", "cpu")

ARCHS = ("qwen1.5-4b", "qwen3-4b", "qwen3-32b", "llama3-405b")
TOL = dict(atol=1e-5, rtol=1e-4)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
_MOVED = ("bq", "bk", "bv", "q_norm", "k_norm")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one CPU thread: its SMOKE ops are small, and
    beside other busy test processes torch's idle worker threads spin for
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moved(params, seed: int):
    """``params`` with the biases and the q/k norm scales moved by
    normal(0, 0.1) draws (their inits are zeros and ones)."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        if any(getattr(k, "key", None) in _MOVED for k in path):
            return a + jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(move, params)


def _pair(jcfg, cfg, seed: int = 0):
    params = _moved(j_init_model(jcfg, jax.random.PRNGKey(seed)), seed)
    return params, from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")


@pytest.fixture(scope="module")
def zoo():
    return {arch: (j_get_smoke_config(arch),) + _pair(
        j_get_smoke_config(arch), get_smoke_config(arch)) for arch in ARCHS}


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _toks(vocab: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    for port, ref in ((get_config(arch), j_get_config(arch)),
                      (get_smoke_config(arch), j_get_smoke_config(arch))):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert port.stages == ref.stages
        assert port.n_heads_padded == ref.n_heads_padded


def _forward_decode_prefill(jcfg, params, model, rows: int = 2):
    """Hidden states of ``forward`` over 24 tokens, logits of 12
    ``decode_step`` positions and of a 12-position ``prefill_chunk``."""
    toks = _toks(jcfg.vocab_size, (rows, 24), 1)
    jx, _ = j_forward(params, jnp.asarray(toks, jnp.int32), jcfg)
    with torch.no_grad():
        x, _ = model(torch.as_tensor(toks))
    _close(x, jx, **TOL)
    jstate, state = j_init_state(jcfg, rows, 16), init_state(model, rows, 16)
    for t in range(12):
        jlg, jstate = j_decode_step(params, jstate,
                                    jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                    jnp.int32(t), jcfg)
        lg = decode_step(model, state, torch.as_tensor(toks[:, t:t + 1]), t)
        _close(lg, jlg, **LOGIT_TOL)
    pos0, n_valid = np.zeros(rows, np.int64), np.full(rows, 12)
    jlp, _ = j_prefill_chunk(params, j_init_state(jcfg, rows, 16),
                             jnp.asarray(toks[:, :12], jnp.int32),
                             jnp.asarray(pos0, jnp.int32),
                             jnp.asarray(n_valid, jnp.int32), jcfg)
    lp = prefill_chunk(model, init_state(model, rows, 16),
                       torch.as_tensor(toks[:, :12]), torch.as_tensor(pos0),
                       torch.as_tensor(n_valid))
    _close(lp, jlp, **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_decode_and_prefill_match_reference(zoo, arch):
    _forward_decode_prefill(*zoo[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(zoo, arch):
    """``llama3-405b`` SMOKE runs its two microbatches and its chunked
    loss (``logits_chunk`` 8)."""
    jcfg, params, model = zoo[arch]
    toks = _toks(jcfg.vocab_size, (4, 32), 2)
    labels = _toks(jcfg.vocab_size, (4, 32), 3)
    batch = {"tokens": toks, "labels": labels}
    jl, jg = jax.value_and_grad(j_loss_fn)(
        params, jax.tree.map(lambda a: jnp.asarray(a, jnp.int32), batch),
        jcfg)
    loss, grads = train_loop.grads_fn(model, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    got = jax.tree_util.tree_leaves_with_path(to_reference(model, grads))
    ref = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jg)))
    assert len(got) == len(ref)
    for path, g in got:
        r = ref[path]
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-5 * max(np.abs(r).max(), 1e-12),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("s,window", [(29, 0), (29, 6), (16, 0)])
def test_blockwise_attention_matches_reference_and_naive(zoo, s, window):
    """``llama3-405b`` SMOKE's first attention block, ``attn_block`` 8:
    the keys padded to whole blocks (29 positions), an exact multiple
    (16), and a 6-position sliding window."""
    jcfg, params, model = zoo["llama3-405b"]
    jcfg = jcfg.with_(sliding_window=window)
    cfg = model.cfg.with_(sliding_window=window)
    assert cfg.attn_impl == "blockwise" and cfg.attn_block == 8
    p = jax.tree.map(lambda a: a[0],
                     params["stages"]["s0"]["b0_attn"]["attn"])
    x = np.random.default_rng(s + window).normal(
        size=(2, s, cfg.d_model)).astype(np.float32)
    a = model.blocks[0].attn
    with torch.no_grad():
        y = attn_forward(a, torch.as_tensor(x), cfg)
        naive = attn_forward(a, torch.as_tensor(x),
                             cfg.with_(attn_impl="naive"))
    _close(y, j_attn_forward(p, jnp.asarray(x), jcfg), **TOL)
    _close(y, naive, **TOL)


def test_padded_head_geometry_matches_reference():
    """``qwen1.5-4b``'s geometry at SMOKE width: 5 heads padded to 8
    (``tp`` 8) over 5 kv heads with ``qkv_bias``, the padded heads' query,
    bias and output weights drawn nonzero so what they read shows."""
    jcfg = j_get_smoke_config("qwen1.5-4b").with_(n_heads=5, n_kv_heads=5,
                                                   tp=8)
    cfg = get_smoke_config("qwen1.5-4b").with_(n_heads=5, n_kv_heads=5, tp=8)
    assert cfg.n_heads_padded == 8 and cfg.n_heads_padded % 5
    want = np.asarray(j_kv_head_map(jcfg))
    np.testing.assert_array_equal(kv_head_map(cfg).numpy(), want)
    np.testing.assert_array_equal(want[5:], 0)
    params = j_init_model(jcfg, jax.random.PRNGKey(6))
    rng = np.random.default_rng(6)
    attn = params["stages"]["s0"]["b0_attn"]["attn"]
    for name, axis in (("wq", 2), ("bq", 1), ("wo", 1)):
        a = np.array(attn[name])
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(5, None)
        assert not a[tuple(idx)].any()        # zero at init
        a[tuple(idx)] = rng.normal(0, 0.1, a[tuple(idx)].shape)
        attn[name] = jnp.asarray(a)
    params = _moved(params, 6)
    model = from_reference(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    _forward_decode_prefill(jcfg, params, model)


def test_padded_whole_groups_follow_the_head_map():
    """6 heads padded to 8 (``tp`` 4) over 2 kv heads: the padded count is
    a multiple of the kv heads, so JAX's decode groups query head ``i``
    onto ``i // 4`` while its ``forward`` (and ``kv_head_map``) reads ``i //
    3``: true head 3 reads another kv head, and JAX's decode is not its own
    forward (last-position logits apart by more than 1e-2; 0.299 measured).
    The port reads the map in both: its decode and its forward equal
    JAX's forward."""
    jcfg = j_get_smoke_config("qwen3-4b").with_(n_heads=6, n_kv_heads=2,
                                                 tp=4)
    cfg = get_smoke_config("qwen3-4b").with_(n_heads=6, n_kv_heads=2, tp=4)
    params = j_init_model(jcfg, jax.random.PRNGKey(7))
    model = from_reference(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    toks = _toks(jcfg.vocab_size, (2, 8), 8)
    jx, _ = j_forward(params, jnp.asarray(toks, jnp.int32), jcfg)
    jfwd = np.asarray(jnp.einsum("bsd,dv->bsv", jx,
                                 params["tok"]["lm_head"]))[:, -1]
    jstate, state = j_init_state(jcfg, 2, 8), init_state(model, 2, 8)
    for t in range(8):
        jlg, jstate = j_decode_step(params, jstate,
                                    jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                    jnp.int32(t), jcfg)
        lg = decode_step(model, state, torch.as_tensor(toks[:, t:t + 1]), t)
    assert np.abs(np.asarray(jlg) - jfwd).max() > 1e-2
    _close(lg, jfwd, **LOGIT_TOL)
    with torch.no_grad():
        x, _ = model(torch.as_tensor(toks))
    _close(x, jx, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_to_reference_inverts_from_reference(zoo, arch):
    jcfg, params, model = zoo[arch]
    want = jax.tree.map(np.asarray, params)
    back = to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, back, want)
    names = {n for n, _ in model.blocks[0].attn.named_parameters()}
    extra = ({"bq", "bk", "bv"} if jcfg.qkv_bias else set()) | (
        {"q_norm", "k_norm"} if jcfg.qk_norm else set())
    assert names - {"wq", "wk", "wv", "wo"} == extra


@pytest.mark.parametrize("arch", ["qwen3-4b", "llama3-405b"])
def test_smoke_roundtrip_bit_exact(arch):
    """4 lanes x 40 tokens, chunk 16, seeded weights: the coder backend's
    round trip is exact, and the kernel backend's container (the plain
    versions here) is the coder's byte for byte."""
    cfg = get_smoke_config(arch)
    model = init_model(cfg, seed=3, device="cpu")
    toks = token_stream(cfg.vocab_size, (4, 40), seed=4)
    blobs = {}
    for backend in ("coder", "kernel"):
        st = compress.lm_compress_chunked(model, toks, 16, backend=backend,
                                          device="cpu")
        blobs[backend] = bitstream.pack_chunked(*st.chunks, chunk_size=16,
                                                n_symbols=40)
    assert blobs["coder"] == blobs["kernel"]
    sym, _ = compress.lm_decompress_chunked(
        model, bitstream.parse_chunked(blobs["coder"]), 40, 16,
        backend="coder", device="cpu")
    np.testing.assert_array_equal(sym.numpy(), toks)


def test_full_vocabulary_meets_the_spc_ceiling():
    """``qwen3-4b``'s 151,936 symbols exceed 2**16: one narrow layer with
    the full vocabulary is refused by the SPC's named error."""
    cfg = get_config("qwen3-4b").with_(n_layers=1, d_model=32, d_ff=32,
                                       n_heads=2, n_kv_heads=1, head_dim=16,
                                       tp=1, dtype="float32")
    model = init_model(cfg, seed=0, device="cpu")
    toks = token_stream(cfg.vocab_size, (1, 4), seed=0)
    with pytest.raises(ValueError, match=r"exceeds 2\*\*prob_bits"):
        compress.lm_compress_chunked(model, toks, 4, prob_bits=16,
                                     device="cpu")


def _top_k_rows():
    """Built ties: all-zero rows, integer-valued rows (many equal values)
    at K = 256, 4096 and 32,768, and rows of -inf with a few finite
    entries."""
    rng = np.random.default_rng(11)
    rows = [np.zeros((2, 256), np.float32)]
    rows += [rng.integers(-3, 3, (16, k)).astype(np.float32)
             for k in (256, 4096, 32768)]
    inf = np.full((3, 64), -np.inf, np.float32)
    inf[0, 5] = 1.0
    inf[1, [7, 9]] = 0.0
    rows.append(inf)
    return rows


@pytest.mark.parametrize("k", [1, 4])
def test_model_topk_candidates_match_jax_on_ties(k):
    for x in _top_k_rows():
        want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
        got = model_topk_candidates(torch.as_tensor(x), k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _argmax_rule(probs: torch.Tensor, k: int):
    """The MoE router's earlier top-k: ``k`` repeated ``argmax`` es, each
    pick masked with -1 (probabilities are non-negative)."""
    iota = torch.arange(probs.shape[-1])
    left, vals, ids = probs, [], []
    for _ in range(k):
        i = left.argmax(-1, keepdim=True)
        vals.append(probs.gather(-1, i))
        ids.append(i)
        left = left.masked_fill(iota == i, -1.0)
    return torch.cat(vals, -1), torch.cat(ids, -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_first_routes_as_before(dtype):
    """Router probabilities of 8 and 16 experts (rounded logits, so ties
    are common in bfloat16): ``topk_first`` gives the repeated-``argmax``
    rule's values and ids bit for bit, and JAX's ids."""
    rng = np.random.default_rng(12)
    for e in (8, 16):
        logits = torch.as_tensor(rng.normal(0, 0.5, (512, e)).astype(
            np.float32)).to(getattr(torch, dtype))
        probs = torch.softmax(logits.float(), -1)
        w, ids = topk_first(probs, 2)
        w0, ids0 = _argmax_rule(probs, 2)
        assert torch.equal(ids, ids0) and torch.equal(w, w0)
        np.testing.assert_array_equal(
            ids.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(
                probs.numpy()), 2)[1]))
