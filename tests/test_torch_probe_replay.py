"""The identity the CUDA full-stream decode relies on (CPU).

On a strictly increasing CDF (every SPC frequency >= 1) the search's
symbol is the unique x with cdf[x] <= slot < cdf[x+1], and its probe count
is a pure function of x, ``slot == cdf[x]``, the candidate ids and the
predictor's window.  ``repro_torch.core.search.replay_probes`` (the plain
mirror of ``csrc/decode_search.cuh``) is held equal to the port's and the
JAX package's ``find_symbol`` for every slot of SPC tables, with
candidates (out-of-range and duplicate ids) and the windows of all three
predictors; a table with a zero frequency breaks the identity.  The
running-sum ``NeighborAverage`` mirror is held equal to the port's and the
JAX package's ``predict``/``update`` across chunk resets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import predictors as jpred
from repro.core import search as jsearch
from repro_torch.core import predictors, search, spc

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

_I64 = torch.int64
PREDICTORS = {"none": None, "neighbor": predictors.NeighborAverage(4, 8),
              "last": predictors.LastValue(8),
              "zero": predictors.ZeroPredictor(8)}


def _table(k: int, prob_bits: int, seed: int):
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.full(k, 0.3)).astype(np.float32)
    tbl = spc.tables_from_probs(torch.as_tensor(probs), prob_bits)
    assert int(tbl.freq.min()) >= 1 and int(tbl.cdf[-1]) == 1 << prob_bits
    return tbl.cdf.to(_I64)


def _windows(pred, x_ctx: np.ndarray, k: int):
    """The predictor's anchor per lane from a context of earlier symbols
    ``x_ctx (lanes, window)``, and the clipped window ``[lo_w, hi_w)``."""
    if pred is None:
        return None, None, None
    if isinstance(pred, predictors.NeighborAverage):
        mu = x_ctx.sum(-1) // x_ctx.shape[-1]
    elif isinstance(pred, predictors.LastValue):
        mu = x_ctx[:, -1]
    else:
        mu = np.zeros(x_ctx.shape[0], np.int64)
    lo_w = np.clip(mu - pred.delta, 0, k - 1)
    hi_w = np.clip(mu + pred.delta + 1, 1, k)
    return mu, lo_w, hi_w


@pytest.mark.parametrize("prob_bits", [12, 14, 16])
@pytest.mark.parametrize("k", [256, 255, 4096])
def test_replay_equals_find_symbol_every_slot(k, prob_bits):
    cdf = _table(k, prob_bits, seed=k + prob_bits)
    slots = torch.arange(1 << prob_bits, dtype=_I64)
    n = slots.shape[0]
    rng = np.random.default_rng(prob_bits)
    x_true = torch.searchsorted(cdf, slots, right=True) - 1
    at_start = cdf[x_true] == slots
    # candidates: random ids with out-of-range and duplicate entries; a
    # quarter of the rows hold the true symbol somewhere
    cands = rng.integers(-3, k + 3, (n, 5))
    cands[:, 3] = cands[:, 1]
    rows = rng.random(n) < 0.25
    cands[rows, rng.integers(0, 5, rows.sum())] = x_true.numpy()[rows]
    jcdf = jnp.asarray(cdf.numpy().astype(np.int32))
    jslots = jnp.asarray(slots.numpy().astype(np.int32))
    for name, pred in PREDICTORS.items():
        ctx = np.clip(x_true.numpy()[:, None]
                      + rng.integers(-12, 13, (n, 4)), 0, k - 1)
        mu, lo_w, hi_w = _windows(pred, ctx, k)
        delta = None if pred is None else pred.delta
        for cd in (None, cands):
            x, probes = search.find_symbol(
                cdf, k, slots, None if cd is None else torch.as_tensor(cd),
                mu=None if mu is None else torch.as_tensor(mu), delta=delta)
            jx, jprobes = jsearch.find_symbol(
                jcdf, k, jslots,
                mu=None if mu is None else jnp.asarray(mu.astype(np.int32)),
                delta=delta,
                candidates=None if cd is None else jnp.asarray(
                    cd.astype(np.int32)))
            replay = search.replay_probes(
                x_true, at_start, None if cd is None else torch.as_tensor(cd),
                None if lo_w is None else torch.as_tensor(lo_w),
                None if hi_w is None else torch.as_tensor(hi_w), k)
            tag = f"{name}, candidates={cd is not None}"
            assert torch.equal(x, x_true), tag
            assert np.array_equal(np.asarray(jx), x_true.numpy()), tag
            assert torch.equal(replay, probes), tag
            assert np.array_equal(np.asarray(jprobes), replay.numpy()), tag


def test_replay_fails_on_a_zero_frequency():
    """With freq[x] == 0 the bisection can commit early on a symbol whose
    interval is empty, so neither the symbol nor the probes follow from the
    interval identity: the kernel's guard sends such tables to the exact
    bisection."""
    freq = torch.tensor([3, 0, 0, 5, 1, 0, 7], dtype=_I64)
    cdf = torch.cat([torch.zeros(1, dtype=_I64), torch.cumsum(freq, 0)])
    k = freq.shape[0]
    slots = torch.arange(int(cdf[-1]), dtype=_I64)
    x, probes = search.find_symbol(cdf, k, slots)
    x_true = torch.searchsorted(cdf, slots, right=True) - 1
    replay = search.replay_probes(x_true, cdf[x_true] == slots, None, None,
                                  None, k)
    assert not torch.equal(x, x_true) or not torch.equal(probes, replay)
    assert bool((freq[x] == 0).any())     # the search answered an empty x
    # the same table with every frequency >= 1 satisfies it
    freq1 = freq.clamp(min=1)
    cdf1 = torch.cat([torch.zeros(1, dtype=_I64), torch.cumsum(freq1, 0)])
    slots1 = torch.arange(int(cdf1[-1]), dtype=_I64)
    x1, probes1 = search.find_symbol(cdf1, k, slots1)
    assert torch.equal(probes1, search.replay_probes(
        x1, cdf1[x1] == slots1, None, None, None, k))


@pytest.mark.parametrize("k", [1, 2, 3, 7, 64, 100])
def test_bisect_probes_is_translation_invariant(k):
    """The replay's depth function from any bracket [lo, hi) equals the
    reference bisection's active iterations on a strictly increasing CDF."""
    cdf = torch.arange(k + 1, dtype=_I64) * 3
    for lo in range(k):
        for hi in range(lo + 1, k + 1):
            xs = torch.arange(lo, hi, dtype=_I64)
            for off in (0, 1):                 # slot at cdf[x] or inside
                slots = cdf[xs] + off
                x, steps = search.bsearch(
                    cdf, slots, torch.full_like(xs, lo),
                    torch.full_like(xs, hi), search.ceil_log2(k))
                assert torch.equal(x, xs)
                assert torch.equal(steps, search.bisect_probes(
                    torch.full_like(xs, hi - lo), xs - lo,
                    torch.full_like(xs, off == 0, dtype=torch.bool)))


@pytest.mark.parametrize("window", list(range(1, 17)))
def test_running_mean_mu_matches_neighbor_average(window):
    rng = np.random.default_rng(window)
    lanes, t_len, chunk = 5, 61, 17 if window % 2 else 40
    syms = rng.integers(0, 4096, (lanes, t_len))
    got = predictors.running_mean_mu(torch.as_tensor(syms), window, chunk)
    pt, jp = predictors.NeighborAverage(window, 8), jpred.NeighborAverage(
        window, 8)
    want = np.zeros((lanes, t_len), np.int64)
    for c0 in range(0, t_len, chunk):
        ctx, jctx = pt.init(lanes), jp.init(lanes)
        for t in range(c0, min(c0 + chunk, t_len)):
            mu = pt.predict(ctx).mu
            want[:, t] = mu.numpy()
            assert np.array_equal(np.asarray(jp.predict(jctx).mu), want[:, t])
            ctx = pt.update(ctx, torch.as_tensor(syms[:, t]))
            jctx = jp.update(jctx, jnp.asarray(syms[:, t].astype(np.int32)))
    assert np.array_equal(got.numpy(), want)


def test_mean_reciprocal_is_exact_below_2_pow_28():
    """The kernel's 32-bit mean: (sum * ceil(2**32 / n)) >> 32 == sum // n
    for n in 2..16 and every sum the kernel can hold (16 * K, K < 2**24)."""
    rng = np.random.default_rng(0)
    sums = np.concatenate([np.arange(1 << 16), rng.integers(0, 1 << 28, 1 << 16),
                           (1 << 28) - 1 - np.arange(1 << 12)])
    sums = torch.as_tensor(sums, dtype=_I64)
    for n in range(2, 17):
        assert torch.equal((sums * predictors.mean_rcp(n)) >> 32, sums // n)
