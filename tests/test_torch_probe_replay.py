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
JAX package's ``predict``/``update`` across chunk resets.  The wide rows'
search of ``csrc/rans_decode_step.cu`` (the candidates by ballot, then the
bisection read ahead five levels a round from a 31-node subtree of mids
loaded at once) is mirrored in numpy and held equal to JAX's
``find_symbol``, symbol and probes, on every slot of K = 32,064, 32,768
and 50,280 rows, SPC rows and rows with zero frequencies, with and
without top-4 candidates.
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


# ---------------------------------------------------------------------------
# B2's wide rows: the bisection read ahead by the warp
# ---------------------------------------------------------------------------

TREE_LEVELS = 5                     # kTreeLevels


def _tree_nodes(cdf: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Each lane j < 31's load of a round from brackets [lo, hi): the cdf at
    the mid of heap node j + 1 (its path from the root in the bits below
    the top one), 0 where its bracket holds one entry.  (31, n)."""
    out = np.zeros((31,) + lo.shape, np.int64)
    for lane in range(31):
        node = lane + 1
        l, h = lo.copy(), hi.copy()
        for d in range(node.bit_length() - 2, -1, -1):
            mid = (l + h) >> 1
            right = (node >> d) & 1
            l, h = (mid, h) if right else (l, mid)
        live = h - l > 1
        out[lane] = np.where(live, cdf[np.where(live, (l + h) >> 1, 0)], 0)
    return out


def tree_search(cdf: np.ndarray, k: int, slot: np.ndarray,
                cands: np.ndarray | None, n_iter: int):
    """The wide rows' search of B2 for every slot: ``(x, probes, rounds)``.
    Candidates first (the first clipped id whose interval holds the slot
    wins; every one tried costs a probe), then the masked bisection of
    ``n_iter`` iterations from [0, K), walked through each round's
    preloaded subtree, one probe per active iteration, ``cdf[mid] == slot``
    committing early."""
    n = slot.shape[0]
    probes = np.zeros(n, np.int64)
    found = np.zeros(n, bool)
    x = np.zeros(n, np.int64)
    for c in ([] if cands is None else cands.T):
        cc = np.clip(c, 0, k - 1)
        ok = (cdf[cc] <= slot) & (slot < cdf[cc + 1]) & ~found
        probes += ~found
        x = np.where(ok, cc, x)
        found |= ok
    lo = np.where(found, x, 0)
    hi = np.where(found, x + 1, k)
    it = np.zeros(n, np.int64)
    rounds = 0
    while ((hi - lo > 1) & (it < n_iter)).any():
        nodes = _tree_nodes(cdf, lo, hi)     # one level of independent loads
        rounds += 1
        node = np.ones(n, np.int64)
        for _ in range(TREE_LEVELS):
            act = (hi - lo > 1) & (it < n_iter)
            mid = (lo + hi) >> 1
            c = nodes[node - 1, np.arange(n)]
            assert np.array_equal(c[act], cdf[mid[act]])
            probes += act
            it += act
            go = act & (c <= slot)
            lo = np.where(go, mid, lo)
            hi = np.where(go & (c == slot), mid + 1,
                          np.where(act & ~go, mid, hi))
            node = np.where(go, 2 * node + 1, 2 * node)
    return lo, probes, rounds


def _wide_step_rows(k: int, seed: int):
    """A K-entry SPC row at prob_bits 16 and the same row with frequencies
    0 (their mass moved to symbol 128): cdf rows (K + 1,)."""
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.full(k, 0.3)).astype(np.float32)
    freq = spc.tables_from_probs(torch.as_tensor(probs), 16).freq.numpy()
    zf = freq.astype(np.int64).copy()
    zeros = rng.choice(np.arange(200, k), 40, replace=False)
    zf[128] += zf[zeros].sum() + zf[3:7].sum()
    zf[zeros] = 0
    zf[3:7] = 0
    return {name: np.r_[0, np.cumsum(f)].astype(np.int64)
            for name, f in (("spc", freq), ("zero_freq", zf))}


@pytest.mark.parametrize("rows", ["spc", "zero_freq"])
@pytest.mark.parametrize("k", [32064, 32768, 50280])
def test_tree_search_equals_find_symbol(k, rows):
    cdf = _wide_step_rows(k, seed=k)[rows]
    assert cdf[-1] == 1 << 16
    slots = np.arange(1 << 16, dtype=np.int64)
    n = slots.size
    rng = np.random.default_rng(k + 1)
    x_true = np.searchsorted(cdf, slots, side="right") - 1
    cands = rng.integers(-3, k + 3, (n, 4))
    cands[:, 3] = cands[:, 1]                     # duplicate ids
    hold = rng.random(n) < 0.25
    cands[hold, rng.integers(0, 4, hold.sum())] = x_true[hold]
    jcdf = jnp.asarray(cdf.astype(np.int32))
    jslots = jnp.asarray(slots.astype(np.int32))
    n_iter = search.ceil_log2(k)
    for cd in (None, cands):
        x, probes, rounds = tree_search(cdf, k, slots, cd, n_iter)
        jx, jprobes = jsearch.find_symbol(
            jcdf, k, jslots,
            candidates=None if cd is None else jnp.asarray(
                cd.astype(np.int32)))
        tag = f"{rows}, candidates={cd is not None}"
        assert np.array_equal(x, np.asarray(jx)), tag
        assert np.array_equal(probes, np.asarray(jprobes)), tag
        # n_iter levels (15 or 16) in rounds of at most five
        assert rounds == -(-n_iter // TREE_LEVELS), tag
    if rows == "zero_freq":                      # the search ends on an
        empty = np.diff(cdf)[x] == 0             # empty interval somewhere
        assert empty.any() and not np.array_equal(x, x_true)
