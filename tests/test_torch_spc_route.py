"""The fused LM path's SPC through B6, and B6's selection rule (CPU).

* At ``tests/test_torch_compress.py``'s size (the ``SMOKE`` model, 4 lanes
  x 40 tokens, chunk 16 with a ragged tail), ``backend="kernel"`` gives
  the same container bytes, symbols and per-lane probes as
  ``backend="coder"``, and its SPC goes through the B6 wrappers: one
  ``ops.spc_quantize_tables`` call on the compress side, one
  ``spc_quantize.spc_freq_cdf`` call per decoded position.
* The batched ``collect_tables`` (one quantization of every step's BF16
  probabilities) equals the per-step one on every plane.
* The selection rule of ``csrc/spc_quantize.cu``, written here in numpy
  (the -0.0 canonicalisation, the order-preserving key with the index as
  tiebreak, the radix select of the top-up and the weighted radix select
  of the waterfill), equals JAX's ``repro.core.spc.quantize_probs`` on tie
  patterns, pathological rows and random Dirichlet rows at K in {1, 2,
  255, 256, 4096}, and a sort-based rule on residuals that hold both -0.0
  and +0.0.  ``spc_freq_cdf`` on the CPU equals JAX's
  ``freq_cdf_from_probs`` for float32 and bfloat16 input.
* Above the register layouts (16,384 < K <= 65,536): the same rule with
  a segmented index-order walk (each of 32 warps a contiguous segment of
  ``ceil(K / 1024) * 32`` entries, 32 a round) equals JAX's
  ``quantize_probs`` at K in {16,385, 50,280, 65,536}, ``prob_bits=16``,
  on Dirichlet, tied and near-uniform rows; and the cluster layout of
  ``spc_cluster_kernel`` (8-bit digit histograms over ``ceil(K / 8,192)``
  segments below the keys' common prefix, the segments' and warps' tie
  prefixes and CDF offsets from their totals) equals JAX's
  ``freq_cdf_from_probs`` at K in {16,385, 32,064, 32,768, 50,280,
  65,536}.

Integer outputs compare exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import spc as jspc
from repro_torch.configs.ras_pimc import SMOKE
from repro_torch.core import bitstream, spc
from repro_torch.data.pipeline import token_stream
from repro_torch.kernels import ops, spc_quantize
from repro_torch.models import init_model
from repro_torch.serve import compress

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

LANES, T, CHUNK = 4, 40, 16          # ragged: 16 + 16 + 8


@pytest.fixture(scope="module")
def model():
    return init_model(SMOKE, seed=0, device="cpu")


@pytest.fixture(scope="module")
def tokens():
    return token_stream(256, (LANES, T), seed=5)


def _counting(monkeypatch):
    """Count the B6 wrappers' calls on the serve path."""
    calls = {"spc_freq_cdf": 0, "spc_quantize_tables": 0}

    def wrap(mod, name):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    wrap(spc_quantize, "spc_freq_cdf")
    wrap(ops, "spc_quantize_tables")
    return calls


def _round_trip(model, tokens, backend):
    st = compress.lm_compress_chunked(model, tokens, CHUNK, backend=backend,
                                      device="cpu")
    blob = bitstream.pack_chunked(*st.chunks, chunk_size=CHUNK, n_symbols=T)
    sym, avg, probes = compress.lm_decompress_chunked(
        model, bitstream.parse_chunked(blob), T, CHUNK, backend=backend,
        lane_probes=True, device="cpu")
    return blob, sym.numpy(), float(avg), probes.numpy()


def test_kernel_backend_equals_coder_backend(model, tokens):
    kern = _round_trip(model, tokens, "kernel")
    ref = _round_trip(model, tokens, "coder")
    assert kern[0] == ref[0]
    np.testing.assert_array_equal(kern[1], tokens)
    np.testing.assert_array_equal(kern[1], ref[1])
    assert kern[2] == ref[2]
    np.testing.assert_array_equal(kern[3], ref[3])


@pytest.mark.parametrize("backend,want", [
    ("kernel", {"spc_quantize_tables": 1, "spc_freq_cdf": T}),
    ("coder", {"spc_quantize_tables": 0, "spc_freq_cdf": 0}),
])
def test_kernel_backend_routes_its_spc_through_b6(model, tokens, monkeypatch,
                                                  backend, want):
    calls = _counting(monkeypatch)
    _round_trip(model, tokens, backend)
    assert calls == want


@pytest.mark.parametrize("prob_bits", [14, 16])
def test_batched_collect_tables_equals_per_step(model, tokens, prob_bits):
    toks = torch.as_tensor(tokens, dtype=torch.int64)
    got, xent = compress.collect_tables(model, toks, prob_bits, "kernel")
    want, want_xent = compress.collect_tables(model, toks, prob_bits,
                                              "coder")
    for name in spc.TableSet._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape == (T, LANES, 256 + (name == "cdf")), name
        assert torch.equal(a, b), name
    assert float(xent) == float(want_xent)


def test_collect_tables_rejects_unknown_backend(model, tokens):
    toks = torch.as_tensor(tokens, dtype=torch.int64)
    with pytest.raises(ValueError, match="unknown encode backend"):
        compress.collect_tables(model, toks, 14, "two_pass")


# ---------------------------------------------------------------------------
# the kernel's selection rule, in numpy
# ---------------------------------------------------------------------------

def _bf16(p: np.ndarray) -> np.ndarray:
    """float32 -> bf16 (round to nearest even) -> float32, as the kernel's
    F32In::round_bf16 does it on the bits."""
    u = p.astype(np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    return np.where(nan, np.float32(np.nan), r.view(np.float32))


def _key(resid: np.ndarray) -> np.ndarray:
    """resid -> the order-preserving uint32 key, -0.0 made +0.0 first."""
    u = resid.astype(np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    neg = (u >> 31) == 1
    return np.where(neg, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def select_rule(resid, f0, delta) -> np.ndarray:
    """The radix-select correction of ``spc_quantize.cu`` on one row."""
    k = f0.size
    key = _key(resid).astype(np.int64)
    f = f0.astype(np.int64).copy()
    if delta >= 0:
        r = delta % k
        f += delta // k
        if r:
            v = 0                                  # the r-th largest key
            for b in range(31, -1, -1):
                if (key >= (v | 1 << b)).sum() >= r:
                    v |= 1 << b
            m = r - (key > v).sum()
            tie = key == v
            before = np.cumsum(tie) - tie          # index-order tie rank
            f += (key > v) | (tie & (before < m))
        return f
    need = -delta
    cap = f0.astype(np.int64) - 1
    v = 0                                  # least key with sum(cap) >= need
    for b in range(31, -1, -1):
        if cap[key <= (v | ((1 << b) - 1))].sum() < need:
            v |= 1 << b
    rem = need - cap[key < v].sum()
    tcap = np.where(key == v, cap, 0)
    before = np.cumsum(tcap) - tcap
    take = np.where(key < v, cap,
                    np.where(key == v, np.clip(rem - before, 0, cap), 0))
    return f - take


def sort_rule(resid, f0, delta) -> np.ndarray:
    """The reference's stable-sort correction on one row."""
    k = f0.size
    f = f0.astype(np.int64).copy()
    if delta >= 0:
        order = np.argsort(-resid, kind="stable")  # resid desc, index asc
        rank = np.empty(k, np.int64)
        rank[order] = np.arange(k)
        return f + delta // k + (rank < delta % k)
    order = np.argsort(resid, kind="stable")
    cap = (f0.astype(np.int64) - 1)[order]
    excl = np.cumsum(cap) - cap
    take = np.empty(k, np.int64)
    take[order] = np.minimum(np.clip(-delta - excl, 0, None), cap)
    return f - take


def quantize_rows(probs: np.ndarray, prob_bits: int = 14) -> np.ndarray:
    """Steps 1-5 of the kernel, then :func:`select_rule` per row."""
    total = 1 << prob_bits
    p = _bf16(probs)
    p = np.where(np.isfinite(p) & (p > 0), p, np.float32(0))
    scaled = (p * np.float32(total)).astype(np.float32)
    f0 = np.maximum(1, np.rint(scaled)).astype(np.int64)
    resid = (scaled - f0.astype(np.float32)).astype(np.float32)
    return np.stack([select_rule(r, f, total - int(f.sum()))
                     for r, f in zip(resid, f0)])


def _pathological(k=128):            # tests/test_torch_spc_kernel.py's
    return np.stack([
        np.full(k, 1.0 / k),
        np.r_[1.0, np.zeros(k - 1)],
        np.r_[np.full(k - 1, 1e-9), [1.0]],
        np.full(k, 1 / 3),                # unnormalised: delta far below 0
    ] * 2)


def _ties(k=64):                     # the tie rows of the SPC tests
    return np.stack([
        np.full(k, 1.0 / k),
        np.tile([0.5, 0.25, 0.25, 0.0] * 4, 4) / 4.0,
        np.r_[np.full(k // 2, 3e-5), np.full(k // 2, 0.03)],
        np.tile([0.5, 0.25, 0.25, 0.0], k // 4) / (k // 4),
        np.r_[np.full(k // 2, 3e-5), np.full(k // 2, 0.015)],
    ])


ROWS = {
    "pathological": lambda: _pathological(),
    "ties": lambda: _ties(),
    **{f"dirichlet_k{k}": (lambda k=k: np.random.default_rng(k).dirichlet(
        np.full(k, 0.5), size=6)) for k in (1, 2, 255, 256, 4096)},
}


@pytest.mark.parametrize("name", list(ROWS))
def test_selection_rule_matches_jax(name):
    probs = ROWS[name]().astype(np.float32)
    want = np.asarray(jspc.quantize_probs(jnp.asarray(probs)))
    got = quantize_rows(probs)
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == 1 << 14).all() and got.min() >= 1
    # the torch plain version the CPU path runs agrees too
    np.testing.assert_array_equal(
        spc_quantize.spc_quantize_plain(torch.as_tensor(probs)).numpy(),
        want)


def test_selection_rule_ties_signed_zero_residuals():
    """Residuals with -0.0 and +0.0 interleaved: the reference's stable
    sort ties them, so the selection must order them by index alone."""
    rng = np.random.default_rng(3)
    k = 64
    zeros = np.where(np.arange(k) % 2 == 0, np.float32(-0.0),
                     np.float32(0.0))
    base = rng.uniform(-0.5, 0.5, k).astype(np.float32)
    rows = 0
    for frac in (0.25, 0.5, 1.0):
        resid = np.where(rng.uniform(size=k) < frac, zeros, base).astype(
            np.float32)
        assert np.signbit(resid[resid == 0]).any()
        assert (~np.signbit(resid[resid == 0])).any()
        f0 = rng.integers(1, 40, k)
        for delta in (1, 5, k - 1, 3 * k + 7, -1, -9, -int(f0.sum() - k)):
            np.testing.assert_array_equal(select_rule(resid, f0, delta),
                                          sort_rule(resid, f0, delta))
            rows += 1
    assert rows == 21


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spc_freq_cdf_matches_jax(dtype):
    rng = np.random.default_rng(7)
    probs = np.concatenate([rng.dirichlet(np.full(256, 0.4), size=12),
                            _pathological(256)]).astype(np.float32)
    x = torch.as_tensor(probs).to(getattr(torch, dtype))
    freq, cdf = spc_quantize.spc_freq_cdf(x)
    jf, jc = jspc.freq_cdf_from_probs(jnp.asarray(x.float().numpy()))
    np.testing.assert_array_equal(freq.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(cdf.numpy(), np.asarray(jc))
    assert (cdf[:, -1] == 1 << 14).all()
    np.testing.assert_array_equal(
        spc_quantize.spc_quantize(x).numpy(), np.asarray(jf))


def wide_rule(resid, f0, delta) -> np.ndarray:
    """:func:`select_rule` with the tie ranks of a segmented walk: 32 warp
    segments in rounds of 32 entries, each warp starting from the earlier
    warps' totals (the one-block wide layout before the cluster layout)."""
    k = f0.size
    key = _key(resid).astype(np.int64)
    f = f0.astype(np.int64).copy()
    topup = delta >= 0
    base, r = (delta // k, delta % k) if topup else (0, 0)
    sel = select_rule(resid, f0, delta)        # for v, via its selection
    if topup and r == 0:
        return f + base
    if topup:
        v = 0
        for b in range(31, -1, -1):
            if (key >= (v | 1 << b)).sum() >= r:
                v |= 1 << b
        m = r - (key > v).sum()
        weight = (key == v).astype(np.int64)
    else:
        cap = f - 1
        v = 0
        for b in range(31, -1, -1):
            if cap[key <= (v | ((1 << b) - 1))].sum() < -delta:
                v |= 1 << b
        m = -delta - cap[key < v].sum()
        weight = np.where(key == v, cap, 0)
    seg = -(-k // 1024) * 32
    excl = np.zeros(k, np.int64)
    before = 0
    for lo in range(0, 32 * seg, seg):          # the warps, in order
        for j in range(lo, min(k, lo + seg), 32):   # their rounds
            w = weight[j:min(k, j + 32)]
            excl[j:j + w.size] = before + np.cumsum(w) - w
            before += w.sum()
    at = key == v
    if topup:
        out = f + base + ((key > v) | (at & (excl < m)))
    else:
        take = np.where(key < v, cap,
                        np.where(at, np.clip(m - excl, 0, cap), 0))
        out = f - take
    np.testing.assert_array_equal(out, sel)
    return out


def _wide_rows(k):
    rng = np.random.default_rng(k)
    base = np.full(k, 1.0 / k)
    return np.stack([
        rng.dirichlet(np.full(k, 0.5)),
        base,                                              # one tie run
        base * (1 + 1e-3 * rng.standard_normal(k)),        # near-uniform
        np.tile([0.5, 0.25, 0.25, 0.0], k // 4 + 1)[:k] / (k / 4),
        np.r_[np.full(k // 2, 3e-6), np.full(k - k // 2, 1.5e-5)],
        np.full(k, 1 / 3),                                 # the waterfill
    ]).astype(np.float32)


@pytest.mark.parametrize("k", [16385, 50280, 65536])
def test_wide_selection_rule_matches_jax(k):
    probs = _wide_rows(k)
    want = np.asarray(jspc.quantize_probs(jnp.asarray(probs), 16))
    total = 1 << 16
    p = _bf16(probs)
    p = np.where(np.isfinite(p) & (p > 0), p, np.float32(0))
    scaled = (p * np.float32(total)).astype(np.float32)
    f0 = np.maximum(1, np.rint(scaled)).astype(np.int64)
    resid = (scaled - f0.astype(np.float32)).astype(np.float32)
    deltas = [total - int(f.sum()) for f in f0]
    # both corrections run (at K = 2**16 every f0 >= 1 already fills the
    # mass, so only the waterfill and delta = 0 can)
    assert min(deltas) < 0 and (max(deltas) > 0 or k == total)
    got = np.stack([wide_rule(r, f, d)
                    for r, f, d in zip(resid, f0, deltas)])
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == total).all() and got.min() >= 1
    np.testing.assert_array_equal(
        spc_quantize.spc_quantize_plain(torch.as_tensor(probs), 16).numpy(),
        want)


# ---------------------------------------------------------------------------
# the cluster layout (csrc/spc_quantize.cu, spc_cluster_kernel), in numpy
# ---------------------------------------------------------------------------

WIDE_SEG, DIGIT, PASSES = 8192, 8, 4     # kWideSeg, kDigitBits, kPasses
WARP_ENTRIES = 32 * 16                   # a warp's entries: 32 lanes x kWideE


def _final_sum(f0s, gl, tie, n, before, topup, base, r, m):
    """A segment's or a warp's final sum from its totals and the tie weights
    before it (the kernel's ``final_sum``)."""
    at_v = np.minimum(np.maximum(m - before, 0), tie)
    if topup:
        return f0s + base * n + (gl + at_v if r > 0 else 0)
    return f0s - gl - at_v


def cluster_rule(probs_row: np.ndarray, prob_bits: int = 16):
    """One row through the cluster layout: C = ceil(K / 8,192) segments of
    a multiple of 16 entries; the mass and the least and largest key; 8-bit
    digit passes below the keys' common prefix, each a histogram per
    segment of the keys matching the boundary so far, summed, the digit
    where the running total (counts from the top, caps from the bottom)
    reaches the rank or the need; then the tie prefix and the CDF offsets
    from the segments' and their warps' totals (never from summing f).
    Returns ``(freq, cdf, passes run)``."""
    k, total = probs_row.size, 1 << prob_bits
    p = _bf16(probs_row)
    p = np.where(np.isfinite(p) & (p > 0), p, np.float32(0))
    scaled = (p * np.float32(total)).astype(np.float32)
    f0 = np.maximum(1, np.rint(scaled)).astype(np.int64)
    key = _key((scaled - f0.astype(np.float32)).astype(np.float32)).astype(
        np.int64)
    c = -(-k // WIDE_SEG)
    seg = -(-(-(-k // c)) // 16) * 16
    bounds = [(i * seg, min(k, (i + 1) * seg)) for i in range(c)]
    assert all(lo < hi for lo, hi in bounds) and seg <= WIDE_SEG
    delta = total - int(f0.sum())
    topup = delta >= 0
    base, r = (delta // k, delta % k) if topup else (0, 0)
    want = r if topup else -delta
    cap = f0 - 1
    w = np.ones(k, np.int64) if topup else cap
    kmin, kmax = int(key.min()), int(key.max())
    nb = 0 if kmin == kmax else (kmin ^ kmax).bit_length()
    v = kmin & ~((1 << nb) - 1)
    acc, passes = 0, 0
    for ps in range(PASSES if (not topup or r > 0) else 0):
        shift = 32 - DIGIT * (ps + 1)
        if shift >= nb:
            continue                         # bits every key shares
        above = shift + DIGIT
        match = (key >> above) == (v >> above)
        bins = np.zeros(1 << DIGIT, np.int64)
        for lo, hi in bounds:                # every segment's own bins
            d = (key[lo:hi] >> shift) & ((1 << DIGIT) - 1)
            np.add.at(bins, d[match[lo:hi]], w[lo:hi][match[lo:hi]])
        below = np.cumsum(bins) - bins
        before = bins.sum() - below - bins if topup else below
        hit = np.flatnonzero((acc + before < want)
                             & (want <= acc + before + bins))
        assert hit.size == 1
        v |= int(hit[0]) << shift
        acc += int(before[hit[0]])
        passes += 1
    m = want - acc
    at = key == v
    tw = np.where(at, w, 0)
    gl = np.where(key > v if topup else key < v, w, 0)
    # segment totals, then the warps' within each segment
    freq = np.empty(k, np.int64)
    cdf = np.zeros(k + 1, np.int64)
    seg_tie = np.array([tw[lo:hi].sum() for lo, hi in bounds])
    seg_tb = np.cumsum(seg_tie) - seg_tie
    seg_f = np.array([_final_sum(f0[lo:hi].sum(), gl[lo:hi].sum(), t_, hi - lo,
                                 tb, topup, base, r, m)
                      for (lo, hi), t_, tb in zip(bounds, seg_tie, seg_tb)])
    seg_off = np.cumsum(seg_f) - seg_f
    for (lo, hi), tb0, off in zip(bounds, seg_tb, seg_off):
        for wlo in range(lo, hi, WARP_ENTRIES):
            whi = min(hi, wlo + WARP_ENTRIES)
            wt = tw[wlo:whi]
            excl = tb0 + np.cumsum(wt) - wt
            ff = f0[wlo:whi].copy()
            if topup:
                ff += base + ((r > 0) & ((key[wlo:whi] > v)
                                         | (at[wlo:whi] & (excl < m))))
            else:
                ff -= np.where(key[wlo:whi] < v, cap[wlo:whi],
                               np.where(at[wlo:whi],
                                        np.clip(m - excl, 0, cap[wlo:whi]),
                                        0))
            freq[wlo:whi] = ff
            cdf[wlo + 1:whi + 1] = off + np.cumsum(ff)
            fsum = _final_sum(f0[wlo:whi].sum(), gl[wlo:whi].sum(), wt.sum(),
                              whi - wlo, tb0, topup, base, r, m)
            assert fsum == ff.sum()          # the warp's offset from totals
            tb0 += wt.sum()
            off += fsum
    return freq, cdf, passes


@pytest.mark.parametrize("k", [16385, 32064, 32768, 50280, 65536])
def test_cluster_selection_rule_matches_jax(k):
    """The cluster layout's selection, tie prefix and CDF offsets in numpy
    against JAX's ``freq_cdf_from_probs`` (16,385 and 50,280 split over 3
    and 7 segments that do not divide them), with rows that need no pass
    (no remainder, or every key tied), a row whose keys' common prefix cuts
    a pass, and rows that take all four."""
    probs = _wide_rows(k)
    jf, jc = (np.asarray(a) for a in jspc.freq_cdf_from_probs(
        jnp.asarray(probs), 16))
    np.testing.assert_array_equal(jf, np.asarray(
        jspc.quantize_probs(jnp.asarray(probs), 16)))
    runs = [cluster_rule(row) for row in probs]
    for i, (freq, cdf, _) in enumerate(runs):
        np.testing.assert_array_equal(freq, jf[i])
        np.testing.assert_array_equal(cdf, jc[i])
    passes = [n for _, _, n in runs]
    assert passes[1] == 0 and passes[5] == 0     # no selection, or one tie
    assert max(passes) == PASSES
    if k in (32064, 50280):                      # the common prefix cuts one
        assert passes[2] == PASSES - 1
    assert (jc[:, -1] == 1 << 16).all()
