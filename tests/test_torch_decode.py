"""Port decode surfaces vs the JAX reference (CPU).

The same numpy-seeded inputs go through ``repro`` and ``repro_torch``;
every integer output must be identical (symbols, per-lane and per-chunk
probes, under planes and flags, container bytes, named errors):

* ``find_symbol`` with a predictor bracket at the alphabet edges, with
  delta 0 and combined with candidates;
* ``coder.decode`` / ``decode_chunked`` with every predictor, the LUT and
  truncated streams;
* the plain B3 against the Pallas ``rans_decode_lanes`` (interpret mode) on
  all three table layouts, with predictors, candidates, ragged chunks and
  truncated streams; the plain B4 against ``rans_decode_slab`` through
  ``ops.rans_decode_chunked(from_container=)``, the three poisoned slabs
  included;
* the v1 container, ``unpack_chunked`` and the size helpers;
* the static-table image path and the Fig. 4(b) probe totals;
* the two-pass LM decode on the ``SMOKE`` config.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.ras_pimc import SMOKE as J_SMOKE
from repro.core import bitstream as jbs
from repro.core import coder as jcoder
from repro.core import predictors as jpred
from repro.core import search as jsearch
from repro.core import spc as jspc
from repro.data import pipeline as jpipe
from repro.kernels import ops as jops
from repro.kernels.rans_decode import rans_decode_lanes as j_decode_lanes
from repro.kernels.rans_decode import rans_decode_slab as j_decode_slab
from repro.models import init_model as j_init_model
from repro.serve import compress as jcompress
from repro_torch.configs.ras_pimc import SMOKE
from repro_torch.core import bitstream, coder, predictors, search, spc
from repro_torch.data import pipeline
from repro_torch.kernels import ops, rans_decode
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

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_vectors")

PREDICTORS = {
    "none": (None, None),
    "na48": (jpred.NeighborAverage(4, 8), predictors.NeighborAverage(4, 8)),
    "na24": (jpred.NeighborAverage(2, 4), predictors.NeighborAverage(2, 4)),
    "last": (jpred.LastValue(8), predictors.LastValue(8)),
    "zero": (jpred.ZeroPredictor(8), predictors.ZeroPredictor(8)),
}


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, ref, what=""):
    np.testing.assert_array_equal(_np(got), np.asarray(ref), err_msg=what)


def _case(layout, seed, k=40, lanes=4, t=37, smooth=False):
    """Seeded (JAX tables, port tables, symbols).  ``smooth`` makes
    random-walk symbols, so the predictors hit and miss."""
    rng = np.random.default_rng(seed)
    shape = {"static": (), "perpos": (t,), "lane": (t, lanes)}[layout]
    probs = rng.dirichlet(np.full(k, 0.5), size=shape or None).astype(
        np.float32)
    if smooth:
        syms = np.clip(k // 2 + np.cumsum(rng.integers(-2, 3, (lanes, t)),
                                          1), 0, k - 1).astype(np.int32)
    else:
        syms = rng.integers(0, k, (lanes, t)).astype(np.int32)
    return (jspc.tables_from_probs(jnp.asarray(probs)),
            spc.tables_from_probs(_t(probs)), syms)


def _cands(syms, k, topk, seed):
    return pipeline.candidate_planes(syms, k, topk, 0.6, seed=seed)


# ---------------------------------------------------------------------------
# predictors and the search core
# ---------------------------------------------------------------------------

def test_predictor_configs_compare_by_type():
    assert predictors.LastValue(8) != predictors.ZeroPredictor(8)
    assert hash(predictors.LastValue(8)) != hash(predictors.ZeroPredictor(8))
    assert predictors.NeighborAverage(4, 8) == predictors.NeighborAverage()
    assert len({predictors.LastValue(3), predictors.LastValue(3)}) == 1


@pytest.mark.parametrize("name", ["na48", "na24", "last", "zero"])
def test_predictor_steps_match_reference(name):
    jp, tp = PREDICTORS[name]
    rng = np.random.default_rng(len(name))
    jctx, tctx = jp.init(5), tp.init(5)
    for _ in range(7):
        jpr, tpr = jp.predict(jctx), tp.predict(tctx)
        _eq(tpr.mu, jpr.mu, name)
        assert tpr.delta == int(jpr.delta)
        x = rng.integers(0, 64, 5)
        jctx = jp.update(jctx, jnp.asarray(x, jnp.int32))
        tctx = tp.update(tctx, _t(x))
        _eq(tctx, jctx, name)


@pytest.mark.parametrize("per_lane,topk,delta", [
    (False, 0, 0), (False, 0, 8), (True, 0, 3), (True, 4, 0), (False, 2, 5)])
def test_find_symbol_window_matches_reference(per_lane, topk, delta):
    rng = np.random.default_rng(31 + 7 * topk + delta + per_lane)
    lanes, k = 48, 24
    probs = rng.dirichlet(np.full(k, 0.4), size=(lanes,) if per_lane
                          else None)
    cdf = np.asarray(jspc.tables_from_probs(
        jnp.asarray(probs, jnp.float32)).cdf)
    slot = rng.integers(0, 1 << 14, lanes)
    true = np.asarray(jnp.searchsorted(jnp.asarray(cdf if not per_lane
                                                   else cdf[0]),
                                       jnp.asarray(slot), side="right")) - 1
    # anchors at and past both alphabet edges, near and far from the symbol
    mu = np.r_[np.zeros(8), np.full(8, k - 1), np.full(4, -3),
               np.full(4, k + 2), true[24:36], rng.integers(0, k, 12)]
    cands = rng.integers(-2, k + 2, (lanes, topk)).astype(np.int32)
    if topk:
        cands[::3, -1] = true[::3]
    jx, jp = jsearch.find_symbol(
        jnp.asarray(cdf), k, jnp.asarray(slot, jnp.uint32),
        mu=jnp.asarray(mu, jnp.int32), delta=delta,
        candidates=jnp.asarray(cands))
    tx, tp = search.find_symbol(
        _t(cdf.astype(np.int64)).to(torch.int32), k, _t(slot),
        candidates=_t(cands), mu=_t(mu.astype(np.int64)), delta=delta)
    _eq(tx, jx)
    _eq(tp, jp)


# ---------------------------------------------------------------------------
# the pure-torch coder decode
# ---------------------------------------------------------------------------

def _encoded(jt, syms, cut=0):
    """JAX-encoded monolithic stream (the last ``cut`` bytes dropped) in
    both frameworks."""
    enc = jcoder.encode(jnp.asarray(syms), jt)
    if cut:
        enc = jcoder.EncodedLanes(buf=enc.buf[:, :-cut], start=enc.start,
                                  length=enc.length - cut)
    return enc, bitstream.EncodedLanes(*(_t(a) for a in enc[:3]))


@pytest.mark.parametrize("name", list(PREDICTORS))
def test_coder_decode_predictors_match_reference(name):
    jt, tt, syms = _case("static", seed=3, k=64, lanes=6, t=48, smooth=True)
    jp, tp = PREDICTORS[name]
    enc, tenc = _encoded(jt, syms)
    jsym, javg, jl = jcoder.decode(enc, 48, jt, predictor=jp,
                                   lane_probes=True)
    tsym, tavg, tl = coder.decode(tenc, 48, tt, predictor=tp,
                                  lane_probes=True)
    _eq(tsym, syms)
    _eq(tsym, jsym)
    _eq(tl, jl)
    assert float(tavg) == pytest.approx(float(javg), rel=1e-6)


@pytest.mark.parametrize("layout", ["static", "perpos", "lane"])
def test_coder_decode_layouts_with_candidates_match_reference(layout):
    jt, tt, syms = _case(layout, seed=5, smooth=True)
    cands = _cands(syms, 40, 3, seed=5)
    enc, tenc = _encoded(jt, syms)
    pj, pt = PREDICTORS["na24"]
    ref = jcoder.decode(enc, 37, jt, predictor=pj, lane_probes=True,
                        candidates=jnp.asarray(cands))
    got = coder.decode(tenc, 37, tt, predictor=pt, lane_probes=True,
                       candidates=_t(cands))
    _eq(got[0], ref[0])
    _eq(got[2], ref[2])


def test_coder_decode_lut_matches_reference():
    jt, tt, syms = _case("static", seed=6, k=64, lanes=4, t=40)
    _eq(spc.decode_lut(tt), jspc.decode_lut(jt))
    enc, tenc = _encoded(jt, syms)
    ref = jcoder.decode(enc, 40, jt, use_lut=True, lane_probes=True)
    got = coder.decode(tenc, 40, tt, use_lut=True, lane_probes=True)
    _eq(got[0], ref[0])
    _eq(got[2], ref[2])
    with pytest.raises(ValueError, match="exclusive"):
        coder.decode(tenc, 40, tt, use_lut=True,
                     candidates=_t(_cands(syms, 64, 2, 1)))


@pytest.mark.parametrize("layout,chunk", [("static", 16), ("perpos", 12),
                                          ("lane", 37), ("lane", 10)])
def test_coder_decode_chunked_matches_reference(layout, chunk):
    jt, tt, syms = _case(layout, seed=8, smooth=True)
    cands = _cands(syms, 40, 2, seed=8)
    ch = jcoder.encode_chunked(jnp.asarray(syms), jt, chunk)
    tch = bitstream.ChunkedLanes(*(_t(a) for a in ch[:3]))
    pj, pt = PREDICTORS["na48"]
    ref = jcoder.decode_chunked(ch, 37, jt, chunk, predictor=pj,
                                lane_probes=True,
                                candidates=jnp.asarray(cands))
    got = coder.decode_chunked(tch, 37, tt, chunk, predictor=pt,
                               lane_probes=True, candidates=_t(cands))
    _eq(got[0], syms)
    _eq(got[2], ref[2])
    assert float(got[1]) == pytest.approx(float(ref[1]), rel=1e-6)


@pytest.mark.parametrize("layout", ["perpos", "lane"])
def test_table_slicing_matches_reference(layout):
    jt, tt, _ = _case(layout, seed=12)
    for got, ref in ((coder.slice_tables(tt, 5, 19),
                      jcoder.slice_tables(jt, 5, 19)),
                     (coder.chunk_tables(tt, 3, 10),
                      jcoder.chunk_tables(jt, 3, 10))):
        assert type(got) is type(tt)
        for a, b in zip(got, ref):
            _eq(a.to(torch.int64) & 0xFFFFFFFF,
                np.asarray(b).astype(np.int64))


def test_coder_decode_truncated_matches_reference():
    jt, tt, syms = _case("lane", seed=9)
    enc, tenc = _encoded(jt, syms, cut=3)
    ref = jcoder.decode(enc, 37, jt, lane_probes=True, return_exhausted=True)
    got = coder.decode(tenc, 37, tt, lane_probes=True, return_exhausted=True)
    for a, b in zip(got, ref):
        if isinstance(a, torch.Tensor) and a.dtype != torch.float32:
            _eq(a, b)
    assert bool(got[3].any())
    with pytest.raises(coder.StreamExhaustedError):
        coder.decode(tenc, 37, tt)
    ch = jcoder.encode_chunked(jnp.asarray(syms), jt, 16)
    tch = bitstream.ChunkedLanes(_t(ch.buf)[..., :-2], _t(ch.start),
                                 _t(ch.length) - 2)
    with pytest.raises(coder.StreamExhaustedError):
        coder.decode_chunked(tch, 37, tt, 16)


# ---------------------------------------------------------------------------
# plain B3 / B4 against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

B3_CASES = [
    # layout, chunk (None: monolithic), predictor, topk, cut
    ("static", None, "na48", 0, 0),
    ("static", 16, "last", 2, 0),
    ("perpos", 12, "zero", 0, 0),
    ("perpos", None, "none", 3, 2),
    ("lane", 16, "na24", 4, 0),
    ("lane", 10, "none", 2, 3),
]


@pytest.mark.parametrize("layout,chunk,pred,topk,cut", B3_CASES)
def test_plain_b3_matches_pallas(layout, chunk, pred, topk, cut):
    jt, tt, syms = _case(layout, seed=11 + len(layout), smooth=True)
    lanes, t = syms.shape
    if chunk is None:
        enc = jcoder.encode(jnp.asarray(syms), jt)
        buf, start = np.asarray(enc.buf), np.asarray(enc.start)
    else:
        ch = jcoder.encode_chunked(jnp.asarray(syms), jt, chunk)
        buf, start = np.asarray(ch.buf), np.asarray(ch.start)
    if cut:
        buf = buf[..., :-cut]
    cands = _cands(syms, 40, topk, seed=topk) if topk else None
    jp, tp = PREDICTORS[pred]
    ref = j_decode_lanes(jnp.asarray(buf), jnp.asarray(start), jt.freq,
                         jt.cdf, t_len=t, chunk_size=chunk, predictor=jp,
                         candidates=None if cands is None
                         else jnp.asarray(cands), lane_block=lanes)
    args = (_t(buf), _t(start), tt.freq, tt.cdf, t, chunk)
    kw = dict(predictor=tp, candidates=None if cands is None else _t(cands))
    got = rans_decode.rans_decode_lanes_plain(*args, **kw)
    for name, a, b in zip(("sym", "probes", "under"), got, ref):
        assert a.dtype == torch.int32
        _eq(a, b, name)
    assert (int(got[2].sum()) > 0) == bool(cut)
    wrapped = rans_decode.rans_decode_lanes(*args, **kw)
    for a, b in zip(wrapped, got):
        assert torch.equal(a, b)


def _poisons(cs):
    """The three hostile-after-validation slabs of the fuzz tier."""
    s = cs.slab.shape[0]
    return {
        "offset_past_end": cs._replace(
            offset=np.full_like(cs.offset, s + 1000)),
        "length_past_window": cs._replace(
            length=np.full_like(cs.length, cs.cap + 7)),
        "both_hostile": cs._replace(
            offset=np.full_like(cs.offset, s - 1),
            length=np.full_like(cs.length, cs.cap + 3)),
    }


@pytest.mark.parametrize("layout,chunk,pred,topk", [
    ("static", 16, "na48", 0), ("perpos", 9, "none", 2),
    ("lane", 16, "last", 3)])
def test_plain_b4_matches_pallas(layout, chunk, pred, topk):
    jt, tt, syms = _case(layout, seed=21, smooth=True)
    ch = jcoder.encode_chunked(jnp.asarray(syms), jt, chunk)
    blob = jbs.pack_chunked(*map(np.asarray, ch), chunk_size=chunk,
                            n_symbols=37)
    jcs, cs = jbs.parse_chunked(blob), bitstream.parse_chunked(blob)
    cands = _cands(syms, 40, topk, seed=3) if topk else None
    jp, tp = PREDICTORS[pred]
    jkw = dict(predictor=jp, lane_probes=True, chunk_probes=True,
               candidates=None if cands is None else jnp.asarray(cands))
    tkw = dict(predictor=tp, lane_probes=True, chunk_probes=True,
               candidates=None if cands is None else _t(cands))
    ref = jops.rans_decode_chunked(tbl=jt, from_container=jcs, **jkw)
    got = ops.rans_decode_chunked(tbl=tt, from_container=cs, **tkw)
    _eq(got[0], syms)
    for a, b in zip(got[2:], ref[2:]):
        _eq(a, b)
    dense = ops.rans_decode_chunked(
        bitstream.ChunkedLanes(*(_t(a) for a in ch[:3])), 37, tt, chunk,
        **tkw)
    for a, b in zip(dense[2:], got[2:]):
        assert torch.equal(a, b)
    for name, bad in _poisons(cs).items():
        jbad = jcs._replace(offset=bad.offset, length=bad.length)
        ref = jops.rans_decode_chunked(tbl=jt, from_container=jbad,
                                       exhausted_flags=True, **jkw)
        got = ops.rans_decode_chunked(tbl=tt, from_container=bad,
                                      exhausted_flags=True, **tkw)
        for a, b in zip(got[:1] + got[2:], ref[:1] + ref[2:]):
            _eq(a, b, name)
        # the raw under planes too, not only their > 0 flags
        (slab, base, wstart, wlen), cap = ops.slab_planes(bad, "cpu")
        plain = rans_decode.rans_decode_slab_plain(
            slab, base, wstart, wlen, tt.freq, tt.cdf, cap=cap, t_len=37,
            chunk_size=chunk, predictor=tp, candidates=tkw["candidates"])
        jraw = j_decode_slab(
            jnp.asarray(slab.numpy()), jnp.asarray(base.numpy()),
            jnp.asarray(wstart.numpy()), jnp.asarray(wlen.numpy()),
            jt.freq, jt.cdf, cap=cap, t_len=37, chunk_size=chunk,
            predictor=jp, candidates=jkw["candidates"], lane_block=4)
        for a, b in zip(plain, jraw):
            _eq(a, b, name)
    with pytest.raises(coder.StreamExhaustedError):
        ops.rans_decode_chunked(tbl=tt,
                                from_container=_poisons(cs)["offset_past_end"])


def test_ops_decode_degenerate_and_errors_match_reference():
    jt, tt, syms = _case("static", seed=2)
    enc, tenc = _encoded(jt, syms)
    got = ops.rans_decode(tenc, 0, tt, lane_probes=True, exhausted_flags=True)
    ref = jops.rans_decode(enc, 0, jt, lane_probes=True, exhausted_flags=True)
    for a, b in zip(got, ref):
        assert tuple(a.shape) == tuple(np.shape(b))
    for n in (37, 0):                  # the kernel wrapper's check, and ops'
        with pytest.raises(ValueError, match="implies"):
            ops.rans_decode_chunked(bitstream.ChunkedLanes(
                tenc.buf[None], tenc.start[None], tenc.length[None]), n, tt,
                10)
    with pytest.raises(ValueError, match="not both"):
        ops.rans_decode_chunked(bitstream.ChunkedLanes(
            tenc.buf[None], tenc.start[None], tenc.length[None]), 37, tt, 37,
            from_container=bitstream.parse_chunked(bitstream.pack(
                *tenc, n_symbols=37)))
    with pytest.raises(coder.StreamExhaustedError):
        ops.rans_decode(tenc, 40, tt)


# ---------------------------------------------------------------------------
# the v1 container and the size helpers
# ---------------------------------------------------------------------------

def test_v1_pack_unpack_match_reference():
    jt, tt, syms = _case("static", seed=40, k=32, lanes=5, t=30)
    enc = jcoder.encode(jnp.asarray(syms), jt)
    tenc = coder.encode(_t(syms), tt)
    blob = jbs.pack(*map(np.asarray, enc), n_symbols=30)
    assert bitstream.pack(*tenc, n_symbols=30) == blob
    buf, start, meta = bitstream.unpack(blob)
    jbuf, jstart, jmeta = jbs.unpack(blob)
    _eq(buf, jbuf)
    _eq(start, jstart)
    assert tuple(meta) == tuple(jmeta)
    v2 = jbs.pack_chunked(*map(np.asarray, jcoder.encode_chunked(
        jnp.asarray(syms), jt, 7)), chunk_size=7, n_symbols=30)
    for b in (blob, v2):
        got, ref = bitstream.unpack_chunked(b), jbs.unpack_chunked(b)
        _eq(got[0], ref[0])
        _eq(got[1], ref[1])
        assert tuple(got[2]) == tuple(ref[2])
    length = np.asarray(enc.length)
    assert bitstream.compressed_size(length) == jbs.compressed_size(length)
    assert bitstream.compressed_size(tenc.length) == len(blob)
    for crc in (True, False):
        assert (bitstream.compressed_size_chunked(length[None], crc)
                == jbs.compressed_size_chunked(length[None], crc))
    small = coder.encode(_t(syms), tt, cap=20)
    with pytest.raises(ValueError, match="overflowed"):
        bitstream.pack(*small, n_symbols=30)


def test_v1_unpack_errors_match_reference():
    jt, _, syms = _case("static", seed=41, k=16, lanes=3, t=20)
    blob = jbs.pack(*map(np.asarray, jcoder.encode(jnp.asarray(syms), jt)),
                    n_symbols=20)
    v2 = jbs.pack_chunked(*map(np.asarray, jcoder.encode_chunked(
        jnp.asarray(syms), jt, 8)), chunk_size=8, n_symbols=20)
    bad = [blob[:c] for c in (0, 3, 4, 10, 19, 20, 25, len(blob) - 1)]
    bad += [v2, b"XXXX" + blob[4:], blob[:4] + b"\x07" + blob[5:]]
    for b in bad:
        with pytest.raises(ValueError) as got:
            bitstream.unpack(b)
        with pytest.raises(ValueError) as ref:
            jbs.unpack(b)
        assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("name", ["v1_static", "v2_static_crc",
                                  "v2_perpos_nocrc", "v2_perlane_crc"])
def test_golden_corpus_decodes_on_the_port(name):
    from test_torch_gpu import CASES, case_tables
    case = CASES[name]
    tt, syms = case_tables(case)
    with open(os.path.join(GOLDEN, name + ".ras"), "rb") as fh:
        blob = fh.read()
    if case["fmt"] == "v1":
        buf, start, meta = bitstream.unpack(blob)
        enc = bitstream.EncodedLanes(_t(buf), _t(start), None)
        sym, _ = compress.histogram_decompress(enc, meta.n_symbols, tt,
                                               device="cpu")
        assert bitstream.pack(*coder.encode(_t(syms), tt),
                              n_symbols=case["t"]) == blob
    else:
        sym, _ = ops.rans_decode_chunked(
            tbl=tt, from_container=bitstream.parse_chunked(blob))
    _eq(sym, syms)


# ---------------------------------------------------------------------------
# data, the image path and Fig. 4(b)
# ---------------------------------------------------------------------------

def test_data_generators_match_reference():
    _eq(pipeline.image_rows(6, 50, seed=3), jpipe.image_rows(6, 50, seed=3))
    _eq(pipeline.synthetic_image(20, 36, seed=42),
        jpipe.synthetic_image(20, 36, seed=42))
    rows = pipeline.image_rows(4, 30, seed=1)
    _eq(pipeline.candidate_planes(rows, 256, 4, 0.7, seed=2),
        jpipe.candidate_planes(rows, 256, 4, 0.7, seed=2))


def test_histogram_path_matches_reference():
    img = pipeline.synthetic_image(32, 64, seed=42)
    rows = img.reshape(8, -1).astype(np.int64)
    jenc, jt = jcompress.histogram_compress(rows, 256)
    enc, tt = compress.histogram_compress(rows, 256, device="cpu")
    for a, b in zip(tt, jt):
        _eq(a.to(torch.int64) & 0xFFFFFFFF, np.asarray(b).astype(np.int64))
    blob = jbs.pack(*map(np.asarray, jenc), n_symbols=256)
    assert bitstream.pack(*enc, n_symbols=256) == blob
    assert bitstream.pack(*ops.rans_encode(_t(rows), tt),
                          n_symbols=256) == blob
    buf, start, _ = bitstream.unpack(blob)
    uenc = bitstream.EncodedLanes(_t(buf), _t(start), None)
    pj, pt = PREDICTORS["na48"]
    ref = jcompress.histogram_decompress(jenc, 256, jt, predictor=pj)
    for backend in ("kernel", "coder"):
        got = compress.histogram_decompress(uenc, 256, tt, predictor=pt,
                                            backend=backend,
                                            lane_probes=True, device="cpu")
        _eq(got[0], rows)
        assert float(got[1]) == pytest.approx(float(ref[1]), rel=1e-6)
    with pytest.raises(ValueError, match="backend"):
        compress.histogram_decompress(uenc, 256, tt, backend="nope",
                                      device="cpu")


def test_fig4b_probe_totals_match_reference():
    rows = pipeline.image_rows(16, 256, seed=0)
    counts = np.bincount(rows.ravel(), minlength=256)
    jt = jax.tree.map(jnp.asarray, jspc.tables_from_counts_np(counts))
    tt = spc.tables_from_counts_np(counts)
    enc = jcoder.encode(jnp.asarray(rows, jnp.int32), jt)
    tenc = bitstream.EncodedLanes(*(_t(a) for a in enc[:3]))
    totals = []
    for name in ("none", "na48", "na24"):
        jp, tp = PREDICTORS[name]
        _, _, jl = jcoder.decode(enc, 256, jt, predictor=jp,
                                 lane_probes=True)
        sym, _, tl = ops.rans_decode(tenc, 256, tt, predictor=tp,
                                     lane_probes=True)
        _eq(sym, rows)
        _eq(tl, jl, name)
        totals.append(int(tl.sum()))
    assert totals[0] > totals[1] > totals[2]


# ---------------------------------------------------------------------------
# the two-pass LM decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_model():
    return init_model(SMOKE, seed=0, device="cpu")


def test_lm_decompress_backends_agree(smoke_model):
    tokens = pipeline.token_stream(256, (4, 24), seed=7)
    outs = {}
    for backend in ("kernel", "coder"):
        st = compress.lm_compress(smoke_model, tokens, backend=backend,
                                  device="cpu")
        outs[backend] = bitstream.pack(*st.enc, n_symbols=24)
    assert outs["kernel"] == outs["coder"]
    assert float(st.bits_per_symbol) > 0
    probes = {}
    for backend in ("coder", "kernel", "two_pass"):
        sym, _, probes[backend] = compress.lm_decompress(
            smoke_model, st.enc, 24, backend=backend, lane_probes=True,
            device="cpu")
        _eq(sym, tokens)
    assert torch.equal(probes["coder"], probes["kernel"])
    assert torch.equal(probes["coder"], probes["two_pass"])
    with pytest.raises(ValueError, match="backend"):
        compress.lm_decompress(smoke_model, st.enc, 24, backend="nope",
                               device="cpu")


def test_lm_decompress_chunked_two_pass(smoke_model):
    tokens = pipeline.token_stream(256, (4, 40), seed=8)
    st = compress.lm_compress_chunked(smoke_model, tokens, 16,
                                      backend="kernel", device="cpu")
    cs = bitstream.parse_chunked(bitstream.pack_chunked(
        *st.chunks, chunk_size=16, n_symbols=40))
    probes = {}
    for backend in ("kernel", "coder", "two_pass"):
        sym, _, probes[backend] = compress.lm_decompress_chunked(
            smoke_model, cs, 40, 16, backend=backend, lane_probes=True,
            device="cpu")
        _eq(sym, tokens)
    sym, _, dense = compress.lm_decompress_chunked(
        smoke_model, st.chunks, 40, 16, backend="two_pass", lane_probes=True,
        device="cpu")
    _eq(sym, tokens)
    assert torch.equal(probes["kernel"], probes["two_pass"])
    assert torch.equal(probes["coder"], probes["two_pass"])
    assert torch.equal(dense, probes["two_pass"])
    length = st.chunks.length.clone()
    length[-1] -= 2
    short = bitstream.parse_chunked(bitstream.pack_chunked(
        st.chunks.buf, st.chunks.start, length, chunk_size=16,
        n_symbols=40))
    with pytest.raises(coder.StreamExhaustedError):
        compress.lm_decompress_chunked(smoke_model, short, 40, 16,
                                       backend="two_pass", device="cpu")


def test_two_pass_on_reference_planes_matches_reference():
    """JAX-made per-lane tables and candidate planes handed to both
    frameworks' ``ops.rans_decode_chunked``, dense and from the slab."""
    lanes, t, chunk = 4, 40, 16
    tokens = jpipe.token_stream(256, (lanes, t), seed=9)
    params = j_init_model(J_SMOKE, jax.random.PRNGKey(2))
    jt, _ = jcompress.collect_tables(params, J_SMOKE,
                                     jnp.asarray(tokens, jnp.int32))
    tt = spc.TableSet(*(_t(np.asarray(a).astype(np.int64)).to(torch.int32)
                        for a in jt))
    cands = _cands(tokens, 256, 4, seed=9)
    ch = jcoder.encode_chunked(jnp.asarray(tokens, jnp.int32), jt, chunk)
    blob = jbs.pack_chunked(*map(np.asarray, ch), chunk_size=chunk,
                            n_symbols=t)
    ref = jops.rans_decode_chunked(ch, t, jt, chunk,
                                   candidates=jnp.asarray(cands),
                                   lane_probes=True, chunk_probes=True)
    dense = ops.rans_decode_chunked(
        bitstream.ChunkedLanes(*(_t(a) for a in ch[:3])), t, tt, chunk,
        candidates=_t(cands), lane_probes=True, chunk_probes=True)
    slab = ops.rans_decode_chunked(
        tbl=tt, from_container=bitstream.parse_chunked(blob),
        candidates=_t(cands), lane_probes=True, chunk_probes=True)
    for got in (dense, slab):
        _eq(got[0], tokens)
        _eq(got[2], ref[2])
        _eq(got[3], ref[3])


# ---------------------------------------------------------------------------
# device defaults
# ---------------------------------------------------------------------------

def test_slab_and_histogram_entry_points_need_a_device_or_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    rows = pipeline.image_rows(2, 8, seed=0)
    enc, tt = compress.histogram_compress(rows, 256, device="cpu")
    cs = bitstream.parse_chunked(bitstream.pack(*enc, n_symbols=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        bitstream.slab_to_chunked(cs)
    with pytest.raises(RuntimeError, match="CUDA"):
        bitstream.chunk_encoded_from_slab(cs, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        compress.histogram_compress(rows, 256)
    with pytest.raises(RuntimeError, match="CUDA"):
        compress.histogram_decompress(enc, 8, tt)
    dense = bitstream.slab_to_chunked(cs, "cpu")
    _eq(dense.buf[0], bitstream.unpack(bitstream.pack(*enc,
                                                      n_symbols=8))[0])
