"""Port integer codec core vs the JAX reference (CPU).

The same numpy-seeded inputs go through ``repro.core`` and
``repro_torch.core``; every integer output must be identical: SPC
frequencies and Barrett planes (tie patterns, delta > 0, delta < 0,
delta > K), ``umulhi32``/``encode_step``, ``find_symbol`` symbols and
probe counts, coder streams, v2 container bytes, and the container
parser's named errors in the same order.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _prop import floats, ints, sweep
from repro.core import bitstream as jbs
from repro.core import coder as jcoder
from repro.core import search as jsearch
from repro.core import spc as jspc
from repro.core import update as jupdate
from repro_torch.core import bitstream, coder, constants as C, search, spc
from repro_torch.core import u32, update

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


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _u32(x) -> np.ndarray:
    """Port int32 bit patterns / JAX uint32 -> numpy uint32 for comparison."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x).astype(np.int64).astype(np.uint32)


def _prob_cases():
    rng = np.random.default_rng(23)
    cases = [np.full(256, 1.0 / 256), np.full(3, 1 / 3),
             np.r_[1.0, np.zeros(255)],
             np.r_[np.full(200, 1e-9), rng.dirichlet(np.ones(56))],
             np.full(1 << C.PROB_BITS, 1.0 / (1 << C.PROB_BITS))]
    # random concentrations, batched as rows of a few widths so that the
    # reference compiles once per width
    rows = {k: [] for k in (2, 57, 400)}
    for r in sweep(104, 24):
        k = list(rows)[int(ints(r, 0, len(rows) - 1))]
        conc = float(floats(r, 0.02, 8.0))
        rows[k].append(r.dirichlet(np.full(k, conc)))
    cases += [np.stack(v) for v in rows.values() if v]
    cases.append(rng.dirichlet(np.ones(64), size=(3, 5)))      # 3-d batch
    # unnormalized mass: delta > K (0.9 total) and delta < 0 (1.2 total)
    cases.append(0.9 * rng.dirichlet(np.ones(256), size=4))
    cases.append(1.2 * rng.dirichlet(np.full(256, 0.3), size=4))
    cases.append(np.r_[np.nan, np.inf, -1.0, rng.dirichlet(np.ones(29))])
    return [np.asarray(p, np.float32) for p in cases]


def test_quantize_probs_matches_reference():
    deltas = []
    for p in _prob_cases():
        ref = np.asarray(jspc.quantize_probs(jnp.asarray(p)))
        got = spc.quantize_probs(_t(p)).numpy()
        np.testing.assert_array_equal(_u32(got), ref)
        f0 = np.maximum(1, np.round(
            np.asarray(jnp.asarray(p).astype(jnp.bfloat16).astype(
                jnp.float32)) * (1 << C.PROB_BITS)))
        deltas.append(((1 << C.PROB_BITS) - np.nan_to_num(f0).sum(-1)).ravel())
    deltas = np.concatenate(deltas)
    assert (deltas > 0).any() and (deltas < 0).any() and (deltas > 256).any()


def test_tables_match_reference():
    rng = np.random.default_rng(5)
    probs = rng.dirichlet(np.full(64, 0.4), size=(6, 3)).astype(np.float32)
    ref = jspc.tables_from_probs(jspc.store_bf16(jnp.asarray(probs)))
    got = spc.tables_from_probs(spc.store_bf16(_t(probs)))
    for name, a, b in zip(spc.TableSet._fields, got, ref):
        np.testing.assert_array_equal(_u32(a), np.asarray(b), err_msg=name)
    f, cdf = spc.freq_cdf_from_probs(_t(probs))
    np.testing.assert_array_equal(f.numpy(), got.freq.numpy())
    np.testing.assert_array_equal(cdf.numpy(), got.cdf.numpy())


def test_barrett_planes_match_reference_edges():
    n = C.PROB_BITS
    k = 256
    rng = np.random.default_rng(9)
    freq = np.r_[1, 2, 3, 1 << (n - 1), (1 << n) - k + 1,
                 rng.integers(1, (1 << n) - k + 1, 200)].astype(np.uint32)
    start = rng.integers(0, (1 << n) - 1, freq.size).astype(np.uint32)
    ref = jspc.barrett_planes(jnp.asarray(freq), jnp.asarray(start), n)
    got = spc.barrett_planes(_t(freq.astype(np.int64)),
                             _t(start.astype(np.int64)), n)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_u32(a), np.asarray(b))


def test_umulhi32_and_encode_step_match_reference():
    rng = np.random.default_rng(11)
    a = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jupdate.umulhi32(jnp.asarray(a), jnp.asarray(b)))
    got = update.umulhi32(_t(a.astype(np.int64)), _t(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)

    # per-lane rows: the f == 2**n - K + 1 extreme (every other symbol at
    # f == 1) and random rows with f == 1 entries
    n, k, lanes = C.PROB_BITS, 256, 512
    freq = np.ones((lanes, k), np.int64)
    freq[: lanes // 2, 0] = (1 << n) - k + 1
    rand = rng.integers(1, 120, (lanes // 2, k))
    rand[:, :8] = 1
    rand[:, -1] += (1 << n) - rand.sum(-1)
    freq[lanes // 2:] = rand
    assert freq.min() >= 1 and (freq.sum(-1) == 1 << n).all()
    jt = jspc.build_tables(jnp.asarray(freq, jnp.uint32))
    tt = spc.build_tables(_t(freq))
    s = rng.integers(C.RANS_L, 1 << 31, lanes, dtype=np.int64)
    x = rng.integers(0, k, lanes)
    x[: lanes // 4] = 0
    x[lanes // 2: lanes // 2 + 64] = rng.integers(0, 8, 64)
    js, jrecs = jupdate.encode_step(
        jnp.asarray(s, jnp.uint32),
        jupdate.gather_encode_entry(jt, jnp.asarray(x, jnp.int32)))
    ts, trecs = update.encode_step(
        _t(s), update.gather_encode_entry(tt, _t(x)))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                  np.asarray(js))
    for (jb, jc), (tb, tc) in zip(jrecs, trecs):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tb.numpy().astype(np.uint8),
                                      np.asarray(jb))


@pytest.mark.parametrize("topk", [0, 4])
@pytest.mark.parametrize("per_lane", [False, True])
def test_find_symbol_matches_reference(topk, per_lane):
    rng = np.random.default_rng(13 + topk + per_lane)
    lanes, k = 64, 48
    shape = (lanes, k) if per_lane else (k,)
    probs = rng.dirichlet(np.full(k, 0.3), size=shape[:-1] or None)
    tbl = jspc.tables_from_probs(jnp.asarray(probs, jnp.float32))
    cdf = np.asarray(tbl.cdf)
    slot = rng.integers(0, 1 << C.PROB_BITS, lanes)
    cands = rng.integers(-2, k + 2, (lanes, topk)).astype(np.int32)
    if topk:     # make some lanes hit on their first or a later candidate
        cands[::3, 1] = np.asarray(jnp.searchsorted(
            jnp.asarray(cdf if not per_lane else cdf[0]),
            jnp.asarray(slot[::3]), side="right")) - 1
    jx, jp = jsearch.find_symbol(jnp.asarray(cdf), k,
                                 jnp.asarray(slot, jnp.uint32),
                                 candidates=jnp.asarray(cands))
    tx, tp = search.find_symbol(_t(cdf.astype(np.int64)).to(torch.int32), k,
                                _t(slot), candidates=_t(cands))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def _layout_case(layout, seed=3, k=40, lanes=4, t=37):
    rng = np.random.default_rng(seed)
    shape = {"static": (), "perpos": (t,), "lane": (t, lanes)}[layout]
    probs = rng.dirichlet(np.full(k, 0.5), size=shape or None).astype(
        np.float32)
    syms = rng.integers(0, k, (lanes, t)).astype(np.int32)
    return probs, syms


@pytest.mark.parametrize("layout", ["static", "perpos", "lane"])
def test_coder_encode_chunked_matches_reference(layout):
    probs, syms = _layout_case(layout)
    jt = jspc.tables_from_probs(jnp.asarray(probs))
    tt = spc.tables_from_probs(_t(probs))
    for chunk in (10, 37):
        ref = jcoder.encode_chunked(jnp.asarray(syms), jt, chunk)
        got = coder.encode_chunked(_t(syms), tt, chunk)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_coder_overflow_matches_reference():
    probs, syms = _layout_case("lane", seed=8)
    jt = jspc.tables_from_probs(jnp.asarray(probs))
    tt = spc.tables_from_probs(_t(probs))
    for cap in (1, 3, 6, 20):
        ref = jcoder.encode(jnp.asarray(syms), jt, cap=cap)
        got = coder.encode(_t(syms), tt, cap=cap)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_decode_get_matches_reference_over_stream():
    probs, syms = _layout_case("lane", seed=21)
    lanes, t = syms.shape
    jt = jspc.tables_from_probs(jnp.asarray(probs))
    tt = spc.tables_from_probs(_t(probs))
    enc = jcoder.encode(jnp.asarray(syms), jt)
    tenc = bitstream.EncodedLanes(*(_t(a) for a in enc[:3]))
    jst, tst = jcoder.decoder_init(enc), coder.decoder_init(tenc)
    cands = np.random.default_rng(1).integers(0, 40, (t, lanes, 4))
    cands[:, :, 0] = syms.T
    for i in range(t + 2):       # two steps past the end: underflow flags
        jrow = jspc.TableSet(*(a[min(i, t - 1)] for a in jt))
        trow = spc.TableSet(*(a[min(i, t - 1)] for a in tt))
        cj = jnp.asarray(cands[min(i, t - 1)], jnp.int32)
        jst, jx, jp = jcoder.decode_get(jst, enc.buf, jrow, candidates=cj)
        tst, tx, tp = coder.decode_get(tst, tenc.buf, trow,
                                       candidates=_t(cands[min(i, t - 1)]))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tst.s.numpy().astype(np.uint32),
                                      np.asarray(jst.s))
        np.testing.assert_array_equal(tst.ptr.numpy(), np.asarray(jst.ptr))
        np.testing.assert_array_equal(tst.underflow.numpy(),
                                      np.asarray(jst.underflow))
    assert tst.underflow.all()
    with pytest.raises(coder.StreamExhaustedError):
        coder._check_exhausted(tst.underflow)


@pytest.mark.parametrize("checksums", [True, False])
def test_pack_chunked_matches_reference(checksums):
    probs, syms = _layout_case("perpos", seed=30)
    jt = jspc.tables_from_probs(jnp.asarray(probs))
    ch = jcoder.encode_chunked(jnp.asarray(syms), jt, 10)
    kw = dict(chunk_size=10, n_symbols=syms.shape[1], checksums=checksums)
    ref = jbs.pack_chunked(*map(np.asarray, ch), **kw)
    got = bitstream.pack_chunked(*(_t(a) for a in ch), **kw)
    assert got == ref


@pytest.mark.parametrize("name", ["v2_static_crc", "v2_perpos_nocrc",
                                  "v2_perlane_crc"])
def test_golden_v2_parse_and_repack_identical(name):
    with open(os.path.join(GOLDEN, name + ".ras"), "rb") as fh:
        blob = fh.read()
    cs = bitstream.parse_chunked(blob)
    ref = jbs.parse_chunked(blob)
    np.testing.assert_array_equal(cs.offset, ref.offset)
    np.testing.assert_array_equal(cs.length, ref.length)
    assert cs.meta == tuple(ref.meta) and cs.cap == ref.cap
    dense = bitstream.slab_to_chunked(cs, "cpu")
    jdense = jbs.slab_to_chunked(ref)
    for a, b in zip(dense[:3], jdense[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    crc = bool(blob[6] & bitstream.FLAG_CHUNK_CRC32)
    again = bitstream.pack_chunked(
        *dense[:3], chunk_size=cs.meta.chunk_size,
        n_symbols=cs.meta.n_symbols, prob_bits=cs.meta.prob_bits,
        checksums=crc)
    assert again == blob


def _parse_outcome(parse, blob):
    try:
        cs = parse(blob)
    except ValueError as e:
        return ("error", str(e))
    return ("ok", cs.offset.tolist(), cs.length.tolist(), cs.cap,
            tuple(cs.meta), bytes(cs.slab))


def test_parse_errors_match_reference_on_corrupt_blobs():
    """Truncations, byte flips, wrapped offsets, inflated lengths and
    tampered CRCs: same outcome and same named error text as the
    reference parser."""
    rng = np.random.default_rng(90)
    k, lanes, t, chunk = 32, 4, 48, 13
    jt = jspc.tables_from_probs(
        jnp.asarray(rng.dirichlet(np.full(k, 0.5)), jnp.float32))
    syms = jnp.asarray(rng.integers(0, k, (lanes, t)), jnp.int32)
    ch = jcoder.encode_chunked(syms, jt, chunk)
    enc = jcoder.encode(syms, jt)
    blobs = [jbs.pack_chunked(*map(np.asarray, ch), chunk_size=chunk,
                              n_symbols=t, checksums=c) for c in (True, False)]
    blobs.append(jbs.pack(*map(np.asarray, enc), n_symbols=t))
    mutated = []
    for blob in blobs:
        cuts = {0, 1, 3, 4, 7, 23, 24, 30, len(blob) - 1}
        cuts |= {int(ints(r, 0, len(blob) - 1)) for r in sweep(91, 20)}
        mutated += [blob[:c] for c in sorted(cuts)]
        for r in sweep(92, 40):
            mut = bytearray(blob)
            mut[int(ints(r, 0, len(blob) - 1))] ^= 1 << int(ints(r, 0, 7))
            mutated.append(bytes(mut))
    nocrc = blobs[1]
    hdr, rec = jbs._HEADER_V2.size, jbs._INDEX_V2_DT.itemsize
    for cell in (0, 2):
        mut = bytearray(nocrc)
        mut[hdr + cell * rec + 7] ^= 0x80              # offset wraps
        mutated.append(bytes(mut))
        mut = bytearray(nocrc)
        mut[hdr + cell * rec + 8:hdr + cell * rec + 12] = \
            (0xFFFFFFF0).to_bytes(4, "little")         # inflated length
        mutated.append(bytes(mut))
    crc_rec = jbs._INDEX_V2C_DT.itemsize
    mut = bytearray(blobs[0])
    mut[hdr + 5 * crc_rec + 12] ^= 0x5A                # wrong CRC cell
    mutated.append(bytes(mut))
    mutated.append(b"XXXX" + blobs[0][4:])
    kinds = set()
    for blob in blobs + mutated:
        got = _parse_outcome(bitstream.parse_chunked, blob)
        ref = _parse_outcome(jbs.parse_chunked, blob)
        assert got == ref
        kinds.add(got[1].split(":")[0].split(" at ")[0] if got[0] == "error"
                  else "ok")
    assert len(kinds) >= 5, kinds


def test_u32_bits_round_trip():
    v = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, C.U32_MASK])
    assert torch.equal(u32.value(u32.bits(v)), v)
    assert u32.bits(v).dtype == torch.int32
