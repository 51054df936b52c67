"""The records reference encode (B5) and the scalar oracles against JAX
(CPU; the Pallas kernel in interpret mode).

* ``bitstream.compact_records`` equals ``repro.core.bitstream.
  compact_records`` on the same records, with a cap sweep down to
  ``cap < 4`` (overflow, header clipped), and compacts a chunk axis in one
  call.
* ``coder.encode_records`` equals JAX's and the port's ``coder.encode``.
* ``rans_encode_records_plain`` equals ``repro.kernels.rans_encode.
  rans_encode_records`` on all three planes (bytes, mask, states) for every
  table layout, a ragged chunk and ``t_block`` padding rows, also with
  symbols outside ``[0, K)`` (zero table entries, as the reference's
  one-hot gather reads them).
* ``golden`` and ``PyRans`` equal the JAX oracles by stream bytes, decoded
  symbols and ``search_steps``.
Integer outputs compare exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bitstream as jbitstream
from repro.core import coder as jcoder
from repro.core import golden as jgolden
from repro.core import python_baseline as jpython_baseline
from repro.core import spc as jspc
from repro.kernels.rans_encode import rans_encode_records as j_records
from repro_torch.core import bitstream, coder, golden, python_baseline, spc
from repro_torch.kernels import ops, rans_encode

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


def _t(a):
    return torch.as_tensor(np.array(a))


def _case(layout, seed, k=40, lanes=4, t=37):
    rng = np.random.default_rng(seed)
    shape = {"static": (), "perpos": (t,), "lane": (t, lanes)}[layout]
    probs = rng.dirichlet(np.full(k, 0.5), size=shape or None).astype(
        np.float32)
    syms = rng.integers(0, k, (lanes, t)).astype(np.int32)
    return (jspc.tables_from_probs(jnp.asarray(probs)),
            spc.tables_from_probs(_t(probs)), syms)


def _assert_lanes_equal(got, ref):
    for name, a, b in zip(("buf", "start", "length", "overflow"), got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


def _random_records(seed, t=29, lanes=5):
    """Arbitrary records: random bytes under a random mask (~60% emitted),
    so the compaction is tested apart from any encoder."""
    rng = np.random.default_rng(seed)
    byts = rng.integers(0, 256, (t, 2, lanes)).astype(np.uint8)
    mask = (rng.random((t, 2, lanes)) < 0.6).astype(np.uint8)
    states = rng.integers(1 << 23, 1 << 31, (lanes,)).astype(np.uint32)
    return byts, mask, states


@pytest.mark.parametrize("cap", [80, 45, 20, 5, 4, 3, 1])
def test_compact_records_matches_jax(cap):
    byts, mask, states = _random_records(seed=cap)
    ref = jbitstream.compact_records(jnp.asarray(byts), jnp.asarray(mask),
                                     jnp.asarray(states), cap)
    got = bitstream.compact_records(_t(byts), _t(mask),
                                    _t(states.astype(np.int64)), cap)
    _assert_lanes_equal(got, ref)
    # int32 bit patterns (the B5 kernel's states) give the same streams
    bits = bitstream.compact_records(_t(byts), _t(mask),
                                     _t(states.view(np.int32)), cap)
    _assert_lanes_equal(bits, ref)
    if cap < 4:
        assert got.overflow.all()


def test_compact_records_chunk_axis_matches_per_chunk():
    recs = [_random_records(seed=s) for s in (1, 2, 3)]
    byts, mask, states = (np.stack(x) for x in zip(*recs))
    for cap in (70, 30):
        got = bitstream.compact_records(_t(byts), _t(mask),
                                        _t(states.view(np.int32)), cap)
        for c in range(3):
            ref = jbitstream.compact_records(
                jnp.asarray(byts[c]), jnp.asarray(mask[c]),
                jnp.asarray(states[c]), cap)
            _assert_lanes_equal(coder.chunk_encoded(got, c), ref)


@pytest.mark.parametrize("layout", ["static", "perpos", "lane"])
def test_encode_records_matches_jax(layout):
    jt, tt, syms = _case(layout, seed=21)
    for cap in (None, 50, 3):
        ref = jcoder.encode_records(jnp.asarray(syms), jt, cap=cap)
        got = coder.encode_records(_t(syms), tt, cap=cap)
        _assert_lanes_equal(got, ref)
        for a, b in zip(got, coder.encode(_t(syms), tt, cap=cap)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["static", "perpos", "lane"])
@pytest.mark.parametrize("chunk,t_block", [(None, None), (13, None),
                                           (13, 5)])
def test_plain_records_match_pallas(layout, chunk, t_block):
    jt, tt, syms = _case(layout, seed=31)
    ref = j_records(jnp.asarray(syms), jt, chunk_size=chunk,
                    t_block=t_block)
    got = rans_encode.rans_encode_records_plain(_t(syms), tt, chunk,
                                                t_block)
    for name, a, b in zip(("bytes", "mask", "states"), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy().view(np.asarray(b).dtype),
                                      np.asarray(b), err_msg=name)
    # the wrapper runs the plain version on the CPU, and its compaction
    # equals the fused encode
    b, m, s = ops.rans_encode_records(_t(syms), tt, chunk, t_block)
    cap = coder.default_cap(chunk or syms.shape[1])
    fused = ops.rans_encode_chunked(_t(syms), tt, chunk or syms.shape[1],
                                    cap=cap)
    for x, y in zip(ops.compact_records(b, m, s, cap), fused):
        assert torch.equal(x, y)


@pytest.mark.parametrize("layout", ["static", "perpos", "lane"])
@pytest.mark.parametrize("chunk,t_block", [(None, None), (13, 5)])
def test_plain_records_out_of_range_symbols_match_pallas(layout, chunk,
                                                         t_block):
    jt, tt, syms = _case(layout, seed=33)
    rng = np.random.default_rng(34)
    bad = rng.random(syms.shape) < 0.125
    syms[bad] = rng.choice(np.array([-1, -2**31, 40, 41, 2**31 - 1]),
                           int(bad.sum()))
    ref = j_records(jnp.asarray(syms), jt, chunk_size=chunk,
                    t_block=t_block)
    got = rans_encode.rans_encode_records_plain(_t(syms), tt, chunk,
                                                t_block)
    for name, a, b in zip(("bytes", "mask", "states"), got, ref):
        np.testing.assert_array_equal(a.numpy().view(np.asarray(b).dtype),
                                      np.asarray(b), err_msg=name)
    # compacted, they are B1's streams on the same symbols
    cap = coder.default_cap(chunk or syms.shape[1])
    fused = rans_encode.rans_encode_lanes_plain(_t(syms), tt, cap, chunk)
    for x, y in zip(ops.compact_records(*got, cap), fused):
        assert torch.equal(x, y)


def test_records_reject_bad_layouts_and_empty_streams():
    _, tt, syms = _case("perpos", seed=5)
    with pytest.raises(ValueError, match="encoder tables"):
        rans_encode.rans_encode_records(_t(syms[:, :-1]), tt)
    with pytest.raises(ValueError, match="T > 0"):
        rans_encode.rans_encode_records(torch.zeros((4, 0),
                                                    dtype=torch.int32),
                                        spc.TableSet(*(a[0] for a in tt)))
    with pytest.raises(ValueError, match="chunk_size"):
        rans_encode.rans_encode_records(_t(syms), tt, chunk_size=0)


@pytest.mark.parametrize("layout", ["static", "perpos"])
def test_golden_matches_jax_oracle(layout):
    jt, tt, syms = _case(layout, seed=41, k=64, lanes=2, t=300)
    f, cdf = tt.freq.numpy(), tt.cdf.numpy()
    jf, jcdf = np.asarray(jt.freq), np.asarray(jt.cdf)
    for row in syms:
        if layout == "static":
            got = golden.encode(row, f, cdf)
            assert got == jgolden.encode(row, jf, jcdf)
            out = golden.decode(got, len(row), f, cdf)
            np.testing.assert_array_equal(
                out, jgolden.decode(got, len(row), jf, jcdf))
        else:
            got = golden.encode_per_position(row, f, cdf)
            assert got == jgolden.encode_per_position(row, jf, jcdf)
            out = golden.decode_per_position(got, f, cdf)
            np.testing.assert_array_equal(
                out, jgolden.decode_per_position(got, jf, jcdf))
        np.testing.assert_array_equal(out, row)
    # lane 0 of the multi-lane coder is the oracle's stream
    enc = coder.encode(_t(syms), tt)
    lane = enc.buf[0, int(enc.start[0]):int(enc.start[0] + enc.length[0])]
    want = (golden.encode(syms[0], f, cdf) if layout == "static"
            else golden.encode_per_position(syms[0], f, cdf))
    assert bytes(lane.numpy()) == want


def test_pyrans_matches_jax_baseline():
    jt, tt, syms = _case("static", seed=43, k=256, lanes=3, t=700)
    ours = python_baseline.PyRans(tt.freq.numpy(), tt.cdf.numpy())
    theirs = jpython_baseline.PyRans(np.asarray(jt.freq), np.asarray(jt.cdf))
    seq = [int(x) for x in syms.ravel()]
    blob = ours.encode(seq)
    assert blob == theirs.encode(seq)
    assert blob == golden.encode(seq, tt.freq.numpy(), tt.cdf.numpy())
    assert ours.decode(blob, len(seq)) == theirs.decode(blob, len(seq)) == seq
    assert ours.search_steps == theirs.search_steps > 0
