"""Port kernels' plain versions vs the JAX Pallas kernels (CPU, interpret).

* B1: ``rans_encode_lanes_plain`` equals ``repro.kernels.rans_encode.
  rans_encode_lanes`` byte for byte (buf, start, length, overflow) on every
  table layout, ragged chunks, and an overflow sweep down to ``cap < 4``.
* B2: ``rans_decode_step_plain`` stepped over a JAX-encoded stream equals
  ``repro.kernels.rans_decode.rans_decode_step`` on (s', ptr', symbol,
  probes, under) at every step, truncated stream included.
The ``gpu``-marked twins that hold each CUDA kernel against its plain
version on the card live in ``tests/test_torch_gpu.py``, which imports no
JAX (the GPU host has none).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import coder as jcoder
from repro.core import spc as jspc
from repro.kernels.rans_decode import rans_decode_step as j_decode_step
from repro.kernels.rans_encode import rans_encode_lanes as j_encode_lanes
from repro_torch.core import coder, spc
from repro_torch.kernels import ops, rans_decode, rans_encode

jax.config.update("jax_platforms", "cpu")


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


def _assert_planes_equal(got, ref):
    for name, a, b in zip(("buf", "start", "length", "overflow"), got, ref):
        np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(b),
                                      err_msg=name)


@pytest.mark.parametrize("layout", ["static", "perpos", "lane"])
def test_plain_encode_matches_pallas(layout):
    jt, tt, syms = _case(layout, seed=4)
    for chunk, cap in ((10, 28), (37, 82), (16, 12)):
        ref = j_encode_lanes(jnp.asarray(syms), jt, cap=cap, chunk_size=chunk)
        got = rans_encode.rans_encode_lanes_plain(_t(syms), tt, cap, chunk)
        _assert_planes_equal(got, ref)


def test_plain_encode_overflow_sweep_matches_pallas():
    jt, tt, syms = _case("lane", seed=6, t=24)
    for cap in (1, 2, 3, 5, 9, 17, 40):
        ref = j_encode_lanes(jnp.asarray(syms), jt, cap=cap, chunk_size=11)
        got = rans_encode.rans_encode_lanes_plain(_t(syms), tt, cap, 11)
        _assert_planes_equal(got, ref)
        if cap < 4:
            assert got[3].all()
    assert not got[3].any()


def test_ops_encode_matches_coder_and_header_only():
    _, tt, syms = _case("perpos", seed=7)
    for chunk in (9, 37):
        got = ops.rans_encode_chunked(_t(syms), tt, chunk)
        ref = coder.encode_chunked(_t(syms), tt, chunk)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    mono = ops.rans_encode(_t(syms), tt)
    ref = coder.encode(_t(syms), tt)
    for a, b in zip(mono, ref):
        assert torch.equal(a, b)
    for cap in (2, 8):
        empty = torch.zeros((3, 0), dtype=torch.int32)
        got = ops.rans_encode(empty, tt, cap=cap)
        ref = coder.encode(empty, tt, cap=cap)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def _step_both(enc, syms_tables, n_steps, cands, per_lane):
    """Step the JAX Pallas kernel and the plain version side by side."""
    jt, tt = syms_tables
    buf = np.asarray(enc.buf)
    dec = jcoder.decoder_init(enc)
    js, jp = dec.s, dec.ptr
    ts = _t(np.asarray(dec.s).astype(np.int64)).to(torch.int32)
    tp = _t(np.asarray(dec.ptr))
    tbuf = _t(buf)
    total_under = 0
    for i in range(n_steps):
        row = min(i, jt.freq.shape[0] - 1)
        jf, jc = (jt.freq[row], jt.cdf[row]) if per_lane else (jt.freq,
                                                               jt.cdf)
        tf, tc = (tt.freq[row], tt.cdf[row]) if per_lane else (tt.freq,
                                                               tt.cdf)
        cand = cands[row] if cands is not None else None
        js, jp, jx, jpr, ju = j_decode_step(
            jnp.asarray(buf.T), js, jp, jf, jc,
            candidates=None if cand is None else jnp.asarray(cand))
        ts, tp, tx, tpr, tu = rans_decode.rans_decode_step_plain(
            tbuf, ts, tp, tf, tc, candidates=None if cand is None
            else _t(cand))
        np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                      np.asarray(js))
        for a, b in ((tp, jp), (tx, jx), (tpr, jpr), (tu, ju)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        total_under += int(tu.sum())
    return total_under


@pytest.mark.parametrize("layout,topk", [("static", 0), ("lane", 4)])
def test_plain_decode_step_matches_pallas(layout, topk):
    jt, tt, syms = _case(layout, seed=12, t=12)
    lanes, t = syms.shape
    enc = jcoder.encode(jnp.asarray(syms), jt)
    cands = None
    if topk:
        cands = np.random.default_rng(3).integers(-1, 42, (t, lanes, topk))
        cands[::2, :, 2] = syms.T[::2]
    assert _step_both(enc, (jt, tt), t, cands, layout == "lane") == 0


def test_plain_decode_step_truncated_stream_matches_pallas():
    jt, tt, syms = _case("lane", seed=14, t=12)
    enc = jcoder.encode(jnp.asarray(syms), jt)
    cut = 4     # drop the stream's last bytes: later refills read past cap
    trunc = jcoder.EncodedLanes(buf=enc.buf[:, :-cut], start=enc.start,
                                length=enc.length - cut)
    under = _step_both(trunc, (jt, tt), syms.shape[1] + 2, None, True)
    assert under > 0
