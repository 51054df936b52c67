"""CUDA kernel tier: each kernel against its plain PyTorch version.

Marked ``gpu``; every test skips without a CUDA device.  The file imports
no JAX, so it runs on a GPU host without the reference package's
dependencies (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_gpu.py

B1 (encode), B2 (decode step), B3 (full-stream decode), B4 (slab
decode), B5 (records encode) and B6 (SPC quantizer, also with its CDF
output) are held against their plain versions on every table layout and
predictor, with candidates, truncated streams, poisoned slabs, ragged
chunks, ``t_block`` padding, SPC tie patterns and waterfill rows, B1 and B5
at chunk lengths around their gather lead, K from 2 to 4096, caps below
the header and symbols outside ``[0, K)``, B2 on ``(freq, cdf)`` pairs
whose freq is not the cdf's differences, B2 and
B3/B4 with the code path each launch ran; the kernel-backed LM path runs
its SPC through B6 and never the sort-based plain version on the card; B5 plus ``compact_records`` equals B1, overflow
included; the frozen corpus ``tests/golden_vectors/*.ras`` decodes on the
card and re-packs through B5 byte for byte; ``build_tables`` on the card
equals the CPU's for every frequency; each call launches its kernel
exactly once.  The batching engine's path: ``ops.rans_decode_step_rows``
through B2 equals the coder pop; the engine's slots keep the
single-request state bitwise and ``prefill_chunk`` is the step path
bitwise on the card; a small mixed engine workload is byte-identical to
the single-request kernel path with its B1, B2 and B6 launches counted and
no host sync inside a cycle.  Training and bits-back: B2 at the stack's
shapes (per-lane K = 16 and K = 256 rows and a shared row, 512 lanes, no
candidates, popping past the stream end) and B6 on rows of 16 against
their plain versions; one train step on the card against the same step on
the CPU; a small ``bb_encode``/``bb_decode`` round trip on the card whose
kernel and coder stacks are byte-identical, with one B2 launch per pop.
The recurrent families: B6's cluster layout (16,384 < K <= 65,536) on
Dirichlet, near-uniform, tied and waterfill rows in BF16 and float32, on
1, 16 and 4,096 rows, with and without the CDF, each launch on its
plan's cluster; B2's read-ahead bisection at K = 32,064, 32,768 and
50,280 on per-lane, shared, zero-frequency and mismatched rows over 1, 16
and 128 lanes, each launch on the path its plan names; the mamba2-130m
(smoke and full width) and recurrentgemma-2b (smoke) decode steps in
float32 on the card against the CPU.  The MoE family: B6 and B2 also at mixtral-8x22b's K = 32,768; both
MoE SMOKE models round-trip on the card (kernel and coder containers
byte-identical, one B2 and one B6 launch per decoded position), their
steps match the CPU's and their prefill is their steps bitwise.
Training of the zoo: ``ssd_chunked`` and ``rglru_forward`` (values and
gradients) on the card against the CPU, and a train step of the
mamba2-130m, recurrentgemma-2b and mixtral-8x22b SMOKE models on the
card against the CPU's under deterministic algorithms (loss, every
gradient, the step's metrics).  The dense zoo:
the four SMOKE models (QKV bias, QK norm, blockwise attention) round-trip
through the kernel backend (B6, B1, B2) byte-identical to the coder
backend.  The decode's first-index top-k on the card equals the CPU's on
built ties.  B6 and B2 also at phi3.5-moe's K = 32,064.  Cross attention
and the encoder-decoder: the llama-3.2-vision-11b and
seamless-m4t-large-v2 SMOKE models in float32 on the card against the
CPU (the encoder's memory, a forward, decode steps with memory,
``generate`` and a train step).  Checkpoints: a train state on the card
through ``train.checkpoint`` and back bitwise (float32 and bfloat16), a
non-blocking save holding the values of its call, and the
``RestartManager`` recovering from an injected fault bitwise equal to an
unbroken run.  Placement, on a world-1 NCCL group over a ``FileStore``:
the chunk mesh's encode and decode against the single-device kernels (one
B1 and one B3 per slab and per tail), the two-rank chunk emulation
(``encode_slab``/``decode_slab`` in turn, stitched), the card's int8
cross-pod reduce against a gloo CPU group's, and ``ras-pimc`` SMOKE on a
lane mesh and a chunk mesh.  The production mesh: ``make_mesh_for(1)``
on that group is a (1, 1) ``DeviceMesh``, and ``shard_params``/``unshard``
of the ``ras-pimc`` ``CONFIG`` parameters round-trip bitwise on the card.
"""

import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (bitstream, coder, constants, predictors, spc,
                              u32)
from repro_torch.core.bitstream import EncodedLanes
from repro_torch.data.pipeline import candidate_planes, token_stream
from repro_torch.device import configure_cuda_numerics
from repro_torch.kernels import (LAUNCHES, autotune, ops, rans_decode,
                                 rans_encode, spc_quantize)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_vectors")

# the frozen corpus's cases, as ``tests/golden_vectors/generate.py`` lists
# them (that script imports JAX)
CASES = {c["name"]: c for c in [
    dict(name="v1_static", fmt="v1", seed=41, k=64, lanes=4, t=64,
         tables="static"),
    dict(name="v2_static_crc", fmt="v2", seed=42, k=64, lanes=4, t=64,
         chunk_size=20, checksums=True, tables="static"),
    dict(name="v2_perpos_nocrc", fmt="v2", seed=43, k=32, lanes=4, t=48,
         chunk_size=16, checksums=False, tables="perpos"),
    dict(name="v2_perlane_crc", fmt="v2", seed=44, k=16, lanes=4, t=32,
         chunk_size=13, checksums=True, tables="perlane"),
]}


def case_tables(case):
    """A corpus case's TableSet and symbols, rebuilt from its seed with the
    port's own SPC (the same draws as ``generate.build_case``)."""
    rng = np.random.default_rng(case["seed"])
    k, lanes, t = case["k"], case["lanes"], case["t"]
    size = {"static": None, "perpos": t, "perlane": (t, lanes)}[
        case["tables"]]
    probs = rng.dirichlet(np.full(k, 0.5), size=size)
    tbl = spc.tables_from_probs(torch.as_tensor(probs.astype(np.float32)))
    syms = rng.integers(0, k, (lanes, t)).astype(np.int32)
    return tbl, syms


def _t(a):
    return torch.as_tensor(np.array(a))


def _case(layout, seed, k, lanes, t, prob_bits=14):
    rng = np.random.default_rng(seed)
    shape = {"static": (), "perpos": (t,), "lane": (t, lanes)}[layout]
    probs = rng.dirichlet(np.full(k, 0.5), size=shape or None).astype(
        np.float32)
    syms = rng.integers(0, k, (lanes, t)).astype(np.int32)
    return spc.tables_from_probs(_t(probs), prob_bits), syms


def _assert_planes_equal(got, ref):
    for name, a, b in zip(("buf", "start", "length", "overflow"), got, ref):
        assert torch.equal(a.cpu(), b.cpu()), name


# ---------------------------------------------------------------------------
# gpu tier: each CUDA kernel against its plain version on the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel tier)")
    configure_cuda_numerics()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["static", "perpos", "lane"])
def test_gpu_encode_kernel_matches_plain(layout):
    dev = _cuda()
    tt, syms = _case(layout, seed=4, k=256, lanes=128, t=300)
    for chunk, cap in ((128, 264), (300, 608), (64, 40)):
        ref = rans_encode.rans_encode_lanes_plain(_t(syms), tt, cap, chunk)
        before = LAUNCHES["rans_encode_lanes"]
        got = rans_encode.rans_encode_lanes(
            _t(syms).to(dev), spc.TableSet(*(a.to(dev) for a in tt)), cap,
            chunk)
        torch.cuda.synchronize()
        assert LAUNCHES["rans_encode_lanes"] == before + 1
        _assert_planes_equal(got, ref)


def _out_of_range(syms, k, seed, share=0.05):
    """``syms`` with about ``share`` of them replaced by ids outside
    ``[0, k)`` (negative, k and far above, the int32 extremes)."""
    rng = np.random.default_rng(seed)
    out = syms.copy()
    bad = rng.random(out.shape) < share
    out[bad] = rng.choice(np.array([-1, -2**31, k, k + 1000, 2**31 - 1]),
                          int(bad.sum()))
    return out


def _encode_both_match(tt, syms, chunk, dev):
    """B1 at caps default, 1, 3, 4 and a third of the default, and B5 at
    t_block None and 7, each one launch, against their plain versions."""
    gt, gs = _on(tt, dev), _t(syms).to(dev)
    cap = coder.default_cap(min(chunk, syms.shape[1]))
    for c in (cap, 1, 3, 4, cap // 3):
        ref = rans_encode.rans_encode_lanes_plain(_t(syms), tt, c, chunk)
        got = _launched("rans_encode_lanes", lambda: (
            rans_encode.rans_encode_lanes(gs, gt, c, chunk)))
        _assert_same(got, ref)
    for t_block in (None, 7):
        ref = rans_encode.rans_encode_records_plain(_t(syms), tt, chunk,
                                                    t_block)
        got = _launched("rans_encode_records", lambda: (
            rans_encode.rans_encode_records(gs, gt, chunk, t_block)))
        _assert_same(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1, 7, 8, 9, 33, 47, 48, 49, 256])
@pytest.mark.parametrize("layout", ["static", "perpos", "lane"])
def test_gpu_encode_chunk_edges_match_plain(layout, chunk):
    """B1 and B5 at chunk lengths 1, around a batch (8 steps), a symbol tile
    (32) and the kernels' lookup lead (48 steps), and 256, with ragged
    tails at T = 300, on 40 lanes (ten warps of 4 lanes), with out-of-range
    symbols."""
    dev = _cuda()
    tt, syms = _case(layout, seed=chunk, k=256, lanes=40, t=300)
    _encode_both_match(tt, _out_of_range(syms, 256, seed=chunk), chunk, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 2048, 2049, 4096])
@pytest.mark.parametrize("layout", ["static", "perpos", "lane"])
def test_gpu_encode_alphabet_edges_match_plain(layout, k):
    """B1 and B5 at K = 2, at and above the static table's shared-memory
    limit (2,048) and at 4,096, with out-of-range symbols."""
    dev = _cuda()
    tt, syms = _case(layout, seed=k, k=k, lanes=40, t=120)
    _encode_both_match(tt, _out_of_range(syms, k, seed=k), 40, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("topk", [0, 4])
@pytest.mark.parametrize("k", [256, 4096])
@pytest.mark.parametrize("rows", ["shared", "lane"])
def test_gpu_decode_step_mismatched_pair_matches_plain(rows, k, topk):
    """B2 on (freq, cdf) pairs whose freq is not the cdf's differences: f
    comes from the freq row on every path (registers at K = 256, the
    read-ahead bisection at K = 4096), as in the plain version."""
    dev = _cuda()
    lanes, t = 64, 8
    tt, syms = _case("perpos" if rows == "shared" else "lane", seed=k + 1,
                     k=k, lanes=lanes, t=t)
    enc = coder.encode(_t(syms), tt)
    dec = coder.decoder_init(enc)
    s, ptr = u32.bits(dec.s), dec.ptr.to(torch.int32)
    bump = torch.randint(0, 3, tt.freq.shape, dtype=torch.int32,
                         generator=torch.Generator().manual_seed(k))
    cands = (torch.as_tensor(candidate_planes(syms, k, topk, 0.5, seed=k))
             if topk else None)
    for i in range(t):
        bent = (tt.freq[i] + bump[i]).contiguous()
        _step_pair(enc.buf, s, ptr, bent, tt.cdf[i],
                   None if cands is None else cands[i], dev)
        assert rans_decode.last_branches("rans_decode_step") == \
            autotune.decode_step_plan(k, lanes).branches()
        ref = _step_pair(enc.buf, s, ptr, tt.freq[i], tt.cdf[i],
                         None if cands is None else cands[i], dev)
        s, ptr = ref[0], ref[1]


@pytest.mark.gpu
def test_gpu_decode_step_kernel_matches_plain():
    dev = _cuda()
    tt, syms = _case("lane", seed=5, k=256, lanes=128, t=64)
    enc = coder.encode(_t(syms), tt)
    buf = enc.buf[:, :-3].contiguous()          # truncated: under > 0
    dec = coder.decoder_init(EncodedLanes(buf, enc.start, enc.length - 3))
    s = u32.bits(dec.s)
    ptr = dec.ptr.to(torch.int32)
    cands = torch.randint(0, 256, (syms.shape[1], 128, 4),
                          generator=torch.Generator().manual_seed(0),
                          dtype=torch.int32)
    cands[:, :, 1] = _t(syms.T)
    gs, gp = s.to(dev), ptr.to(dev)
    under = 0
    for i in range(syms.shape[1] + 2):
        row = min(i, syms.shape[1] - 1)
        ref = rans_decode.rans_decode_step_plain(
            buf, s, ptr, tt.freq[row], tt.cdf[row], candidates=cands[row])
        got = rans_decode.rans_decode_step(
            buf.to(dev), gs, gp, tt.freq[row].to(dev), tt.cdf[row].to(dev),
            candidates=cands[row].to(dev))
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b)
        s, ptr, gs, gp = ref[0], ref[1], got[0], got[1]
        under += int(ref[4].sum())
    assert under > 0


@pytest.mark.gpu
def test_gpu_decode_step_shared_rows_without_candidates():
    dev = _cuda()
    tt, syms = _case("static", seed=6, k=256, lanes=128, t=48)
    enc = coder.encode(_t(syms), tt)
    dec = coder.decoder_init(enc)
    s, ptr = u32.bits(dec.s), dec.ptr.to(torch.int32)
    gs, gp = s.to(dev), ptr.to(dev)
    gbuf, gf, gc = enc.buf.to(dev), tt.freq.to(dev), tt.cdf.to(dev)
    for t in range(syms.shape[1]):
        ref = rans_decode.rans_decode_step_plain(enc.buf, s, ptr, tt.freq,
                                                 tt.cdf)
        got = rans_decode.rans_decode_step(gbuf, gs, gp, gf, gc)
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b)
        assert torch.equal(ref[2], _t(syms[:, t]))
        s, ptr, gs, gp = ref[0], ref[1], got[0], got[1]


def _step_pair(buf, s, ptr, freq, cdf, cands, dev,
               prob_bits=constants.PROB_BITS):
    """One B2 launch and its plain version on the same inputs (the plain
    one on the CPU); returns the plain outputs after checking equality."""
    ref = rans_decode.rans_decode_step_plain(buf, s, ptr, freq, cdf,
                                             prob_bits, candidates=cands)
    got = _launched("rans_decode_step", lambda: rans_decode.rans_decode_step(
        buf.to(dev), s.to(dev), ptr.to(dev), freq.to(dev), cdf.to(dev),
        prob_bits, candidates=None if cands is None else cands.to(dev)))
    _assert_same(got, ref)
    return ref


@pytest.mark.gpu
@pytest.mark.parametrize("topk", [0, 1, 4, 40])
@pytest.mark.parametrize("k", [2, 255, 256, 4096])
@pytest.mark.parametrize("rows", ["shared", "lane"])
def test_gpu_decode_step_rows_match_plain(rows, k, topk):
    """B2 on shared (K,) and per-lane (lanes, K) rows, registers (K <= 380:
    the warp row count path) and device memory (K = 4096: the read-ahead
    bisection), each launch on the path its plan names."""
    dev = _cuda()
    lanes, t = 64, 24
    tt, syms = _case("perpos" if rows == "shared" else "lane",
                     seed=k + topk, k=k, lanes=lanes, t=t)
    enc = coder.encode(_t(syms), tt)
    dec = coder.decoder_init(enc)
    s, ptr = u32.bits(dec.s), dec.ptr.to(torch.int32)
    cands = (torch.as_tensor(candidate_planes(syms, k, topk, 0.5, seed=k))
             if topk else None)
    for i in range(t):
        ref = _step_pair(enc.buf, s, ptr, tt.freq[i], tt.cdf[i],
                         None if cands is None else cands[i], dev)
        assert rans_decode.last_branches("rans_decode_step") == \
            autotune.decode_step_plan(k, lanes).branches()
        assert torch.equal(ref[2], _t(syms[:, i]))
        s, ptr = ref[0], ref[1]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["oob_candidates", "ptr_edges",
                                  "zero_freq"])
def test_gpu_decode_step_edges_match_plain(case):
    """B2 on out-of-range and duplicate candidates, on cursors at 0, cap - 1
    and outside the stream with states that refill twice (``under``
    fires), and on rows with zero frequencies (the exact bisection)."""
    dev = _cuda()
    lanes, k, t = 64, 256, 16
    tt, syms = _case("lane", seed=31, k=k, lanes=lanes, t=t)
    want = {"warp_rows"}
    if case == "zero_freq":
        tt = _zero_freq(tt, 14, every=3)
        for z in ZERO_SYMBOLS:
            syms[syms == z] = z + 2
        want = {"warp_rows", "warp_bisect"}
    enc = coder.encode(_t(syms), tt)
    dec = coder.decoder_init(enc)
    s, ptr = u32.bits(dec.s), dec.ptr.to(torch.int32)
    gen = torch.Generator().manual_seed(3)
    cands = torch.as_tensor(candidate_planes(syms, k, 6, 0.5, seed=3))
    if case == "oob_candidates":
        cands[:, ::2, 1] = -5
        cands[:, ::3, 2] = k + 3
        cands[:, ::4, 3] = cands[:, ::4, 0]
    if case == "ptr_edges":
        cap = enc.buf.shape[1]
        s = torch.randint(0, 1 << 14, (lanes,), generator=gen,
                          dtype=torch.int32)        # both refills fire
        ptr = torch.tensor([0, cap - 1, -1, cap] * (lanes // 4),
                           dtype=torch.int32)
        ref = _step_pair(enc.buf, s, ptr, tt.freq[0], tt.cdf[0], cands[0],
                         dev)
        assert rans_decode.last_branches("rans_decode_step") == want
        assert int(ref[4].sum()) > 0
        return
    seen = set()
    for i in range(t):
        ref = _step_pair(enc.buf, s, ptr, tt.freq[i], tt.cdf[i], cands[i],
                         dev)
        seen |= rans_decode.last_branches("rans_decode_step")
        s, ptr = ref[0], ref[1]
    assert seen == want


@pytest.mark.gpu
def test_gpu_slice_roundtrip_and_backends_identical():
    dev = _cuda()
    from repro_torch.configs.ras_pimc import SMOKE
    from repro_torch.core import bitstream
    from repro_torch.models import init_model
    from repro_torch.serve import compress

    model = init_model(SMOKE, seed=0, device=dev)
    tokens = token_stream(256, (8, 40), seed=2)
    blobs = {}
    for backend in ("kernel", "coder"):
        st = compress.lm_compress_chunked(model, tokens, 16, backend=backend)
        blobs[backend] = bitstream.pack_chunked(*st.chunks, chunk_size=16,
                                                n_symbols=40)
    assert blobs["kernel"] == blobs["coder"]
    cs = bitstream.parse_chunked(blobs["kernel"])
    probes = {}
    for backend in ("kernel", "coder"):
        sym, _, probes[backend] = compress.lm_decompress_chunked(
            model, cs, 40, 16, backend=backend, lane_probes=True)
        assert np.array_equal(sym.cpu().numpy(), tokens)
    assert torch.equal(probes["kernel"], probes["coder"])


@pytest.mark.gpu
def test_gpu_kernel_backend_runs_no_plain_spc(monkeypatch):
    """The fused LM path's SPC runs through B6 on the card: one launch for
    the compress side's whole table batch, one per decoded position, and
    no call of the sort-based ``quantize_probs`` on a CUDA tensor."""
    dev = _cuda()
    from repro_torch.configs.ras_pimc import SMOKE
    from repro_torch.models import init_model
    from repro_torch.serve import compress

    plain = spc.quantize_probs
    on_card = []

    def spy(probs, *a, **kw):
        if probs.is_cuda:
            on_card.append(tuple(probs.shape))
        return plain(probs, *a, **kw)

    monkeypatch.setattr(spc, "quantize_probs", spy)
    model = init_model(SMOKE, seed=0, device=dev)
    tokens = token_stream(256, (8, 40), seed=2)
    before = dict(LAUNCHES)
    st = compress.lm_compress_chunked(model, tokens, 16, backend="kernel")
    sym, _ = compress.lm_decompress_chunked(model, st.chunks, 40, 16,
                                            backend="kernel")
    torch.cuda.synchronize()
    assert np.array_equal(sym.cpu().numpy(), tokens)
    ran = {n: LAUNCHES[n] - before[n] for n in LAUNCHES}
    assert ran == {**{n: 0 for n in LAUNCHES}, "rans_encode_lanes": 1,
                   "rans_decode_step": 40, "spc_quantize": 41}
    assert on_card == []


PREDICTORS = [None, predictors.NeighborAverage(4, 8),
              predictors.NeighborAverage(2, 4), predictors.LastValue(8),
              predictors.ZeroPredictor(8), predictors.NeighborAverage(1, 8),
              predictors.NeighborAverage(16, 3), predictors.LastValue(40)]

# the decode kernel's table cases: (layout, K, prob_bits, zero frequencies)
# and the code paths (rans_decode.BRANCH_BITS) a launch on them must run
TABLES = {
    "static": ("static", 256, 14, False, {"slot_table"}),
    "perpos": ("perpos", 256, 14, False, {"warp_rows"}),
    "lane": ("lane", 256, 14, False, {"warp_rows"}),
    "static_zero_freq": ("static", 256, 14, True, {"shared_bisect"}),
    "lane_zero_freq": ("lane", 256, 14, True, {"warp_rows", "warp_bisect"}),
    "static_bits16": ("static", 256, 16, False, {"slot_table"}),
    "static_k1000": ("static", 1000, 14, False, {"slot_table"}),
    "static_k4096": ("static", 4096, 14, False, {"slot_table"}),
    "static_k5000": ("static", 5000, 14, False, {"warp_rows"}),
}
ZERO_SYMBOLS = (3, 4, 121, 200)      # symbols given frequency 0


def _on(tbl, dev):
    return spc.TableSet(*(a.to(dev) for a in tbl))


def _zero_freq(tt, prob_bits, every=1):
    """``tt`` with ZERO_SYMBOLS at frequency 0 (their mass moved to symbol
    128) in every ``every``-th row."""
    freq = tt.freq.clone()
    rows = freq.reshape(-1, freq.shape[-1])[::every]
    zs = list(ZERO_SYMBOLS)
    rows[:, 128] += rows[:, zs].sum(-1)
    rows[:, zs] = 0
    freq.reshape(-1, freq.shape[-1])[::every] = rows
    return spc.build_tables(freq, prob_bits)


def _smooth_case(table, seed, lanes=128, t=300):
    """A TABLES case: its tables, smooth random-walk symbols (none of them
    at a zero frequency) and its prob_bits."""
    layout, k, prob_bits, zero, _ = TABLES[table]
    tt, _ = _case(layout, seed, k, lanes, t, prob_bits)
    rng = np.random.default_rng(seed)
    syms = np.clip(k // 2 + np.cumsum(rng.integers(-3, 4, (lanes, t)), 1),
                   0, k - 1).astype(np.int32)
    if zero:
        tt = _zero_freq(tt, prob_bits, every=1 if layout == "static" else 7)
        for z in ZERO_SYMBOLS:
            syms[syms == z] = z + 2
    return tt, syms, prob_bits


def _branches(name, table, pred):
    """The code paths a launch on TABLES[table] with ``pred`` must run: a
    window wider than the kernel's probe tables (2 * delta + 1 > 63) moves
    a static table from the slot path to the warp path."""
    want = TABLES[table][4]
    if pred is not None and 2 * pred.delta + 1 > 63:
        moved = {"slot_table": "warp_rows", "shared_bisect": "warp_bisect"}
        want = {moved.get(w, w) for w in want}
    assert rans_decode.last_branches(name) == want, name


def _launched(name, fn):
    before = LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1, name
    return out


def _assert_same(got, ref):
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", list(TABLES))
@pytest.mark.parametrize("pred", range(len(PREDICTORS)))
def test_gpu_decode_lanes_kernel_matches_plain(layout, pred):
    dev = _cuda()
    tt, syms, prob_bits = _smooth_case(layout, seed=7 + pred)
    k = tt.freq.shape[-1]
    cands = torch.as_tensor(candidate_planes(syms, k, 2, 0.5, seed=pred))
    cands[::5, :, 1] = cands[::5, :, 0]             # duplicate ids
    cands[::7, :, 1] = k + 3                         # out of range
    ch = coder.encode_chunked(_t(syms), tt, 128)
    gt = _on(tt, dev)
    cases = [(ch.buf, ch.start, 128, None, False),             # chunked
             (ch.buf[..., :-3], ch.start, 128, cands, True)]   # truncated
    if TABLES[layout][0] != "lane":
        enc = coder.encode(_t(syms), tt)
        cases.append((enc.buf, enc.start, None, cands, False))  # monolithic
    for buf, start, chunk, cd, truncated in cases:
        kw = dict(prob_bits=prob_bits, predictor=PREDICTORS[pred],
                  candidates=cd)
        ref = rans_decode.rans_decode_lanes_plain(
            buf, start, tt.freq, tt.cdf, 300, chunk, **kw)
        kw["candidates"] = None if cd is None else cd.to(dev)
        got = _launched("rans_decode_lanes", lambda: rans_decode.rans_decode_lanes(
            buf.to(dev), start.to(dev), gt.freq, gt.cdf, 300, chunk, **kw))
        _assert_same(got, ref)
        _branches("rans_decode_lanes", layout, PREDICTORS[pred])
        if not TABLES[layout][3]:
            # (the reference's early commit may answer a zero-frequency
            # symbol and lose the stream, so only kernel == plain holds on
            # those tables)
            assert (int(ref[2].sum()) > 0) == truncated
            if not truncated:
                assert torch.equal(got[0].cpu(), _t(syms))


def _poisons(cs):
    """The fuzz tier's three hostile-after-validation index planes; only
    offsets past the payload end must be flagged (a length past the window
    still reads the real stream to its end)."""
    s = cs.slab.shape[0]
    return [cs._replace(offset=np.full_like(cs.offset, s + 1000)),
            cs._replace(length=np.full_like(cs.length, cs.cap + 7)),
            cs._replace(offset=np.full_like(cs.offset, s - 1),
                        length=np.full_like(cs.length, cs.cap + 3))]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", list(TABLES))
def test_gpu_decode_slab_kernel_matches_plain(layout):
    dev = _cuda()
    tt, syms, prob_bits = _smooth_case(layout, seed=21)
    k = tt.freq.shape[-1]
    cands = torch.as_tensor(candidate_planes(syms, k, 4, 0.6, seed=1))
    ch = coder.encode_chunked(_t(syms), tt, 128)
    cs = bitstream.parse_chunked(bitstream.pack_chunked(
        *ch, chunk_size=128, n_symbols=300))
    gt = _on(tt, dev)
    for i, src in enumerate([cs] + _poisons(cs)):
        pred = PREDICTORS[i % len(PREDICTORS)]
        (planes, cap) = ops.slab_planes(src, dev)
        kw = dict(cap=cap, t_len=300, chunk_size=128, prob_bits=prob_bits,
                  predictor=pred)
        ref = rans_decode.rans_decode_slab_plain(
            *(p.cpu() for p in planes), tt.freq, tt.cdf, candidates=cands,
            **kw)
        got = _launched("rans_decode_slab", lambda: rans_decode.rans_decode_slab(
            *planes, gt.freq, gt.cdf, candidates=cands.to(dev), **kw))
        _assert_same(got, ref)
        _branches("rans_decode_slab", layout, pred)
        if i == 0:
            if not TABLES[layout][3]:
                assert torch.equal(got[0].cpu(), _t(syms))
            dense = rans_decode.rans_decode_lanes(
                ch.buf.to(dev), ch.start.to(dev), gt.freq, gt.cdf, 300, 128,
                prob_bits=prob_bits, predictor=pred,
                candidates=cands.to(dev))
            _assert_same(got, dense)
        elif i == 1:                                # offsets past the end
            assert int(got[2].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_gpu_golden_corpus_decodes(name):
    dev = _cuda()
    case = CASES[name]
    tt, syms = case_tables(case)
    with open(os.path.join(GOLDEN, name + ".ras"), "rb") as fh:
        blob = fh.read()
    gt = _on(tt, dev)
    if case["fmt"] == "v1":
        buf, start, meta = bitstream.unpack(blob)
        enc = EncodedLanes(_t(buf).to(dev), _t(start).to(dev), None)
        sym, _ = _launched("rans_decode_lanes", lambda: ops.rans_decode(
            enc, meta.n_symbols, gt))
    else:
        cs = bitstream.parse_chunked(blob)
        sym, _ = _launched("rans_decode_slab", lambda: ops.rans_decode_chunked(
            tbl=gt, from_container=cs))
    assert torch.equal(sym.cpu(), _t(syms))


# ---------------------------------------------------------------------------
# B5 records encode and B6 SPC quantizer
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["static", "perpos", "lane"])
def test_gpu_records_kernel_matches_plain(layout):
    dev = _cuda()
    tt, syms = _case(layout, seed=8, k=256, lanes=128, t=300)
    gt, gs = _on(tt, dev), _t(syms).to(dev)
    for chunk, t_block in ((128, None), (300, None), (128, 48), (None, 7)):
        ref = rans_encode.rans_encode_records_plain(_t(syms), tt, chunk,
                                                    t_block)
        got = _launched("rans_encode_records", lambda: (
            rans_encode.rans_encode_records(gs, gt, chunk, t_block)))
        _assert_same(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["static", "perpos", "lane"])
def test_gpu_records_compacted_match_fused(layout):
    dev = _cuda()
    tt, syms = _case(layout, seed=9, k=256, lanes=128, t=300)
    gt, gs = _on(tt, dev), _t(syms).to(dev)
    b, m, st = _launched("rans_encode_records", lambda: (
        ops.rans_encode_records(gs, gt, 128, 96)))
    for cap in (coder.default_cap(128), 90, 3):
        fused = ops.rans_encode_chunked(gs, gt, 128, cap=cap)
        got = ops.compact_records(b, m, st, cap)
        _assert_same(got, fused)
    assert not bool(ops.compact_records(
        b, m, st, coder.default_cap(128)).overflow.any())
    assert bool(got.overflow.all())                  # cap 3 < the header


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_gpu_golden_corpus_repacks_through_records(name):
    dev = _cuda()
    case = CASES[name]
    tt, syms = case_tables(case)
    with open(os.path.join(GOLDEN, name + ".ras"), "rb") as fh:
        want = fh.read()
    gt, gs = _on(tt, dev), _t(syms).to(dev)
    chunk = case.get("chunk_size")
    b, m, st = _launched("rans_encode_records", lambda: (
        ops.rans_encode_records(gs, gt, chunk)))
    cap = coder.default_cap(min(chunk or case["t"], case["t"]))
    enc = ops.compact_records(b, m, st, cap)
    if case["fmt"] == "v1":
        blob = bitstream.pack(*coder.chunk_encoded(enc, 0),
                              n_symbols=case["t"])
    else:
        blob = bitstream.pack_chunked(*enc, chunk_size=chunk,
                                      n_symbols=case["t"],
                                      checksums=case["checksums"])
    assert blob == want


def _spc_rows():
    rng = np.random.default_rng(10)
    k = 128
    rows = [rng.dirichlet(np.full(256, conc), size=b).astype(np.float32)
            for b, conc in ((8, 0.3), (16, 2.0))]
    rows.append(rng.dirichlet(np.full(300, 0.1), size=8).astype(np.float32))
    rows.append(np.stack([                       # pathological rows
        np.full(k, 1.0 / k), np.r_[1.0, np.zeros(k - 1)],
        np.r_[np.full(k - 1, 1e-9), [1.0]], np.full(k, 1 / 3),
        np.tile([0.5, 0.25, 0.25, 0.0], k // 4) / (k // 4),   # ties
        np.r_[np.full(k // 2, 3e-5), np.full(k // 2, 0.015)],
    ]).astype(np.float32))
    # 96 KB of shared memory (above the 48 KB default) and B = 5
    rows.append(rng.dirichlet(np.full(8192, 0.5), size=5).astype(np.float32))
    return rows


def _spc_route_cases():
    """B6 cases for ``spc_freq_cdf``: (probs, prob_bits)."""
    rng = np.random.default_rng(17)
    k = 256
    tiny = np.r_[np.full(200, 1e-9), rng.dirichlet(np.full(56, 0.5))]
    # exact multiples of 2**-14: every residual is +0.0, so the mass
    # correction is one tie run ordered by index (-0.0 cannot arise from
    # probabilities: scaled - rint(scaled) is +0.0 when it is zero)
    grid = rng.integers(1, 100, (4, k)) / float(1 << 14)
    return {
        "waterfill": (np.stack([tiny, np.full(k, 1 / 3), tiny[::-1]]), 14),
        "tie_runs": (np.stack([
            np.full(k, 1.0 / k), np.tile([0.5, 0.25, 0.25, 0.0], k // 4)
            / (k // 4), np.r_[np.full(k // 2, 3e-5), np.full(k // 2, 0.015)],
        ]), 14),
        "zero_residuals": (grid, 14),
        "b1": (rng.dirichlet(np.full(k, 0.5), size=1), 14),
        "k1": (np.array([[1.0], [0.3], [0.0], [2.0], [np.nan]]), 14),
        "k16384_bits16": (rng.dirichlet(np.full(16384, 0.5), size=3), 16),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["waterfill", "tie_runs", "zero_residuals",
                                  "b1", "k1", "k16384_bits16"])
def test_gpu_spc_freq_cdf_matches_plain(case, dtype):
    dev = _cuda()
    probs, prob_bits = _spc_route_cases()[case]
    x = torch.as_tensor(probs.astype(np.float32)).to(getattr(torch, dtype))
    ref = spc.freq_cdf_from_probs(x, prob_bits)
    assert torch.equal(spc_quantize.spc_quantize_plain(x, prob_bits), ref[0])
    assert (ref[1][:, -1] == 1 << prob_bits).all()
    got = _launched("spc_quantize", lambda: spc_quantize.spc_freq_cdf(
        x.to(dev), prob_bits))
    _assert_same(got, ref)
    freq = _launched("spc_quantize", lambda: spc_quantize.spc_quantize(
        x.to(dev), prob_bits))
    assert torch.equal(freq.cpu(), ref[0])


@pytest.mark.gpu
def test_gpu_barrett_planes_match_cpu():
    """``build_tables`` on the card equals the CPU's for every frequency
    (its shift once came from a float log2 that floors short on CUDA)."""
    dev = _cuda()
    for prob_bits in (8, 14, 16):
        f = torch.arange(1, (1 << prob_bits) + 1, dtype=torch.int64)
        start = (f * 7) % (1 << prob_bits)
        ref = spc.barrett_planes(f, start, prob_bits)
        got = spc.barrett_planes(f.to(dev), start.to(dev), prob_bits)
        _assert_same(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(5))
def test_gpu_spc_kernel_matches_plain(case):
    dev = _cuda()
    probs = _t(_spc_rows()[case])
    ref = spc_quantize.spc_quantize_plain(probs)
    got = _launched("spc_quantize", lambda: spc_quantize.spc_quantize(
        probs.to(dev)))
    assert torch.equal(got.cpu(), ref)
    assert (ref.sum(-1) == 1 << 14).all() and int(ref.min()) >= 1
    tables = _launched("spc_quantize", lambda: ops.spc_quantize_tables(
        probs.to(dev)))
    _assert_same(tables, spc.tables_from_probs(probs))


# ---------------------------------------------------------------------------
# the batching engine's path on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("topk", [0, 4])
def test_gpu_decode_step_rows_kernel_matches_coder(topk):
    """``ops.rans_decode_step_rows``: B2 over 4 slots x 32 lanes of rows ==
    the coder pop, over 20 steps, one launch a step."""
    dev = _cuda()
    tt, syms = _case("lane", seed=12, k=256, lanes=128, t=20)
    enc = coder.encode(_t(syms), tt)
    dec = coder.decoder_init(enc)
    buf = enc.buf.to(dev)
    s = {b: u32.bits(dec.s).to(dev) for b in ("kernel", "coder")}
    ptr = {b: dec.ptr.to(torch.int32).to(dev) for b in ("kernel", "coder")}
    cands = torch.as_tensor(candidate_planes(syms, 256, topk, 0.5, seed=3),
                            device=dev) if topk else None
    for t in range(20):
        tbl = spc.FreqCdf(tt.freq[t].to(dev), tt.cdf[t].to(dev))
        c = None if cands is None else cands[t]
        out = {b: _launched("rans_decode_step", lambda: (
            ops.rans_decode_step_rows(buf, s[b], ptr[b], tbl, candidates=c,
                                      backend=b)))
               if b == "kernel" else
               ops.rans_decode_step_rows(buf, s[b], ptr[b], tbl,
                                         candidates=c, backend=b)
               for b in ("kernel", "coder")}
        _assert_same(out["kernel"], out["coder"])
        assert torch.equal(out["kernel"][2].cpu(), _t(syms[:, t]))
        for b in out:
            s[b], ptr[b] = out[b][0], out[b][1]


def _small_model(dev):
    from repro_torch.configs.ras_pimc import SMOKE
    from repro_torch.models import init_model
    return init_model(SMOKE, seed=0, device=dev)


@pytest.mark.gpu
def test_gpu_engine_slots_keep_the_single_request_state():
    """Four slots of 16 lanes (requests of 40, 23, 33 and 6 symbols in a
    64-slot ring) through the step loop on the card: each slot's state
    after the run is bitwise the single-request scan's after the same
    tokens, at the request's own ring length."""
    from repro_torch.serve import compress
    from repro_torch.serve.engine import BatchEngine
    dev = _cuda()
    model = _small_model(dev)
    lanes = 16
    toks = [token_stream(256, (lanes, n), seed=70 + i)
            for i, n in enumerate((40, 23, 33, 6))]
    eng = BatchEngine(model, slots=4, lanes=lanes, chunk_size=16,
                      max_len=64, prefill="off")
    rids = [eng.submit_compress(t) for t in toks]
    res = eng.run()
    for rid, t in zip(rids, toks):
        assert res[rid].ok
        inputs = torch.cat([torch.full((lanes, 1), compress.BOS),
                            _t(t[:, :-1]).long()], 1).to(dev)
        alone = compress.teacher_forced_scan(model, inputs, t.shape[1],
                                             lambda lg, i: None)
        st = eng._states[res[rid].slot]
        assert torch.equal(st.k, alone.k) and torch.equal(st.v, alone.v)


@pytest.mark.gpu
def test_gpu_prefill_chunk_bitwise_matches_steps():
    from repro_torch.models import decode_step, init_state, prefill_chunk
    dev = _cuda()
    model = _small_model(dev)
    b, s, warm = 32, 24, 5
    toks = _t(token_stream(256, (b, warm + s), seed=9)).to(dev)
    step = init_state(model, b, 40)
    for t in range(warm):
        decode_step(model, step, toks[:, t:t + 1], t)
    pf = type(step)(step.k.clone(), step.v.clone(), step.length)
    nv = torch.full((b,), s, dtype=torch.int64, device=dev)
    nv[20:24] = 7                                    # one ragged slot's rows
    pos0 = torch.full((b,), warm, dtype=torch.int64, device=dev)
    ref = torch.stack([decode_step(model, step, toks[:, warm + t:warm + t + 1],
                                   pos0 + torch.clamp(nv, max=t))
                       for t in range(s)], 1)
    lg = prefill_chunk(model, pf, toks[:, warm:], pos0, nv)
    live = (torch.arange(s, device=dev)[None] < nv[:, None])
    assert torch.equal(lg[live], ref[live])
    keep = torch.ones(pf.k.shape[2], dtype=torch.bool)
    keep[warm + 7] = False             # the ragged rows' clamped slot
    assert torch.equal(pf.k[:, :20], step.k[:, :20])
    assert torch.equal(pf.k[:, 20:24][:, :, keep],
                       step.k[:, 20:24][:, :, keep])
    assert torch.equal(pf.v[:, 24:], step.v[:, 24:])


@pytest.mark.gpu
def test_gpu_engine_byte_identical_to_single_request():
    """A small mixed workload on the card through the kernel step backend:
    blobs equal ``lm_compress_chunked(backend="kernel")``'s, tokens and
    per-lane probes ``lm_decompress_chunked``'s, with B1, B2 and B6
    launched and no host sync inside a cycle."""
    from repro_torch.serve import compress
    from repro_torch.serve.engine import BatchEngine
    dev = _cuda()
    model = _small_model(dev)
    lanes, chunk = 8, 16
    toks = [token_stream(256, (lanes, n), seed=60 + i)
            for i, n in enumerate((40, 23, 33))]
    ref = [bitstream.pack_chunked(*compress.lm_compress_chunked(
        model, t, chunk, backend="kernel").chunks, chunk_size=chunk,
        n_symbols=t.shape[1]) for t in toks]
    eng = BatchEngine(model, slots=3, lanes=lanes, chunk_size=chunk,
                      max_len=48, step_backend="kernel")
    eng.check_sync = True
    rc = [eng.submit_compress(t) for t in toks[:2]]
    rd = eng.submit_decompress(ref[2])
    before = dict(LAUNCHES)
    res = eng.run()
    ran = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    for r, blob in zip(rc, ref):
        assert res[r].ok and res[r].blob == blob
    sym, _, lp = compress.lm_decompress_chunked(
        model, bitstream.parse_chunked(ref[2]), 33, chunk, backend="kernel",
        lane_probes=True)
    assert res[rd].ok
    np.testing.assert_array_equal(res[rd].tokens, toks[2])
    np.testing.assert_array_equal(res[rd].lane_probes, lp.cpu().numpy())
    # cycles of 16, 16 and 8 steps (the longest chunk left), each with a
    # decode and compress rows
    assert ran["rans_decode_step"] == 40
    assert ran["rans_encode_lanes"] == 2 + 2 + 1     # each compress chunk
    assert ran["spc_quantize"] == 40 + 3             # per step + per cycle


# ---------------------------------------------------------------------------
# training and bits-back (slice 5)
# ---------------------------------------------------------------------------

def _dirichlet_rows(rng, k, rows, dev):
    probs = rng.dirichlet(np.full(k, 0.3), size=rows)
    return spc.freq_cdf_from_probs(spc.store_bf16(
        torch.as_tensor(probs.astype(np.float32)))), probs


@pytest.mark.gpu
@pytest.mark.parametrize("k,per_lane", [(16, True), (256, True), (16, False)])
def test_gpu_decode_step_at_stack_shapes(k, per_lane):
    """B2 as the stack pops: 512 lanes, no candidates, per-lane or shared
    rows, from 8 initial bytes per lane until every lane has read past
    its stream end (underflow counted on both)."""
    from repro_torch.core import stack
    dev = _cuda()
    lanes = 512
    rng = np.random.default_rng(70 + k)
    (freq, cdf), _ = _dirichlet_rows(rng, k, lanes if per_lane else None,
                                     dev)
    freq, cdf = freq.to(dev), cdf.to(dev)
    st = stack.stack_init_bits(lanes, 64, n_bytes=8, seed=k, device=dev)
    s, ptr = u32.bits(st.s), st.ptr.to(torch.int32)
    flagged = torch.zeros(lanes, dtype=torch.bool, device=dev)
    for step in range(256):
        if bool(flagged.all()):
            break
        ref = rans_decode.rans_decode_step_plain(st.buf, s, ptr, freq, cdf)
        before = LAUNCHES["rans_decode_step"]
        got = rans_decode.rans_decode_step(st.buf, s, ptr, freq, cdf)
        assert LAUNCHES["rans_decode_step"] == before + 1
        for name, a, b in zip(("s", "ptr", "sym", "probes", "under"), got,
                              ref):
            assert torch.equal(a, b), (step, name)
        s, ptr = got[0], got[1]
        flagged |= got[4] > 0
    assert bool(flagged.all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_spc_rows_of_16(dtype):
    """B6 on the VAE's latent rows (K = 16): Gaussian bin masses with
    tails far below one unit, and Dirichlet rows."""
    from repro_torch.core import stack
    dev = _cuda()
    rng = np.random.default_rng(71)
    edges, _ = stack.std_gaussian_bins(16)
    mu = torch.as_tensor(rng.normal(0, 2, 2048), dtype=torch.float32)
    sig = torch.as_tensor(rng.uniform(0.02, 3, 2048), dtype=torch.float32)
    gauss = stack.gaussian_bin_probs(mu, sig, edges)
    _, dirich = _dirichlet_rows(rng, 16, 2048, dev)
    for probs in (gauss, torch.as_tensor(dirich.astype(np.float32))):
        p = probs.to(dtype)
        ref = spc_quantize.spc_freq_cdf_plain(p)
        before = LAUNCHES["spc_quantize"]
        got = spc_quantize.spc_freq_cdf(p.to(dev))
        assert LAUNCHES["spc_quantize"] == before + 1
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_gpu_train_step_matches_cpu():
    """Two train steps of the smoke model on the card and on the CPU from
    the same weights and batches, both past the warmup (step counter 100,
    lr 3e-3, so every leaf moves by far more than the tolerance): losses,
    norms and every updated parameter within 1e-4 of the leaf's largest
    entry (the card's GEMMs and reductions sum in other orders)."""
    from repro_torch.configs.ras_pimc import SMOKE
    from repro_torch.data.pipeline import train_batch
    from repro_torch.models import init_model
    from repro_torch.train import train_loop
    dev = _cuda()
    init = {k: v.detach().clone() for k, v in
            init_model(SMOKE, seed=4, device="cpu").named_parameters()}
    runs = {}
    for d in ("cpu", dev):
        state = train_loop.init_train_state(init_model(SMOKE, seed=4,
                                                       device=d))
        state = state._replace(step=torch.full_like(state.step, 100))
        step = train_loop.make_train_step(SMOKE, base_lr=3e-3)
        for i in range(2):
            state, m = step(state, train_batch(SMOKE, 8, 64, step=i))
        runs[str(d)] = (state, {k: float(v) for k, v in m.items()})
    (cpu, mc), (card, mg) = runs["cpu"], runs[str(dev)]
    np.testing.assert_allclose(mg["lr"], 3e-3, rtol=1e-6)
    for k in mc:
        np.testing.assert_allclose(mg[k], mc[k], rtol=1e-4, err_msg=k)
    assert int(card.step) == 102
    for (name, a), b in zip(card.model.named_parameters(),
                            cpu.model.parameters()):
        a, b = a.detach().cpu(), b.detach()
        tol = 1e-4 * float(b.abs().max())
        moved = float((a - init[name]).abs().max())
        assert moved > 10 * tol, f"{name} moved {moved}, tolerance {tol}"
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=tol,
                                   err_msg=name)


@pytest.mark.gpu
def test_gpu_bitsback_roundtrip(monkeypatch):
    """A small VAE trained on the card: ``bb_encode`` through the coder and
    the kernel pops lands byte-identical stacks, ``bb_decode`` through B2
    returns the pixels and the initial stack, one B2 launch per pop, and
    the tables' SPC runs through B6 (no sort-based SPC on the card)."""
    from repro_torch.core import stack
    from repro_torch.models import vae
    dev = _cuda()
    plain, on_card = spc.quantize_probs, []

    def spy(probs, *a, **kw):
        if probs.is_cuda:
            on_card.append(tuple(probs.shape))
        return plain(probs, *a, **kw)

    monkeypatch.setattr(spc, "quantize_probs", spy)
    cfg = vae.VAEConfig(d_x=16, d_h=16)
    lanes = 64
    params, loss = vae.train_vae(
        cfg, lambda i: np.random.default_rng(i).integers(
            0, cfg.x_bins, (lanes, cfg.d_x)), steps=5, lr=1e-3, device=dev)
    assert np.isfinite(loss)
    x = torch.as_tensor(np.random.default_rng(72).integers(
        0, cfg.x_bins, (lanes, cfg.d_x)), device=dev)
    st0 = stack.stack_init_bits(lanes, 1024, n_bytes=32, seed=73,
                                device=dev)
    st_c = vae.bb_encode(st0, params, x, cfg, backend="coder")
    before = LAUNCHES["rans_decode_step"]
    st_k = vae.bb_encode(st0, params, x, cfg, backend="kernel")
    assert LAUNCHES["rans_decode_step"] - before == 2 * cfg.d_z
    for a, b in zip(st_k, st_c):
        assert torch.equal(a, b)
    before = LAUNCHES["rans_decode_step"]
    st_d, x_d = vae.bb_decode(st_k, params, cfg, backend="kernel")
    assert LAUNCHES["rans_decode_step"] - before == 2 * cfg.d_z + cfg.d_x
    assert torch.equal(x_d, x)
    assert torch.equal(st_d.s, st0.s) and torch.equal(st_d.ptr, st0.ptr)
    assert not bool(st_d.underflow.any())
    assert not on_card, on_card


# ---------------------------------------------------------------------------
# the recurrent families (mamba2-130m's K = 50,280 and its model)
# ---------------------------------------------------------------------------

def _wide_rows(k: int, case: str) -> np.ndarray:
    """B6 rows above the register layouts' 16,384: (B, K) float32."""
    rng = np.random.default_rng(k)
    if case == "dirichlet":
        return rng.dirichlet(np.full(k, 0.5), size=3)
    if case == "near_uniform":          # residual ties and near-ties
        base = np.full(k, 1.0 / k)
        return np.stack([base, base * (1 + 1e-3 * rng.standard_normal(k)),
                         base * (1 + rng.integers(0, 2, k) * 2e-2)])
    if case == "ties":
        return np.stack([
            np.tile([0.5, 0.25, 0.25, 0.0], k // 4 + 1)[:k] / (k / 4),
            np.r_[np.full(k // 2, 3e-6), np.full(k - k // 2, 1.5e-5)],
        ])
    tiny = np.r_[np.full(k - 56, 1e-9), rng.dirichlet(np.full(56, 0.5))]
    return np.stack([tiny, np.full(k, 1 / 3), tiny[::-1]])   # waterfill


def _wide_batch(k: int, case: str, rows: int, dtype: str, dev):
    """``rows`` rows of K: the case's rows first (one row: its first), the
    rest softmaxes of seeded logits drawn on the card, as a model's are."""
    head = torch.as_tensor(_wide_rows(k, case)[:rows].astype(np.float32))
    x = head.to(dev)
    if rows > head.shape[0]:
        gen = torch.Generator(device=dev).manual_seed(k + rows)
        fill = torch.softmax(torch.randn((rows - head.shape[0], k),
                                         generator=gen, device=dev) * 3.0, -1)
        x = torch.cat([x, fill])
    return x.to(getattr(torch, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 16, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["dirichlet", "near_uniform", "ties",
                                  "waterfill"])
@pytest.mark.parametrize("k", [16385, 32064, 32768, 50280, 65536])
def test_gpu_spc_wide_matches_plain(k, case, dtype, rows):
    """B6's cluster layout (16,384 < K <= 65,536) at prob_bits 16 on 1, 16
    and 4,096 rows, with and without the CDF, against the sort-based plain
    SPC (on the CPU up to 16 rows, on the card for the batch)."""
    dev = _cuda()
    x = _wide_batch(k, case, rows, dtype, dev)
    plan = autotune.spc_plan(rows, k)
    assert (plan.path, plan.cluster, plan.grid) == (
        "cluster", -(-k // autotune.SPC_WIDE_SEG), rows * plan.cluster)
    ref = spc.freq_cdf_from_probs(x if rows > 16 else x.cpu(), 16)
    assert (ref[1][:, -1] == 1 << 16).all() and int(ref[0].min()) >= 1
    got = _launched("spc_quantize", lambda: spc_quantize.spc_freq_cdf(x, 16))
    _assert_same(got, ref)
    freq = _launched("spc_quantize", lambda: spc_quantize.spc_quantize(x, 16))
    assert torch.equal(freq.cpu(), ref[0].cpu())


def _wide_step_tables(tt, rows: str, seed: int):
    """The wide B2 cases' tables: per-lane SPC rows, the first lane's rows
    shared by every lane, zero frequencies in every third (position, lane)
    row, or a freq that is not the cdf's differences (the cdf kept)."""
    if rows == "shared":
        return tt._replace(freq=tt.freq[:, 0], cdf=tt.cdf[:, 0])
    if rows == "zero_freq":
        return _zero_freq(tt, 16, every=3)
    if rows == "mismatched":
        gen = torch.Generator().manual_seed(seed)
        bent = tt.freq + torch.randint(0, 3, tt.freq.shape, generator=gen,
                                       dtype=tt.freq.dtype)
        return tt._replace(freq=bent)
    return tt


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 16, 128])
@pytest.mark.parametrize("rows", ["lane", "shared", "zero_freq",
                                  "mismatched"])
@pytest.mark.parametrize("k", [32064, 32768, 50280])
def test_gpu_decode_step_large_k_rows_match_plain(k, rows, lanes):
    """B2 at the phi, mixtral and mamba2 slices' K = 32,064, 32,768 and
    50,280 at prob_bits 16: per-lane rows (the slices' own), a shared row,
    rows with zero frequencies and mismatched (freq, cdf) pairs, on 1, 16
    and 128 lanes, with top-4 candidates (out-of-range and duplicate ids
    among them) and without.  Every launch runs the read-ahead bisection
    its plan names; all six output rows equal the plain pop's."""
    dev = _cuda()
    t = 6
    tt, syms = _case("lane", seed=9, k=k, lanes=lanes, t=t, prob_bits=16)
    enc = coder.encode(_t(syms), tt)
    tt = _wide_step_tables(tt, rows, seed=k + lanes)
    dec = coder.decoder_init(enc)
    s, ptr = u32.bits(dec.s), dec.ptr.to(torch.int32)
    cands = torch.as_tensor(candidate_planes(syms, k, 4, 0.5, seed=9))
    cands[:, ::2, 1] = -5
    cands[:, ::3, 2] = k + 3
    cands[:, ::4, 3] = cands[:, ::4, 0]
    want = autotune.decode_step_plan(k, lanes).branches()
    assert want == {"tree_bisect"}
    for i in range(t):
        cand = cands[i] if i % 2 == 0 else None
        ref = _step_pair(enc.buf, s, ptr, tt.freq[i], tt.cdf[i], cand, dev,
                         prob_bits=16)
        assert rans_decode.last_branches("rans_decode_step") == want
        if rows == "lane":
            assert torch.equal(ref[2], _t(syms[:, i]))
        s, ptr = ref[0], ref[1]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,width", [("mamba2-130m", "smoke"),
                                        ("mamba2-130m", "full"),
                                        ("recurrentgemma-2b", "smoke")])
def test_gpu_recurrent_steps_match_cpu(arch, width):
    """The same float32 weights on the card and on the CPU, 2 rows x 4
    steps: logits within 1e-4 (the summation orders of cuBLAS and the
    card's reductions against the CPU's)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import decode_step, init_model, init_state
    dev = _cuda()
    cfg = (get_smoke_config(arch) if width == "smoke"
           else get_config(arch)).with_(dtype="float32")
    models = [init_model(cfg, seed=3, device=d) for d in ("cpu", dev)]
    states = [init_state(m, 2, 8) for m in models]
    toks = torch.randint(0, cfg.vocab_size, (2, 4),
                         generator=torch.Generator().manual_seed(4))
    for t in range(4):
        lg = [decode_step(m, st, toks[:, t:t + 1].to(m.embedding.device), t)
              for m, st in zip(models, states)]
        assert bool(torch.isfinite(lg[1]).all())
        assert float((lg[1].cpu() - lg[0]).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# the MoE family (mixtral-8x22b's and phi3.5-moe's SMOKE on the card)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "phi3.5-moe-42b-a6.6b"])
def test_gpu_moe_smoke_roundtrip(arch):
    """The SMOKE model on the card, 4 lanes x 40 tokens (mixtral's 16-slot
    window wraps): kernel and coder containers byte-identical, the fused
    decode exact with one B2 and one B6 launch per position; its float32
    steps against the same weights on the CPU within 1e-4; the card's
    ``prefill_chunk`` bitwise its own steps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import (decode_step, init_model, init_state,
                                    prefill_chunk)
    from repro_torch.serve import compress
    dev = _cuda()
    cfg = get_smoke_config(arch)
    model = init_model(cfg, seed=2, device=dev)
    toks = token_stream(cfg.vocab_size, (4, 40), seed=5)

    def blob(backend):
        st = compress.lm_compress_chunked(model, toks, 16, backend=backend)
        return bitstream.pack_chunked(*st.chunks, chunk_size=16,
                                      n_symbols=40)

    b = blob("kernel")
    assert b == blob("coder")
    before = dict(LAUNCHES)
    sym, _, _ = compress.lm_decompress_chunked(
        model, bitstream.parse_chunked(b), 40, 16, backend="kernel",
        lane_probes=True)
    torch.cuda.synchronize()
    assert LAUNCHES["rans_decode_step"] - before["rans_decode_step"] == 40
    assert LAUNCHES["spc_quantize"] - before["spc_quantize"] == 40
    assert np.array_equal(sym.cpu().numpy(), toks)
    cpu = init_model(cfg, seed=2, device="cpu")
    states = [init_state(m, 2, 40) for m in (cpu, model)]
    t_in = torch.as_tensor(toks[:2])
    for t in range(24):
        lg = [decode_step(m, st, t_in[:, t:t + 1].to(m.embedding.device), t)
              for m, st in zip((cpu, model), states)]
        assert float((lg[1].cpu() - lg[0]).abs().max()) <= 1e-4
    st_p = init_state(model, 2, 40)
    lp = prefill_chunk(model, st_p, t_in[:, :16].to(dev),
                       torch.zeros(2, dtype=torch.int64, device=dev),
                       torch.full((2,), 16, dtype=torch.int64, device=dev))
    st_s = init_state(model, 2, 40)
    for t in range(16):
        ls = decode_step(model, st_s, t_in[:, t:t + 1].to(dev), t)
        assert torch.equal(lp[:, t], ls)
    assert torch.equal(st_p.k, st_s.k) and torch.equal(st_p.v, st_s.v)


# ---------------------------------------------------------------------------
# training of the zoo, the dense zoo's SMOKE models and the decode's top-k
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("scan", ["ssd_chunked", "rglru_forward"])
def test_gpu_recurrent_scans_match_cpu(scan):
    """The training scans on the card against the CPU in float32, at a
    length that is not a multiple of the SSD chunk (29 over 8): values
    and the gradients of a weighted sum within 1e-5 of their largest
    entry."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_model, rglru, ssm
    dev = _cuda()
    rng = np.random.default_rng(7)
    if scan == "ssd_chunked":
        b, s, h, p, n = 2, 29, 4, 8, 16
        args = [rng.normal(size=(b, s, h, p)),
                np.log1p(np.exp(rng.normal(size=(b, s, h)))),
                -np.exp(rng.normal(size=(h,)) * 0.5),
                rng.normal(size=(b, s, 1, n)), rng.normal(size=(b, s, 1, n))]
        out_shape = (b, s, h, p)
    else:
        cfg = get_smoke_config("recurrentgemma-2b")
        blk = init_model(cfg, seed=2, device="cpu").blocks[0].rec
        args = [rng.normal(size=(2, 40, cfg.d_model))]
        out_shape = (2, 40, cfg.d_model)
    w = torch.as_tensor(rng.normal(size=out_shape).astype(np.float32))
    got = []
    for d in ("cpu", dev):
        xs = [torch.as_tensor(a.astype(np.float32), device=d)
              .requires_grad_() for a in args]
        if scan == "ssd_chunked":
            y = ssm.ssd_chunked(*xs, chunk=8)
        else:
            rec = copy.deepcopy(blk).to(d)
            y = rglru.rglru_forward(rec, xs[0], cfg)
        grads = torch.autograd.grad((y * w.to(d)).sum(), xs)
        got.append([t.detach().cpu() for t in (y, *grads)])
    for c, g in zip(*got):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=0,
                                   atol=1e-5 * float(c.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b",
                                  "mixtral-8x22b"])
def test_gpu_zoo_train_step_matches_cpu(arch):
    """The recurrent families' and mixtral's SMOKE train step (the SSD
    chunk scan, the RG-LRU doubling scan and the capacity MoE backward
    under deterministic algorithms) on the card against the CPU from the
    same weights and batch: the loss within rtol 1e-5, every gradient leaf
    within 1e-4 of its largest entry, and the step's loss and gradient
    norm within rtol 1e-4.  The updated parameters are not compared: from
    fresh moments AdamW moves each entry by about lr * sign(g), so an entry
    whose gradient is near 0 steps apart on the two devices (1 of 8,192
    entries of a recurrentgemma-2b MLP leaf differed by 1.03e-5 after two
    steps, against a 1e-4-of-largest bound of 8.4e-6)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import train_batch
    from repro_torch.models import init_model
    from repro_torch.train import train_loop
    dev = _cuda()
    cfg = get_smoke_config(arch)
    batch = train_batch(cfg, 8, 64, step=0)
    runs = {}
    for d in ("cpu", dev):
        model = init_model(cfg, seed=4, device=d)
        loss, grads = train_loop.grads_fn(model, batch)
        state = train_loop.init_train_state(model)
        state = state._replace(step=torch.full_like(state.step, 100))
        state, m = train_loop.make_train_step(cfg, base_lr=3e-3)(state,
                                                                 batch)
        assert all(bool(torch.isfinite(p).all())
                   for p in state.model.parameters())
        runs[str(d)] = (float(loss), {k: g.cpu() for k, g in grads.items()},
                        {k: float(v) for k, v in m.items()})
    (lc, gc, mc), (lg, gg, mg) = runs["cpu"], runs[str(dev)]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for name, b in gc.items():
        np.testing.assert_allclose(gg[name].numpy(), b.numpy(), rtol=0,
                                   atol=1e-4 * float(b.abs().max()),
                                   err_msg=name)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(mg[k], mc[k], rtol=1e-4, err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen3-4b", "qwen3-32b",
                                  "llama3-405b"])
def test_gpu_dense_smoke_roundtrip(arch):
    """The SMOKE model on the card, 4 lanes x 40 tokens, chunk 16: kernel
    and coder containers byte-identical, the fused decode exact with one
    B1 launch and one B2 and one B6 launch per position (one more B6 for
    the compress side's batch); its float32 steps against the same weights
    on the CPU within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode_step, init_model, init_state
    from repro_torch.serve import compress
    dev = _cuda()
    cfg = get_smoke_config(arch)
    model = init_model(cfg, seed=2, device=dev)
    toks = token_stream(cfg.vocab_size, (4, 40), seed=5)

    def blob(backend):
        st = compress.lm_compress_chunked(model, toks, 16, backend=backend)
        return bitstream.pack_chunked(*st.chunks, chunk_size=16,
                                      n_symbols=40)

    b = blob("coder")
    before = dict(LAUNCHES)
    assert blob("kernel") == b
    sym, _ = compress.lm_decompress_chunked(
        model, bitstream.parse_chunked(b), 40, 16, backend="kernel")
    torch.cuda.synchronize()
    want = {"rans_encode_lanes": 1, "rans_decode_step": 40,
            "spc_quantize": 41}
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == {
        k: want.get(k, 0) for k in LAUNCHES}
    assert np.array_equal(sym.cpu().numpy(), toks)
    cpu = init_model(cfg, seed=2, device="cpu")
    states = [init_state(m, 2, 16) for m in (cpu, model)]
    t_in = torch.as_tensor(toks[:2])
    for t in range(12):
        lg = [decode_step(m, st, t_in[:, t:t + 1].to(m.embedding.device), t)
              for m, st in zip((cpu, model), states)]
        assert float((lg[1].cpu() - lg[0]).abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("k", [256, 4096, 32768])
def test_gpu_topk_matches_cpu_on_ties(k):
    """``model_topk_candidates`` (a stable descending sort) on the card
    equals the CPU's, largest first and the lower index first among
    equals: all-zero rows, integer-valued rows, rows of -inf with a few
    finite entries, and BF16 logits; ``topk_first`` routes router
    probabilities as on the CPU."""
    dev = _cuda()
    rng = np.random.default_rng(k)
    inf = np.full((4, k), -np.inf, np.float32)
    inf[:, rng.integers(0, k, 3)] = 0.0
    xs = [torch.zeros((16, k)),
          torch.as_tensor(rng.integers(-3, 3, (16, k)).astype(np.float32)),
          torch.as_tensor(inf),
          torch.as_tensor(rng.normal(0, 2, (16, k)).astype(
              np.float32)).to(torch.bfloat16)]
    for x in xs:
        for topk in (1, 4):
            assert torch.equal(
                predictors.model_topk_candidates(x.to(dev), topk).cpu(),
                predictors.model_topk_candidates(x, topk))
    probs = torch.softmax(torch.as_tensor(rng.normal(
        0, 0.5, (512, 8)).astype(np.float32)).to(torch.bfloat16).float(), -1)
    for got, want in zip(predictors.topk_first(probs.to(dev), 2),
                         predictors.topk_first(probs, 2)):
        assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# cross attention and the encoder-decoder (the vlm and audio SMOKE models)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_gpu_encdec_smoke_matches_cpu(arch):
    """The same float32 weights and inputs on the card and on the CPU:
    the memory (``train_batch``'s patch embeddings, or ``encode_memory``
    of its encoder inputs), a 24-token forward's logits, 12 decode steps
    with memory and greedy ``generate`` (6 new tokens) within 1e-4, the
    same tokens; one train step with ``grad_accum = 2`` (the memory split
    with the tokens): loss within rtol 1e-5, every gradient leaf within
    1e-4 of its largest entry, the step's loss and gradient norm within
    rtol 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import train_batch
    from repro_torch.models import (decode_step, encode_memory, init_model,
                                    init_state)
    from repro_torch.serve.engine import generate
    from repro_torch.train import train_loop
    dev = _cuda()
    cfg = get_smoke_config(arch).with_(grad_accum=2)
    batch = train_batch(cfg, 2, 24, step=0, seed=3)
    runs = {}
    for d in ("cpu", dev):
        model = init_model(cfg, seed=4, device=d)
        tok = torch.as_tensor(batch["tokens"], dtype=torch.int64, device=d)
        with torch.no_grad():
            mem = (torch.as_tensor(batch["memory"], device=d)
                   if "memory" in batch else encode_memory(
                       model, torch.as_tensor(batch["enc_inputs"],
                                              device=d)))
            fwd = model._logits(model(tok, memory=mem)[0])
        state = init_state(model, 2, 12)
        steps = torch.stack([decode_step(model, state, tok[:, t:t + 1], t,
                                         memory=mem) for t in range(12)], 1)
        gen, glg = generate(model, tok[:, :6], 6, max_len=16, memory=mem,
                            return_logits=True)
        loss, grads = train_loop.grads_fn(model, batch)
        st = train_loop.init_train_state(model)
        st = st._replace(step=torch.full_like(st.step, 100))
        st, m = train_loop.make_train_step(cfg, base_lr=3e-3)(st, batch)
        assert all(bool(torch.isfinite(p).all())
                   for p in st.model.parameters())
        runs[str(d)] = dict(
            mem=mem.cpu(), fwd=fwd.cpu(), steps=steps.cpu(), gen=gen.cpu(),
            glg=glg.cpu(), loss=float(loss),
            grads={k: g.cpu() for k, g in grads.items()},
            m={k: float(v) for k, v in m.items()})
    c, g = runs["cpu"], runs[str(dev)]
    for k in ("mem", "fwd", "steps", "glg"):
        assert bool(torch.isfinite(g[k]).all()), k
        assert float((g[k] - c[k]).abs().max()) <= 1e-4, k
    assert torch.equal(g["gen"], c["gen"])
    np.testing.assert_allclose(g["loss"], c["loss"], rtol=1e-5)
    for name, b in c["grads"].items():
        np.testing.assert_allclose(g["grads"][name].numpy(), b.numpy(),
                                   rtol=0, atol=1e-4 * float(b.abs().max()),
                                   err_msg=name)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(g["m"][k], c["m"][k], rtol=1e-4,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# checkpoints and the restart manager on the card
# ---------------------------------------------------------------------------

def _card_train_state(dev, dtype: str, seed: int):
    from repro_torch.configs.ras_pimc import SMOKE
    from repro_torch.models import init_model
    from repro_torch.train import train_loop
    cfg = SMOKE.with_(dtype=dtype, grad_accum=1)
    return cfg, train_loop.init_train_state(init_model(cfg, seed=seed,
                                                       device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_checkpoint_roundtrip(dtype, tmp_path):
    """A train state on the card, two steps in, through ``save`` (npz on
    the host) and back onto a fresh state on the card bitwise, bfloat16
    leaves included; ``save(blocking=False)`` holds the values of the call
    even when the card's tensors change at once."""
    import time

    from repro_torch.data.pipeline import train_batch
    from repro_torch.train import checkpoint, train_loop
    dev = _cuda()
    cfg, state = _card_train_state(dev, dtype, seed=3)
    step = train_loop.make_train_step(cfg, base_lr=3e-3)
    state = state._replace(step=torch.full_like(state.step, 100))
    for i in range(2):
        state, _ = step(state, train_batch(cfg, 4, 32, step=i))
    checkpoint.save(str(tmp_path / "sync"), 102, state)
    _, fresh = _card_train_state(dev, dtype, seed=9)
    checkpoint.restore(str(tmp_path / "sync"), 102, fresh)
    for (name, a), b in zip(state.model.named_parameters(),
                            fresh.model.parameters()):
        assert b.device == a.device and b.dtype == a.dtype
        assert torch.equal(a, b), name
    for k in state.opt.m:
        assert torch.equal(state.opt.m[k], fresh.opt.m[k])
        assert torch.equal(state.opt.v[k], fresh.opt.v[k])
    assert int(fresh.step) == int(state.step) == 102
    assert int(fresh.opt.step) == int(state.opt.step) == 2
    before = state.model.embedding.detach().clone()
    checkpoint.save(str(tmp_path / "async"), 5, state, blocking=False)
    with torch.no_grad():
        state.model.embedding.add_(1.0)
    deadline = time.monotonic() + 60
    while checkpoint.latest_step(str(tmp_path / "async")) != 5:
        assert time.monotonic() < deadline, "the writer thread never published"
        time.sleep(0.01)
    _, late = _card_train_state(dev, dtype, seed=9)
    checkpoint.restore(str(tmp_path / "async"), 5, late)
    assert torch.equal(late.model.embedding, before)


@pytest.mark.gpu
def test_gpu_restart_manager_recovers_bitwise(tmp_path):
    """Ten train steps on the card under a ``RestartManager`` saving every
    5, one fault injected before step 7 (restored from step 5), against an
    unbroken run: every parameter and moment bitwise equal under the
    card's deterministic settings."""
    from repro_torch.data.pipeline import train_batch
    from repro_torch.train import fault_tolerance, train_loop
    dev = _cuda()
    runs = []
    for fault in (7, None):
        cfg, state = _card_train_state(dev, "float32", seed=4)
        state = state._replace(step=torch.full_like(state.step, 0))
        step = train_loop.make_train_step(cfg, base_lr=3e-2)
        fired = []

        def hook(i, fault=fault, fired=fired):
            if i == fault and not fired:
                fired.append(i)
                raise RuntimeError(f"injected fault before step {i}")

        mgr = fault_tolerance.RestartManager(str(tmp_path / str(fault)),
                                             save_every=5)
        state = mgr.run(state, step,
                        lambda i: train_batch(cfg, 4, 32, step=i), 10,
                        fault_hook=hook)
        runs.append((state, mgr.failures))
    (broken, n_broken), (clean, n_clean) = runs
    assert (n_broken, n_clean) == (1, 0)
    assert int(broken.step) == int(clean.step) == 10
    for (name, a), b in zip(broken.model.named_parameters(),
                            clean.model.parameters()):
        assert torch.equal(a, b), name
    for k in broken.opt.m:
        assert torch.equal(broken.opt.m[k], clean.opt.m[k])
        assert torch.equal(broken.opt.v[k], clean.opt.v[k])


# ---------------------------------------------------------------------------
# placement: chunk and lane meshes over torch.distributed (NCCL, world 1)
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl1(tmp_path):
    """The card as a world-1 NCCL group over a ``FileStore`` (no TCP
    store), destroyed after the test."""
    import datetime

    import torch.distributed as dist
    dev = _cuda()
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()),
        timeout=datetime.timedelta(seconds=60))
    yield dev
    dist.destroy_process_group()


@pytest.mark.gpu
def test_gpu_production_mesh_round_trip(nccl1):
    """``launch.mesh.make_mesh_for(1)`` on a world-1 NCCL group is a
    (1, 1) ``("data", "model")`` device mesh on the card, and
    ``parallel.sharding.shard_params`` then ``unshard`` of the full-width
    ``ras-pimc`` parameters gives them back bitwise."""
    from repro_torch.configs.ras_pimc import CONFIG
    from repro_torch.launch.mesh import make_mesh_for, mesh_shape_of
    from repro_torch.models import init_model
    from repro_torch.parallel import sharding

    dm = make_mesh_for(1)
    shape = mesh_shape_of(dm)
    assert (shape.axis_names, shape.sizes) == (("data", "model"), (1, 1))
    assert dm.device_type == "cuda"
    model = init_model(CONFIG, seed=0, device=nccl1, draw="device")
    full = {k: p.detach() for k, p in model.named_parameters()}
    specs = sharding.param_specs(model, shape)
    local = sharding.shard_params(full, specs, dm)
    assert all(local[k].is_cuda for k in full)
    back = sharding.unshard(local, specs, dm)
    assert all(torch.equal(back[k], full[k]) for k in full)


def _launches(fn):
    from repro_torch.kernels import reset_launches
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in LAUNCHES.items() if v}


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["static", "perpos", "lane"])
def test_gpu_chunk_mesh_matches_single_device_kernels(nccl1, layout):
    """``parallel.encode_chunked`` / ``decode_chunked`` on a world-1 chunk
    mesh (4 full chunks of 128 and a tail of 40, top-4 candidates): one
    B1 for the slab and one for the tail, byte-identical to
    ``ops.rans_encode_chunked`` and the coder; the decode from dense
    chunks and from the parsed container equal to the single-device B3
    in symbols and per-lane probes."""
    from repro_torch.parallel import chunked as pc
    dev = nccl1
    tt, syms = _case(layout, seed=8, k=256, lanes=128, t=4 * 128 + 40)
    tbl = spc.TableSet(*(a.to(dev) for a in tt))
    sym = torch.as_tensor(syms, device=dev)
    t = sym.shape[1]
    cands = torch.as_tensor(candidate_planes(syms, 256, 4, 0.6, seed=8),
                            device=dev)
    mesh = pc.chunk_mesh(device=dev)
    enc, n = _launches(lambda: pc.encode_chunked(sym, tbl, 128, mesh=mesh,
                                                 backend="kernel"))
    assert n == {"rans_encode_lanes": 2}
    _assert_planes_equal(enc, ops.rans_encode_chunked(sym, tbl, 128))
    _assert_planes_equal(enc, coder.encode_chunked(sym, tbl, 128))
    want = ops.rans_decode_chunked(enc, t, tbl, 128, candidates=cands,
                                   lane_probes=True)
    assert torch.equal(want[0], sym.to(torch.int32))
    cs = bitstream.parse_chunked(bitstream.pack_chunked(
        *enc, chunk_size=128, n_symbols=t))
    for src in (enc, cs):
        got, n = _launches(lambda: pc.decode_chunked(
            src, t, tbl, 128, mesh=mesh, backend="kernel",
            candidates=cands, lane_probes=True))
        assert n == {"rans_decode_lanes": 2}
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[2], want[2])
        assert float(got[1]) == float(want[1])


@pytest.mark.gpu
def test_gpu_two_rank_chunk_emulation():
    """Ranks 0 and 1 of a 2-rank chunk mesh run in turn on the card
    (``encode_slab``, ``decode_slab``: functions of the rank and size
    alone) and stitched equal the single-device kernels on the full
    chunks."""
    from repro_torch.parallel import chunked as pc
    dev = _cuda()
    tt, syms = _case("lane", seed=9, k=256, lanes=128, t=512)
    tbl = spc.TableSet(*(a.to(dev) for a in tt))
    sym = torch.as_tensor(syms, device=dev)
    whole = ops.rans_encode_chunked(sym, tbl, 128)
    slabs = [pc.encode_slab(sym, tbl, 128, r, 2, backend="kernel")
             for r in (0, 1)]
    for a, *parts in zip(whole, *slabs):
        assert torch.equal(a, torch.cat(parts))
    want = ops.rans_decode_chunked(whole, 512, tbl, 128, chunk_probes=True)
    outs = [pc.decode_slab(bitstream.ChunkedLanes(*whole[:3]), 512, tbl,
                           128, r, 2, backend="kernel") for r in (0, 1)]
    assert torch.equal(torch.cat([o[0] for o in outs], 1), want[0])
    assert torch.equal(torch.cat([o[1] for o in outs]),
                       want[2].to(torch.int64))
    assert not bool(torch.cat([o[2] for o in outs]).any())


def _int8_reduce_card_and_host(dev, groups=None):
    import torch.distributed as dist
    from repro_torch.parallel import collectives as col
    rng = np.random.default_rng(12)
    grads = {k: torch.as_tensor((rng.normal(size=s) * 10.0 ** -i)
                                .astype(np.float32))
             for i, (k, s) in enumerate((("a", (256, 64)), ("b", (1000,)),
                                         ("c", (3, 5, 7)), ("d", (256, 64))))}
    errs = {k: torch.as_tensor((rng.normal(size=g.shape) * 1e-3)
                               .astype(np.float32)) for k, g in grads.items()}
    card = col.compressed_psum_tree(
        {k: g.to(dev) for k, g in grads.items()}, col.pod_mesh(device=dev),
        {k: e.to(dev) for k, e in errs.items()}, groups=groups)
    host = col.compressed_psum_tree(
        grads, col.pod_mesh(dist.new_group(backend="gloo"), device="cpu"),
        errs, groups=groups)
    for a, b in zip(card, host):
        for k in grads:
            assert torch.equal(a[k].cpu(), b[k]), k
    return host


@pytest.mark.gpu
def test_gpu_int8_reduce_matches_cpu(nccl1):
    """``compressed_psum_tree`` on the card's pod mesh equals the same
    reduce on a gloo CPU group, bitwise (means and residuals)."""
    _int8_reduce_card_and_host(nccl1)


@pytest.mark.gpu
def test_gpu_grouped_int8_reduce_matches_cpu(nccl1):
    """With ``groups=`` (``a`` and ``d``, the repeats of one stacked leaf,
    share a scale, ``d`` 1000x smaller): the card's reduce equals the
    gloo CPU group's bitwise, and ``d`` quantizes with ``a``'s scale
    (its codes are near zero)."""
    out, _ = _int8_reduce_card_and_host(
        nccl1, groups={"a": "ad", "b": "b", "c": "c", "d": "ad"})
    alone, _ = _int8_reduce_card_and_host(nccl1)
    assert not torch.equal(out["d"], alone["d"])
    assert torch.equal(out["b"], alone["b"])


@pytest.mark.gpu
def test_gpu_lane_mesh_smoke_roundtrip(nccl1):
    """``ras-pimc`` SMOKE on the card on a world-1 lane mesh: the compress
    priced per lane slab gives the unplaced container, the fused decode on
    the mesh round-trips with the unplaced per-lane probes, two-pass pass 2
    on a chunk mesh gives the same symbols; a chunk mesh given to the fused
    path raises."""
    from repro_torch.configs.ras_pimc import SMOKE
    from repro_torch.models import init_model
    from repro_torch.parallel import chunked as pc
    from repro_torch.serve import compress
    dev = nccl1
    model = init_model(SMOKE, seed=0, device=dev)
    toks = token_stream(SMOKE.vocab_size, (8, 48), seed=3)
    lane, chunk = pc.lane_mesh(device=dev), pc.chunk_mesh(device=dev)
    st = compress.lm_compress_chunked(model, toks, 16, backend="kernel")
    placed = compress.lm_compress_chunked(model, toks, 16, backend="kernel",
                                          mesh=lane)
    _assert_planes_equal(placed.chunks, st.chunks)
    want = compress.lm_decompress_chunked(model, st.chunks, 48, 16,
                                          backend="kernel", lane_probes=True)
    got = compress.lm_decompress_chunked(model, st.chunks, 48, 16,
                                         backend="kernel", mesh=lane,
                                         lane_probes=True)
    assert np.array_equal(got[0].cpu().numpy(), toks)
    assert torch.equal(got[2], want[2])
    two = compress.lm_decompress_chunked(model, st.chunks, 48, 16,
                                         backend="two_pass", mesh=chunk)
    assert torch.equal(two[0], got[0]) and float(two[1]) == float(got[1])
    with pytest.raises(ValueError, match="lanes"):
        compress.lm_decompress_chunked(model, st.chunks, 48, 16,
                                       backend="kernel", mesh=chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("ras-pimc", "mamba2-130m"))
def test_gpu_placed_engine_blobs(nccl1, arch):
    """A SMOKE model placed for compute on ``make_mesh_for(1)`` served by
    ``BatchEngine`` on the card (the kernel step backend): its blobs equal
    the unplaced engine's and the placed single-request
    ``lm_compress_chunked``'s, and the first decompresses exactly through
    the placed engine."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import init_model
    from repro_torch.parallel import sharding
    from repro_torch.serve import compress
    from repro_torch.serve.engine import BatchEngine
    dev = nccl1
    cfg = get_smoke_config(arch)
    model = init_model(cfg, seed=0, device=dev)
    placed = sharding.place_model(model, make_mesh_for(1, device=dev))
    lanes, chunk = 4, 16
    toks = [token_stream(cfg.vocab_size, (lanes, n), seed=70 + i)
            for i, n in enumerate((40, 23, 33))]

    def serve(m):
        eng = BatchEngine(m, slots=2, lanes=lanes, chunk_size=chunk,
                          max_len=48, step_backend="kernel")
        rids = [eng.submit_compress(t, arrival=float(i))
                for i, t in enumerate(toks)]
        res = eng.run()
        return eng, [res[r].blob for r in rids]

    eng, blobs = serve(placed)
    assert blobs == serve(model)[1]
    for t, blob in zip(toks, blobs):
        assert blob == bitstream.pack_chunked(*compress.lm_compress_chunked(
            placed, t, chunk, backend="kernel").chunks, chunk_size=chunk,
            n_symbols=t.shape[1])
    rd = eng.submit_decompress(blobs[0])
    got = eng.run()[rd]
    assert got.ok
    np.testing.assert_array_equal(got.tokens, toks[0])
