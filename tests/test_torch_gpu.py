"""CUDA kernel tier: each kernel against its plain PyTorch version.

Marked ``gpu``; every test skips without a CUDA device.  The file imports
no JAX, so it runs on a GPU host without the reference package's
dependencies (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import coder, spc, u32
from repro_torch.core.bitstream import EncodedLanes
from repro_torch.device import configure_cuda_numerics
from repro_torch.kernels import rans_decode, rans_encode


def _t(a):
    return torch.as_tensor(np.array(a))


def _case(layout, seed, k, lanes, t):
    rng = np.random.default_rng(seed)
    shape = {"static": (), "perpos": (t,), "lane": (t, lanes)}[layout]
    probs = rng.dirichlet(np.full(k, 0.5), size=shape or None).astype(
        np.float32)
    syms = rng.integers(0, k, (lanes, t)).astype(np.int32)
    return spc.tables_from_probs(_t(probs)), syms


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
        before = rans_encode.LAUNCHES
        got = rans_encode.rans_encode_lanes(
            _t(syms).to(dev), spc.TableSet(*(a.to(dev) for a in tt)), cap,
            chunk)
        torch.cuda.synchronize()
        assert rans_encode.LAUNCHES == before + 1
        _assert_planes_equal(got, ref)


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


@pytest.mark.gpu
def test_gpu_slice_roundtrip_and_backends_identical():
    dev = _cuda()
    from repro_torch.configs.ras_pimc import SMOKE
    from repro_torch.core import bitstream
    from repro_torch.data.pipeline import token_stream
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
