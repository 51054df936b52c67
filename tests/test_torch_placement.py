"""The port's placement (``repro_torch.parallel.chunked``, ``mesh=``
through ``serve.compress`` and ``serve.engine``) against JAX's (CPU, gloo).

The rank programs live in ``tests/_torch_ranks.py`` (torch and the port
only): a world-1 group runs in this process, groups of 2 and 4 ranks are
spawned once per file over a ``FileStore``, each rank writing what it
returned.  Inputs are made from seeds with numpy on both sides.

* ``parallel.encode_chunked`` / ``decode_chunked`` on 1, 2 and 4 ranks,
  both backends, static, per-position and per-lane tables, a ragged tail,
  top-2 candidates, dense chunks and a ``ContainerSlab``, a predictor: every
  rank's streams, overflow flags and symbols equal JAX's
  ``parallel.chunked`` with ``mesh=None`` byte for byte, and the probe
  average exactly; the kernel backend also equals JAX's path on its
  one-device chunk mesh.  An indivisible chunk count falls back; a
  truncated stream raises ``StreamExhaustedError`` on every rank (the
  port's counterpart of ``test_parallel_decode_chunked_truncated_raises``,
  held against JAX's no-mesh coder path).  ``bench_chunked`` takes the
  chunk mesh when more than one rank is up.
* The LM paths at ``ras-pimc`` SMOKE on 2 ranks: compress priced per lane
  slab equals the unplaced container (the row-invariance pin on the CPU),
  the fused decode on a lane mesh and two-pass pass 2 on a chunk mesh
  round-trip with the unplaced probes, the reference's refusals and their
  words, a truncated container raising on every rank.
* ``BatchEngine(mesh=)`` on 2 ranks: whole slots per rank, every blob the
  single-request blob, each rank's state the rows of the unplaced engine's
  state (the protocol's row-axis pin); ``slots=1`` falls back.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import _torch_ranks as R
from repro.core import coder as jcoder, predictors as jpred, spc as jspc
from repro.core.coder import StreamExhaustedError as JStreamExhaustedError
from repro.parallel import chunked as jpc
from repro_torch.core import bitstream
from repro_torch.parallel import Mesh, MeshError, make_mesh
from repro_torch.parallel import chunked as pc

jax.config.update("jax_platforms", "cpu")

WORLDS = (1, 2, 4)
BACKENDS = ("coder", "kernel")
ENC = ("buf", "start", "length", "overflow")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The file's spawned groups, started together at once: the chunked
    suite on 2 and 4 ranks, the LM suite on 2."""
    tmp = tmp_path_factory.mktemp("ranks")
    return {("chunked", 2): R.RankJob("chunked", 2, tmp),
            ("chunked", 4): R.RankJob("chunked", 4, tmp),
            ("lm", 2): R.RankJob("lm", 2, tmp)}


@pytest.fixture(scope="module")
def chunked(jobs, tmp_path_factory):
    """{world: [each rank's results]} of ``_torch_ranks.chunked_suite``."""
    one = [R.in_process("chunked", tmp_path_factory.mktemp("world1"))]
    return {1: one, 2: jobs["chunked", 2].results(),
            4: jobs["chunked", 4].results()}


def _jcase(layout, seed, t=R.T):
    probs, syms, cands = R.chunk_case(layout, seed, t)
    return jspc.tables_from_probs(jnp.asarray(probs)), syms, cands


def _ranks_equal(ranks, key):
    for r, res in enumerate(ranks[1:], 1):
        np.testing.assert_array_equal(res[key], ranks[0][key],
                                      err_msg=f"rank {r} {key}")
    return ranks[0][key]


def _enc_equal(ranks, key, jenc):
    for f in ENC:
        np.testing.assert_array_equal(_ranks_equal(ranks, f"{key}/{f}"),
                                      np.asarray(getattr(jenc, f)),
                                      err_msg=f"{key}/{f}")


def _dec_equal(ranks, key, jsym, javg):
    np.testing.assert_array_equal(_ranks_equal(ranks, f"{key}/sym"),
                                  np.asarray(jsym))
    assert _ranks_equal(ranks, f"{key}/avg") == np.float32(javg)
    lp = _ranks_equal(ranks, f"{key}/lane_probes")
    assert np.float32(lp.sum()) / np.float32(lp.size * jsym.shape[1]) == \
        np.float32(javg)


@pytest.fixture(scope="module")
def jax_ref(jobs):
    """JAX's ``parallel.chunked`` with ``mesh=None`` on every case."""
    out = {}
    for i, layout in enumerate(R.LAYOUTS):
        jt, syms, cands = _jcase(layout, 70 + i)
        for be in BACKENDS:
            enc = jpc.encode_chunked(jnp.asarray(syms), jt, R.CHUNK,
                                     backend=be)
            out[layout, be] = (enc, jpc.decode_chunked(
                enc, R.T, jt, R.CHUNK, backend=be,
                candidates=jnp.asarray(cands)))
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("layout", R.LAYOUTS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_placed_codec_matches_jax(jax_ref, chunked, world, layout, backend):
    ranks = chunked[world]
    assert [int(r["size"]) for r in ranks] == [world] * world
    assert [int(r["rank"]) for r in ranks] == list(range(world))
    enc, (jsym, javg) = jax_ref[layout, backend]
    key = f"{layout}/{backend}"
    _enc_equal(ranks, f"{key}/enc", enc)
    _, syms, _ = R.chunk_case(layout, 70 + R.LAYOUTS.index(layout))
    np.testing.assert_array_equal(np.asarray(jsym), syms)
    _dec_equal(ranks, f"{key}/dec", jsym, javg)
    _dec_equal(ranks, f"{key}/slab", jsym, javg)


@pytest.mark.parametrize("layout", R.LAYOUTS)
def test_kernel_backend_matches_jax_one_device_mesh(chunked, layout):
    """JAX's kernel path on its one-device chunk mesh (shard_map with
    ``check_rep`` off) against the port's on 2 ranks: the same streams and
    symbols; the probe average within float32 rounding (the reference sums
    per-chunk averages, the port exact per-chunk counts)."""
    jt, syms, cands = _jcase(layout, 70 + R.LAYOUTS.index(layout))
    mesh = jpc.chunk_mesh()
    enc = jpc.encode_chunked(jnp.asarray(syms), jt, R.CHUNK, mesh=mesh,
                             backend="kernel")
    sym, avg = jpc.decode_chunked(enc, R.T, jt, R.CHUNK, mesh=mesh,
                                  backend="kernel",
                                  candidates=jnp.asarray(cands))
    ranks = chunked[2]
    _enc_equal(ranks, f"{layout}/kernel/enc", enc)
    np.testing.assert_array_equal(ranks[0][f"{layout}/kernel/dec/sym"],
                                  np.asarray(sym))
    np.testing.assert_allclose(ranks[1][f"{layout}/kernel/dec/avg"],
                               float(avg), rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_predictor_indivisible_and_overflow_match_jax(chunked, world,
                                                      backend):
    """A predictor inside every chunk; 3 full chunks of 20 (placed on one
    rank, the single-device program on 2 and 4); a cap of 12 bytes whose
    cells come back truncated and flagged."""
    ranks = chunked[world]
    jt, syms, _ = _jcase("static", 80)
    js = jnp.asarray(syms)
    enc = jpc.encode_chunked(js, jt, R.CHUNK, backend=backend)
    jsym, javg = jpc.decode_chunked(enc, R.T, jt, R.CHUNK, backend=backend,
                                    predictor=jpred.NeighborAverage(2, 4))
    _dec_equal(ranks, f"predictor/{backend}/dec", jsym, javg)
    enc = jpc.encode_chunked(js, jt, 20, backend=backend)
    _enc_equal(ranks, f"indivisible/{backend}/enc", enc)
    _dec_equal(ranks, f"indivisible/{backend}/dec",
               *jpc.decode_chunked(enc, R.T, jt, 20, backend=backend))
    enc = jpc.encode_chunked(js, jt, R.CHUNK, cap=12, backend=backend)
    assert np.asarray(enc.overflow).any()
    _enc_equal(ranks, f"overflow/{backend}/enc", enc)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_truncated_stream_raises_on_every_rank(chunked, world, backend):
    ranks = chunked[world]
    jt, syms, _ = _jcase("static", 81, t=64)
    np.testing.assert_array_equal(
        _ranks_equal(ranks, f"truncated/{backend}/dec/sym"), syms)
    for res in ranks:
        err = str(res[f"truncated/{backend}/error"])
        assert err.startswith("StreamExhaustedError: parallel.decode_"
                              "chunked"), err
    ch = jcoder.encode_chunked(jnp.asarray(syms), jt, R.CHUNK)
    cut = jcoder.ChunkedLanes(*(jnp.asarray(a) for a in
                                R.truncate_last_chunk(*ch[:3], 2)))
    with pytest.raises(JStreamExhaustedError):
        jpc.decode_chunked(cut, 64, jt, R.CHUNK)


@pytest.mark.parametrize("world", WORLDS)
def test_bench_chunked_takes_the_chunk_mesh(chunked, world):
    """``bench_chunked`` places its points on a chunk mesh when a group of
    more than one rank is up (the reference's rule) and writes its size
    under ``devices``; the bits are the single-device run's."""
    from repro_torch.benchmarks import bench_chunked
    ranks = chunked[world]
    for p in bench_chunked.run(**R.BENCH_POINT, device="cpu", warmup=False):
        key = f"bench/{p['name']}"
        assert p["devices"] == 1
        assert _ranks_equal(ranks, f"{key}/devices") == (
            world if world > 1 else 1)
        assert _ranks_equal(ranks, f"{key}/bits") == p["bits_per_symbol"]


def _fake(axis, size, rank=0):
    return Mesh(axis=axis, group=None, size=size, rank=rank,
                device=torch.device("cpu"))


def test_routing_contract():
    """The reference's routing: a chunk mesh places a chunk count it
    divides (size 1 included); a lane mesh a row count it divides; a lane
    program given a mesh of another axis raises with the reference's
    words; no process group, no mesh."""
    assert pc._usable(_fake("chunks", 1), 3)
    assert pc._usable(_fake("chunks", 2), 4)
    assert not pc._usable(_fake("chunks", 2), 3)
    assert not pc._usable(_fake("chunks", 2), 0)
    assert not pc._usable(_fake("lanes", 2), 4)
    assert not pc._usable(None, 4)
    assert pc.lane_mesh_usable(_fake("lanes", 2), 4)
    assert not pc.lane_mesh_usable(_fake("lanes", 3), 4)
    assert not pc.lane_mesh_usable(None, 4)
    with pytest.raises(ValueError, match="lane_mesh.*two_pass"):
        pc.lane_mesh_usable(_fake("chunks", 1), 4)
    assert [_fake("chunks", 4, r).slab(8) for r in range(4)] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]
    assert not torch.distributed.is_initialized()
    with pytest.raises(MeshError, match="init_process_group"):
        make_mesh("chunks", device="cpu")
    with pytest.raises(MeshError):
        pc.lane_mesh(device="cpu")


# ---------------------------------------------------------------------------
# the LM paths and the engine on a lane mesh of 2 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm(jobs):
    return jobs["lm", 2].results()


@pytest.fixture(scope="module")
def unplaced():
    """The port's unplaced results on the LM suite's inputs."""
    from repro_torch.serve import compress
    model = R._smoke_model()
    toks = R.lm_tokens()
    st = compress.lm_compress_chunked(model, toks, R.LM_CHUNK,
                                      backend="kernel", device="cpu")
    dec = compress.lm_decompress_chunked(model, st.chunks, R.LM_T,
                                         R.LM_CHUNK, backend="kernel",
                                         device="cpu", lane_probes=True)
    mono = compress.lm_compress(model, toks, backend="kernel", device="cpu")
    return dict(model=model, toks=toks, chunks=st.chunks, dec=dec,
                mono=mono.enc, bits=st.bits_per_symbol)


def test_lane_placed_compress_matches_unplaced(lm, unplaced):
    """Each rank prices its lane slab as its own model call; on the CPU at
    SMOKE the slab's rows price as inside the whole batch, so the placed
    containers are the unplaced ones byte for byte (the row-invariance pin:
    ROADMAP C)."""
    for be in BACKENDS:
        for f in ENC:
            want = unplaced["chunks"]._asdict()[f].numpy()
            np.testing.assert_array_equal(
                _ranks_equal(lm, f"placed/{be}/{f}"), want)
            np.testing.assert_array_equal(_ranks_equal(lm, f"whole/{f}"),
                                          want)
        assert _ranks_equal(lm, f"placed/{be}/bits") == float(
            unplaced["bits"])
    for f in ENC:
        np.testing.assert_array_equal(_ranks_equal(lm, f"mono/enc/{f}"),
                                      unplaced["mono"]._asdict()[f].numpy())


def test_lane_placed_decode_round_trips(lm, unplaced):
    sym, avg, lane_probes = unplaced["dec"]
    np.testing.assert_array_equal(sym.numpy(), unplaced["toks"])
    for key in ("fused/placed", "fused/whole_slab"):
        np.testing.assert_array_equal(_ranks_equal(lm, f"{key}/sym"),
                                      unplaced["toks"])
        np.testing.assert_array_equal(
            _ranks_equal(lm, f"{key}/lane_probes"), lane_probes.numpy())
        assert _ranks_equal(lm, f"{key}/avg") == float(avg)
    np.testing.assert_array_equal(_ranks_equal(lm, "two_pass/chunks/sym"),
                                  unplaced["toks"])
    assert _ranks_equal(lm, "two_pass/chunks/avg") == float(avg)
    np.testing.assert_array_equal(_ranks_equal(lm, "mono/dec/sym"),
                                  unplaced["toks"])


def test_lane_placed_refusals_and_exhaustion(lm):
    """The reference's refusals (``tests/test_serve_compress.py``) with its
    words, and a truncated container, raise alike on every rank."""
    want = {"refuse/lane_probes": "ValueError: lane_probes requires mesh",
            "refuse/chunk_mesh_fused": "ValueError: the fused decode "
                                       "(backend='kernel') parallelizes "
                                       "over the lane axis",
            "refuse/coder_mesh": "ValueError: mesh= requires "
                                 "backend='kernel' or 'two_pass'",
            "refuse/mono_coder_mesh": "ValueError: mesh= requires "
                                      "backend='kernel'",
            "truncated/error": "StreamExhaustedError: "
                               "lm_decompress_chunked"}
    for key, head in want.items():
        assert str(_ranks_equal(lm, key)).startswith(head), key


def test_engine_on_lane_mesh(lm, unplaced):
    """Whole slots per rank (slot i on rank i * size // slots): every blob
    equals the single-request blob and the decompress round-trips with its
    probes, under the cycle clock and rank 0's wall clock; each rank's
    state is its rows of the unplaced engine's state; ``slots=1`` (one
    slot, two ranks) falls back to the single-device program."""
    from repro_torch.serve import compress
    from repro_torch.serve.engine import BatchEngine
    model = unplaced["model"]
    blobs = []
    for toks in R.engine_tokens():
        st = compress.lm_compress_chunked(model, toks, 8, backend="kernel",
                                          device="cpu")
        blobs.append(bitstream.pack_chunked(*st.chunks, chunk_size=8,
                                            n_symbols=toks.shape[1]))
    want_tok, _, want_probes = compress.lm_decompress_chunked(
        model, bitstream.parse_chunked(blobs[0]), 20, 8, backend="kernel",
        device="cpu", lane_probes=True)
    for slots, clock, placed in ((2, "virtual", True), (2, "wall", True),
                                 (1, "virtual", False)):
        key = f"engine/s{slots}/{clock}"
        assert [bool(r[f"{key}/placed"]) for r in lm] == [placed] * 2
        # one slot of 2 lanes a rank placed; both slots' rows unplaced
        assert [int(r[f"{key}/local_rows"]) for r in lm] == (
            [2, 2] if placed else [2, 2])
        for i, blob in enumerate(blobs):
            assert _ranks_equal(lm, f"{key}/blob{i}").tobytes() == blob
        np.testing.assert_array_equal(_ranks_equal(lm, f"{key}/tokens"),
                                      want_tok.numpy())
        np.testing.assert_array_equal(
            _ranks_equal(lm, f"{key}/lane_probes"), want_probes.numpy())
    eng = BatchEngine(model, slots=2, lanes=2, chunk_size=8, max_len=24,
                      step_backend="kernel", device="cpu")
    rids = [eng.submit_compress(t, arrival=float(i))
            for i, t in enumerate(R.engine_tokens())]
    eng.submit_decompress(eng.run()[rids[0]].blob)
    eng.run()
    assert _ranks_equal(lm, "engine/s2/virtual/prefill_cycles") == \
        eng.prefill_cycles
    for r, res in enumerate(lm):
        st = eng._states[r]
        np.testing.assert_array_equal(res["engine/s2/virtual/state_k"],
                                      st.k.numpy())
        np.testing.assert_array_equal(res["engine/s2/virtual/state_v"],
                                      st.v.numpy())
