"""The recurrent families through the serve stack on the port (CPU).

The round trips of ``tests/test_model_protocol.py`` on the port: the
reference's ``mamba2-130m`` (pure recurrent state) and
``recurrentgemma-2b`` (RG-LRU state + a 16-slot local-window ring) SMOKE
configs on seeded random weights, chunk 8, streams with a ragged tail.

* ``lm_compress_chunked`` on the kernel and coder backends gives
  byte-identical containers, and the fused kernel decode, the coder
  decode and the two-pass decode are bit-exact with equal per-lane
  probes (the kernel wrappers run their plain versions on the CPU);
* ``state_spec``, ``ring_length``, ``wrap_length`` and ``can_prefill``
  equal JAX's; the state's leaves have the rows on axis 1, start at
  zero, and ``recurrent_state_tree`` marks recurrent leaves as JAX's does;
* ``prefill_chunk`` and ``BatchEngine(prefill="force")`` raise
  ``PrefillUnsupportedError``;
* ``launch/serve.py --arch <arch> --device cpu`` compresses and decodes
  bit-exactly (``--mode compress``) and serves byte-identical engine
  blobs (``--mode engine``);
* the engine takes streams longer than ``max_len`` (the state never
  wraps), its blobs are byte-identical to the single-request path's and
  decode exactly, ``prefill="auto"`` steps down; a slot whose last chunk
  is short keeps its recurrent leaves bit for bit: after the run they
  equal the single-request state after the same tokens.

Integer outputs and engine states compare exactly.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import can_prefill as j_can_prefill
from repro.models import init_state as j_init_state
from repro.models import recurrent_state_tree as j_recurrent_state_tree
from repro.models import ring_length as j_ring_length
from repro.models import state_spec as j_state_spec
from repro.models import wrap_length as j_wrap_length
from repro_torch.configs import get_smoke_config
from repro_torch.core import bitstream
from repro_torch.data.pipeline import token_stream
from repro_torch.models import (PrefillUnsupportedError, can_prefill,
                                has_recurrent_state, init_model, init_state,
                                prefill_chunk, recurrent_state_tree,
                                ring_length, state_spec, wrap_length)
from repro_torch.launch import serve as launcher
from repro_torch.serve import compress
from repro_torch.serve.engine import BatchEngine

jax.config.update("jax_platforms", "cpu")

ARCHS = ("mamba2-130m", "recurrentgemma-2b")
CHUNK = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one CPU thread: its ops are small, and beside
    other busy test processes torch's idle worker threads spin for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def zoo():
    return {arch: init_model(get_smoke_config(arch), seed=0, device="cpu")
            for arch in ARCHS}


def _toks(model, lanes, t_len, seed):
    return token_stream(model.cfg.vocab_size, (lanes, t_len), seed=seed)


def _blob(model, toks, backend="coder"):
    st = compress.lm_compress_chunked(model, toks, CHUNK, backend=backend,
                                      device="cpu")
    return bitstream.pack_chunked(*st.chunks, chunk_size=CHUNK,
                                  n_symbols=toks.shape[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_chunked_roundtrip_bit_exact(zoo, arch):
    model = zoo[arch]
    toks = _toks(model, 2, 20, seed=3)          # 20 = 2 full chunks + tail
    blob = _blob(model, toks, "kernel")
    assert blob == _blob(model, toks, "coder")
    slab = bitstream.parse_chunked(blob)
    probes = []
    for backend in ("kernel", "coder", "two_pass"):
        sym, _, lp = compress.lm_decompress_chunked(
            model, slab, 20, CHUNK, backend=backend, lane_probes=True,
            device="cpu")
        np.testing.assert_array_equal(sym.numpy(), toks)
        probes.append(lp.numpy())
    np.testing.assert_array_equal(probes[0], probes[1])
    np.testing.assert_array_equal(probes[0], probes[2])


@pytest.mark.parametrize("arch", ARCHS)
def test_monolithic_roundtrip_bit_exact(zoo, arch):
    model = zoo[arch]
    toks = _toks(model, 2, 12, seed=4)
    enc_k = compress.lm_compress(model, toks, backend="kernel",
                                 device="cpu").enc
    enc_c = compress.lm_compress(model, toks, backend="coder",
                                 device="cpu").enc
    for a, b in zip(enc_k, enc_c):
        assert torch.equal(a, b)
    sym, _ = compress.lm_decompress(model, enc_k, 12, backend="kernel",
                                    device="cpu")
    np.testing.assert_array_equal(sym.numpy(), toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_geometry_equals_reference(arch):
    cfg, jcfg = get_smoke_config(arch), j_get_smoke_config(arch)
    assert tuple(state_spec(cfg)) == tuple(j_state_spec(jcfg))
    assert can_prefill(cfg) == j_can_prefill(jcfg) is False
    for max_len in (8, 16, 32, 4096):
        assert ring_length(cfg, max_len) == j_ring_length(jcfg, max_len)
        assert wrap_length(cfg, max_len) == j_wrap_length(jcfg, max_len)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_leaves_rows_reset_and_recurrent_tree(zoo, arch):
    model = zoo[arch]
    st = init_state(model, 3, 16)
    for leaf in st.leaves().values():
        assert leaf.shape[1] == 3 and not leaf.any()
    tree = recurrent_state_tree(st)
    jtree = j_recurrent_state_tree(j_init_state(j_get_smoke_config(arch),
                                                3, 16))
    assert sorted(set(tree.values())) == sorted(set(jax.tree.leaves(jtree)))
    assert has_recurrent_state(st) == state_spec(model.cfg).recurrent
    assert {k for k, rec in tree.items() if not rec} == (
        {"k", "v"} if state_spec(model.cfg).ring else set())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_unsupported_is_named(zoo, arch):
    model = zoo[arch]
    st = init_state(model, 2, 16)
    with pytest.raises(PrefillUnsupportedError, match="sequential state"):
        prefill_chunk(model, st, torch.zeros((2, 4), dtype=torch.int64),
                      torch.zeros(2, dtype=torch.int64),
                      torch.full((2,), 4, dtype=torch.int64))
    with pytest.raises(PrefillUnsupportedError, match="prefill='force'"):
        BatchEngine(model, slots=1, lanes=2, chunk_size=CHUNK,
                    prefill="force", device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_long_streams_byte_identical(zoo, arch):
    """Streams of 40 > max_len = 16 are admitted without allow_wrap (the
    state never wraps), batched with a 20-symbol stream; every blob equals
    the single-request path's and decodes exactly through the engine."""
    model = zoo[arch]
    eng = BatchEngine(model, slots=2, lanes=2, chunk_size=CHUNK,
                      max_len=16, step_backend="kernel", device="cpu")
    long_toks = _toks(model, 2, 40, seed=5)
    short_toks = _toks(model, 2, 20, seed=6)
    rid_l = eng.submit_compress(long_toks)
    rid_s = eng.submit_compress(short_toks)
    res = eng.run()
    assert res[rid_l].ok and res[rid_s].ok
    assert eng.prefill_cycles == 0
    assert res[rid_l].blob == _blob(model, long_toks)
    assert res[rid_s].blob == _blob(model, short_toks)
    dids = [eng.submit_decompress(res[r].blob) for r in (rid_l, rid_s)]
    out = eng.run()
    for did, toks in zip(dids, (long_toks, short_toks)):
        assert out[did].ok
        np.testing.assert_array_equal(out[did].tokens, toks)
    _, _, lp = compress.lm_decompress_chunked(
        model, bitstream.parse_chunked(res[rid_l].blob), 40, CHUNK,
        backend="kernel", lane_probes=True, device="cpu")
    np.testing.assert_array_equal(out[dids[0]].lane_probes, lp.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_frozen_rows_keep_recurrent_state(zoo, arch):
    """Slot 0's 20-symbol request ends on a 4-step chunk while slot 1's
    24-symbol request runs 8 steps: after the run slot 0's recurrent
    leaves are bitwise the single-request state after its 20 tokens (the
    4 frozen steps changed nothing)."""
    model = zoo[arch]
    lanes = 2
    eng = BatchEngine(model, slots=2, lanes=lanes, chunk_size=CHUNK,
                      max_len=16, device="cpu")
    toks = _toks(model, lanes, 20, seed=7)
    rid = eng.submit_compress(toks)
    eng.submit_compress(_toks(model, lanes, 24, seed=8))
    res = eng.run()
    assert res[rid].ok and res[rid].slot == 0
    inputs = torch.cat([torch.zeros((lanes, 1), dtype=torch.int64),
                        torch.as_tensor(toks[:, :-1])], 1)
    alone = compress.teacher_forced_scan(model, inputs, 20,
                                         lambda lg, t: None)
    tree = recurrent_state_tree(alone)
    assert any(tree.values())
    for name, rec in tree.items():
        if rec:
            assert torch.equal(eng._states[0].leaves()[name],
                               alone.leaves()[name]), name


@pytest.mark.parametrize("mode,want", [
    ("compress", "bit-exact roundtrip: True"),
    ("engine", "byte-identical to the single-request path")])
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_zoo(arch, mode, want, capsys):
    launcher.main(["--arch", arch, "--mode", mode, "--device", "cpu",
                   "--lanes", "2", "--symbols", "24", "--streams", "3",
                   "--backend", "kernel"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and want in out
