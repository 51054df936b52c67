"""Port LM compression slice: compress -> v2 container -> fused decode (CPU).

* the port's round trip is bit-exact, and its ``kernel`` and ``coder``
  backends give byte-identical containers and equal per-lane probes;
* a truncated container raises ``StreamExhaustedError`` on both backends;
* fed JAX's ``collect_tables``, the port's encode + pack is byte-identical
  to JAX's ``lm_compress_chunked(backend="kernel")`` + ``pack_chunked``;
* with JAX-converted params the port's cross entropy is within 1e-4 bits
  of JAX's and its payload within 1%;
* a guard keeps ``jax`` and ``repro`` out of the port, ``chip_smoke.py``,
  ``tools/``, the JAX-free ``gpu`` tier ``tests/test_torch_gpu.py`` and
  the multi-rank workers ``tests/_torch_ranks.py`` (``parallel/``
  included by name).
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.ras_pimc import SMOKE as J_SMOKE
from repro.core import bitstream as jbs
from repro.data.pipeline import token_stream as j_token_stream
from repro.models import init_model as j_init_model
from repro.serve import compress as jcompress
from repro_torch.configs.ras_pimc import SMOKE
from repro_torch.core import bitstream, coder, spc, u32
from repro_torch.data.pipeline import token_stream
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import init_model
from repro_torch.models.convert import from_reference
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

ROOT = pathlib.Path(__file__).resolve().parents[1]
LANES, T, CHUNK = 4, 40, 16          # ragged: 16 + 16 + 8


@pytest.fixture(scope="module")
def tokens():
    toks = token_stream(256, (LANES, T), seed=5)
    np.testing.assert_array_equal(toks, j_token_stream(256, (LANES, T),
                                                       seed=5))
    return toks


@pytest.fixture(scope="module")
def model():
    return init_model(SMOKE, seed=0, device="cpu")


def _blob(chunks, **kw):
    return bitstream.pack_chunked(*chunks, chunk_size=CHUNK, n_symbols=T,
                                  **kw)


def test_roundtrip_bit_exact_and_backends_identical(model, tokens):
    st_k = compress.lm_compress_chunked(model, tokens, CHUNK,
                                        backend="kernel", device="cpu")
    st_c = compress.lm_compress_chunked(model, tokens, CHUNK,
                                        backend="coder", device="cpu")
    blob = _blob(st_k.chunks)
    assert blob == _blob(st_c.chunks)
    assert float(st_k.bits_per_symbol) > 0 and np.isfinite(
        float(st_k.model_xent_bits))
    cs = bitstream.parse_chunked(blob)
    outs = {}
    for backend in ("kernel", "coder"):
        sym, avg, per_lane = compress.lm_decompress_chunked(
            model, cs, T, CHUNK, backend=backend, lane_probes=True,
            device="cpu")
        np.testing.assert_array_equal(sym.numpy(), tokens)
        outs[backend] = (float(avg), per_lane.numpy())
    assert outs["kernel"][0] == outs["coder"][0]
    np.testing.assert_array_equal(outs["kernel"][1], outs["coder"][1])
    # dense ChunkedLanes input decodes the same as the parsed slab
    sym, _ = compress.lm_decompress_chunked(model, st_k.chunks, T, CHUNK,
                                            backend="kernel", device="cpu")
    np.testing.assert_array_equal(sym.numpy(), tokens)


def test_truncated_container_raises_stream_exhausted(model, tokens):
    st = compress.lm_compress_chunked(model, tokens, CHUNK, backend="kernel",
                                      device="cpu")
    length = st.chunks.length.clone()
    length[-1] -= 2                      # drop each last-chunk stream's tail
    cs = bitstream.parse_chunked(bitstream.pack_chunked(
        st.chunks.buf, st.chunks.start, length, chunk_size=CHUNK,
        n_symbols=T))
    for backend in ("kernel", "coder"):
        with pytest.raises(coder.StreamExhaustedError):
            compress.lm_decompress_chunked(model, cs, T, CHUNK,
                                           backend=backend, device="cpu")


def test_entry_points_need_a_device_or_the_card(model, tokens):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        compress.lm_compress_chunked(model, tokens, CHUNK)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(SMOKE, seed=0)


def test_cuda_entry_points_need_the_numeric_settings():
    if torch.are_deterministic_algorithms_enabled():
        pytest.skip("this process already runs in deterministic mode")
    with pytest.raises(RuntimeError, match="configure_cuda_numerics"):
        resolve_device("cuda")


@pytest.fixture(scope="module")
def jax_side(tokens):
    params = j_init_model(J_SMOKE, jax.random.PRNGKey(11))
    jt, jxent = jcompress.collect_tables(params, J_SMOKE,
                                         jnp.asarray(tokens, jnp.int32))
    st = jcompress.lm_compress_chunked(params, J_SMOKE,
                                       jnp.asarray(tokens, jnp.int32), CHUNK,
                                       backend="kernel")
    blob = jbs.pack_chunked(*map(np.asarray, st.chunks), chunk_size=CHUNK,
                            n_symbols=T)
    return params, jt, float(jxent), blob


def test_container_from_reference_tables_is_byte_identical(tokens, jax_side):
    _, jt, _, jblob = jax_side
    tables = spc.TableSet(*(u32.bits(torch.as_tensor(
        np.asarray(a).astype(np.int64))) for a in jt))
    chunks = ops.rans_encode_chunked(torch.as_tensor(tokens), tables, CHUNK)
    assert _blob(chunks) == jblob


def test_converted_model_prices_like_reference(tokens, jax_side):
    params, jt, jxent, jblob = jax_side
    model = from_reference(jax.tree.map(np.asarray, params), SMOKE,
                           device="cpu")
    toks = torch.as_tensor(tokens)
    tables, xent = compress.collect_tables(model, toks)
    assert abs(float(xent) - jxent) <= 1e-4
    same = np.all(u32.value(tables.freq).numpy() == np.asarray(jt.freq), -1)
    print(f"identical (t, lane) tables: {same.mean():.4f}")
    assert same.mean() > 0.5
    st = compress.lm_compress_chunked(model, tokens, CHUNK, backend="kernel",
                                      device="cpu")
    payload = int(st.chunks.length.sum())
    jpayload = int(jbs.parse_chunked(jblob).length.sum())
    assert abs(payload - jpayload) <= 0.01 * jpayload


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_))"
    r"|import_module\(\s*['\"](jax|repro)\b(?!_)", re.M)


def test_port_never_imports_jax_or_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted((ROOT / "tools").glob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py",
              ROOT / "tests" / "_torch_ranks.py"]
    assert len(files) > 10
    assert ROOT / "src" / "repro_torch" / "kernels" / "rans_decode.py" in files
    for name in ("__init__.py", "chunked.py", "collectives.py"):
        assert ROOT / "src" / "repro_torch" / "parallel" / name in files
    for name in ("launch/mesh.py", "launch/specs.py", "launch/dryrun.py",
                 "models/param.py", "parallel/sharding.py",
                 "analysis/hlo.py", "analysis/roofline.py",
                 "analysis/report.py", "kernels/autotune.py"):
        assert ROOT / "src" / "repro_torch" / name in files
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"
    assert _FORBIDDEN.search("from repro.core import spc")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from repro_torch.core import spc")
