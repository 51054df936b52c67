"""The SPC quantizer (B6) against JAX (CPU; the Pallas kernel in interpret
mode).

``spc_quantize_plain`` and ``ops.spc_quantize_tables`` equal JAX's
``ops.spc_quantize_tables`` (the Pallas ``spc_quantize`` then
``build_tables``) on every plane: the three ``(b, k, conc)`` cases and the
pathological rows of ``tests/test_kernels.py``, including an unnormalised
row that drives ``delta`` far below zero, plus tie patterns and a batch
that is no multiple of the TPU kernel's ``batch_block``.  The wrapper's
named errors are checked.  The Barrett planes that ``build_tables`` adds
equal JAX's for every frequency of every ``prob_bits``, with the shift
computed in exact integer steps.  Integer outputs compare exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import spc as jspc
from repro.kernels import ops as jops
from repro.kernels.spc_quantize import spc_quantize as j_spc_quantize
from repro_torch.core import constants as C
from repro_torch.core import spc
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import spc_quantize as spc_kernel

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


def _assert_tables_equal(got, ref):
    for name in spc.TableSet._fields:
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(a.view(b.dtype) if a.dtype != b.dtype
                                      else a, b, err_msg=name)


def _check_against_jax(rows: np.ndarray, batch_block: int = 8):
    probs = rows.astype(np.float32)
    ref = jops.spc_quantize_tables(jnp.asarray(probs),
                                   batch_block=batch_block)
    plain = spc_kernel.spc_quantize_plain(torch.as_tensor(probs))
    np.testing.assert_array_equal(plain.numpy(), np.asarray(ref.freq))
    before = dict(LAUNCHES)
    got = ops.spc_quantize_tables(torch.as_tensor(probs))
    assert LAUNCHES == before       # the CPU runs the plain version
    _assert_tables_equal(got, ref)
    _assert_tables_equal(got, spc.tables_from_probs(torch.as_tensor(probs)))
    assert (plain.sum(-1) == 1 << C.PROB_BITS).all() and plain.min() >= 1
    return plain


@pytest.mark.parametrize("b,k,conc", [
    (8, 256, 0.3),
    (16, 64, 2.0),
    (8, 300, 0.1),   # non-pow2 K
])
def test_spc_quantize_matches_jax(b, k, conc):
    rng = np.random.default_rng(b * k)
    _check_against_jax(rng.dirichlet(np.full(k, conc), size=b))


def _pathological(k=128):
    return np.stack([
        np.full(k, 1.0 / k),
        np.r_[1.0, np.zeros(k - 1)],
        np.r_[np.full(k - 1, 1e-9), [1.0]],
        np.full(k, 1 / 3),                # unnormalised on purpose
    ] * 2)


def test_spc_quantize_pathological_rows_match_jax():
    rows = _pathological()
    # the 1/3 row sums to K/3 mass units: delta is far below zero
    scaled = np.round(rows[3].astype(np.float32) * (1 << C.PROB_BITS))
    assert (1 << C.PROB_BITS) - scaled.sum() < -(1 << C.PROB_BITS)
    _check_against_jax(rows)


def test_spc_quantize_ties_and_any_batch_match_jax():
    rng = np.random.default_rng(9)
    k = 64
    rows = np.stack([
        np.full(k, 1.0 / k),                            # uniform
        np.tile([0.5, 0.25, 0.25, 0.0] * 4, 4) / 4.0,   # repeated residuals
        np.r_[np.full(k // 2, 3e-5), np.full(k // 2, 0.03)],
    ])
    _check_against_jax(rows, batch_block=3)
    # B = 5 is no multiple of the TPU kernel's batch_block = 8
    probs = rng.dirichlet(np.full(k, 0.7), size=5).astype(np.float32)
    want = np.asarray(j_spc_quantize(jnp.asarray(probs), batch_block=5))
    got = spc_kernel.spc_quantize(torch.as_tensor(probs))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_spc_quantize_named_errors():
    ok = torch.full((2, 8), 1 / 8)
    with pytest.raises(ValueError, match=r"\(B, K\)"):
        spc_kernel.spc_quantize(ok[0])
    with pytest.raises(ValueError, match="B >= 1"):
        spc_kernel.spc_quantize(ok[:0])
    with pytest.raises(ValueError, match="exceeds 2\\*\\*prob_bits"):
        spc_kernel.spc_quantize(torch.full((1, 300), 1 / 300), prob_bits=8)
    # the kernel's layouts reach the SPC's own ceiling: a wider row is
    # refused by the mass check on either device
    assert spc_kernel.MAX_K == 1 << 16
    big = spc_kernel.MAX_K + 1
    with pytest.raises(ValueError, match="exceeds 2\\*\\*prob_bits"):
        spc_kernel.spc_quantize(torch.full((1, big), 1 / big), prob_bits=16)


@pytest.mark.parametrize("prob_bits", [8, 14, 16])
def test_barrett_planes_match_jax_on_every_frequency(prob_bits):
    total = 1 << prob_bits
    f = np.arange(1, total + 1, dtype=np.uint32)
    start = (np.arange(total, dtype=np.uint32) * 7) % total
    ref = jspc.barrett_planes(jnp.asarray(f), jnp.asarray(start), prob_bits)
    got = spc.barrett_planes(torch.as_tensor(f.astype(np.int64)),
                             torch.as_tensor(start.astype(np.int64)),
                             prob_bits)
    for name, a, b in zip(("rcp", "rshift", "bias", "cmpl", "x_max"), got,
                          ref):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b), err_msg=name)
    x = torch.arange(0, 1 << 18, dtype=torch.int64)
    want = [int(v).bit_length() for v in x.tolist()]
    assert spc._bit_length(x).tolist() == want
