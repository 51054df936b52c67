"""The port's package surfaces against the reference's (CPU).

* Every name that ``repro.core``, ``repro.configs`` and ``repro.models``
  export resolves in the port's package of the same name; the reference's
  ``forward``, ``make_model_defs`` and ``abstract_model`` are
  ``LM.forward``, ``models.param.param_axes`` and
  ``models.param.abstract_params`` there.
* ``core.stack`` re-exports ``StreamExhaustedError``, and
  ``update.gather_encode_entry`` returns an ``EncEntry`` of the
  reference's fields.
* ``spc.tables_from_logits`` (every table plane) and ``coder.find_symbol``
  (symbols and probe counts, with candidates and a predictor bracket)
  equal JAX's, integer for integer, on seeded inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jconfigs
import repro.core as jcore
import repro.models as jmodels
import repro_torch.configs as configs
import repro_torch.core as core
import repro_torch.models as models
from repro.core import coder as jcoder
from repro.core import spc as jspc
from repro.core import update as jupdate
from repro_torch.core import coder, spc, stack, update
from repro_torch.core import constants as C
from repro_torch.models import param

jax.config.update("jax_platforms", "cpu")

# the reference's model-construction names and their port counterparts
_MODEL_COUNTERPARTS = {"forward": (models.LM, "forward"),
                       "make_model_defs": (param, "param_axes"),
                       "abstract_model": (param, "abstract_params")}


def _u32(x) -> np.ndarray:
    """Port int32 bit patterns / JAX uint32 -> numpy uint32."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x).astype(np.int64).astype(np.uint32)


@pytest.mark.parametrize("ref,port", [(jcore, core), (jconfigs, configs),
                                      (jmodels, models)],
                         ids=["core", "configs", "models"])
def test_every_reference_name_resolves(ref, port):
    for name in ref.__all__:
        if port is models and name in _MODEL_COUNTERPARTS:
            owner, attr = _MODEL_COUNTERPARTS[name]
            assert callable(getattr(owner, attr)), name
            continue
        assert name in port.__all__, name
        assert hasattr(port, name), name
    for name in port.__all__:
        assert hasattr(port, name), name


def test_reexports_and_entry_fields():
    assert stack.StreamExhaustedError is coder.StreamExhaustedError
    assert issubclass(stack.StreamExhaustedError, ValueError)
    assert update.EncEntry._fields == jupdate.EncEntry._fields
    assert models.init_cache is models.init_state
    assert set(models.FAMILY_PROTOCOLS) == set(jmodels.FAMILY_PROTOCOLS)
    assert models.ModelProtocol._fields == jmodels.ModelProtocol._fields
    assert set(configs.SHAPES) == set(jconfigs.SHAPES)
    assert ([tuple(g) for g in configs.grid()]
            == [tuple(g) for g in jconfigs.grid()])
    rng = np.random.default_rng(2)
    probs = rng.dirichlet(np.ones(16), size=3).astype(np.float32)
    tbl = spc.tables_from_probs(torch.as_tensor(probs))
    x = torch.as_tensor(rng.integers(0, 16, 3))
    got = update.gather_encode_entry(tbl, x)
    assert isinstance(got, update.EncEntry)
    ref = jupdate.gather_encode_entry(
        jspc.tables_from_probs(jnp.asarray(probs)), jnp.asarray(x.numpy()))
    for name, a, b in zip(update.EncEntry._fields, got, ref):
        np.testing.assert_array_equal(_u32(a), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("shape,prob_bits,scale",
                         [((5, 256), 16, 3.0), ((2, 3, 61), 12, 8.0),
                          ((1000,), 16, 30.0)])
def test_tables_from_logits_matches_reference(shape, prob_bits, scale):
    """Logits of a few spreads (the widest drives many symbols to the
    floor frequency) give every table plane equal to JAX's."""
    rng = np.random.default_rng(prob_bits + shape[-1])
    logits = (scale * rng.standard_normal(shape)).astype(np.float32)
    ref = jspc.tables_from_logits(jnp.asarray(logits), prob_bits)
    got = spc.tables_from_logits(torch.as_tensor(logits), prob_bits)
    assert got._fields == ref._fields
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_array_equal(_u32(a), np.asarray(b), err_msg=name)
    # BF16 logits go through the same float32 softmax
    bf = torch.as_tensor(logits).to(torch.bfloat16)
    ref = jspc.tables_from_logits(jnp.asarray(bf.float().numpy(),
                                              jnp.bfloat16), prob_bits)
    got = spc.tables_from_logits(bf, prob_bits)
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_array_equal(_u32(a), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("topk", [0, 3])
@pytest.mark.parametrize("bracket", [False, True])
@pytest.mark.parametrize("per_lane", [False, True])
def test_find_symbol_matches_reference(topk, bracket, per_lane):
    rng = np.random.default_rng(31 + 4 * topk + 2 * bracket + per_lane)
    lanes, k = 48, 40
    logits = (2.0 * rng.standard_normal((lanes, k) if per_lane else (k,))
              ).astype(np.float32)
    jtbl = jspc.tables_from_logits(jnp.asarray(logits))
    tbl = spc.tables_from_logits(torch.as_tensor(logits))
    slot = rng.integers(0, 1 << C.PROB_BITS, lanes)
    truth = np.stack([np.searchsorted(np.asarray(jtbl.cdf)[i if per_lane
                                                          else ...],
                                      slot[i], side="right") - 1
                      for i in range(lanes)])
    kw, jkw = {}, {}
    if topk:    # some lanes hit on their first or a later candidate
        cands = rng.integers(-2, k + 2, (lanes, topk)).astype(np.int32)
        cands[::3, 1] = truth[::3]
        cands[1::5, 0] = truth[1::5]
        kw["candidates"] = torch.as_tensor(cands)
        jkw["candidates"] = jnp.asarray(cands)
    if bracket:  # the bracket holds the symbol on some lanes, not others
        mu = np.clip(truth + rng.integers(-3, 4, lanes), 0, k - 1)
        kw.update(mu=torch.as_tensor(mu), delta=2)
        jkw.update(mu=jnp.asarray(mu, jnp.int32), delta=2)
    jx, jp = jcoder.find_symbol(jtbl, jnp.asarray(slot, jnp.uint32), **jkw)
    tx, tp = coder.find_symbol(tbl, torch.as_tensor(slot), **kw)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tx.numpy(), truth)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert core.find_symbol is coder.find_symbol
