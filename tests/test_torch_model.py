"""Port dense model vs the JAX reference (CPU, float32).

JAX's ``repro.models.init_model`` params are converted with
``models.convert.from_reference``; the port's ``decode_step`` logits over
8 steps must agree with ``repro.models.decode_step`` within atol 1e-4 and
rtol 1e-4.  The tolerance covers the two frameworks' different reduction
orders in matmul, softmax and rsqrt.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.ras_pimc import SMOKE as J_SMOKE
from repro.models import decode_step as j_decode_step
from repro.models import init_model as j_init_model
from repro.models import init_state as j_init_state
from repro_torch.configs.ras_pimc import CONFIG, SMOKE
from repro_torch.models import decode_step, init_model, init_state
from repro_torch.models.convert import from_reference

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


@pytest.fixture(scope="module")
def converted():
    params = j_init_model(J_SMOKE, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, params)
    return params, from_reference(tree, SMOKE, device="cpu")


@pytest.mark.parametrize("max_len", [40, 6])     # linear cache and a ring
def test_decode_step_logits_match_reference(converted, max_len):
    params, model = converted
    lanes, steps = 3, 8
    toks = np.random.default_rng(0).integers(0, 256, (lanes, steps))
    jcache = j_init_state(J_SMOKE, lanes, max_len)
    state = init_state(model, lanes, max_len)
    for t in range(steps):
        jlg, jcache = j_decode_step(params, jcache,
                                    jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                    jnp.int32(t), J_SMOKE)
        lg = decode_step(model, state, torch.as_tensor(toks[:, t:t + 1]), t)
        assert lg.shape == (lanes, SMOKE.vocab_padded)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                   atol=1e-4, rtol=1e-4)


def test_config_and_seeded_init():
    assert (CONFIG.n_layers, CONFIG.d_model, CONFIG.n_heads,
            CONFIG.head_dim_, CONFIG.d_ff, CONFIG.vocab_size) == (
                4, 256, 4, 64, 512, 256)
    a, b = (init_model(SMOKE, seed=1, device="cpu") for _ in range(2))
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    c = init_model(SMOKE, seed=2, device="cpu")
    assert not torch.equal(a.embedding, c.embedding)
