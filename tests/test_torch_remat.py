"""Activation checkpointing (``cfg.remat``) in the port, against itself and
against the JAX reference (CPU, float32, the SMOKE width).

* ``remat`` of every ``CONFIG`` and ``SMOKE`` of the registry equals the
  reference's.
* The checkpointed unit is the reference's: one repetition of a stage's
  pattern (``LM.units``) and one encoder block, each run through
  ``transformer.remat`` exactly once a forward while autograd records,
  and never under ``torch.no_grad()``.
* For one arch of each family (dense, moe, ssm, hybrid, vlm, audio with
  ``enc_inputs``), the port's loss and every gradient with ``remat=True``
  equal those with ``remat=False`` bit for bit, while fewer tensors are
  saved for backward.
* The port with ``remat=True`` against ``jax.value_and_grad`` of the
  reference's ``loss_fn`` with ``remat=True`` on converted parameters:
  the loss within rtol 1e-5, each gradient leaf within 1e-5 of the
  reference leaf's largest entry (the training tests' tolerance,
  ``tests/test_torch_train.py``).
* The dry-run reckons a SMOKE train cell's activations under ``remat``
  as the stash the trace saw plus the largest unit's recomputed set, and
  fewer bytes than without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data import pipeline as jpipeline
from repro.models import init_model as j_init_model
from repro.models.transformer import loss_fn as j_loss_fn
from repro_torch.analysis import hlo
from repro_torch.configs import (ARCH_IDS, ShapeSpec, get_config,
                                 get_smoke_config)
from repro_torch.launch import dryrun, mesh, specs
from repro_torch.models import loss_fn, transformer
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.train import train_loop

jax.config.update("jax_platforms", "cpu")

# one arch of each family
FAMILIES = {"dense": "ras-pimc", "moe": "mixtral-8x22b",
            "ssm": "mamba2-130m", "hybrid": "recurrentgemma-2b",
            "vlm": "llama-3.2-vision-11b", "audio": "seamless-m4t-large-v2"}
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one CPU thread: its SMOKE ops are small, and
    beside other busy test processes torch's idle worker threads spin for
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch: str, remat: bool, seed: int = 4):
    """(JAX config, JAX params, the port's model holding them), both
    configs at ``remat``."""
    jcfg = j_get_smoke_config(arch).with_(remat=remat)
    params = j_init_model(jcfg, jax.random.PRNGKey(seed))
    model = from_reference(jax.tree.map(np.asarray, params),
                           get_smoke_config(arch).with_(remat=remat),
                           device="cpu")
    return jcfg, params, model


def _batch(jcfg) -> dict:
    """Seeded numpy planes: tokens and labels, and the memory or the
    encoder inputs of a vlm or audio config."""
    return jpipeline.train_batch(jcfg, B, S, step=2, seed=7)


def _leaves_close(got: dict, ref, rel: float):
    """Every leaf of two reference-layout trees within ``rel`` of the
    reference leaf's largest entry."""
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, ref)))
    assert len(flat_got) == len(flat_ref)
    for path, g in flat_got:
        r = flat_ref[path]
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=rel * max(np.abs(r).max(), 1e-12),
                                   err_msg=jax.tree_util.keystr(path))


def _saved_and_grads(model, batch: dict):
    """(loss, gradients by name, the number of tensors saved for backward
    outside the checkpointed units)."""
    saved = []

    def pack(t):
        saved.append(t.shape)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, grads = train_loop.grads_fn(model, batch)
    return loss, grads, len(saved)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_of_every_config_equals_reference(arch):
    for port, ref in ((get_config(arch), j_get_config(arch)),
                      (get_smoke_config(arch), j_get_smoke_config(arch))):
        assert port.remat == ref.remat, port.name


@pytest.mark.parametrize("family", FAMILIES)
def test_one_checkpoint_per_unit_while_recording(family, monkeypatch):
    """The units group the blocks as the reference's stages repeat their
    pattern; a recording forward checkpoints each unit and each encoder
    block once, a forward under ``no_grad`` none, and ``remat=False``
    none."""
    arch = FAMILIES[family]
    jcfg, _, model = _pair(arch, True)
    cfg = model.cfg
    assert [len(u) for u in model.units] == [
        len(pat) for pat, reps in cfg.stages for _ in range(reps)]
    assert [b for u in model.units for b in u] == list(range(cfg.n_layers))
    calls = []
    real = transformer.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", counting)
    batch = {k: torch.as_tensor(v) for k, v in _batch(jcfg).items()}
    batch["tokens"] = batch["tokens"].long()
    batch["labels"] = batch["labels"].long()
    loss_fn(model, batch).backward()
    assert len(calls) == len(model.units) + cfg.encoder_layers
    calls.clear()
    with torch.no_grad():
        loss_fn(model, batch)
    model.cfg = cfg.with_(remat=False)
    loss_fn(model, batch)
    assert calls == []


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_is_bitwise_the_plain_step(family):
    arch = FAMILIES[family]
    jcfg, _, plain = _pair(arch, False)
    _, _, ckpt = _pair(arch, True)
    batch = _batch(jcfg)
    loss0, g0, n0 = _saved_and_grads(plain, batch)
    loss1, g1, n1 = _saved_and_grads(ckpt, batch)
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert n1 < n0      # the units' own tensors were not kept


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_matches_reference_remat(family):
    jcfg, params, model = _pair(FAMILIES[family], True)
    batch = _batch(jcfg)
    jl, jg = jax.value_and_grad(j_loss_fn)(
        params, jax.tree.map(jnp.asarray, batch), jcfg)
    loss, grads = train_loop.grads_fn(model, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _leaves_close(to_reference(model, grads), jg, 1e-5)


@pytest.mark.parametrize("arch", ["ras-pimc", "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_dryrun_reckons_fewer_activation_bytes_with_remat(arch, monkeypatch):
    """A SMOKE train cell on the 1 x 1 mesh: with ``remat`` the traced
    step saves less, the largest checkpointed unit's recomputed set rides
    on it, and the total stays below the plain step's; the parameter,
    gradient and moment bytes do not move."""
    monkeypatch.setattr(specs, "get_config", get_smoke_config)
    shape = ShapeSpec("t", 32, 4, "train")
    out = {}
    for remat in (False, True):
        cell = specs.build_cell(arch, shape, mesh.mesh_shape_for(1),
                                overrides={"grad_accum": 2, "remat": remat})
        assert len(cell.units) == (
            remat * (len(cell.cfg.stages) + cell.cfg.is_encdec))
        _, tr = hlo.trace(cell.run)
        out[remat] = tr, dryrun.memory(cell, tr)
    (tr0, m0), (tr1, m1) = out[False], out[True]
    assert m0["recompute_bytes"] == 0
    assert m0["activation_bytes"] == tr0.saved_bytes
    assert 0 < m1["recompute_bytes"] < tr0.saved_bytes
    assert m1["activation_bytes"] == tr1.saved_bytes + m1["recompute_bytes"]
    assert tr1.saved_bytes < tr0.saved_bytes
    assert m1["activation_bytes"] < m0["activation_bytes"]
    assert tr1.flops > tr0.flops    # the recomputed forward
    for k in ("param_bytes", "grad_bytes", "optimizer_bytes"):
        assert m1[k] == m0[k], k
