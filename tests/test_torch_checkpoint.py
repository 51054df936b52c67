"""The port's checkpoints and fault tolerance against JAX's (CPU, SMOKE).

* ``train.checkpoint.save`` of a port ``TrainState`` and JAX's ``save`` of
  the same state (the port's built from JAX's tree by
  ``models.convert.from_reference``) give npz files with equal key sets,
  shapes, dtypes and bytes, and manifests with equal fields, in float32
  and in bfloat16 (a ``|V2`` leaf on both sides).
* Checkpoints cross between the packages bitwise: JAX -> port (float32
  and bfloat16) and port -> JAX (float32).  JAX cannot read a bfloat16
  checkpoint (``TypeError`` on ``|V2``), its own or the port's: a property
  of the reference, pinned here.
* ``latest_step`` answers as the reference on the reference's cases, a
  half-written directory among them.
* ``save(blocking=False)`` has every tensor on the host when it returns.
* ``StragglerMonitor`` keeps JAX's EMA and slow steps; ``RestartManager``
  recovers from a fault bitwise, gives up after ``max_failures`` and, as
  the reference, replays a fault before the first checkpoint on the
  stepped state (a toy state in both packages).
"""

import json
import os
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.ras_pimc import SMOKE as J_SMOKE
from repro.data import pipeline as jpipeline
from repro.models import init_model as j_init_model
from repro.train import checkpoint as jcheckpoint
from repro.train import fault_tolerance as jft
from repro.train import train_loop as jtrain_loop
from repro_torch.configs.ras_pimc import SMOKE
from repro_torch.models import init_model
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.train import checkpoint, fault_tolerance, train_loop

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


DTYPES = ["float32", "bfloat16"]


def _jax_state(dtype: str):
    """A JAX ras-pimc SMOKE train state one step in (moments and step
    nonzero), float32 moments as JAX's launcher keeps them."""
    cfg = J_SMOKE.with_(dtype=dtype, grad_accum=1)
    state = jtrain_loop.init_train_state(
        j_init_model(cfg, jax.random.PRNGKey(0)))
    step = jax.jit(jtrain_loop.make_train_step(cfg, base_lr=1e-2))
    batch = jax.tree.map(jnp.asarray, jpipeline.train_batch(cfg, 2, 16))
    state, _ = step(state._replace(step=jnp.int32(150)), batch)
    return state


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(jstate, dtype: str) -> train_loop.TrainState:
    """The same state in the port, built from JAX's trees."""
    model = from_reference(_np(jstate.params), SMOKE.with_(dtype=dtype),
                           device="cpu")
    f32 = SMOKE.with_(dtype="float32")

    def moments(tree):
        return {k: v.detach().clone() for k, v in
                from_reference(_np(tree), f32, device="cpu")
                .named_parameters()}

    state = train_loop.init_train_state(model, moment_dtype=torch.float32)
    opt = state.opt._replace(step=torch.tensor(int(jstate.opt.step),
                                               dtype=torch.int32),
                             m=moments(jstate.opt.m), v=moments(jstate.opt.v))
    return state._replace(opt=opt, step=torch.tensor(int(jstate.step),
                                                     dtype=torch.int32))


@pytest.fixture(scope="module")
def jstates():
    return {dt: _jax_state(dt) for dt in DTYPES}


def _files(d: str, step: int):
    path = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "host0.npz")) as z:
        return {k: z[k] for k in z.files}, list(z.files), manifest


def _bits(state: train_loop.TrainState) -> dict:
    """Every leaf of a port state in the reference's layout, each dtype
    kept (bfloat16 as its bits)."""
    return dict(checkpoint._flatten(checkpoint._reference_tree(state)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_save_writes_jax_layout(jstates, dtype, tmp_path):
    jstate = jstates[dtype]
    jcheckpoint.save(str(tmp_path / "jax"), 7, jstate)
    checkpoint.save(str(tmp_path / "port"), 7, _port_state(jstate, dtype))
    got, got_order, got_man = _files(str(tmp_path / "port"), 7)
    ref, ref_order, ref_man = _files(str(tmp_path / "jax"), 7)
    assert len(ref) == 35 and got_order == ref_order
    for k, r in ref.items():
        g = got[k]
        assert (g.shape, g.dtype) == (r.shape, r.dtype), k
        assert g.tobytes() == r.tobytes(), k
    want_dtype = np.dtype("V2") if dtype == "bfloat16" else np.float32
    assert ref["params.tok.embedding"].dtype == want_dtype
    assert ref["opt.step"].dtype == ref["step"].dtype == np.int32
    assert set(got_man) == set(ref_man) == {"step", "time", "keys", "hosts"}
    assert {k: got_man[k] for k in ("step", "keys", "hosts")} == {
        k: ref_man[k] for k in ("step", "keys", "hosts")}


def _fresh_port_state(dtype: str) -> train_loop.TrainState:
    model = init_model(SMOKE.with_(dtype=dtype), seed=5, device="cpu")
    return train_loop.init_train_state(model, moment_dtype=torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_checkpoint_restores_in_port_bitwise(jstates, dtype, tmp_path):
    jstate = jstates[dtype]
    jcheckpoint.save(str(tmp_path), 3, jstate)
    state = _fresh_port_state(dtype)
    out = checkpoint.restore(str(tmp_path), 3, state)
    assert out is state
    ref, _, _ = _files(str(tmp_path), 3)
    got = {k.replace("/", "."): v for k, v in _bits(state).items()}
    assert set(got) == set(ref)
    for k, g in got.items():
        assert g.dtype == ref[k].dtype and g.tobytes() == ref[k].tobytes(), k
    assert int(state.step) == int(jstate.step) == 151


def test_port_float32_checkpoint_restores_in_jax_bitwise(jstates, tmp_path):
    jstate = jstates["float32"]
    port = _port_state(jstate, "float32")
    # the port state one step further, so the restore must change JAX's
    step = train_loop.make_train_step(SMOKE.with_(grad_accum=1), base_lr=1e-2)
    port, _ = step(port, jpipeline.train_batch(J_SMOKE, 2, 16, step=1))
    checkpoint.save(str(tmp_path), 9, port)
    restored = jcheckpoint.restore(str(tmp_path), 9, jstate)
    want = _bits(port)
    got = dict(checkpoint._flatten(_np(restored)))
    assert set(got) == set(want)
    for k, g in got.items():
        assert g.dtype == want[k].dtype and g.tobytes() == want[k].tobytes()
    assert int(restored.step) == 152
    np.testing.assert_array_equal(
        np.asarray(restored.params["tok"]["embedding"]),
        to_reference(port.model)["tok"]["embedding"])


def test_bfloat16_checkpoint_jax_refuses_port_restores(jstates, tmp_path):
    """JAX's restore refuses ``|V2`` leaves (``jnp.asarray``), so it cannot
    read a bfloat16 checkpoint, the port's or its own; the port reads
    both by bit pattern."""
    jstate = jstates["bfloat16"]
    port = _port_state(jstate, "bfloat16")
    checkpoint.save(str(tmp_path / "port"), 4, port)
    jcheckpoint.save(str(tmp_path / "jax"), 4, jstate)
    for d in ("port", "jax"):
        with pytest.raises(TypeError, match="V2"):
            jcheckpoint.restore(str(tmp_path / d), 4, jstate)
    fresh = _fresh_port_state("bfloat16")
    checkpoint.restore(str(tmp_path / "port"), 4, fresh)
    for (name, a), b in zip(port.model.named_parameters(),
                            fresh.model.parameters()):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), name
    for k in port.opt.m:
        assert torch.equal(port.opt.m[k], fresh.opt.m[k])
        assert torch.equal(port.opt.v[k], fresh.opt.v[k])
    assert int(fresh.step) == int(port.step)


def test_restore_refuses_a_checkpoint_of_another_state(jstates, tmp_path):
    checkpoint.save(str(tmp_path), 1, _port_state(jstates["float32"],
                                                  "float32"))
    with pytest.raises(ValueError, match="bfloat16|float32"):
        checkpoint.restore(str(tmp_path), 1, _fresh_port_state("bfloat16"))
    other = train_loop.init_train_state(init_model(
        SMOKE.with_(n_layers=3), seed=0, device="cpu"))
    with pytest.raises((KeyError, ValueError)):
        checkpoint.restore(str(tmp_path), 1, other)


def _mkstep(d, name: str, manifest: bool) -> None:
    os.makedirs(os.path.join(d, name), exist_ok=True)
    if manifest:
        with open(os.path.join(d, name, "manifest.json"), "w") as f:
            f.write("{}")


LATEST_CASES = {
    "missing directory": None,
    "empty": [],
    "one step": [("step_00000005", True)],
    "newest wins": [("step_00000005", True), ("step_00000020", True),
                    ("step_00000010", True)],
    "half-written newest": [("step_00000005", True),
                            ("step_00000010.tmp0", True)],
    "no manifest": [("step_00000005", True), ("step_00000030", False)],
    "only unpublished": [("step_00000010.tmp0", False)],
    "other names": [("step_00000003", True), ("logs", False),
                    ("notes.txt", None)],
}


@pytest.mark.parametrize("case", sorted(LATEST_CASES))
def test_latest_step_matches_reference(case, tmp_path):
    d = str(tmp_path / "ckpt")
    entries = LATEST_CASES[case]
    if entries is not None:
        os.makedirs(d)
        for name, manifest in entries:
            if manifest is None:
                open(os.path.join(d, name), "w").close()
            else:
                _mkstep(d, name, manifest)
    assert checkpoint.latest_step(d) == jcheckpoint.latest_step(d)


def test_nonblocking_save_snapshots_before_returning(tmp_path):
    state = _fresh_port_state("float32")
    before = to_reference(state.model)["tok"]["embedding"]
    checkpoint.save(str(tmp_path), 2, state, blocking=False)
    with torch.no_grad():
        state.model.embedding.add_(1.0)
        for m in state.opt.m.values():
            m.add_(1.0)
    deadline = time.monotonic() + 60
    while checkpoint.latest_step(str(tmp_path)) != 2:
        assert time.monotonic() < deadline, "the writer thread never published"
        time.sleep(0.01)
    got, _, _ = _files(str(tmp_path), 2)
    np.testing.assert_array_equal(got["params.tok.embedding"], before)
    assert not got["opt.m.tok.embedding"].any()


def test_straggler_monitor_matches_reference():
    dts = [0.10, 0.11, 0.09, 0.50, 0.10, 0.12, 0.05, 1.20, 0.30, 0.31]
    port = fault_tolerance.StragglerMonitor(factor=2.0)
    ref = jft.StragglerMonitor(factor=2.0)
    flags = [(port.observe(i, dt), ref.observe(i, dt))
             for i, dt in enumerate(dts)]
    assert [a for a, _ in flags] == [b for _, b in flags]
    assert port.ema == ref.ema
    assert port.slow_steps == ref.slow_steps
    assert [s for s, _, _ in port.slow_steps] == [3, 7]


class _Toy(NamedTuple):
    step: object
    acc: object


def _toy(pkg: str):
    """A toy state and step in either package: the step adds the batch
    (the step index) to an accumulator."""
    if pkg == "jax":
        state = _Toy(jnp.int32(0), jnp.int32(0))
        loss = jnp.float32(0)
    else:
        state = _Toy(torch.zeros((), dtype=torch.int32),
                     torch.zeros((), dtype=torch.int32))
        loss = torch.zeros(())

    def step_fn(st, batch):
        return _Toy(st.step + 1, st.acc + batch), {"loss": loss}

    return state, step_fn


def _once(at: int):
    fired = []

    def hook(i):
        if i == at and not fired:
            fired.append(i)
            raise RuntimeError(f"injected fault before step {i}")
    return hook


@pytest.mark.parametrize("fault_at, want_step, want_acc", [
    (None, 10, 45),     # unbroken
    (7, 10, 45),        # restored from step 5: the replay is exact
    (2, 12, 46),        # before the first checkpoint: replayed on the
])                      # stepped state (a property of the reference)
def test_restart_manager_toy_matches_reference(tmp_path, fault_at, want_step,
                                               want_acc):
    got = {}
    for pkg, mod in (("jax", jft), ("port", fault_tolerance)):
        state, step_fn = _toy(pkg)
        mgr = mod.RestartManager(str(tmp_path / pkg), save_every=5)
        hook = None if fault_at is None else _once(fault_at)
        out = mgr.run(state, step_fn, lambda i: i, 10, fault_hook=hook)
        pub = {s: int(np.asarray(_files(str(tmp_path / pkg), s)[0]["step"]))
               for s in (5, 10)}
        got[pkg] = (int(out.step), int(out.acc), mgr.failures, pub)
    assert got["port"] == got["jax"]
    assert got["port"][:3] == (want_step, want_acc,
                               0 if fault_at is None else 1)
    if fault_at == 2:       # step_00000005 holds a state at step 7
        assert got["port"][3] == {5: 7, 10: 12}


def test_restart_manager_gives_up_after_max_failures(tmp_path):
    def always(i):
        if i >= 3:
            raise RuntimeError("deterministic crash")

    counts = {}
    for pkg, mod in (("jax", jft), ("port", fault_tolerance)):
        state, step_fn = _toy(pkg)
        mgr = mod.RestartManager(str(tmp_path / pkg), save_every=2,
                                 max_failures=2)
        with pytest.raises(RuntimeError, match="deterministic crash"):
            mgr.run(state, step_fn, lambda i: i, 10, fault_hook=always)
        counts[pkg] = mgr.failures
    assert counts == {"jax": 3, "port": 3}


def _train(tmp, fault_at):
    cfg = SMOKE.with_(grad_accum=1)
    state = train_loop.init_train_state(init_model(cfg, seed=0,
                                                   device="cpu"))
    step = train_loop.make_train_step(cfg, base_lr=1e-2)
    mgr = fault_tolerance.RestartManager(str(tmp), save_every=5)
    hook = None if fault_at is None else _once(fault_at)
    state = mgr.run(state, step,
                    lambda i: jpipeline.train_batch(J_SMOKE, 2, 16, step=i),
                    10, fault_hook=hook)
    return state, mgr


def test_restart_manager_recovers_bitwise(tmp_path):
    state, mgr = _train(tmp_path / "fault", 7)
    ref, ref_mgr = _train(tmp_path / "clean", None)
    assert (int(state.step), mgr.failures, ref_mgr.failures) == (10, 1, 0)
    for (name, a), b in zip(state.model.named_parameters(),
                            ref.model.parameters()):
        assert torch.equal(a, b), name
    for k in state.opt.m:
        assert torch.equal(state.opt.m[k], ref.opt.m[k])
        assert torch.equal(state.opt.v[k], ref.opt.v[k])
    assert checkpoint.latest_step(str(tmp_path / "fault")) == 10


def test_remesh_waits_for_placement(jstates, tmp_path):
    """``remesh`` restores a JAX-written float32 checkpoint onto a new
    placement (the reference's ``test_elastic_remesh``): a device, and a
    world-1 gloo mesh (this rank's device), bitwise."""
    import datetime

    import torch.distributed as dist
    from repro_torch.parallel.collectives import pod_mesh
    jstate = jstates["float32"]
    jcheckpoint.save(str(tmp_path), 3, jstate)
    ref, _, _ = _files(str(tmp_path), 3)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        for placement in ("cpu", pod_mesh(device="cpu")):
            state = fault_tolerance.remesh(_fresh_port_state("float32"),
                                           str(tmp_path), 3, placement)
            got = {k.replace("/", "."): v for k, v in _bits(state).items()}
            assert set(got) == set(ref)
            for k, g in got.items():
                assert g.tobytes() == ref[k].tobytes(), k
            assert next(state.model.parameters()).device.type == "cpu"
    finally:
        dist.destroy_process_group()


def _with_error(jstate, seed: int):
    """JAX's state with a seeded float32 error-feedback tree."""
    rng = np.random.default_rng(seed)
    err = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape).astype(np.float32)), jstate.params)
    return jstate._replace(error=err)


def test_error_tree_checkpoint_crosses_packages(jstates, tmp_path):
    """A state with the cross-pod residuals writes ``error.<path>`` as the
    reference does (skipped when None), and such checkpoints cross between
    the packages in both directions bitwise; a state with residuals refuses
    a checkpoint without them, and the reverse."""
    jstate = _with_error(jstates["float32"], 11)
    jcheckpoint.save(str(tmp_path / "jax"), 5, jstate)
    ref, _, _ = _files(str(tmp_path / "jax"), 5)
    assert sorted(k[6:] for k in ref if k.startswith("error.")) == sorted(
        k[7:] for k in ref if k.startswith("params."))
    model = init_model(SMOKE, seed=5, device="cpu")
    state = train_loop.init_train_state(model, moment_dtype=torch.float32,
                                        with_error=True)
    checkpoint.restore(str(tmp_path / "jax"), 5, state)
    got = {k.replace("/", "."): v for k, v in _bits(state).items()}
    assert set(got) == set(ref)
    for k, g in got.items():
        assert g.tobytes() == ref[k].tobytes(), k
    # port -> JAX: the residuals changed, so the restore must change JAX's
    for k in state.error:
        state.error[k].mul_(-2.0)
    checkpoint.save(str(tmp_path / "port"), 6, state)
    back = jcheckpoint.restore(str(tmp_path / "port"), 6, jstate)
    want = to_reference(model, state.error)
    for (kp, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back.error)[0],
            jax.tree_util.tree_flatten_with_path(want)[0]):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(kp))
    plain = _fresh_port_state("float32")
    with pytest.raises(KeyError, match="unexpected.*error"):
        checkpoint.restore(str(tmp_path / "port"), 6, plain)
    checkpoint.save(str(tmp_path / "plain"), 1, plain)
    with pytest.raises(KeyError, match="missing.*error"):
        checkpoint.restore(str(tmp_path / "plain"), 1, state)
