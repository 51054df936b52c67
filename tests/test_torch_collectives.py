"""The port's collectives and cross-pod train step against JAX's (CPU,
gloo).

The rank programs live in ``tests/_torch_ranks.py`` (torch and the port
only); groups of 2, 3 and 4 ranks are spawned once per file, together,
over a ``FileStore``; a world-1 group runs in this process.  Each rank's
inputs are made from a seed with numpy; JAX runs the reference's reduce on
the same inputs under ``jax.vmap(..., axis_name="pod")``, op by op (a
``jax.jit`` of it lets XLA contract ``xf - q * scale`` into a fused
multiply-add, which moves the last bit; the port computes the reference's
operations as written).

* ``quantize_int8`` / ``dequantize_int8`` bitwise against JAX's.
* ``compressed_psum`` and ``compressed_psum_tree`` on 1, 2 and 3 ranks:
  each rank's mean and residual bitwise equal to JAX's for that pod (the
  int8 payload moves as a ring of ``size - 1`` point-to-point hops, and
  each rank sums the scales in the reference's hop order).  With
  ``groups=``, each leaf bitwise the repeat of JAX's reduce of the tree
  whose leaves stack each group's members.
* The reference's identity and error-feedback tests
  (``tests/test_train_substrate.py``) on a world-1 pod mesh; ``pmean``;
  ``hierarchical_psum`` over 2 x 2 groups of 4 ranks.
* The cross-pod train step (``make_train_step(compress_crosspod=True,
  mesh=pod_mesh())``) on 2 ranks, ``ras-pimc`` SMOKE, three steps: the
  replicas stay bitwise in step, the step equals its composition (pod
  gradients on the rank's rows, the reduce in the groups of
  ``crosspod_groups``, clip, lr, AdamW) bitwise, and the reduce of the
  ranks' gradients is, per rank, bitwise JAX's ``compressed_psum_tree``
  of them in the reference's stacked tree (``to_reference``: a stage's
  blocks one leaf, with one scale, as the reference's ``pod_step``
  reduces them).  Its refusals.
"""

from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch.distributed as dist

import _torch_ranks as R
from repro.parallel import collectives as jcol
from repro_torch.models.convert import leaf_paths, to_reference
from repro_torch.parallel import Mesh
from repro_torch.parallel import collectives as col

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The file's spawned groups, started together at once."""
    tmp = tmp_path_factory.mktemp("ranks")
    return {(s, w): R.RankJob(s, w, tmp) for s, w in
            (("collectives", 2), ("collectives", 3), ("collectives", 4),
             ("train", 2))}


@pytest.fixture(scope="module")
def pod1(tmp_path_factory):
    """A world-1 gloo group in this process and its pod mesh."""
    tmp = tmp_path_factory.mktemp("pod1")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "s"), 1),
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    yield col.pod_mesh(device="cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(jobs, pod1):
    out = {1: [R.collectives_suite(0, 1)]}
    for w in (2, 3, 4):
        out[w] = jobs["collectives", w].results()
    return out


def _vmap_psum(n):
    xs, es = zip(*[R.psum_inputs(r) for r in range(n)])
    return jax.vmap(lambda x, e: jcol.compressed_psum(x, "pod", e, n),
                    axis_name="pod")(jnp.stack(xs), jnp.stack(es))


def _vmap_tree(trees, etrees, n):
    def stack(ts):
        return jax.tree.map(lambda *a: jnp.stack(a), *ts)
    return jax.vmap(lambda t, e: jcol.compressed_psum_tree(t, "pod", e, n),
                    axis_name="pod")(stack(trees), stack(etrees))


def test_quantize_int8_matches_jax():
    rng = np.random.default_rng(0)
    for x in (rng.normal(size=(128,)).astype(np.float32),
              (rng.normal(size=(4, 33)) * 1e-6).astype(np.float32),
              np.zeros((5,), np.float32),
              np.array([0.5, -1.5, 2.5, 127.0], np.float32) / 127.0 * 3.0):
        q, s = col.quantize_int8(torch.as_tensor(x))
        jq, js = jcol.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(
            col.dequantize_int8(q, s).numpy(),
            np.asarray(jcol.dequantize_int8(jq, js)))


@pytest.mark.parametrize("world", (1, 2, 3))
def test_compressed_psum_matches_jax_per_rank(ranks, world):
    out, err = _vmap_psum(world)
    for r, res in enumerate(ranks[world]):
        np.testing.assert_array_equal(res["psum/out"], np.asarray(out[r]),
                                      err_msg=f"rank {r} mean")
        np.testing.assert_array_equal(res["psum/err"], np.asarray(err[r]),
                                      err_msg=f"rank {r} residual")


@pytest.mark.parametrize("world", (1, 2, 3))
def test_compressed_psum_tree_matches_jax_per_rank(ranks, world):
    trees, etrees = zip(*[R.tree_inputs(r) for r in range(world)])
    out, err = _vmap_tree(trees, etrees, world)
    for r, res in enumerate(ranks[world]):
        for k in trees[0]:
            np.testing.assert_array_equal(res[f"tree/out/{k}"],
                                          np.asarray(out[k][r]))
            np.testing.assert_array_equal(res[f"tree/err/{k}"],
                                          np.asarray(err[k][r]))


@pytest.mark.parametrize("world", (1, 2, 3))
def test_compressed_psum_tree_groups_match_jax_stacked(ranks, world):
    """``groups=``: each member of a group is bitwise its repeat of JAX's
    reduce of the leaf that stacks the group (one scale for the stack),
    its mean and its residual, on every rank."""
    inputs = [R.group_inputs(r) for r in range(world)]
    groups = inputs[0][2]

    def stacked(tree):
        return {g: np.stack([tree[k] for k in tree if groups[k] == g])
                for g in dict.fromkeys(groups.values())}

    out, err = _vmap_tree([stacked(t) for t, _, _ in inputs],
                          [stacked(e) for _, e, _ in inputs], world)
    for r, res in enumerate(ranks[world]):
        for k, g in groups.items():
            i = int(k.split(".")[1]) if "." in k else 0
            np.testing.assert_array_equal(res[f"groups/out/{k}"],
                                          np.asarray(out[g][r][i]))
            np.testing.assert_array_equal(res[f"groups/err/{k}"],
                                          np.asarray(err[g][r][i]))


def test_pmean_and_hierarchical_psum(ranks):
    for w in (1, 2, 3, 4):
        assert [float(r["pmean"]) for r in ranks[w]] == [w / 2.0] * w
    want = np.arange(6, dtype=np.float32) * (1 + 2 + 3 + 4)
    for res in ranks[4]:
        np.testing.assert_array_equal(res["hier"], want)


def test_compressed_psum_single_device_identity(pod1):
    """On a 1-member pod the compressed mean is dequant(quant(x)) and the
    error feedback captures exactly the quantization residual."""
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(64,)),
                        dtype=torch.float32)
    out, err = col.compressed_psum(x, pod1, torch.zeros_like(x))
    np.testing.assert_allclose((out + err).numpy(), x.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_error_feedback_reduces_bias(pod1):
    """Accumulated compressed sums converge to the true sum over steps."""
    rng = np.random.default_rng(2)
    g = torch.as_tensor(rng.normal(size=(256,)) * 1e-3, dtype=torch.float32)
    err = torch.zeros_like(g)
    acc = np.zeros(256, np.float64)
    for _ in range(50):
        out, err = col.compressed_psum(g, pod1, err)
        acc += out.numpy().astype(np.float64)
    np.testing.assert_allclose(acc, g.numpy().astype(np.float64) * 50,
                               rtol=0.02, atol=5e-4)


def test_crosspod_step_on_two_ranks(jobs):
    a, b = jobs["train", 2].results()
    for k in a:     # the residuals are each pod's own
        if k.startswith("params/") or k == "losses":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert bool(a["composition_equal"]) and bool(b["composition_equal"])
    assert np.isfinite(a["losses"]).all()
    model = R._smoke_model()
    paths = leaf_paths(model)
    names = [k[6:] for k in a if k.startswith("grads/")]
    assert set(names) == set(paths)

    def stacked(res):
        tree = to_reference(model, {k: res[f"grads/{k}"] for k in names},
                            host=np.asarray)
        return jax.tree.map(jnp.asarray, tree)

    trees = [stacked(res) for res in (a, b)]
    zeros = [jax.tree.map(jnp.zeros_like, t) for t in trees]
    out, _ = _vmap_tree(trees, zeros, 2)
    for r, res in enumerate((a, b)):
        for k in names:
            path, i = paths[k]
            leaf = out
            for key in path:
                leaf = leaf[key]
            want = np.asarray(leaf[r] if i is None else leaf[r][i])
            np.testing.assert_array_equal(res[f"reduced/{k}"], want,
                                          err_msg=f"rank {r} {k}")
    assert not np.array_equal(a[f"grads/{names[0]}"],
                              b[f"grads/{names[0]}"])


def test_crosspod_step_refusals():
    from repro_torch.configs.ras_pimc import SMOKE
    from repro_torch.train import train_loop
    with pytest.raises(ValueError, match="multi-pod mesh"):
        train_loop.make_train_step(SMOKE, compress_crosspod=True)
    chunks = Mesh("chunks", None, 1, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="multi-pod mesh"):
        train_loop.make_train_step(SMOKE, compress_crosspod=True,
                                   mesh=chunks)
    pod = Mesh("pod", None, 1, 0, torch.device("cpu"))
    step = train_loop.make_train_step(SMOKE.with_(grad_accum=1),
                                      compress_crosspod=True, mesh=pod)
    state = train_loop.init_train_state(R._smoke_model())
    with pytest.raises(ValueError, match="with_error=True"):
        step(state, {})
