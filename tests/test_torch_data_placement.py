"""A placed model with rows over ``data`` (and ``pod``): the train step on
batches the batch axes do not divide, compress, the engine, and the
cross-pod int8 step under the compute placement (CPU, gloo ranks, against
JAX where it has a counterpart, else against the port's own paths).

The rank programs are ``tests/_torch_ranks.py``'s suites ``data_train``
(4 ranks) and ``data_serve`` (1, 2 and 4 ranks), all spawned at once with
the JAX process (``tests/_torch_tp_ref.py`` on 4 forced CPU devices).

* The train step (``_torch_ranks.TP_ROWS``): 3 rows on a ``(2, 2)`` mesh
  (``ras-pimc``, and ``phi3.5-moe`` with its load-balance loss), 6 rows
  in 2 microbatches of 3 (``qwen3-4b``), 2 rows on a ``(pod 2, data 2,
  model 1)`` mesh.  Each batch lies over the axes that divide it and whole
  on the ranks of the rest, as the reference's ``batch_pspec`` places it.
  Loss, gradients, logits, two steps and the parameters after them within
  1e-5 of each leaf's largest entry of JAX's GSPMD step and of the port's
  one-rank step.
* The cross-pod step (``_torch_ranks.CROSSPOD``: ``ras-pimc`` on ``(pod
  2, data 1, model 2)`` and ``(2, 2, 1)``, ``phi3.5-moe`` on ``(2, 1,
  2)`` with its experts over model): bitwise its composition on every
  rank (the pod's placed gradients, the int8 ring with one whole scale
  per group of ``crosspod_groups`` over the rank's shards, the clip,
  AdamW); against the reference's own ``make_train_step(
  compress_crosspod=True, mesh)`` (its ``pod_step`` runs on JAX 0.9
  here): each pod's gradients within 1e-5, one scale per leaf of the
  reference's stacked tree (a stage's stack of blocks) within 1e-6
  relative of the reference's quantizer on JAX's pod gradients, the
  reduce equal to the reference's ``compressed_psum_tree`` of JAX's pod
  gradients in that stacked tree and each pod's residuals the reference
  step's own, element for element but for counted one-code differences
  at rounding boundaries, the step-0 parameters unchanged, both losses
  and the first grad norm within 1e-5.
* Compress (``_torch_ranks.DATA_COMPRESS``) on ``(2, 2)`` and ``(4, 1)``,
  4 lanes and 3 (whole on both data ranks): every rank writes the same
  container on both backends and decodes it exactly on every backend and
  two-pass; which placements give the whole model's bytes.
* The engine (``_torch_ranks.DATA_ENGINE``) placed on ``(1, 1)``, ``(1,
  2)`` and ``(2, 2)``: its blobs the placed single-request path's, and at
  ``(1, 1)`` the unplaced engine's, bit for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import _torch_ranks as R
from repro.parallel import collectives as jcol
from repro_torch.models.convert import leaf_paths, to_reference

jax.config.update("jax_platforms", "cpu")

HERE = Path(__file__).resolve().parent
SERVE_WORLDS = (1, 2, 4)
ENC = ("buf", "start", "length", "overflow")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_inputs(path: Path) -> None:
    inp = {}
    for name in list(R.TP_ROWS) + list(R.CROSSPOD):
        R.flat_tree(to_reference(R.tp_model(name)), f"{name}/w", inp)
        for i in range(3):
            for plane, a in R.tp_batch(name, i).items():
                inp[f"{name}/b{i}/{plane}"] = a
    np.savez(path, **inp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the train ranks' results, JAX's, the one-rank results by case,
    the serve ranks' results by world): every group and the JAX process
    at once, the one-rank steps here meanwhile."""
    tmp = tmp_path_factory.mktemp("data")
    _reference_inputs(tmp / "in.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               TP_REF_JAX_CACHE=str(HERE.parent / ".pytest_cache" / "jax"),
               PYTHONPATH=os.pathsep.join(
                   [str(R.SRC)] + [p for p in [os.environ.get(
                       "PYTHONPATH")] if p]))
    log = open(tmp / "jax.log", "w")
    ref = subprocess.Popen([sys.executable, str(HERE / "_torch_tp_ref.py"),
                            str(tmp / "in.npz"), str(tmp / "out.npz")],
                           env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        train = R.RankJob("data_train", 4, tmp)
        serve = {w: R.RankJob("data_serve", w, tmp) for w in SERVE_WORLDS}
        one = {name: R.tp_outputs(R.tp_model(name), name)
               for name in R.TP_ROWS}
        ranks = train.results(timeout=240)
        served = {w: job.results(timeout=240) for w, job in serve.items()}
        ref.wait(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
        log.close()
    if ref.returncode:
        raise RuntimeError("the reference's steps failed:\n"
                           + (tmp / "jax.log").read_text()[-4000:])
    with np.load(tmp / "out.npz") as z:
        jax_out = {k: z[k] for k in z.files}
    return ranks, jax_out, one, served


def _case(res: dict, name: str) -> dict:
    return {k[len(name) + 1:]: v for k, v in res.items()
            if k.startswith(f"{name}/")}


# ---------------------------------------------------------------------------
# the train step on a batch the batch axes do not divide
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(R.TP_ROWS))
def test_rows_cases_do_not_divide_over_the_batch_axes(name):
    """Each case's batch (or microbatch) leaves a batch axis it does not
    divide: its rows lie whole on that axis's ranks."""
    _, over, dims, rows = R.TP_ROWS[name]
    sizes = dict(zip(R.mesh_names(dims), dims))
    micro = rows // over.get("grad_accum", 1)
    assert micro % (sizes.get("pod", 1) * sizes["data"]), name


@pytest.mark.parametrize("name", list(R.TP_ROWS))
def test_placed_step_on_indivisible_batch_matches_reference(runs, name):
    """Loss, gradients, logits, two steps' losses and grad norms and the
    parameters after them within 1e-5 of each leaf's largest entry of
    JAX's GSPMD-placed step and of the one-rank step; MoE routing the
    one rank's; every rank returns the same whole results."""
    ranks, jax_out, one, _ = runs
    placed = _case(ranks[0], name)
    got = R.as_reference(name, placed)
    want_jax = _case(jax_out, name)
    want_one = R.as_reference(name, one[name])
    if "ids" in want_one:
        np.testing.assert_array_equal(got.pop("ids"), want_one.pop("ids"),
                                      err_msg=f"{name}: routing differs")
    assert set(want_jax) == set(got) == set(want_one)
    for k in sorted(got):
        R.close(got[k], want_jax[k], f"{name} {k}: placed port vs JAX")
        R.close(got[k], want_one[k], f"{name} {k}: placed vs one rank")
    for r in range(1, 4):
        for k in placed:
            if not k.startswith("shard/"):
                np.testing.assert_array_equal(ranks[r][f"{name}/{k}"],
                                              placed[k], err_msg=k)


# ---------------------------------------------------------------------------
# the cross-pod step under the compute placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(R.CROSSPOD))
def test_crosspod_placed_step_equals_its_composition(runs, name):
    """On every rank the step is bitwise the pod's placed gradients, the
    int8 ring with each group's whole scale, the clip over the pod's
    shards, lr and AdamW (the residuals and the pods' mean loss too); the
    ranks of both pods hold the same parameters, reduced gradients and
    losses, the ranks of a pod the same residuals."""
    ranks = runs[0]
    res = [_case(r, name) for r in ranks]
    assert sorted(int(r["pod"]) for r in res) == [0, 0, 1, 1]
    for r in res:
        assert bool(r["composition_equal"]), name
    for k in res[0]:
        if k.startswith(("params/", "reduced/", "step")):
            for r in res[1:]:
                np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)
        if k.startswith("error/"):      # each pod's own
            for r in res[1:]:
                if r["pod"] == res[0]["pod"]:
                    np.testing.assert_array_equal(r[k], res[0][k],
                                                  err_msg=k)


def _port_leaves(name: str, flat: dict, prefix: str) -> dict:
    """The reference's flattened tree under ``prefix`` as the port's
    parameter names (a stacked leaf's repeat ``r`` for each block)."""
    out = {}
    for k, (path, r) in leaf_paths(R.tp_model(name)).items():
        a = flat[f"{prefix}/" + "/".join(path)]
        out[k] = a if r is None else a[r]
    return out


def _codes(red: np.ndarray, scales: list, n: int) -> np.ndarray:
    """The int32 sums of ``n`` pods' int8 codes behind an int8 mean
    ``red`` whose pods' scales are ``scales`` (``red = acc * (sum(scales)
    / n) / n``), checked to give ``red`` back."""
    unit = np.float32(sum(scales)) / n / n
    acc = np.rint(red / unit).astype(np.int64)
    np.testing.assert_allclose(acc * unit, red, rtol=1e-6,
                               atol=float(unit) * 1e-3)
    return acc


def _boundary_codes(got, want, pods, tol: float) -> int:
    """The entries where the int32 code sums ``got`` and ``want`` differ:
    each must be one code apart and have a pod whose value ``x / scale``
    lies within ``tol`` codes of a rounding boundary; returns their
    count."""
    diff = np.nonzero(got != want)
    if not diff[0].size:
        return 0
    assert (np.abs(got[diff] - want[diff]) == 1).all()
    near = np.zeros(diff[0].size, bool)
    for x, scale in pods:
        frac = np.abs(x[diff] / scale)
        near |= np.abs(frac - np.floor(frac) - 0.5) <= tol
    assert near.all(), (diff, near)
    return int(diff[0].size)


def _stacked(name: str, res: dict, group: str) -> dict:
    """A port result by parameter name (``<group>/<name>``) as the
    reference's flattened stacked tree (``<path>`` -> the leaf stacking
    its blocks' tensors over the stage's repeats)."""
    tensors = {k[len(group) + 1:]: v for k, v in res.items()
               if k.startswith(f"{group}/")}
    out = {}
    R.flat_tree(to_reference(R.tp_model(name), tensors, host=np.asarray),
                group, out)
    return {k[len(group) + 1:]: v for k, v in out.items()}


@pytest.mark.parametrize("name", list(R.CROSSPOD))
def test_crosspod_placed_step_matches_reference(runs, name):
    """Against the reference's own ``make_train_step(compress_crosspod=
    True, mesh)`` on the same mesh (its ``pod_step``): each pod's
    gradients within 1e-5 of each block's largest entry; one scale per
    leaf of the reference's stacked tree, each within 1e-6 relative of
    the reference's quantizer on JAX's pod gradient of that leaf; the
    reduce equal to the reference's ``compressed_psum_tree`` of JAX's pod
    gradients in the stacked tree, element for element, and each pod's
    residuals after step 0 the reference step's own (within the
    gradients' tolerance), but where a pod's value lies within that
    tolerance of a rounding boundary (one code apart there; counted and
    printed); the step-0 parameters unchanged (``cosine_lr(0) = 0``),
    both steps' losses and the first grad norm within 1e-5 of the
    reference step's."""
    ranks, jax_out, _, _ = runs
    res = {int(r[f"{name}/pod"]): _case(r, name) for r in ranks}
    want = _case(jax_out, name)
    n = len(res)
    leaves = sorted({"/".join(path) for path, _ in
                     leaf_paths(R.tp_model(name)).values()})
    pods = [{k: want[f"pod{p}/grads/{k}"] for k in leaves} for p in range(n)]
    stacked = {k: jnp.stack([jnp.asarray(t[k]) for t in pods])
               for k in leaves}
    red, _ = jax.vmap(
        lambda t, e: jcol.compressed_psum_tree(t, "pod", e, n),
        axis_name="pod")(stacked, jax.tree.map(jnp.zeros_like, stacked))
    for p in range(n):
        blocks = _port_leaves(name, want, f"pod{p}/grads")
        for k, v in blocks.items():
            R.close(res[p][f"grads/{k}"], v,
                    f"{name} pod {p} {k}: placed port vs JAX")
    # a gradient within 1e-5 of its block's largest entry is within
    # 127e-5 codes of its stacked leaf's scale, the scale's 1e-6 relative
    # moves it 127e-6 more
    tol = 127 * (1e-5 + 1e-6)
    got_red = _stacked(name, res[0], "reduced")
    got = [(_stacked(name, res[p], "grads"), _stacked(name, res[p], "error"))
           for p in range(n)]
    counts, residual_counts = {}, {}
    for p in range(n):
        assert sorted(k[6:] for k in res[p] if k.startswith("scale/")) \
            == leaves, f"{name}: one scale per reference leaf"
    for k in leaves:
        scales = [float(jcol.quantize_int8(jnp.asarray(t[k]))[1])
                  for t in pods]
        got_scales = [float(res[p][f"scale/{k}"]) for p in range(n)]
        np.testing.assert_allclose(got_scales, scales, rtol=1e-6,
                                   err_msg=f"{name} {k}: scales")
        counts[k] = _boundary_codes(
            _codes(got_red[k], got_scales, n),
            _codes(np.asarray(red[k][0]), scales, n),
            [(g[k], s) for g, s in zip(pods, scales)], tol)
        for p in range(n):
            (g, e), s = (got[p][0][k], got[p][1][k]), got_scales[p]
            g_ref, e_ref = pods[p][k], want[f"pod{p}/error/{k}"]
            q, q_ref = (np.rint((a - b) / c) for a, b, c in
                        ((g, e, s), (g_ref, e_ref, scales[p])))
            residual_counts[p, k] = _boundary_codes(
                q, q_ref, [(g_ref, scales[p])], tol)
            same = q == q_ref
            np.testing.assert_allclose(
                e[same], e_ref[same], rtol=0, atol=scales[p] * (tol + 1e-4),
                err_msg=f"{name} pod {p} {k}: residuals")
    print(f"{name}: {len(leaves)} scales; {sum(counts.values())} one-code "
          f"differences at rounding boundaries of "
          f"{sum(v.size for v in pods[0].values())} reduced entries",
          {k: v for k, v in counts.items() if v},
          f"; {sum(residual_counts.values())} in the pods' residuals")
    initial = {k: p.detach().numpy() for k, p in
               R.tp_model(name).named_parameters()}
    after = _port_leaves(name, want, "params")
    for k, v in initial.items():
        np.testing.assert_array_equal(res[0][f"params/{k}"], v, err_msg=k)
        np.testing.assert_array_equal(after[k], v, err_msg=k)
    for key in ("step0/loss", "step1/loss", "step0/grad_norm"):
        R.close(res[0][key], want[key], f"{name} {key}")


# ---------------------------------------------------------------------------
# compress and the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(R.DATA_COMPRESS))
def test_data_placed_compress_round_trip(runs, name):
    """Every rank writes the same container, the coder and kernel
    backends the same bytes; on the same placement it decodes exactly on
    both backends, two-pass and the monolithic pair, with the same
    per-lane probes on every backend."""
    served = runs[3][4]
    a = _case(served[0], name)
    for r in served[1:]:
        for k, v in _case(r, name).items():
            np.testing.assert_array_equal(v, a[k], err_msg=f"{name} {k}")
    lanes = R.DATA_COMPRESS[name][3]
    toks = R.lm_tokens()[:lanes, :R.TP_COMPRESS_T]
    for f in ENC:
        np.testing.assert_array_equal(a[f"coder/enc/{f}"],
                                      a[f"kernel/enc/{f}"])
    for be in ("coder", "kernel", "two_pass", "mono"):
        np.testing.assert_array_equal(a[f"{be}/dec/sym"], toks, err_msg=be)
    for be in ("coder", "two_pass"):
        np.testing.assert_array_equal(a[f"{be}/dec/lane_probes"],
                                      a["kernel/dec/lane_probes"])


def test_data_placed_containers_name_their_placements(runs):
    """Which placements price as the whole model does on this CPU: their
    containers are the whole model's bytes, and the whole model decodes
    them; every other container decodes on its own placement (above).
    Printed; a container equal to the whole model's must decode there."""
    served = runs[3][4][0]
    whole = {}
    for name in R.DATA_COMPRESS:
        a = _case(served, name)
        same = all(np.array_equal(a[f"whole/enc/{f}"], a[f"kernel/enc/{f}"])
                   for f in ENC)
        whole[name] = same
        if same:
            assert bool(a["whole/decodes"]), name
    print("containers equal to the whole model's, by placement:", whole)


def test_placed_state_of_rows_the_data_axis_does_not_divide(runs):
    """A decode state of 3 rows on (2, 2) lies whole on both data ranks:
    ``unplace_state(state, 3)`` gives the whole state (within 1e-5 of the
    whole model's after the same steps), and ``place_state`` of it the
    rank's shards back, bitwise, on every rank."""
    served = runs[3][4]
    for res in served:
        assert bool(res["rows3/place_state_bitwise"])
        for k in [k for k in res if k.startswith("rows3/state/")]:
            want = res["rows3/whole/" + k[len("rows3/state/"):]]
            assert res[k].shape == want.shape and want.shape[1] == 3, k
            R.close(res[k], want, k)
            np.testing.assert_array_equal(res[k], served[0][k])


@pytest.mark.parametrize("arch", R.DATA_ENGINE)
@pytest.mark.parametrize("world", SERVE_WORLDS)
def test_placed_engine_matches_single_request(runs, world, arch):
    """A placed SMOKE model served by ``BatchEngine`` (slots of 2 lanes)
    on a ``(1, world)`` mesh, or ``(2, 2)`` at 4 ranks: every blob is the
    placed single-request ``lm_compress_chunked``'s, the first decodes
    exactly through the engine, every rank returns the same; at ``(1,
    1)`` the blobs, tokens and probes are the unplaced engine's, bit for
    bit."""
    served = runs[3][world]
    a = _case(served[0], f"engine/{arch}")
    for r in served[1:]:
        for k, v in _case(r, f"engine/{arch}").items():
            np.testing.assert_array_equal(v, a[k], err_msg=f"{arch} {k}")
    toks = R.engine_tokens()
    for i in range(len(toks)):
        np.testing.assert_array_equal(a[f"blob{i}"], a[f"single{i}"],
                                      err_msg=f"{arch} request {i}")
    np.testing.assert_array_equal(a["tokens"], toks[0])
    if world == 1:
        for k in [k for k in a if k.startswith("unplaced/")]:
            np.testing.assert_array_equal(a[k], a[k[len("unplaced/"):]],
                                          err_msg=k)
