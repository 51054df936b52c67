"""The reference's side of ``tests/test_torch_tensor_parallel.py`` and
``tests/test_torch_data_placement.py``: JAX's GSPMD-placed steps on 4
forced CPU devices, in a process of their own.

    python tests/_torch_tp_ref.py <in.npz> <out.npz> [decode]

``XLA_FLAGS=--xla_force_host_platform_device_count=4`` must be set before
JAX starts, so the test runs this file as a subprocess (its own process
keeps its single device).  ``<in.npz>`` holds, for each case of
``_torch_ranks.TP_CASES`` or ``TP_ROWS`` that the reference runs, the
seeded weights as the reference's tree (``<case>/w/<path>``) and the
batches (``<case>/b<i>/<plane>``); this process places them by
``repro.parallel.sharding.param_shardings`` and ``batch_pspec`` (every
plane of the batch: a ``vlm`` case's memory, an ``audio`` case's encoder
inputs; a batch the batch axes do not divide lies whole on the ranks of
those it skips) on a ``("data", "model")`` or ``("pod", "data",
"model")`` mesh of the case's shape, and writes to
``<out.npz>`` what one jitted function of the reference computes there:
``grads_fn``'s loss and gradients on batch 0, the prefill logits of batch
0 (``forward`` then ``logits``), and two ``make_train_step`` steps on
batches 1 and 2 (their losses and grad norms, and the parameters after
them).  The residual stream is constrained by the case's ``act_pspec``,
or by the reference's default, the batch's ``batch_pspec`` axes, as its
``launch/specs.build_cell`` sets it.  A case of ``_torch_ranks.CROSSPOD``
runs the reference's cross-pod step instead (:func:`run_crosspod`).

With ``decode``, ``<in.npz>`` holds for each case of
``_torch_ranks.TP_DECODE`` its geometry's weights (``<case>/w/<path>``),
its tokens, for per-row positions each step's positions and, for a
model with cross attention, its memory (``<case>/memory``), and this
process runs the reference's serving cell as ``launch/specs.build_cell``
builds it (``serve_step``): ``decode_step`` jitted with the parameters by
``param_shardings``, the cache by ``repro.launch.specs.cache_shardings``
(the kv heads over ``model`` when ``cfg.kv_sharded``, else the ring's
slots), the tokens and the memory by ``batch_pspec`` and the logits left
``(batch, "model")``; it writes each step's logits, the final cache's
leaves as the port's state leaves (``state/k``, ``state/v`` and the
recurrent ``state/ssm.h``, ``state/ssm.conv``, ``state/rec.h``,
``state/rec.conv``, each stacked by kind in depth order) and, for a
dense model, the logits of ``prefill_chunk`` (placed the same way) over
the first ``TP_PREFILL`` tokens of a fresh cache (the reference's MoE
prefill runs the capacity dispatch over the chunk and drops tokens; the
port's runs the steps' FFN per position and drops none, so the port
holds it to its own steps instead; a recurrent or cross-attention model
does not prefill).

On JAX 0.9 ``jax.make_mesh`` defaults to ``Explicit`` axes, under which
``with_sharding_constraint`` fails an assert; the mesh is built with
``AxisType.Auto`` axes, as GSPMD's placement reads them.  Nothing of the
reference is edited.
"""

from __future__ import annotations

import os
import sys

import numpy as np

import _torch_ranks as R


def _tree(flat: dict) -> dict:
    out: dict = {}
    for path, a in flat.items():
        node = out
        *keys, leaf = path.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = a
    return out


def _flat(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = np.asarray(tree, np.float32)


def run_case(name: str, inp: dict) -> dict:
    import jax

    from repro.configs import get_smoke_config
    from repro.models.layers import logits as j_logits
    from repro.models.transformer import forward
    from repro.parallel.sharding import batch_pspec
    from repro.train import train_loop

    arch, over, dims, rows = R.tp_case(name)
    cfg = get_smoke_config(arch).with_(**over)
    mesh = _mesh(dims)
    if cfg.act_pspec is None:
        cfg = cfg.with_(act_pspec=(batch_pspec(mesh, rows, 1)[0], None,
                                   None))
    params, batches, p_shard, b_shard = _placed_inputs(name, inp, cfg, mesh,
                                                       rows)
    step = train_loop.make_train_step(cfg, base_lr=R.TP_LR)

    def fn(params, b0, b1, b2):
        loss, grads = train_loop.grads_fn(params, b0, cfg)
        x, _ = forward(params, b0["tokens"], cfg, memory=b0.get("memory"),
                       enc_inputs=b0.get("enc_inputs"))
        lg = j_logits(params["tok"], x, cfg)
        state = train_loop.init_train_state(params)
        metrics = []
        for b in (b1, b2):
            state, m = step(state, b)
            metrics.append(m)
        return loss, grads, lg, metrics, state.params

    with jax.set_mesh(mesh):
        out = jax.jit(fn, in_shardings=(p_shard, b_shard, b_shard,
                                        b_shard))(params, *batches)
    loss, grads, lg, metrics, new = jax.device_get(out)
    res = {"loss": np.asarray(loss), "logits": np.asarray(lg, np.float32)}
    for i, m in enumerate(metrics):
        res[f"step{i}/loss"] = np.asarray(m["loss"])
        res[f"step{i}/grad_norm"] = np.asarray(m["grad_norm"])
    _flat(grads, "grads", res)
    _flat(new, "params", res)
    return res


def _mesh(dims: tuple):
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh(tuple(dims), R.mesh_names(dims),
                         axis_types=(AxisType.Auto,) * len(dims))


def _placed_inputs(name: str, inp: dict, cfg, mesh, rows: int):
    """A case's parameters, its three batches and their shardings
    (``param_shardings``; every batch plane by ``batch_pspec``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.models.transformer import make_model_defs
    from repro.parallel.sharding import batch_pspec, param_shardings

    params = jax.tree.map(jnp.asarray, _tree(
        {k[len(name) + 3:]: v for k, v in inp.items()
         if k.startswith(f"{name}/w/")}))
    planes = sorted(k.split("/")[-1] for k in inp
                    if k.startswith(f"{name}/b0/"))
    batches = [{p: jnp.asarray(inp[f"{name}/b{i}/{p}"]) for p in planes}
               for i in range(3)]
    p_shard = param_shardings(cfg, mesh, make_model_defs(cfg))
    b_shard = {p: NamedSharding(mesh, batch_pspec(mesh, rows,
                                                  batches[0][p].ndim))
               for p in planes}
    return params, batches, p_shard, b_shard


def run_crosspod(name: str, inp: dict) -> dict:
    """A case of ``_torch_ranks.CROSSPOD`` on the reference's own
    cross-pod step, ``make_train_step(compress_crosspod=True, mesh)``
    (its ``pod_step`` in a ``shard_map`` over ``pod``, ``data`` and
    ``model`` left to GSPMD): two steps on batches 0 and 1 (their losses
    and grad norms, the parameters after the first, and each pod's
    residuals after the first, ``pod<p>/error``, by its stacked tree);
    and, by the same ``shard_map`` over ``pod`` of the reference's
    ``grads_fn`` (with ``inner_cfg``'s ``act_pspec``), each pod's
    gradients of batch 0 (``pod<p>/grads``), whose int8 reduce the test
    runs on the reference's stacked tree."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_smoke_config
    from repro.parallel.sharding import batch_pspec
    from repro.train import train_loop

    arch, over, dims, rows = R.tp_case(name)
    cfg = get_smoke_config(arch).with_(**over)
    mesh = _mesh(dims)
    cfg = cfg.with_(act_pspec=(batch_pspec(mesh, rows, 1)[0], None, None))
    inner = cfg.with_(act_pspec=(("data",), None, None))
    params, batches, p_shard, b_shard = _placed_inputs(name, inp, cfg, mesh,
                                                       rows)
    step = train_loop.make_train_step(cfg, base_lr=R.TP_LR,
                                      compress_crosspod=True, mesh=mesh)

    def pod_grads(params, batch):
        _, grads = train_loop.grads_fn(params, batch, inner)
        return jax.tree.map(lambda g: g[None], grads)

    def fn(params, b0, b1):
        grads = jax.shard_map(
            pod_grads, mesh=mesh,
            in_specs=(jax.tree.map(lambda x: P(), params),
                      jax.tree.map(lambda x: P("pod"), b0)),
            out_specs=jax.tree.map(lambda x: P("pod"), params),
            axis_names=frozenset({"pod"}), check_vma=False)(params, b0)
        state = train_loop.init_train_state(params, with_error=True)
        state, m0 = step(state, b0)
        after, error = state.params, state.error
        _, m1 = step(state, b1)
        return grads, after, error, [m0, m1]

    with jax.set_mesh(mesh):
        grads, after, error, metrics = jax.jit(
            fn, in_shardings=(p_shard, b_shard, b_shard))(params,
                                                          *batches[:2])
    res = {}
    for p in range(mesh.shape["pod"]):
        _flat(jax.tree.map(lambda g: np.asarray(g)[p], grads),
              f"pod{p}/grads", res)
        _flat(jax.tree.map(lambda e: _pod_value(e, mesh, p), error),
              f"pod{p}/error", res)
    _flat(jax.device_get(after), "params", res)
    for i, m in enumerate(jax.device_get(metrics)):
        res[f"step{i}/loss"] = np.asarray(m["loss"])
        res[f"step{i}/grad_norm"] = np.asarray(m["grad_norm"])
    return res


def _pod_value(a, mesh, p: int) -> np.ndarray:
    """What pod ``p``'s devices hold of ``a``: ``pod_step``'s residuals
    leave its ``shard_map`` as if replicated over ``pod`` (its
    ``out_specs`` name no ``pod``, ``check_vma=False``), but each pod's
    devices keep their own pod's."""
    devs = set(mesh.devices[p].flat)
    out = np.zeros(a.shape, np.float32)
    seen = np.zeros(a.shape, bool)
    for sh in a.addressable_shards:
        if sh.device in devs:
            out[sh.index] = np.asarray(sh.data)
            seen[sh.index] = True
    assert seen.all(), f"pod {p} does not hold all of a leaf {a.shape}"
    return out


def run_decode(name: str, inp: dict) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

    from repro.configs import get_smoke_config
    from repro.launch.specs import cache_shardings
    from repro.models.transformer import (decode_step, init_cache,
                                          make_model_defs, prefill_chunk)
    from repro.parallel.sharding import batch_pspec, param_shardings

    tp_name, rows, length, steps = R.TP_DECODE[name]
    arch, over, (dp, tp) = R.TP_CASES[tp_name]
    cfg = get_smoke_config(arch).with_(**over)
    b = R.TP_BATCH
    mesh = jax.make_mesh((dp, tp), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    params = jax.tree.map(jnp.asarray, _tree(
        {k[len(name) + 3:]: v for k, v in inp.items()
         if k.startswith(f"{name}/w/")}))
    tokens = np.asarray(inp[f"{name}/tokens"], np.int32)
    pos0 = np.asarray(inp[f"{name}/pos0"], np.int32)
    p_shard = param_shardings(cfg, mesh, make_model_defs(cfg))
    c_shard = cache_shardings(cfg, mesh, jax.eval_shape(
        lambda: init_cache(cfg, b, length)), b)
    t_shard = NamedSharding(mesh, batch_pspec(mesh, b, 2))
    rep = NamedSharding(mesh, P())
    lg_shard = NamedSharding(mesh, P(batch_pspec(mesh, b, 1)[0], "model"))
    shards = (p_shard, c_shard, t_shard, rep)
    mem = ()
    if f"{name}/memory" in inp:
        mem = (inp[f"{name}/memory"],)
        shards += (NamedSharding(mesh, batch_pspec(mesh, b, 3)),)
    step = jax.jit(lambda p, c, t, pos, *m: decode_step(p, c, t, pos, cfg,
                                                        *m),
                   in_shardings=shards, out_shardings=(lg_shard, c_shard))
    chunk = jax.jit(lambda p, c, t, p0, nv: prefill_chunk(p, c, t, p0, nv,
                                                          cfg),
                    in_shardings=(p_shard, c_shard, t_shard, rep, rep))
    res, lgs = {}, []
    fresh = jax.tree.map(np.asarray, init_cache(cfg, b, length))
    with jax.set_mesh(mesh):
        cache = fresh
        for t in range(steps):
            pos = (np.asarray(inp[f"{name}/pos"][t], np.int32) if rows
                   else np.int32(t))
            lg, cache = step(params, cache, tokens[:, t:t + 1], pos, *mem)
            lgs.append(np.asarray(lg, np.float32))
        if R.tp_prefills(name) and cfg.family != "moe":
            lg, _ = chunk(params, fresh,
                          tokens[:, :R.TP_PREFILL], pos0,
                          np.full((b,), R.TP_PREFILL, np.int32))
            res["prefill_logits"] = np.asarray(lg, np.float32)
    res["logits"] = np.stack(lgs)
    for k, a in _state_leaves(cfg, jax.device_get(cache)).items():
        res[f"state/{k}"] = a
    return res


def _state_leaves(cfg, cache) -> dict:
    """The reference's cache as the port's state leaves: every block's
    leaves stacked by kind in depth order (``k``/``v`` of the attention
    kinds, ``<kind>.<leaf>`` of the recurrent ones), the reference's tree
    holding each stage block's leaves with a leading repetition axis."""
    out: dict = {}
    for i, (pat, reps) in enumerate(cfg.stages):
        for r in range(reps):
            for j, kind in enumerate(pat):
                c = cache[f"s{i}"][f"b{j}_{kind}"]
                if kind == "cross":         # attends the memory, no state
                    continue
                if kind in ("ssm", "rec"):
                    leaves = {f"{kind}.{k}": c[kind][k][r]
                              for k in ("conv", "h")}
                else:
                    leaves = {k: c["kv"][k][r] for k in ("k", "v")}
                for k, a in leaves.items():
                    out.setdefault(k, []).append(np.asarray(a, np.float32))
    return {k: np.stack(v) for k, v in out.items()}


def main(argv: list[str]) -> int:
    src, dst, *mode = argv
    import jax
    jax.config.update("jax_platforms", "cpu")
    cache = os.environ.get("TP_REF_JAX_CACHE")
    if cache:
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    if jax.device_count() != 4:
        raise RuntimeError(f"{jax.device_count()} JAX devices; run with "
                           "XLA_FLAGS=--xla_force_host_platform_device_count"
                           "=4")
    with np.load(src) as z:
        inp = {k: z[k] for k in z.files}
    cases = sorted({k.split("/")[0] for k in inp})
    res = {}
    for name in cases:
        run = (run_decode if mode == ["decode"] else
               run_crosspod if name in R.CROSSPOD else run_case)
        for k, v in run(name, inp).items():
            res[f"{name}/{k}"] = v
    np.savez(dst, **res)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
