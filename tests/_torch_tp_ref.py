"""The reference's side of ``tests/test_torch_tensor_parallel.py``: JAX's
GSPMD-placed steps on 4 forced CPU devices, in a process of their own.

    python tests/_torch_tp_ref.py <in.npz> <out.npz>

``XLA_FLAGS=--xla_force_host_platform_device_count=4`` must be set before
JAX starts, so the test runs this file as a subprocess (its own process
keeps its single device).  ``<in.npz>`` holds, for each case of
``_torch_ranks.TP_CASES`` that the reference runs, the seeded weights as
the reference's tree (``<case>/w/<path>``) and the batches
(``<case>/b<i>/<plane>``); this process places them by
``repro.parallel.sharding.param_shardings`` and ``batch_pspec`` on a
``("data", "model")`` mesh of the case's shape, and writes to
``<out.npz>`` what one jitted function of the reference computes there:
``grads_fn``'s loss and gradients on batch 0, the prefill logits of batch
0 (``forward`` then ``logits``), and two ``make_train_step`` steps on
batches 1 and 2 (their losses and grad norms, and the parameters after
them).  The residual stream is constrained by the case's ``act_pspec``,
or by the reference's default ``(("data",), None, None)`` as its
``launch/specs.build_cell`` sets it.

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
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding

    from repro.configs import get_smoke_config
    from repro.models.layers import logits as j_logits
    from repro.models.transformer import forward, make_model_defs
    from repro.parallel.sharding import batch_pspec, param_shardings
    from repro.train import train_loop

    arch, over, (dp, tp) = R.TP_CASES[name]
    cfg = get_smoke_config(arch).with_(**over)
    if cfg.act_pspec is None:
        cfg = cfg.with_(act_pspec=(("data",), None, None))
    mesh = jax.make_mesh((dp, tp), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    params = jax.tree.map(jnp.asarray, _tree(
        {k[len(name) + 3:]: v for k, v in inp.items()
         if k.startswith(f"{name}/w/")}))
    batches = [{p: jnp.asarray(inp[f"{name}/b{i}/{p}"])
                for p in ("tokens", "labels")} for i in range(3)]
    p_shard = param_shardings(cfg, mesh, make_model_defs(cfg))
    b_shard = {p: NamedSharding(mesh, batch_pspec(mesh, R.TP_BATCH, 2))
               for p in ("tokens", "labels")}
    step = train_loop.make_train_step(cfg, base_lr=R.TP_LR)

    def fn(params, b0, b1, b2):
        loss, grads = train_loop.grads_fn(params, b0, cfg)
        x, _ = forward(params, b0["tokens"], cfg)
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


def main(argv: list[str]) -> int:
    src, dst = argv
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
        for k, v in run_case(name, inp).items():
            res[f"{name}/{k}"] = v
    np.savez(dst, **res)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
