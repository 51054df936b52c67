"""The port's production mesh, sharding rules, dry-run cells, traced
roofline and launch plans against the reference (CPU, no card).

* ``configs.registry``'s grid and shapes, ``ModelConfig``'s estimates,
  ``launch.specs.tune_for_shape``, ``analysis.roofline.model_flops`` and
  ``scan_multiplier``: equal to JAX's for every cell and arch.
* Parameters at full ``CONFIG`` of every arch, built on the meta device
  (nothing allocated): shapes, logical axes and counts leaf by leaf
  against ``make_model_defs`` through ``convert.leaf_paths``; per-rank
  shard shapes on both production meshes, FSDP on and off, against
  ``NamedSharding(AbstractMesh, pspec_tree(...)).shard_shape``.
* The decode state at ``decode_32k`` against ``jax.eval_shape(init_cache)``
  and both ``cache_shardings``; the optimizer state against
  ``jax.eval_shape(init_train_state)``; ``batch_spec`` against
  ``batch_pspec`` on stand-in meshes.
* The trace: a SMOKE dense train step's matmul FLOPs against a count by
  hand; at world 1 the dry-run's parameter, gradient and moment bytes are
  the CPU tensors' bytes.
* Placement on 4 gloo ranks (``tests/_torch_ranks.py``, suite ``mesh``):
  ``shard_params``/``unshard`` round-trip bitwise; ``pod_mesh`` and
  ``chunk_mesh`` on a device mesh's groups give the 1-D meshes' bytes.
* The launch plan's constants against the ``constexpr`` s of ``csrc/``;
  the report's tables from a SMOKE dry-run.
"""

import math
import re
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding

import _torch_ranks as R
from repro.analysis import roofline as jroof
from repro.configs import registry as jreg
from repro.launch import mesh as jmesh, specs as jspecs
from repro.models.param import _flatten, param_count as j_param_count
from repro.models.param import abstract_params as j_abstract
from repro.models.param import pspec_tree as j_pspec_tree
from repro.models.transformer import init_cache, make_model_defs
from repro.parallel import chunked as jpc, collectives as jcol
from repro.parallel import sharding as jsharding
from repro.core import spc as jspc
from repro.train.train_loop import init_train_state as j_init_train_state
from repro_torch.analysis import hlo, report, roofline
from repro_torch.configs import registry
from repro_torch.data.pipeline import train_batch
from repro_torch.kernels import autotune, rans_decode, spc_quantize
from repro_torch.launch import dryrun, mesh, specs
from repro_torch.models import convert, init_model, param
from repro_torch.parallel import MeshError, sharding
from repro_torch.train import train_loop

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parent.parent
ARCHS = registry.ARCH_IDS
CELLS = [(a, s) for a, s, _, _ in jreg.grid()]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _abstract(multi_pod: bool):
    ms = mesh.production_mesh_shape(multi_pod=multi_pod)
    return ms, AbstractMesh(ms.sizes, ms.axis_names)


def _spec(p) -> tuple:
    """A placement per dim with a one-axis tuple as its axis (JAX's
    ``PartitionSpec`` writes ``("data",)`` as ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in p)


def _tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# the grid, the shapes and the estimates
# ---------------------------------------------------------------------------

def test_grid_matches_reference():
    got = list(registry.grid())
    assert got == list(jreg.grid())
    assert len(got) == 40 and sum(not ok for _, _, ok, _ in got) == 8
    assert registry.SHAPES.keys() == jreg.SHAPES.keys()
    for k, sh in registry.SHAPES.items():
        j = jreg.SHAPES[k]
        assert (sh.name, sh.seq_len, sh.global_batch, sh.kind) == (
            j.name, j.seq_len, j.global_batch, j.kind)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_rules_match_reference(arch, shape):
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    sh, jsh = registry.SHAPES[shape], jreg.SHAPES[shape]
    assert registry.shape_applicable(cfg, sh) == jreg.shape_applicable(
        jcfg, jsh)
    t, jt = specs.tune_for_shape(cfg, sh), jspecs.tune_for_shape(jcfg, jsh)
    for f in ("attn_impl", "attn_block", "grad_accum", "moment_dtype",
              "grad_dtype", "dtype"):
        assert getattr(t, f) == getattr(jt, f), f
    assert roofline.model_flops(t, sh) == jroof.model_flops(jt, jsh)
    assert roofline.scan_multiplier(t, sh) == jroof.scan_multiplier(jt, jsh)


@pytest.mark.parametrize("arch", ARCHS)
def test_estimates_match_reference(arch):
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    assert cfg.param_count_estimate() == jcfg.param_count_estimate()
    assert (cfg.active_param_count_estimate()
            == jcfg.active_param_count_estimate())
    assert cfg.kv_sharded == jcfg.kv_sharded
    assert cfg.is_attention_free == jcfg.is_attention_free


# ---------------------------------------------------------------------------
# parameters: shapes, axes, counts and shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_axes_match_reference(arch):
    cfg = registry.get_config(arch)
    defs = make_model_defs(jreg.get_config(arch))
    flat = dict(_flatten(defs))
    model = param.meta_model(cfg)
    assert all(p.is_meta for p in model.parameters())
    axes, ab = param.param_axes(model), param.abstract_params(cfg)
    seen = {}
    for name, (path, r) in convert.leaf_paths(model).items():
        d = flat[path]
        shape, ax = (d.shape, d.axes) if r is None else (d.shape[1:],
                                                         d.axes[1:])
        if r is not None:
            assert d.axes[0] == "layers" and r < d.shape[0]
            seen[path] = seen.get(path, 0) + 1
        assert ab[name] == (shape, param.torch_dtype(cfg)), name
        assert axes[name] == ax, name
    assert set(p for p, _ in convert.leaf_paths(model).values()) == set(flat)
    assert all(n == flat[p].shape[0] for p, n in seen.items())
    assert param.param_count(model) == j_param_count(defs)


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_shapes_match_reference(arch):
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    defs = make_model_defs(jcfg)
    flat = dict(_flatten(defs))
    model = param.meta_model(cfg)
    paths = convert.leaf_paths(model)
    for multi in (False, True):
        ms, am = _abstract(multi)
        for fsdp in (True, False):
            jp = j_pspec_tree(defs, jsharding.logical_rules(
                jcfg, multi_pod=multi, fsdp=fsdp))
            got = sharding.param_specs(model, ms, fsdp=fsdp)
            for name, p in model.named_parameters():
                path, r = paths[name]
                sh = NamedSharding(am, _tree_get(jp, path))
                try:
                    want = sh.shard_shape(flat[path].shape)
                except ValueError:     # an axis that does not divide
                    with pytest.raises(ValueError, match="does not divide"):
                        sharding.shard_shape(p.shape, got[name], ms)
                    continue
                want = want if r is None else want[1:]
                assert sharding.shard_shape(p.shape, got[name], ms) == \
                    tuple(want), (name, multi, fsdp)


def test_batch_spec_matches_reference():
    for multi in (False, True):
        ms, am = _abstract(multi)
        for b in (1, 2, 16, 32, 128, 256, 48):
            for ndim in (1, 2, 3):
                assert _spec(sharding.batch_spec(ms, b, ndim)) == _spec(
                    jsharding.batch_pspec(am, b, ndim)), (multi, b, ndim)
        assert sharding.count_collective_free(ms) == \
            jsharding.count_collective_free(am)


# ---------------------------------------------------------------------------
# decode state and optimizer state
# ---------------------------------------------------------------------------

def _cache_leaves(cache):
    """The reference's cache leaves by the port's state name (``k``/``v``
    and ``<kind>.<leaf>``): a list of (leaf, key path) in stage order."""
    out = {}
    for stage, blocks in cache.items():
        for block, groups in blocks.items():
            kind = block.split("_", 1)[1]
            for group, leaves in groups.items():
                for leaf, a in leaves.items():
                    name = leaf if group == "kv" else f"{kind}.{leaf}"
                    out.setdefault(name, []).append(
                        (a, (stage, block, group, leaf)))
    return out


@pytest.mark.parametrize("arch", ARCHS[:-1])
def test_decode_state_matches_reference(arch):
    shape = registry.SHAPES["decode_32k"]
    b, s = shape.global_batch, shape.seq_len
    jcfg = jspecs.tune_for_shape(jreg.get_config(arch), jreg.SHAPES[
        "decode_32k"])
    cache = jax.eval_shape(lambda: init_cache(jcfg, b, s))
    leaves = _cache_leaves(cache)
    for multi in (False, True):
        ms, am = _abstract(multi)
        cell = specs.build_cell(arch, "decode_32k", ms)
        assert set(cell.state) == set(leaves)
        path_specs = jspecs.cache_shardings(jcfg, am, cache, b)
        simple = jsharding.cache_shardings(jcfg, am, cache, b)
        port_simple = sharding.cache_specs(
            cell.cfg, ms, {k: sh for k, (sh, _, _) in cell.state.items()},
            b)
        for name, (shp, dt, spec) in cell.state.items():
            refs = leaves[name]
            assert shp[0] == sum(a.shape[0] for a, _ in refs), name
            for a, keys in refs:
                assert shp[1:] == a.shape[1:], name
                assert dt == getattr(torch, str(a.dtype)), name
                assert _spec(spec) == _spec(_tree_get(path_specs,
                                                      keys).spec)
                assert _spec(port_simple[name]) == _spec(
                    _tree_get(simple, keys).spec)


@pytest.mark.parametrize("arch", ARCHS[:-1])
def test_optimizer_state_matches_reference(arch):
    jcfg = jspecs.tune_for_shape(jreg.get_config(arch),
                                 jreg.SHAPES["train_4k"])
    p_abs = j_abstract(make_model_defs(jcfg), jnp.dtype(jcfg.dtype))
    st = jax.eval_shape(lambda p: j_init_train_state(
        p, moment_dtype=jnp.dtype(jcfg.moment_dtype)), p_abs)
    cell = specs.build_cell(arch, "train_4k", mesh.production_mesh_shape())
    paths = convert.leaf_paths(cell.model)
    assert len(cell.optimizer) == 2 * len(cell.params)
    for key, (shp, dt, spec) in cell.optimizer.items():
        m, name = key.split(".", 1)
        path, r = paths[name]
        leaf = _tree_get(getattr(st.opt, m), path)
        assert shp == (leaf.shape if r is None else leaf.shape[1:]), key
        assert dt == getattr(torch, str(leaf.dtype)), key
        assert spec == cell.params[name][2]


# ---------------------------------------------------------------------------
# the trace and the dry-run's bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_traced_matmul_flops_match_hand_count(remat):
    cfg = registry.get_smoke_config("ras-pimc").with_(remat=remat)
    b, s = 4, 16
    model = param.meta_model(cfg)
    batch = {"tokens": torch.zeros(b, s, dtype=torch.int64, device="meta"),
             "labels": torch.zeros(b, s, dtype=torch.int64, device="meta")}
    step = train_loop.make_train_step(cfg)
    _, tr = hlo.trace(lambda: step(train_loop.init_train_state(model), batch))
    n, d, dh = b * s, cfg.d_model, cfg.head_dim_
    hp, kv, ff, v = (cfg.n_heads_padded, cfg.n_kv_heads, cfg.d_ff,
                     cfg.vocab_padded)
    layer = (2 * n * d * (hp + 2 * kv) * dh + 2 * n * hp * dh * d
             + 2 * 2 * b * hp * s * s * dh + 3 * 2 * n * d * ff)
    forward = cfg.n_layers * layer + 2 * n * d * v
    # forward, and two products back; under remat backward runs each
    # layer's forward again up to the last tensor it saves (checkpoint's
    # early stop), so without the MLP's output product, whose output no
    # backward reads
    recompute = cfg.n_layers * (layer - 2 * n * ff * d) if remat else 0
    assert tr.flops == 3 * forward + recompute
    assert tr.saved_bytes > 0 and tr.peak_live_bytes > 0
    assert dict(hlo.op_histogram(tr, top=100)) == tr.ops


@pytest.mark.parametrize("arch", ("ras-pimc", "mixtral-8x22b", "qwen3-4b",
                                  "llama3-405b", "mamba2-130m",
                                  "recurrentgemma-2b",
                                  "llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"))
def test_world1_bytes_are_the_tensors_bytes(arch, monkeypatch):
    """At world 1 the dry-run's parameter, gradient and moment bytes are
    those of the CPU tensors of the same step (the card's counterpart runs
    in chip_smoke.py), under the compute placement (the dense archs,
    mixtral, whose experts run on 1/1 of their columns, the recurrent
    families, on 1/1 of their channels, and the vlm and audio models, their
    cross attention and encoder on 1/1 of their heads)."""
    monkeypatch.setattr(specs, "get_config", registry.get_smoke_config)
    cfg = registry.get_smoke_config(arch).with_(grad_accum=2)
    shape = registry.ShapeSpec("t", 16, 4, "train")
    cell = specs.build_cell(arch, shape, mesh.mesh_shape_for(1),
                            overrides={"grad_accum": 2})
    assert cell.comm is not None
    _, tr = hlo.trace(cell.run)
    mem = dryrun.memory(cell, tr)
    model = init_model(cfg, seed=0, device="cpu")
    state = train_loop.init_train_state(model)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (4, 16))
    batch = {k: v for k, v in train_batch(cfg, 4, 16).items()
             if k in ("memory", "enc_inputs")}
    _, grads = train_loop.grads_fn(model, {"tokens": toks, "labels": toks,
                                           **batch})

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    assert mem["param_bytes"] == nbytes(model.parameters())
    assert mem["grad_bytes"] == nbytes(grads.values())
    assert mem["optimizer_bytes"] == nbytes(
        list(state.opt.m.values()) + list(state.opt.v.values()))
    assert mem["grad_accum_bytes"] == 4 * param.param_count(model)
    assert mem["gathered_layer_bytes"] == 0
    assert hlo.collective_stats(cell)["total_bytes"] == 0   # one rank
    assert mem["total_bytes"] == sum(
        mem[k] for k in ("param_bytes", "grad_bytes", "grad_accum_bytes",
                         "optimizer_bytes", "activation_bytes"))


# an arch with cross attention over a memory
CROSS_ARCH = "llama-3.2-vision-11b"


def test_dryrun_records_and_report_tables(tmp_path, monkeypatch, capsys):
    """A SMOKE dry-run of a train, prefill and decode cell on a 2 x 2 and
    a 2 x 2 x 2 mesh and a skipped cell, written to ``tmp_path``, then the
    report's tables of those records.  The dense ``ras-pimc``'s and the
    ``llama-3.2-vision-11b``'s train, prefill and decode cells are all
    compute-placed: each records its model-axis collectives."""
    monkeypatch.setattr(specs, "get_config", registry.get_smoke_config)
    small = (registry.ShapeSpec("train_4k", 16, 64, "train"),
             registry.ShapeSpec("prefill_32k", 32, 8, "prefill"),
             registry.ShapeSpec("decode_32k", 64, 8, "decode"))
    meshes = {"2x2": mesh.MeshShape(("data", "model"), (2, 2)),
              "2x2x2": mesh.MeshShape(("pod", "data", "model"), (2, 2, 2))}
    for name, ms in meshes.items():
        for arch in ("ras-pimc", CROSS_ARCH):
            for sh in small:
                rec = dryrun.run_cell(arch, sh, out_dir=str(tmp_path),
                                      verbose=False, mesh=ms)
                assert rec["status"] == "OK", rec.get("trace")
                assert rec["mesh"] == name
                assert rec["roofline"]["collectives"]["by_axes"]["model"] > 0
                assert rec["memory"]["fits"]
        rec = dryrun.run_cell("qwen3-4b", "long_500k", out_dir=str(tmp_path),
                              verbose=False, mesh=ms)
        assert rec["status"] == "SKIP"
    recs = report.load(str(tmp_path))
    assert len(recs) == 14
    table = report.dryrun_table(recs)
    assert table.count("| OK |") == 12 and table.count("| SKIP |") == 2
    for name in meshes:
        assert len(report.roofline_table(recs, name).splitlines()) == 2 + 6
    ok = [r for r in recs if r["status"] == "OK"]
    # a train cell gathers its placed weights' FSDP shards over data twice
    # a microbatch (forward and backward), reduces the gradients over the
    # data axes and adds the model-axis collectives its step recorded
    for arch in ("ras-pimc", CROSS_ARCH):
        train = next(r for r in ok if r["shape"] == "train_4k"
                     and r["mesh"] == "2x2" and r["arch"] == arch)
        coll = train["roofline"]["collectives"]
        cell = specs.build_cell(arch, small[0], meshes["2x2"])
        cell.run()
        want = 2 * cell.cfg.grad_accum * sum(
            (math.prod(hlo.gathered_shape(cell, sh, sp))
             - math.prod(sharding.shard_shape(sh, sp, cell.mesh)))
            * dt.itemsize for sh, dt, sp in cell.params.values())
        assert coll["all-gather"]["bytes"] - sum(
            b for op, a, b, _ in cell.recorded
            if op == "all-gather" and a == "model") == want
        reduces = sum(op in ("reduce-scatter", "all-reduce") and a == "model"
                      for op, a, _, _ in cell.recorded)
        assert sum(coll.get(op, {}).get("count", 0) for op in (
            "reduce-scatter", "all-reduce")) == len(cell.params) + reduces
        assert reduces > 0
    assert coll["body_bytes"] + coll["entry_bytes"] == pytest.approx(
        train["roofline"]["collective_bytes_per_chip"])
    assert all(r["roofline"]["peak_flops"] == roofline.PEAK_FLOPS[
        "float32"] for r in ok)
    assert all(r["trace"]["flops"] > 0 for r in ok)
    monkeypatch.setattr("sys.argv", ["report", str(tmp_path)])
    report.main()
    assert "## cells: 12 OK, 2 SKIP, 0 FAIL" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# meshes and placement
# ---------------------------------------------------------------------------

def test_mesh_shapes_match_reference(monkeypatch):
    monkeypatch.setattr(jmesh.jax, "make_mesh", lambda shape, axes: (
        tuple(shape), tuple(axes)))
    for multi in (False, True):
        ms = mesh.production_mesh_shape(multi_pod=multi)
        assert (ms.sizes, ms.axis_names) == jmesh.make_production_mesh(
            multi_pod=multi)
    for n in (1, 2, 7, 8, 12, 16, 24, 250, 256):
        for mp in (16, 4):
            ms = mesh.mesh_shape_for(n, mp)
            assert (ms.sizes, ms.axis_names) == jmesh.make_mesh_for(n, mp)


def test_mesh_constructors_need_a_group(tmp_path):
    with pytest.raises(MeshError, match="process group"):
        mesh.make_production_mesh(device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "s"), 1), rank=0, world_size=1,
        timeout=timedelta(seconds=60))
    try:
        with pytest.raises(MeshError, match="256 ranks"):
            mesh.make_production_mesh(device="cpu")
        dm = mesh.make_mesh_for(1, device="cpu")
        assert mesh.mesh_shape_of(dm) == mesh.MeshShape(("data", "model"),
                                                        (1, 1))
        model = init_model(registry.get_smoke_config("ras-pimc"),
                           device="cpu")
        full = {k: p.detach() for k, p in model.named_parameters()}
        specs_ = sharding.param_specs(model, mesh.mesh_shape_of(dm))
        back = sharding.unshard(sharding.shard_params(full, specs_, dm),
                                specs_, dm)
        assert all(torch.equal(back[k], full[k]) for k in full)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh4(tmp_path_factory):
    return R.RankJob("mesh", 4, tmp_path_factory.mktemp("mesh4")).results()


def test_shard_round_trip_on_four_ranks(mesh4):
    ms = mesh.mesh_shape_for(4, 2)
    for rank, res in enumerate(mesh4):
        assert tuple(res["mesh"]) == ms.sizes
        for arch in R.MESH_ARCHS:
            assert bool(res[f"{arch}/bitwise"]), (rank, arch)
            model = param.meta_model(registry.get_smoke_config(arch))
            sp = sharding.param_specs(model, ms)
            for name, p in model.named_parameters():
                assert tuple(res[f"{arch}/shard/{name}"]) == \
                    sharding.shard_shape(p.shape, sp[name], ms)
    # the data axis splits the embedding, the model axis the vocab
    emb = [tuple(r["ras-pimc/shard/embedding"]) for r in mesh4]
    cfg = registry.get_smoke_config("ras-pimc")
    assert emb == [(cfg.vocab_padded // 2, cfg.d_model // 2)] * 4


def test_axis_groups_give_the_one_dimensional_bytes(mesh4):
    out, err = jax.vmap(lambda x, e: jcol.compressed_psum(x, "pod", e, 2),
                        axis_name="pod")(*map(jnp.stack, zip(
                            *[R.psum_inputs(r) for r in range(2)])))
    probs, syms, _ = R.chunk_case("static", 70)
    enc = jpc.encode_chunked(jnp.asarray(syms),
                             jspc.tables_from_probs(jnp.asarray(probs)),
                             R.CHUNK, backend="kernel")
    for rank, res in enumerate(mesh4):
        p = int(res["pod"][0])
        assert tuple(res["pod"]) == (rank // 2, 2)
        np.testing.assert_array_equal(res["psum/out"], np.asarray(out[p]))
        np.testing.assert_array_equal(res["psum/err"], np.asarray(err[p]))
        for f in ("buf", "start", "length", "overflow"):
            np.testing.assert_array_equal(res[f"chunks/enc/{f}"],
                                          np.asarray(getattr(enc, f)))


# ---------------------------------------------------------------------------
# the launch plan and the roofline constants
# ---------------------------------------------------------------------------

_CONSTEXPR = re.compile(
    r"constexpr\s+(?:u?int\w*|size_t|unsigned)\s+(k\w+)\s*=\s*([^;]+);")


def _constexprs(name: str) -> dict:
    text = (ROOT / "src" / "repro_torch" / "csrc" / name).read_text()
    out = {}
    for key, expr in _CONSTEXPR.findall(text):
        expr = re.sub(r"(\d+)u\b", r"\1", expr)
        try:
            out[key] = eval(expr, {}, dict(out))   # noqa: S307 — our sources
        except (NameError, SyntaxError):
            continue
    return out


def test_launch_plan_constants_match_cuda_sources():
    enc = _constexprs("rans_encode.cu")
    assert (autotune.ENCODE_PLANES, autotune.ENCODE_SMEM_TABLE_MAX,
            autotune.ENCODE_CELLS, autotune.ENCODE_BATCH,
            autotune.ENCODE_AHEAD, autotune.ENCODE_TILE,
            autotune.ENCODE_TILES) == tuple(enc[k] for k in (
                "kPlanes", "kSmemTableMax", "kCells", "kBatch", "kAhead",
                "kTile", "kTiles"))
    dec = _constexprs("rans_decode_lanes.cu")
    assert (autotune.SMEM_BYTES, autotune.MAX_WINDOW,
            autotune.SLOT_TABLE_MAX, autotune.MAX_SLOT_BITS,
            autotune.SLOT_BLOCK, autotune.WARP_BLOCK, autotune.WIN_TAB,
            autotune.ROW_RING, autotune.ROW_WORDS) == tuple(dec[k] for k in (
                "kMaxSmem", "kMaxWindow", "kSlotTableMax", "kMaxSlotBits",
                "kSlotBlock", "kWarpBlock", "kWinTab", "kRowRing",
                "kRowWords"))
    step = _constexprs("rans_decode_step.cu")
    assert (autotune.STEP_WARPS, autotune.STEP_REG_K,
            autotune.STEP_TREE_LEVELS) == (step["kWarps"], step["kRegK"],
                                           step["kTreeLevels"])
    b6 = _constexprs("spc_quantize.cu")
    assert (autotune.SPC_MAX_K, autotune.SPC_REG_MAX_K,
            autotune.SPC_ROW_WARPS, autotune.SPC_BLOCK_WARPS,
            autotune.SPC_WIDE_WARPS, autotune.SPC_WIDE_E,
            autotune.SPC_WIDE_SEG, autotune.SPC_MAX_CLUSTER,
            autotune.SPC_DIGIT_BITS) == tuple(b6[k] for k in (
                "kMaxK", "kRegMaxK", "kRowWarps", "kBlockWarps",
                "kWideWarps", "kWideE", "kWideSeg", "kMaxCluster",
                "kDigitBits"))
    # a row of SPC_MAX_K fits one portable cluster
    assert autotune.SPC_MAX_CLUSTER * autotune.SPC_WIDE_SEG >= \
        autotune.SPC_MAX_K
    # the wrappers and the roofline read the plan's one copy
    assert rans_decode.MAX_WINDOW is autotune.MAX_WINDOW
    assert rans_decode.MAX_K is autotune.DECODE_MAX_K
    assert spc_quantize.MAX_K is autotune.SPC_MAX_K
    assert roofline.SMEM_BYTES is autotune.SMEM_BYTES


def test_launch_plans():
    # B1/B5: the static table in shared memory up to 2,048 entries, 40 KB
    p = autotune.encode_plan(2048, 128, 3, "static")
    assert (p.path, p.grid, p.block) == ("static_smem", 96, 32)
    assert p.smem <= 48 * 1024
    assert autotune.encode_plan(2049, 128, 1, "static").path == "device_rows"
    assert autotune.encode_plan(256, 128, 1, "lane").path == "device_rows"
    # B3/B4: the slot table for static tables up to K = 4,096, 16 bits
    p = autotune.decode_plan(256, 128, "static", 14)
    assert (p.path, p.grid, p.branches()) == ("slot_table", 4,
                                              {"slot_table"})
    assert p.branches(zero_freq=True) == {"shared_bisect"}
    assert autotune.decode_plan(4096, 8, "static", 16).path == "slot_table"
    assert autotune.decode_plan(5000, 8, "static", 16).path == "warp_rows"
    assert autotune.decode_plan(256, 8, "static", 17).path == "warp_rows"
    # a predictor's window past the probe tables' 64 widths: the warp path
    assert autotune.decode_plan(256, 8, "static", 14, window=8,
                                delta=8).path == "slot_table"
    assert autotune.decode_plan(256, 8, "static", 14, window=40,
                                delta=40).path == "warp_rows"
    p = autotune.decode_plan(256, 128, "lane", 14)
    assert (p.path, p.grid, p.branches(True)) == ("warp_rows", 32,
                                                  {"warp_bisect"})
    for k in (2, 256, 1000, 4096):
        assert autotune.decode_plan(k, 1, "static", 16).smem <= \
            autotune.SMEM_BYTES
    # B2: the register row up to K = 380 (the warp row count, or the
    # bisection on a zero frequency); longer rows the read-ahead bisection
    # on any row
    p = autotune.decode_step_plan(380, 128)
    assert (p.path, p.branches(), p.branches(True)) == (
        "register_row", {"warp_rows"}, {"warp_bisect"})
    for k in (381, 32064, 50280):
        p = autotune.decode_step_plan(k, 128)
        assert (p.path, p.grid, p.branches(), p.branches(True)) == (
            "tree_bisect", 32, {"tree_bisect"}, {"tree_bisect"})
    assert set(rans_decode.BRANCH_BITS) >= {"tree_bisect"}
    assert len(set(rans_decode.BRANCH_BITS.values())) == \
        len(rans_decode.BRANCH_BITS)
    # B6: warp, block and cluster layouts by K; a cluster of
    # ceil(K / 8,192) blocks a row
    assert [autotune.spc_plan(8, k).path for k in (
        32, 33, 256, 1024, 1025, 16384, 16385, 65536)] == [
        "warp_e1", "warp_e2", "warp_e8", "warp_e32", "block", "block",
        "cluster", "cluster"]
    assert [(autotune.spc_plan(16, k).cluster, autotune.spc_plan(16, k).grid)
            for k in (16385, 32064, 32768, 50280, 65536)] == [
        (3, 48), (4, 64), (4, 64), (7, 112), (8, 128)]
    p = autotune.spc_plan(4096, 50280)
    assert (p.block, p.smem, p.grid) == (512, 65536, 4096 * 7)
    assert autotune.spc_plan(8, 16384).cluster == 1
    with pytest.raises(ValueError):
        autotune.spc_plan(1, 65537)


def test_roofline_constants_and_bound():
    assert roofline.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert (roofline.HBM_BYTES_PER_S, roofline.HBM_BYTES) == (3.35e12, 80e9)
    assert roofline.INT32_OPS_PER_S == 132 * 64 * 1.98e9
    ms, what = roofline.kernel_bound(3_350_000, 0)
    assert (round(ms, 9), what) == (0.001, "bytes")
    assert roofline.kernel_bound(0, 10 ** 9)[1] == "operations"
    pod = mesh.production_mesh_shape()
    assert roofline.link_rate(pod, ["model"]) == roofline.NETWORK_BYTES_PER_S
    eight = mesh.mesh_shape_for(8, 8)
    assert roofline.link_rate(eight, ["model"]) == \
        roofline.NVLINK_BYTES_PER_S
