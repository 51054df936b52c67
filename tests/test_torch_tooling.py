"""The port's launchers, examples and sweeps against JAX's (CPU, SMOKE).

* ``launch.train`` writes the checkpoints of JAX's launcher at the same
  arguments (steps, key set, shapes, dtypes).
* ``launch.serve --ckpt`` restores a checkpoint that JAX's launcher wrote,
  prints its step and round-trips bit-exactly; the restored model's
  logits are within 1e-5 of JAX's on the same parameters.  A directory
  with no complete step serves the seeded weights.
* The four examples' ``main`` run on the CPU with every check (few
  training steps where they train).
* ``bench_lanes.run`` and ``bench_chunked.run`` at small T give the bytes
  and bits of JAX's ``coder.encode_chunked``; their full reference points
  at 8 lanes equal the committed ``BENCH_lanes.json`` and
  ``BENCH_chunked.json``.
"""

import contextlib
import io
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.ras_pimc import SMOKE as J_SMOKE
from repro.core import bitstream as jbitstream
from repro.core import coder as jcoder
from repro.core import spc as jspc
from repro.data.pipeline import image_rows
from repro.launch import train as jlaunch_train
from repro.models import decode_step as j_decode_step
from repro.models import init_model as j_init_model
from repro.models import init_state as j_init_state
from repro.train import checkpoint as jcheckpoint
from repro.train import train_loop as jtrain_loop
from repro_torch.benchmarks import bench_chunked, bench_lanes
from repro_torch.configs.ras_pimc import SMOKE
from repro_torch.core import coder, spc
from repro_torch.examples import (compress_images, compress_latents,
                                  quickstart, train_small_lm)
from repro_torch.launch import serve, train
from repro_torch.models import decode_step, init_model, init_state
from repro_torch.train import checkpoint, train_loop

jax.config.update("jax_platforms", "cpu")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one CPU thread: its ops are small, and beside
    other busy test processes torch's idle worker threads spin for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TRAIN_ARGS = ["--steps", "4", "--save-every", "2", "--batch", "2",
              "--seq", "16"]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return out.getvalue(), result


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    _run(jlaunch_train.main, TRAIN_ARGS + ["--ckpt", d])
    return d


def _layout(d: str, step: int) -> dict:
    path = os.path.join(d, f"step_{step:08d}", "host0.npz")
    with np.load(path) as z:
        return {k: (z[k].shape, z[k].dtype) for k in z.files}


def test_launch_train_writes_jax_launcher_checkpoints(jax_ckpt, tmp_path):
    d = str(tmp_path)
    out, state = _run(train.main, TRAIN_ARGS + ["--ckpt", d,
                                                "--device", "cpu"])
    assert sorted(os.listdir(d)) == sorted(os.listdir(jax_ckpt)) == [
        "step_00000002", "step_00000004"]
    assert _layout(d, 4) == _layout(jax_ckpt, 4)
    assert int(state.step) == 4
    last = out.strip().splitlines()[-1]
    assert last.startswith("done: 4 steps, final loss ")
    assert last.endswith("straggler steps, 0 restarts")
    with np.load(os.path.join(d, "step_00000004", "host0.npz")) as z:
        assert int(z["step"]) == int(z["opt.step"]) == 4


def test_serve_restores_jax_checkpoint(jax_ckpt):
    out, _ = _run(serve.main, ["--ckpt", jax_ckpt, "--device", "cpu",
                               "--lanes", "2", "--symbols", "16",
                               "--backend", "kernel"])
    assert "restored checkpoint step 4" in out
    assert "bit-exact roundtrip: True" in out
    # the served parameters against JAX's on the same checkpoint
    jparams = j_init_model(J_SMOKE, jax.random.PRNGKey(0))
    jstate = jcheckpoint.restore(jax_ckpt, 4,
                                 jtrain_loop.init_train_state(jparams))
    model = init_model(SMOKE, seed=0, device="cpu")
    checkpoint.restore(jax_ckpt, 4, train_loop.init_train_state(
        model, moment_dtype="float32"))
    lanes, steps = 2, 6
    toks = np.random.default_rng(0).integers(0, 256, (lanes, steps))
    jcache = j_init_state(J_SMOKE, lanes, steps)
    state = init_state(model, lanes, steps)
    for t in range(steps):
        jlg, jcache = j_decode_step(jstate.params, jcache,
                                    jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                    jnp.int32(t), J_SMOKE)
        lg = decode_step(model, state, torch.as_tensor(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0,
                                   atol=1e-5)


def test_serve_without_a_complete_step_serves_seeded_weights(tmp_path):
    os.makedirs(tmp_path / "step_00000010.tmp0")
    out, _ = _run(serve.main, ["--ckpt", str(tmp_path), "--device", "cpu",
                               "--lanes", "2", "--symbols", "8"])
    assert "restored" not in out and "bit-exact roundtrip: True" in out


@pytest.mark.parametrize("name, argv", [
    ("quickstart", []),
    ("compress_images", []),
    ("compress_latents", ["--steps", "200"]),
    ("train_small_lm", ["--steps", "60"]),
])
def test_example_main_runs_on_cpu(name, argv):
    mod = {"quickstart": quickstart, "compress_images": compress_images,
           "compress_latents": compress_latents,
           "train_small_lm": train_small_lm}[name]
    out, result = _run(mod.main, argv + ["--device", "cpu"])
    assert result and "Traceback" not in out
    if name == "train_small_lm":
        assert result["failures"] == 0 and result["cr_lm"] > result["cr_hist"]


def _jax_chunks(rows, chunk):
    counts = np.bincount(image_rows(8, 4096, seed=0).ravel(), minlength=256)
    tbl = jax.tree.map(jnp.asarray, jspc.tables_from_counts_np(counts))
    enc = jax.tree.map(np.asarray, jcoder.encode_chunked(
        jnp.asarray(rows, jnp.int32), tbl, chunk))
    mono = np.asarray(jcoder.encode(jnp.asarray(rows, jnp.int32),
                                    tbl).length)
    return enc, mono


def _port_table():
    counts = np.bincount(image_rows(8, 4096, seed=0).ravel(), minlength=256)
    return spc.tables_from_counts_np(counts)


def test_bench_lanes_small_matches_jax_coder():
    t, chunk = 96, 32
    pts = bench_lanes.run(t=t, lane_counts=(4, 8), chunk_size=chunk,
                          device="cpu", warmup=False)
    for p in pts:
        rows = image_rows(p["lanes"], t, seed=0)
        jenc, _ = _jax_chunks(rows, chunk)
        blob = jbitstream.pack_chunked(jenc.buf, jenc.start, jenc.length,
                                       jenc.overflow, chunk_size=chunk,
                                       n_symbols=t)
        assert p["container_bytes"] == len(blob)
        assert p["backends_byte_identical"] is True
        enc = coder.encode_chunked(torch.as_tensor(rows), _port_table(),
                                   chunk)
        for a, b in zip(enc, jenc):
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("chunk_sizes", [(16, 64, 160), (16, 64)])
def test_bench_chunked_small_matches_jax_bits(chunk_sizes):
    """With and without a chunk of the whole stream (which is the
    monolithic stream the overhead is measured against)."""
    t = 160
    pts = bench_chunked.run(t=t, chunk_sizes=chunk_sizes, lane_counts=(4,),
                            device="cpu", warmup=False)
    assert [p["chunk_size"] for p in pts] == list(chunk_sizes)
    rows = image_rows(4, t, seed=0)
    for p in pts:
        jenc, mono = _jax_chunks(rows, p["chunk_size"])
        bits = float(jenc.length.sum()) * 8 / (4 * t)
        assert p["bits_per_symbol"] == bits
        assert p["flush_overhead_bits"] == bits - float(mono.sum()) * 8 / (
            4 * t)
        assert p["n_chunks"] == -(-t // p["chunk_size"])
        assert p["kernel_byte_identical"] is True


def test_sweeps_at_eight_lanes_equal_committed_points():
    lanes = bench_lanes.run(lane_counts=(8,), device="cpu", warmup=False)
    committed = json.loads((ROOT / "BENCH_lanes.json").read_text())
    assert lanes[0]["container_bytes"] == committed[0]["container_bytes"] \
        == 8599
    chunked = bench_chunked.run(lane_counts=(8,), device="cpu", warmup=False)
    ref = {p["name"]: p for p in json.loads(
        (ROOT / "BENCH_chunked.json").read_text())}
    assert [p["name"] for p in chunked] == [
        "chunked_l8_c128", "chunked_l8_c512", "chunked_l8_c2048"]
    for p in chunked:
        for k in ("bits_per_symbol", "flush_overhead_bits", "n_chunks"):
            assert p[k] == ref[p["name"]][k], (p["name"], k)
    assert chunked[0]["bits_per_symbol"] == 7.97314453125
