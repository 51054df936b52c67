"""The card script's plan and its workers, on the CPU (no card).

``chip_smoke.py`` runs its timed kernel comparisons in the parent alone,
then the other phases in worker processes on the one card
(``chip_smoke.PLAN``).  Here, without a card:

* the plan: every phase of the one-process order (``chip_smoke.PHASES``)
  runs exactly once, in the parent or in one worker, in that order; the
  timed kernel phases are the parent's; the heavy phases share one
  worker; a phase that reads another's object runs in its producer's
  worker, after it (or, for a record, in the parent after the workers);
  every record the parent merges is made by one phase; every worker
  phase has a recorded peak that fits the card;
* the merge of the records into the six kernels' records, on records of
  the phases' shapes;
* the workers' protocol (``chip_smoke._Workers``) with stand-in worker
  processes: the lines relayed with the worker's name, the records
  handed back, the card given to a worker that asks for it alone only
  once every other worker is done, two phases whose peaks do not fit
  together run in turn; and a worker that exits nonzero, dies or sends
  no record stops the others and the script (exit 1), its name and last
  lines on standard error;
* the script exits 2 with no result where there is no card.
"""

import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ORDER = tuple(cs.PHASES)


def _owner(phase: str) -> str:
    return next(w for w, names in cs.PLAN.items() if phase in names)


def test_every_phase_runs_once_in_the_one_process_order():
    seen = [n for names in cs.PLAN.values() for n in names]
    assert sorted(seen) == sorted(ORDER)
    assert len(seen) == len(set(seen))
    for names in cs.PLAN.values():
        assert list(names) == sorted(names, key=ORDER.index), names


TIMED = ("B1 encode", "B2 decode step", "B3/B4 chunked decode",
         "B5 records", "Fig. 4(b)", "image", "B3/B4 cases",
         "reference check", "Fig. 4(a)", "B6 SPC")
# the phases whose peaks the card could not hold twice
HEAVY = tuple(p for p in ORDER if 2 * cs._budget(p) > cs.CARD_BUDGET_GIB
              and p not in cs.PLAN["parent"] + cs.PLAN["after"])


def test_timed_kernel_phases_are_the_parents():
    assert cs.PLAN["parent"] == TIMED


@pytest.mark.parametrize("phase", HEAVY)
def test_heavy_phases_share_one_worker(phase):
    assert {"mixtral slice", "remat", "phi slice", "vlm"} <= set(HEAVY)
    owners = {_owner(p) for p in HEAVY}
    assert owners == {_owner(phase)} and owners <= set(cs.WORKERS)


def test_workers_and_the_parents_order():
    assert set(cs.PLAN) == {"parent", "after", *cs.WORKERS}
    assert 2 <= len(cs.WORKERS) <= 3


@pytest.mark.parametrize("phase", ORDER)
def test_each_consumer_runs_after_its_producer(phase):
    """An object stays in its producer's process, read after it; a
    record (JSON) may also reach a phase the parent runs after every
    worker."""
    _, reads, _ = cs.PHASES[phase]
    owner = _owner(phase)
    names = cs.PLAN[owner]
    for obj in reads:
        if obj == "dev":
            continue
        producers = [p for p in ORDER if obj in cs.PHASES[p][2]]
        assert len(producers) == 1, obj
        if owner == "after" and obj in cs.RECORDS:
            assert _owner(producers[0]) in cs.WORKERS + ("parent",)
            continue
        assert producers[0] in names, (phase, obj)
        assert names.index(producers[0]) < names.index(phase), (phase, obj)


@pytest.mark.parametrize("phase", [p for p in ORDER
                                   if p not in cs.PLAN["parent"]
                                   + cs.PLAN["after"]])
def test_each_worker_phase_has_a_peak_that_fits(phase):
    assert 0 < cs._budget(phase) <= cs.CARD_BUDGET_GIB


def test_every_record_is_made_by_one_phase():
    for rec in cs.RECORDS:
        assert sum(rec in makes for _, _, makes in cs.PHASES.values()) \
            == 1, rec


def _launches(**counts) -> dict:
    names = ("rans_encode_lanes", "rans_decode_step", "rans_decode_lanes",
             "rans_decode_slab", "rans_encode_records", "spc_quantize")
    return {n: counts.get(n, 0) for n in names}


def test_merge_of_the_records():
    """``_kernel_records`` on records of the phases' shapes: each
    kernel's launches on its main path and in each phase, the large-K
    slices' B6 and B2 times, the largest differences."""
    names = ("rans_encode_lanes", "rans_decode_step", "rans_decode_lanes",
             "rans_decode_slab", "rans_encode_records", "spc_quantize")
    r = {f"b{i + 1}": {"name": n, "max_abs_err": 0}
         for i, n in enumerate(names)}
    r["b4"].update(b3_chunked_ms=0.2, b3_chunked_call_ms=0.3)
    r.update(b1_image={"image_ms": 0.16}, fig4b=(0, 0.31, 0.4),
             cases=(0, 0), fig4a={"b1_fig4a_ms": 0.08, "b3_fig4a_ms": 0.2,
                                  "b3_fig4a_call_ms": 0.3})
    for k in ("m2", "mx", "phi"):
        shape = {"ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.1, "err": 0}
        r[k] = {"batch": shape, "position": shape,
                "b2": dict(shape, bound_by="bytes")}
    slice_launches = _launches(rans_encode_lanes=1, rans_decode_step=600,
                               spc_quantize=601)
    for key in ("image", "two_pass", "engine", "placement",
                "placed_engine", "crosspod_placed", "fig4c",
                "m2", "mx", "zoo", "tp", "phi", "trainer", "launcher",
                "example", "lanes", "chunked", "dryrun"):
        r[f"{key}_launches"] = _launches(rans_decode_slab=1)
    r["slice_launches"] = slice_launches
    r["m2_placed"] = _launches(rans_decode_step=128)
    r["mx_placed"] = r["phi_placed"] = _launches(rans_decode_step=128)
    recs = cs._kernel_records(r)
    assert [x["name"] for x in recs] == list(names)
    b1, b2, b3, b4, b5, b6 = recs
    assert (b1["launches"], b2["launches"], b6["launches"]) == (1, 600, 601)
    assert b4["launches"] == 1 and b3["launches"] == 0
    assert b2["moe_placed_launches"] == 256
    assert b2["recurrent_placed_launches"] == 128
    assert b6["phi_batch_ms"] == 1.0 and b2["mamba2_bound_by"] == "bytes"
    assert b3["b3_slice_ms"] == 0.2 and b1["b1_fig4a_ms"] == 0.08
    for rec in recs:
        assert rec["dryrun_launches"] == int(rec is b4)


def _script(body: str) -> list:
    return [sys.executable, "-c", body]


def test_workers_relay_records_and_give_the_card_alone(tmp_path, capsys):
    done = tmp_path / "b.done"
    scripts = {
        # asks for the card alone: it must get it only after b has exited
        "a": ("import sys, json, pathlib\n"
              "print('a first line')\n"
              "print('@@alone', flush=True)\n"
              "assert sys.stdin.readline().strip() == 'go'\n"
              f"ok = pathlib.Path({str(done)!r}).exists()\n"
              "print('@@records ' + json.dumps({'x': 1, 'alone': ok}))\n"),
        "b": ("import time, json, pathlib, sys\n"
              "time.sleep(1.0)\n"
              "print('b says', file=sys.stderr)\n"
              "print('@@records ' + json.dumps({'y': [2, 3]}), flush=True)\n"
              f"pathlib.Path({str(done)!r}).write_text('x')\n"),
    }
    got = cs._Workers(["a", "b"], time.perf_counter(),
                      command=lambda n: _script(scripts[n])).run()
    assert got == {"a": {"x": 1, "alone": True}, "b": {"y": [2, 3]}}
    out = capsys.readouterr()
    assert "[a] a first line" in out.out and "[b] b says" in out.err
    assert "worker a:" in out.out and "worker b:" in out.out


# a worker of the parent run through chip_smoke's own worker code on the
# CPU: two stand-in phases, the second holding a timing for the card alone
WORKER = """
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {src!r})
import torch
for n in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
    setattr(torch.cuda, n, lambda *a, **k: None)
torch.cuda.max_memory_reserved = lambda *a, **k: 0
import repro_torch.device as device
device.configure_cuda_numerics = lambda: None
device.resolve_device = lambda d: torch.device("cpu")
import chip_smoke as cs
cs.PHASES = {{
    "make": (lambda dev: {{"v": 1}}, ("dev",), ("obj",)),
    "check": (lambda dev: 3.5, ("dev",), ()),    # a value nothing keeps
    "use": (lambda dev, obj: cs._alone(lambda: {{"timed": obj["v"] + 1}}),
            ("dev", "obj"), ("m2",)),
}}
cs.PLAN = {{"w": ("make", "check", "use")}}
cs.RECORDS = ("m2",)
sys.exit(cs._worker(sys.argv[1], "--child" in sys.argv))
"""


def test_a_worker_runs_its_phases_and_holds_its_timings(tmp_path, capsys):
    """``chip_smoke._worker`` under the parent's protocol: each phase
    waits for ``go``, prints its time and peak, and its held timing runs
    when the card is the worker's alone, before its records go back."""
    helper = tmp_path / "worker.py"
    helper.write_text(WORKER.format(root=str(ROOT), src=str(ROOT / "src")))
    got = cs._Workers(["w"], time.perf_counter(), command=lambda n: [
        sys.executable, str(helper), n, "--child"]).run()
    assert got == {"w": {"m2": {"timed": 2}}}
    out = capsys.readouterr()
    for phase in ("make", "check", "use",
                  "large-K kernels, alone on the card"):
        assert f"[w] phase {phase}: " in out.out, out.out
        assert f"[w] phase {phase}: " in out.err
    assert "[w] use: waited" in out.out


def _phases_script(phases) -> str:
    return ("import json, sys, time\n"
            "spans = {}\n"
            f"for name, secs in {phases!r}:\n"
            "    print('@@phase ' + name, flush=True)\n"
            "    assert sys.stdin.readline().strip() == 'go'\n"
            "    t = time.time()\n"
            "    time.sleep(secs)\n"
            "    spans[name] = [t, time.time()]\n"
            "    print('@@done', flush=True)\n"
            "print('@@records ' + json.dumps(spans))\n")


def test_phases_whose_peaks_do_not_fit_take_turns():
    """Two phases whose peaks do not fit together never overlap; a small
    phase passes one that waits."""
    budgets = {"big": 70.0, "mid": 10.0, "tiny": 1.0, "tiny2": 1.0}
    plans = {"a": [("big", 0.8)], "b": [("mid", 0.8), ("tiny2", 0.1)],
             "c": [("tiny", 0.4)]}
    got = cs._Workers(list(plans), time.perf_counter(),
                      command=lambda n: _script(_phases_script(plans[n])),
                      budget=budgets.__getitem__).run()
    spans = {k: v for rec in got.values() for k, v in rec.items()}
    assert set(spans) == set(budgets)
    big, mid = spans["big"], spans["mid"]
    assert big[1] <= mid[0] or mid[1] <= big[0], spans


@pytest.mark.parametrize("fault,why", [
    ("sys.exit(3)", "exited with 3"),
    ("os.kill(os.getpid(), signal.SIGKILL)", "exited with -9"),
    ("pass", "sent no record"),
])
def test_a_failing_worker_stops_the_script(fault, why, capsys):
    bad = ("import os, signal, sys\n"
           "print('bad was here', flush=True)\n"
           f"{fault}\n")
    slow = "import time\ntime.sleep(60)\n"
    t0 = time.perf_counter()
    workers = cs._Workers(["slow", "bad"], t0, command=lambda n: _script(
        slow if n == "slow" else bad))
    with pytest.raises(SystemExit) as e:
        workers.run()
    assert e.value.code == 1
    assert time.perf_counter() - t0 < 30        # the sleeper was stopped
    assert workers.procs["slow"][0].poll() is not None
    err = capsys.readouterr().err
    assert f"worker bad {why}" in err and "bad was here" in err


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert cs.main([]) == 2
    assert cs.main(["--worker", "serve"]) == 2
    assert capsys.readouterr().out == ""
