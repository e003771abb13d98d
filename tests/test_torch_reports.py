"""The port's report tools against the JAX package's, on the same logs: the
schema lint (``obs/validate.py``), the run report (``obs/summarize.py``),
the regression gate (``obs/compare.py``), the timeline
(``obs/timeline.py``), the diagnosis (``obs/doctor.py``), the fleet
roll-up (``obs/fleet.py``), the numerics and convergence reports and the
Chrome-trace readers (``utils/profiling.py``), and ``cli.main``'s command
set.

Each tool is held to the JAX consumer on one ``events.jsonl`` or run
directory: equal dicts, equal formatted text, equal ``main`` stdout and
exit codes. The logs come from three sources:

* the port's own emitters on the CPU at a tiny size (module-scoped): an
  eval run with converge and numerics on, a 3-step ``train()`` run, a
  load test (its ``seq`` and ``serve`` runs) through ``cli loadtest``, and
  a two-rank gloo trainer through ``cli train --data_parallel 2``, whose
  rank directories are a fleet;
* synthetic logs written through the port's ``make_record`` /
  ``append_json_log``, one case a doctor, fleet and validate verdict, a
  compare pass and regression, and a Chrome-trace capture with a
  ``/device:`` process and an "XLA Ops" lane;
* a hypothesis property over random step/request/slo/loader streams.
"""

import contextlib
import gzip
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from raft_stereo_tpu import cli as jcli
from raft_stereo_tpu.obs import compare as jcompare
from raft_stereo_tpu.obs import converge as jconverge
from raft_stereo_tpu.obs import doctor as jdoctor
from raft_stereo_tpu.obs import fleet as jfleet
from raft_stereo_tpu.obs import numerics as jnumerics
from raft_stereo_tpu.obs import summarize as jsummarize
from raft_stereo_tpu.obs import timeline as jtimeline
from raft_stereo_tpu.obs import validate as jvalidate
from raft_stereo_tpu.utils import profiling as jprofiling
from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch.obs import compare, converge, doctor, fleet
from raft_stereo_tpu_torch.obs import numerics, summarize, timeline, validate
from raft_stereo_tpu_torch.obs.events import append_json_log, make_record
from raft_stereo_tpu_torch.utils import profiling

from torch_parity import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--hidden_dims", "32", "32", "32"]
TRAIN_STEPS = 3
DP_STEPS = 3


def _run_main(fn, argv):
    """``fn(argv)``'s exit code, stdout and stderr (SystemExit caught)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = fn(argv)
        except SystemExit as e:
            rc = e.code
    return (0 if rc is None else rc), out.getvalue(), err.getvalue()


def _same_main(port_fn, jax_fn, argv, stderr=True):
    got, want = _run_main(port_fn, argv), _run_main(jax_fn, argv)
    assert got[:2] == want[:2], (got, want)
    if stderr:
        assert got[2] == want[2]
    return got


def _load(path):
    with open(path) as f:
        return json.load(f)


# --- the checks, one a tool ------------------------------------------------

def same_lint(path):
    got = validate.check_path(path)
    assert got == jvalidate.check_path(path)
    assert validate.check_paths([path, path]) == \
        jvalidate.check_paths([path, path])
    _same_main(validate.main, jvalidate.main, [path])
    return got


def same_summary(run_dir):
    got = summarize.summarize_run(run_dir, top=5)
    assert got == jsummarize.summarize_run(run_dir, top=5)
    assert summarize.format_summary(got) == jsummarize.format_summary(got)
    _same_main(summarize.main, jsummarize.main, [run_dir, "--top", "5"])
    return got


def same_diagnosis(run_dir):
    got = doctor.diagnose(run_dir)
    assert got == jdoctor.diagnose(run_dir)
    assert doctor.format_diagnosis(got) == jdoctor.format_diagnosis(got)
    _same_main(doctor.main, jdoctor.main, [run_dir])
    _same_main(doctor.main, jdoctor.main, [run_dir, "--json"])
    return got


def same_timeline(run_dir, work):
    outs = [os.path.join(work, f"timeline_{s}.json") for s in ("t", "j")]
    got = timeline.build_timeline(run_dir, out=outs[0])
    want = jtimeline.build_timeline(run_dir, out=outs[1])
    assert dict(got, path=None) == dict(want, path=None)
    assert _load(outs[0]) == _load(outs[1])
    out = os.path.join(work, "timeline_main.json")
    docs = []
    for fn in (timeline.main, jtimeline.main):
        docs.append((_run_main(fn, [run_dir, "--out", out]), _load(out)))
    assert docs[0] == docs[1]
    return got, _load(outs[0])


def same_self_compare(run_dir):
    got = compare.compare_runs(run_dir, run_dir)
    assert got == jcompare.compare_runs(run_dir, run_dir)
    assert compare.format_comparison(got) == jcompare.format_comparison(got)
    rc = _same_main(compare.main, jcompare.main, [run_dir, run_dir])[0]
    _same_main(compare.main, jcompare.main,
               [run_dir, run_dir, "--json", "-"])
    return got, rc


def same_numerics(run_dir):
    recs = numerics.load_records(run_dir)
    assert recs == jnumerics.load_records(run_dir)
    doc = numerics.build_report(run_dir, recs, top=4)
    assert doc == jnumerics.build_report(run_dir, recs, top=4)
    assert numerics.format_report(doc) == jnumerics.format_report(doc)
    for argv in ([run_dir], [run_dir, "--top", "3", "--json", "-"]):
        _same_main(numerics.main, jnumerics.main, argv)
    return doc


def same_converge(run_dir):
    return _same_main(converge.main, jconverge.main,
                      [run_dir, "--json", "-"])


def same_fleet(fleet_dir, work):
    rollup = fleet.aggregate_fleet(fleet_dir)
    assert rollup == jfleet.aggregate_fleet(fleet_dir)
    verdicts = fleet.fleet_verdicts(rollup)
    assert verdicts == jfleet.fleet_verdicts(rollup)
    assert fleet.format_rollup(rollup, verdicts) == \
        jfleet.format_rollup(rollup, verdicts)
    assert fleet.diagnose_fleet(fleet_dir) == \
        jfleet.diagnose_fleet(fleet_dir)
    outs = [os.path.join(work, f"fleet_{s}.json") for s in ("t", "j")]
    got = fleet.build_fleet_timeline(fleet_dir, out=outs[0])
    want = jfleet.build_fleet_timeline(fleet_dir, out=outs[1])
    assert dict(got, path=None) == dict(want, path=None)
    assert _load(outs[0]) == _load(outs[1])
    out = os.path.join(work, "fleet_main.json")
    rollup_path = os.path.join(fleet_dir, "fleet_rollup.json")
    for flags in ([], ["--json"]):
        docs = []
        for fn in (fleet.main, jfleet.main):
            docs.append((_run_main(fn, [fleet_dir, "--out", out, *flags]),
                         _load(out), _load(rollup_path)))
        assert docs[0] == docs[1]
        os.remove(rollup_path)
    return rollup, verdicts


def same_everything(run_dir, work):
    """Every single-run tool on one run dir; returns what the checks
    saw."""
    os.makedirs(work, exist_ok=True)
    return dict(lint=same_lint(run_dir), summary=same_summary(run_dir),
                doctor=same_diagnosis(run_dir),
                timeline=same_timeline(run_dir, work),
                compare=same_self_compare(run_dir),
                numerics=same_numerics(run_dir),
                converge=same_converge(run_dir))


# --- (a) logs the port's emitters write --------------------------------------

def _write_kitti(root, n, h, w, seed):
    from raft_stereo_tpu_torch.data import png
    rng = np.random.default_rng(seed)
    kroot = os.path.join(root, "KITTI", "training")
    for d in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(kroot, d))
    for i in range(n):
        for d in ("image_2", "image_3"):
            png.write_png(os.path.join(kroot, d, f"00000{i}_10.png"),
                          rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        disp = rng.uniform(0.5, 20, (h, w))
        disp[rng.uniform(size=(h, w)) < 0.2] = 0.0
        png.write_png(os.path.join(kroot, "disp_occ_0", f"00000{i}_10.png"),
                      (disp * 256.0).astype(np.uint16))


def _child_env(work):
    shim = os.path.join(work, "shim")
    os.makedirs(shim, exist_ok=True)
    with open(os.path.join(shim, "tensorflow.py"), "w") as f:
        f.write("raise ImportError('no TensorFlow for the children')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, shim]),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def _start(cmd, env, log):
    with open(log, "w") as f:
        return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=f,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)


def _finish(proc, log, timeout=240):
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    with open(log) as f:
        text = f.read()
    assert rc == 0, text[-3000:]
    return text


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's emitters at a tiny size: the two-rank trainer and the two
    eval entry points as subprocesses (started first, run meanwhile),
    then an eval, a train() and a load test in this process."""
    from chip_smoke import write_sceneflow_tree
    from raft_stereo_tpu_torch import evaluate
    from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig
    from raft_stereo_tpu_torch.training import logger as tlogger
    from raft_stereo_tpu_torch.training.trainer import train

    work = str(tmp_path_factory.mktemp("reports"))
    things = os.path.join(work, "things")
    write_sceneflow_tree(things, 4, 64, 96, 5, max_disp=8)
    kitti = os.path.join(work, "kitti")
    _write_kitti(kitti, 4, 32, 64, 7)
    env = _child_env(work)
    runs = os.path.join(work, "runs")
    dp = [sys.executable, "-m", "raft_stereo_tpu_torch.cli", "train",
          "--device", "cpu", "--data_parallel", "2", "--name", "dp",
          "--data_root", things, "--run_dir", runs,
          "--ckpt_dir", os.path.join(work, "ckpts"), "--batch_size", "2",
          "--num_steps", str(DP_STEPS), "--image_size", "48", "64",
          "--train_iters", "1", "--valid_iters", "1", *TINY,
          "--validation_frequency", "1000000",
          "--checkpoint_frequency", "1000000", "--num_workers", "1",
          "--stall_deadline_s", "0", "--heartbeat_every", "0.5"]
    ev = ["--device", "cpu", "--dataset", "kitti", "--data_root", kitti,
          "--valid_iters", "2", *TINY, "--stream", "off"]
    procs = {"dp": (_start(dp, env, os.path.join(work, "dp.log")),
                    os.path.join(work, "dp.log"))}
    for name, head in (("cli_eval", ["raft_stereo_tpu_torch.cli", "eval"]),
                       ("evaluate", ["raft_stereo_tpu_torch.evaluate"])):
        log = os.path.join(work, f"{name}.log")
        cmd = [sys.executable, "-m", *head, *ev,
               "--run_dir", os.path.join(runs, name)]
        procs[name] = (_start(cmd, env, log), log)
    try:
        out = {}
        # an eval with converge and numerics on (the defaults), 4 frames
        out["eval"] = os.path.join(runs, "eval")
        rc, stdout, _ = _run_main(evaluate.main, [
            *ev[:6], "--valid_iters", "4", *TINY, "--stream", "off",
            "--run_dir", out["eval"]])
        assert rc == 0 and "kitti-epe" in stdout
        # train() for TRAIN_STEPS steps with a grad record a step, a
        # checkpoint and heartbeats
        mp = pytest.MonkeyPatch()
        mp.setattr(tlogger, "_make_writer", lambda log_dir: None)
        try:
            train(RAFTStereoConfig(hidden_dims=(32, 32, 32)), TrainConfig(
                name="tiny", data_root=things, batch_size=2,
                num_steps=TRAIN_STEPS, image_size=(48, 64), train_iters=1,
                valid_iters=1, checkpoint_frequency=2,
                validation_frequency=10 ** 6, num_workers=1,
                stall_deadline_s=0, numerics_every=1,
                heartbeat_every_s=0.2, ckpt_dir=os.path.join(work, "tck"),
                run_dir=runs), device="cpu")
        finally:
            mp.undo()
        out["train"] = os.path.join(runs, "tiny")
        # the load test through the root command line: seq and serve
        lt = os.path.join(runs, "loadtest")
        rc, stdout, _ = _run_main(cli.main, [
            "loadtest", "--device", "cpu", *TINY, "--iters", "2",
            "--shapes", "32x64", "48x64", "--clients", "2",
            "--requests_per_client", "2", "--poison_at", "2",
            "--max_batch", "2", "--run_dir", lt, "--no_progress",
            "--heartbeat_every", "0.5"])
        assert rc == 0 and "LOADTEST summary" in stdout
        out["seq"], out["serve"] = (os.path.join(lt, p)
                                    for p in ("seq", "serve"))
        for name, (proc, log) in procs.items():
            out[f"{name}_stdout"] = _finish(proc, log)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    out["fleet"] = os.path.join(runs, "dp")
    out["work"] = work
    return out


@pytest.mark.parametrize("run", ["eval", "train", "seq", "serve"])
def test_port_run_reports_match_jax(port_runs, run):
    run_dir = port_runs[run]
    seen = same_everything(run_dir, os.path.join(port_runs["work"],
                                                 f"cmp_{run}"))
    assert seen["lint"] == []
    summary = seen["summary"]["events"]
    assert seen["summary"]["trace"] is None
    assert seen["summary"]["schema_errors"] == []
    kinds = [v["phase"] for v in seen["doctor"]["verdicts"]]
    tl_summary, tl = seen["timeline"]
    roots = [e for e in tl["traceEvents"] if e.get("ph") == "X"
             and e["name"] in ("step", "request")]
    assert seen["compare"][1] == 0 and seen["compare"][0]["ok"]
    if run == "eval":
        assert summary["steps"] == 4
        assert summary["converge"]["count"] == 4
        assert seen["numerics"]["tap_events"] == 4
        assert seen["converge"][0] == 0
        assert kinds == ["numerics"]  # eval frames carry in_flight
    elif run == "train":
        assert summary["steps"] == TRAIN_STEPS
        assert seen["numerics"]["grad_events"] == TRAIN_STEPS
        assert kinds == ["train", "numerics"]
        assert len(roots) == TRAIN_STEPS
        assert tl_summary["coverage"]["roots"] == TRAIN_STEPS
    elif run == "serve":
        assert kinds[0] == "serve"
        requests = sum(1 for r in _records(run_dir)
                       if r["event"] == "request")
        assert requests == 4 and len(roots) == requests
    else:
        assert seen["numerics"]["grad_events"] == 0


def _records(run_dir):
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_port_runs_compare_across_runs(port_runs):
    """compare between two different port runs, both ways."""
    a, b = port_runs["seq"], port_runs["serve"]
    for base, cand in ((a, b), (b, a), (port_runs["eval"],
                                        port_runs["train"])):
        got = compare.compare_runs(base, cand)
        assert got == jcompare.compare_runs(base, cand)
        _same_main(compare.main, jcompare.main, [base, cand])


def test_data_parallel_ranks_as_a_fleet(port_runs):
    """The two gloo ranks started through ``cli train --data_parallel 2``:
    the rank directories are a fleet; the roll-up, its verdicts, its
    timeline and doctor's routing equal JAX's, FLEET_OK over both ranks."""
    fleet_dir = port_runs["fleet"]
    assert sorted(os.listdir(fleet_dir)) == ["rank0", "rank1"]
    rollup, verdicts = same_fleet(fleet_dir, port_runs["work"])
    assert rollup["n_hosts"] == 2
    assert [h["steps"]["n"] for h in rollup["hosts"]] == [DP_STEPS] * 2
    assert [v["verdict"] for v in verdicts] == ["FLEET_OK"]
    assert same_diagnosis(fleet_dir)["verdicts"] == verdicts
    for r in ("rank0", "rank1"):
        assert same_lint(os.path.join(fleet_dir, r)) == []
        summary = same_summary(os.path.join(fleet_dir, r))
        assert summary["events"]["steps"] == DP_STEPS


def test_cli_eval_is_the_eval_entry_point(port_runs):
    """``python -m raft_stereo_tpu_torch.cli eval`` and ``python -m
    raft_stereo_tpu_torch.evaluate`` on one tree: the same results."""
    last = [port_runs[f"{n}_stdout"].strip().splitlines()[-1]
            for n in ("cli_eval", "evaluate")]
    assert last[0] == last[1] and "kitti-epe" in last[0]


# --- (b) synthetic logs --------------------------------------------------------

def _write(run_dir, specs):
    """Write ``(event, t, payload)`` specs as one events.jsonl through the
    port's make_record / append_json_log."""
    path = os.path.join(run_dir, "events.jsonl")
    for event, t, payload in specs:
        append_json_log(path, make_record(event, t=t, **payload),
                        stream=None)
    return run_dir


def _steps(n, wait, disp, fetch, t0=0.0, every=None, **extra):
    every = every or (wait + disp + fetch)
    return [("step", t0 + every * (i + 1),
             dict(step=i + 1, data_wait_s=wait, dispatch_s=disp,
                  fetch_s=fetch, batch_size=2, **extra))
            for i in range(n)]


def _requests(n, lat, wait):
    return [("request", 0.1 * (i + 1),
             dict(id=f"r{i}", status="ok", latency_s=lat, queue_wait_s=wait,
                  bucket="64x128b1", batch_size=1)) for i in range(n)]


def _curves(n, budget, settle):
    out = []
    for i in range(n):
        res = [1.0 / (k + 1) if k < settle else 0.001 for k in range(budget)]
        out.append(("converge", 1.0 + i,
                    dict(source="eval:kitti", iters=budget,
                         idx=list(range(budget)), residual=res,
                         bucket="32x64", frame=i, half_life=1,
                         final_residual=res[-1])))
    return out


def _taps(iters=3, sat=0, nonfinite=None):
    series = {f: [0.5] * iters for f in ("min", "max", "absmean")}
    series.update(nonfinite=[0] * iters, sat=[sat] * iters,
                  underflow=[0] * iters)
    taps = {"0:net0": series, "1:corr": dict(series)}
    fnf = None
    if nonfinite is not None:
        taps["1:corr"] = dict(series, nonfinite=[0, 4, 4][:iters])
        fnf = {"tap": "1:corr", "iter": 1, "count": 4}
    return [("numerics", 2.0, dict(source="eval:kitti", kind="taps",
                                   iters=iters, taps=taps, frame=0,
                                   first_nonfinite=fnf,
                                   sat_total=3 * sat, underflow_total=0))]


def _grads(norms, step=1):
    return [("numerics", 1.0 + step,
             dict(source="train", kind="grad", step=step,
                  leaves=[f"leaf{i}" for i in range(len(norms))],
                  grad_norm=norms))]


START = [("run_start", 0.0, dict(run="synthetic"))]
DOCTOR_CASES = {
    "STALLED": START + _steps(3, 0.01, 0.2, 0.01) + [
        ("stall", 5.0, dict(seconds_since_step=4.0, deadline_s=3.0))],
    "COMPILE_STORM": START + _steps(3, 0.01, 0.2, 0.01) + [
        ("compile", 0.1 * i, dict(duration_s=0.3, source="train_step"))
        for i in range(3)],
    "DATA_STARVED": START + _steps(5, 0.3, 0.1, 0.05) + [
        ("loader", 1.0, dict(queue_depth=0)),
        ("loader", 2.0, dict(queue_depth=1))],
    "COMPUTE_BOUND": START + _steps(5, 0.01, 0.3, 0.1),
    # medians of waits and device legs both under their bars
    "BALANCED": START + [("step", 0.5 * (i + 1), dict(
        step=i + 1, data_wait_s=w, dispatch_s=d, fetch_s=0.0))
        for i, (w, d) in enumerate([(0.0, 1.0), (0.0, 1.0), (0.0, 1.0),
                                    (0.35, 0.35), (1.0, 0.0),
                                    (1.0, 0.0)])],
    "UNKNOWN": START + _steps(3, 0.0, 0.0, 0.0),
    "UNKNOWN_EMPTY": START + [("run_end", 1.0, dict(steps=0))],
    "QUEUE_SATURATED": START + _requests(6, 0.2, 0.15) + [
        ("queue", 0.5, dict(depth=3, rejected=2)),
        ("slo", 0.6, dict(p50_ms=200.0, p99_ms=250.0, pairs_per_sec=5.0,
                          in_flight=1, rejected=2))],
    "COMPUTE_BOUND_SERVE": START + _requests(6, 0.2, 0.01),
    "UNKNOWN_SERVE": START + _requests(3, 0.0, 0.0),
    "STALLED_SERVE": START + _requests(3, 0.2, 0.01) + [
        ("stall", 5.0, dict(seconds_since_step=9.0, deadline_s=3.0))],
    "OVER_ITERATED": START + _curves(5, 16, 3),
    "NONFINITE_ORIGIN": START + _taps(nonfinite=True),
    "NONFINITE_ORIGIN_GRAD": START + _grads([1.0, None, 2.0]),
    "BF16_SATURATION": START + _taps(sat=2),
    "GRAD_EXPLOSION": START + _grads([1.0, 5e3, 2.0]),
    "NUMERICS_CLEAN": START + _grads([1.0, 2.0]) + _taps(),
}


@pytest.mark.parametrize("case", sorted(DOCTOR_CASES))
def test_doctor_verdicts_match_jax(case, tmp_path):
    run = _write(str(tmp_path / "run"), DOCTOR_CASES[case])
    verdicts = [v["verdict"] for v in same_diagnosis(run)["verdicts"]]
    assert case.split("_SERVE")[0].split("_EMPTY")[0].split("_GRAD")[0] \
        in verdicts, verdicts
    same_summary(run)
    same_numerics(run)
    same_converge(run)
    same_timeline(run, str(tmp_path))


def _host(fleet_dir, name, steps, step_s, beats, every=0.5, clean=True,
          t0=0.0, wall=1.7e9):
    specs = [("run_start", t0, dict(run=name, host_id=name)),
             ("clock_anchor", t0, dict(host_id=name, monotonic=t0,
                                       wall=wall + t0))]
    specs += [(e, t, dict(p, host_id=name)) for e, t, p in
              _steps(steps, 0.01, step_s, 0.01, t0=t0, every=0.25)]
    specs += [("heartbeat", t0 + every * (i + 1),
               dict(host_id=name, role="trainer", seq=i, every_s=every))
              for i in range(beats)]
    specs += [("span", t0 + 0.1, dict(name="step", span_id=f"{name}s1",
                                      trace_id="shared", start_s=t0,
                                      dur_s=0.1, host_id=name,
                                      parent_id="h0s1" if name != "h0"
                                      else None, remote_parent=name != "h0"))]
    if clean:
        specs.append(("run_end", t0 + 0.25 * steps + 0.1,
                      dict(steps=steps, ok=True, host_id=name)))
    return _write(os.path.join(fleet_dir, name), specs)


FLEET_CASES = {
    "FLEET_OK": [("h0", 6, 0.2, 4, {}), ("h1", 6, 0.2, 4, {})],
    "STRAGGLER": [("h0", 6, 0.2, 4, {}), ("h1", 6, 0.2, 4, {}),
                  ("h2", 6, 0.9, 4, {})],
    "DEAD_HOST": [("h0", 12, 0.2, 10, {}),
                  ("h1", 3, 0.2, 1, {"clean": False})],
    "DESYNC": [("h0", 10, 0.2, 4, {}), ("h1", 4, 0.2, 4, {})],
}


@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_fleet_verdicts_match_jax(case, tmp_path):
    fleet_dir = str(tmp_path / "fleet")
    for name, steps, step_s, beats, kw in FLEET_CASES[case]:
        _host(fleet_dir, name, steps, step_s, beats, **kw)
    rollup, verdicts = same_fleet(fleet_dir, str(tmp_path))
    assert case in [v["verdict"] for v in verdicts], verdicts
    assert same_diagnosis(fleet_dir)["verdicts"] == verdicts
    assert rollup["cross_host_traces"]  # the shared trace joins hosts


def test_fleet_lenient_and_unanchored_match_jax(tmp_path):
    """A killed host's cut last line, a log with no clock_anchor (the ts
    offset), a fleet dir with no runs, and main's error exit."""
    fleet_dir = str(tmp_path / "fleet")
    _host(fleet_dir, "h0", 4, 0.2, 3)
    unanchored = os.path.join(fleet_dir, "h1")
    _write(unanchored, [("run_start", 0.0, dict(run="u"))]
           + _steps(4, 0.01, 0.2, 0.01))
    with open(os.path.join(unanchored, "events.jsonl"), "a") as f:
        f.write('{"schema": 10, "event": "st')
    assert fleet.read_events_lenient(
        os.path.join(unanchored, "events.jsonl")) == \
        jfleet.read_events_lenient(os.path.join(unanchored, "events.jsonl"))
    assert fleet.load_host(unanchored) == jfleet.load_host(unanchored)
    same_fleet(fleet_dir, str(tmp_path))
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for argv in ([empty], [str(tmp_path / "absent")]):
        assert _same_main(fleet.main, jfleet.main, argv)[0] == 1
    assert fleet.discover_runs(fleet_dir) == jfleet.discover_runs(fleet_dir)


def _span(sid, parent=None, trace="tr", **kw):
    return ("span", 1.0, dict(name="step" if parent is None else "dispatch",
                              span_id=sid, trace_id=trace, start_s=0.0,
                              dur_s=0.1, parent_id=parent, **kw))


def _conv(**kw):
    rec = dict(source="eval:kitti", iters=4, idx=[0, 1, 3],
               residual=[1.0, 0.5, 0.1])
    rec.update(kw)
    return [("converge", 1.0, rec)]


def _num_taps(**kw):
    rec = _taps(iters=3)[0][2]
    rec.update(kw)
    return [("numerics", 1.0, rec)]


_TAPS3 = _taps(iters=3)[0][2]["taps"]
VALIDATE_CASES = {
    "span_duplicate": [_span("a"), _span("a")],
    "span_orphan": [_span("a"), _span("b", parent="zz")],
    "span_remote_parent_ok": [_span("b", parent="zz", remote_parent=True)],
    "span_no_trace": [_span("a", trace="")],
    "converge_malformed": _conv(idx="x"),
    "converge_lengths": _conv(residual=[1.0, 0.5]),
    "converge_budget": _conv(iters=2, idx=[0, 1, 2], residual=[1, 1, 1]),
    "converge_order": _conv(idx=[0, 2, 1]),
    "converge_cover": _conv(idx=[0, 1, 2]),
    "converge_epe": _conv(epe=[1.0]),
    "converge_nonfinite": _conv(residual=[1.0, float("nan"), 0.1]),
    "numerics_grad_malformed": [("numerics", 1.0, dict(
        source="train", kind="grad", leaves="x", grad_norm=[]))],
    "numerics_grad_lengths": [("numerics", 1.0, dict(
        source="train", kind="grad", step=1, leaves=["a"],
        grad_norm=[1.0, 2.0]))],
    "numerics_grad_values": [("numerics", 1.0, dict(
        source="train", kind="grad", step=1, leaves=["a"],
        grad_norm=["big"]))],
    "numerics_taps_malformed": _num_taps(iters="3"),
    "numerics_series_malformed": _num_taps(taps={"0:a": 1}),
    "numerics_series_length": _num_taps(taps={"0:a": dict(
        _TAPS3["0:net0"], min=[0.1])}),
    "numerics_negative": _num_taps(taps={"0:a": dict(
        _TAPS3["0:net0"], sat=[0, -1, 0])}),
    "numerics_fnf_malformed": _num_taps(first_nonfinite=3),
    "numerics_fnf_tap": _num_taps(first_nonfinite={"tap": "9:x", "iter": 0}),
    "numerics_fnf_iter": _num_taps(first_nonfinite={"tap": "0:net0",
                                                    "iter": 7}),
    "numerics_fnf_zero": _num_taps(first_nonfinite={"tap": "0:net0",
                                                    "iter": 1}),
    "numerics_kind": [("numerics", 1.0, dict(source="x", kind="what"))],
    "fleet_empty_host": [("step", 1.0, dict(step=1, data_wait_s=0,
                                            dispatch_s=0, fetch_s=0,
                                            host_id=""))],
    "fleet_two_hosts": [("run_start", 0.0, dict(run="r", host_id="a")),
                        ("run_end", 1.0, dict(steps=0, host_id="b"))],
    "fleet_anchor_twice": [
        ("clock_anchor", 0.0, dict(host_id="a", monotonic=0, wall=1)),
        ("clock_anchor", 0.1, dict(host_id="a", monotonic=0, wall=1))],
    "fleet_seq_type": [
        ("clock_anchor", 0.0, dict(host_id="a", monotonic=0, wall=1)),
        ("heartbeat", 1.0, dict(host_id="a", role="r", seq=-1))],
    "fleet_seq_order": [
        ("clock_anchor", 0.0, dict(host_id="a", monotonic=0, wall=1)),
        ("heartbeat", 1.0, dict(host_id="a", role="r", seq=2)),
        ("heartbeat", 2.0, dict(host_id="a", role="r", seq=2))],
    "fleet_rewind": [
        ("clock_anchor", 0.0, dict(host_id="a", monotonic=0, wall=1)),
        ("heartbeat", 2.0, dict(host_id="a", role="r", seq=1)),
        ("heartbeat", 1.0, dict(host_id="a", role="r", seq=2))],
    "fleet_no_anchor": [("heartbeat", 1.0, dict(host_id="a", role="r",
                                                seq=0))],
    "fleet_new_segment_ok": [
        ("run_start", 0.0, dict(run="r", host_id="a")),
        ("run_start", 0.0, dict(run="r", host_id="b"))],
    "schema_violation": [("step", 1.0, dict(step=1))],
    "clean": START + _steps(2, 0.1, 0.1, 0.1),
}


@pytest.mark.parametrize("case", sorted(VALIDATE_CASES))
def test_validate_findings_match_jax(case, tmp_path):
    run = _write(str(tmp_path / "run"), VALIDATE_CASES[case])
    records = _records(run)
    for name in ("check_span_integrity", "check_converge_integrity",
                 "check_numerics_integrity", "check_fleet_integrity"):
        assert getattr(validate, name)(records) == \
            getattr(jvalidate, name)(records)
    errors = same_lint(run)
    assert bool(errors) == (not case.endswith("ok") and case != "clean"), \
        errors


def test_validate_paths_and_policies_match_jax(tmp_path):
    """check_path's own findings (a missing path, an empty log, an
    unparseable line) and the policy route (a clean and a doctored
    policy, unreadable JSON), the multi-path main and its usage exit."""
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "events.jsonl").write_text("")
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "events.jsonl").write_text('{"schema": 10,\n')
    row = {"tau": 0.1, "budget": 8}
    good = {"kind": "iter_policy", "version": 1, "source_run": "r",
            "buckets": {"32x64": {"tau": 0.1, "budget": 6, "min_iters": 1,
                                  "provenance": {"source": "s",
                                                 "row": row}}}}
    doctored = dict(good, version=2, buckets={"3x": {
        "tau": 0, "budget": 9, "min_iters": 10, "provenance": {
            "source": "s", "row": row}}})
    paths = []
    for name, doc in (("good.json", good), ("doctored.json", doctored)):
        (tmp_path / name).write_text(json.dumps(doc))
        paths.append(str(tmp_path / name))
    (tmp_path / "broken.json").write_text("{")
    paths += [str(tmp_path / "broken.json"), str(tmp_path / "absent"),
              str(empty), str(bad)]
    for p in paths:
        errors = same_lint(p)
        assert bool(errors) == (not p.endswith("good.json")), (p, errors)
        assert validate.check_policy_path(p) == jvalidate.check_policy_path(p)
        assert validate._looks_like_policy(p) == jvalidate._looks_like_policy(p)
    assert _same_main(validate.main, jvalidate.main, paths)[0] == 1
    assert _run_main(validate.main, [])[0] == _run_main(jvalidate.main,
                                                        [])[0] == 2


def test_compare_pass_regression_and_errors_match_jax(tmp_path):
    def run(name, pairs, step_s, peak, compile_s):
        return _write(str(tmp_path / name), START + _steps(
            4, 0.01, step_s, 0.01) + [
            ("throughput", 2.0, dict(pairs_per_sec=pairs, steps=4)),
            ("memory", 2.0, dict(stats={"peak_bytes_in_use": peak})),
            ("xla_memory", 2.0, dict(source="s", peak_bytes=peak // 2)),
            ("compile", 0.5, dict(duration_s=compile_s, source="s"))])
    base = run("base", 10.0, 0.2, 1000, 1.0)
    same = run("same", 10.1, 0.21, 1010, 1.2)
    worse = run("worse", 9.0, 0.4, 2000, 3.0)
    zero = run("zero", 10.0, 0.2, 0, 0.0)
    only_steps = _write(str(tmp_path / "steps"), START + _steps(4, 0.05, 0.2,
                                                                0.01))
    for a, cand, want in ((base, same, 0), (base, worse, 1),
                          (base, zero, 0), (zero, base, 1),
                          (base, only_steps, 1),
                          (base, str(tmp_path / "absent"), 2),
                          (str(tmp_path / "absent"), base, 2)):
        got = compare.compare_runs(a, cand)
        assert got == jcompare.compare_runs(a, cand)
        assert compare.format_comparison(got) == \
            jcompare.format_comparison(got)
        rc = _same_main(compare.main, jcompare.main, [a, cand])[0]
        assert rc == want, (cand, got)
    assert compare.extract_metrics(base) == jcompare.extract_metrics(base)
    argv = [base, worse, "--max-throughput-drop", "0.5",
            "--max-phase-increase", "2", "--max-memory-growth", "2",
            "--max-compile-growth", "5", "--json", str(tmp_path / "r.json")]
    assert _same_main(compare.main, jcompare.main, argv)[0] == 0


def _chrome_trace(run_dir, corrupt=False):
    """A Chrome-trace capture: a ``/device:`` process with an "XLA Ops"
    lane (ops in three categories and a ``while`` wrapper), a host
    process, and spans in the run's log with a ``dispatch`` leg."""
    prof = os.path.join(run_dir, "plugins", "profile", "2026_10_18")
    os.makedirs(prof)
    path = os.path.join(prof, "host.trace.json.gz")
    if corrupt:
        with open(path, "wb") as f:
            f.write(b"not a gzip stream")
        return path
    events = [
        {"ph": "M", "pid": 7, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "pid": 7, "tid": 3, "name": "thread_name",
         "args": {"name": "XLA Ops"}},
        {"ph": "M", "pid": 7, "tid": 4, "name": "thread_name",
         "args": {"name": "Steps"}},
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/host:CPU"}},
        {"ph": "X", "pid": 1, "tid": 1, "name": "host_op", "ts": 5,
         "dur": 9}]
    for i in range(12):
        events.append({"ph": "X", "pid": 7, "tid": 3,
                       "name": f"fusion.{i % 5}", "ts": 1000 + 10 * i,
                       "dur": 3 + i, "args": {
                           "hlo_category": ("convolution fusion",
                                            "loop fusion", "while")[i % 3],
                           "long_name": f"%fusion.{i % 5} = f32[8,64] "
                                        + "x" * 200}})
    events.append({"ph": "X", "pid": 7, "tid": 4, "name": "step 1",
                   "ts": 1000, "dur": 200})
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return path


def test_trace_readers_and_device_lanes_match_jax(tmp_path):
    run = _write(str(tmp_path / "run"), START + _steps(2, 0.01, 0.2, 0.01)
                 + [_span("root"), _span("d1", parent="root"),
                    ("compile", 0.3, dict(duration_s=0.2, source="s"))])
    path = _chrome_trace(run)
    assert profiling._latest_trace_json(run) == \
        jprofiling._latest_trace_json(run) == path
    got = profiling.load_trace_events(run)
    assert got == jprofiling.load_trace_events(run)
    assert profiling.device_lanes(got[1]) == jprofiling.device_lanes(got[1])
    for top in (2, 25):
        report = profiling.summarize_trace(run, top=top)
        assert report == jprofiling.summarize_trace(run, top=top)
        assert profiling.format_report(report) == \
            jprofiling.format_report(report)
    assert report["total_device_ms"] > 0 and report["note"] is None
    # a host-only capture: the note
    host_only = str(tmp_path / "host")
    os.makedirs(os.path.join(host_only, "plugins", "profile", "x"))
    with gzip.open(os.path.join(host_only, "plugins", "profile", "x",
                                "h.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": got[1][3:5]}, f)
    assert profiling.summarize_trace(host_only) == \
        jprofiling.summarize_trace(host_only)
    for reader in (profiling.load_trace_events,
                   jprofiling.load_trace_events):
        with pytest.raises(FileNotFoundError):
            reader(str(tmp_path))
    summary = same_summary(run)
    assert summary["trace"]["total_device_ms"] == report["total_device_ms"]
    tl_summary, tl = same_timeline(run, str(tmp_path))
    assert tl_summary["device_events"] > 0
    assert any(e["pid"] == timeline._DEVICE_PID_BASE + 7
               for e in tl["traceEvents"])
    assert (timeline.HOST_PID, timeline.EVENTS_PID,
            timeline._DEVICE_PID_BASE, timeline._INSTANT_EVENTS) == \
        (jtimeline.HOST_PID, jtimeline.EVENTS_PID,
         jtimeline._DEVICE_PID_BASE, jtimeline._INSTANT_EVENTS)
    # a corrupt capture: the report's error line
    bad = _write(str(tmp_path / "bad"), START + _steps(2, 0.01, 0.2, 0.01))
    _chrome_trace(bad, corrupt=True)
    assert "error" in same_summary(bad)["trace"]
    same_timeline(bad, str(tmp_path))


def test_report_errors_and_missing_logs_match_jax(tmp_path):
    """Mains on a directory with no log: their error lines and exits."""
    empty = str(tmp_path / "nothing")
    os.makedirs(empty)
    for port_fn, jax_fn in ((timeline.main, jtimeline.main),
                            (doctor.main, jdoctor.main),
                            (numerics.main, jnumerics.main),
                            (summarize.main, jsummarize.main)):
        _same_main(port_fn, jax_fn, [empty])
    assert summarize.summarize_run(empty) == jsummarize.summarize_run(empty)
    assert summarize.format_summary(summarize.summarize_run(empty)) == \
        jsummarize.format_summary(jsummarize.summarize_run(empty))
    assert _same_main(converge.main, jconverge.main, [empty])[0] == 1
    numerics_out = str(tmp_path / "n" / "report.json")
    run = _write(str(tmp_path / "run"), START + _grads([1.0, None]))
    _same_main(numerics.main, jnumerics.main,
               [run, "--json", numerics_out])
    assert numerics.first_nonfinite_report(_records(run)) == \
        jnumerics.first_nonfinite_report(_records(run))


def test_thresholds_and_constants_are_jax(tmp_path):
    for port_mod, jax_mod, names in (
            (doctor, jdoctor, ("COMPILE_STORM_MIN_EVENTS",
                               "COMPILE_STORM_WALL_FRAC",
                               "DATA_STARVED_FRAC", "COMPUTE_BOUND_FRAC",
                               "QUEUE_SATURATED_FRAC",
                               "OVER_ITERATED_MARGIN",
                               "OVER_ITERATED_MIN_CURVES")),
            (fleet, jfleet, ("STRAGGLER_FACTOR", "STRAGGLER_MIN_STEPS",
                             "DEAD_HOST_GAP_BEATS", "DESYNC_STEP_MARGIN")),
            (compare, jcompare, ("DEFAULT_THRESHOLDS",)),
            (timeline, jtimeline, ("ROOT_NAMES",)),
            (summarize, jsummarize, ("_PHASES",))):
        for name in names:
            assert getattr(port_mod, name) == getattr(jax_mod, name), name


# --- (c) a property over random record streams -------------------------------

_PHASE = st.floats(0.0, 0.5, allow_nan=False)


@st.composite
def streams(draw):
    """A random run: steps (eval-style with in_flight or train-style),
    requests, slo and loader gauges, compiles and a stall, in time
    order."""
    specs = [("run_start", 0.0, dict(run="h"))]
    t = 0.0
    eval_style = draw(st.booleans())
    for i in range(draw(st.integers(0, 8))):
        w, d, f = draw(_PHASE), draw(_PHASE), draw(_PHASE)
        t += w + d + f + draw(st.floats(0.0, 0.1))
        extra = {"in_flight": 1} if eval_style else {}
        if draw(st.booleans()):
            extra["batch_size"] = draw(st.integers(1, 4))
        specs.append(("step", t, dict(step=i + 1, data_wait_s=w,
                                      dispatch_s=d, fetch_s=f, **extra)))
    for i in range(draw(st.integers(0, 6))):
        t += draw(st.floats(0.0, 0.1))
        specs.append(("request", t, dict(
            id=f"q{i}", status=draw(st.sampled_from(["ok", "error"])),
            latency_s=draw(_PHASE), queue_wait_s=draw(_PHASE))))
    for _ in range(draw(st.integers(0, 3))):
        specs.append(("slo", t, dict(
            p50_ms=draw(_PHASE) * 1e3, p99_ms=draw(_PHASE) * 1e3,
            pairs_per_sec=draw(_PHASE), in_flight=draw(st.integers(0, 3)),
            rejected=draw(st.integers(0, 3)))))
    for _ in range(draw(st.integers(0, 3))):
        specs.append(("loader", t, dict(queue_depth=draw(
            st.integers(0, 8)))))
    for _ in range(draw(st.integers(0, 4))):
        specs.append(("compile", t, dict(duration_s=draw(_PHASE),
                                         source="s")))
    if draw(st.booleans()):
        specs.append(("throughput", t, dict(pairs_per_sec=draw(_PHASE),
                                            steps=1)))
    if draw(st.integers(0, 9)) == 0:
        specs.append(("stall", t, dict(seconds_since_step=draw(_PHASE),
                                       deadline_s=0.1)))
    return specs


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(a=streams(), b=streams())
def test_random_streams_report_alike(a, b):
    work = tempfile.mkdtemp(prefix="reports_hyp_")
    try:
        ra = _write(os.path.join(work, "a"), a)
        rb = _write(os.path.join(work, "b"), b)
        for run in (ra, rb):
            got = summarize.summarize_run(run)
            assert got == jsummarize.summarize_run(run)
            assert summarize.format_summary(got) == \
                jsummarize.format_summary(got)
            got = doctor.diagnose(run)
            assert got == jdoctor.diagnose(run)
            assert doctor.format_diagnosis(got) == \
                jdoctor.format_diagnosis(got)
        got = compare.compare_runs(ra, rb)
        want = jcompare.compare_runs(ra, rb)
        assert json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True)
        assert compare.format_comparison(got) == \
            jcompare.format_comparison(want)
    finally:
        shutil.rmtree(work)


# --- the root command line ----------------------------------------------------

def test_cli_commands_are_jax_and_help_exits_zero():
    """The command tuple is JAX's; every command's --help exits 0; each
    report command's help is the JAX parser's; the entry points' help is
    the port's own parser's (so the dispatch reached the port)."""
    import raft_stereo_tpu.cli as jcli_mod
    import inspect
    src = inspect.getsource(jcli_mod.main)
    assert all(f'"{c}"' in src for c in cli.COMMANDS)
    assert len(cli.COMMANDS) == 12
    reports = {"timeline": cli.build_timeline_parser,
               "doctor": cli.build_doctor_parser,
               "fleet": cli.build_fleet_parser,
               "numerics": cli.build_numerics_parser}
    entry = {"train": cli.build_train_parser, "eval": cli.build_eval_parser,
             "serve": cli.build_serve_parser,
             "loadtest": cli.build_loadtest_parser}
    for cmd in cli.COMMANDS:
        rc, out, _ = _run_main(cli.main, [cmd, "--help"])
        assert rc == 0 and out, cmd
        if cmd in reports:
            want = getattr(jcli, reports[cmd].__name__)().format_help()
            assert out == want == reports[cmd]().format_help()
        if cmd in entry:
            assert out == entry[cmd]().format_help()
    rc, out, err = _run_main(cli.main, ["lint"])
    assert rc == 2 and "A15" in err and not out
    assert "A15" in _run_main(cli.main, ["lint", "--help"])[1]
    for argv in ([], ["nonsense"]):
        rc, _, err = _run_main(cli.main, argv)
        assert rc == 2 and "telemetry|compare|lint" in err


def test_cli_report_commands_dispatch(port_runs, tmp_path):
    """Each report command through ``cli.main`` prints what the module's
    main prints."""
    run = port_runs["train"]
    for cmd, fn, argv in (
            ("telemetry", summarize.main, [run]),
            ("compare", compare.main, [run, run]),
            ("doctor", doctor.main, [run]),
            ("numerics", numerics.main, [run]),
            ("timeline", timeline.main, [run, "--out",
                                         str(tmp_path / "t.json")]),
            ("converge", converge.main, [port_runs["eval"]]),
            ("fleet", fleet.main, [port_runs["fleet"], "--out",
                                   str(tmp_path / "f.json")])):
        assert _run_main(cli.main, [cmd, *argv]) == _run_main(fn, argv), cmd
    assert math.isfinite(summarize.summarize_run(run)["events"]["phases"][
        "dispatch_s"]["p50"])
