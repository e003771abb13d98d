"""The port's telemetry core (``raft_stereo_tpu_torch.obs``) against the JAX
package's (``raft_stereo_tpu.obs``).

* the same calls on both buses write the same records, apart from the
  clock (``ts``, ``t``), the process (``host_id``, ``pid``), the device
  fields and the run directory in paths;
* the span tracer builds the same span trees;
* the memory record carries ``torch.cuda``'s allocator statistics under
  the JAX key names; the compile hook turns each nvcc build into one
  ``compile`` record and an already built kernel into none;
* a run with tracing off emits the traced run's non-span records;
* a port eval run's ``events.jsonl`` passes ``scripts/check_events.py``
  (run as a subprocess, the way users lint a run).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raft_stereo_tpu import obs as jobs
from raft_stereo_tpu_torch import obs as tobs
from raft_stereo_tpu_torch.obs import telemetry as ttel
from raft_stereo_tpu_torch.ops.kernels import _build

from torch_parity import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fields that name the clock, the process, the device or the run directory
VOLATILE = {"ts", "t", "host_id", "pid", "devices", "path", "wall",
            "monotonic", "start_s", "dur_s", "traceback"}


def _normalized(run_dir):
    return [{k: v for k, v in rec.items() if k not in VOLATILE}
            for rec in jobs.read_events(os.path.join(run_dir,
                                                     "events.jsonl"))]


def _drive(mod, run_dir):
    """One scripted run on ``mod``'s bus: every record helper the eval and
    training paths call, a flight-recorder dump and the crash path."""
    with mod.Telemetry(run_dir, run_name="eval", stall_deadline_s=None,
                       host_id="host-a") as tel:
        tel.run_start(config={"dataset": "kitti", "valid_iters": 2})
        for i in range(3):
            tel.step(i + 1, data_wait_s=0.001 * i, dispatch_s=0.25,
                     fetch_s=1e-7, batch_size=2, in_flight=i)
        tel.pipeline(in_flight=2, window=3, microbatch=1)
        tel.loader_gauge({"queue_depth": 4, "wait_s": 0.5})
        tel.validation({"kitti-epe": np.float32(1.25), "kitti-d1": 3},
                       dataset="kitti")
        tel.throughput(12.345678, steps=3)
        tel.checkpoint(3, "ckpt/3", reason="final")
        tel.emit("anomaly", kind="nonfinite_grad", step=3)
        tel.error(ValueError("boom"))
    return tel


def test_records_equal_jax_records(tmp_path):
    tel = _drive(tobs, str(tmp_path / "port"))
    _drive(jobs, str(tmp_path / "jax"))
    got, want = _normalized(tel.run_dir), _normalized(
        str(tmp_path / "jax"))
    assert [r["event"] for r in got] == [r["event"] for r in want]
    assert got == want
    events = [r["event"] for r in got]
    assert events[:2] == ["run_start", "clock_anchor"]
    assert events.count("flightrec") == 2  # the anomaly and the crash
    assert events[-1] == "run_end"
    recs = jobs.read_events(os.path.join(tel.run_dir, "events.jsonl"))
    assert recs[0]["devices"] == {"platform": "cpu", "count": 1}
    assert all(r["host_id"] == "host-a" and r["pid"] == os.getpid()
               for r in recs)
    assert not jobs.validate_events(recs)


def test_event_schema_is_jax_schema():
    assert tobs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
    assert tobs.SUPPORTED_SCHEMA_VERSIONS == jobs.SUPPORTED_SCHEMA_VERSIONS
    assert tobs.EVENT_TYPES == jobs.EVENT_TYPES
    rec = tobs.make_record("step", t=1.0, step=1)
    assert tobs.validate_record(rec) == jobs.validate_record(rec) != []
    bad = [{"schema": 10, "ts": "x", "event": "nope"}, {"event": "step"}, 3]
    assert tobs.validate_events(bad) == jobs.validate_events(bad)


@pytest.mark.parametrize("explicit,env", [("a", None), (None, "b"),
                                          (None, None)])
def test_host_id_resolution_matches(monkeypatch, explicit, env):
    if env is None:
        monkeypatch.delenv(tobs.HOST_ID_ENV, raising=False)
    else:
        monkeypatch.setenv(tobs.HOST_ID_ENV, env)
    assert tobs.HOST_ID_ENV == jobs.HOST_ID_ENV
    assert tobs.TRACEPARENT_ENV == jobs.TRACEPARENT_ENV
    assert tobs.resolve_host_id(explicit) == jobs.resolve_host_id(explicit)


def _spans(mod, run_dir):
    tel = mod.Telemetry(run_dir, stall_deadline_s=None, fleet=False)
    tr = mod.Tracer(tel, flush_every=2)
    with tr.span("frame", index=0):
        with tr.span("decode"):
            pass
        ctx = tr.current()
        tr.record("predict", 1.0, 2.0, parent=ctx, frames=1)
    root = tr.record("eval/frames", 3.0, 5.0, frames=2)
    tr.record("eval/fetch", 4.0, 5.0, parent=root)
    open_span = tr.start("left-open")
    assert open_span.context.span_id in {s["span_id"]
                                         for s in tr.snapshot()}
    tel.close()  # closes the open span, flushes everything
    return [r for r in _normalized(run_dir) if r["event"] == "span"]


def test_tracer_spans_equal_jax_spans(tmp_path):
    got = _spans(tobs, str(tmp_path / "port"))
    want = _spans(jobs, str(tmp_path / "jax"))
    assert got == want
    assert [s["name"] for s in got] == ["decode", "predict", "frame",
                                        "eval/frames", "eval/fetch",
                                        "left-open"]
    assert tobs.tracer_for(None) is tobs.NULL_TRACER
    assert tobs.tracer_for(object(), enabled=False) is tobs.NULL_TRACER


def test_memory_record_uses_jax_key_names(tmp_path, monkeypatch):
    """Off the card the stats are {} (as JAX's on the CPU); on the card
    they are the allocator's under JAX's names (faked here: the test has
    no card); a run on the CPU of a machine with a card reports the CPU."""
    tel = tobs.Telemetry(str(tmp_path / "cpu"), stall_deadline_s=None)
    tel.memory()
    tel.close()
    assert jobs.read_events(tel.events_path)[-1]["stats"] == {}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda *a: {
        "allocated_bytes.all.current": 123,
        "allocated_bytes.all.peak": 456, "reserved_bytes.all.peak": 789})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (10, 80))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "H100")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    tel = tobs.Telemetry(str(tmp_path / "gpu"), stall_deadline_s=None)
    tel.run_start()
    tel.memory()
    tel.close()
    recs = jobs.read_events(tel.events_path)
    assert recs[0]["devices"] == {"platform": "gpu", "kind": "H100",
                                  "count": 1}
    assert recs[-1]["stats"] == {"bytes_in_use": 123,
                                 "peak_bytes_in_use": 456,
                                 "bytes_limit": 80}

    tel = tobs.Telemetry(str(tmp_path / "cpu_run"), stall_deadline_s=None,
                         device="cpu")
    tel.run_start()
    tel.memory()
    tel.close()
    recs = jobs.read_events(tel.events_path)
    assert recs[0]["devices"] == {"platform": "cpu", "count": 1}
    assert recs[-1]["stats"] == {}


def test_kernel_build_emits_one_compile_record(tmp_path, monkeypatch):
    """A build (nvcc replaced by a script that writes its ``-o`` file)
    emits one ``compile`` record naming the kernel; the same kernel
    already built emits none, and a closed bus hears nothing."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!" + sys.executable + "\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    tel = tobs.Telemetry(str(tmp_path / "run"), stall_deadline_s=None)
    _build.build_all(["windowed_sample"])
    _build.build_all(["windowed_sample"])  # built: no nvcc, no record
    tel.close()
    _build.build_all(["fused_corr"])  # no open bus
    compiles = [r for r in jobs.read_events(tel.events_path)
                if r["event"] == "compile"]
    assert len(compiles) == 1
    assert compiles[0]["source"] == "nvcc:windowed_sample"
    assert compiles[0]["duration_s"] >= 0
    assert ttel._compile_listener in _build._build_listeners


class _InstantPredictor:
    """A predictor without a model: flow = -(left image's first channel)."""

    def _flow(self, im1):
        return -np.asarray(im1, np.float32)[..., :1]

    def __call__(self, im1, im2, iters=None):
        return self._flow(im1)

    def predict_async(self, im1, im2, iters=None):
        flow = self._flow(im1)

        class Handle:
            dispatch_s, fetch_s = 0.0, 0.0

            def result(self):
                return flow
        return Handle()


@pytest.mark.parametrize("stream", [False, True], ids=["sequential",
                                                        "streamed"])
def test_tracing_off_emits_the_traced_records(tmp_path, stream):
    from raft_stereo_tpu_torch.eval.stream import StreamConfig, run_frames
    from torch_parity import write_eth3d
    from raft_stereo_tpu_torch.data import ETH3D
    write_eth3d(tmp_path / "ds", np.random.default_rng(4), n=3)
    ds = ETH3D(root=str(tmp_path / "ds" / "ETH3D"))
    cfg = StreamConfig(enabled=stream, window=2, microbatch=2)
    streams, flows = {}, {}
    for traced in (True, False):
        run = str(tmp_path / f"run_{traced}")
        tel = tobs.Telemetry(run, stall_deadline_s=None)
        tr = tobs.tracer_for(tel, enabled=traced)
        assert (tr is tobs.NULL_TRACER) is not traced
        out = []
        run_frames(_InstantPredictor(), ds,
                   lambda i, s, f, t: out.append((i, f.copy())), iters=2,
                   stream=cfg, telemetry=tel)
        tel.close()
        recs = jobs.read_events(tel.events_path)
        timing = ("data_wait_s", "dispatch_s", "fetch_s", "ts", "t")
        streams[traced] = [{k: v for k, v in r.items() if k not in timing}
                           for r in recs if r["event"] != "span"]
        flows[traced] = out
        spans = [r for r in recs if r["event"] == "span"]
        assert bool(spans) is traced
    assert streams[True] == streams[False]
    assert [i for i, _ in flows[True]] == [0, 1, 2]
    for (_, a), (_, b) in zip(flows[True], flows[False]):
        assert np.array_equal(a, b)


def test_port_eval_run_passes_check_events(tmp_path, capsys):
    """The port's eval entry point on the CPU, streamed, with a run
    directory (in-process: ``tests/test_torch_eval.py`` runs it as
    ``python -m``); ``scripts/check_events.py`` lints the result as users
    lint a run, in a subprocess."""
    from raft_stereo_tpu_torch import evaluate
    from torch_parity import write_eth3d
    write_eth3d(tmp_path / "ds", np.random.default_rng(5))
    run = tmp_path / "run"
    evaluate.main(["--device", "cpu", "--dataset", "eth3d", "--data_root",
                   str(tmp_path / "ds"), "--valid_iters", "2",
                   "--hidden_dims", "32", "32", "32", "--stream", "on",
                   "--run_dir", str(run)])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "{'eth3d-epe'")
    lint = subprocess.run([sys.executable, "scripts/check_events.py",
                           str(run)], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert lint.returncode == 0, lint.stdout + lint.stderr
    events = [json.loads(line)["event"]
              for line in open(run / "events.jsonl")]
    assert events.count("step") == 2 and events.count("validation") == 1
    assert events[-1] == "run_end"
