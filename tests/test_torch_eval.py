"""The port's evaluation path (predictor, stream driver, validators, entry
point) against the JAX package's, on bridged weights and synthetic trees.

* each of the four port validators matches the JAX validator run
  sequentially (``stream=False``): per-frame flow within 1e-3 px (fp32),
  EPE within 1e-4 px, D1 equal except for pixels whose JAX endpoint error
  lies within 1e-3 px of the threshold (counted, and only those allowed);
* port streamed (window 3) equals port sequential bitwise, decoded in
  worker processes (the port's datasets' default) or on threads. With
  frames stacked two a dispatch (micro-batch 2) the CPU's convolutions and
  matmuls take other kernels for batch 2 than for batch 1 (oneDNN and
  without it; ~1e-5 px apart on these frames), so there the flows are held
  within 1e-4 px, EPE within 1e-5 px and D1 to its threshold pixels. The
  JAX predictor shows the same batch-2 gap on the same inputs, and in both
  a frame's flow in a batch is bitwise independent of its partner and slot;
* ``predict_async(...).result()`` equals ``__call__``;
* the JAX package's fake-latency pipeline tests, against the port's driver;
* ``python -m raft_stereo_tpu_torch.evaluate --device cpu`` runs end to
  end, and its ``events.jsonl`` has the event kinds and counts of a JAX
  eval run with ``--no_converge --no_numerics --stream off``; streamed, it
  leaves no process running once it has exited; ``--iter_epe`` raises.
"""

import collections
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RAFTStereoConfig
from raft_stereo_tpu.eval import validate as jval
from raft_stereo_tpu.inference import StereoPredictor as JaxPredictor
from raft_stereo_tpu.obs import read_events
from raft_stereo_tpu_torch import evaluate
from raft_stereo_tpu_torch.data import datasets as tds
from raft_stereo_tpu_torch.eval import validate as tval
from raft_stereo_tpu_torch.eval.stream import (FrameTiming, StreamConfig,
                                               decodes_in_processes,
                                               run_frames)
from raft_stereo_tpu_torch.inference import StereoPredictor
from raft_stereo_tpu_torch.obs import Telemetry
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

import torch_parity as tp
from torch_parity import (jax_readers_without_native,  # noqa: F401
                          torch_one_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 3
FLOW_TOL_PX = 1e-3
EPE_TOL_PX = 1e-4
CFG = RAFTStereoConfig(hidden_dims=(32, 32, 32))
STREAM = StreamConfig(enabled=True, window=3, microbatch=2, decode_workers=2)
MICROBATCH_TOL_PX = 1e-4  # batch 2 against batch 1 on the CPU (fp32)

# validator -> (D1 threshold px, validity of a sample, D1 weighting): the
# JAX package's definitions (raft_stereo_tpu/eval/validate.py)
RULES = {
    "eth3d": (1.0, lambda s: s["valid"] >= 0.5, "image"),
    "kitti": (3.0, lambda s: s["valid"] >= 0.5, "pixel"),
    "things": (1.0, lambda s: (s["valid"] >= 0.5)
               & (np.abs(s["flow"][..., 0]) < 192.0), "pixel"),
    "middlebury": (2.0, lambda s: (s["valid"] >= -0.5)
                   & (s["flow"][..., 0] > -1000), "image"),
}
KWARGS = {"kitti": {"warmup_frames": 0}, "middlebury": {"split": "F"}}
PREFIX = {"eth3d": "eth3d", "kitti": "kitti", "things": "things",
          "middlebury": "middleburyF"}


def _dataset(name, root):
    return {"eth3d": lambda: tds.ETH3D(root=f"{root}/ETH3D"),
            "kitti": lambda: tds.KITTI(root=f"{root}/KITTI"),
            "things": lambda: tds.SceneFlow(root=root,
                                            dstype="frames_finalpass",
                                            things_test=True),
            "middlebury": lambda: tds.Middlebury(
                root=f"{root}/Middlebury")}[name]()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    ds = tmp_path_factory.mktemp("eval_tree") / "datasets"
    return tp.write_eval_tree(ds, np.random.default_rng(21))


@pytest.fixture(scope="module")
def variables():
    return tp.jax_variables(CFG, seed=3, image_shape=(1, 64, 96, 3))


@pytest.fixture(scope="module")
def jax_predictor(variables):
    return JaxPredictor(CFG, variables, valid_iters=ITERS)


@pytest.fixture(scope="module")
def predictor(variables):
    return StereoPredictor(tp.port_config(CFG), state_dict_from_jax(variables),
                           valid_iters=ITERS, device="cpu")


class Recording:
    """A predictor whose every returned flow is kept, in return order:
    synchronous calls and the results of ``predict_async``'s handles (the
    stream driver fetches each handle once, in index order)."""

    def __init__(self, predictor):
        self.predictor, self.flows = predictor, []

    def __call__(self, im1, im2, iters=None):
        flow = self.predictor(im1, im2, iters)
        self.flows.extend(np.array(flow))
        return flow

    def predict_timed(self, im1, im2, iters=None):
        flow, dt = self.predictor.predict_timed(im1, im2, iters)
        self.flows.extend(np.array(flow))
        return flow, dt

    def predict_async(self, im1, im2, iters=None):
        handle = self.predictor.predict_async(im1, im2, iters)
        flows = self.flows

        class Handle:
            dispatch_s = handle.dispatch_s

            def result(self):
                flow = handle.result()
                flows.extend(np.array(flow))
                self.fetch_s = handle.fetch_s
                return flow
        return Handle()


@pytest.fixture(scope="module")
def port_runs(tree, predictor):
    """``run(name, mode)``: the port validator ``name`` over the tree,
    sequential, streamed (window 3) or micro-batched (window 3,
    micro-batch 2), once a module: (per-frame flows, metrics without the
    wall-clock FPS)."""
    streams = {"sequential": False,
               "streamed": StreamConfig(enabled=True, window=3, microbatch=1,
                                        decode_workers=2),
               "microbatch": STREAM}
    memo = {}

    def run(name, mode):
        if (name, mode) not in memo:
            rec = Recording(predictor)
            results = tval.VALIDATORS[name](
                rec, root=str(tree), iters=ITERS, stream=streams[mode],
                **KWARGS.get(name, {}))
            memo[name, mode] = (rec.flows, {
                k: v for k, v in results.items()
                if not k.endswith(("fps", "fps-e2e"))})
        return memo[name, mode]
    return run


def _d1_allowance(name, samples, ref_flows, tol=FLOW_TOL_PX):
    """Largest D1 difference (percent) the threshold pixels can make: the
    valid pixels whose reference endpoint error lies within ``tol`` of the
    threshold, weighted as the validator weights D1."""
    thr, valid_of, weighting = RULES[name]
    near, total = [], []
    for s, f in zip(samples, ref_flows):
        valid = valid_of(s)
        epe = np.abs(f[..., 0] - s["flow"][..., 0])
        near.append(int((np.abs(epe - thr) <= tol)[valid].sum()))
        total.append(int(valid.sum()))
    if weighting == "pixel":
        return 100.0 * sum(near) / sum(total), sum(near)
    return 100.0 * float(np.mean([n / t for n, t in zip(near, total)])), \
        sum(near)


@pytest.mark.parametrize("name", list(RULES))
def test_validator_matches_jax_sequential(tree, jax_predictor, port_runs,
                                          name):
    jrec = Recording(jax_predictor)
    want = jval.VALIDATORS[name](jrec, root=str(tree), iters=ITERS,
                                 stream=False, **KWARGS.get(name, {}))
    flows, got = port_runs(name, "sequential")
    assert got.keys() == {k for k in want
                          if not k.endswith(("fps", "fps-e2e"))}
    samples = [_dataset(name, str(tree)).sample(i)
               for i in range(len(jrec.flows))]
    assert len(flows) == len(jrec.flows) == len(samples) > 0
    for a, b in zip(flows, jrec.flows):
        assert a.shape == b.shape
        assert tp.max_abs(a, b) <= FLOW_TOL_PX
    prefix = PREFIX[name]
    assert abs(got[f"{prefix}-epe"] - want[f"{prefix}-epe"]) <= EPE_TOL_PX
    allowed, n_near = _d1_allowance(name, samples, jrec.flows)
    d1_diff = abs(got[f"{prefix}-d1"] - want[f"{prefix}-d1"])
    assert d1_diff <= allowed + 1e-9, (d1_diff, n_near)
    assert 0.0 < want[f"{prefix}-d1"] < 100.0  # the threshold is exercised


@pytest.mark.parametrize("name", list(RULES))
def test_streamed_equals_sequential_bitwise(port_runs, name):
    seq_flows, seq = port_runs(name, "sequential")
    flows, got = port_runs(name, "streamed")
    assert len(flows) == len(seq_flows) > 0
    for a, b in zip(flows, seq_flows):
        assert np.array_equal(a, b)
    assert got == seq


class _OnThreads:
    """A dataset seen through a plain object: the stream driver decodes
    it on threads (only the port's own datasets decode in processes)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def sample(self, i):
        return self.dataset.sample(i)


@pytest.mark.parametrize("name", list(RULES))
def test_decode_in_processes_equals_threads_bitwise(tree, predictor, name):
    """The port's datasets decode in worker processes, any other dataset
    on threads; the two give the same frames and flows, bitwise."""
    ds = _dataset(name, str(tree))
    assert decodes_in_processes(ds)
    assert not decodes_in_processes(_OnThreads(ds))
    runs = []
    for data in (ds, _OnThreads(ds)):
        got = []
        run_frames(predictor, data, lambda i, s, f, t: got.append((i, s, f)),
                   iters=ITERS, stream=StreamConfig(enabled=True, window=3))
        runs.append(got)
    assert len(runs[0]) == len(runs[1]) == len(ds) > 0
    for (i, s, f), (j, t, g) in zip(*runs):
        assert i == j and np.array_equal(f, g)
        assert s.keys() == t.keys() and all(
            np.array_equal(s[k], t[k]) for k in s)


@pytest.mark.parametrize("name", list(RULES))
def test_streamed_microbatch_matches_sequential(tree, port_runs, name):
    seq_flows, seq = port_runs(name, "sequential")
    flows, got = port_runs(name, "microbatch")
    assert len(flows) == len(seq_flows) > 0
    for a, b in zip(flows, seq_flows):
        assert tp.max_abs(a, b) <= MICROBATCH_TOL_PX
    prefix = PREFIX[name]
    assert abs(got[f"{prefix}-epe"] - seq[f"{prefix}-epe"]) <= 1e-5
    samples = [_dataset(name, str(tree)).sample(i)
               for i in range(len(flows))]
    allowed, _ = _d1_allowance(name, samples, seq_flows,
                               tol=MICROBATCH_TOL_PX)
    assert abs(got[f"{prefix}-d1"] - seq[f"{prefix}-d1"]) <= allowed + 1e-9


def test_batch_of_two_gap_is_the_frameworks(jax_predictor, predictor):
    """Why micro-batching is held to a tolerance on the CPU and not
    bitwise: the JAX predictor too gives a frame other flows in a batch of
    two than alone (the CPU's kernels differ by batch size; ~7e-6 px in
    JAX, ~8e-6 px in the port on these inputs). In the port the first
    layer whose output departs from batch 1's is a convolution whose
    inputs are still bitwise equal. In both, a frame's flow in a batch of
    two is bitwise independent of its partner and of its slot: no element
    of a batch leaks into another, at any scale."""
    from chip_smoke import first_divergence
    rng = np.random.default_rng(5)
    left = rng.uniform(0, 255, (3, 48, 96, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (3, 48, 96, 3)).astype(np.float32)
    gaps = {}
    for name, pred in (("jax", jax_predictor), ("port", predictor)):
        alone = np.asarray(pred(left[:1], right[:1]))
        pair = np.asarray(pred(left[:2], right[:2]))
        other = np.asarray(pred(left[[0, 2]], right[[0, 2]]))
        swapped = np.asarray(pred(left[[2, 0]], right[[2, 0]]))
        assert np.array_equal(pair[0], other[0]), name
        assert np.array_equal(pair[0], swapped[1]), name
        gaps[name] = tp.max_abs(pair[:1], alone)
    assert 0.0 < gaps["jax"] <= MICROBATCH_TOL_PX, gaps
    assert gaps["port"] <= MICROBATCH_TOL_PX, gaps
    name, _, inputs_equal, _, _ = first_divergence(predictor,
                                                   (left[:2], right[:2]))
    assert inputs_equal and isinstance(
        predictor.model.get_submodule(name), torch.nn.Conv2d), name


def test_kitti_fps_keys_by_mode(tree, predictor):
    seq = tval.validate_kitti(predictor, root=str(tree), iters=ITERS,
                              warmup_frames=0, stream=False)
    strm = tval.validate_kitti(predictor, root=str(tree), iters=ITERS,
                               warmup_frames=0, stream=STREAM)
    assert "kitti-fps" in seq and "kitti-fps-e2e" in seq
    assert "kitti-fps" not in strm and "kitti-fps-e2e" in strm


def test_predict_async_matches_call(predictor):
    rng = np.random.default_rng(3)
    left = rng.uniform(0, 255, (2, 47, 90, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (2, 47, 90, 3)).astype(np.float32)
    sync = predictor(left, right, iters=2)
    handle = predictor.predict_async(left, right, iters=2)
    assert handle.ready()  # the CPU forward ran in the call
    out = handle.result()
    assert out.shape == sync.shape == (2, 47, 90, 1)
    assert np.array_equal(out, sync)
    assert handle.exception() is None and handle.aux_result() is None
    assert handle.fetch_s is not None and handle.dispatch_s >= 0.0
    assert handle.result() is out  # idempotent, cached
    u8 = rng.integers(0, 255, (1, 32, 64, 3), dtype=np.uint8)
    assert np.array_equal(predictor.predict_async(u8, u8, 2).result(),
                          predictor(u8.astype(np.float32), u8, 2))
    assert predictor.take_aux() is None


def test_stream_on_requires_async_predictor():
    class NoAsync:
        pass

    with pytest.raises(ValueError, match="predict_async"):
        run_frames(NoAsync(), [], lambda *a: None, iters=2, stream=True)


# ----------------------- the JAX package's injected-latency pipeline tests

class _FakeFrames:
    """Minimal dataset: n identical tiny frames, instant decode."""

    def __init__(self, n, h=8, w=16):
        self.n = n
        self._s = {
            "image1": np.zeros((h, w, 3), np.uint8),
            "image2": np.zeros((h, w, 3), np.uint8),
            "flow": np.zeros((h, w, 1), np.float32),
            "valid": np.ones((h, w), np.float32),
        }

    def __len__(self):
        return self.n

    def sample(self, i):
        return dict(self._s)


def _sleep_until(t):
    while True:
        dt = t - time.monotonic()
        if dt <= 0:
            return
        time.sleep(dt)


class _FakeLatencyPredictor:
    """Single-queue fake device with a host round-trip cost: dispatches
    serialize on the 'device' (``device_s`` a frame); the serial paths pay
    two round-trips a frame, the async path one, after completion."""

    def __init__(self, device_s, rtt_s):
        self.device_s, self.rtt_s = device_s, rtt_s
        self._free_at = time.monotonic()

    def _enqueue(self, batch):
        start = max(time.monotonic(), self._free_at)
        self._free_at = done = start + self.device_s * batch
        return done

    def _flow(self, im1):
        return np.zeros(im1.shape[:3] + (1,), np.float32)

    def predict_async(self, im1, im2, iters=None):
        done = self._enqueue(im1.shape[0])
        outer = self

        class Handle:
            dispatch_s = 0.0
            fetch_s = 0.0

            def result(self):
                _sleep_until(done)         # device completion
                time.sleep(outer.rtt_s)    # one D2H round-trip
                return outer._flow(im1)

        return Handle()

    def predict_timed(self, im1, im2, iters=None):
        time.sleep(self.rtt_s)             # inputs settled first
        done = self._enqueue(im1.shape[0])
        _sleep_until(done)
        time.sleep(self.rtt_s)             # full-map fetch
        return self._flow(im1), self.device_s * im1.shape[0]

    def __call__(self, im1, im2, iters=None):
        return self.predict_timed(im1, im2, iters)[0]


def test_pipeline_speedup_at_window_2plus():
    """>=2x end-to-end throughput over the serial path at in-flight window
    >= 2 (serial pays device + 2 RTT a frame; the pipeline retires at
    max(device, RTT))."""
    n, device_s, rtt_s = 20, 0.008, 0.012
    ds = _FakeFrames(n)
    seen = []

    def consume(i, sample, flow, timing):
        assert isinstance(timing, FrameTiming)
        seen.append(i)

    serial = run_frames(_FakeLatencyPredictor(device_s, rtt_s), ds, consume,
                        iters=2, stream=False, timed=True)
    assert seen == list(range(n))
    seen.clear()
    stream = run_frames(
        _FakeLatencyPredictor(device_s, rtt_s), ds, consume, iters=2,
        stream=StreamConfig(enabled=True, window=3, microbatch=1))
    assert seen == list(range(n))  # retire order == index order
    assert serial["mode"] == "sequential" and stream["mode"] == "stream"
    speedup = serial["wall_s"] / stream["wall_s"]
    assert speedup >= 2.0, (
        f"pipeline speedup {speedup:.2f}x < 2x "
        f"(serial {serial['wall_s']:.3f}s, stream {stream['wall_s']:.3f}s)")


def test_microbatch_groups_same_shape_frames():
    ds = _FakeFrames(8)
    sizes = []
    run_frames(_FakeLatencyPredictor(1e-4, 1e-4), ds,
               lambda i, s, f, t: sizes.append(t.batch_size), iters=2,
               stream=StreamConfig(enabled=True, window=2, microbatch=4))
    assert len(sizes) == 8
    assert max(sizes) > 1


def test_streaming_emits_steps_and_pipeline_gauge(tree, predictor,
                                                  tmp_path):
    run = tmp_path / "run"
    tel = Telemetry(str(run), run_name="stream-eval")
    tel.run_start(config={"dataset": "eth3d"})
    tval.validate_eth3d(predictor, root=str(tree), iters=ITERS,
                        telemetry=tel, stream=STREAM)
    tel.emit("run_end", steps=tel.steps, ok=True)
    tel.close()

    events = read_events(str(run / "events.jsonl"))
    steps = [e for e in events if e["event"] == "step"]
    assert [s["step"] for s in steps] == [1, 2]  # every frame, in order
    for s in steps:
        assert {"data_wait_s", "dispatch_s", "fetch_s", "in_flight",
                "batch_size"} <= set(s)
    gauges = [e for e in events if e["event"] == "pipeline"]
    assert gauges and all("in_flight" in g for g in gauges)
    assert gauges[0]["window"] == STREAM.window

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import check_events
    assert check_events.main([str(run)]) == 0


def test_sequential_validators_emit_steps_too(tree, predictor, tmp_path):
    run = tmp_path / "run"
    tel = Telemetry(str(run), run_name="seq-eval")
    tval.validate_middlebury(predictor, root=str(tree), iters=ITERS,
                             telemetry=tel, stream=False)
    tel.close()
    steps = [e for e in read_events(str(run / "events.jsonl"))
             if e["event"] == "step"]
    assert len(steps) == 1 and steps[0]["in_flight"] == 1


def test_empty_valid_mask_skips_frame_with_warning(tmp_path, predictor,
                                                   caplog):
    ds = tmp_path / "datasets"
    tp.write_eth3d(ds, np.random.default_rng(5), n=2, bad_frames=(1,))
    with caplog.at_level(logging.WARNING,
                         logger="raft_stereo_tpu_torch.eval.validate"):
        result = tval.validate_eth3d(predictor, root=str(ds), iters=ITERS,
                                     stream=False)
    assert np.isfinite(result["eth3d-epe"])
    assert any("validity mask is empty" in r.message for r in caplog.records)


# ------------------------------------------------------------ entry point

def test_entry_point_events_match_jax_run(tree, tmp_path, monkeypatch,
                                          capsys):
    """The port's evaluate on the CPU and the JAX package's eval main on
    the same tree and flags: the same event kinds and counts. ``compile``
    records are left out: a JAX run compiles XLA programs, a port run on
    the CPU builds no kernel."""
    from raft_stereo_tpu import cli as jcli
    flags = ["--dataset", "kitti", "--data_root", str(tree),
             "--valid_iters", "2", "--hidden_dims", "32", "32", "32",
             "--stream", "off", "--no_converge", "--no_numerics"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # one intra-op thread, as in-process
    out = subprocess.run(
        [sys.executable, "-m", "raft_stereo_tpu_torch.evaluate", "--device",
         "cpu", "--run_dir", str(tmp_path / "port"), *flags],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("{'kitti-epe'")
    monkeypatch.setattr(sys, "argv", ["eval", "--run_dir",
                                      str(tmp_path / "jax"), *flags])
    jcli._eval_main()

    def kinds(run):
        return collections.Counter(
            json.loads(line)["event"]
            for line in open(tmp_path / run / "events.jsonl")
            if json.loads(line)["event"] != "compile")
    assert kinds("port") == kinds("jax")
    assert kinds("port")["step"] == 2


def _session_processes(sid):
    """Commands of the live (not zombie) processes of session ``sid``."""
    found = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if fields[0] != "Z" and int(fields[3]) == sid:
            found.append(cmd)
    return found


def test_streamed_entry_point_leaves_no_process(tree, tmp_path):
    """A streamed run decodes in worker processes forked from a fork
    server; the entry point's process does not end before that server and
    multiprocessing's resource tracker have: nothing of its session is
    left running once it has exited."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    # output to files: a pipe would stay open, and communicate() wait, for
    # as long as a process that inherited it runs
    out_path, err_path = tmp_path / "stdout", tmp_path / "stderr"
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "raft_stereo_tpu_torch.evaluate",
             "--device", "cpu", "--run_dir", str(tmp_path / "port"),
             "--dataset", "kitti", "--data_root", str(tree), "--valid_iters",
             "2", "--hidden_dims", "32", "32", "32", "--stream", "on"],
            cwd=REPO, env=env, stdout=out, stderr=err,
            start_new_session=True)
    try:
        proc.wait(timeout=300)
        left = _session_processes(proc.pid)
    finally:
        proc.kill()
        for pid in [int(n) for n in os.listdir("/proc") if n.isdigit()]:
            try:
                if os.getsid(pid) == proc.pid:
                    os.kill(pid, 9)
            except OSError:
                pass
    assert proc.returncode == 0, err_path.read_text()
    assert out_path.read_text().strip().splitlines()[-1].startswith(
        "{'kitti-epe'")
    assert any(json.loads(line)["event"] == "pipeline"
               for line in open(tmp_path / "port" / "events.jsonl"))
    assert left == []


def test_iter_epe_and_iter_policy_raise(tree):
    base = ["--device", "cpu", "--dataset", "kitti", "--data_root",
            str(tree)]
    for extra in (["--iter_epe"], ["--iter_policy", "p.json"]):
        with pytest.raises(ValueError, match="A11"):
            evaluate.main(base + extra)
    # a directory that is no trainer checkpoint is refused by name
    with pytest.raises(ValueError, match="neither a reference .pth nor a "
                                         "checkpoint directory"):
        evaluate.load_weights(str(tree), tp.port_config(CFG))
