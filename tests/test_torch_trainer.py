"""The port's trainer and its fault tolerance
(``raft_stereo_tpu_torch/training/{resilience,checkpoint,trainer}.py``,
``python -m raft_stereo_tpu_torch.train``), on the CPU.

* Resilience units, as the JAX package's tests/test_resilience.py holds
  its own: the atomic save and manifest, damage and digest/structure
  mismatches found, clobber in place or to ``.bak``, retention, auto-resume
  skipping corrupt and foreign checkpoints, ``SignalGuard``,
  ``AnomalyPolicy``, and the emergency checkpoint on a finite state, a
  non-finite one and an ``AnomalyHalt``.
* Trainer parity: the JAX package's ``train()`` and the port's
  ``train(device="cpu")`` from one reference ``.pth`` on one synthetic
  SceneFlow tree with the recipe's augmentation (hidden 32, 1 iteration,
  batch 2 at 48x64, 3 steps). Per-step losses from both ``events.jsonl``
  within LOSS_REL, and the final parameters within the null floor of
  tests/test_torch_training.py::test_two_steps_match_jax_step (NULL_RUNS
  JAX runs of the same three batches through the JAX trainer's own step
  function, each from weights scaled by 1 + 1e-6 N(0, 1); floor 1e-5).
  The JAX side runs once: its model comes from ``jax.eval_shape`` (the
  .pth replaces the weights) and its step is not introspected, so the one
  compile is the step's.
* The drill (after scripts/fault_drill.py), through ``python -m
  raft_stereo_tpu_torch.train --device cpu`` subprocesses, each in a
  session of its own, torch on one thread: an uninterrupted oracle; SIGTERM
  (a ``reason="preempt"`` checkpoint, exit 0, then ``--restore_ckpt
  auto``); SIGKILL after a periodic checkpoint; SIGKILL, then the newest
  checkpoint truncated (``ckpt_integrity ok=false`` recorded, rollback to
  the one before); and a NaN batch (the update skipped, the run finishes
  with finite parameters). The three interrupted legs end with parameters
  bitwise equal to the oracle's and the oracle's per-step losses; no leg
  that exits leaves a process behind.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from raft_stereo_tpu.config import RAFTStereoConfig as JConfig
from raft_stereo_tpu.config import TrainConfig as JTrainConfig
from raft_stereo_tpu_torch.config import TrainConfig
from raft_stereo_tpu_torch.obs import read_events, validate_events
from raft_stereo_tpu_torch.training import resilience as rz
from raft_stereo_tpu_torch.training.checkpoint import (load_payload,
                                                       restore_train_state,
                                                       save_train_state)
from raft_stereo_tpu_torch.training.optim import fetch_optimizer
from raft_stereo_tpu_torch.training.state import TrainState

from torch_parity import (jax_readers_without_native,  # noqa: F401
                          jax_variables, null_gate, perturbed, port_config,
                          torch_one_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = (32, 32, 32)
H, W = 48, 64
NULL_RUNS = 8
LOSS_REL = 1e-3
DRILL_STEPS = 8
DRILL_CKPT_EVERY = 2
CHILD_TIMEOUT_S = 300


# --- resilience units --------------------------------------------------------

def tiny_state(seed=0, step=0):
    """A TrainState of a 4 -> 3 linear layer, after one optimizer update
    (moments and count non-trivial)."""
    g = torch.Generator().manual_seed(seed)
    model = torch.nn.Linear(4, 3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    opt = fetch_optimizer(TrainConfig(num_steps=10), model.parameters())
    opt.step([torch.randn(p.shape, generator=g) for p in model.parameters()])
    return TrainState(model, opt, step=step)


def corrupt_one_file(ckpt_path, mode="flip"):
    victim = os.path.join(ckpt_path, "state", rz.STATE_FILE)
    if mode == "truncate":
        with open(victim, "r+b") as f:
            f.truncate(max(os.path.getsize(victim) // 2, 1))
    else:
        with open(victim, "r+b") as f:
            f.seek(100)
            byte = f.read(1)
            f.seek(100)
            f.write(bytes([byte[0] ^ 0xFF]))


def _same_state(a, b):
    pa, pb = rz.state_payload(a), rz.state_payload(b)
    assert rz.tree_structure_hash(pa) == rz.tree_structure_hash(pb)
    return all(
        (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
        for (_, x), (_, y) in zip(rz._leaves(pa), rz._leaves(pb)))


def test_atomic_save_verify_restore_roundtrip(tmp_path):
    state = tiny_state(step=7)
    path = save_train_state(str(tmp_path), "run", state, step=7,
                            config_digest="abcd1234")
    assert path.endswith("7_run")
    manifest = rz.load_manifest(path)
    assert manifest["step"] == 7 and manifest["config_digest"] == "abcd1234"
    assert manifest["tree_hash"] == rz.tree_structure_hash(state)
    assert manifest["files"] == {rz.STATE_FILE: manifest["files"][
        rz.STATE_FILE]}
    ok, reason, _ = rz.verify_checkpoint(
        path, config_digest="abcd1234",
        tree_hash=rz.tree_structure_hash(tiny_state(seed=99)))
    assert ok, reason
    target = tiny_state(seed=99)
    target.optimizer.adamw.state.clear()  # a fresh optimizer
    target.optimizer.count = 0
    restored = restore_train_state(path, target)
    assert restored.step == 7 and restored.optimizer.count == 1
    assert _same_state(restored, state)
    # no temp dirs left behind
    assert not [e for e in os.listdir(tmp_path) if e.startswith(".")]


@pytest.mark.parametrize("mode", ["truncate", "flip"])
def test_verify_detects_damage(tmp_path, mode):
    path = save_train_state(str(tmp_path), "run", tiny_state(), step=3)
    assert rz.verify_checkpoint(path)[0]
    corrupt_one_file(path, mode=mode)
    ok, reason, _ = rz.verify_checkpoint(path)
    assert not ok
    assert ("size mismatch" if mode == "truncate" else "crc") in reason


def test_verify_rejects_digest_and_structure_mismatch(tmp_path):
    path = save_train_state(str(tmp_path), "run", tiny_state(), step=3,
                            config_digest="aaaa")
    ok, reason, _ = rz.verify_checkpoint(path, config_digest="bbbb")
    assert not ok and "config digest" in reason
    other = {"model": {"weight": torch.zeros(2, 2)}}
    ok, reason, _ = rz.verify_checkpoint(
        path, tree_hash=rz.tree_structure_hash(other))
    assert not ok and "structure" in reason


def test_auto_resume_skips_corrupt_newest(tmp_path):
    state = tiny_state()
    old = save_train_state(str(tmp_path), "run", state, step=2,
                           config_digest="d1")
    new = save_train_state(str(tmp_path), "run", state, step=4,
                           config_digest="d1")
    corrupt_one_file(new, mode="truncate")
    best, reports = rz.find_latest_valid(str(tmp_path), "run",
                                         config_digest="d1")
    assert best == old
    assert [r["ok"] for r in reports] == [False, True]
    assert reports[0]["path"] == new and "size mismatch" in reports[0][
        "reason"]
    # a missing manifest (a torn checkpoint) is skipped, not fatal
    os.remove(os.path.join(new, "MANIFEST.json"))
    best2, reports2 = rz.find_latest_valid(str(tmp_path), "run")
    assert best2 == old and "manifest" in reports2[0]["reason"]


def test_auto_resume_skips_foreign_digest(tmp_path):
    state = tiny_state()
    save_train_state(str(tmp_path), "other-config", state, step=9)
    theirs = save_train_state(str(tmp_path), "run", state, step=9,
                              config_digest="theirs")
    mine = save_train_state(str(tmp_path), "run", state, step=5,
                            config_digest="mine")
    best, reports = rz.find_latest_valid(str(tmp_path), "run",
                                         config_digest="mine")
    assert best == mine
    assert reports[0]["path"] == theirs and not reports[0]["ok"]


def test_clobber_same_digest_overwrites_in_place(tmp_path):
    a, b = tiny_state(seed=1), tiny_state(seed=2)
    p1 = save_train_state(str(tmp_path), "run", a, config_digest="same")
    p2 = save_train_state(str(tmp_path), "run", b, config_digest="same")
    assert p1 == p2 and not os.path.exists(p1 + ".bak")
    assert _same_state(restore_train_state(p1, tiny_state(seed=99)), b)


def test_clobber_mismatched_digest_rotates_to_bak(tmp_path):
    a, b = tiny_state(seed=1), tiny_state(seed=2)
    p1 = save_train_state(str(tmp_path), "run", a, config_digest="old-run")
    p2 = save_train_state(str(tmp_path), "run", b, config_digest="new-run")
    assert p1 == p2 and os.path.isdir(p1 + ".bak")
    assert _same_state(restore_train_state(p1 + ".bak", tiny_state(99)), a)
    assert _same_state(restore_train_state(p2, tiny_state(99)), b)


def test_retention_keeps_last_k_and_every_nth(tmp_path):
    state = tiny_state()
    for step in (2, 4, 6, 8, 10):
        save_train_state(str(tmp_path), "run", state, step=step)
    deleted = rz.apply_retention(str(tmp_path), "run", keep_last=2,
                                 keep_every=4)
    kept = sorted(e for e in os.listdir(tmp_path) if e.endswith("_run"))
    assert kept == ["10_run", "4_run", "8_run"]
    assert sorted(os.path.basename(d) for d in deleted) == ["2_run",
                                                            "6_run"]
    for step in (12, 14):
        save_train_state(str(tmp_path), "run", state, step=step,
                         keep_last=2, keep_every=4)
    kept = sorted(e for e in os.listdir(tmp_path) if e.endswith("_run"))
    assert kept == ["12_run", "14_run", "4_run", "8_run"]


def test_config_digest_and_structure_hash():
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    m1, t1 = RAFTStereoConfig(), TrainConfig()
    assert rz.config_digest(m1, t1) == rz.config_digest(
        RAFTStereoConfig(), TrainConfig())
    assert rz.config_digest(m1, t1) != rz.config_digest(
        RAFTStereoConfig(hidden_dims=(96, 96, 96)), t1)
    assert rz.config_digest(m1, t1) != rz.config_digest(
        m1, TrainConfig(lr=1e-3))
    assert rz.config_digest(m1, t1) == rz.config_digest(
        m1, TrainConfig(name="other", ckpt_dir="elsewhere",
                        validation_frequency=123, checkpoint_frequency=7))
    a = rz.state_payload(tiny_state())
    assert rz.tree_structure_hash(a) == rz.tree_structure_hash(
        tiny_state(seed=5))  # values do not count
    # a fresh optimizer has the same structure as a stepped one
    fresh = tiny_state()
    fresh.optimizer.adamw.state.clear()
    assert rz.tree_structure_hash(fresh) == rz.tree_structure_hash(a)
    b = rz.state_payload(tiny_state())
    b["model"]["weight"] = b["model"]["weight"].half()
    assert rz.tree_structure_hash(a) != rz.tree_structure_hash(b)


def test_state_is_finite():
    good = tiny_state()
    assert rz.state_is_finite(good)
    assert rz.state_is_finite(rz.state_payload(good))
    with torch.no_grad():
        good.model.weight[0, 0] = float("nan")
    assert not rz.state_is_finite(good)
    assert not rz.state_is_finite(rz.state_payload(good))


def test_signal_guard_records_and_restores():
    prev = signal.getsignal(signal.SIGTERM)
    with rz.SignalGuard() as guard:
        assert guard.installed and not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested and guard.signame == "SIGTERM"
    assert signal.getsignal(signal.SIGTERM) is prev


class _Bus:
    def __init__(self):
        self.events = []

    def emit(self, event, **payload):
        self.events.append(dict(payload, event=event))

    def checkpoint(self, step, path, **payload):
        self.events.append(dict(payload, event="checkpoint", step=step,
                                path=path))


def test_anomaly_policy_halts_after_consecutive_skips():
    bus = _Bus()
    policy = rz.AnomalyPolicy(max_consecutive=3, telemetry=bus)
    policy.observe(True, 1, grad_norm=float("nan"),
                   top_leaves=[("fnet/conv1/kernel", None)])
    policy.observe(True, 2)
    policy.observe(False, 3)  # the streak broken: the counter resets
    policy.observe(True, 4)
    policy.observe(True, 5)
    with pytest.raises(rz.AnomalyHalt):
        policy.observe(True, 6)
    kinds = [e["event"] + ":" + e["kind"] for e in bus.events]
    assert kinds.count("anomaly:nonfinite_grad") == 5
    assert kinds[-1] == "anomaly:halt" and policy.total == 5
    assert bus.events[0]["top_leaves"] == [["fnet/conv1/kernel", None]]
    never = rz.AnomalyPolicy(max_consecutive=0)
    for step in range(1, 50):
        never.observe(True, step)
    assert never.total == 49


@pytest.mark.parametrize("case", ["finite", "nonfinite", "halt"])
def test_emergency_checkpoint(tmp_path, case):
    from raft_stereo_tpu_torch.training.trainer import _emergency_checkpoint
    cfg = TrainConfig(name="crashy", ckpt_dir=str(tmp_path))
    state = tiny_state()
    exc = RuntimeError("boom")
    if case == "nonfinite":
        with torch.no_grad():
            state.model.bias[0] = float("inf")
    elif case == "halt":
        exc = rz.AnomalyHalt("poisoned")
    bus = _Bus()
    path = _emergency_checkpoint(exc, state, cfg, bus, 17, "dig")
    if case == "finite":
        assert path is not None and path.endswith("17_crashy")
        assert bus.events[-1]["event"] == "checkpoint"
        assert bus.events[-1]["reason"] == "crash"
        ok, reason, manifest = rz.verify_checkpoint(path,
                                                    config_digest="dig")
        assert ok and manifest["reason"] == "crash", reason
        assert rz.find_latest_valid(str(tmp_path), "crashy",
                                    config_digest="dig")[0] == path
        return
    assert path is None and not os.listdir(tmp_path)  # not even a temp
    assert bus.events == ([] if case == "halt" else [
        {"event": "anomaly", "kind": "nonfinite_state", "step": 17}])


# --- trainer parity ----------------------------------------------------------

def _write_tree(root):
    from chip_smoke import write_sceneflow_tree
    write_sceneflow_tree(str(root), 4, 64, 96, 5, max_disp=8)


def _losses(run_dir):
    events = read_events(os.path.join(run_dir, "events.jsonl"))
    assert validate_events(events) == []
    return {e["step"]: e["loss"] for e in events if e["event"] == "step"}


@pytest.fixture(scope="module")
def parity(tmp_path_factory, drill):
    """One JAX train() and one port train() from the same .pth, and the
    NULL_RUNS JAX null runs through the JAX trainer's step function."""
    import raft_stereo_tpu.training.logger as jlogger
    from raft_stereo_tpu.data import native
    from raft_stereo_tpu.training import trainer as jtrainer
    from raft_stereo_tpu.training.state import TrainState as JState
    from raft_stereo_tpu.utils.checkpoint_convert import (
        convert_to_torch_state_dict)
    import raft_stereo_tpu_torch.training.logger as tlogger
    from raft_stereo_tpu_torch.training.trainer import train

    root = tmp_path_factory.mktemp("parity")
    _write_tree(root / "data")
    jcfg = JConfig(hidden_dims=SMALL)
    variables = jax_variables(jcfg, seed=5, image_shape=(1, H, W, 3))
    pth = str(root / "weights.pth")
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in
                convert_to_torch_state_dict(variables).items()}, pth)
    kw = dict(name="par", restore_ckpt=pth, batch_size=2, num_steps=3,
              image_size=(H, W), train_iters=1, valid_iters=1,
              data_root=str(root / "data"), validation_frequency=1000,
              num_workers=2, lr=1e-4, spatial_scale=(-0.2, 0.4),
              saturation_range=(0.0, 1.4), stall_deadline_s=None,
              data_parallel=1, ckpt_keep_last=0, heartbeat_every_s=0)

    captured = {}

    def capture(step_fn, state, placed, tel):
        captured["fn"] = step_fn

        def step(state, placed):
            captured.setdefault("batches", []).append(placed)
            out = step_fn(state, placed)
            captured["state"] = out[0]
            return out
        return step

    def make_pjit(model, tx, *args, **kwargs):
        captured["tx"] = tx
        return make_pjit_train_step(model, tx, *args, **kwargs)

    def shaped_init(rng, cfg, shape):
        from raft_stereo_tpu.models.raft_stereo import create_model
        return create_model(cfg), variables

    make_pjit_train_step = jtrainer.make_pjit_train_step
    mp = pytest.MonkeyPatch()
    try:
        # the JAX readers on their numpy path, as jax_readers_without_native
        # sets them for each test: this module-scoped fixture runs before
        # that function-scoped one, and another worker may rewrite the
        # native library in place while the JAX loader decodes
        mp.setattr(native, "_load", lambda: None)
        # no TensorBoard writers (importing one can import TensorFlow)
        mp.setattr(jlogger, "_make_writer", lambda log_dir: None)
        mp.setattr(jtrainer, "_compile_step_introspected", capture)
        mp.setattr(jtrainer, "make_pjit_train_step", make_pjit)
        mp.setattr(jtrainer, "init_model", shaped_init)
        jtrainer.train(jcfg, JTrainConfig(
            **kw, ckpt_dir=str(root / "jck"), run_dir=str(root / "jruns")))
    finally:
        mp.undo()

    def null_runs():
        # the JAX trainer's step on its own three batches, from perturbed
        # weights (the compiled step is reused: no second compile)
        from raft_stereo_tpu.parallel.mesh import make_mesh, replicated
        mesh = make_mesh(1, 1)
        with mesh:
            for i in range(NULL_RUNS):
                state = jax.device_put(JState.create(
                    dict(variables, params=perturbed(variables["params"],
                                                     40 + i)),
                    captured["tx"]), replicated(mesh))
                for placed in captured["batches"]:
                    state, _ = captured["fn"](state, placed)
                nulls.append(jax.tree_util.tree_map(np.asarray,
                                                    state.params))

    nulls = []
    thread = threading.Thread(target=null_runs, name="null-runs")
    thread.start()  # beside the port's run
    try:
        mp.setattr(tlogger, "_make_writer", lambda log_dir: None)
        final = train(port_config(jcfg), TrainConfig(
            **kw, ckpt_dir=str(root / "tck"), run_dir=str(root / "truns")),
            device="cpu")
    finally:
        mp.undo()
        thread.join()
    assert len(nulls) == NULL_RUNS
    return dict(
        jax_params=jax.tree_util.tree_map(np.asarray,
                                          captured["state"].params),
        nulls=nulls, port=load_payload(final)["model"], final_path=final,
        jax_losses=_losses(root / "jruns" / "par"),
        port_losses=_losses(root / "truns" / "par"))


def test_trainer_matches_jax(parity, record_property):
    jl, tl = parity["jax_losses"], parity["port_losses"]
    assert sorted(jl) == sorted(tl) == [1, 2, 3]
    loss_dev = max(abs(tl[s] - jl[s]) / abs(jl[s]) for s in jl)
    params = {k: v.numpy() for k, v in parity["port"].items()
              if not k.endswith(("running_mean", "running_var",
                                 "num_batches_tracked"))}
    ok, readings = null_gate(params, parity["jax_params"], parity["nulls"],
                             1e-5)
    record_property("loss_max_rel_dev", loss_dev)
    for key, value in readings.items():
        record_property(key, value)
    assert loss_dev <= LOSS_REL, (jl, tl)
    assert ok, readings


def test_entry_points_read_trainer_checkpoint(parity, tmp_path, capsys):
    """The port's train() ends in a checkpoint directory that the entry
    points read: load_weights gives the trained weights bitwise, the eval
    entry point evaluates them (the results of the validator run on those
    weights in process), and the demo's loader takes the path."""
    from raft_stereo_tpu_torch import demo, evaluate
    from raft_stereo_tpu_torch.eval.validate import validate_eth3d
    from raft_stereo_tpu_torch.inference import StereoPredictor
    from torch_parity import write_eth3d
    cfg = port_config(JConfig(hidden_dims=SMALL))
    final = parity["final_path"]
    state = evaluate.load_weights(final, cfg)
    assert state.keys() == parity["port"].keys()
    assert all(torch.equal(state[k], parity["port"][k]) for k in state)
    write_eth3d(tmp_path / "datasets", np.random.default_rng(4))
    ds = str(tmp_path / "datasets")
    evaluate.main(["--device", "cpu", "--dataset", "eth3d", "--data_root",
                   ds, "--valid_iters", "1", "--hidden_dims", "32", "32",
                   "32", "--restore_ckpt", final, "--stream", "off"])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    want = validate_eth3d(StereoPredictor(cfg, parity["port"],
                                          valid_iters=1, device="cpu"),
                          ds, 1, stream=False)
    assert printed == str(want)
    seen = []

    def stop_at_predictor(cfg, state, **kw):
        seen.append(state)
        raise SystemExit("loaded")

    mp = pytest.MonkeyPatch()
    mp.setattr(demo, "StereoPredictor", stop_at_predictor)
    try:
        with pytest.raises(SystemExit, match="loaded"):
            demo.main(["--restore_ckpt", final, "-l", "none", "-r", "none",
                       "--device", "cpu", "--hidden_dims", "32", "32", "32"])
    finally:
        mp.undo()
    assert all(torch.equal(seen[0][k], parity["port"][k]) for k in state)


# --- the drill ---------------------------------------------------------------

def _session_processes(sid):
    pids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[3]) == sid and fields[0] != "Z":
            pids.append(int(name))
    return pids


def _reap_session(sid, grace_s=5.0):
    """The processes left in session ``sid`` after ``grace_s``; then kill
    whatever is left."""
    deadline = time.monotonic() + grace_s
    left = _session_processes(sid)
    while left and time.monotonic() < deadline:
        time.sleep(0.1)
        left = _session_processes(sid)
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    return left


def _read_lenient(path):
    out = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # a SIGKILL can cut the last record
    except OSError:
        pass
    return out


class Drill:
    """The drill's legs, run from a background thread while the parity
    fixture computes (each child is a process of its own)."""

    def __init__(self, work):
        self.work = str(work)
        self.data = os.path.join(self.work, "data")
        _write_tree(self.data)
        shim = os.path.join(self.work, "shim")
        os.makedirs(shim)
        # the children's TensorBoard writer must not import TensorFlow
        with open(os.path.join(shim, "tensorflow.py"), "w") as f:
            f.write("raise ImportError('no TensorFlow for the drill')\n")
        self.env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO, shim]), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
            PYTHONUNBUFFERED="1")
        self.env.pop(rz.FAULT_NAN_STEP_ENV, None)
        self.results = {}
        self.error = None

    def cmd(self, name, leg, restore=None):
        cmd = [sys.executable, "-m", "raft_stereo_tpu_torch.train",
               "--device", "cpu", "--name", name,
               "--data_root", self.data,
               "--ckpt_dir", os.path.join(self.work, "ckpts", name),
               "--run_dir", os.path.join(self.work, "runs", leg),
               "--batch_size", "2", "--num_steps", str(DRILL_STEPS),
               "--image_size", str(H), str(W), "--train_iters", "1",
               "--valid_iters", "1", "--hidden_dims", "32", "32", "32",
               "--validation_frequency", "1000000",
               "--checkpoint_frequency", str(DRILL_CKPT_EVERY),
               "--ckpt_keep_last", "0", "--num_workers", "2",
               "--lr", "1e-4", "--stall_deadline_s", "0",
               "--heartbeat_every", "0"]
        return cmd + (["--restore_ckpt", restore] if restore else [])

    def start(self, name, leg, restore=None, env=None):
        log = open(os.path.join(self.work, f"{leg}.log"), "w")
        proc = subprocess.Popen(
            self.cmd(name, leg, restore), cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT, env=dict(self.env, **(env or {})),
            start_new_session=True)
        log.close()
        return proc

    def events(self, name, leg):
        return _read_lenient(os.path.join(self.work, "runs", leg, name,
                                          "events.jsonl"))

    def kill_after(self, proc, name, leg, step, sig, checkpoints=0):
        """Signal ``proc`` once its stream shows a ``step`` record for
        ``step`` and ``checkpoints`` checkpoint records."""
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while time.monotonic() < deadline:
            ev = self.events(name, leg)
            if any(e.get("event") == "step" and e["step"] >= step
                   for e in ev) and sum(
                    e.get("event") == "checkpoint" for e in ev) \
                    >= checkpoints:
                proc.send_signal(sig)
                return
            if proc.poll() is not None:
                raise RuntimeError(f"{leg} exited before step {step}")
            time.sleep(0.05)
        raise RuntimeError(f"{leg}: no step {step} in time")

    def finish(self, proc, leg):
        rc = proc.wait(timeout=CHILD_TIMEOUT_S)
        left = _reap_session(proc.pid)
        self.results[leg] = dict(rc=rc, left=left)
        return rc

    def run(self):
        try:
            oracle = self.start("oracle", "oracle")
            term = self.start("sigterm", "sigterm-1")
            kill = self.start("sigkill", "sigkill-1")
            corrupt = self.start("corrupt", "corrupt-1")
            nan = self.start("nan", "nan", env={rz.FAULT_NAN_STEP_ENV: "3"})
            self.kill_after(term, "sigterm", "sigterm-1", 3, signal.SIGTERM)
            self.kill_after(kill, "sigkill", "sigkill-1", 3, signal.SIGKILL,
                            checkpoints=1)
            self.kill_after(corrupt, "corrupt", "corrupt-1", 4,
                            signal.SIGKILL, checkpoints=2)
            for proc, leg in ((oracle, "oracle"), (term, "sigterm-1"),
                              (kill, "sigkill-1"), (corrupt, "corrupt-1"),
                              (nan, "nan")):
                self.finish(proc, leg)
            ckpts = os.path.join(self.work, "ckpts", "corrupt")
            steps = sorted(int(m.group(1)) for m in
                           (re.match(r"^(\d+)_corrupt$", e)
                            for e in os.listdir(ckpts)) if m)
            newest = os.path.join(ckpts, f"{steps[-1]}_corrupt")
            self.results["corrupted"] = (newest, steps[-1])
            victim = os.path.join(newest, "state", rz.STATE_FILE)
            with open(victim, "r+b") as f:
                f.truncate(os.path.getsize(victim) // 2)
            resumes = [(self.start(n, f"{n}-2", restore="auto"), f"{n}-2")
                       for n in ("sigterm", "sigkill", "corrupt")]
            for proc, leg in resumes:
                self.finish(proc, leg)
        except BaseException as e:  # reported by the test
            self.error = e


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    d = Drill(tmp_path_factory.mktemp("drill"))
    thread = threading.Thread(target=d.run, name="drill", daemon=True)
    thread.start()
    yield d, thread
    thread.join(timeout=CHILD_TIMEOUT_S)


def _final(d, name):
    return load_payload(os.path.join(d.work, "ckpts", name, name))["model"]


def test_drill_legs_resume_bitwise(drill, parity):
    d, thread = drill
    thread.join(timeout=CHILD_TIMEOUT_S)
    assert not thread.is_alive(), "the drill did not finish"
    assert d.error is None, repr(d.error)
    logs = {leg: open(os.path.join(d.work, f"{leg}.log")).read()[-2000:]
            for leg in d.results if isinstance(d.results[leg], dict)}
    for leg in ("oracle", "sigterm-1", "nan", "sigterm-2", "sigkill-2",
                "corrupt-2"):
        assert d.results[leg]["rc"] == 0, (leg, logs[leg])
        assert d.results[leg]["left"] == [], leg  # nothing outlived it
    for leg in ("sigkill-1", "corrupt-1"):
        assert d.results[leg]["rc"] == -signal.SIGKILL, leg
    oracle = _final(d, "oracle")
    want = {e["step"]: e["loss"] for e in d.events("oracle", "oracle")
            if e.get("event") == "step"}
    assert sorted(want) == list(range(1, DRILL_STEPS + 1))
    for name in ("sigterm", "sigkill", "corrupt"):
        got = _final(d, name)
        assert got.keys() == oracle.keys()
        assert all(torch.equal(got[k], oracle[k]) for k in oracle), name
        first, second = d.events(name, f"{name}-1"), d.events(name,
                                                              f"{name}-2")
        losses = {}
        for ev in (first, second):
            losses.update({e["step"]: e["loss"] for e in ev
                           if e.get("event") == "step"})
        assert losses == want, name
        resume = [e for e in second if e.get("event") == "resume"]
        assert len(resume) == 1, name
        if name == "sigterm":
            assert any(e.get("event") == "preempt" for e in first)
            preempt = [e for e in first if e.get("event") == "checkpoint"
                       and e.get("reason") == "preempt"]
            assert len(preempt) == 1
            assert resume[0]["step"] == preempt[0]["step"]
        if name == "corrupt":
            newest, step = d.results["corrupted"]
            bad = [e for e in second if e.get("event") == "ckpt_integrity"
                   and not e["ok"]]
            assert [e["path"] for e in bad] == [newest]
            assert resume[0]["step"] == step - DRILL_CKPT_EVERY
    nan = d.events("nan", "nan")
    skipped = {e["step"]: e["skipped_updates"] for e in nan
               if e.get("event") == "step"}
    assert skipped[3] == 1.0 and sum(skipped.values()) == 1.0
    assert any(e.get("event") == "anomaly" and e.get("kind") ==
               "nonfinite_grad" and e["step"] == 3 for e in nan)
    assert rz.state_is_finite(_final(d, "nan"))
