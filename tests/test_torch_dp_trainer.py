"""Data-parallel training through the port's trainer and entry point
(``data/loader.py``'s rank slices, ``training/trainer.py`` as one rank,
``python -m raft_stereo_tpu_torch.train --data_parallel N``), on the CPU.

* Loader: each rank's slices of the global batches concatenate bitwise
  to the one-process batches, through an epoch boundary and a mid-epoch
  ``start_batch`` resume.
* Three legs run as subprocesses (torch on one thread, gloo), the first
  two at once: A, the entry point with ``--data_parallel 2 --device cpu``
  for 4 steps with a checkpoint every 2, to its final checkpoint; C, two
  ranks started as torchrun starts them (``RANK``/``WORLD_SIZE``/...),
  SIGTERM sent to rank 1 alone after its step-2 record; then B, the entry
  point restored from A's step-2 checkpoint. B ends bitwise at A's final
  state (parameters, AdamW moments, count, step) with A's per-step
  losses; C's ranks both exit 0 after the same step, with one preempt
  checkpoint written by rank 0 alone; every rank's events.jsonl passes
  the port's ``validate_events`` and carries its mesh coordinates; no
  process is left behind.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from raft_stereo_tpu_torch.data.loader import Loader, infinite_batches
from raft_stereo_tpu_torch.obs import read_events, validate_events
from raft_stereo_tpu_torch.parallel.distributed import free_port
from raft_stereo_tpu_torch.training import resilience as rz
from raft_stereo_tpu_torch.training.checkpoint import load_payload

from loader_stub import ArrayDataset
from test_torch_trainer import _reap_session, _read_lenient, _write_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4
CKPT_EVERY = 2
TERM_STEPS = 8
TERM_AFTER = 2
TIMEOUT_S = 240


def test_rank_slices_concatenate_to_the_global_stream():
    ds = ArrayDataset(n=10)
    whole = Loader(ds, batch_size=4, seed=3, num_workers=1)
    ranks = [Loader(ds, batch_size=4, seed=3, num_workers=1,
                    process_slice=slice(r * 2, r * 2 + 2)) for r in (0, 1)]
    try:
        assert len(whole) == len(ranks[0]) == 2

        def take(loader, n):
            it = infinite_batches(loader)
            out = [next(it) for _ in range(n)]
            it.close()
            return out
        want = take(whole, 5)  # over two epoch boundaries
        got = [take(r, 5) for r in ranks]
        for b in range(5):
            for k in want[b]:
                assert got[0][b][k].shape[0] == got[1][b][k].shape[0] == 2
                cat = np.concatenate([got[0][b][k], got[1][b][k]])
                assert np.array_equal(cat, want[b][k]), (b, k)
        # a resume at epoch 1, batch 1
        for r in ranks:
            r.epoch, r.start_batch = 1, 1
        resumed = [next(iter(r)) for r in ranks]
        for k in want[3]:
            assert np.array_equal(np.concatenate([x[k] for x in resumed]),
                                  want[3][k]), k
    finally:
        for loader in [whole] + ranks:
            loader.close()


class Legs:
    """The subprocess legs."""

    def __init__(self, work):
        self.work = str(work)
        self.data = os.path.join(self.work, "data")
        _write_tree(self.data)
        shim = os.path.join(self.work, "shim")
        os.makedirs(shim)
        with open(os.path.join(shim, "tensorflow.py"), "w") as f:
            f.write("raise ImportError('no TensorFlow for the legs')\n")
        self.env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO, shim]), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
            PYTHONUNBUFFERED="1")
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                  "MASTER_ADDR", "MASTER_PORT", rz.FAULT_NAN_STEP_ENV,
                  rz.FAULT_SLEEP_ENV):
            self.env.pop(k, None)
        self.results = {}
        self.error = None

    def cmd(self, leg, steps, restore=None, dp=True):
        cmd = [sys.executable, "-m", "raft_stereo_tpu_torch.train",
               "--device", "cpu", "--name", "dp", "--data_root", self.data,
               "--ckpt_dir", os.path.join(self.work, "ckpts", leg),
               "--run_dir", os.path.join(self.work, "runs", leg),
               "--batch_size", "2", "--num_steps", str(steps),
               "--image_size", "48", "64", "--train_iters", "1",
               "--valid_iters", "1", "--hidden_dims", "32", "32", "32",
               "--validation_frequency", "1000000",
               "--checkpoint_frequency", str(CKPT_EVERY),
               "--ckpt_keep_last", "0", "--num_workers", "1",
               "--lr", "1e-4", "--stall_deadline_s", "0",
               "--heartbeat_every", "0"]
        if dp:
            cmd += ["--data_parallel", "2"]
        return cmd + (["--restore_ckpt", restore] if restore else [])

    def start(self, leg, cmd, env=None, log=None):
        with open(os.path.join(self.work, f"{log or leg}.log"), "w") as f:
            return subprocess.Popen(cmd, cwd=REPO, stdout=f,
                                    stderr=subprocess.STDOUT,
                                    env=dict(self.env, **(env or {})),
                                    start_new_session=True)

    def events(self, leg, rank):
        return _read_lenient(os.path.join(self.work, "runs", leg, "dp",
                                          f"rank{rank}", "events.jsonl"))

    def finish(self, name, proc):
        rc = proc.wait(timeout=TIMEOUT_S)
        self.results[name] = dict(rc=rc, left=_reap_session(proc.pid))

    def run(self):
        try:
            a = self.start("a", self.cmd("a", STEPS))
            port = str(free_port())
            term = []
            for r in (0, 1):
                env = dict(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                           LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=port,
                           **{rz.FAULT_SLEEP_ENV: "0.3"})
                term.append(self.start("c", self.cmd("c", TERM_STEPS,
                                                     dp=False),
                                       env=env, log=f"c{r}"))
            deadline = time.monotonic() + TIMEOUT_S
            while not any(e.get("event") == "step"
                          and e["step"] >= TERM_AFTER
                          for e in self.events("c", 1)):
                if time.monotonic() > deadline or term[1].poll() is not None:
                    raise RuntimeError("rank 1 of leg c gave no step record")
                time.sleep(0.05)
            term[1].send_signal(signal.SIGTERM)
            self.finish("a", a)
            for r, proc in enumerate(term):
                self.finish(f"c{r}", proc)
            b = self.start("b", self.cmd("b", STEPS, restore=os.path.join(
                self.work, "ckpts", "a", f"{CKPT_EVERY}_dp")))
            self.finish("b", b)
        except BaseException as e:  # reported by the test
            self.error = e


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    legs = Legs(tmp_path_factory.mktemp("dp_legs"))
    legs.run()
    assert legs.error is None, repr(legs.error)
    logs = {leg: open(os.path.join(legs.work, f"{leg}.log")).read()[-3000:]
            for leg in ("a", "b", "c0", "c1")}
    for leg in ("a", "b", "c0", "c1"):
        assert legs.results[leg]["rc"] == 0, (leg, logs[leg])
        assert legs.results[leg]["left"] == [], leg  # nothing outlived it
    return legs


def _rank_events(legs, leg):
    out = []
    for r in (0, 1):
        path = os.path.join(legs.work, "runs", leg, "dp", f"rank{r}",
                            "events.jsonl")
        events = read_events(path)
        assert validate_events(events) == [], (leg, r)
        assert all(e.get("coords") == [r, 0] for e in events), (leg, r)
        assert len({e["host_id"] for e in events}) == 1
        start = [e for e in events if e["event"] == "run_start"][0]
        assert start["config"]["parallel"] == {
            "data": 2, "seq": 1, "rank": r, "coords": [r, 0],
            "backend": "gloo"}
        out.append(events)
    return out


def _losses(events):
    return {e["step"]: e["loss"] for e in events if e["event"] == "step"}


def test_two_rank_entry_point_resumes_bitwise(legs):
    a, b = _rank_events(legs, "a"), _rank_events(legs, "b")
    ckpts = os.path.join(legs.work, "ckpts")
    assert sorted(os.listdir(os.path.join(ckpts, "a"))) == [
        "2_dp", "4_dp", "dp"]
    want, got = load_payload(os.path.join(ckpts, "a", "dp")), load_payload(
        os.path.join(ckpts, "b", "dp"))
    assert want["step"] == got["step"] == STEPS
    pa, pb = rz.state_payload(want), rz.state_payload(got)
    assert rz.tree_structure_hash(pa) == rz.tree_structure_hash(pb)
    assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for (_, x), (_, y) in zip(rz._leaves(pa), rz._leaves(pb)))
    # one loss a step, the same on both ranks; the resumed steps A's
    la = _losses(a[0])
    assert sorted(la) == list(range(1, STEPS + 1))
    assert _losses(a[1]) == la
    assert _losses(b[0]) == _losses(b[1]) == {
        s: la[s] for s in range(CKPT_EVERY + 1, STEPS + 1)}
    # the checkpoints are rank 0's: its records, none of rank 1's
    assert [e["step"] for e in a[0] if e["event"] == "checkpoint"] == [
        2, 4, 4]
    assert not [e for e in a[1] if e["event"] == "checkpoint"]
    assert all(e["batch_size"] == 2 for e in a[0] if e["event"] == "step")
    with open(os.path.join(legs.work, "a.log")) as f:
        assert f.read().strip().splitlines()[-1] == (
            f"final checkpoint: {os.path.join(ckpts, 'a', 'dp')}")


def test_sigterm_to_one_rank_stops_both_at_one_step(legs):
    c = _rank_events(legs, "c")
    stops = [[e["step"] for e in ev if e["event"] == "preempt"] for ev in c]
    assert len(stops[0]) == len(stops[1]) == 1 and stops[0] == stops[1]
    step = stops[0][0]
    assert TERM_AFTER < step < TERM_STEPS
    assert c[0][-1]["event"] == c[1][-1]["event"] == "run_end"
    assert c[0][-1]["step"] == c[1][-1]["step"] == step
    assert [e["signal"] for ev in c for e in ev
            if e["event"] == "preempt"] == ["a peer rank's signal",
                                            "SIGTERM"]
    ckpts = os.path.join(legs.work, "ckpts", "c")
    preempt = []
    for name in os.listdir(ckpts):
        with open(os.path.join(ckpts, name, rz.MANIFEST_NAME)) as f:
            if json.load(f)["reason"] == "preempt":
                preempt.append(name)
    assert preempt == [f"{step}_dp"]
    assert [e["step"] for e in c[0] if e["event"] == "checkpoint"
            and e.get("reason") == "preempt"] == [step]
