"""The port's data parallelism (``raft_stereo_tpu_torch/parallel``,
``training/{loss,state}.py``'s ``group``) on the CPU, against the JAX
package.

Two ranks joined by gloo run every rank-side check in one spawn
(``tests/dp_workers.py::parity_rank``, started once for the module and run
beside the JAX fixtures):

* the counterpart of tests/test_distributed.py: ``initialize`` a no-op
  alone, ``process_batch_slice`` as JAX's (and its error on an
  indivisible batch), and the ranks' placed slices gathered back equal to
  the global batch;
* ``sequence_loss`` under the 2-rank group on uneven valid masks against
  JAX's ``sequence_loss(axis_name=...)`` under ``shard_map`` on a 2-device
  CPU mesh (1e-6 relative), and each rank's gradient of it bitwise its
  slice of the one-process gradient (the global sums are constants of the
  forward: a differentiable all-reduce would double it after the
  gradients' all-reduce);
* the 2-rank step (hidden 32, ``reg``, 2 iterations, global batch 4 at
  32x64, 2 + 2): the reduced gradients against the port's one-process
  gradients of the concatenated batch and against JAX's single-device
  ``make_train_step`` gradients on the same batch and bridged weights,
  loss within 1e-5 relative, gradients under the null-floor rule of
  tests/test_torch_training.py (NULL_RUNS JAX runs with every weight
  scaled by 1 + 1e-6 N(0, 1)); two steps leave both replicas bitwise
  equal; a stop request on one rank reaches both;
* a 1-rank group bitwise equal to the step without one;
* the fused loss's grouped step (``fused_loss=True``), alone and over the
  batched-weight-gradient backward (``batched_scan_wgrad``, JAX's
  ``test_shardmap_dp_matches_single_device_custom``): the loss within
  1e-5 relative of JAX's single-device one, the reduced gradients under
  the same null-floor rule, both ranks' bitwise equal;
* ``seq_parallel > 1`` raises.
"""

import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from raft_stereo_tpu.config import RAFTStereoConfig as JConfig
from raft_stereo_tpu.models.raft_stereo import create_model
from raft_stereo_tpu.parallel.compat import shard_map
from raft_stereo_tpu.training import loss as jloss

from raft_stereo_tpu_torch.config import TrainConfig
from raft_stereo_tpu_torch.models import RAFTStereo
from raft_stereo_tpu_torch.parallel import data_parallel as dp
from raft_stereo_tpu_torch.parallel import distributed as pd
from raft_stereo_tpu_torch.parallel import mesh as pm
from raft_stereo_tpu_torch.training.loss import sequence_loss
from raft_stereo_tpu_torch.training.optim import fetch_optimizer
from raft_stereo_tpu_torch.training.state import make_train_step
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

from torch_parity import (flat, jax_variables, null_gate, perturbed,
                          port_config, rel_l2)

SMALL = (32, 32, 32)
B, H, W = 4, 32, 64
ITERS = 2
NULL_RUNS = 8
ROUNDOFF_REL = 1e-7
LR, NUM_STEPS = 1e-4, 100
LOSS_ITERS, LOSS_HW = 3, (8, 12)


def _batch(seed):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    right = np.clip(np.roll(left, -3, axis=2)
                    + rng.normal(0, 4, left.shape), 0, 255).astype(np.float32)
    flow = -rng.uniform(0, 8, (B, H, W, 1)).astype(np.float32)
    # uneven valid shares: rank 0's pairs 90% valid, rank 1's 30%
    keep = np.array([0.9, 0.9, 0.3, 0.3])[:, None, None]
    valid = (rng.uniform(size=(B, H, W)) < keep).astype(np.float32)
    return dict(image1=left, image2=right, flow=flow, valid=valid)


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    h, w = LOSS_HW
    preds = rng.normal(-4, 3, (LOSS_ITERS, B, h, w, 1)).astype(np.float32)
    gt = -rng.uniform(0, 10, (B, h, w, 1)).astype(np.float32)
    gt[1, 0, :3] = 800.0  # |gt| >= max_flow: out of the mask
    gt[3, 2, 1] = np.inf  # a non-finite ground truth where invalid
    keep = np.array([0.8, 0.8, 0.1, 0.1])[:, None, None]
    valid = (rng.uniform(size=(B, h, w)) < keep).astype(np.float32)
    valid[3, 2, 1] = 0.0
    return preds, gt, valid


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig(hidden_dims=SMALL, corr_implementation="reg")
    return jcfg, jax_variables(jcfg, seed=41, image_shape=(B, H, W, 3))


@pytest.fixture(scope="module")
def ranks(setup):
    """Two gloo ranks on the CPU, every rank-side check in one spawn,
    started in a thread so the JAX fixtures compute meanwhile."""
    from dp_workers import parity_rank
    jcfg, v = setup
    box = {}

    def run():
        try:
            box["out"] = pd.launch(
                parity_rank, ["cpu", "cpu"], port_config(jcfg),
                state_dict_from_jax(v), _batch(42), ITERS, _loss_inputs(43),
                LR, NUM_STEPS, timeout_s=300.0)
        except BaseException as e:  # reported by the tests
            box["error"] = e

    thread = threading.Thread(target=run, name="dp-ranks")
    thread.start()
    yield box, thread
    thread.join(timeout=300)


def _rank_results(ranks):
    box, thread = ranks
    thread.join(timeout=300)
    assert not thread.is_alive(), "the ranks did not finish"
    assert "error" not in box, repr(box.get("error"))
    return box["out"]


@pytest.fixture(scope="module")
def jax_grads(setup):
    """JAX's single-device loss and gradients on the whole batch, and the
    NULL_RUNS null runs' gradients."""
    jcfg, v = setup
    model = create_model(jcfg)
    batch = _batch(42)

    def loss_fn(params):
        preds = model.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            batch["image1"], batch["image2"], iters=ITERS)
        return jloss.sequence_loss(preds, batch["flow"], batch["valid"])

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    (loss, _), grads = fn(v["params"])
    nulls = [to_np(fn(perturbed(v["params"], 51 + i))[1])
             for i in range(NULL_RUNS)]
    return float(loss), to_np(grads), nulls


def test_initialize_alone_and_batch_slices(ranks):
    """tests/test_distributed.py's counterpart: alone, no group is made
    and the process loads the whole batch; two ranks load [0, 4) and
    [4, 8) of 8, [0, 2) and [2, 4) here, and their placed slices gather
    back to the global batch."""
    assert pd.initialize(num_processes=1, device="cpu") == torch.device(
        "cpu")
    assert not torch.distributed.is_initialized()
    assert pd.process_batch_slice(8) == slice(0, 8)
    mesh = pd.global_mesh(device="cpu")
    assert (mesh.data, mesh.seq, mesh.coords, mesh.group) == (1, 1, (0, 0),
                                                              None)
    batch = _batch(42)
    placed = pd.host_local_to_global(mesh, batch)
    assert all(np.array_equal(placed[k].numpy(), batch[k]) for k in batch)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pd.global_mesh(2)
    out = _rank_results(ranks)
    assert [r["slice"] for r in out] == [(0, 2), (2, 4)]
    assert [r["coords"] for r in out] == [(0, 0), (1, 0)]
    assert all(r["backend"] == "gloo" for r in out)
    assert all(r["gather_equal"] for r in out)
    assert all("not divisible by 2 processes" in r["indivisible"]
               for r in out)


def test_sequence_loss_group_matches_jax_shard_map(ranks, record_property):
    preds, gt, valid = _loss_inputs(43)
    mesh = JMesh(np.array(jax.devices()[:2]), ("data",))
    fn = jax.jit(shard_map(
        lambda p, g, m: jloss.sequence_loss(p, g, m, axis_name="data"),
        mesh=mesh, in_specs=(P(None, "data"), P("data"), P("data")),
        out_specs=(P(), P()), check_vma=False))
    jl, jm = fn(preds, gt, valid)
    want = dict({k: float(x) for k, x in jm.items()}, loss=float(jl))
    # the one-process loss and its gradient on the whole batch
    whole = torch.from_numpy(preds).requires_grad_(True)
    loss, _ = sequence_loss(whole, torch.from_numpy(gt),
                            torch.from_numpy(valid))
    loss.backward()
    out = _rank_results(ranks)
    devs = [abs(r["loss_fn"][k] - want[k]) / abs(want[k])
            for r in out for k in want]
    record_property("max_rel_dev", max(devs))
    assert max(devs) <= 1e-6, ([r["loss_fn"] for r in out], want)
    assert out[0]["loss_fn"] == out[1]["loss_fn"]  # every rank the same
    # each rank's gradient: its pixels once, over the global count
    got = np.concatenate([r["loss_fn_grad"] for r in out], axis=1)
    assert np.array_equal(got, whole.grad.numpy())


def test_dp_step_matches_one_process_and_jax(setup, ranks, jax_grads,
                                             record_property):
    jcfg, v = setup
    want_loss, want, nulls = jax_grads
    out = _rank_results(ranks)
    dp_grads, one_grads = out[0]["dp_grads"], out[1]["one_grads"]
    names = list(dp_grads)
    want_sd = state_dict_from_jax({"params": want})
    norm = float(np.linalg.norm(flat(want_sd, names)))
    roundoff = {k for k in names
                if np.linalg.norm(want_sd[k].numpy()) < ROUNDOFF_REL * norm}
    ok_dp, dp_read = null_gate(dp_grads, want, nulls, 1e-4, roundoff)
    ok_one, one_read = null_gate(one_grads, want, nulls, 1e-4, roundoff)
    dp_vs_one = rel_l2(flat(dp_grads, names), flat(one_grads, names))
    losses = [out[0]["dp_loss"], out[1]["dp_loss"],
              out[0]["steps"][0]["loss"]]
    loss_devs = [abs(x - ref) / abs(ref) for x in losses
                 for ref in (out[1]["one_loss"], want_loss)]
    record_property("loss_max_rel_dev", max(loss_devs))
    record_property("dp_vs_one_rel_l2", dp_vs_one)
    for key, value in dp_read.items():
        record_property(f"dp_{key}", value)
    assert max(loss_devs) <= 1e-5, (losses, out[1]["one_loss"], want_loss)
    assert ok_dp, dp_read
    assert ok_one, one_read
    assert dp_vs_one <= max(dp_read["rel_l2_all_null"]), dp_vs_one
    # the reduced gradients, the steps and the replicas agree bitwise
    assert out[0]["dp_grads_digest"] == out[1]["dp_grads_digest"]
    assert out[0]["steps"] == out[1]["steps"]
    assert out[0]["params_digest"] == out[1]["params_digest"]
    assert out[0]["moments_digest"] == out[1]["moments_digest"]
    assert all(s["skipped_updates"] == 0.0 for s in out[0]["steps"])
    # a stop asked on rank 1 alone reaches both; the flags sum
    assert all(s["stop"] for r in out for s in r["steps"])
    assert out[0]["flag_sum"] == out[1]["flag_sum"] == [1.0]


def test_one_rank_group_is_bitwise_the_plain_step(ranks):
    assert _rank_results(ranks)[0]["solo_bitwise"]


def test_backend_rule():
    assert pd.backend_for(["cpu", "cpu"]) == "gloo"
    assert pd.backend_for(["cuda:0", "cuda:0"]) == "gloo"  # a shared card
    assert pd.backend_for(["cuda:0", "cpu"]) == "gloo"
    assert pd.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert pd.backend_for(["cuda:0"]) == "nccl"
    # the CPU and an indexed card as given; "cuda" is the rank's own card,
    # which a machine without one refuses (no fallback to the CPU)
    assert pd.rank_device("cpu", 3) == torch.device("cpu")
    assert pd.rank_device("cuda:1", 0) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="not available"):
        pd.rank_device("cuda", 0)
    assert pm.resolve_data_parallel(0, "cpu") == 1
    assert pm.resolve_data_parallel(3, "cpu") == 3


def test_seq_parallel_and_fused_loss_raise(setup):
    jcfg, _ = setup
    cfg = port_config(jcfg)
    with pytest.raises(ValueError, match="A13"):
        TrainConfig(seq_parallel=2)
    with pytest.raises(ValueError, match="A13"):
        pm.make_mesh(1, 2)
    with pytest.raises(ValueError, match="A13"):
        dp.dryrun_train_step(2, seq_parallel=2, device="cpu")
    model = RAFTStereo(cfg)
    opt = fetch_optimizer(TrainConfig(), model.parameters())
    seq_mesh = pm.Mesh(data=1, seq=2, coords=(0, 0),
                       device=torch.device("cpu"))
    with pytest.raises(ValueError, match="A13"):
        dp.make_pjit_train_step(model, opt, ITERS, seq_mesh)
    mesh = pm.make_mesh(device="cpu")
    # the fused loss builds every step (its grouped run: the tests below)
    for fn in (make_train_step, dp.make_shardmap_train_step,
               dp.make_pjit_train_step):
        args = (model, opt, ITERS) + ((mesh,) if fn is not make_train_step
                                      else ())
        assert callable(fn(*args, fused_loss=True))
    with pytest.raises(ValueError, match="not divisible"):
        pm.batch_sharding(pm.Mesh(data=2, seq=1, coords=(1, 0),
                                  device=torch.device("cpu")), 3)
    # the pjit-style step runs the unfused lookup, as JAX forces it, on
    # the same parameters; the model itself keeps its config
    fused = RAFTStereo(dataclasses.replace(cfg, fused_lookup=True))
    unfused = dp.unfused_lookup(fused)
    assert fused.cfg.fused_lookup is True
    assert unfused.cfg.fused_lookup is False
    assert [id(p) for p in unfused.parameters()] == [
        id(p) for p in fused.parameters()]
    assert dp.unfused_lookup(model) is model


def _fused_dp_check(key, setup, ranks, jax_grads, record_property):
    jcfg, v = setup
    want_loss, want, nulls = jax_grads
    out = _rank_results(ranks)
    got = out[0][key + "_grads"]
    names = list(got)
    want_sd = state_dict_from_jax({"params": want})
    norm = float(np.linalg.norm(flat(want_sd, names)))
    roundoff = {k for k in names
                if np.linalg.norm(want_sd[k].numpy()) < ROUNDOFF_REL * norm}
    ok, read = null_gate(got, want, nulls, 1e-4, roundoff)
    losses = [r[key + "_loss"] for r in out]
    loss_dev = max(abs(x - want_loss) / abs(want_loss) for x in losses)
    record_property("loss_max_rel_dev", loss_dev)
    for k, value in read.items():
        record_property(k, value)
    assert loss_dev <= 1e-5, (losses, want_loss)
    assert losses[0] == losses[1]
    assert out[0][key + "_epe"] == out[1][key + "_epe"]
    assert ok, read
    assert out[0][key + "_grads_digest"] == out[1][key + "_grads_digest"]


def test_fused_loss_dp_matches_single_device(setup, ranks, jax_grads,
                                             record_property):
    """The fused loss's grouped step on 2 gloo ranks against JAX's
    single-device gradients of the same (stacked) loss."""
    _fused_dp_check("fused", setup, ranks, jax_grads, record_property)


def test_shardmap_dp_matches_single_device_custom(setup, ranks, jax_grads,
                                                  record_property):
    """JAX's tests/test_scan_grad.py counterpart: the grouped fused-loss
    step over the batched-weight-gradient backward against the
    single-device gradients, under the null floor."""
    _fused_dp_check("custom", setup, ranks, jax_grads, record_property)
