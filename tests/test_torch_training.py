"""The PyTorch port's training step held to the JAX package's on the CPU.

Loss, schedule and optimizer are compared on seeded numpy inputs; the
train-mode forward, the whole step's gradients and two whole steps on a
small model (hidden dims 32, 2 iterations, ``reg_pallas`` on both sides,
where the JAX model reaches its Pallas lookup, forward and backward, in
interpret mode) on bridged weights, in fp32. Each test records its
measured deviation as a junit property. Bounds, with what these inputs
measured when the bound was set:

* loss and metrics: 1e-6 relative (measured <= 2.2e-7);
* schedule: 1e-6 relative at every step of a 300-step horizon (measured
  0: both evaluate optax's linear pieces in fp32);
* optimizer (clip + AdamW + OneCycle, and under ``optax.MultiSteps``), at
  the recipe's LR: 1e-6 relative L2 per leaf on the parameters after each
  update (measured <= 6.9e-8), 1e-4 on the updates themselves (measured
  <= 3.4e-5: optax takes AdamW's bias corrections in fp32, where
  ``1 - 0.999**t`` cancels to 1.3e-5 relative at t = 1; torch in fp64);
* train-mode forward: 1e-3 px on every iteration's prediction, the
  test-mode forward's bound (measured 2.3e-5 px);
* whole-step gradients and parameters after two steps: the null-floor
  rule (PARITY.md's ``floor_gate``: the port's deviation from JAX within
  JAX's own deviation under a perturbation), over NULL_RUNS = 8 null runs,
  each JAX against JAX with every weight scaled by ``1 + 1e-6 N(0, 1)``,
  a perturbation of the size that separates the two frameworks'
  forwards (a few ReLUs and L1 signs flip; whole-leaf gradients move by
  up to 1e-3 relative). All leaves together: within the largest null
  run's deviation. Leaf by leaf (``chip_smoke.null_floor_gate``): a
  run's score is its worst ratio of a leaf's deviation to max(1e-4, or
  1e-5 for parameters, that leaf's largest null deviation); the port
  passes when no null run, scored against the others, is less unusual
  than it. A fixed factor does not fit: per leaf the null deviation is
  heavy-tailed (null scores up to 2.2 for gradients, 8.4 for
  parameters). Gradient leaves whose JAX norm is below ROUNDOFF_REL of
  the global norm (biases that an instance norm cancels, 1e-11 to 1e-8
  of it: round-off of sums that cancel, 100% apart in every null run)
  count only in the aggregate. Measured: all gradients together 1.8e-4
  against null runs of 2.2e-4 to 5.0e-4, leaf score 1.006 against null
  scores 0.76 to 2.25; parameters after two steps 3.29e-5 against
  2.65e-5 to 4.01e-5, leaf score 1.15 against 1.02 to 8.40; the loss
  bitwise equal.
"""

import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_stereo_tpu.config import RAFTStereoConfig as JConfig
from raft_stereo_tpu.config import TrainConfig as JTrainConfig
from raft_stereo_tpu.config import middlebury_finetune_config as j_middlebury
from raft_stereo_tpu.config import realtime_config as j_realtime
from raft_stereo_tpu.config import rvc_config as j_rvc
from raft_stereo_tpu.config import sceneflow_config as j_sceneflow
from raft_stereo_tpu.models.raft_stereo import create_model
from raft_stereo_tpu.training import loss as jloss
from raft_stereo_tpu.training import optim as joptim
from raft_stereo_tpu.training.state import TrainState as JTrainState
from raft_stereo_tpu.training.state import make_train_step as j_make_step

from raft_stereo_tpu_torch import config as tconfig
from raft_stereo_tpu_torch.models import RAFTStereo
from raft_stereo_tpu_torch.training import loss as tloss
from raft_stereo_tpu_torch.training import optim as toptim
from raft_stereo_tpu_torch.training.state import (TrainState, loss_and_grads,
                                                  make_train_step)
from raft_stereo_tpu_torch.utils.weights import (jax_leaf_names,
                                                 state_dict_from_jax)

from torch_parity import (flat, jax_variables, max_abs, null_gate, perturbed,
                          port_config, rel_l2)

SMALL = (32, 32, 32)
B, H, W = 2, 64, 128
ITERS = 2
# a short horizon: the LR warms up in one update, then anneals
NUM_STEPS = 100
# JAX-vs-JAX null runs the port is held to (see the module docstring)
NULL_RUNS = 8
# gradient leaves below this fraction of the global norm are round-off
ROUNDOFF_REL = 1e-7


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _batch(seed, nan=False):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    right = np.roll(left, -5, axis=2)
    right = np.clip(right + rng.normal(0, 4, right.shape), 0, 255).astype(
        np.float32)
    flow = -rng.uniform(0, 12, (B, H, W, 1)).astype(np.float32)
    valid = (rng.uniform(size=(B, H, W)) > 0.1).astype(np.float32)
    if nan:
        left[0, 3, 5, 0] = np.nan
    return dict(image1=left, image2=right, flow=flow, valid=valid)


def _port_model(jcfg, variables, **overrides):
    model = RAFTStereo(dataclasses.replace(port_config(jcfg), **overrides))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _named_grads(model, grads):
    return dict(zip([n for n, _ in model.named_parameters()], grads))


# ------------------------------------------------------------------ config


def test_train_config_and_sceneflow_preset_match_jax():
    jm, jt = j_sceneflow()
    tm, tt = tconfig.sceneflow_config()
    assert tm == port_config(jm)
    for f in dataclasses.fields(tconfig.TrainConfig):
        assert getattr(tt, f.name) == getattr(jt, f.name), f.name
        assert (getattr(tconfig.TrainConfig(), f.name)
                == getattr(JTrainConfig(), f.name)), f.name
    assert tconfig.RAFTStereoConfig().remat_refinement is JConfig(
    ).remat_refinement is True
    # a JAX knob the port lacks may only sit at its default
    for field, value in [("remat_encoders", "blocks"), ("scan_unroll", 2),
                         ("refinement_save_policy", "corr"),
                         ("batched_scan_wgrad", True),
                         ("residual_dtype", "bfloat16"),
                         ("deferred_upsample", False)]:
        with pytest.raises(ValueError, match="not ported"):
            port_config(JConfig(**{field: value}))
    assert port_config(JConfig(fused_lookup=True)).fused_lookup is True
    with pytest.raises(ValueError, match="grad_accum_steps"):
        tconfig.TrainConfig(grad_accum_steps=0)
    # every field of the JAX TrainConfig, the augmentation of both presets
    assert ({f.name for f in dataclasses.fields(tconfig.TrainConfig)}
            == {f.name for f in dataclasses.fields(JTrainConfig)})
    assert tt.spatial_scale == (-0.2, 0.4)
    assert tt.saturation_range == (0.0, 1.4)
    jm2, jt2 = j_middlebury()
    tm2, tt2 = tconfig.middlebury_finetune_config()
    assert tm2 == port_config(jm2)
    for f in dataclasses.fields(tconfig.TrainConfig):
        assert getattr(tt2, f.name) == getattr(jt2, f.name), f.name
    # one device: 0 and 1 accepted, more refused naming the queue item
    for ok in (0, 1):
        tconfig.TrainConfig(data_parallel=ok)
    with pytest.raises(ValueError, match="A10c"):
        tconfig.TrainConfig(data_parallel=2)
    with pytest.raises(ValueError, match="A13"):
        tconfig.TrainConfig(seq_parallel=2)


@pytest.mark.parametrize("preset", ["default", "realtime", "rvc"])
def test_jax_leaf_names_follow_the_jax_tree(preset):
    jcfg = {"default": JConfig, "realtime": j_realtime, "rvc": j_rvc}[
        preset]()
    v = jax_variables(jcfg, seed=1)
    want = [tuple(p.key for p in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(v["params"])[0]]
    got = jax_leaf_names(RAFTStereo(port_config(jcfg)))
    assert [path for _, path in got] == want
    # and each name is the leaf the weight bridge puts there
    sd = state_dict_from_jax(v)
    leaves = jax.tree_util.tree_leaves(v["params"])
    for (name, _), leaf in zip(got, leaves):
        assert sd[name].numel() == np.asarray(leaf).size, name


# -------------------------------------------------------------------- loss


@pytest.mark.parametrize("case", ["clean", "inf_and_invalid", "one_iter"])
def test_sequence_loss_matches_jax(case, record_property):
    rng = np.random.default_rng(3)
    n = 1 if case == "one_iter" else 5
    preds = rng.normal(0, 6, (n, 2, 12, 20, 1)).astype(np.float32)
    gt = rng.normal(0, 6, (2, 12, 20, 1)).astype(np.float32)
    valid = np.ones((2, 12, 20), np.float32)
    if case == "inf_and_invalid":
        gt[0, 1, 2, 0] = np.inf        # zero depth: infinite disparity
        gt[1, 3, 4, 0] = -800.0        # beyond max_flow
        valid[0, 5:8] = 0.0
        valid[1, 0, 0] = 0.4
    want_loss, want_m = jloss.sequence_loss(
        jnp.asarray(preds), jnp.asarray(gt), jnp.asarray(valid))
    got_loss, got_m = tloss.sequence_loss(_t(preds), _t(gt), _t(valid))
    devs = [abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))]
    for k in ("epe", "1px", "3px", "5px"):
        devs.append(abs(float(got_m[k]) - float(want_m[k]))
                    / max(abs(float(want_m[k])), 1e-30))
    record_property("max_rel_dev", max(devs))
    assert np.isfinite(float(got_loss))
    assert max(devs) <= 1e-6
    np.testing.assert_array_equal(
        tloss.loss_mask(_t(gt), _t(valid)).numpy(),
        np.asarray(jloss.loss_mask(jnp.asarray(gt), jnp.asarray(valid))))


# -------------------------------------------------------- schedule, optimizer


@pytest.mark.parametrize("num_steps,accum", [(200, 1), (390, 2), (2, 1)])
def test_schedule_matches_jax(num_steps, accum, record_property):
    jcfg = JTrainConfig(num_steps=num_steps, grad_accum_steps=accum)
    tcfg = tconfig.TrainConfig(num_steps=num_steps, grad_accum_steps=accum)
    counts = np.arange(300)
    want = np.asarray(joptim.fetch_schedule(jcfg)(jnp.asarray(counts)),
                      np.float64)
    got = np.array([toptim.fetch_schedule(tcfg)(int(c)) for c in counts])
    dev = float(np.max(np.abs(got - want) / np.abs(want)))
    record_property("max_rel_dev", dev)
    assert dev <= 1e-6
    peak = toptim.one_cycle_lr(1e-3, 1000)
    # fp32 round-off only
    assert peak(0) == pytest.approx(1e-3 / 25, rel=1e-5)
    assert peak(9) == pytest.approx(1e-3, rel=1e-6)


def _leaves(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(0, 0.1, (4, 3, 3, 5)).astype(np.float32),
            "b": rng.normal(0, 0.1, (5,)).astype(np.float32),
            "c": rng.normal(0, 0.1, (7, 2)).astype(np.float32)}


def _grad_stream(n, seed):
    """Gradients with global norms around 0.3 and 3 (the clip's two
    branches) and one at 30."""
    rng = np.random.default_rng(seed)
    scales = [0.05, 0.5, 5.0, 0.05][:n] + [0.5] * max(n - 4, 0)
    return [{k: (rng.normal(0, s, v.shape)).astype(np.float32)
             for k, v in _leaves(0).items()} for s in scales]


@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_matches_optax(accum, record_property):
    """``accum=1``: clip + AdamW + OneCycle (fetch_optimizer); ``accum=2``:
    the same under optax.MultiSteps."""
    cfg = dict(num_steps=20, grad_accum_steps=accum)  # the recipe's LR
    tx = joptim.fetch_optimizer(JTrainConfig(**cfg))
    jparams = {k: jnp.asarray(v) for k, v in _leaves(0).items()}
    jstate = tx.init(jparams)
    tparams = [torch.nn.Parameter(_t(v)) for v in _leaves(0).values()]
    opt = toptim.fetch_optimizer(tconfig.TrainConfig(**cfg), tparams)
    stream = _grad_stream(4 if accum == 1 else 6, seed=1)
    norms = [float(optax.global_norm(g)) for g in stream]
    assert min(norms) < 1.0 < max(norms)  # both branches of the clip
    devs, upd_devs = [], []
    for i, g in enumerate(stream):
        before = [p.detach().clone() for p in tparams]
        jbefore = dict(jparams)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied = opt.step([_t(v) for v in g.values()])
        assert applied == ((i + 1) % accum == 0)
        assert opt.count == (i + 1) // accum
        for p, p0, k in zip(tparams, before, jparams):
            if not applied:  # a micro-step leaves the parameters alone
                assert torch.equal(p, p0)
            devs.append(rel_l2(p.detach().numpy(), jparams[k]))
            if applied:
                upd_devs.append(rel_l2((p - p0).detach().numpy(),
                                       jparams[k] - jbefore[k]))
    record_property("max_rel_l2_params", max(devs))
    record_property("max_rel_l2_updates", max(upd_devs))
    assert max(devs) <= 1e-6
    assert max(upd_devs) <= 1e-4


# ----------------------------------------------------- model and whole step


@pytest.fixture(scope="module")
def small():
    jcfg = JConfig(hidden_dims=SMALL, corr_implementation="reg_pallas")
    return jcfg, jax_variables(jcfg, seed=21, image_shape=(B, H, W, 3))


@pytest.fixture(scope="module")
def jax_grads(small):
    """JAX's loss and gradients on one batch, and the gradients of the
    NULL_RUNS null runs."""
    jcfg, v = small
    model = create_model(jcfg)
    batch = _batch(22)

    def loss_fn(params):
        preds = model.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            batch["image1"], batch["image2"], iters=ITERS)
        return jloss.sequence_loss(preds, batch["flow"], batch["valid"])

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    (loss, _), grads = fn(v["params"])
    nulls = [to_np(fn(perturbed(v["params"], 31 + i))[1])
             for i in range(NULL_RUNS)]
    return batch, float(loss), to_np(grads), nulls


def test_train_forward_matches_jax(small, record_property):
    jcfg, v = small
    batch = _batch(23)
    model = create_model(jcfg)
    want = np.asarray(jax.jit(lambda var, a, b: model.apply(
        var, a, b, iters=ITERS))(v, batch["image1"], batch["image2"]))
    with torch.no_grad():
        got = _port_model(jcfg, v)(_t(batch["image1"]), _t(batch["image2"]),
                                   iters=ITERS, test_mode=False).numpy()
    assert got.shape == want.shape == (ITERS, B, H, W, 1)
    record_property("max_abs_px", max_abs(got, want))
    record_property("max_abs_flow_px", float(np.abs(want).max()))
    assert max_abs(got, want) <= 1e-3
    assert np.abs(want[-1] - want[0]).max() > 0.1  # the iterations differ


def test_step_gradients_match_jax(small, jax_grads, record_property):
    jcfg, v = small
    batch, want_loss, want, null_grads = jax_grads
    model = _port_model(jcfg, v)
    before = windowed_sample_launches()
    loss, _, grads = loss_and_grads(model, batch, ITERS)
    assert windowed_sample_launches() == before  # CPU: the plain versions
    named = {k: g.numpy() for k, g in _named_grads(model, grads).items()}
    want_sd = state_dict_from_jax({"params": want})
    norm = float(np.linalg.norm(flat(want_sd, named)))
    roundoff = {k for k in named
                if np.linalg.norm(want_sd[k].numpy()) < ROUNDOFF_REL * norm}
    ok, readings = null_gate(named, want, null_grads, 1e-4, roundoff)
    record_property("loss_rel_dev", abs(float(loss) - want_loss) / want_loss)
    for key, value in readings.items():
        record_property(key, value)
    assert abs(float(loss) - want_loss) <= 1e-6 * want_loss
    assert ok, readings
    # every leaf gets a gradient, the lookup's volume path included
    assert all(float(g.abs().max()) > 0 for g in grads)


def windowed_sample_launches():
    from raft_stereo_tpu_torch.ops.kernels.windowed_sample import (
        windowed_sample)
    return windowed_sample.launches, windowed_sample.bwd_launches


def test_two_steps_match_jax_step(small, record_property):
    jcfg, v = small
    batches = [_batch(24), _batch(25)]
    tx = joptim.fetch_optimizer(JTrainConfig(num_steps=NUM_STEPS))
    jstep = jax.jit(j_make_step(create_model(jcfg), tx, ITERS,
                                numerics=True))

    def jax_run(params):
        state = JTrainState.create(dict(v, params=params), tx)
        metrics = []
        for batch in batches:
            state, m = jstep(state, batch)
            metrics.append(m)
        return state, metrics
    jstate, jms = jax_run(v["params"])
    null_params = [jax_run(perturbed(v["params"], 32 + i))[0].params
                   for i in range(NULL_RUNS)]
    model = _port_model(jcfg, v)
    opt = toptim.fetch_optimizer(tconfig.TrainConfig(num_steps=NUM_STEPS),
                                 model.parameters())
    state = TrainState(model, opt)
    step = make_train_step(model, opt, ITERS, numerics=True)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    metric_devs = []
    for batch, jm in zip(batches, jms):
        state, m = step(state, batch)
        for k in ("loss", "epe", "grad_norm"):
            metric_devs.append(abs(float(m[k]) - float(jm[k]))
                               / abs(float(jm[k])))
        metric_devs.append(rel_l2(m["leaf_grad_norms"].numpy(),
                                  jm["leaf_grad_norms"]))
        assert float(m["skipped_updates"]) == float(jm["skipped_updates"]) \
            == 0.0
    assert state.step == int(jstate.step) == 2 and opt.count == 2
    params = {k: p.detach().numpy() for k, p in model.named_parameters()}
    ok, readings = null_gate(params, jstate.params, null_params, 1e-5)
    record_property("max_rel_dev_metrics", max(metric_devs))
    for key, value in readings.items():
        record_property(key, value)
    assert max(metric_devs) <= 1e-3
    assert ok, readings
    assert min(float(np.abs(p - start[k].numpy()).max())
               for k, p in params.items()) > 0  # every leaf moved


def test_remat_refinement_is_bitwise_neutral(small, record_property):
    # bound: bitwise (the recomputation runs the same CPU ops)
    jcfg, v = small
    batch = _batch(26)
    out = []
    for remat in (True, False):
        model = _port_model(jcfg, v, remat_refinement=remat)
        loss, _, grads = loss_and_grads(model, batch, ITERS)
        out.append((loss, grads))
    record_property("max_abs_grad_diff", max(
        float((a - b).abs().max()) for a, b in zip(out[0][1], out[1][1])))
    assert torch.equal(out[0][0], out[1][0])
    for g_on, g_off in zip(out[0][1], out[1][1]):
        assert torch.equal(g_on, g_off)


def test_nan_batch_is_skipped(small):
    jcfg, v = small
    model = _port_model(jcfg, v)
    opt = toptim.fetch_optimizer(tconfig.TrainConfig(num_steps=NUM_STEPS),
                                 model.parameters())
    state = TrainState(model, opt)
    step = make_train_step(model, opt, ITERS)
    state, m = step(state, _batch(27))
    assert float(m["skipped_updates"]) == 0.0 and opt.count == 1

    def snapshot():
        out = [p.detach().clone() for p in model.parameters()]
        for p in model.parameters():
            s = opt.adamw.state[p]
            out += [s["exp_avg"].clone(), s["exp_avg_sq"].clone(),
                    torch.as_tensor(s["step"]).clone()]
        return out

    before, lr = snapshot(), opt.lr
    state, m = step(state, _batch(28, nan=True))
    assert not np.isfinite(float(m["loss"]))
    assert float(m["skipped_updates"]) == 1.0
    assert state.step == 2 and opt.count == 1 and opt.lr == lr
    assert all(torch.equal(a, b) for a, b in zip(before, snapshot()))
    state, m = step(state, _batch(29))  # and training goes on
    assert float(m["skipped_updates"]) == 0.0 and opt.count == 2


def test_step_refusals(small):
    jcfg, v = small
    model = _port_model(jcfg, v)
    opt = toptim.fetch_optimizer(tconfig.TrainConfig(), model.parameters())
    with pytest.raises(NotImplementedError, match="A10"):
        make_train_step(model, opt, ITERS, axis_name="data")
    with pytest.raises(NotImplementedError, match="fused_loss"):
        make_train_step(model, opt, ITERS, fused_loss=True)
    other = toptim.fetch_optimizer(tconfig.TrainConfig(),
                                   list(model.parameters())[::-1])
    with pytest.raises(ValueError, match="parameters"):
        make_train_step(model, other, ITERS)
