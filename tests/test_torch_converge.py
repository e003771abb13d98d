"""The port's convergence outputs and early exit (per-iteration EPE, the
adaptive refinement in both modes, the iteration policy, the predictor's
policy plumbing, the eval stream's ``converge`` records) against the JAX
package's, on bridged weights, hidden 32x3, 32x64 pairs, 4 iterations.

Bounds, with what these inputs measured when they were set:

* residual and EPE curves: 1e-4 px (measured 3.0e-7 and 3.1e-6);
  ``flow_up`` 1e-3 px (measured 5.0e-5);
* τ=0 adaptive is bitwise the port's own fixed loop (``torch.where`` with
  an all-true mask is exact). It is held to JAX's FIXED loop within
  1e-3 px, not to JAX's adaptive one: the JAX package's own bitwise τ=0
  pin fails in a lone process (XLA fuses the masked program otherwise);
* ``iters_taken`` equal to a NumPy oracle on the port's fixed curves and
  to JAX's at a τ placed midway between two recorded residuals, at least
  10x the port-JAX residual gap from every recorded value;
* ``while_loop`` bitwise ``masked_scan`` (flows, residual rows,
  ``iters_taken``);
* policy documents, digests, decision tables and lint errors equal to
  JAX's on the same records and doctored policies.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from raft_stereo_tpu.config import RAFTStereoConfig as JConfig
from raft_stereo_tpu.inference import StereoPredictor as JPredictor
from raft_stereo_tpu.models.raft_stereo import create_model
from raft_stereo_tpu.obs import converge as jcv
from raft_stereo_tpu.obs import read_events
from raft_stereo_tpu.obs.validate import check_iter_policy as j_check
from raft_stereo_tpu_torch.eval.stream import StreamConfig
from raft_stereo_tpu_torch.eval import validate as tval
from raft_stereo_tpu_torch.inference import StereoPredictor
from raft_stereo_tpu_torch.models import RAFTStereo
from raft_stereo_tpu_torch.obs import Telemetry
from raft_stereo_tpu_torch.obs import converge as tcv
from raft_stereo_tpu_torch.obs.validate import check_iter_policy
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

import torch_parity as tp
from torch_parity import (jax_readers_without_native,  # noqa: F401
                          torch_one_thread)

H, W = 32, 64
ITERS = 4
CURVE_TOL = 1e-4
FLOW_TOL_PX = 1e-3
JCFG = JConfig(hidden_dims=(32, 32, 32))


@pytest.fixture(scope="module")
def setup():
    variables = tp.jax_variables(JCFG, seed=11, image_shape=(1, H, W, 3))
    model = RAFTStereo(tp.port_config(JCFG))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.eval()
    rng = np.random.default_rng(12)
    # three pairs of different difficulty: shifted copies and noise
    left = rng.uniform(0, 255, (3, H, W, 3)).astype(np.float32)
    right = np.stack([np.roll(left[0], -2, 1), np.roll(left[1], -5, 1),
                      rng.uniform(0, 255, (H, W, 3))]).astype(np.float32)
    gt = -rng.uniform(0, 8, (3, H, W, 1)).astype(np.float32)
    valid = (rng.uniform(size=(3, H, W, 1)) > 0.3).astype(np.float32)
    valid[2, :8] = 0.0       # whole cells without GT
    return variables, model, (left, right, gt, valid)


def _port(model, inputs, **kw):
    left, right = inputs[:2]
    with torch.inference_mode():
        out = model(torch.from_numpy(left), torch.from_numpy(right),
                    iters=ITERS, test_mode=True, **kw)
    return [o.numpy() if isinstance(o, torch.Tensor) else o for o in out]


@pytest.fixture(scope="module")
def fixed(setup):
    """The JAX fixed loop with per-sample residual and EPE curves, and the
    port's, on the same inputs."""
    variables, model, inputs = setup
    left, right, gt, valid = inputs
    jmodel = create_model(JCFG)
    fn = jax.jit(lambda v, a, b, g, m: jmodel.apply(
        v, a, b, iters=ITERS, test_mode=True, iter_metrics="per_sample",
        flow_gt=g, loss_mask=m))
    want = [np.asarray(o) for o in fn(variables, left, right, gt, valid)]
    got = _port(model, inputs, iter_metrics="per_sample",
                flow_gt=torch.from_numpy(gt), loss_mask=torch.from_numpy(valid))
    return got, want


def _jax_adaptive(variables, inputs, tau, min_iters=1):
    jmodel = create_model(JCFG)
    left, right, gt, valid = inputs
    fn = jax.jit(lambda v, a, b, g, m: jmodel.apply(
        v, a, b, iters=ITERS, test_mode=True, iter_metrics="per_sample",
        flow_gt=g, loss_mask=m, adaptive_tau=tau,
        adaptive_min_iters=min_iters))
    return [np.asarray(o) for o in fn(variables, left, right, gt, valid)]


# ------------------------------------------------------------ model paths

def test_iter_curves_match_jax(setup, fixed, record_property):
    (lr, up, res, epe), (jlr, jup, jres, jepe) = fixed
    assert res.shape == epe.shape == (ITERS, 3)
    record_property("residual_dev", tp.max_abs(res, jres))
    record_property("epe_dev", tp.max_abs(epe, jepe))
    record_property("flow_up_dev", tp.max_abs(up, jup))
    assert tp.max_abs(res, jres) <= CURVE_TOL
    assert tp.max_abs(epe, jepe) <= CURVE_TOL
    assert tp.max_abs(up, jup) <= FLOW_TOL_PX
    assert tp.max_abs(lr, jlr) <= FLOW_TOL_PX
    # the batch-mean flavour is the mean of the per-sample curves, and the
    # flows do not move with the outputs asked for
    _, model, inputs = setup
    m_lr, m_up, m_res, m_epe = _port(
        model, inputs, iter_metrics=True, flow_gt=torch.from_numpy(
            inputs[2]), loss_mask=torch.from_numpy(inputs[3]))
    assert np.allclose(m_res, res.mean(1), rtol=1e-6)
    assert np.allclose(m_epe, epe.mean(1), rtol=1e-6)
    plain_lr, plain_up = _port(model, inputs)
    assert np.array_equal(m_up, plain_up) and np.array_equal(up, plain_up)


def test_tau_zero_adaptive_is_the_fixed_loop(setup, fixed):
    _, model, inputs = setup
    (lr, up, res, epe), (_, jup, _, _) = fixed
    for mode in ("masked_scan", "while_loop"):
        model.cfg = dataclasses.replace(model.cfg, adaptive_mode=mode)
        a_lr, a_up, a_res, a_epe, taken = _port(
            model, inputs, iter_metrics="per_sample",
            flow_gt=torch.from_numpy(inputs[2]),
            loss_mask=torch.from_numpy(inputs[3]), adaptive_tau=0.0)
        assert np.array_equal(a_up, up) and np.array_equal(a_lr, lr)
        assert np.array_equal(a_res, res) and np.array_equal(a_epe, epe)
        assert taken.dtype == np.int32 and list(taken) == [ITERS] * 3
        assert tp.max_abs(a_up, jup) <= FLOW_TOL_PX
    model.cfg = dataclasses.replace(model.cfg, adaptive_mode="masked_scan")


def _oracle_taken(res, tau, min_iters, budget):
    """NumPy twin of the freeze rule: after applied update i, a sample
    freezes iff r < tau and i >= min_iters."""
    out = []
    for j in range(res.shape[1]):
        out.append(next((i for i in range(min_iters, budget + 1)
                         if res[i - 1, j] < tau), budget))
    return out


def _midway_tau(res, jres):
    """A τ midway between two adjacent recorded residuals (over every
    sample and iteration but the last) that lies at least 10x the port-JAX
    residual gap from every recorded value, and freezes some sample
    before the budget."""
    gap = max(tp.max_abs(res, jres), 1e-7)
    vals = np.sort(np.unique(res[:-1].ravel()))
    for a, b in zip(vals[:-1], vals[1:]):
        tau = float((a + b) / 2)
        if np.min(np.abs(res - tau)) >= 10 * gap and \
                min(_oracle_taken(res, tau, 1, ITERS)) < ITERS:
            return tau
    raise AssertionError("no τ clear of the recorded residuals")


def test_iters_taken_matches_oracle_and_jax(setup, fixed):
    variables, model, inputs = setup
    (_, _, res, epe), (_, _, jres, _) = fixed
    tau = _midway_tau(res, jres)
    oracle = _oracle_taken(res, tau, 1, ITERS)
    lr, up, a_res, a_epe, taken = _port(
        model, inputs, iter_metrics="per_sample",
        flow_gt=torch.from_numpy(inputs[2]),
        loss_mask=torch.from_numpy(inputs[3]), adaptive_tau=tau)
    assert list(taken) == oracle and len(set(oracle)) > 1
    for j, t in enumerate(oracle):
        # applied updates record the fixed curve's rows, frozen ones 0.0;
        # the EPE rows of a frozen sample stay at its frozen field's EPE
        assert np.array_equal(a_res[:t, j], res[:t, j])
        assert np.all(a_res[t:, j] == 0.0)
        assert np.array_equal(a_epe[:t, j], epe[:t, j])
        assert np.all(a_epe[t:, j] == a_epe[t - 1, j])
    j_lr, j_up, j_res, j_epe, j_taken = _jax_adaptive(variables, inputs, tau)
    assert list(j_taken) == oracle
    assert tp.max_abs(a_res, j_res) <= CURVE_TOL
    assert tp.max_abs(a_epe, j_epe) <= CURVE_TOL
    assert tp.max_abs(up, j_up) <= FLOW_TOL_PX
    # the min_iters floor outranks an always-passing threshold
    *_, floored = _port(model, inputs, iter_metrics="per_sample",
                        adaptive_tau=1e9, adaptive_min_iters=2)
    assert list(floored) == [2, 2, 2]


def test_while_loop_is_bitwise_masked_scan(setup, fixed):
    _, model, inputs = setup
    (_, _, res, _), (_, _, jres, _) = fixed
    outs = {}
    for tau in (_midway_tau(res, jres), 1e9):
        for mode in ("masked_scan", "while_loop"):
            model.cfg = dataclasses.replace(model.cfg, adaptive_mode=mode)
            outs[mode] = _port(model, inputs, iter_metrics="per_sample",
                               flow_gt=torch.from_numpy(inputs[2]),
                               adaptive_tau=tau)
        ms, wl = outs["masked_scan"], outs["while_loop"]
        for i in (0, 1, 2, 4):   # flows, residual rows, iters_taken
            assert np.array_equal(ms[i], wl[i]), (tau, i)
        taken = ms[4]
        # EPE rows agree for the trips the while loop ran (until every
        # sample had frozen); after that stop its rows stay 0.0
        ran = min(int(taken.max()), ITERS - 1)
        assert np.array_equal(ms[3][:ran], wl[3][:ran])
        assert np.all(wl[3][ran:-1] == 0.0)
    model.cfg = dataclasses.replace(model.cfg, adaptive_mode="masked_scan")


def test_forward_guards_match_jax(setup):
    _, model, inputs = setup
    a = torch.from_numpy(inputs[0][:1])
    gt = torch.from_numpy(inputs[2][:1])
    for kw, match in (
            (dict(adaptive_tau=0.1, iter_metrics=True), "per_sample"),
            (dict(adaptive_tau=0.1, iter_metrics="per_sample",
                  numerics=True), "numerics taps are not supported"),
            (dict(adaptive_tau=-1.0, iter_metrics="per_sample"), ">= 0"),
            (dict(adaptive_tau=0.1, iter_metrics="per_sample",
                  test_mode=False), "test-mode"),
            (dict(flow_gt=gt), "iter_metrics"),
            (dict(numerics=True, test_mode=False), "test-mode"),
            (dict(flow_gt=gt, test_mode=False), "loss_mask")):
        kw.setdefault("test_mode", True)
        with pytest.raises(ValueError, match=match):
            model(a, a, iters=2, **kw)
    with pytest.raises(ValueError, match="adaptive_mode"):
        dataclasses.replace(model.cfg, adaptive_mode="scan")
    assert tp.port_config(JConfig(adaptive_mode="while_loop")).adaptive_mode \
        == "while_loop"


# ------------------------------------------------------------ the policy

def _records(curves, epes=None, bucket="32x64", source="eval:kitti"):
    return [jcv.converge_payload(source, len(c), c, bucket=bucket,
                                 epe=None if epes is None else epes[i],
                                 frame=i)
            for i, c in enumerate(curves)]


def test_policy_and_tables_match_jax(fixed, tmp_path, capsys):
    (_, _, res, epe), _ = fixed
    curves = [res[:, j] for j in range(res.shape[1])]
    recs = (_records(curves, [epe[:, j] for j in range(3)])
            + _records(curves[:2], bucket="64x96", source="serve:x"))
    got = [tcv.converge_payload(r["source"], r["iters"], res[:, i % 3],
                                bucket=r["bucket"], frame=r["frame"],
                                epe=None if "epe" not in r
                                else epe[:, i % 3])
           for i, r in enumerate(recs)]
    assert got == recs
    taus = (float(np.median(res)), 0.5, 0.05)
    for by in ("bucket", "all", "both"):
        assert tcv.decision_table(recs, taus, by) == \
            jcv.decision_table(recs, taus, by)
    assert tcv.format_table(tcv.decision_table(recs, taus)) == \
        jcv.format_table(jcv.decision_table(recs, taus))
    for tau in taus:
        assert [tcv.simulate(r, tau) for r in recs] == \
            [jcv.simulate(r, tau) for r in recs]
        assert tcv.exit_percentile(recs, tau) == jcv.exit_percentile(recs,
                                                                     tau)
    for kw in (dict(tau=taus[0]), dict(tau=0.05, min_iters=2, margin=0),
               dict(tau=taus[0], source_run="runs/x")):
        doc = tcv.build_policy(recs, **kw)
        assert doc == jcv.build_policy(recs, **kw)
        assert tcv.policy_digest(doc) == jcv.policy_digest(doc)
        assert check_iter_policy(doc) == j_check(doc) == []
        for bucket in ("32x64", "64x96", "96x96", None):
            assert tcv.policy_lookup(doc, bucket) == \
                jcv.policy_lookup(doc, bucket)
    with pytest.raises(ValueError, match="no converge records"):
        tcv.build_policy([])
    # the command line: the same table, the same policy file
    run = tmp_path / "run"
    run.mkdir()
    with open(run / "events.jsonl", "w") as f:
        for r in recs:
            f.write(json.dumps({"event": "converge", **r}) + "\n")
    outs = {}
    for name, main in (("port", tcv.main), ("jax", jcv.main)):
        argv = [str(run), "--emit-policy", str(tmp_path / f"{name}.json"),
                "--policy-tau", str(taus[0]), "--taus", *map(str, taus)]
        assert main(argv) == 0
        outs[name] = capsys.readouterr().out
    assert outs["port"] == outs["jax"]
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    assert tcv.load_records(str(run)) == jcv.load_records(str(run))
    assert tcv.main([str(tmp_path / "empty")]) == 1


def _entry(tau, budget, min_iters=1, recorded=None):
    return {"tau": tau, "budget": budget, "min_iters": min_iters,
            "provenance": {"source": "eval:test",
                           "row": {"tau": tau,
                                   "budget": recorded or budget}}}


def _policy(buckets, default=None):
    doc = {"kind": "iter_policy", "version": 1, "source_run": "runs/test",
           "buckets": buckets}
    if default is not None:
        doc["default"] = default
    return doc


def _set_tau(d):
    d["buckets"]["32x64"]["tau"] = 0.2


def _inflate(d):
    d["buckets"]["32x64"]["budget"] = 9


def _zero_tau(d):
    d["buckets"]["32x64"]["tau"] = 0.0
    d["buckets"]["32x64"]["provenance"]["row"]["tau"] = 0.0


DOCTORINGS = {
    "tau_vs_row": _set_tau, "budget": _inflate, "zero_tau": _zero_tau,
    "no_coverage": lambda d: d["buckets"].clear(),
    "bucket_key": lambda d: d["buckets"].update({"32x": _entry(0.05, 3)}),
    "min_iters": lambda d: d["buckets"]["32x64"].update(min_iters=7),
    "kind": lambda d: d.update(kind="nope"),
    "version": lambda d: d.update(version=2),
    "source_run": lambda d: d.pop("source_run"),
    "provenance": lambda d: d["buckets"]["32x64"].pop("provenance"),
    "default": lambda d: d.update(default={"tau": "x", "budget": 0,
                                           "min_iters": 0}),
    "not_object": lambda d: d.clear(),
}


@pytest.mark.parametrize("name", sorted(DOCTORINGS))
def test_doctored_policy_lint_matches_jax(name, tmp_path):
    doc = _policy({"32x64": _entry(0.05, 3)})
    DOCTORINGS[name](doc)
    errors = check_iter_policy(doc)
    assert errors and errors == j_check(doc)
    path = tmp_path / "p.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError) as got:
        tcv.load_policy(str(path))
    with pytest.raises(ValueError) as want:
        jcv.load_policy(str(path))
    assert str(got.value) == str(want.value)
    # a predictor handed the doctored file fails at construction
    with pytest.raises(ValueError, match="iter_policy"):
        StereoPredictor(tp.port_config(JCFG), {}, iter_policy=str(path),
                        device="cpu")
    assert check_iter_policy([]) == j_check([])


# ---------------------------------------------------- predictor plumbing

def test_predictor_policy_plumbing(setup):
    variables, model, inputs = setup
    cfg, sd = model.cfg, model.state_dict()
    left, right = inputs[0][:1], inputs[1][:1]
    policy = _policy({"32x64": _entry(1e9, 2, recorded=ITERS)},
                     default=_entry(1e9, 3, recorded=ITERS))
    with pytest.raises(ValueError, match="needs an iter_policy"):
        StereoPredictor(cfg, sd, adaptive=True, device="cpu")
    with pytest.raises(ValueError, match="numerics taps"):
        StereoPredictor(cfg, sd, iter_policy=policy, numerics=True,
                        device="cpu")
    pred = StereoPredictor(cfg, sd, valid_iters=ITERS, iter_policy=policy,
                           device="cpu")
    jpred = JPredictor(JCFG, variables, valid_iters=ITERS,
                       iter_policy=policy)
    assert pred.converge and pred.policy_digest == jpred.policy_digest
    for hw in ((32, 64), (30, 60), (40, 64), (64, 128)):
        assert pred.policy_entry(*hw) == jpred.policy_entry(*hw)
    # the bucket's budget caps the iterations; iters_taken rides the aux
    flow = pred(left, right)
    aux = pred.take_aux()
    assert aux["residual"].shape == (2, 1) and list(aux["iters_taken"]) == [1]
    assert pred.take_aux() is None
    # a smaller per-call iters caps the budget further
    pred(left, right, iters=1)
    assert pred.take_aux()["residual"].shape == (1, 1)
    # the async handle carries the same aux; the result is bitwise
    handle = pred.predict_async(left, right)
    assert np.array_equal(handle.result(), flow)
    assert {k: v.tolist() for k, v in handle.aux_result().items()} == \
        {k: v.tolist() for k, v in aux.items()}
    # adaptive=False with a policy loaded is the fixed predictor
    off = StereoPredictor(cfg, sd, valid_iters=ITERS, iter_policy=policy,
                          adaptive=False, device="cpu")
    plain = StereoPredictor(cfg, sd, valid_iters=ITERS, device="cpu")
    assert np.array_equal(off(left, right), plain(left, right))
    assert off.take_aux() is None and plain.take_aux() is None


def test_predictor_uncovered_bucket_runs_fixed(setup):
    _, model, inputs = setup
    policy = _policy({"64x128": _entry(1e9, 2, recorded=ITERS)})
    pred = StereoPredictor(model.cfg, model.state_dict(), valid_iters=ITERS,
                           iter_policy=policy, device="cpu")
    conv = StereoPredictor(model.cfg, model.state_dict(), valid_iters=ITERS,
                           converge=True, device="cpu")
    left, right = inputs[0][:1], inputs[1][:1]
    assert pred.policy_entry(H, W) is None
    assert np.array_equal(pred(left, right), conv(left, right))
    aux, want = pred.take_aux(), conv.take_aux()
    assert "iters_taken" not in aux
    assert np.array_equal(aux["residual"], want["residual"])


# ------------------------------------------------------- the eval stream

@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    ds = tmp_path_factory.mktemp("converge_tree") / "datasets"
    tp.write_kitti(ds, np.random.default_rng(13), n=3)
    return ds


def _kitti_records(pred, tree, run, stream):
    tel = Telemetry(str(run), stall_deadline_s=None)
    tel.run_start(config={})
    tval.validate_kitti(pred, root=str(tree), iters=ITERS, warmup_frames=0,
                        telemetry=tel, stream=stream)
    tel.emit("run_end", steps=tel.steps, ok=True)
    tel.close()
    return [r for r in read_events(str(run / "events.jsonl"))
            if r["event"] in ("converge", "numerics")]


def test_eval_stream_records_match_jax(setup, kitti_tree, tmp_path):
    """A KITTI validation with converge, iter_epe and numerics on: the
    port's ``converge`` and ``numerics`` records against a JAX run's,
    sequential; streamed (window 3, micro-batch 2) the same records."""
    from raft_stereo_tpu.eval import validate as jval
    from raft_stereo_tpu.obs import Telemetry as JTelemetry
    variables, model, _ = setup
    kw = dict(valid_iters=ITERS, converge=True, iter_epe=True,
              numerics=True)
    pred = StereoPredictor(model.cfg, model.state_dict(), device="cpu", **kw)
    got = _kitti_records(pred, kitti_tree, tmp_path / "seq", False)
    tel = JTelemetry(str(tmp_path / "jax"), stall_deadline_s=None)
    jval.validate_kitti(JPredictor(JCFG, variables, **kw),
                        root=str(kitti_tree), iters=ITERS,
                        warmup_frames=0, telemetry=tel, stream=False)
    tel.close()
    want = [r for r in read_events(str(tmp_path / "jax" / "events.jsonl"))
            if r["event"] in ("converge", "numerics")]
    assert [r["event"] for r in got] == [r["event"] for r in want]
    assert [r["event"] for r in got].count("converge") == 3
    for r, w in zip(got, want):
        plain = {k: v for k, v in r.items()
                 if k not in ("ts", "t", "host_id", "pid", "taps",
                              "residual", "epe", "final_residual",
                              "half_life")}
        assert plain == {k: w[k] for k in plain}
        if r["event"] == "converge":
            assert tp.max_abs(r["residual"], w["residual"]) <= CURVE_TOL
            assert tp.max_abs(r["epe"], w["epe"]) <= CURVE_TOL
            assert r.get("half_life") == w.get("half_life")
        else:
            assert list(r["taps"]) == list(w["taps"])
            for label, series in r["taps"].items():
                for field in ("nonfinite", "sat", "underflow"):
                    assert series[field] == w["taps"][label][field]
                for field in ("min", "max", "absmean"):
                    assert np.allclose(series[field],
                                       w["taps"][label][field],
                                       rtol=1e-4, atol=1e-6)
    streamed = _kitti_records(pred, kitti_tree, tmp_path / "stream",
                              StreamConfig(enabled=True, window=3,
                                           microbatch=1, decode_workers=2))

    def strip(recs, event):
        # a streamed dispatch emits its numerics record before its
        # frames' converge records (the JAX package's order too)
        return [{k: v for k, v in r.items() if k not in ("ts", "t")}
                for r in recs if r["event"] == event]
    for event in ("converge", "numerics"):
        assert strip(streamed, event) == strip(got, event)
    # an adaptive predictor: iters_taken on every record, streamed or not,
    # and no numerics records (the early exit carries no taps)
    policy = tcv.build_policy([r for r in got if r["event"] == "converge"],
                              tau=float(np.median([
                                  r["residual"][1] for r in got
                                  if r["event"] == "converge"])),
                              source_run="seq")
    apred = StereoPredictor(model.cfg, model.state_dict(), device="cpu",
                            valid_iters=ITERS, iter_policy=policy)
    a_seq = _kitti_records(apred, kitti_tree, tmp_path / "a_seq", False)
    a_str = _kitti_records(apred, kitti_tree, tmp_path / "a_str",
                           StreamConfig(enabled=True, window=2,
                                        microbatch=2, decode_workers=2))
    assert [r["event"] for r in a_seq] == ["converge"] * 3
    assert [r["iters_taken"] for r in a_seq] == \
        [r["iters_taken"] for r in a_str]
    assert all(1 <= r["iters_taken"] <= ITERS for r in a_seq)


def test_entry_point_defaults_match_jax_run(kitti_tree, tmp_path,
                                            monkeypatch, capsys):
    """The eval entry points with their defaults (converge and numerics
    on) and ``--iter_epe``: the same run_start config (the device aside),
    the same event kinds and counts, and records of the same shape (tap
    labels, curve lengths, EPE present). Values are held on bridged
    weights above; each entry point makes its own weights here."""
    import sys
    from raft_stereo_tpu import cli as jcli
    from raft_stereo_tpu_torch import evaluate
    base = ["--dataset", "kitti", "--data_root", str(kitti_tree),
            "--valid_iters", "2", "--hidden_dims", "32", "32", "32",
            "--stream", "off", "--iter_epe"]
    evaluate.main(["--device", "cpu", "--run_dir", str(tmp_path / "port"),
                   *base])
    monkeypatch.setattr(sys, "argv", ["eval", "--run_dir",
                                      str(tmp_path / "jax"), *base])
    jcli._eval_main()
    capsys.readouterr()
    runs = {name: [r for r in read_events(str(tmp_path / name /
                                              "events.jsonl"))
                   if r["event"] != "compile"]
            for name in ("port", "jax")}

    def kinds(recs):
        out = {}
        for r in recs:
            out[r["event"]] = out.get(r["event"], 0) + 1
        return out
    assert kinds(runs["port"]) == kinds(runs["jax"])
    assert kinds(runs["port"])["converge"] == 3
    assert kinds(runs["port"])["numerics"] == 3
    starts = [next(r for r in recs if r["event"] == "run_start")["config"]
              for recs in (runs["port"], runs["jax"])]
    starts[0].pop("device")
    assert starts[0] == starts[1]
    for event in ("converge", "numerics"):
        got = [r for r in runs["port"] if r["event"] == event]
        want = [r for r in runs["jax"] if r["event"] == event]
        for r, w in zip(got, want):
            assert sorted(r) == sorted(w)
            for key in ("source", "bucket", "frame", "iters", "idx"):
                assert r.get(key) == w.get(key)
            if event == "numerics":
                assert list(r["taps"]) == list(w["taps"])
