"""The port's serving path (``raft_stereo_tpu_torch/serve``, the converge
emit half, ``iter_metrics``, the serve and loadtest flags) against the JAX
package's, on the CPU, at the default widths, 48x96 and 2 iterations (as
tests/test_serve.py runs the JAX server), weights bridged from one seeded
JAX tree.

* ``iter_metrics`` (True and "per_sample") against JAX ``model.apply``:
  curves and flows within 1e-3 px, and flow_up bitwise the
  ``iter_metrics=False`` one;
* host-side copies record for record: converge payloads and records,
  BoundedQueue/collect_group under one operation sequence, bucket labels,
  SLOTracker snapshots and records under one clock, Prometheus text, the
  load-test trace and synthetic pairs;
* the server: served flows bitwise equal to the port's StereoPredictor at
  batch 1 and within 1e-3 px of the JAX server's on the same requests;
  batched dispatch with poison isolation (the batchmates bitwise equal to
  their clean batch), the warm-start chain (against the model driven by
  hand), hot reload (also of a +fused bucket; a structure mismatch
  raises), drain, dispatch and retire failures that fail their batch only;
* the HTTP front on the CPU, run_clients with a poisoned request, the
  event stream linted by the JAX package's ``obs/validate.check_path``.
"""

import dataclasses
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from raft_stereo_tpu.config import RAFTStereoConfig as JConfig
from raft_stereo_tpu.obs.validate import check_path
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.inference import StereoPredictor
from raft_stereo_tpu_torch.models import RAFTStereo
from raft_stereo_tpu_torch.obs import Telemetry, Tracer
from raft_stereo_tpu_torch.serve import (BoundedQueue, BucketKey,
                                         QueueClosed, ServeConfig,
                                         ServerDraining, SLOTracker,
                                         StereoServer, collect_group)
from raft_stereo_tpu_torch.serve.cache import padded_batch
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

import torch_parity as tp
from torch_parity import torch_one_thread  # noqa: F401

H, W = 48, 96
ITERS = 2
FLOW_TOL_PX = 1e-3
JCFG = JConfig()
CPU = torch.device("cpu")


def _pair(seed, h=H, w=W, poison=False):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 255, (h, w, 3)).astype(np.float32)
    right = rng.integers(0, 255, (h, w, 3)).astype(np.float32)
    if poison:
        left[0, 0, 0] = np.nan
    return left, right


@pytest.fixture(scope="module")
def weights():
    variables = tp.jax_variables(JCFG, seed=7, image_shape=(1, H, W, 3))
    return variables, state_dict_from_jax(variables)


@pytest.fixture(scope="module")
def stack(weights):
    """The port's predictor and server and the JAX server, on one set of
    weights."""
    from raft_stereo_tpu.serve import ServeConfig as JServeConfig
    from raft_stereo_tpu.serve import StereoServer as JServer
    variables, sd = weights
    cfg = tp.port_config(JCFG)
    knobs = dict(max_batch=4, window=2, default_iters=ITERS, linger_s=0.2)
    predictor = StereoPredictor(cfg, sd, valid_iters=ITERS, device="cpu")
    server = StereoServer(cfg, sd, ServeConfig(**knobs), device="cpu")
    jserver = JServer(JCFG, variables, JServeConfig(**knobs))
    yield cfg, predictor, server, jserver
    server.close(timeout=60)
    jserver.close(timeout=60)


def _serve_both(stack, submits):
    """Submit ``submits`` ((left, right, kwargs) each) back to back to the
    port's server, then to the JAX server; both lists of results."""
    _, _, server, jserver = stack
    out = []
    for srv in (server, jserver):
        handles = [srv.submit(l, r, **kw) for l, r, kw in submits]
        out.append([h.result(timeout=300) for h in handles])
    return out


# --- iter_metrics ------------------------------------------------------------

@pytest.mark.parametrize("metrics", [True, "per_sample"])
def test_iter_metrics_match_jax(weights, metrics):
    from raft_stereo_tpu.models.raft_stereo import create_model
    variables, sd = weights
    model = RAFTStereo(tp.port_config(JCFG))
    model.load_state_dict(sd, strict=True)
    model.eval()
    l0, r0 = _pair(1, 64, 96)
    l1, r1 = _pair(2, 64, 96)
    im1, im2 = np.stack([l0, l1]), np.stack([r0, r1])
    with torch.inference_mode():
        lr, up, curve = model(torch.from_numpy(im1), torch.from_numpy(im2),
                              iters=ITERS, iter_metrics=metrics)
        lr_plain, up_plain = model(torch.from_numpy(im1),
                                   torch.from_numpy(im2), iters=ITERS)
    assert torch.equal(up, up_plain) and torch.equal(lr, lr_plain)
    want_shape = (ITERS,) if metrics is True else (ITERS, 2)
    assert tuple(curve.shape) == want_shape
    jmodel = create_model(JCFG)
    fn = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, iters=ITERS,
                                              test_mode=True,
                                              iter_metrics=metrics))
    jlr, jup, jcurve = fn(variables, im1, im2)
    assert tp.max_abs(curve.numpy(), jcurve) <= FLOW_TOL_PX
    assert tp.max_abs(up.numpy(), jup) <= FLOW_TOL_PX
    assert tp.max_abs(lr.numpy(), jlr) <= FLOW_TOL_PX
    with pytest.raises(ValueError, match="test-mode"):
        model(torch.from_numpy(im1), torch.from_numpy(im2), iters=1,
              test_mode=False, iter_metrics=metrics)


# --- host-side copies --------------------------------------------------------

class _Capture:
    """A telemetry sink that keeps each emitted (event, payload)."""

    def __init__(self):
        self.records = []

    def emit(self, event, **payload):
        self.records.append((event, payload))


@pytest.mark.parametrize("n, extra", [
    (2, {}), (7, {"bucket": "64x96", "id": "r1"}), (40, {"epe": True}),
    (32, {"bucket": "384x1248"})])
def test_converge_records_match_jax(n, extra):
    from raft_stereo_tpu.obs import converge as jconv
    from raft_stereo_tpu_torch.obs import converge as tconv
    rng = np.random.default_rng(n)
    curve = np.sort(rng.uniform(0, 3, n))[::-1].astype(np.float32)
    kw = dict(extra)
    if kw.pop("epe", False):
        kw["epe"] = list(rng.uniform(0, 5, n))
    args = ("serve:64x96b1i2", n, curve)
    assert tconv.converge_payload(*args, **kw) == jconv.converge_payload(
        *args, **kw)
    assert tconv.converge_payload(*args, max_points=5, **kw) == \
        jconv.converge_payload(*args, max_points=5, **kw)
    got, want = _Capture(), _Capture()
    tconv.emit(got, *args, **kw)
    jconv.emit(want, *args, **kw)
    assert got.records == want.records and got.records[0][0] == "converge"
    tconv.emit(None, *args)  # no sink: nothing, no error


def _queue_ops(mod):
    """One operation sequence on ``mod``'s BoundedQueue and collect_group;
    the log of what each step returned."""
    log = []
    q = mod.BoundedQueue(3)
    log += [q.put(x, timeout=0.05) for x in ("a0", "a1", "b0")]
    log.append(q.put("z", timeout=0.05))           # full: False
    first = q.get()
    log.append(mod.collect_group(first, q.get_nowait, q.push_front, 4,
                                 key=lambda s: s[0]))
    log += [len(q), q.get_nowait(), q.get_nowait(), q.get(timeout=0.02)]
    q.put("c0", timeout=0.05)
    q.push_front("c-1")
    q.close()
    try:
        q.put("x")
        log.append("admitted")
    except mod.QueueClosed:
        log.append("closed")
    log += [q.closed, q.get(), q.get(), q.get(timeout=0.02)]
    log.append(mod.collect_group("x", lambda: None, log.append, 0, key=len))
    return log


def test_queue_and_grouping_match_jax():
    from raft_stereo_tpu.serve import batching as jbatching
    from raft_stereo_tpu_torch.serve import batching as tbatching
    got, want = _queue_ops(tbatching), _queue_ops(jbatching)
    assert got == want
    assert got[4] == ["a0", "a1"] and got[-1] == ["x"]


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("impl", ["", "fused"])
@pytest.mark.parametrize("policy", ["", "0123abcd"])
def test_bucket_label_matches_jax(warm, impl, policy):
    from raft_stereo_tpu.serve.cache import BucketKey as JKey
    args = (64, 96, 2, 32, warm, policy, impl)
    assert BucketKey(*args).label() == JKey(*args).label()
    assert BucketKey(*args) == tuple(JKey(*args))


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 0.0137
        return self.t


def _slo_run(tracker_cls, monkeypatch):
    monkeypatch.setattr(time, "monotonic", _Clock())
    sink = _Capture()
    slo = tracker_cls(sink, window=5, emit_every=3, gauge_every=2)
    snaps = []
    for i in range(9):
        slo.admit(queue_depth=i % 3, in_flight=i % 2)
        if i % 4 == 3:
            slo.reject()
        ok = i % 5 != 2
        slo.retire(
            request_id=f"r{i}", status="ok" if ok else "error",
            latency_s=0.01 * (i + 1) + 0.003 * (i % 3), queue_wait_s=0.001 * i,
            bucket=f"64x96b{1 + i % 2}i2", batch_size=1 + i % 2,
            in_flight=i % 2, stream="cam" if i % 3 == 0 else None,
            error=None if ok else "boom",
            traceback_tail=None if ok else "T" * 2500,
            final_residual=0.5 / (i + 1), iters_taken=20 + i if i % 2
            else None, output_min=-30.0 - i, output_max=-0.5 * i)
        snaps.append(slo.snapshot(in_flight=i % 2))
    slo.flush(in_flight=0)
    return snaps, sink.records


def test_slo_snapshots_match_jax(monkeypatch):
    from raft_stereo_tpu.serve.slo import SLOTracker as JTracker
    got = _slo_run(SLOTracker, monkeypatch)
    want = _slo_run(JTracker, monkeypatch)
    assert got == want
    kinds = [e for e, _ in got[1]]
    assert kinds.count("request") == 9 and kinds.count("slo") == 4
    assert {"quality", "iters", "output_range"} <= set(got[0][-1])


@pytest.mark.parametrize("host_id", [None, "serve-host"])
def test_prometheus_text_matches_jax(host_id):
    from raft_stereo_tpu.serve.http import prometheus_metrics as jprom
    from raft_stereo_tpu_torch.serve.http import prometheus_metrics
    stats = {"p50_ms": 12.5, "p99_ms": 40.25, "pairs_per_sec": 7.125,
             "in_flight": 2, "queue_depth": 3, "window_requests": 40,
             "draining": False, "executables": 4, "sessions": 1,
             "admitted": 41, "completed": 39, "failed": 1, "rejected": 2,
             "stopped": False,
             "quality": {"64x96b1i2": {"final_residual_p50": 0.03,
                                       "final_residual_p95": 0.1, "n": 9},
                         "384x1248b4i32+fused": {
                             "final_residual_p50": 0.2, "n": 3}},
             "iters": {"64x96b1i2": {"iters_taken_p50": 12,
                                     "iters_taken_p95": 20,
                                     "iters_taken_mean": 13.5, "n": 9}},
             "output_range": {"64x96b1i2": {"output_min_p05": -40.0,
                                            "output_max_p95": -0.5,
                                            "n": 9}}}
    text = prometheus_metrics(stats, host_id=host_id)
    assert text == jprom(stats, host_id=host_id)
    assert "raft_serve_final_residual_p50" in text


def test_loadtest_trace_and_pairs_match_jax():
    from raft_stereo_tpu.serve import loadtest as jlt
    from raft_stereo_tpu_torch.serve import loadtest as tlt
    kw = dict(shapes=((48, 96), (64, 128), (96, 64)), clients=5,
              requests_per_client=3, video_streams=2, poison_at=7, seed=3)
    assert tlt.LoadTestConfig(**kw).trace() == jlt.LoadTestConfig(
        **kw).trace()
    assert tlt.DEFAULT_SHAPES == jlt.DEFAULT_SHAPES
    for poison in (False, True):
        got = tlt.synth_pair(np.random.default_rng(5), 20, 30, poison)
        want = jlt.synth_pair(np.random.default_rng(5), 20, 30, poison)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _dests(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_serve_parsers_match_jax():
    from raft_stereo_tpu import cli as jcli
    from raft_stereo_tpu_torch import cli
    for port, jax_ in ((cli.build_serve_parser, jcli.build_serve_parser),
                       (cli.build_loadtest_parser,
                        jcli.build_loadtest_parser)):
        got, want = _dests(port()), _dests(jax_())
        assert got.pop("device") == "cuda"
        # the eval/train-only knobs the port's model flags share with the
        # JAX package's are the same set; so is everything else
        assert got == want
    cfg = cli.serve_config(cli.build_serve_parser().parse_args(
        ["--no_aot", "--linger_ms", "25", "--fused_width", "1248"]))
    assert (cfg.aot, cfg.linger_s, cfg.fused_width, cfg.converge) == (
        False, 0.025, 1248, True)
    assert cli._parse_shapes(["48x96", "128X64"]) == [(48, 96), (128, 64)]
    for flags in (["--numerics"], ["--iter_policy", "p.json"],
                  ["--adaptive", "on"]):
        for build in (cli.build_serve_parser, cli.build_loadtest_parser):
            args = build().parse_args(flags)
            with pytest.raises(ValueError, match="A11"):
                cli.serve_config(args)
    assert cli.serve_config(cli.build_serve_parser().parse_args(
        ["--adaptive", "off"])).adaptive is False


# --- the server --------------------------------------------------------------

def test_served_bitwise_predictor_and_near_jax(stack):
    """Two raw shapes padding into one bucket: each bitwise the port's
    predictor, within 1e-3 px of the JAX server."""
    _, predictor, _, _ = stack
    submits = [(*_pair(0), {}), (*_pair(1, 40, 80), {})]
    ours, theirs = [], []
    for l, r, kw in submits:
        o, t = _serve_both(stack, [(l, r, kw)])
        ours += o
        theirs += t
    for (l, r, _), res, jres in zip(submits, ours, theirs):
        assert res.ok and res.batch_size == 1 and res.bucket == "64x96b1i2"
        assert res.flow.shape == l.shape[:2] + (1,)
        np.testing.assert_array_equal(
            res.flow, predictor(l[None], r[None], ITERS)[0])
        assert tp.max_abs(res.flow, jres.flow) <= FLOW_TOL_PX
        assert res.residuals.shape == (ITERS,)
        assert abs(res.final_residual - jres.final_residual) <= FLOW_TOL_PX
        np.testing.assert_array_equal(res.disparity, -res.flow[..., 0])


def test_batched_dispatch_and_poison_isolation(stack):
    """Four back-to-back requests ride one dispatch; a poisoned one fails
    alone and its batchmates are bitwise their clean-batch results."""
    _, predictor, server, _ = stack
    pairs = [_pair(10 + i) for i in range(4)]
    poisoned = list(pairs)
    poisoned[2] = _pair(12, poison=True)
    clean = [server.submit(l, r) for l, r in pairs]
    clean = [h.result(timeout=300) for h in clean]
    ours, theirs = _serve_both(stack, [(l, r, {}) for l, r in poisoned])
    for batch in (clean, ours, theirs):
        assert [r.batch_size for r in batch] == [4] * 4
    assert all(r.ok for r in clean)
    assert [r.ok for r in ours] == [True, True, False, True]
    assert ours[2].error_kind == "nonfinite_output" and ours[2].flow is None
    assert not theirs[2].ok and theirs[2].error_kind == "nonfinite_output"
    # the served batch is the predictor's batch of four
    four = predictor(*(np.stack(x) for x in zip(*pairs)), ITERS)
    for j in range(4):
        np.testing.assert_array_equal(clean[j].flow, four[j])
    for j in (0, 1, 3):
        np.testing.assert_array_equal(ours[j].flow, clean[j].flow)
        assert tp.max_abs(ours[j].flow, theirs[j].flow) <= FLOW_TOL_PX
        # batch 4 against batch 1: other CPU kernels, within the bar
        direct = predictor(pairs[j][0][None], pairs[j][1][None], ITERS)[0]
        assert tp.max_abs(ours[j].flow, direct) <= FLOW_TOL_PX
    assert server.submit(*_pair(14)).result(timeout=300).ok


def test_warm_start_chain(stack):
    """A three-frame session: frame k+1 rides frame k's low-res flow,
    bitwise the model driven by hand with that flow_init, and within
    1e-3 px of the JAX server's session."""
    cfg, _, server, _ = stack
    frames = [_pair(20 + k) for k in range(3)]
    ours, theirs = [], []
    for l, r in frames:
        o, t = _serve_both(stack, [(l, r, dict(stream="cam",
                                                warm_start=True))])
        ours += o
        theirs += t
    assert all(r.ok and r.bucket == "64x96b1i2w" for r in ours + theirs)
    init = np.zeros((1, 64 // cfg.factor, 96 // cfg.factor, 2), np.float32)
    for (l, r), res, jres in zip(frames, ours, theirs):
        im1, padders, _ = padded_batch([l], (64, 96), CPU)
        im2, _, _ = padded_batch([r], (64, 96), CPU)
        with torch.inference_mode():
            lr, up = server.cache.model(im1, im2, iters=ITERS,
                                        flow_init=torch.from_numpy(init))
        np.testing.assert_array_equal(res.flow,
                                      padders[0].unpad(up)[0].numpy())
        np.testing.assert_array_equal(res.flow_lowres, lr[0].numpy())
        assert tp.max_abs(res.flow, jres.flow) <= FLOW_TOL_PX
        init = res.flow_lowres[None]
    assert np.all(ours[-1].flow_lowres[..., 1] == 0)


def test_hot_reload(stack, weights):
    """A reload mid-traffic drops nothing; after it, flows are bitwise a
    fresh predictor's on the new weights and within 1e-3 px of the JAX
    server's after the same reload; no new entries; a structure mismatch
    raises; a +fused bucket sees the reload too."""
    cfg, _, server, jserver = stack
    variables, sd = weights
    scaled_vars = jax.tree.map(lambda leaf: leaf * 0.5, variables)
    scaled = state_dict_from_jax(scaled_vars)
    left, right = _pair(30)
    before = server.submit(left, right).result(timeout=300)
    n_entries = len(server.cache)
    try:
        handles = [server.submit(*_pair(31 + i)) for i in range(3)]
        server.reload(scaled, note="test-swap")
        jserver.reload(scaled_vars)
        handles.append(server.submit(left, right))
        assert all(h.result(timeout=300).ok for h in handles)
        after, jafter = _serve_both(stack, [(left, right, {})])
        after, jafter = after[0], jafter[0]
        assert after.ok and not np.array_equal(after.flow, before.flow)
        fresh = StereoPredictor(cfg, scaled, valid_iters=ITERS, device="cpu")
        np.testing.assert_array_equal(after.flow,
                                      fresh(left[None], right[None])[0])
        assert tp.max_abs(after.flow, jafter.flow) <= FLOW_TOL_PX
        assert len(server.cache) >= n_entries
        with pytest.raises(ValueError, match="structure"):
            server.reload({"bogus": torch.zeros(3)})
    finally:
        server.reload(sd)
        jserver.reload(variables)
    # the memoryless flavour of a wide bucket: its module shares the weights
    fused_cfg = dataclasses.replace(cfg, corr_implementation="fused")
    wide = StereoServer(cfg, sd, ServeConfig(max_batch=1,
                                             default_iters=ITERS,
                                             fused_width=96), device="cpu")
    try:
        for state in (sd, scaled):
            if state is scaled:
                wide.reload(scaled)
            res = wide.submit(left, right).result(timeout=300)
            assert res.ok and res.bucket == "64x96b1i2+fused"
            want = StereoPredictor(fused_cfg, state, valid_iters=ITERS,
                                   device="cpu")(left[None], right[None])
            np.testing.assert_array_equal(res.flow, want[0])
    finally:
        assert wide.close(timeout=60)


def test_http_round_trip(stack):
    from raft_stereo_tpu_torch.serve.http import make_http_server
    _, _, server, _ = stack
    httpd = make_http_server(server, "127.0.0.1", 0, host_id="cpu-host")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % httpd.server_address
    try:
        left, right = _pair(50)
        want = server.submit(left, right).result(timeout=300).flow
        for poison, code in ((False, 200), (True, 422)):
            l, r = _pair(50, poison=poison)
            buf = io.BytesIO()
            np.savez_compressed(buf, left=l, right=r)
            req = urllib.request.Request(
                f"{base}/v1/predict?iters={ITERS}", data=buf.getvalue(),
                method="POST", headers={"traceparent": "00-t1-s1-01"})
            try:
                with urllib.request.urlopen(req, timeout=300) as resp:
                    status, headers, body = (resp.status, resp.headers,
                                             resp.read())
            except urllib.error.HTTPError as err:
                status, headers, body = err.code, err.headers, err.read()
            assert status == code
            assert headers["traceparent"] == "00-t1-s1-01"
            assert headers["X-Bucket"] == "64x96b1i2"
            if code == 200:
                with np.load(io.BytesIO(body)) as npz:
                    np.testing.assert_array_equal(npz["flow"], want)
            else:
                assert json.loads(body)["kind"] == "nonfinite_output"
        for path in ("/healthz", "/slo"):
            with urllib.request.urlopen(base + path, timeout=10) as resp:
                assert resp.status == 200
                assert json.loads(resp.read())["completed"] >= 2
        with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
            text = resp.read().decode()
        assert 'raft_serve_requests_failed_total{host="cpu-host"}' in text
        off = make_http_server(server, "127.0.0.1", 0, metrics=False)
        t2 = threading.Thread(target=off.serve_forever, daemon=True)
        t2.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen("http://%s:%d/metrics"
                                       % off.server_address, timeout=10)
            assert err.value.code == 404
        finally:
            off.shutdown()
            off.server_close()
    finally:
        httpd.shutdown()
        httpd.server_close()


# --- drain, failures, the load generator (small model) -----------------------

SMALL = RAFTStereoConfig(hidden_dims=(32, 32, 32))


@pytest.fixture(scope="module")
def small_weights():
    variables = tp.jax_variables(JConfig(hidden_dims=(32, 32, 32)), seed=9,
                                 image_shape=(1, H, W, 3))
    return state_dict_from_jax(variables)


def test_drain_completes_admitted_rejects_new(small_weights):
    server = StereoServer(SMALL, small_weights,
                          ServeConfig(max_batch=2, default_iters=ITERS,
                                      linger_s=0.05), device="cpu")
    handles = [server.submit(*_pair(40 + i)) for i in range(4)]
    server.request_drain()
    with pytest.raises(ServerDraining):
        server.submit(*_pair(45))
    assert all(h.result(timeout=120).ok for h in handles)
    assert server.join(timeout=120)
    stats = server.stats()
    assert stats["queue_depth"] == 0 and stats["in_flight"] == 0
    assert stats["rejected"] == 1 and stats["stopped"]


class _Failing:
    """A dispatch whose retire raises (a device fault surfaces there)."""

    def ready(self):
        return True

    def result(self):
        raise RuntimeError("synthetic device fault at retire")


class _Done:
    def __init__(self, outputs):
        self.outputs = outputs

    def ready(self):
        return True

    def result(self):
        return self.outputs


class _StubCache:
    """Stands in for ExecutableCache: ``mode`` "raise" fails the dispatch
    call, "retire" fails at retire, "ok" returns finite outputs."""

    def __init__(self, mode):
        self.mode = mode

    def __len__(self):
        return 1

    def __call__(self, key, im1, im2, flow_init=None, keep=()):
        if self.mode == "raise":
            raise RuntimeError("synthetic dispatch failure")
        if self.mode == "retire":
            return _Failing()
        b, h, w, _ = im1.shape
        return _Done((np.zeros((b, h // 4, w // 4, 2), np.float32),
                      np.full((b, h, w, 1), 7.0, np.float32),
                      np.ones((b,), bool)))


def test_dispatch_failures_fail_batch_not_scheduler(tmp_path, small_weights):
    tel = Telemetry(str(tmp_path / "run"), stall_deadline_s=None,
                    device="cpu")
    server = StereoServer(SMALL, small_weights,
                          ServeConfig(max_batch=2, default_iters=ITERS,
                                      linger_s=0.2, slo_every=2),
                          device="cpu", telemetry=tel, autostart=False)
    server.cache = _StubCache("raise")
    server.start()
    for mode, where in (("raise", "synthetic dispatch failure"),
                        ("retire", "synthetic device fault at retire")):
        server.cache = _StubCache(mode)
        handles = [server.submit(*_pair(60 + i)) for i in range(2)]
        results = [h.result(timeout=60) for h in handles]
        assert [r.batch_size for r in results] == [2, 2]
        assert all(not r.ok and r.error_kind == "dispatch"
                   and where in r.error and "RuntimeError" in r.traceback
                   for r in results)
    server.cache = _StubCache("ok")
    res = server.submit(*_pair(62)).result(timeout=60)
    assert res.ok and float(res.flow.max()) == 7.0
    server.request_drain()
    assert server.join(timeout=60)
    tel.close()
    assert check_path(str(tmp_path / "run")) == []


def test_warmup_runs_in_the_scheduler_thread(small_weights):
    """A running server warms its buckets up in the scheduler thread
    (cuDNN and cuBLAS state is per thread); an unstarted one inline."""
    threads = []
    for start in (True, False):
        server = StereoServer(SMALL, small_weights,
                              ServeConfig(max_batch=2, default_iters=1),
                              device="cpu", autostart=start)
        warmup = server.cache.warmup

        def recording(keys, warmup=warmup):
            threads.append(threading.current_thread().name)
            return warmup(keys)

        server.cache.warmup = recording
        assert server.warmup([(H, W)], batch_sizes=(1, 2)) == 2
        assert server.warmup([(40, 80)], batch_sizes=(1, 2)) == 0
        assert len(server.cache) == 2
        assert server.close(timeout=60)
    assert threads == ["serve-scheduler"] * 2 + ["MainThread"] * 2


def test_drain_on_unstarted_server_completes_inline(small_weights):
    server = StereoServer(SMALL, small_weights,
                          ServeConfig(max_batch=2, default_iters=ITERS),
                          device="cpu", autostart=False)
    server.cache = _StubCache("ok")
    handles = [server.submit(*_pair(70 + i)) for i in range(3)]
    assert server.close(timeout=60)
    assert all(h.result(timeout=5).ok for h in handles)


def test_run_clients_poisoned_loses_nothing_and_lints(tmp_path,
                                                      small_weights):
    """The load generator with a poisoned request: exactly that one fails,
    none is lost; the run's events.jsonl (request/queue/slo/converge
    records and the request span trees) lints clean under the JAX
    package's check_path."""
    from raft_stereo_tpu_torch.serve.loadtest import (LoadTestConfig,
                                                      run_clients)
    run = str(tmp_path / "serve")
    tel = Telemetry(run, stall_deadline_s=None, device="cpu")
    Tracer(tel)
    tel.run_start(config={"mode": "loadtest-serve"})
    server = StereoServer(SMALL, small_weights,
                          ServeConfig(max_batch=4, default_iters=1,
                                      linger_s=0.02, slo_every=4),
                          device="cpu", telemetry=tel)
    lt = LoadTestConfig(shapes=((48, 96), (64, 64), (32, 96)), clients=4,
                        requests_per_client=3, iters=1, poison_at=4,
                        progress=False)
    tally = run_clients(server, lt, tel)
    server.request_drain()
    assert server.join(timeout=120)
    tel.emit("run_end", steps=server.slo.completed, ok=True)
    tel.close()
    assert tally["lost"] == 0 and tally["rejected"] == 0
    assert tally["ok"] == 11 and tally["failed"] == 1
    assert tally["poisoned_failed"] == 1
    assert check_path(run) == []
    events = [json.loads(line) for line in open(f"{run}/events.jsonl")]
    kinds = {e["event"] for e in events}
    assert {"request", "queue", "slo", "converge", "span"} <= kinds
    warm = [e for e in events if e["event"] == "request"
            and e.get("stream") == "video0"]
    assert len(warm) == 3 and all(e["bucket"].endswith("w") for e in warm)


def test_boundedqueue_blocks_and_wakes():
    q = BoundedQueue(1)
    assert q.put("a", timeout=0.05)
    got = []
    t = threading.Thread(target=lambda: got.append(q.put("b", timeout=5)))
    t.start()
    time.sleep(0.05)
    assert q.get() == "a"
    t.join(timeout=5)
    assert not t.is_alive() and got == [True] and q.get() == "b"
    q.close()
    with pytest.raises(QueueClosed):
        q.put("c")
    assert collect_group("x", q.get_nowait, q.push_front, 3, len) == ["x"]
