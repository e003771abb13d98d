"""The port's numerics taps (the sink and ``_tap_stats`` of nn/gru.py, the
model's ``numerics=True`` output, obs/numerics.py's ``taps_payload``)
against the JAX package's.

* ``_tap_stats`` on built tensors holding NaN, +/-Inf, bf16-saturating
  and subnormal values (fp32 and bf16): the counters equal JAX's, min,
  max and absmean within 1e-6 relative (and within bf16's smallest
  normal absolute, where XLA's CPU reductions flush a subnormal that
  PyTorch keeps);
* the sink: ``"NN:label"`` keys in trace order, ``#2`` on a repeat, no-op
  unarmed;
* tap labels and order equal to JAX's (read from ``jax.eval_shape`` of
  its forward) in the default config, the realtime preset (slow-fast
  pre-iterations, ``#2`` labels) and with ``fused_lookup=True`` (no
  ``corr_feats``);
* the default config's tap stacks in fp32 against JAX's on bridged
  weights: counters equal, min/max/absmean within 1e-4 relative (measured
  3.6e-6), and ``numerics=True`` leaves the flow bitwise unchanged;
* ``taps_payload`` equal to JAX's on the same stacks, poisoned or not.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_stereo_tpu.config import RAFTStereoConfig as JConfig
from raft_stereo_tpu.config import realtime_config as j_realtime
from raft_stereo_tpu.models.raft_stereo import create_model
from raft_stereo_tpu.nn import gru as jgru
from raft_stereo_tpu.obs import numerics as jnm
from raft_stereo_tpu_torch.models import RAFTStereo
from raft_stereo_tpu_torch.nn import gru as tgru
from raft_stereo_tpu_torch.obs import numerics as tnm
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

import torch_parity as tp
from torch_parity import torch_one_thread  # noqa: F401

ITERS = 3
STAT_RTOL = 1e-6
TAP_RTOL = 1e-4
SMALL = (32, 32, 32)


def _jax_stats(x):
    return np.asarray(jax.jit(jgru._tap_stats)(jnp.asarray(x)))


def _port_stats(x):
    return tgru._tap_stats(x).numpy()


def _built_tensors():
    rng = np.random.default_rng(3)
    base = rng.normal(0, 2, 4096).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 3.39e38, -3.4e38,
                        3.3895313892515355e38, 1e-41, -2e-39, 1e-45,
                        1.1754943508222875e-38, 0.0, -0.0], np.float32)
    poisoned = base.copy()
    poisoned[::97] = special[np.arange(len(poisoned[::97])) % len(special)]
    return {"plain": base, "special": special, "poisoned": poisoned,
            "all_nan": np.full(16, np.nan, np.float32),
            "tiny": np.float32(1e-40) * rng.uniform(0, 1, 256).astype(
                np.float32)}


@pytest.mark.parametrize("name", ["plain", "special", "poisoned", "all_nan",
                                  "tiny"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tap_stats_match_jax(name, dtype):
    x = _built_tensors()[name].reshape(-1, 4)
    if dtype == "bfloat16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        j = jnp.asarray(x).astype(jnp.bfloat16)
    else:
        t, j = torch.from_numpy(x), jnp.asarray(x)
    got, want = _port_stats(t), _jax_stats(j)
    assert got.dtype == np.float32 and got.shape == (6,)
    # counters exactly; a count of a subnormal here would have been missed
    # by a float compare on a flushing device
    assert np.array_equal(got[3:], want[3:]), (got, want)
    # XLA's CPU reductions flush subnormals to zero and PyTorch's do not:
    # where a subnormal decides min, max or absmean the two differ by less
    # than bf16's smallest normal, the underflow rail itself
    assert np.allclose(got[:3], want[:3], rtol=STAT_RTOL,
                       atol=tnm.BF16_MIN_NORMAL, equal_nan=True), (got, want)
    if name == "all_nan":
        assert np.isposinf(got[0]) and np.isneginf(got[1])


def test_sink_labels_and_unarmed_identity():
    x = torch.ones(3)
    assert tgru.record_numerics_tap(x, "idle") is x
    assert not tgru.taps_armed()
    with tgru.numerics_taps() as sink:
        tgru.record_numerics_tap(x, "a")
        with tgru.numerics_taps() as inner:
            tgru.record_numerics_tap(x, "b")
        tgru.record_numerics_tap(x, "a")
        tgru.record_numerics_tap(x, "a")
    assert list(sink) == ["00:a", "01:a#2", "02:a#3"]
    assert list(inner) == ["00:b"]
    assert not tgru.taps_armed()
    assert (tnm.STAT_FIELDS, tnm.BF16_MAX_FINITE, tnm.BF16_MIN_NORMAL) == (
        jnm.STAT_FIELDS, jnm.BF16_MAX_FINITE, jnm.BF16_MIN_NORMAL)
    for key in ("03:gru32.zr", "gru", "x:y", "12:delta_flow#2"):
        assert tnm.split_label(key) == jnm.split_label(key)


def _pair(h, w, seed=0):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
    return left, np.roll(left, -3, axis=2)


def _jax_tap_keys(jcfg, h, w):
    variables = tp.jax_variables(jcfg, seed=0, image_shape=(1, h, w, 3))
    model = create_model(jcfg)
    left, right = _pair(h, w)
    out = jax.eval_shape(lambda v, a, b: model.apply(
        v, a, b, iters=ITERS, test_mode=True, numerics=True),
        variables, left, right)
    taps = out[-1]
    assert all(v.shape == (ITERS, 6) for v in taps.values())
    return sorted(taps), variables


@pytest.mark.parametrize("preset,hw", [("default", (32, 64)),
                                       ("realtime", (64, 128)),
                                       ("fused_lookup", (32, 352))])
def test_tap_labels_and_order_match_jax(preset, hw):
    jcfg = {"default": JConfig(hidden_dims=SMALL),
            "realtime": dataclasses.replace(j_realtime(), hidden_dims=SMALL),
            "fused_lookup": JConfig(hidden_dims=SMALL, fused_lookup=True,
                                    corr_implementation="reg_pallas")}[preset]
    want, variables = _jax_tap_keys(jcfg, *hw)
    model = RAFTStereo(tp.port_config(jcfg))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.eval()
    left, right = _pair(*hw)
    with torch.inference_mode():
        out = model(torch.from_numpy(left), torch.from_numpy(right),
                    iters=ITERS, numerics=True)
    taps = out[-1]
    assert list(taps) == want
    assert all(tuple(v.shape) == (ITERS, 6) for v in taps.values())
    labels = [tnm.split_label(k)[1] for k in taps]
    if preset == "fused_lookup":
        assert "corr_feats" not in labels and len(labels) == 7
    elif preset == "realtime":
        assert labels == ["corr_feats", "gru16.zr", "gru16.q", "gru16.zr#2",
                          "gru16.q#2", "gru08.zr", "gru08.q", "delta_flow"]
    else:
        assert labels == ["corr_feats", "gru32.zr", "gru32.q", "gru16.zr",
                          "gru16.q", "gru08.zr", "gru08.q", "delta_flow"]


@pytest.fixture(scope="module")
def default_taps():
    """The default architecture (hidden 32x3, fp32) with numerics on, JAX
    and the port, on bridged weights; with the converge output too, so
    the dict is checked to ride last behind it."""
    jcfg = JConfig(hidden_dims=SMALL)
    variables = tp.jax_variables(jcfg, seed=5, image_shape=(2, 32, 64, 3))
    left, right = _pair(32, 64, seed=6)
    left, right = np.concatenate([left, right]), np.concatenate([right, left])
    model = create_model(jcfg)
    jout = jax.jit(lambda v, a, b: model.apply(
        v, a, b, iters=ITERS, test_mode=True, iter_metrics="per_sample",
        numerics=True))(variables, left, right)
    port = RAFTStereo(tp.port_config(jcfg))
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    port.eval()
    with torch.inference_mode():
        a, b = torch.from_numpy(left), torch.from_numpy(right)
        out = port(a, b, iters=ITERS, iter_metrics="per_sample",
                   numerics=True)
        plain = port(a, b, iters=ITERS)
    return out, plain, jout


def test_default_taps_match_jax(default_taps, record_property):
    out, plain, jout = default_taps
    taps, jtaps = out[-1], jout[-1]
    assert len(out) == 4 and list(taps) == sorted(jtaps)
    worst = 0.0
    for k, v in taps.items():
        got, want = v.numpy(), np.asarray(jtaps[k])
        assert np.array_equal(got[:, 3:], want[:, 3:]), k
        dev = np.abs(got[:, :3] - want[:, :3]) / np.maximum(
            np.abs(want[:, :3]), 1e-6)
        worst = max(worst, float(dev.max()))
    record_property("tap_rel_dev", worst)
    assert worst <= TAP_RTOL
    # numerics leaves the flows and the curves bitwise as they were
    assert torch.equal(out[1], plain[1]) and torch.equal(out[0], plain[0])
    assert tp.max_abs(out[2].numpy(), jout[2]) <= 1e-4


def test_taps_payload_matches_jax(default_taps):
    out, _, _ = default_taps
    taps = {k: v.numpy() for k, v in out[-1].items()}
    poisoned = {k: v.copy() for k, v in taps.items()}
    poisoned["05:gru08.zr"][1, 3] = 7.0
    poisoned["05:gru08.zr"][1, 0] = np.nan
    poisoned["07:delta_flow"][1, 3] = 2.0
    poisoned["02:gru32.q"][2, 4] = 1.0
    for stacks in (taps, poisoned, {"00:x": taps["00:corr_feats"][0]}, {}):
        for kw in ({}, {"bucket": "32x64", "frame": 3}):
            got = tnm.taps_payload("eval:kitti", stacks, **kw)
            assert got == jnm.taps_payload("eval:kitti", stacks, **kw)
            if got is not None:
                assert tnm.alarm(got) == jnm.alarm(got)
    assert tnm.taps_payload("e", poisoned)["first_nonfinite"] == {
        "tap": "gru08.zr", "iter": 1, "count": 7}
