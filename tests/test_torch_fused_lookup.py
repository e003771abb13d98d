"""The fused lookup+convc1 (``fused_lookup=True``) of the PyTorch port held
to the JAX package's on the CPU.

Inputs are made with numpy from a seed and fed to both frameworks. The
plain versions (the CPU side of the ``fused_lookup`` CUDA kernels) are held
to ``fused_lookup_c1`` run under ``jax.jit`` in interpret mode, as
tests/test_fused_lookup.py runs it, and to its hand-written backward by
``jax.vjp``. Each test records its measured deviation as a junit property.
Bounds, with what these inputs measured when the bound was set:

* plain forward: 1e-6 abs with an fp32 compute dtype (the 36-term product
  is summed in another order; measured <= 9.5e-7); with bf16 within one
  bf16 ulp of the JAX value or 1e-6 abs, whichever is larger (both round
  one fp32 sum once; measured bitwise equal);
* plain backward: each ``dvol`` as the forward, in the volume's dtype
  (measured <= 9.5e-7 from fp32 volumes; bf16 volumes bitwise but for one
  element one bf16 ulp apart); ``dk`` and ``db`` 1e-6 of their largest
  magnitude (fp32 sums over every pixel in another order; measured <=
  2.8e-7); the coordinates' cotangent is None (the port) and 0 (JAX);
* ``fused_lookup_applicable`` equal to JAX's on shapes inside its VMEM
  budget;
* the model with ``fused_lookup=True`` against the JAX model on the same
  weights: test mode 1e-3 px on ``flow_up`` (measured 4.0e-5 px of a
  12 px field), train mode 1e-3 px (measured 2.3e-5), and one step's
  gradients under the null-floor rule of tests/test_torch_training.py (8
  JAX-vs-JAX null runs, weights x (1 + 1e-6 N(0, 1)); measured: all
  gradients 1.0e-4 against null runs of 2.0e-4 to 8.4e-4, leaf score 0.34
  against null scores up to 1.49);
* the port's fused path against its own unfused path: 1e-4 px (measured
  1.9e-5).

The model tests run at 32x352 (1/4-resolution grid 8x88, pyramid widths
88/44/22/11): the narrowest size at which every level is wider than the
2r+2 = 10-tap window, so the gate engages in both packages.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_stereo_tpu.config import RAFTStereoConfig as JConfig
from raft_stereo_tpu.inference import StereoPredictor as JPredictor
from raft_stereo_tpu.models.raft_stereo import create_model
from raft_stereo_tpu.ops.pallas.lookup_kernels import \
    fused_lookup_applicable as j_applicable
from raft_stereo_tpu.ops.pallas.lookup_kernels import fused_lookup_c1 as j_flc
from raft_stereo_tpu.training import loss as jloss

from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch import config as tconfig
from raft_stereo_tpu_torch.inference import StereoPredictor
from raft_stereo_tpu_torch.models import RAFTStereo
from raft_stereo_tpu_torch.ops.corr import init_corr
from raft_stereo_tpu_torch.ops.kernels import fused_lookup as fl
from raft_stereo_tpu_torch.ops.kernels.windowed_sample import windowed_sample
from raft_stereo_tpu_torch.training.state import loss_and_grads
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

from torch_parity import (flat, jax_variables, max_abs, null_gate, perturbed,
                          port_config)

SMALL = (32, 32, 32)
B, H, W = 1, 32, 352
ITERS = 2
NULL_RUNS = 8
ROUNDOFF_REL = 1e-7
BF16_ULP = 2.0 ** -7
TOL = 1e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -------------------------------------------------------------- the kernel

# (name, radius, (B, H, W1, level-0 W2)): every level wider than 2r+2, the
# JAX kernel's own requirement
CASES = [("r4", 4, (2, 4, 96, 96)), ("r1", 1, (2, 3, 40, 40))]


def _inputs(shape, radius, seed):
    b, h, w1, w2 = shape
    rng = np.random.default_rng(seed)
    levels = [rng.normal(size=(b, h, w1, w2 >> i)).astype(np.float32)
              for i in range(4)]
    coords = rng.uniform(-3, w2 + 3, size=(b, h, w1)).astype(np.float32)
    # integer, boundary and far-out centers (finite: JAX's floor(NaN) ->
    # int is implementation-defined)
    edge = [0.0, -1.0, float(w2 - 1), float(w2), -radius - 0.5, 1e9, -1e9,
            0.999999]
    coords.reshape(-1)[:len(edge)] = edge
    channels = 4 * (2 * radius + 1)
    kern = (rng.normal(size=(channels, 64)) * 0.2).astype(np.float32)
    bias = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    return levels, coords, kern, bias


def _close(got, want, dtype, record_property=None, key="max_abs"):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if record_property is not None:
        record_property(key, max_abs(got, want))
    bound = TOL if dtype == "float32" else np.maximum(
        np.abs(want) * BF16_ULP, TOL)
    return bool(np.all(np.abs(got - want) <= bound))


def _rel_close(got, want, record_property, key):
    dev = max_abs(got, want) / max(float(np.abs(want).max()), 1e-30)
    record_property(key, dev)
    return dev <= TOL


@functools.lru_cache(maxsize=None)
def _jax_flc(radius, dt):
    jdt = getattr(jnp, dt)
    return jax.jit(lambda lv, c, k, b: j_flc(tuple(lv), c, k, b, radius,
                                             jdt))


@functools.lru_cache(maxsize=None)
def _jax_flc_vjp(radius, dt):
    jdt = getattr(jnp, dt)

    def vjp(lv, c, k, b, g):
        _, f = jax.vjp(lambda a, x, y, z: j_flc(tuple(a), x, y, z, radius,
                                                jdt), lv, c, k, b)
        return f(g)
    return jax.jit(vjp)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("vdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,radius,shape", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_forward_matches_jax(name, radius, shape, vdt, dt,
                                   record_property):
    levels, coords, kern, bias = _inputs(shape, radius, seed=radius)
    tv, jv = getattr(torch, vdt), getattr(jnp, vdt)
    got = fl.fused_lookup_c1_plain([_t(v).to(tv) for v in levels],
                                   _t(coords), _t(kern), _t(bias), radius,
                                   getattr(torch, dt))
    want = _jax_flc(radius, dt)([jnp.asarray(v, jv) for v in levels],
                                jnp.asarray(coords), jnp.asarray(kern),
                                jnp.asarray(bias))
    assert got.dtype == getattr(torch, dt)
    assert tuple(got.shape) == want.shape == shape[:3] + (64,)
    assert _close(got.float().numpy(), np.asarray(want, np.float32), dt,
                  record_property)
    # far-out centers look up zeros: the output is relu(bias)
    far = got.float().numpy().reshape(-1, 64)[5:7]
    assert np.all(far == np.maximum(bias, 0).astype(
        np.asarray(want).dtype).astype(np.float32))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("vdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,radius,shape", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_backward_matches_jax(name, radius, shape, vdt, dt,
                                    record_property):
    levels, coords, kern, bias = _inputs(shape, radius, seed=radius + 10)
    g = np.random.default_rng(radius).normal(
        size=shape[:3] + (64,)).astype(np.float32)
    tv, jv = getattr(torch, vdt), getattr(jnp, vdt)
    tdt, jdt = getattr(torch, dt), getattr(jnp, dt)
    dvols, dk, db = fl.fused_lookup_c1_backward_plain(
        [_t(v).to(tv) for v in levels], _t(coords), _t(kern), _t(bias),
        _t(g).to(tdt), radius, tdt)
    w_dvols, dc, w_dk, w_db = _jax_flc_vjp(radius, dt)(
        [jnp.asarray(v, jv) for v in levels], jnp.asarray(coords),
        jnp.asarray(kern), jnp.asarray(bias), jnp.asarray(g, jdt))
    assert not np.any(np.asarray(dc))  # JAX: no coords gradient
    for i, (got, want) in enumerate(zip(dvols, w_dvols)):
        assert got.dtype == tv and tuple(got.shape) == want.shape
        assert _close(got.float().numpy(), np.asarray(want, np.float32),
                      vdt, record_property, f"max_abs_dvol{i}")
    assert dk.dtype == db.dtype == torch.float32
    assert _rel_close(dk.numpy(), np.asarray(w_dk), record_property,
                      "rel_dk")
    assert _rel_close(db.numpy(), np.asarray(w_db), record_property,
                      "rel_db")
    assert np.abs(dvols[3].float().numpy()).max() > 0


def test_applicable_matches_jax():
    def pyramid(b, h, w, w2, n=4, step=lambda i, w2: w2 >> i):
        return [np.zeros((b, h, w, step(i, w2)), np.float32)
                for i in range(n)]
    cases = [(pyramid(1, 8, 88, 88), 4), (pyramid(1, 8, 80, 80), 4),
             (pyramid(2, 4, 40, 40), 1), (pyramid(2, 4, 24, 24), 1),
             (pyramid(1, 8, 88, 88, n=3), 4),
             ([np.zeros((1, 8, 88, 88)), np.zeros((1, 8, 87, 44)),
               np.zeros((1, 8, 88, 22)), np.zeros((1, 8, 88, 11))], 4),
             (pyramid(1, 16, 312, 312), 4), (pyramid(1, 6, 156, 156), 4)]
    for levels, radius in cases:
        want = j_applicable([jnp.asarray(v) for v in levels], radius)
        assert fl.fused_lookup_applicable([_t(v) for v in levels],
                                          radius) == want
    assert [fl.fused_lookup_applicable([_t(v) for v in c[0]], c[1])
            for c in cases] == [True, False, True, False, False, False,
                                True, True]


def test_wrapper_takes_plain_path_on_cpu_and_gives_coords_no_grad():
    levels, coords, kern, bias = _inputs((1, 2, 48, 48), 4, seed=3)
    lv = [_t(v).requires_grad_() for v in levels]
    tc = _t(coords).requires_grad_()
    # convc1's weight viewed as the (36, 64) matrix, as the encoder does
    weight = _t(kern.T.reshape(64, 36, 1, 1).copy()).requires_grad_()
    tk = weight.view(64, -1).t()
    tb = _t(bias).requires_grad_()
    before = (fl.fused_lookup_c1.launches, fl.fused_lookup_c1.bwd_launches)
    out = fl.fused_lookup_c1(lv, tc, tk, tb, 4)
    ct = _t(np.random.default_rng(4).normal(size=out.shape).astype(
        np.float32))
    grads = torch.autograd.grad(out, (*lv, tc, weight, tb), ct,
                                allow_unused=True)
    assert (fl.fused_lookup_c1.launches,
            fl.fused_lookup_c1.bwd_launches) == before
    assert torch.equal(out, fl.fused_lookup_c1_plain(
        [_t(v) for v in levels], _t(coords), _t(kern), _t(bias), 4))
    dvols, dk, db = fl.fused_lookup_c1_backward_plain(
        [_t(v) for v in levels], _t(coords), _t(kern), _t(bias), ct, 4)
    assert all(torch.equal(a, b) for a, b in zip(grads[:4], dvols))
    assert grads[4] is None
    assert torch.equal(grads[5], dk.t().reshape(64, 36, 1, 1))
    assert torch.equal(grads[6], db)


def test_wrapper_never_falls_back_off_cpu():
    levels = [torch.empty((1, 2, 48, 48 >> i), device="meta")
              for i in range(4)]
    c = torch.empty((1, 2, 48), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fl.fused_lookup_c1(levels, c, torch.empty((36, 64), device="meta"),
                           torch.empty((64,), device="meta"), 4)


# ----------------------------------------------------- model and the gate


def test_config_and_cli():
    assert tconfig.RAFTStereoConfig().fused_lookup is None
    for value in (None, True, False):
        cfg = port_config(JConfig(fused_lookup=value))
        assert cfg.fused_lookup is value
    parser = cli.build_demo_parser()
    for flag, value in (("on", True), ("off", False), ("auto", None)):
        args = parser.parse_args(["--restore_ckpt", "x.pth", "-l", "a",
                                  "-r", "b", "--corr_implementation",
                                  "reg_cuda", "--fused_lookup", flag])
        assert cli.model_config(args) == tconfig.RAFTStereoConfig(
            corr_implementation="reg_cuda", fused_lookup=value)


def test_gate_follows_jax():
    # engaged for the volume pyramids at a shape that fits, never for the
    # feature pyramids, never unless asked for
    rng = np.random.default_rng(5)
    f1 = _t(rng.normal(size=(1, 8, 88, 16)).astype(np.float32))
    f2 = _t(rng.normal(size=(1, 8, 88, 16)).astype(np.float32))
    narrow = [_t(rng.normal(size=(1, 8, 40, 16)).astype(np.float32))] * 2
    for impl, fused, want in [("reg", True, True), ("reg_cuda", True, True),
                              ("reg", None, False), ("reg", False, False),
                              ("alt_pallas", True, False),
                              ("alt_cuda", True, False)]:
        model = RAFTStereo(tconfig.RAFTStereoConfig(
            hidden_dims=SMALL, corr_implementation=impl, fused_lookup=fused))
        state = init_corr(model.cfg.corr_implementation, f1, f2)
        assert model.uses_fused_lookup(state) is want, (impl, fused)
    model = RAFTStereo(tconfig.RAFTStereoConfig(hidden_dims=SMALL,
                                                fused_lookup=True))
    assert not model.uses_fused_lookup(init_corr("reg", *narrow))


def _pair(seed):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    right = np.clip(np.roll(left, -5, axis=2) + rng.normal(0, 4, left.shape),
                    0, 255).astype(np.float32)
    return left, right


@pytest.fixture(scope="module")
def small():
    jcfg = JConfig(hidden_dims=SMALL, fused_lookup=True)
    return jcfg, jax_variables(jcfg, seed=81, image_shape=(B, H, W, 3))


def _port_model(jcfg, variables):
    model = RAFTStereo(port_config(jcfg))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


@pytest.mark.parametrize("impl", ["reg", "reg_cuda"])
def test_test_mode_forward_matches_jax_and_unfused(small, impl,
                                                   record_property):
    _, v = small
    jcfg = JConfig(hidden_dims=SMALL, fused_lookup=True,
                   corr_implementation=impl)
    left, right = _pair(82)
    want = JPredictor(jcfg, v, valid_iters=3)(left, right)
    before = fl.fused_lookup_c1.launches
    pred = StereoPredictor(port_config(jcfg), state_dict_from_jax(v),
                           valid_iters=3, device="cpu")
    got = pred(left, right)
    assert fl.fused_lookup_c1.launches == before  # CPU: the plain version
    assert got.shape == want.shape == (B, H, W, 1)
    record_property("max_abs_px", max_abs(got, want))
    record_property("max_abs_flow_px", float(np.abs(want).max()))
    assert max_abs(got, want) <= 1e-3
    # the port's own unfused path on the same weights
    off = StereoPredictor(port_config(JConfig(
        hidden_dims=SMALL, fused_lookup=False, corr_implementation=impl)),
        state_dict_from_jax(v), valid_iters=3, device="cpu")(left, right)
    record_property("max_abs_px_vs_unfused", max_abs(got, off))
    assert max_abs(got, off) <= 1e-4


@pytest.fixture(scope="module")
def jax_grads(small):
    jcfg, v = small
    model = create_model(jcfg)
    left, right = _pair(83)
    rng = np.random.default_rng(84)
    batch = dict(image1=left, image2=right,
                 flow=-rng.uniform(0, 12, (B, H, W, 1)).astype(np.float32),
                 valid=(rng.uniform(size=(B, H, W)) > 0.1).astype(
                     np.float32))

    def loss_fn(params):
        preds = model.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            batch["image1"], batch["image2"], iters=ITERS)
        loss, _ = jloss.sequence_loss(preds, batch["flow"], batch["valid"])
        return loss, preds

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    (loss, preds), grads = fn(v["params"])
    nulls = [to_np(fn(perturbed(v["params"], 91 + i))[1])
             for i in range(NULL_RUNS)]
    return batch, float(loss), np.asarray(preds), to_np(grads), nulls


def test_train_forward_matches_jax(small, jax_grads, record_property):
    jcfg, v = small
    batch, _, want, _, _ = jax_grads
    with torch.no_grad():
        got = _port_model(jcfg, v)(_t(batch["image1"]), _t(batch["image2"]),
                                   iters=ITERS, test_mode=False).numpy()
    assert got.shape == want.shape == (ITERS, B, H, W, 1)
    record_property("max_abs_px", max_abs(got, want))
    assert max_abs(got, want) <= 1e-3


def test_step_gradients_match_jax(small, jax_grads, record_property):
    jcfg, v = small
    batch, want_loss, _, want, null_grads = jax_grads
    model = _port_model(jcfg, v)
    before = (fl.fused_lookup_c1.launches, fl.fused_lookup_c1.bwd_launches,
              windowed_sample.launches)
    loss, _, grads = loss_and_grads(model, batch, ITERS)
    assert (fl.fused_lookup_c1.launches, fl.fused_lookup_c1.bwd_launches,
            windowed_sample.launches) == before  # CPU: the plain versions
    named = {n: g.numpy() for (n, _), g in zip(model.named_parameters(),
                                               grads)}
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
    # convc1 and the feature encoder get their gradients through the
    # fused kernel's backward
    for prefix in ("update_block.encoder.convc1.", "fnet."):
        leaves = [g for (n, _), g in zip(model.named_parameters(), grads)
                  if n.startswith(prefix)]
        assert leaves and all(float(g.abs().max()) > 0 for g in leaves)
