"""PyTorch port's layers, encoders, update block, weight bridge and the
whole test-mode forward, held to the JAX package on the same weights.

Weights are a seeded numpy JAX tree (tests/torch_parity.py) bridged with
``state_dict_from_jax``; inputs are seeded numpy arrays. Each parity test
records its measured deviation as a junit property (``--junitxml``).
Bounds, with what these inputs measured when the bound was set:

* modules in fp32: max abs deviation <= 5e-5 of max(1, max |output|)
  (measured <= 6.1e-6; the port runs upstream's concat convs and two-pass
  norms where the JAX package splits its gate convs and takes one-pass
  moments).
* whole forward in fp32 (default architecture with ``reg_pallas``, where
  JAX reaches its Pallas kernel in interpret mode, and the realtime
  architecture forced to fp32): 1e-3 px on both flows (measured 2.5e-5 px
  and 2.1e-4 px on ``flow_up``, whose largest values are 8.7 and 18.0 px).
* realtime in bf16 against JAX in bf16: the two frameworks round bf16 at
  other places, so the bound is relative to the fp32 result's scale:
  max |flow_up difference| <= 0.1 * max |flow_up| (measured 0.37 px of
  18.0 px, 2.0%), and no worse than 2x either framework's own bf16-vs-fp32
  deviation (measured 0.61 and 0.65 px).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_stereo_tpu.config import RAFTStereoConfig as JConfig
from raft_stereo_tpu.config import realtime_config as j_realtime
from raft_stereo_tpu.config import rvc_config as j_rvc
from raft_stereo_tpu.inference import StereoPredictor as JPredictor
from raft_stereo_tpu.models.raft_stereo import create_model
from raft_stereo_tpu.nn import encoder as jenc
from raft_stereo_tpu.nn import layers as jlayers
from raft_stereo_tpu.nn.gru import BasicMultiUpdateBlock as JUpdateBlock
from raft_stereo_tpu.utils.checkpoint_convert import (
    convert_state_dict, convert_to_torch_state_dict,
    validate_against_variables)

from raft_stereo_tpu_torch import cli as tcli
from raft_stereo_tpu_torch import config as tconfig
from raft_stereo_tpu_torch.inference import StereoPredictor
from raft_stereo_tpu_torch.models import RAFTStereo
from raft_stereo_tpu_torch.nn import encoder as tenc
from raft_stereo_tpu_torch.nn import layers as tlayers
from raft_stereo_tpu_torch.nn.gru import BasicMultiUpdateBlock
from raft_stereo_tpu_torch.utils.weights import (load_reference_checkpoint,
                                                 state_dict_from_jax)

from torch_parity import (jax_variables, max_abs, module_variables,
                          port_config, rel_dev)

SMALL = (32, 32, 32)
IMG = (1, 64, 128, 3)
ITERS = 3
# fp32 modules: max abs deviation over max(1, max |JAX output|)
MODULE_TOL = 5e-5


def _loaded(module: torch.nn.Module, variables) -> torch.nn.Module:
    module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return module.eval()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _stereo_pair(shape, seed):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, shape).astype(np.float32)
    right = np.roll(left, -3, axis=2)
    right = np.clip(right + rng.normal(0, 4, shape), 0, 255).astype(
        np.float32)
    return left, right


# ------------------------------------------------------------------ config


def test_config_aliases_and_refusals():
    assert tconfig.RAFTStereoConfig(
        corr_implementation="reg_cuda").corr_implementation == "reg_pallas"
    assert tconfig.CORR_ALIASES == __import__(
        "raft_stereo_tpu.config", fromlist=["x"]).CORR_ALIASES
    for name in ("fused", "alt_cuda", "fused_cuda", "memoryless"):
        assert tconfig.RAFTStereoConfig(
            corr_implementation=name).corr_implementation == "fused"
    for name in ("alt", "alt_pallas"):
        assert tconfig.RAFTStereoConfig(
            corr_implementation=name).corr_implementation == name
    with pytest.raises(ValueError, match="not ported"):
        tconfig.RAFTStereoConfig(corr_implementation="ring")
    with pytest.raises(ValueError, match="unknown corr_implementation"):
        tconfig.RAFTStereoConfig(corr_implementation="nope")
    with pytest.raises(ValueError, match="hidden_dims"):
        tconfig.RAFTStereoConfig(hidden_dims=(64, 128, 128))
    with pytest.raises(ValueError):
        tconfig.RAFTStereoConfig(n_gru_layers=4)


@pytest.mark.parametrize("preset", ["realtime", "rvc", "default"])
def test_config_presets_match_jax(preset):
    j = {"realtime": j_realtime, "rvc": j_rvc, "default": JConfig}[preset]()
    t = {"realtime": tconfig.realtime_config, "rvc": tconfig.rvc_config,
         "default": tconfig.RAFTStereoConfig}[preset]()
    assert t == port_config(j)
    assert (t.factor, t.corr_channels) == (j.factor, j.corr_channels)


def test_cli_flags_build_config():
    p = tcli.build_demo_parser()
    args = p.parse_args(["--restore_ckpt", "x.pth", "-l", "a", "-r", "b",
                         "--corr_implementation", "reg_cuda",
                         "--shared_backbone", "--n_downsample", "3",
                         "--n_gru_layers", "2", "--slow_fast_gru",
                         "--mixed_precision", "--no_remat"])
    # --no_remat sets remat_refinement=False, as the JAX package's
    # model_config does (it steers only the training forward)
    assert tcli.model_config(args) == dataclasses.replace(
        tconfig.realtime_config(), remat_refinement=False)
    assert args.device == "cuda"
    args = p.parse_args(["--restore_ckpt", "x", "-l", "a", "-r", "b",
                         "--fused_lookup", "on"])
    assert tcli.model_config(args).fused_lookup is True


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("norm_fn", ["batch", "group", "instance", "none"])
@pytest.mark.parametrize("in_planes,planes,stride", [(32, 32, 1),
                                                     (32, 64, 2)])
def test_residual_block(norm_fn, in_planes, planes, stride, record_property):
    x = np.random.default_rng(0).normal(size=(2, 12, 20, in_planes)).astype(
        np.float32)
    jmod = jlayers.ResidualBlock(in_planes, planes, norm_fn, stride)
    v = module_variables(jmod, 1, jnp.asarray(x))
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    tmod = _loaded(tlayers.ResidualBlock(in_planes, planes, norm_fn, stride),
                   v)
    if stride != 1:  # the shortcut norm sits under both names
        keys = tmod.state_dict().keys()
        assert ("norm3.weight" in keys) == (norm_fn in ("batch", "group"))
        assert ("downsample.1.weight" in keys) == ("norm3.weight" in keys)
    with torch.no_grad():
        got = tmod(_t(x)).numpy()
    record_property("rel_dev", rel_dev(got, want))
    assert got.shape == want.shape and rel_dev(got, want) <= MODULE_TOL


@pytest.mark.parametrize("kind,kwargs,call", [
    ("basic", dict(output_dim=256, norm_fn="instance", downsample=2), {}),
    ("basic", dict(output_dim=256, norm_fn="instance", downsample=3), {}),
    ("multi", dict(norm_fn="batch", downsample=2), dict(num_layers=3)),
    ("multi", dict(norm_fn="group", downsample=3),
     dict(num_layers=2, dual_inp=True)),
    ("multi", dict(norm_fn="instance", downsample=2), dict(num_layers=3)),
    ("multi", dict(norm_fn="none", downsample=2), dict(num_layers=1)),
], ids=["fnet-ds2", "fnet-ds3", "cnet-batch-3", "cnet-group-2-dual",
        "cnet-instance-3", "cnet-none-1"])
def test_encoders(kind, kwargs, call, record_property):
    x = np.random.default_rng(2).normal(size=(2, 32, 64, 3)).astype(
        np.float32)
    if kind == "basic":
        jmod, tmod = jenc.BasicEncoder(**kwargs), tenc.BasicEncoder(**kwargs)
    else:
        dims = (SMALL, SMALL)
        jmod = jenc.MultiBasicEncoder(output_dim=dims, **kwargs)
        tmod = tenc.MultiBasicEncoder(output_dim=dims,
                                      num_layers=call["num_layers"],
                                      **kwargs)
    v = module_variables(jmod, 3, jnp.asarray(x), **call)
    want = jax.tree_util.tree_leaves(jmod.apply(v, jnp.asarray(x), **call))
    tmod = _loaded(tmod, v)
    with torch.no_grad():
        got = tmod(_t(x), dual_inp=call.get("dual_inp", False)) \
            if kind == "multi" else tmod(_t(x))
    got = [g.numpy() for g in jax.tree_util.tree_leaves(
        got, is_leaf=lambda a: isinstance(a, torch.Tensor))]
    assert [g.shape for g in got] == [w.shape for w in want]
    devs = [rel_dev(g, w) for g, w in zip(got, want)]
    record_property("rel_dev", max(devs))
    assert max(devs) <= MODULE_TOL


# ------------------------------------------------------------ update block


@pytest.mark.parametrize("n_layers,flags", [
    (3, dict()),
    (3, dict(compute_mask=False)),
    (3, dict(iter32=True, iter16=False, iter08=False, update=False)),
    (3, dict(iter32=True, iter16=True, iter08=False, update=False)),
    (2, dict(iter32=False)),
    (2, dict(iter32=False, iter16=True, iter08=False, update=False)),
    (1, dict(iter32=False, iter16=False)),
])
def test_update_block(n_layers, flags, record_property):
    cfg = JConfig(hidden_dims=SMALL, n_gru_layers=n_layers)
    rng = np.random.default_rng(4)
    h, w = 8, 16
    net = [rng.normal(size=(1, h >> i, w >> i, 32)).astype(np.float32)
           for i in range(3)]
    inp = [tuple(rng.normal(size=(1, h >> i, w >> i, 32)).astype(np.float32)
                 for _ in range(3)) for i in range(3)]
    corr = rng.normal(size=(1, h, w, cfg.corr_channels)).astype(np.float32)
    flow = np.concatenate([rng.normal(size=(1, h, w, 1)),
                           np.zeros((1, h, w, 1))], -1).astype(np.float32)
    jblock = JUpdateBlock(cfg)
    jargs = (tuple(map(jnp.asarray, net)),
             tuple(tuple(map(jnp.asarray, t)) for t in inp),
             jnp.asarray(corr), jnp.asarray(flow))
    v = module_variables(jblock, 5, *jargs, iter32=n_layers == 3,
                         iter16=n_layers >= 2)
    want = jblock.apply(v, *jargs, **flags)
    tblock = _loaded(BasicMultiUpdateBlock(port_config(cfg)), v)
    with torch.no_grad():
        got = tblock([_t(a) for a in net],
                     [tuple(map(_t, t)) for t in inp], _t(corr), _t(flow),
                     **flags)
    if not flags.get("update", True):
        got, want = (got, None, None), (want, None, None)
    devs = [rel_dev(g.numpy(), wt) for g, wt in zip(got[0], want[0])]
    if got[2] is not None:  # JAX computes only the x-delta (y is zeroed)
        devs.append(rel_dev(got[2][..., :1].numpy(), want[2][..., :1]))
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        devs.append(rel_dev(got[1].numpy(), want[1]))
    record_property("rel_dev", max(devs))
    assert max(devs) <= MODULE_TOL


# ------------------------------------------------------------ weight bridge


@pytest.mark.parametrize("preset", ["default", "realtime", "rvc"])
def test_weight_bridge(preset):
    jcfg = {"default": JConfig, "realtime": j_realtime, "rvc": j_rvc}[
        preset]()
    v = jax_variables(jcfg, seed=6)
    sd = state_dict_from_jax(v)
    ref = convert_to_torch_state_dict(v, data_parallel_prefix=False)
    assert sorted(sd) == sorted(ref)
    for k in ref:
        assert sd[k].dtype == ref[k].dtype and torch.equal(sd[k], ref[k]), k
    model = RAFTStereo(port_config(jcfg))
    model.load_state_dict(sd, strict=True)
    # and back: the port's state dict converts to the same JAX tree
    back = validate_against_variables(
        convert_state_dict(model.state_dict()), v, allow_unused=False)
    for (p1, a), (p2, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(v)[0]):
        assert p1 == p2
        np.testing.assert_array_equal(a, b)


def test_load_reference_checkpoint(tmp_path):
    jcfg = dataclasses.replace(j_realtime(), hidden_dims=SMALL)
    v = jax_variables(jcfg, seed=7)
    state = convert_to_torch_state_dict(v)  # 'module.'-prefixed
    assert all(k.startswith("module.") for k in state)
    # the reference also builds gru32/layer5/outputs32 at 2 GRU levels
    state["module.update_block.gru32.convz.weight"] = torch.zeros(1)
    state["module.cnet.layer5.0.conv1.weight"] = torch.zeros(1)
    state["module.cnet.outputs32.0.bias"] = torch.zeros(1)
    path = tmp_path / "raftstereo-realtime.pth"
    torch.save(state, path)
    cfg = port_config(jcfg)
    model = RAFTStereo(cfg)
    model.load_state_dict(load_reference_checkpoint(str(path), cfg),
                          strict=True)
    for k, val in state_dict_from_jax(v).items():
        assert torch.equal(model.state_dict()[k], val), k
    with pytest.raises(RuntimeError, match="Unexpected key"):
        RAFTStereo(cfg).load_state_dict(
            load_reference_checkpoint(str(path)), strict=True)


# ------------------------------------------------------- the whole forward


def _jax_forward(jcfg, v, left, right, dtype=None):
    model = create_model(jcfg, dtype)
    fn = jax.jit(lambda var, a, b: model.apply(var, a, b, iters=ITERS,
                                               test_mode=True))
    return [np.asarray(o, np.float32) for o in fn(v, left, right)]


def _port_forward(jcfg, v, left, right, dtype=None):
    model = _loaded(RAFTStereo(port_config(jcfg), dtype=dtype), v)
    with torch.inference_mode():
        out = model(_t(left), _t(right), iters=ITERS, test_mode=True)
    return [o.float().numpy() for o in out]


@pytest.fixture(scope="module")
def default_small():
    jcfg = JConfig(hidden_dims=SMALL, corr_implementation="reg_cuda")
    return jcfg, jax_variables(jcfg, seed=8, image_shape=IMG)


@pytest.fixture(scope="module")
def realtime_small():
    jcfg = dataclasses.replace(j_realtime(), hidden_dims=SMALL)
    v = jax_variables(jcfg, seed=9, image_shape=IMG)
    left, right = _stereo_pair(IMG, 10)
    fp32 = _jax_forward(jcfg, v, left, right, jnp.float32)
    return jcfg, v, left, right, fp32


def test_forward_default_reg_pallas(default_small, record_property):
    jcfg, v = default_small
    left, right = _stereo_pair(IMG, 11)
    want = _jax_forward(jcfg, v, left, right)
    got = _port_forward(jcfg, v, left, right)
    assert got[0].shape == (1, 16, 32, 2) and got[1].shape == (1, 64, 128, 1)
    assert np.all(got[0][..., 1] == 0.0)  # epipolar: y never moves
    record_property("max_abs_px", max_abs(got[1], want[1]))
    record_property("max_abs_flow_px", float(np.abs(want[1]).max()))
    assert max_abs(got[0], want[0]) <= 1e-3
    assert max_abs(got[1], want[1]) <= 1e-3
    assert np.abs(want[1]).max() > 0.1  # the comparison is not of zeros


def test_forward_realtime_fp32(realtime_small, record_property):
    jcfg, v, left, right, want = realtime_small
    got = _port_forward(jcfg, v, left, right, torch.float32)
    assert got[1].shape == (1, 64, 128, 1)
    record_property("max_abs_px", max_abs(got[1], want[1]))
    record_property("max_abs_flow_px", float(np.abs(want[1]).max()))
    assert max_abs(got[0], want[0]) <= 1e-3
    assert max_abs(got[1], want[1]) <= 1e-3
    assert np.abs(want[1]).max() > 0.1


def test_forward_realtime_bf16(realtime_small, record_property):
    jcfg, v, left, right, fp32 = realtime_small
    want = _jax_forward(jcfg, v, left, right)          # bf16 compute
    got = _port_forward(jcfg, v, left, right)          # bf16 compute
    port_fp32 = _port_forward(jcfg, v, left, right, torch.float32)
    assert np.all(np.isfinite(got[1]))
    scale = np.abs(fp32[1]).max()
    dev = max_abs(got[1], want[1])
    own = (max_abs(want[1], fp32[1]), max_abs(got[1], port_fp32[1]))
    record_property("max_abs_px", dev)
    record_property("fp32_scale_px", float(scale))
    record_property("jax_and_port_bf16_vs_fp32_px", own)
    assert dev <= 0.1 * scale
    assert dev <= 2 * max(own)


def test_forward_refusals(default_small):
    jcfg, v = default_small
    model = _loaded(RAFTStereo(port_config(jcfg)), v)
    x = torch.zeros(IMG)
    for test_mode in (True, False):  # train mode is ported (A9)
        with pytest.raises(ValueError, match="iters"):
            model(x, x, iters=0, test_mode=test_mode)
    with pytest.raises(ValueError, match="not ported"):
        port_config(dataclasses.replace(jcfg, remat_encoders=True))


def test_predictor_pads_and_unpads_like_jax(default_small, record_property):
    jcfg, v = default_small
    left, right = _stereo_pair((1, 50, 101, 3), 12)
    want = JPredictor(jcfg, v, valid_iters=ITERS)(left, right)
    pred = StereoPredictor(port_config(jcfg), state_dict_from_jax(v),
                           valid_iters=ITERS, device="cpu")
    got = pred(left, right)
    assert got.shape == want.shape == (1, 50, 101, 1)
    record_property("max_abs_px", max_abs(got, want))
    assert max_abs(got, want) <= 1e-3
    disp = pred.compute_disparity(left[0, ..., 0], right[0, ..., 0])
    assert disp.shape == (50, 101) and np.all(np.isfinite(disp))
    timed, secs = pred.predict_timed(left, right)
    np.testing.assert_array_equal(timed, got)
    assert secs > 0


def test_predictor_refuses_missing_card(default_small):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    jcfg, v = default_small
    with pytest.raises(RuntimeError, match="CUDA"):
        StereoPredictor(port_config(jcfg), state_dict_from_jax(v))


def test_demo_cli(default_small, tmp_path):
    from PIL import Image

    from raft_stereo_tpu_torch import demo
    jcfg, v = default_small
    ckpt = tmp_path / "w.pth"
    torch.save(convert_to_torch_state_dict(v), ckpt)
    left, right = _stereo_pair((1, 40, 70, 3), 13)
    Image.fromarray(left[0].astype(np.uint8)).save(tmp_path / "im0.png")
    Image.fromarray(right[0].astype(np.uint8)).save(tmp_path / "im1.png")
    out = tmp_path / "out"
    demo.main(["--restore_ckpt", str(ckpt), "-l", str(tmp_path / "im0.png"),
               "-r", str(tmp_path / "im1.png"), "--output_directory",
               str(out), "--save_numpy", "--valid_iters", "2",
               "--device", "cpu", "--hidden_dims", "32", "32", "32",
               "--corr_implementation", "reg_cuda"])
    assert (out / "im0-disparity.png").exists()
    disp = np.load(out / "im0.npy")
    assert disp.shape == (40, 70) and np.all(np.isfinite(disp))
