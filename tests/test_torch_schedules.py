"""The training step's schedules in the PyTorch port, held to the JAX
package on the CPU.

At the size of the JAX package's tests/test_scan_grad.py (one 32x48 pair,
the default architecture in fp32, 2 iterations) on bridged weights:

* the config's schedule fields (defaults, validation, R4_BEST_SCHEDULE)
  and the shape-dependent resolvers (refinement_save_policy_fits,
  upsample_chunk_count) against JAX's over a grid;
* every schedule's train-mode forward against JAX's same schedule: the
  prediction stack within 1e-3 px, the fused loss's per-iteration sums
  within 1e-6 relative (each is the sum of 1536 masked L1 terms) and its
  final flow within 1e-3 px. JAX schedules that differ only in what the
  backward recomputes or how it accumulates (remat, the save policies
  without residual_dtype, batched_scan_wgrad, the encoder remat modes,
  remat_loss_tail) trace the same forward, so one JAX run serves each
  forward family; residual_dtype's cast-through is a family of its own,
  must differ from the unrounded forward, and is held within a quarter of
  the deviation the cast makes in JAX's forward (a bf16 rounding flips
  where the frameworks' fp32 round-off differs);
* every schedule's gradients against the port's autodiff default (full
  per-iteration recompute) within JAX's own contract
  (tests/test_scan_grad.py: the blended per-leaf bound at 5e-4 relative
  for fp32 residuals, 1e-1 for the batched backward's bf16 stacks at 3
  iterations and 0.15 for the autodiff cast-through at 1 iteration),
  across reg, reg_pallas, alt, alt_pallas, fused and the fused lookup,
  and the slow-fast shared-backbone model;
* batched_scan_wgrad with the full save policy against JAX's same
  schedule's gradients under the null-floor rule (8 JAX null runs);
* the weight gradients hoisted: the gate convs' ``aten.convolution_
  backward`` weight contractions counted in the backward;
* what each policy saves (``saved_tensors_hooks``) and what the
  ``"norms"`` encoder schedule keeps against the saves of no remat;
* the CLI's schedule flags against JAX's ``model_config``.
"""

import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from raft_stereo_tpu import cli as jcli
from raft_stereo_tpu import config as jconfig
from raft_stereo_tpu.config import RAFTStereoConfig as JConfig
from raft_stereo_tpu.models import raft_stereo as jmodel
from raft_stereo_tpu.models.raft_stereo import create_model
from raft_stereo_tpu.training import loss as jloss

from raft_stereo_tpu_torch import cli as tcli
from raft_stereo_tpu_torch import config as tconfig
from raft_stereo_tpu_torch.models import RAFTStereo, init_weights
from raft_stereo_tpu_torch.models import raft_stereo as tmodel
from raft_stereo_tpu_torch.training.loss import (loss_mask, sequence_loss,
                                                 sequence_loss_fused)
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

from torch_parity import (jax_variables, max_abs, null_gate, perturbed,
                          port_config, torch_one_thread)

SHAPE = (1, 32, 48, 3)
ITERS = 2
NULL_RUNS = 8
ROUNDOFF_REL = 1e-7
FWD_PX = 1e-3
SUMS_REL = 1e-6


def _batch(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, shape).astype(np.float32)
    right = np.clip(np.roll(left, -3, axis=2)
                    + rng.normal(0, 4, shape), 0, 255).astype(np.float32)
    flow = -rng.uniform(0, 8, shape[:3] + (1,)).astype(np.float32)
    valid = (rng.uniform(size=shape[:3]) > 0.1).astype(np.float32)
    return dict(image1=left, image2=right, flow=flow, valid=valid)


@pytest.fixture(scope="module")
def setup():
    return jax_variables(JConfig(), seed=11, image_shape=SHAPE), _batch(5)


def _port(v, **fields):
    model = RAFTStereo(port_config(JConfig(**fields)))
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    return model


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _step(model, batch, fused, iters=ITERS):
    """The train-mode forward, the sequence loss and its gradients:
    ``(outputs, loss, grads)`` in ``model.parameters()`` order."""
    b = {k: _t(v) for k, v in batch.items()}
    params = list(model.parameters())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if fused:
            mask = loss_mask(b["flow"], b["valid"])
            out = model(b["image1"], b["image2"], iters=iters,
                        test_mode=False, flow_gt=b["flow"], loss_mask=mask)
            loss, _ = sequence_loss_fused(*out, b["flow"], mask)
        else:
            out = model(b["image1"], b["image2"], iters=iters,
                        test_mode=False)
            loss, _ = sequence_loss(out, b["flow"], b["valid"])
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    out = tuple(o.detach() for o in out) if fused else out.detach()
    return out, float(loss.detach()), grads


def _seeded(cfg, seed):
    """Seeded port weights (He init, the flow head's output conv scaled by
    0.1 as the parity trees scale it)."""
    model = init_weights(RAFTStereo(cfg), torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(0.1)
    return model.state_dict()


def assert_grads_tolerance(want, got, rel_l2_bound):
    """JAX's tests/test_scan_grad.py bound, leaf by leaf: ``|got - want|
    <= rel * |want| + rel / 200 * max_leaf |want|`` (L2 norms)."""
    want = [w.double() for w in want]
    scale = max(float(torch.linalg.vector_norm(w)) for w in want)
    worst = 0.0
    for i, (a, b) in enumerate(zip(want, got)):
        diff = float(torch.linalg.vector_norm(b.double() - a))
        na = float(torch.linalg.vector_norm(a))
        bound = rel_l2_bound * na + rel_l2_bound / 200.0 * scale
        worst = max(worst, diff / bound)
        assert diff < bound, f"leaf {i}: diff {diff:.3e} > {bound:.3e}"
    return worst


# ------------------------------------------------------------------ config

def test_config_fields_validation_and_r4_match_jax():
    fields = ("deferred_upsample", "remat_encoders", "upsample_tile_budget",
              "remat_loss_tail", "refinement_save_policy",
              "batched_scan_wgrad", "residual_dtype")
    for f in fields:
        assert getattr(tconfig.RAFTStereoConfig(), f) == getattr(JConfig(),
                                                                 f), f
    for field, bad in [("remat_encoders", "all"),
                       ("refinement_save_policy", "zr"),
                       ("residual_dtype", "float16"),
                       ("batched_scan_wgrad", "yes")]:
        with pytest.raises(ValueError) as want:
            JConfig(**{field: bad})
        with pytest.raises(ValueError) as got:
            tconfig.RAFTStereoConfig(**{field: bad})
        assert str(got.value) == str(want.value)
    with pytest.warns(UserWarning, match="no effect"):
        tconfig.RAFTStereoConfig(refinement_save_policy=True,
                                 remat_refinement=False)
    want = dict(jconfig.R4_BEST_SCHEDULE)
    assert want.pop("fold_enc_saves") is False
    assert tconfig.R4_BEST_SCHEDULE == want
    # every JAX field maps but the three knobs eager PyTorch has no use for
    jf = {f.name for f in dataclasses.fields(JConfig)}
    tf = {f.name for f in dataclasses.fields(tconfig.RAFTStereoConfig)}
    assert jf - tf == {"fused_block_w", "fold_enc_saves", "scan_unroll"}
    assert tf <= jf
    cfg = JConfig(remat_encoders="norms", refinement_save_policy="corr",
                  batched_scan_wgrad=True, residual_dtype="bfloat16",
                  deferred_upsample=False, upsample_tile_budget=5,
                  remat_loss_tail=False)
    assert port_config(cfg) == tconfig.RAFTStereoConfig(
        **{f: getattr(cfg, f) for f in fields})
    for field, value in [("scan_unroll", 2), ("fold_enc_saves", True)]:
        with pytest.raises(ValueError, match="not ported"):
            port_config(JConfig(**{field: value}))


def test_resolvers_match_jax():
    cfgs = [JConfig(), JConfig(hidden_dims=(64, 96, 64)),
            JConfig(n_gru_layers=2, slow_fast_gru=True),
            JConfig(n_gru_layers=3, slow_fast_gru=True),
            JConfig(n_gru_layers=1), jconfig.realtime_config()]
    dtypes = [(None, None), (jnp.float32, torch.float32),
              (jnp.bfloat16, torch.bfloat16)]
    n = 0
    for cfg in cfgs:
        tcfg = port_config(cfg)
        for it in (1, 7, 22):
            for batch in (1, 4, 8):
                for h, w in ((80, 180), (48, 156), (8, 12)):
                    for jdt, tdt in dtypes:
                        for rd in (None, "float32", "bfloat16"):
                            for fused in (False, True):
                                want = jmodel.refinement_save_policy_fits(
                                    cfg, it, batch, h, w, jdt,
                                    fused_lookup=fused, residual_dtype=rd)
                                got = tmodel.refinement_save_policy_fits(
                                    tcfg, it, batch, h, w, tdt,
                                    fused_lookup=fused, residual_dtype=rd)
                                assert got == want, (cfg, it, batch, h, w)
                                n += 1
    # both answers occur on the grid
    assert tmodel.refinement_save_policy_fits(
        port_config(JConfig()), 22, 8, 80, 180, torch.bfloat16) is False
    assert tmodel.refinement_save_policy_fits(
        port_config(JConfig()), 22, 4, 80, 180, torch.bfloat16) is True
    assert tmodel._UPSAMPLE_TILE_BUDGET == jmodel._UPSAMPLE_TILE_BUDGET
    counts = set()
    for it in (1, 2, 7, 12, 22):
        for batch in (1, 8):
            for hp, wp in ((80, 180), (8, 12), (160, 360)):
                for factor in (4, 8):
                    for budget in (None, 1, 10 ** 6, 10 ** 8, 2 ** 31):
                        want = jmodel.upsample_chunk_count(
                            it, batch, hp, wp, factor, budget=budget)
                        assert tmodel.upsample_chunk_count(
                            it, batch, hp, wp, factor,
                            budget=budget) == want
                        counts.add(want)
    assert {1, 2, 22} <= counts
    assert n > 1000


def test_resolve_save_kinds():
    """The model's one resolution of what the training refinement keeps
    an iteration (``resolve_save_kinds``, which ``_train_refine`` calls):
    nothing without remat or with the policy off; the lookup under
    ``"corr"`` (nothing with the fused lookup, with JAX's warning); the
    gate outputs and the lookup under True, or under None where
    refinement_save_policy_fits holds: not at the recipe's batch 8 in
    bf16 (full recompute, 22 + 22 lookup launches), at its batch 4 a rank
    (22), and at the card tests' small shapes."""
    cfg = port_config(JConfig())
    bf = torch.bfloat16
    full = frozenset({"zr", "q", "corr"})

    def kinds(shape, fused=False, **fields):
        return tmodel.resolve_save_kinds(dataclasses.replace(cfg, **fields),
                                         *shape, bf, fused_lookup=fused)
    recipe, rank, small = (22, 8, 80, 180), (22, 4, 80, 180), (2, 1, 16, 40)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert kinds(small, remat_refinement=False,
                     refinement_save_policy=True) == frozenset()
    assert kinds(small, refinement_save_policy=False) == frozenset()
    assert kinds(small) == kinds(rank) == kinds(recipe,
                                                refinement_save_policy=True)
    assert kinds(small) == full
    assert kinds(recipe) == kinds(recipe, True) == frozenset()
    assert kinds(small, True) == frozenset({"zr", "q"})
    assert kinds(recipe, refinement_save_policy="corr") == {"corr"}
    with pytest.warns(UserWarning, match="no effect with fused_lookup"):
        assert kinds(small, True,
                     refinement_save_policy="corr") == frozenset()


def test_remat_refinement_runs_one_path(setup, monkeypatch):
    """Every per-iteration recompute schedule goes through
    ``refinement_scan`` of one iteration (full recompute: nothing kept);
    batched_scan_wgrad through one scan of the whole loop; no remat
    through neither."""
    v, batch = setup
    b = {k: _t(x) for k, x in batch.items()}
    calls = []
    real = tmodel.refinement_scan

    def spy(*args, **kwargs):
        calls.append((kwargs["length"], kwargs.get("batched", True),
                      kwargs["save_kinds"]))
        return real(*args, **kwargs)
    monkeypatch.setattr(tmodel, "refinement_scan", spy)
    none = frozenset()
    for fields, want in (
            (dict(refinement_save_policy=False), [(1, False, none)] * ITERS),
            (dict(refinement_save_policy="corr"),
             [(1, False, frozenset({"corr"}))] * ITERS),
            (dict(batched_scan_wgrad=True, refinement_save_policy=False),
             [(ITERS, True, none)]),
            (dict(remat_refinement=False), [])):
        calls.clear()
        _port(v, **fields)(b["image1"], b["image2"], iters=ITERS,
                           test_mode=False)
        assert calls == want, fields


class _OnCard:
    """A channels-first CUDA tensor to the FFT rule (device, dtype,
    shape)."""

    def __init__(self, shape):
        self.is_cuda, self.dtype, self.shape = True, torch.float32, shape


def test_fft_route_judged_by_the_contracted_weight():
    """cudnn_takes_fft decides from the weight a call contracts: the
    gru32 gate conv's own 256 -> 128 weight takes the FFT rule, the z|r
    stack (256 -> 256) the batched backward contracts does not."""
    from raft_stereo_tpu_torch.nn.layers import Conv, cudnn_takes_fft
    gate = Conv(256, 128, 3, 1, 1)
    x = _OnCard((1, 256, 126, 180))
    flags = torch.backends.cudnn
    before = flags.allow_tf32
    try:
        flags.allow_tf32 = False
        assert cudnn_takes_fft(gate, x)
        assert cudnn_takes_fft(gate, x, torch.empty((128, 256, 3, 3),
                                                    device="meta"))
        assert not cudnn_takes_fft(gate, x, torch.empty((256, 256, 3, 3),
                                                        device="meta"))
    finally:
        flags.allow_tf32 = before


class _Tf32AtWgrad(TorchDispatchMode):
    """cuDNN's TF32 flag as each weight-gradient contraction reads it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution_backward.default \
                and args[-1][1]:
            self.seen.append(torch.backends.cudnn.allow_tf32)
        return func(*args, **(kwargs or {}))


def _wgrad_fp64(x, g, k=3, pad=1):
    cols = torch.nn.functional.unfold(x.permute(0, 3, 1, 2).double(), k,
                                      padding=pad)
    gc = g.double().reshape(cols.shape[0], -1, g.shape[-1])
    dw = torch.einsum("nlo,ncl->oc", gc, cols)
    return dw.reshape(g.shape[-1], x.shape[-1], k, k)


def test_weight_grad_accumulates_in_fp32_and_sets_no_flag():
    """Conv.weight_grad on bf16 stacks of two convolutions' cotangents
    (Cout' = 2 x 16, as the z|r gates), in one block and in 3 (the
    batched backward's iterations as groups), is the float64 im2col
    contraction within 1e-6 relative L2 (exact products, fp32 sums), in
    fp32, with cuDNN's TF32 flag as the caller left it; a bf16
    contraction of the same stacks is not (its output rounds each
    weight)."""
    from raft_stereo_tpu_torch.nn.layers import Conv
    gen = torch.Generator().manual_seed(3)
    conv = Conv(24, 16, 3, 1, 1, dtype=torch.bfloat16)
    x = torch.randn((6, 10, 12, 24), generator=gen).to(torch.bfloat16)
    g = torch.randn((6, 10, 12, 32), generator=gen).to(torch.bfloat16)
    want = _wgrad_fp64(x, g)
    flags = torch.backends.cudnn
    before = flags.allow_tf32
    try:
        flags.allow_tf32 = False
        with _Tf32AtWgrad() as mode:
            dws = [conv.weight_grad(x, g, groups=n) for n in (1, 3)]
        assert mode.seen == [False, False]
        assert flags.allow_tf32 is False
    finally:
        flags.allow_tf32 = before
    for dw in dws:
        assert dw.dtype == torch.float32 and dw.shape == (32, 24, 3, 3)
        dev = float((dw.double() - want).norm() / want.norm())
        assert dev <= 1e-6, dev
    bf16 = conv.conv_backward(x, torch.zeros((32, 24, 3, 3),
                                             dtype=torch.bfloat16), g,
                              (False, True, False))[1]
    assert float((bf16.double() - want).norm() / want.norm()) > 1e-4


# ------------------------------------------------- forwards against JAX

# forward family -> (JAX config fields, fused loss)
FAMILIES = {
    "stacked": (dict(refinement_save_policy=False), False),
    "fused": (dict(refinement_save_policy=False), True),
    "fused_inloop": (dict(refinement_save_policy=False,
                          deferred_upsample=False), True),
    "fused_chunked": (dict(refinement_save_policy=False,
                           upsample_tile_budget=1), True),
    "cast_full": (dict(refinement_save_policy=True,
                       residual_dtype="bfloat16"), False),
    "cast_corr": (dict(refinement_save_policy="corr",
                       residual_dtype="bfloat16"), False),
}

# name -> (port config fields, forward family, gradient bound)
SCHEDULES = {
    "full_remat": (dict(refinement_save_policy=False), "stacked", 5e-4),
    "policy_auto": (dict(), "stacked", 5e-4),
    "policy_full": (dict(refinement_save_policy=True), "stacked", 5e-4),
    "policy_corr": (dict(refinement_save_policy="corr"), "stacked", 5e-4),
    "no_remat": (dict(remat_refinement=False), "stacked", 5e-4),
    "batched": (dict(batched_scan_wgrad=True, refinement_save_policy=False),
                "stacked", 5e-4),
    "batched_full": (dict(batched_scan_wgrad=True,
                          refinement_save_policy=True), "stacked", 5e-4),
    "batched_corr": (dict(batched_scan_wgrad=True,
                          refinement_save_policy="corr"), "stacked", 5e-4),
    "batched_no_remat": (dict(batched_scan_wgrad=True,
                              remat_refinement=False), "stacked", 5e-4),
    "inloop_upsample": (dict(deferred_upsample=False), "stacked", 5e-4),
    "no_remat_loss_tail": (dict(remat_loss_tail=False), "stacked", 5e-4),
    "enc_whole": (dict(remat_encoders=True), "stacked", 5e-4),
    "enc_blocks": (dict(remat_encoders="blocks"), "stacked", 5e-4),
    "enc_blocks_hires": (dict(remat_encoders="blocks_hires"), "stacked",
                         5e-4),
    "enc_norms": (dict(remat_encoders="norms"), "stacked", 5e-4),
    "fused_loss": (dict(), "fused", 5e-4),
    "fused_inloop": (dict(deferred_upsample=False), "fused_inloop", 5e-4),
    "fused_chunked": (dict(upsample_tile_budget=1), "fused_chunked", 5e-4),
    "fused_chunked_no_tail": (dict(upsample_tile_budget=1,
                                   remat_loss_tail=False), "fused_chunked",
                              5e-4),
    "batched_fused": (dict(batched_scan_wgrad=True), "fused", 5e-4),
    "batched_fused_inloop": (dict(batched_scan_wgrad=True,
                                  deferred_upsample=False), "fused_inloop",
                             5e-4),
    "batched_bf16": (dict(batched_scan_wgrad=True,
                          refinement_save_policy=True,
                          residual_dtype="bfloat16"), "stacked", 1e-1),
    "cast_full": (dict(refinement_save_policy=True,
                       residual_dtype="bfloat16"), "cast_full", 0.15),
    "cast_corr": (dict(refinement_save_policy="corr",
                       residual_dtype="bfloat16"), "cast_corr", 0.15),
}


@pytest.fixture(scope="module")
def jax_forward(setup):
    """``family -> outputs``: JAX's train-mode forward of a forward family
    on the module's weights and batch, each computed once."""
    v, batch = setup

    @functools.lru_cache(maxsize=None)
    def run(family):
        fields, fused = FAMILIES[family]
        model = create_model(JConfig(**fields))
        kw = {}
        if fused:
            kw = dict(flow_gt=batch["flow"], loss_mask=jloss.loss_mask(
                batch["flow"], batch["valid"]))
        fn = jax.jit(lambda p, a, b: model.apply(
            {"params": p, "batch_stats": v["batch_stats"]}, a, b,
            iters=ITERS, **kw))
        out = fn(v["params"], batch["image1"], batch["image2"])
        return jax.tree_util.tree_map(np.asarray, out)
    return run


@pytest.fixture(scope="module")
def reference(setup):
    """The port's autodiff default (full per-iteration recompute) at
    ITERS and at 1 iteration: ``(outputs, loss, grads)``."""
    v, batch = setup
    model = _port(v, refinement_save_policy=False)
    return {iters: _step(model, batch, False, iters) for iters in (1, ITERS)}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_forward_and_grads(setup, reference, jax_forward, name,
                                    record_property):
    v, batch = setup
    fields, family, bound = SCHEDULES[name]
    fused = FAMILIES[family][1]
    model = _port(v, **fields)
    out, loss, grads = _step(model, batch, fused)
    want = jax_forward(family)
    if fused:
        sums_dev = float(np.max(np.abs(out[0].numpy() - want[0])
                                / np.abs(want[0])))
        flow_dev = max_abs(out[1], want[1])
        record_property("err_sums_max_rel_dev", sums_dev)
        record_property("final_flow_max_abs_px", flow_dev)
        assert sums_dev <= SUMS_REL, (out[0], want[0])
        assert flow_dev <= FWD_PX
    elif family.startswith("cast"):
        # The cast-through rounds the kept values to bf16, where the two
        # frameworks' fp32 round-off flips a rounding here and there: held
        # within a quarter of what the cast itself moves JAX's forward
        # (measured: 8% under the full policy, 0.07% under "corr").
        dev = max_abs(out, want)
        effect = max_abs(want, jax_forward("stacked"))
        record_property("max_abs_px", dev)
        record_property("cast_effect_px", effect)
        assert dev <= 0.25 * effect
    else:
        dev = max_abs(out, want)
        record_property("max_abs_px", dev)
        assert dev <= FWD_PX
    if family.startswith("cast"):
        # the cast-through rounds the kept values: not the exact forward
        assert max_abs(out, reference[ITERS][0]) > 0
        if family == "cast_corr":
            assert max_abs(out, jax_forward("cast_full")) > 0
        # JAX's contract for the cast-through: one iteration
        _, _, grads = _step(model, batch, fused, iters=1)
        ref = reference[1][2]
    else:
        ref = reference[ITERS][2]
        if name == "batched_bf16":
            # the forward exact (the port's own); JAX's contract at 3
            # iterations
            assert max_abs(out, reference[ITERS][0]) == 0
            ref = _step(_port(v, refinement_save_policy=False), batch,
                        False, 3)[2]
            grads = _step(model, batch, False, 3)[2]
    record_property("grad_bound_ratio",
                    assert_grads_tolerance(ref, grads, bound))


def test_batched_full_policy_grads_match_jax(setup, record_property):
    """batched_scan_wgrad with the full save policy against JAX's same
    schedule under the null-floor rule."""
    v, batch = setup
    fields = dict(batched_scan_wgrad=True, refinement_save_policy=True)
    model = create_model(JConfig(**fields))

    def loss_fn(params):
        preds = model.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            batch["image1"], batch["image2"], iters=ITERS)
        return jloss.sequence_loss(preds, batch["flow"], batch["valid"])[0]

    fn = jax.jit(jax.grad(loss_fn))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    want = to_np(fn(v["params"]))
    nulls = [to_np(fn(perturbed(v["params"], 31 + i)))
             for i in range(NULL_RUNS)]
    port = _port(v, **fields)
    _, _, grads = _step(port, batch, False)
    got = {n: g.numpy() for (n, _), g in zip(port.named_parameters(), grads)}
    want_sd = state_dict_from_jax({"params": want})
    norm = float(np.linalg.norm(np.concatenate(
        [want_sd[k].numpy().ravel() for k in got])))
    roundoff = {k for k in got
                if np.linalg.norm(want_sd[k].numpy()) < ROUNDOFF_REL * norm}
    ok, read = null_gate(got, want, nulls, 1e-4, roundoff)
    for key, value in read.items():
        record_property(key, value)
    assert ok, read


# ------------------------------------------- implementations and presets

@pytest.mark.parametrize("impl", ["reg_pallas", "alt", "alt_pallas",
                                  "fused", "fused_lookup"])
def test_custom_backward_per_implementation(impl, record_property):
    """The batched backward (with the full policy's replays) and the
    ``"corr"`` policy (the lookup replayed by the implementation's own
    backward) against the autodiff default, per correlation; the fused
    lookup at 32x352, the narrowest width whose pyramid it takes (its
    ``"corr"`` policy warns and falls back)."""
    shape = (1, 32, 352, 3) if impl == "fused_lookup" else (1, 32, 48, 3)
    base = dict(hidden_dims=(32, 32, 32),
                corr_implementation="reg" if impl == "fused_lookup"
                else impl, fused_lookup=impl == "fused_lookup")
    weights = _seeded(port_config(JConfig(**base)), 13)
    batch = _batch(7, shape)

    def port(**fields):
        model = RAFTStereo(port_config(JConfig(**base, **fields)))
        model.load_state_dict(weights)
        return model
    ref = _step(port(refinement_save_policy=False), batch, False)
    for fields in (dict(batched_scan_wgrad=True, refinement_save_policy=True),
                   dict(refinement_save_policy="corr")):
        model = port(**fields)
        if impl == "fused_lookup":
            from raft_stereo_tpu_torch.ops.corr import CorrState
            levels = tuple(torch.zeros(1, 8, 88, 88 >> i) for i in range(4))
            assert model.uses_fused_lookup(CorrState(levels, "reg", 4))
        out, loss, grads = _step(model, batch, False)
        assert max_abs(out, ref[0]) == 0
        record_property(str(fields), assert_grads_tolerance(
            ref[2], grads, 5e-4))
    if impl == "fused_lookup":
        with pytest.warns(UserWarning, match="no effect with fused_lookup"):
            m = port(refinement_save_policy="corr")
            b = {k: _t(x) for k, x in batch.items()}
            m(b["image1"], b["image2"], iters=1, test_mode=False)


def test_slow_fast_shared_backbone(record_property):
    """The realtime preset's shape (slow-fast pre-iterations re-run the
    GRUs on shared weights; shared backbone), fp32 with reg: the batched
    wgrads of the pre32/pre16/main applications sum into one leaf each."""
    jcfg = dataclasses.replace(jconfig.realtime_config(),
                               mixed_precision=False,
                               corr_implementation="reg")
    # at 1/8 resolution 96 columns keep every pyramid level non-empty
    shape = (1, 32, 96, 3)
    v = jax_variables(jcfg, seed=17, image_shape=shape)
    batch = _batch(9, shape)
    fields = dataclasses.asdict(jcfg)
    for k in ("fused_block_w", "fold_enc_saves", "scan_unroll"):
        fields.pop(k)
    ref = _step(_port(v, **dict(fields, refinement_save_policy=False)),
                batch, False)
    out, _, grads = _step(_port(v, **dict(fields, batched_scan_wgrad=True)),
                          batch, False)
    model = create_model(jcfg)
    want = np.asarray(jax.jit(lambda p, a, b: model.apply(
        {"params": p, "batch_stats": v["batch_stats"]}, a, b,
        iters=ITERS))(v["params"], batch["image1"], batch["image2"]))
    record_property("max_abs_px", max_abs(out, want))
    assert max_abs(out, want) <= FWD_PX
    record_property("grad_bound_ratio",
                    assert_grads_tolerance(ref[2], grads, 5e-4))


# ----------------------------------------------------- structure of the step

class _WgradCount(TorchDispatchMode):
    """Counts ``aten.convolution_backward`` calls that compute a weight
    gradient: ``(samples, Cout, Cin, kh, kw)`` of each, a grouped call's
    groups counted as samples of one convolution (the batched backward
    contracts its iterations as groups)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution_backward.default \
                and args[-1][1]:
            groups = args[9]
            w = args[2].shape
            self.calls.append((args[1].shape[0] * groups, w[0] // groups,
                               w[1]) + tuple(w[2:]))
        return func(*args, **(kwargs or {}))


def test_wgrads_hoisted_out_of_the_backward_loop(setup):
    """The gate convs (the only convs with 256 or more input channels at
    the default widths) contract their weight gradients once a step per
    site over iters*B under batched_scan_wgrad (the z and r convs one
    contraction, the iterations its groups), and once an iteration per
    conv without it: 9 a step for 3 GRUs an iteration, 6 hoisted."""
    v, batch = setup
    n = {}
    for flag in (False, True):
        model = _port(v, refinement_save_policy=False,
                      batched_scan_wgrad=flag)
        b = {k: _t(x) for k, x in batch.items()}
        preds = model(b["image1"], b["image2"], iters=ITERS,
                      test_mode=False)
        loss, _ = sequence_loss(preds, b["flow"], b["valid"])
        with _WgradCount() as count:
            loss.backward()
        # gate convs: 3x3, 256 or more inputs, hd or 2 hd outputs
        n[flag] = [c for c in count.calls
                   if c[2] >= 256 and c[3:] == (3, 3) and c[1] in (128, 256)]
    assert len(n[False]) == 9 * ITERS
    assert all(c[0] == SHAPE[0] for c in n[False])
    assert len(n[True]) == 6
    assert all(c[0] == ITERS * SHAPE[0] for c in n[True])
    # the z and r gates: one contraction of 2 hd outputs a GRU
    assert sorted(c[1] for c in n[True]) == [128] * 3 + [256] * 3


def _saved(fn):
    """The tensors autograd saves while ``fn()`` runs: ``(shape, dtype)``
    of each distinct storage."""
    seen = {}

    def pack(t):
        seen[(t.untyped_storage().data_ptr(), tuple(t.shape))] = (
            tuple(t.shape), t.dtype)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return list(seen.values())


def test_policies_save_what_they_say(setup):
    """Under ``"corr"`` the refinement keeps one correlation tensor an
    iteration and no gate output; under the full policy the zr and q
    outputs of every GRU an iteration too, in ``residual_dtype`` where
    set."""
    v, batch = setup
    b = {k: _t(x) for k, x in batch.items()}
    hd, cc = 128, 36
    grids = [(8, 12), (4, 6), (2, 3)]  # gru08, gru16, gru32

    def saves(**fields):
        model = _port(v, **fields)
        return _saved(lambda: model(b["image1"], b["image2"], iters=ITERS,
                                    test_mode=False))

    def count(saved, c, dtype=torch.float32):
        return [sum(1 for s, d in saved if s == (1, h, w, c) and d == dtype)
                for h, w in grids]

    corr = saves(refinement_save_policy="corr")
    full = saves(refinement_save_policy=True)
    lean = saves(refinement_save_policy=True, residual_dtype="bfloat16")
    assert count(corr, cc)[0] == ITERS
    assert count(corr, 2 * hd) == [0, 0, 0]
    assert count(full, cc)[0] == ITERS
    assert count(full, 2 * hd) == [ITERS] * 3
    # the q outputs are hidden-state-shaped: ITERS more than the carries
    assert [f - c for f, c in zip(count(full, hd), count(corr, hd))] \
        == [ITERS] * 3
    assert count(lean, 2 * hd, torch.bfloat16) == [ITERS] * 3
    assert count(lean, cc, torch.bfloat16)[0] == ITERS
    assert count(lean, 2 * hd) == [0, 0, 0]


class _KeptBytes(TorchDispatchMode):
    """Bytes of the outputs of the ops the "norms" schedule keeps."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in tmodel._NORMS_SAVED:
            self.bytes += out.numel() * out.element_size()
        return out


def test_norms_keeps_less_than_no_remat(setup):
    """``remat_encoders="norms"`` keeps every conv output and norm
    statistic of the encoders (the outputs of the ops its policy saves,
    counted as they run) plus its inputs: less than autograd saves for the
    encoders without remat. The gradients are the same."""
    v, batch = setup
    x = _t(batch["image1"])
    x1, x2 = 2 * (x / 255) - 1, 2 * (_t(batch["image2"]) / 255) - 1
    plain = _port(v)
    whole = sum(int(np.prod(s)) * torch.empty((), dtype=d).element_size()
                for s, d in _saved(lambda: plain._encode(x1, x2)))
    with _KeptBytes() as kept:
        _port(v, remat_encoders="norms")._encode(x1, x2)
    assert kept.bytes + 2 * x1.numel() * 4 < whole, (kept.bytes, whole)


def test_cli_schedule_flags_match_jax():
    argv_sets = [
        [],
        ["--refinement_save_policy", "on", "--residual_dtype", "bfloat16"],
        ["--refinement_save_policy", "corr", "--batched_scan_wgrad", "on",
         "--no_remat_loss_tail"],
        ["--refinement_save_policy", "off", "--batched_scan_wgrad", "off",
         "--residual_dtype", "float32", "--no_remat"],
        ["--fused_block_w", "128", "--fused_lookup", "on"],
    ]
    for argv in argv_sets:
        jargs = jcli.build_train_parser().parse_args(argv)
        targs = tcli.build_train_parser().parse_args(argv)
        want = port_config(dataclasses.replace(jcli.model_config(jargs),
                                               fused_block_w=256))
        assert tcli.model_config(targs) == want, argv
