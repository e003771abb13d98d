"""The ``windowed_sample`` CUDA kernels held to their plain versions on the
card.

Every test here needs an NVIDIA GPU with nvcc (the kernels have no CPU or
interpret mode) and skips without one. Run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Bounds, against the plain PyTorch versions on the same inputs: the
forward and the backward's ``dvol`` 1e-5 abs (both kernels round each
product and sum as the plain versions do, so they are expected to be
exact; ``dvol`` is checked bitwise), ``dcoords`` 1e-5 abs (a 9-term fp32
sum taken in another order).
"""

import pytest
import torch

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models import RAFTStereo, init_weights
from raft_stereo_tpu_torch.ops.kernels import windowed_sample as ws
from raft_stereo_tpu_torch.ops.kernels.windowed_sample import (
    windowed_sample, windowed_sample_backward, windowed_sample_backward_plain,
    windowed_sample_plain)

pytestmark = pytest.mark.cuda

R = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    vol = torch.randn(shape, generator=g, device=device).to(dtype)
    w2 = shape[-1]
    center = (torch.rand(shape[:3], generator=g, device=device)
              * (w2 + 4 * R + 4) - 2 * R - 2)
    flat = center.view(-1)
    edge = [0.0, -1.0, float(w2 - 1), float(w2), 1e9, -1e9, float("nan")]
    flat[:len(edge)] = torch.tensor(edge, device=device)
    return vol, center


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 96, 312, 312), (1, 96, 312, 39),
                                   (2, 3, 15, 15), (1, 2, 15, 7),
                                   (1, 2, 15, 3), (1, 2, 15, 1),
                                   (1, 48, 156, 19)])
def test_kernel_matches_plain(cuda, dtype, shape):
    vol, center = _inputs(shape, dtype, cuda)
    before = windowed_sample.launches
    got = windowed_sample(vol, center, R)
    torch.cuda.synchronize()
    assert windowed_sample.launches == before + 1
    want = windowed_sample_plain(vol, center, R)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and bool(nan.any())
    assert (got - want).abs()[~nan].max().item() <= 1e-5
    assert bool((got.view(-1, 2 * R + 1)[4:6] == 0).all())


def test_kernel_64bit_offsets(cuda):
    # B*H*W1*W2 = 2**31 + 2**25 elements: the last rows lie past 2**31
    shape = (1, 33, 1024, 65536)
    vol = torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    vol[0, -1] = torch.randn((1024, 65536), generator=g,
                             device=cuda).to(torch.bfloat16)
    center = torch.rand(shape[:3], generator=g, device=cuda) * 65536
    got = windowed_sample(vol, center, R)
    torch.cuda.synchronize()
    want = windowed_sample_plain(vol[:, -1:], center[:, -1:], R)
    assert (got[:, -1:] - want).abs().max().item() <= 1e-5
    assert bool(want.abs().max() > 0)


def test_wrapper_refuses_bad_inputs(cuda):
    vol, center = _inputs((1, 2, 8, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        windowed_sample(vol.transpose(1, 2), center.transpose(1, 2), R)
    with pytest.raises(TypeError, match="dtype"):
        windowed_sample(vol.half(), center, R)
    with pytest.raises(TypeError, match="center dtype"):
        windowed_sample(vol, center.double(), R)
    with pytest.raises(ValueError, match="want volume"):
        windowed_sample(vol, center[..., :4].contiguous(), R)
    with pytest.raises(ValueError, match="CUDA device"):
        windowed_sample(vol, center.cpu(), R)


def test_model_kernel_matches_plain_lookup(cuda):
    cfg_k = RAFTStereoConfig(hidden_dims=(32, 32, 32),
                             corr_implementation="reg_cuda")
    cfg_p = RAFTStereoConfig(hidden_dims=(32, 32, 32),
                             corr_implementation="reg")
    model_k = init_weights(RAFTStereo(cfg_k), torch.Generator().manual_seed(0))
    model_p = RAFTStereo(cfg_p)
    model_p.load_state_dict(model_k.state_dict(), strict=True)
    model_k.to(cuda).eval()
    model_p.to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(2)
    left = torch.rand((1, 64, 128, 3), generator=g, device=cuda) * 255
    right = torch.roll(left, -4, dims=2)
    windowed_sample.launches = 0
    with torch.inference_mode():
        lo_k, up_k = model_k(left, right, iters=5)
        lo_p, up_p = model_p(left, right, iters=5)
    # one launch for the four levels an iteration
    assert windowed_sample.launches == 5
    assert (up_k - up_p).abs().max().item() <= 1e-5


# level shapes of the SceneFlow training batch (8 x 320x720 at 1/4) and of
# the two inference paths, plus the odd and degenerate widths
BWD_SHAPES = [(8, 80, 180, 180), (8, 80, 180, 22), (1, 96, 312, 312),
              (1, 48, 156, 19), (2, 3, 15, 15), (1, 2, 15, 7),
              (1, 2, 15, 3), (1, 2, 15, 1)]


def _same(a, b):
    """Bitwise equal, NaNs in the same places counting as equal."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def _cotangent(shape, device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape[:3] + (2 * R + 1,), generator=g, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_backward_kernel_matches_plain(cuda, dtype, shape):
    vol, center = _inputs(shape, dtype, cuda)
    ct = _cotangent(shape, cuda)
    before = windowed_sample.bwd_launches
    dvol, dcoords = windowed_sample_backward(vol, center, ct, R)
    torch.cuda.synchronize()
    assert windowed_sample.bwd_launches == before + 1
    want_dvol, want_dcoords = windowed_sample_backward_plain(vol, center, ct,
                                                             R)
    assert dvol.dtype == dtype and dvol.shape == vol.shape
    nan = torch.isnan(want_dvol)
    assert torch.equal(torch.isnan(dvol), nan) and bool(nan.any())
    assert torch.equal(dvol[~nan], want_dvol[~nan])
    assert (dcoords - want_dcoords).abs().max().item() <= 1e-5
    rows = dvol.view(-1, shape[-1])
    assert bool((rows[4:6] == 0).all())  # far-out centers write zeros


def test_backward_kernel_strided_cotangent(cuda):
    # the lookup's cotangent is a slice of the 4-level concatenation
    vol, center = _inputs((2, 8, 40, 40), torch.bfloat16, cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    full = torch.randn((2, 8, 40, 4 * (2 * R + 1)), generator=g, device=cuda)
    ct = full[..., 2 * R + 1:2 * (2 * R + 1)]
    assert not ct.is_contiguous()
    got = windowed_sample_backward(vol, center, ct, R)
    want = windowed_sample_backward(vol, center, ct.contiguous(), R)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.parametrize("rows", [33, 66])
def test_backward_kernel_64bit_offsets(cuda, rows):
    # 2**31 + 2**25 and 2**32 + 2**26 elements: the last rows lie past
    # 2**31 and past 2**32
    shape = (1, rows, 1024, 65536)
    vol = torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    center = torch.rand(shape[:3], generator=g, device=cuda) * 65536
    ct = _cotangent(shape, cuda)
    dvol, _ = windowed_sample_backward(vol, center, ct, R,
                                       need_dcoords=False)
    torch.cuda.synchronize()
    want, _ = windowed_sample_backward_plain(vol[:, -1:], center[:, -1:],
                                             ct[:, -1:], R)
    assert torch.equal(dvol[:, -1:], want)
    assert bool(want.abs().max() > 0)
    del vol, dvol


def test_backward_kernel_is_deterministic(cuda):
    vol, center = _inputs((8, 80, 180, 180), torch.bfloat16, cuda)
    ct = _cotangent(vol.shape, cuda)
    a = windowed_sample_backward(vol, center, ct, R)
    b = windowed_sample_backward(vol, center, ct, R)
    assert _same(a[0], b[0]) and _same(a[1], b[1])


def test_autograd_launches_the_backward(cuda):
    vol, center = _inputs((1, 4, 32, 32), torch.float32, cuda)
    vol.requires_grad_()
    center = center.nan_to_num(0.0).requires_grad_()
    before = (windowed_sample.launches, windowed_sample.bwd_launches)
    out = windowed_sample(vol, center, R)
    ct = _cotangent(vol.shape, cuda)
    dvol, dcoords = torch.autograd.grad(out, (vol, center), ct)
    assert (windowed_sample.launches, windowed_sample.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    want = windowed_sample_backward_plain(vol.detach(), center.detach(),
                                          ct, R)
    assert torch.equal(dvol, want[0])
    assert (dcoords - want[1]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("mixed", [False, True])
def test_model_train_kernels_match_plain_lookup(cuda, mixed):
    # the same training step with the kernels (reg_cuda) and with the plain
    # lookup under autograd (reg), both on the card. The forwards are
    # bitwise equal; the backward is not deterministic from run to run even
    # with deterministic cuDNN (PyTorch backward ops that accumulate with
    # atomics; measured 1.4e-7 of the global gradient norm in fp32 and
    # 6.7e-4 in bf16), so the kernels' deviation from the plain lookup is
    # held to twice the kernel path's own run-to-run deviation, plus 1e-7.
    from raft_stereo_tpu_torch.training.state import loss_and_grads
    torch.backends.cudnn.deterministic = True
    kw = dict(hidden_dims=(32, 32, 32), mixed_precision=mixed,
              corr_storage_dtype="bfloat16" if mixed else None)
    try:
        model_k = init_weights(
            RAFTStereo(RAFTStereoConfig(corr_implementation="reg_cuda", **kw)),
            torch.Generator().manual_seed(0))
        model_p = RAFTStereo(RAFTStereoConfig(corr_implementation="reg", **kw))
        model_p.load_state_dict(model_k.state_dict(), strict=True)
        model_k.to(cuda)
        model_p.to(cuda)
        g = torch.Generator(device=cuda).manual_seed(5)
        left = torch.rand((2, 64, 128, 3), generator=g, device=cuda) * 255
        batch = {"image1": left, "image2": torch.roll(left, -4, dims=2),
                 "flow": -4 * torch.ones((2, 64, 128, 1), device=cuda),
                 "valid": torch.ones((2, 64, 128), device=cuda)}
        windowed_sample.launches = windowed_sample.bwd_launches = 0
        loss_k, _, grads_k = loss_and_grads(model_k, batch, 3)
        # one forward launch for the four levels an iteration (and its
        # remat recompute), one backward launch
        assert (windowed_sample.launches, windowed_sample.bwd_launches) == (
            2 * 3, 3)
        _, _, again = loss_and_grads(model_k, batch, 3)
        loss_p, _, grads_p = loss_and_grads(model_p, batch, 3)
    finally:
        torch.backends.cudnn.deterministic = False
    assert torch.equal(loss_k, loss_p)

    def dist(a, b):
        return float(torch.sqrt(sum(((x - y).double() ** 2).sum()
                                    for x, y in zip(a, b))))
    norm = float(torch.sqrt(sum((y.double() ** 2).sum() for y in grads_p)))
    assert dist(grads_k, grads_p) <= 2 * dist(grads_k, again) + 1e-7 * norm


@pytest.mark.parametrize("layout", ["nhwc", "nchw_storage"])
def test_pool2x_gradient_matches_cpu(cuda, layout):
    # the GRU links' pool gets NHWC-contiguous input from cuDNN's
    # channels-last convolution outputs; its gradient on the card must match
    # the CPU's in either storage. Bound: 1e-6 relative L2 (fp32 round-off
    # of a 9-term sum).
    from raft_stereo_tpu_torch.ops.geometry import pool2x
    g = torch.Generator().manual_seed(6)
    x = torch.randn((2, 16, 40, 128), generator=g)
    if layout == "nchw_storage":
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    ct = torch.randn((2, 8, 20, 128), generator=g)
    grads = []
    for where in ("cpu", cuda):
        xi = x.to(where).detach().requires_grad_()
        (dx,) = torch.autograd.grad(pool2x(xi), xi, ct.to(where))
        grads.append(dx.cpu())
    err = float((grads[1] - grads[0]).norm() / grads[0].norm())
    assert err <= 1e-6, err


# ----------------------------------------------------------- fused_corr
#
# Bounds against the plain PyTorch versions on the same inputs: the forward
# 1e-5 abs (the dot over D summed in another order, taps O(1)); df1/df2
# 1e-5 abs in fp32, and in bf16 one bf16 ulp of the plain value where that
# is larger (both round one fp32 sum once); df2 bitwise from run to run.

from raft_stereo_tpu_torch.ops.kernels import fused_corr as fc  # noqa: E402

# (B, H, W1, W2, D): the hires levels (1/4 of 2016x2880), the SceneFlow
# training levels, and the odd and degenerate widths (W2 <= 2r+2)
FUSED_SHAPES = [(1, 504, 720, 720, 256), (1, 504, 720, 90, 256),
                (8, 80, 180, 180, 256), (8, 80, 180, 22, 256),
                (2, 3, 15, 15, 256), (1, 2, 15, 7, 256), (1, 2, 15, 3, 256),
                (1, 2, 15, 1, 256), (1, 3, 33, 40, 96)]


def _fused_inputs(shape, dtype, device, seed=0):
    b, h, w1, w2, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    f1 = torch.randn((b, h, w1, d), generator=g, device=device).to(dtype)
    f2 = torch.randn((b, h, w2, d), generator=g, device=device).to(dtype)
    center = (torch.rand((b, h, w1), generator=g, device=device)
              * (w2 + 4 * R + 4) - 2 * R - 2)
    flat = center.view(-1)
    edge = [0.0, -1.0, float(w2 - 1), float(w2), 1e9, -1e9, float("nan")]
    flat[:len(edge)] = torch.tensor(edge, device=device)
    return f1, f2, center


def _close(got, want, dtype):
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return False
    diff = (got.float() - want.float())[~nan].abs()
    ulp = want.float()[~nan].abs() * (2.0 ** -7 if dtype == torch.bfloat16
                                      else 0.0)
    return bool((diff <= torch.clamp(ulp, min=1e-5)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_kernels_match_plain(cuda, dtype, shape):
    f1, f2, center = _fused_inputs(shape, dtype, cuda)
    ct = _cotangent(shape[:4], cuda)
    before = (fc.fused_corr.launches, fc.fused_corr.bwd_launches)
    out = fc.fused_corr(f1, f2, center, R)
    df1, df2 = fc.fused_corr_backward(f1, f2, center, ct, R)
    torch.cuda.synchronize()
    assert (fc.fused_corr.launches, fc.fused_corr.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    want = fc.fused_corr_plain(f1, f2, center, R)
    w1, w2 = fc.fused_corr_backward_plain(f1, f2, center, ct, R)
    assert bool(torch.isnan(want).any())
    assert _close(out, want, torch.float32)
    assert df1.dtype == df2.dtype == dtype
    assert _close(df1, w1, dtype) and _close(df2, w2, dtype)
    assert bool((out.view(-1, 2 * R + 1)[4:6] == 0).all())  # far out
    assert bool((df1.view(-1, shape[-1])[4:6] == 0).all())


def test_fused_other_radii(cuda):
    f1, f2, center = _fused_inputs((2, 4, 40, 40, 64), torch.float32, cuda)
    for radius in (0, 1, 3, 8):
        ct = torch.randn(tuple(center.shape) + (2 * radius + 1,),
                         device=cuda)
        assert _close(fc.fused_corr(f1, f2, center, radius),
                      fc.fused_corr_plain(f1, f2, center, radius),
                      torch.float32)
        got = fc.fused_corr_backward(f1, f2, center, ct, radius)
        want = fc.fused_corr_backward_plain(f1, f2, center, ct, radius)
        assert _close(got[0], want[0], torch.float32)
        assert _close(got[1], want[1], torch.float32)
    with pytest.raises(ValueError, match="radius"):
        fc.fused_corr(f1, f2, center, 9)


def test_fused_64bit_offsets(cuda):
    # B*H*W*D = 8320*1024*256 > 2**31 elements in each feature map: the
    # last rows lie past 2**31
    shape = (1, 8320, 1024, 1024, 256)
    f1 = torch.zeros(shape[:3] + (256,), dtype=torch.bfloat16, device=cuda)
    f2 = torch.zeros_like(f1)
    g = torch.Generator(device=cuda).manual_seed(1)
    f1[0, -1] = torch.randn((1024, 256), generator=g, device=cuda).to(
        torch.bfloat16)
    f2[0, -1] = torch.randn((1024, 256), generator=g, device=cuda).to(
        torch.bfloat16)
    center = torch.rand(shape[:3], generator=g, device=cuda) * 1024
    ct = _cotangent(shape[:4], cuda)
    out = fc.fused_corr(f1, f2, center, R)
    df1, df2 = fc.fused_corr_backward(f1, f2, center, ct, R)
    torch.cuda.synchronize()
    last = (slice(None), slice(-1, None))
    want = fc.fused_corr_plain(f1[last], f2[last], center[last], R)
    w1, w2 = fc.fused_corr_backward_plain(f1[last], f2[last], center[last],
                                          ct[last], R)
    assert bool(want.abs().max() > 0)
    assert _close(out[last], want, torch.float32)
    assert _close(df1[last], w1, torch.bfloat16)
    assert _close(df2[last], w2, torch.bfloat16)
    del f1, f2, df1, df2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_backward_is_deterministic(cuda, dtype):
    # many pixels land on each w2 at the coarse level; two runs are bitwise
    # equal (no float atomics)
    f1, f2, center = _fused_inputs((8, 80, 180, 22, 256), dtype, cuda)
    ct = _cotangent((8, 80, 180, 22), cuda)
    a = fc.fused_corr_backward(f1, f2, center, ct, R)
    b = fc.fused_corr_backward(f1, f2, center, ct, R)
    assert _same(a[0], b[0]) and _same(a[1], b[1])


def test_fused_autograd_launches_and_no_center_grad(cuda):
    f1, f2, center = _fused_inputs((1, 4, 32, 32, 64), torch.float32, cuda)
    f1.requires_grad_()
    f2.requires_grad_()
    center = center.nan_to_num(0.0).requires_grad_()
    before = (fc.fused_corr.launches, fc.fused_corr.bwd_launches)
    out = fc.fused_corr(f1, f2, center, R)
    ct = torch.randn(out.shape, device=cuda)
    df1, df2, dc = torch.autograd.grad(out, (f1, f2, center), ct,
                                       allow_unused=True)
    assert (fc.fused_corr.launches, fc.fused_corr.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert dc is None
    want = fc.fused_corr_backward_plain(f1.detach(), f2.detach(),
                                        center.detach(), ct, R)
    assert _close(df1, want[0], torch.float32)
    assert _close(df2, want[1], torch.float32)


def test_fused_wrapper_refuses_bad_inputs(cuda):
    f1, f2, center = _fused_inputs((1, 2, 8, 16, 32), torch.float32, cuda)
    def strided(x):  # same shape, not contiguous
        return x.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fc.fused_corr(strided(f1), f2, center, R)
    with pytest.raises(TypeError, match="dtype"):
        fc.fused_corr(f1.half(), f2.half(), center, R)
    with pytest.raises(TypeError, match="dtype"):
        fc.fused_corr(f1, f2.bfloat16(), center, R)
    with pytest.raises(ValueError, match="want fmap1"):
        fc.fused_corr(f1, f2[..., :16].contiguous(), center, R)
    with pytest.raises(ValueError, match="CUDA device"):
        fc.fused_corr(f1, f2, center.cpu(), R)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_backward_wide_row(cuda, dtype):
    # W1 = W2 = 4000 at 1/4 resolution (a 16,000-pixel-wide pair), above
    # the ~2,640 pixels a whole row in one block's shared memory allowed:
    # the row is tiled over W2, within the bound of plain, bitwise run to
    # run
    f1, f2, center = _fused_inputs((1, 4, 4000, 4000, 256), dtype, cuda,
                                   seed=3)
    ct = _cotangent((1, 4, 4000, 4000), cuda, seed=4)
    before = fc.fused_corr.bwd_launches
    a = fc.fused_corr_backward(f1, f2, center, ct, R)
    b = fc.fused_corr_backward(f1, f2, center, ct, R)
    torch.cuda.synchronize()
    assert fc.fused_corr.bwd_launches == before + 2
    want = fc.fused_corr_backward_plain(f1, f2, center, ct, R)
    assert _close(a[0], want[0], dtype) and _close(a[1], want[1], dtype)
    assert _same(a[0], b[0]) and _same(a[1], b[1])
    assert float(a[1].float().nan_to_num().abs().max()) > 0


def test_fused_memory_contract(cuda):
    # the 4-level lookup at the hires shape allocates its outputs and less
    # than an eighth of one level-0 volume more; the backward at level 0
    # df1 + df2 and that margin
    from raft_stereo_tpu_torch.ops.corr import corr_lookup, init_corr
    b, h, w, d = 1, 504, 720, 256
    margin = b * h * w * w * 4 // 8
    f1, f2, center = _fused_inputs((b, h, w, w, d), torch.float32, cuda)
    center = center.nan_to_num(0.0)
    state = init_corr("fused", f1, f2, num_levels=4, radius=R)
    assert all(lv.shape == (b, h, w >> i, d)
               for i, lv in enumerate(state.levels))
    coords = torch.stack([center, torch.zeros_like(center)], dim=-1)
    for fn, own in [
            (lambda: corr_lookup(state, coords), 2 * b * h * w * 36 * 4),
            (lambda: fc.fused_corr_backward(
                f1, f2, center, torch.randn((b, h, w, 2 * R + 1),
                                            device=cuda), R),
             2 * f1.numel() * 4 + b * h * w * (2 * R + 1) * 4)]:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated(cuda) - base <= own + margin
        del out


def _model_step_matches_reg(cuda, impl, kernel, launches, **kw):
    # one fp32 training step through a kernel path against the same step
    # through the volume and the plain lookup (reg), both on the card.
    # Bounds: loss 1e-5 relative; all gradients within 1e-3 relative L2
    # (the size of a 1e-6 weight perturbation's null run, PERF.md)
    from raft_stereo_tpu_torch.training.state import loss_and_grads
    kw = dict(hidden_dims=(32, 32, 32), **kw)
    model_k = init_weights(
        RAFTStereo(RAFTStereoConfig(corr_implementation=impl, **kw)),
        torch.Generator().manual_seed(0))
    model_p = RAFTStereo(RAFTStereoConfig(corr_implementation="reg",
                                          hidden_dims=(32, 32, 32)))
    model_p.load_state_dict(model_k.state_dict(), strict=True)
    model_k.to(cuda)
    model_p.to(cuda)
    with torch.no_grad():
        model_k.update_block.flow_head.conv2.weight.mul_(0.1)
        model_p.update_block.flow_head.conv2.weight.mul_(0.1)
    g = torch.Generator(device=cuda).manual_seed(5)
    left = torch.rand((2, 64, 384, 3), generator=g, device=cuda) * 255
    batch = {"image1": left, "image2": torch.roll(left, -4, dims=2),
             "flow": -4 * torch.ones((2, 64, 384, 1), device=cuda),
             "valid": torch.ones((2, 64, 384), device=cuda)}
    kernels = (windowed_sample, fc.fused_corr, ac.alt_corr,
               fl.fused_lookup_c1)
    for k in kernels:
        k.launches = k.bwd_launches = 0
    loss_k, _, grads_k = loss_and_grads(model_k, batch, 3)
    assert (kernel.launches, kernel.bwd_launches) == launches
    assert all(k.launches == k.bwd_launches == 0 for k in kernels
               if k is not kernel)
    loss_p, _, grads_p = loss_and_grads(model_p, batch, 3)
    assert abs(float(loss_k) - float(loss_p)) <= 1e-5 * float(loss_p)
    flat_k = torch.cat([x.flatten() for x in grads_k]).double()
    flat_p = torch.cat([x.flatten() for x in grads_p]).double()
    assert float((flat_k - flat_p).norm() / flat_p.norm()) <= 1e-3
    return {n: gr for (n, _), gr in zip(model_k.named_parameters(), grads_k)}


def test_fused_model_train_step_matches_reg(cuda):
    # gradients reach the feature encoder through the fused lookup
    # one forward launch for the four levels an iteration (and its remat
    # recompute), four backward launches
    grads = _model_step_matches_reg(cuda, "alt_cuda", fc.fused_corr,
                                    (2 * 1 * 3, 4 * 3))
    assert all(float(gr.abs().max()) > 0 for n, gr in grads.items()
               if n.startswith("fnet."))


# The one-launch forward over 1 to 4 pyramid levels (level i around
# center / 2**i): the same bound against the plain levels concatenated, two
# runs bitwise equal, and bitwise equal to the one-level launches.


def _pyramid(f2, n):
    from raft_stereo_tpu_torch.ops.geometry import pool_w2
    levels = [f2]
    for _ in range(n - 1):
        levels.append(pool_w2(levels[-1]).contiguous())
    return levels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_fused_pyramid_matches_plain(cuda, dtype, n):
    # level widths 96 .. 12 and, at a 13-wide level 0, 13 .. 1 (W2 <= 2r+2)
    for shape in [(2, 8, 96, 96, 64), (1, 4, 13, 13, 256)]:
        f1, f2, center = _fused_inputs(shape, dtype, cuda)
        levels = _pyramid(f2, n)
        before = fc.fused_corr.launches
        out = fc.fused_corr_pyramid_forward(f1, levels, center, R)
        again = fc.fused_corr_pyramid_forward(f1, levels, center, R)
        torch.cuda.synchronize()
        assert fc.fused_corr.launches == before + 2
        want = fc.fused_corr_pyramid_plain(f1, levels, center, R)
        assert out.shape == want.shape == shape[:3] + (n * (2 * R + 1),)
        assert bool(torch.isnan(want).any())
        assert _close(out, want, torch.float32)
        assert _same(out, again)
        ones = torch.cat([fc.fused_corr_forward(f1, lv, center / (2 ** i), R)
                          for i, lv in enumerate(levels)], dim=-1)
        assert _same(out, ones)
        assert bool((out.view(-1, n * (2 * R + 1))[4:6] == 0).all())


def test_fused_pyramid_other_radii(cuda):
    f1, f2, center = _fused_inputs((2, 4, 40, 40, 64), torch.float32, cuda)
    levels = _pyramid(f2, 4)
    for radius in (0, 1, 3, 8):
        assert _close(fc.fused_corr_pyramid_forward(f1, levels, center,
                                                    radius),
                      fc.fused_corr_pyramid_plain(f1, levels, center, radius),
                      torch.float32)


def test_fused_pyramid_64bit_offsets(cuda):
    # B*H*W*D = 8320*1024*256 > 2**31 elements in fmap1 and level 0: the
    # last rows lie past 2**31
    shape = (1, 8320, 1024, 1024, 256)
    f1 = torch.zeros(shape[:3] + (256,), dtype=torch.bfloat16, device=cuda)
    f2 = torch.zeros_like(f1)
    g = torch.Generator(device=cuda).manual_seed(1)
    f1[0, -1] = torch.randn((1024, 256), generator=g, device=cuda).to(
        torch.bfloat16)
    f2[0, -1] = torch.randn((1024, 256), generator=g, device=cuda).to(
        torch.bfloat16)
    levels = _pyramid(f2, 4)
    center = torch.rand(shape[:3], generator=g, device=cuda) * 1024
    out = fc.fused_corr_pyramid_forward(f1, levels, center, R)
    torch.cuda.synchronize()
    last = (slice(None), slice(-1, None))
    want = fc.fused_corr_pyramid_plain(f1[last], [lv[last] for lv in levels],
                                       center[last], R)
    assert bool(want.abs().max() > 0)
    assert _close(out[last], want, torch.float32)
    del f1, f2, levels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_pyramid_is_deterministic(cuda, dtype):
    f1, f2, center = _fused_inputs((8, 80, 180, 180, 256), dtype, cuda)
    levels = _pyramid(f2, 4)
    assert _same(fc.fused_corr_pyramid_forward(f1, levels, center, R),
                 fc.fused_corr_pyramid_forward(f1, levels, center, R))


def test_fused_pyramid_refuses_mismatched_levels(cuda):
    f1, f2, center = _fused_inputs((2, 4, 16, 16, 32), torch.float32, cuda)
    good = _pyramid(f2, 2)
    for bad, match in [
            (torch.zeros((1, 4, 8, 32), device=cuda), "want fmap1"),  # batch
            (torch.zeros((2, 3, 8, 32), device=cuda), "want fmap1"),  # height
            (torch.zeros((2, 4, 8, 16), device=cuda), "want fmap1"),  # D
            (good[1].bfloat16(), "dtype")]:
        err = TypeError if match == "dtype" else ValueError
        with pytest.raises(err, match=match):
            fc.fused_corr_pyramid_forward(f1, [good[0], bad], center, R)
    with pytest.raises(ValueError, match="levels"):
        fc.fused_corr_pyramid_forward(f1, good * 3, center, R)


def test_fused_pyramid_autograd_launches(cuda):
    # one forward launch for the four levels, one backward launch a level;
    # the gradients are the per-level backward's
    f1, f2, center = _fused_inputs((1, 4, 32, 32, 64), torch.float32, cuda)
    center = center.nan_to_num(0.0)
    levels = [lv.requires_grad_() for lv in _pyramid(f2, 4)]
    f1.requires_grad_()
    before = (fc.fused_corr.launches, fc.fused_corr.bwd_launches)
    out = fc.fused_corr_pyramid(f1, levels, center, R)
    ct = torch.randn(out.shape, device=cuda)
    grads = torch.autograd.grad(out, [f1, *levels], ct)
    assert (fc.fused_corr.launches, fc.fused_corr.bwd_launches) == (
        before[0] + 1, before[1] + 4)
    k = 2 * R + 1
    want1 = 0
    for i, lv in enumerate(levels):
        d1, d2 = fc.fused_corr_backward_plain(
            f1.detach(), lv.detach(), center / (2 ** i),
            ct[..., i * k:(i + 1) * k], R)
        want1 = want1 + d1
        assert _close(grads[1 + i], d2, torch.float32)
    assert _close(grads[0], want1, torch.float32)


# ------------------------------------------------------------- alt_corr
#
# alt_corr computes fused_corr's function by the slab formulation, so it
# is held to both plain versions and to fused_corr's kernels on the same
# inputs. Bounds as for fused_corr: the forward 1e-5 abs; df1/df2 1e-5 abs
# in fp32 and one bf16 ulp of the reference where larger in bf16; two runs
# bitwise equal.

from raft_stereo_tpu_torch.ops.kernels import alt_corr as ac  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_alt_kernels_match_plain_and_fused(cuda, dtype, shape):
    f1, f2, center = _fused_inputs(shape, dtype, cuda, seed=7)
    ct = _cotangent(shape[:4], cuda, seed=8)
    before = (ac.alt_corr.launches, ac.alt_corr.bwd_launches)
    out = ac.alt_corr(f1, f2, center, R)
    df1, df2 = ac.alt_corr_backward(f1, f2, center, ct, R)
    torch.cuda.synchronize()
    assert (ac.alt_corr.launches, ac.alt_corr.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    want = ac.alt_corr_plain(f1, f2, center, R)
    w1, w2 = ac.alt_corr_backward_plain(f1, f2, center, ct, R)
    assert bool(torch.isnan(want).any())
    assert _close(out, want, torch.float32)
    assert df1.dtype == df2.dtype == dtype
    assert _close(df1, w1, dtype) and _close(df2, w2, dtype)
    assert _close(out, fc.fused_corr_forward(f1, f2, center, R),
                  torch.float32)
    g1, g2 = fc.fused_corr_backward(f1, f2, center, ct, R)
    assert _close(df1, g1, dtype) and _close(df2, g2, dtype)
    assert bool((out.view(-1, 2 * R + 1)[4:6] == 0).all())  # far out
    assert bool((df1.view(-1, shape[-1])[4:6] == 0).all())


def test_alt_other_radii(cuda):
    f1, f2, center = _fused_inputs((2, 4, 70, 67, 40), torch.float32, cuda)
    for radius in (0, 1, 3, 8):
        ct = torch.randn(tuple(center.shape) + (2 * radius + 1,),
                         device=cuda)
        assert _close(ac.alt_corr(f1, f2, center, radius),
                      ac.alt_corr_plain(f1, f2, center, radius),
                      torch.float32)
        got = ac.alt_corr_backward(f1, f2, center, ct, radius)
        want = ac.alt_corr_backward_plain(f1, f2, center, ct, radius)
        assert _close(got[0], want[0], torch.float32)
        assert _close(got[1], want[1], torch.float32)


@pytest.mark.parametrize("radius", list(range(9)))
def test_alt_backward_every_radius(cuda, radius):
    # the band's backward at every radius, both dtypes, wide and narrow
    # rows: within the bound of plain and bitwise equal run to run
    for dtype in (torch.float32, torch.bfloat16):
        for shape in [(2, 4, 70, 67, 40), (1, 3, 300, 300, 64),
                      (1, 2, 15, 3, 256)]:
            f1, f2, center = _fused_inputs(shape, dtype, cuda, seed=radius)
            ct = torch.randn(tuple(center.shape) + (2 * radius + 1,),
                             device=cuda)
            a = ac.alt_corr_backward(f1, f2, center, ct, radius)
            b = ac.alt_corr_backward(f1, f2, center, ct, radius)
            want = ac.alt_corr_backward_plain(f1, f2, center, ct, radius)
            assert _same(a[0], b[0]) and _same(a[1], b[1])
            assert _close(a[0], want[0], dtype)
            assert _close(a[1], want[1], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_alt_kernels_are_deterministic(cuda, dtype):
    f1, f2, center = _fused_inputs((8, 80, 180, 22, 256), dtype, cuda)
    ct = _cotangent((8, 80, 180, 22), cuda)
    assert _same(ac.alt_corr(f1, f2, center, R),
                 ac.alt_corr(f1, f2, center, R))
    a = ac.alt_corr_backward(f1, f2, center, ct, R)
    b = ac.alt_corr_backward(f1, f2, center, ct, R)
    assert _same(a[0], b[0]) and _same(a[1], b[1])


def test_alt_autograd_launches_and_no_center_grad(cuda):
    f1, f2, center = _fused_inputs((1, 4, 32, 32, 64), torch.float32, cuda)
    f1.requires_grad_()
    f2.requires_grad_()
    center = center.nan_to_num(0.0).requires_grad_()
    before = (ac.alt_corr.launches, ac.alt_corr.bwd_launches)
    out = ac.alt_corr(f1, f2, center, R)
    ct = torch.randn(out.shape, device=cuda)
    df1, df2, dc = torch.autograd.grad(out, (f1, f2, center), ct,
                                       allow_unused=True)
    assert (ac.alt_corr.launches, ac.alt_corr.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert dc is None
    want = ac.alt_corr_backward_plain(f1.detach(), f2.detach(),
                                      center.detach(), ct, R)
    assert _close(df1, want[0], torch.float32)
    assert _close(df2, want[1], torch.float32)


def test_alt_wrapper_refuses_bad_inputs(cuda):
    f1, f2, center = _fused_inputs((1, 2, 8, 16, 32), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ac.alt_corr(f1.transpose(1, 2).contiguous().transpose(1, 2), f2,
                    center, R)
    with pytest.raises(TypeError, match="dtype"):
        ac.alt_corr(f1, f2.bfloat16(), center, R)
    with pytest.raises(ValueError, match="CUDA device"):
        ac.alt_corr(f1, f2, center.cpu(), R)
    with pytest.raises(ValueError, match="radius"):
        ac.alt_corr(f1, f2, center, 9)
    with pytest.raises(ValueError, match="cotangent"):
        ac.alt_corr_backward(f1, f2, center, torch.zeros((1, 2, 8, 3),
                                                         device=cuda), R)


def test_alt_memory_contract(cuda):
    # the 4-level lookup at the hires shape allocates its outputs and less
    # than an eighth of one level-0 volume more: no (W1, W2) slab
    from raft_stereo_tpu_torch.ops.corr import corr_lookup, init_corr
    b, h, w, d = 1, 504, 720, 256
    margin = b * h * w * w * 4 // 8
    f1, f2, center = _fused_inputs((b, h, w, w, d), torch.float32, cuda)
    center = center.nan_to_num(0.0)
    state = init_corr("alt_pallas", f1, f2, num_levels=4, radius=R)
    coords = torch.stack([center, torch.zeros_like(center)], dim=-1)
    for fn, own in [
            (lambda: corr_lookup(state, coords), 2 * b * h * w * 36 * 4),
            (lambda: ac.alt_corr_backward(
                f1, f2, center, torch.randn((b, h, w, 2 * R + 1),
                                            device=cuda), R),
             2 * f1.numel() * 4 + b * h * w * (2 * R + 1) * 4)]:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated(cuda) - base <= own + margin
        del out


def test_alt_model_train_step_matches_reg(cuda):
    # one forward launch for the four levels an iteration (and its remat
    # recompute), four backward launches
    _model_step_matches_reg(cuda, "alt_pallas", ac.alt_corr,
                            (2 * 1 * 3, 4 * 3))


# alt_corr's one-launch forward over 1 to 4 levels: bitwise equal to its
# plain version (which sums each slab entry in the kernel's order), to the
# one-level launches and from run to run.


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_alt_pyramid_matches_plain(cuda, dtype, n):
    # level widths 96 .. 12 and, at a 13-wide level 0, 13 .. 1 (W2 <= 2r+2)
    for w, d in ((96, 256), (13, 96)):
        f1, f2, center = _fused_inputs((2, 5, w, w, d), dtype, cuda, seed=n)
        levels = _pyramid(f2, n)
        before = ac.alt_corr.launches
        out = ac.alt_corr_pyramid_forward(f1, levels, center, R)
        again = ac.alt_corr_pyramid_forward(f1, levels, center, R)
        torch.cuda.synchronize()
        assert ac.alt_corr.launches == before + 2
        want = ac.alt_corr_pyramid_plain(f1, levels, center, R)
        assert bool(torch.isnan(want).any())
        assert _same(out, want) and _same(out, again)
        ones = torch.cat([ac.alt_corr_forward(f1, lv, center / (2 ** i), R)
                          for i, lv in enumerate(levels)], dim=-1)
        assert _same(out, ones)
        assert _close(out, fc.fused_corr_pyramid_forward(f1, levels, center,
                                                         R), torch.float32)


@pytest.mark.parametrize("radius", [0, 1, 3, 8])
def test_alt_pyramid_other_radii(cuda, radius):
    f1, f2, center = _fused_inputs((2, 4, 70, 70, 40), torch.float32, cuda)
    levels = _pyramid(f2, 4)
    assert _same(ac.alt_corr_pyramid_forward(f1, levels, center, radius),
                 ac.alt_corr_pyramid_plain(f1, levels, center, radius))


def test_alt_pyramid_autograd_launches(cuda):
    f1, f2, center = _fused_inputs((1, 4, 48, 48, 64), torch.float32, cuda)
    levels = [lv.requires_grad_() for lv in _pyramid(f2, 4)]
    f1.requires_grad_()
    center = center.nan_to_num(0.0)
    before = (ac.alt_corr.launches, ac.alt_corr.bwd_launches)
    out = ac.alt_corr_pyramid(f1, levels, center, R)
    ct = torch.randn(out.shape, device=cuda)
    grads = torch.autograd.grad(out, [f1, *levels], ct)
    assert (ac.alt_corr.launches, ac.alt_corr.bwd_launches) == (
        before[0] + 1, before[1] + 4)
    k = 2 * R + 1
    df1 = None
    for i in reversed(range(4)):
        d1, d2 = ac.alt_corr_backward_plain(
            f1.detach(), levels[i].detach(), center / (2 ** i),
            ct[..., i * k:(i + 1) * k], R)
        df1 = d1 if df1 is None else df1 + d1
        assert _close(grads[1 + i], d2, torch.float32)
    assert _close(grads[0], df1, torch.float32)


# ------------------------------------------------- the hires conv (gru32)

def test_gru32_hires_conv_keeps_flags_and_matches_cpu(cuda):
    # update_block.gru32 at 1/16 of a 2016x2880 pair, fp32 with TF32 off:
    # cuDNN's heuristic ran its three gate convs as FFTs of ~33,000
    # kernels each. The forward launches no FFT kernel, leaves every global
    # cuDNN flag as it found it, and matches the CPU within 1e-4 abs (gate
    # outputs in [-1, 1]; sums of 2304 fp32 products in another order)
    from torch.profiler import ProfilerActivity, profile

    from raft_stereo_tpu_torch.nn.gru import ConvGRU
    g = torch.Generator().manual_seed(0)
    gru = ConvGRU(128, 128)
    with torch.no_grad():
        for p in gru.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    h = torch.tanh(torch.randn((1, 126, 180, 128), generator=g))
    x = torch.randn((1, 126, 180, 128), generator=g)
    cz, cr, cq = (torch.randn((1, 126, 180, 128), generator=g) * 0.1
                  for _ in range(3))
    want = gru(h, cz, cr, cq, x)
    gru.to(cuda)
    args = [t.to(cuda) for t in (h, cz, cr, cq, x)]
    flags = torch.backends.cudnn
    before = (flags.enabled, flags.benchmark, flags.deterministic,
              flags.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = gru(*args)
        torch.cuda.synchronize()
    after = (flags.enabled, flags.benchmark, flags.deterministic,
             flags.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    assert after == before
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and not any("fft" in n.lower() for n in names)
    assert float((got.cpu() - want).abs().max()) <= 1e-4


# --------------------------------------------------------- fused_lookup
#
# Bounds against the plain PyTorch versions on the same inputs: the forward
# and dvol 1e-5 abs in fp32 and one bf16 ulp of the plain value where larger
# in bf16 (both take the products in the same order and round each, so they
# are expected to be equal); dk/db 1e-5 of their largest magnitude (sums
# over every pixel in another order); every output bitwise equal from run
# to run.

from raft_stereo_tpu_torch.ops.kernels import fused_lookup as fl  # noqa: E402

# (B, H, W1, level-0 W2): the default and realtime frames, the SceneFlow
# batch, and a small odd pyramid down to W2 = 3
LOOKUP_SHAPES = [(1, 96, 312, 312), (1, 48, 156, 156), (8, 80, 180, 180),
                 (2, 3, 25, 25)]


def _lookup_inputs(shape, vdt, device, seed=0, nan=True):
    b, h, w1, w2 = shape
    g = torch.Generator(device=device).manual_seed(seed)
    levels = [torch.randn((b, h, w1, w2 >> i), generator=g,
                          device=device).to(vdt) for i in range(4)]
    coords = (torch.rand((b, h, w1), generator=g, device=device)
              * (w2 + 4 * R + 4) - 2 * R - 2)
    flat = coords.view(-1)
    edge = [0.0, -1.0, float(w2 - 1), float(w2), 1e9, -1e9,
            float("nan") if nan else 0.5]
    flat[:len(edge)] = torch.tensor(edge, device=device)
    kern = torch.randn((36, 64), generator=g, device=device) * 0.2
    bias = torch.randn((64,), generator=g, device=device) * 0.1
    return levels, coords, kern, bias


def _rel_close(got, want):
    scale = float(want.abs().max())
    return float((got - want).abs().max()) <= 1e-5 * max(scale, 1e-30)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LOOKUP_SHAPES)
def test_fused_lookup_kernels_match_plain(cuda, vdt, dt, shape):
    levels, coords, kern, bias = _lookup_inputs(shape, vdt, cuda)
    g = torch.Generator(device=cuda).manual_seed(9)
    ct = torch.randn(shape[:3] + (64,), generator=g, device=cuda).to(dt)
    before = (fl.fused_lookup_c1.launches, fl.fused_lookup_c1.bwd_launches)
    out = fl.fused_lookup_c1(levels, coords, kern, bias, R, dt)
    dvols, dk, db = fl.fused_lookup_backward(levels, coords, kern, bias, ct,
                                             R, dt)
    torch.cuda.synchronize()
    assert (fl.fused_lookup_c1.launches,
            fl.fused_lookup_c1.bwd_launches) == (before[0] + 1,
                                                 before[1] + 1)
    want = fl.fused_lookup_c1_plain(levels, coords, kern, bias, R, dt)
    w_dvols, w_dk, w_db = fl.fused_lookup_c1_backward_plain(
        levels, coords, kern, bias, ct, R, dt)
    assert out.dtype == dt and out.shape == shape[:3] + (64,)
    assert bool(torch.isnan(want).any())
    assert _close(out, want, dt)
    for got, ref in zip(dvols, w_dvols):
        assert got.dtype == vdt and got.shape == ref.shape
        assert _close(got, ref, vdt)
    assert bool((out.view(-1, 64)[4:6] == torch.relu(bias).to(dt)).all())
    assert bool((dvols[0].view(-1, shape[-1])[4:6] == 0).all())
    # a NaN center makes every dk element NaN: dk/db on finite centers
    coords = coords.nan_to_num(0.0)
    _, dk, db = fl.fused_lookup_backward(levels, coords, kern, bias, ct, R,
                                         dt)
    _, w_dk, w_db = fl.fused_lookup_c1_backward_plain(levels, coords, kern,
                                                      bias, ct, R, dt)
    assert _rel_close(dk, w_dk) and _rel_close(db, w_db)


# (B, H, W1, level-0 W2) for the tiled kernels: on a 132-SM H100 the forward
# takes tiles of 16, 32 and 64 pixels at these sizes, each with a ragged last
# tile (111, 530, 6157 and 8777 pixels), and so does the backward's 64; odd
# widths at every level (41/5, 77/19, 47/23, 67/33) and dvol runs that end
# mid-pack (the scalar tail).
TILE_SHAPES = [(1, 3, 37, 41), (2, 5, 53, 77), (1, 47, 131, 47),
               (1, 67, 131, 67)]


@pytest.mark.parametrize("radius", [0, 8])
@pytest.mark.parametrize("vdt,dt", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_fused_lookup_tiles_bitwise(cuda, shape, vdt, dt, radius):
    """Forward and dvol bitwise equal to plain on ragged tiles, odd widths
    and NaN / +-1e9 centers; two backward runs bitwise equal; dk/db within
    1e-5 of plain on finite centers."""
    levels, coords, _, bias = _lookup_inputs(shape, vdt, cuda, seed=5)
    g = torch.Generator(device=cuda).manual_seed(6)
    kern = torch.randn((4 * (2 * radius + 1), 64), generator=g,
                       device=cuda) * 0.2
    ct = torch.randn(shape[:3] + (64,), generator=g, device=cuda).to(dt)
    out = fl.fused_lookup_c1(levels, coords, kern, bias, radius, dt)
    first = fl.fused_lookup_backward(levels, coords, kern, bias, ct, radius,
                                     dt)
    again = fl.fused_lookup_backward(levels, coords, kern, bias, ct, radius,
                                     dt)
    want = fl.fused_lookup_c1_plain(levels, coords, kern, bias, radius, dt)
    w_dvols, _, _ = fl.fused_lookup_c1_backward_plain(
        levels, coords, kern, bias, ct, radius, dt)
    torch.cuda.synchronize()
    assert bool(torch.isnan(out).any()) and _same(out, want)
    assert all(_same(a, b) for a, b in zip(first[0], w_dvols))
    assert all(_same(a, b) for a, b in zip(first[0] + first[1:],
                                           again[0] + again[1:]))
    assert bool((out.view(-1, 64)[4:6] == torch.relu(bias).to(dt)).all())
    assert all(bool((d.view(-1, d.shape[-1])[4:6] == 0).all())
               for d in first[0])
    finite = coords.nan_to_num(0.0)
    _, dk, db = fl.fused_lookup_backward(levels, finite, kern, bias, ct,
                                         radius, dt)
    _, w_dk, w_db = fl.fused_lookup_c1_backward_plain(levels, finite, kern,
                                                      bias, ct, radius, dt)
    assert _rel_close(dk, w_dk) and _rel_close(db, w_db)


def test_fused_lookup_other_radii(cuda):
    for radius in (0, 1, 3, 8):
        levels, coords, _, bias = _lookup_inputs((2, 4, 40, 40),
                                                 torch.float32, cuda,
                                                 nan=False)
        kern = torch.randn((4 * (2 * radius + 1), 64), device=cuda)
        ct = torch.randn((2, 4, 40, 64), device=cuda)
        assert _close(fl.fused_lookup_c1(levels, coords, kern, bias, radius),
                      fl.fused_lookup_c1_plain(levels, coords, kern, bias,
                                               radius), torch.float32)
        got = fl.fused_lookup_backward(levels, coords, kern, bias, ct,
                                       radius)
        want = fl.fused_lookup_c1_backward_plain(levels, coords, kern, bias,
                                                 ct, radius)
        assert all(_close(a, b, torch.float32)
                   for a, b in zip(got[0], want[0]))
        assert _rel_close(got[1], want[1]) and _rel_close(got[2], want[2])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_fused_lookup_backward_is_deterministic(cuda, dt):
    levels, coords, kern, bias = _lookup_inputs((8, 80, 180, 180),
                                                torch.bfloat16, cuda,
                                                nan=False)
    ct = torch.randn((8, 80, 180, 64), device=cuda).to(dt)
    a = fl.fused_lookup_backward(levels, coords, kern, bias, ct, R, dt)
    b = fl.fused_lookup_backward(levels, coords, kern, bias, ct, R, dt)
    assert all(_same(x, y) for x, y in zip(a[0], b[0]))
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_fused_lookup_autograd_launches_and_no_coords_grad(cuda):
    levels, coords, kern, bias = _lookup_inputs((1, 4, 32, 32),
                                                torch.float32, cuda)
    levels = [v.requires_grad_() for v in levels]
    coords = coords.nan_to_num(0.0).requires_grad_()
    kern = kern.t().contiguous().t().requires_grad_()  # a strided view
    bias.requires_grad_()
    before = (fl.fused_lookup_c1.launches, fl.fused_lookup_c1.bwd_launches)
    out = fl.fused_lookup_c1(levels, coords, kern, bias, R)
    ct = torch.randn(out.shape, device=cuda)
    grads = torch.autograd.grad(out, (*levels, coords, kern, bias), ct,
                                allow_unused=True)
    assert (fl.fused_lookup_c1.launches,
            fl.fused_lookup_c1.bwd_launches) == (before[0] + 1,
                                                 before[1] + 1)
    assert grads[4] is None
    want = fl.fused_lookup_c1_backward_plain(
        [v.detach() for v in levels], coords.detach(), kern.detach(),
        bias.detach(), ct, R)
    assert all(_close(a, b, torch.float32) for a, b in zip(grads[:4],
                                                           want[0]))
    assert _rel_close(grads[5], want[1]) and _rel_close(grads[6], want[2])


def test_fused_lookup_wrapper_refuses_bad_inputs(cuda):
    levels, coords, kern, bias = _lookup_inputs((1, 2, 16, 16),
                                                torch.float32, cuda)
    with pytest.raises(ValueError, match="4 levels|levels, want"):
        fl.fused_lookup_c1(levels[:3], coords, kern, bias, R)
    with pytest.raises(TypeError, match="dtype"):
        fl.fused_lookup_c1([levels[0].bfloat16()] + levels[1:], coords, kern,
                           bias, R)
    with pytest.raises(ValueError, match="CUDA device"):
        fl.fused_lookup_c1(levels, coords.cpu(), kern, bias, R)
    with pytest.raises(ValueError, match="radius"):
        fl.fused_lookup_c1(levels, coords, kern, bias, 9)
    with pytest.raises(ValueError, match="want kernel"):
        fl.fused_lookup_c1(levels, coords, kern[:35], bias, R)


@pytest.mark.parametrize("impl", ["reg", "reg_cuda"])
def test_fused_lookup_model_train_step_matches_reg(cuda, impl):
    # a 1/4-resolution grid 16x96: pyramid widths 96/48/24/12, all > 2r+2
    _model_step_matches_reg(cuda, impl, fl.fused_lookup_c1,
                            (2 * 3, 3), fused_lookup=True)


# ---------------------------------------------- windowed_sample_pyramid

# (volume dtype, (B, H, W1, level-0 W2)): the default, realtime and train
# pyramids, and ragged or odd ones (tiles that do not fill, levels down to
# W2 <= 2r+2, W1 != W2)
WS_PYRAMIDS = [(torch.float32, (1, 96, 312, 312)),
               (torch.bfloat16, (1, 48, 156, 156)),
               (torch.bfloat16, (8, 80, 180, 180)),
               (torch.float32, (1, 3, 37, 37)),
               (torch.bfloat16, (2, 5, 15, 15)),
               (torch.float32, (1, 7, 50, 23)),
               (torch.bfloat16, (3, 1, 65, 130))]


def _ws_pyramid_inputs(dtype, shape, n, device, radius=R, seed=0):
    b, h, w1, w2 = shape
    g = torch.Generator(device=device).manual_seed(seed)
    levels = [torch.randn((b, h, w1, w2 >> i), generator=g,
                          device=device).to(dtype) for i in range(n)]
    center = (torch.rand((b, h, w1), generator=g, device=device)
              * (w2 + 4 * radius + 4) - 2 * radius - 2)
    edge = [0.0, -1.0, float(w2 - 1), float(w2), 1e9, -1e9, float("nan"),
            0.999999, -radius - 0.5]
    center.view(-1)[:len(edge)] = torch.tensor(edge, device=device)
    ct = torch.randn((b, h, w1, n * (2 * radius + 1)), generator=g,
                     device=device)
    return levels, center, ct


def _ws_pyramid_check(levels, center, ct, radius):
    """The pyramid kernels against their plain versions: forward and every
    dvol bitwise equal (NaN patterns included), dcoords within 1e-5, two
    runs bitwise equal, one launch a call each way."""
    before = (ws.windowed_sample.launches, ws.windowed_sample.bwd_launches)
    out = ws.windowed_sample_pyramid_forward(levels, center, radius)
    again = ws.windowed_sample_pyramid_forward(levels, center, radius)
    dvols, dc = ws.windowed_sample_pyramid_backward(levels, center, ct,
                                                    radius)
    dvols2, dc2 = ws.windowed_sample_pyramid_backward(levels, center, ct,
                                                      radius)
    torch.cuda.synchronize()
    assert (ws.windowed_sample.launches, ws.windowed_sample.bwd_launches) \
        == (before[0] + 2, before[1] + 2)
    want = ws.windowed_sample_pyramid_plain(levels, center, radius)
    want_dvols, want_dc = ws.windowed_sample_pyramid_backward_plain(
        levels, center, ct, radius)
    assert out.shape == want.shape and _same(out, want) and _same(out, again)
    assert bool(torch.isnan(out).any())
    k = 2 * radius + 1
    assert bool((out.view(-1, len(levels) * k)[4:6] == 0).all())
    for v, dv, dv2, wdv in zip(levels, dvols, dvols2, want_dvols):
        assert dv.dtype == v.dtype and dv.shape == v.shape
        assert _same(dv, wdv) and _same(dv, dv2)
        assert bool((dv.view(-1, v.shape[-1])[4:6] == 0).all())
    assert _same(dc, dc2)
    nan = torch.isnan(want_dc)
    assert torch.equal(torch.isnan(dc), nan)
    assert (dc - want_dc)[~nan].abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype,shape", WS_PYRAMIDS)
def test_ws_pyramid_kernels_bitwise_plain(cuda, dtype, shape):
    _ws_pyramid_check(*_ws_pyramid_inputs(dtype, shape, 4, cuda), R)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("dtype,shape", [WS_PYRAMIDS[2], WS_PYRAMIDS[3]])
def test_ws_pyramid_fewer_levels(cuda, dtype, shape, n):
    _ws_pyramid_check(*_ws_pyramid_inputs(dtype, shape, n, cuda), R)


@pytest.mark.parametrize("radius", [0, 1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ws_pyramid_other_radii(cuda, dtype, radius):
    _ws_pyramid_check(*_ws_pyramid_inputs(dtype, (2, 6, 70, 70), 4, cuda,
                                          radius=radius), radius)


def test_ws_pyramid_equals_one_level_launches(cuda):
    levels, center, ct = _ws_pyramid_inputs(torch.bfloat16, (8, 80, 180, 180),
                                            4, cuda)
    out = ws.windowed_sample_pyramid_forward(levels, center, R)
    dvols, _ = ws.windowed_sample_pyramid_backward(levels, center, ct, R,
                                                   need_dcoords=False)
    k = 2 * R + 1
    ones = torch.cat([ws.windowed_sample_forward(v, center / 2 ** i, R)
                      for i, v in enumerate(levels)], dim=-1)
    assert _same(out, ones)
    for i, (v, dv) in enumerate(zip(levels, dvols)):
        one, _ = ws.windowed_sample_backward(
            v, center / 2 ** i, ct[..., i * k:(i + 1) * k], R,
            need_dcoords=False)
        assert _same(dv, one)


def test_ws_pyramid_autograd_launches(cuda):
    levels, center, ct = _ws_pyramid_inputs(torch.float32, (1, 4, 32, 32), 4,
                                            cuda)
    levels = [v.requires_grad_() for v in levels]
    center = center.nan_to_num(0.0)
    before = (ws.windowed_sample.launches, ws.windowed_sample.bwd_launches)
    out = ws.windowed_sample_pyramid(levels, center, R)
    grads = torch.autograd.grad(out, levels, ct)
    assert (ws.windowed_sample.launches, ws.windowed_sample.bwd_launches) \
        == (before[0] + 1, before[1] + 1)
    want, _ = ws.windowed_sample_pyramid_backward_plain(
        [v.detach() for v in levels], center, ct, R)
    assert all(_same(a, b) for a, b in zip(grads, want))
    # the center's gradient only where asked for, from the same launch
    c = center.clone().requires_grad_()
    out = ws.windowed_sample_pyramid([v.detach() for v in levels], c, R)
    (dc,) = torch.autograd.grad(out, (c,), ct)
    _, want_dc = ws.windowed_sample_pyramid_backward_plain(levels, center,
                                                           ct, R)
    assert (dc - want_dc).abs().max().item() <= 1e-5


def test_ws_pyramid_refuses_bad_inputs(cuda):
    levels, center, _ = _ws_pyramid_inputs(torch.float32, (1, 2, 16, 16), 4,
                                           cuda)
    with pytest.raises(ValueError, match="5 levels"):
        ws.windowed_sample_pyramid(levels + levels[:1], center, R)
    with pytest.raises(TypeError, match="not all float32"):
        ws.windowed_sample_pyramid([levels[0], levels[1].bfloat16()], center,
                                   R)
    with pytest.raises(ValueError, match="want volumes"):
        ws.windowed_sample_pyramid([levels[0], levels[1][:, :1].contiguous()],
                                   center, R)
    with pytest.raises(ValueError, match="want volumes"):
        ws.windowed_sample_pyramid(
            [levels[0], levels[1][..., :15, :].contiguous()], center, R)
    strided = levels[1].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ws.windowed_sample_pyramid_forward([levels[0], strided], center, R)
    with pytest.raises(ValueError, match="CUDA device"):
        ws.windowed_sample_pyramid_forward([levels[0], levels[1].cpu()],
                                           center, R)
    with pytest.raises(ValueError, match="radius"):
        ws.windowed_sample_pyramid(levels, center, 9)
    with pytest.raises(ValueError, match="cotangent"):
        ws.windowed_sample_pyramid_backward(
            levels, center, torch.zeros((1, 2, 16, 9), device=cuda), R)


# ------------------------------------------------- the evaluation path

def _eval_predictor(cuda, **kw):
    from raft_stereo_tpu_torch.inference import StereoPredictor
    cfg = RAFTStereoConfig(corr_implementation="reg_cuda", **kw)
    model = init_weights(RAFTStereo(cfg), torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(0.1)
    return StereoPredictor(cfg, model.state_dict(), valid_iters=4,
                           device=cuda)


def test_predict_async_in_flight_matches_call(cuda):
    """Four handles in flight at once (pinned staging, asynchronous
    copies, an event each), fetched in turn: each equals ``__call__`` on
    its own frame, bitwise, and the kernel ran for every frame."""
    import numpy as np
    pred = _eval_predictor(cuda)
    rng = np.random.default_rng(0)
    frames = [(rng.integers(0, 255, (1, 64, 160, 3), dtype=np.uint8),
               rng.integers(0, 255, (1, 64, 160, 3), dtype=np.uint8))
              for _ in range(4)]
    want = [pred(a, b) for a, b in frames]
    ws.windowed_sample.launches = 0
    handles = [pred.predict_async(a, b) for a, b in frames]
    assert handles[-1]._host.is_pinned()
    assert all(h._staged[0].is_pinned() for h in handles)
    got = [h.result() for h in handles]
    assert ws.windowed_sample.launches == 4 * 4
    for g, w in zip(got, want):
        assert g.shape == (1, 64, 160, 1) and np.array_equal(g, w)
    assert all(h.ready() and h.fetch_s is not None for h in handles)


def test_telemetry_reads_the_card(cuda, tmp_path):
    import json
    from raft_stereo_tpu_torch.obs import Telemetry
    x = torch.ones(1 << 20, device=cuda)
    tel = Telemetry(str(tmp_path), stall_deadline_s=None)
    tel.run_start()
    tel.memory()
    tel.close()
    recs = [json.loads(line) for line in open(tel.events_path)]
    assert recs[0]["devices"] == {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(),
                                  "count": torch.cuda.device_count()}
    stats = recs[-1]["stats"]
    assert stats["bytes_in_use"] >= x.numel() * 4
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"]
    assert stats["bytes_limit"] == torch.cuda.mem_get_info()[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ws_pyramid_batch_of_two_equals_batch_of_one(cuda, dtype):
    """B1 at B=2 (a micro-batched dispatch) is bitwise equal to its two
    launches at B=1, at the default frame's level shapes."""
    g = torch.Generator(device=cuda).manual_seed(5)
    levels = [torch.randn((2, 96, 312, 312 >> i), generator=g,
                          device=cuda).to(dtype) for i in range(4)]
    center = torch.rand((2, 96, 312), generator=g, device=cuda) * 320 - 4
    both = ws.windowed_sample_pyramid_forward(levels, center, R)
    one = torch.cat([ws.windowed_sample_pyramid_forward(
        [lv[b:b + 1].contiguous() for lv in levels],
        center[b:b + 1].contiguous(), R) for b in range(2)])
    assert torch.equal(both, one)


@pytest.mark.parametrize("mixed", [False, True])
def test_predict_async_batch_of_two(cuda, mixed):
    """Micro-batch 2 on the card: one dispatch of two frames launches B1
    once an iteration; a frame's flow is bitwise independent of its
    partner and slot; the first layer whose output departs from batch 1's
    gets bitwise equal inputs and departs by rounding (cuDNN and PyTorch's
    reductions choose kernels by batch size); fp32 flows within 1e-3 px of
    batch 1's."""
    import numpy as np
    from chip_smoke import DEPARTURE_REL, first_divergence
    pred = _eval_predictor(cuda, mixed_precision=mixed)
    rng = np.random.default_rng(1)
    left = rng.integers(0, 255, (3, 64, 160, 3), dtype=np.uint8)
    right = rng.integers(0, 255, (3, 64, 160, 3), dtype=np.uint8)
    alone = [pred(left[i:i + 1], right[i:i + 1]) for i in range(3)]
    ws.windowed_sample.launches = 0
    pair = pred.predict_async(left[:2], right[:2]).result()
    assert ws.windowed_sample.launches == 4
    other = pred.predict_async(left[[0, 2]], right[[0, 2]]).result()
    swapped = pred.predict_async(left[[2, 0]], right[[2, 0]]).result()
    assert np.array_equal(pair[0], other[0])
    assert np.array_equal(pair[0], swapped[1])
    assert np.array_equal(other[1], swapped[0])
    diverge = first_divergence(pred, (left[:2], right[:2]))
    assert diverge is None or (
        diverge[2] and diverge[3] <= DEPARTURE_REL * diverge[4]), diverge
    if not mixed:
        for got, want in ((pair[0], alone[0]), (pair[1], alone[1]),
                          (other[1], alone[2])):
            assert np.abs(got - want[0]).max() <= 1e-3


def _train_tree(root):
    from chip_smoke import write_sceneflow_tree
    write_sceneflow_tree(str(root), 2, 96, 160, 3, max_disp=12)
    return root


def test_trainer_step_on_card_from_the_cpu_loader_batch(cuda, tmp_path):
    """The loader's first batch is the same bits whatever the number of
    its worker processes (it is made on the host, whichever device
    trains), and one trainer step on the card, with the windowed_sample
    kernels, is finite and launches (2, 1) an iteration."""
    import dataclasses
    from raft_stereo_tpu_torch.config import TrainConfig
    from raft_stereo_tpu_torch.data.datasets import fetch_dataloader
    from raft_stereo_tpu_torch.training.trainer import train
    root = _train_tree(tmp_path / "data")
    cfg = TrainConfig(name="card", batch_size=2, num_steps=1,
                      image_size=(64, 128), train_iters=2,
                      data_root=str(root), ckpt_dir=str(tmp_path / "ck"),
                      run_dir=str(tmp_path / "runs"), num_workers=2,
                      spatial_scale=(-0.2, 0.4), saturation_range=(0, 1.4),
                      validation_frequency=1000, stall_deadline_s=None)
    batches = []
    for workers in (2, 1):
        loader = fetch_dataloader(dataclasses.replace(cfg,
                                                      num_workers=workers))
        batches.append(next(iter(loader)))
        loader.close()
    for k in batches[0]:
        assert batches[0][k].tobytes() == batches[1][k].tobytes(), k
    before = (ws.windowed_sample.launches, ws.windowed_sample.bwd_launches)
    final = train(RAFTStereoConfig(hidden_dims=(32, 32, 32),
                                   corr_implementation="reg_cuda"),
                  cfg, device="cuda")
    after = (ws.windowed_sample.launches, ws.windowed_sample.bwd_launches)
    assert (after[0] - before[0], after[1] - before[1]) == (4, 2)
    from raft_stereo_tpu_torch.obs import read_events
    steps = [e for e in read_events(str(tmp_path / "runs" / "card" /
                                        "events.jsonl"))
             if e["event"] == "step"]
    assert len(steps) == 1 and steps[0]["skipped_updates"] == 0.0
    assert final.endswith("card")


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """Save a stepped TrainState on the card and restore it into a fresh
    one on the card: parameters, buffers and optimizer state bitwise."""
    from raft_stereo_tpu_torch.config import TrainConfig
    from raft_stereo_tpu_torch.training import resilience as rz
    from raft_stereo_tpu_torch.training.checkpoint import (
        restore_train_state, save_train_state)
    from raft_stereo_tpu_torch.training.optim import fetch_optimizer
    from raft_stereo_tpu_torch.training.state import TrainState

    def fresh(seed):
        model = init_weights(RAFTStereo(RAFTStereoConfig(
            hidden_dims=(32, 32, 32))), torch.Generator().manual_seed(seed))
        model.to(cuda)
        return TrainState(model, fetch_optimizer(TrainConfig(num_steps=10),
                                                 model.parameters()))
    state = fresh(0)
    g = torch.Generator(device=cuda).manual_seed(1)
    for _ in range(2):
        state.optimizer.step([torch.randn(p.shape, generator=g, device=cuda)
                              for p in state.model.parameters()])
    state.step = 2
    path = save_train_state(str(tmp_path), "card", state, step=2,
                            config_digest="d")
    assert rz.verify_checkpoint(path, config_digest="d",
                                tree_hash=rz.tree_structure_hash(fresh(1)))[0]
    restored = restore_train_state(path, fresh(1))
    want, got = rz.state_payload(state), rz.state_payload(restored)
    for (pa, a), (pb, b) in zip(rz._leaves(want), rz._leaves(got)):
        assert pa == pb
        if isinstance(a, torch.Tensor):
            assert a.device == b.device and torch.equal(a, b), pa
        else:
            assert a == b, pa


# ------------------------------------------------- the serving path

def _pairs(n, h=64, w=160, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 255, (h, w, 3)).astype(np.float32),
             rng.integers(0, 255, (h, w, 3)).astype(np.float32))
            for _ in range(n)]


def _served(cuda, pred, **knobs):
    from raft_stereo_tpu_torch.serve import ServeConfig, StereoServer
    knobs = dict(dict(max_batch=4, window=2, default_iters=4,
                      linger_s=0.3), **knobs)
    return StereoServer(pred.cfg, pred.model.state_dict(),
                        ServeConfig(**knobs), device=cuda)


def test_served_batch_of_one_equals_predictor_on_card(cuda):
    """A served batch-1 flow is the predictor's on the card bitwise, B1
    launched once an iteration, the dispatch's outputs in pinned host
    buffers."""
    import numpy as np
    pred = _eval_predictor(cuda)
    server = _served(cuda, pred)
    try:
        server.warmup([(64, 160)], batch_sizes=(1,), iters=4)
        for left, right in _pairs(2, seed=1):
            ws.windowed_sample.launches = 0
            res = server.submit(left, right).result(timeout=120)
            assert res.ok and res.batch_size == 1
            assert ws.windowed_sample.launches == 4
            assert res.residuals.shape == (4,)
            assert np.array_equal(res.flow,
                                  pred(left[None], right[None])[0])
    finally:
        assert server.close(timeout=120)


def test_served_poison_isolation_bitwise_on_card(cuda):
    """A NaN request in a batch of four fails alone; its three batchmates
    are bitwise their results in the clean batch."""
    import numpy as np
    pred = _eval_predictor(cuda)
    server = _served(cuda, pred)
    try:
        server.warmup([(64, 160)], batch_sizes=(4,), iters=4)
        pairs = _pairs(4, seed=2)
        bad = [(p[0].copy(), p[1]) for p in pairs]
        bad[1][0][3, 5, 0] = np.nan
        runs = []
        for batch in (pairs, bad):
            handles = [server.submit(l, r) for l, r in batch]
            runs.append([h.result(timeout=120) for h in handles])
        clean, poisoned = runs
        assert all(r.ok and r.batch_size == 4 for r in clean)
        assert [r.ok for r in poisoned] == [True, False, True, True]
        assert poisoned[1].error_kind == "nonfinite_output"
        for j in (0, 2, 3):
            assert np.array_equal(poisoned[j].flow, clean[j].flow)
    finally:
        assert server.close(timeout=120)


def test_served_reload_at_batch_boundary_on_card(cuda):
    """Requests queued around a reload all complete; dispatches after it
    are bitwise a fresh server's on the new weights."""
    import numpy as np
    pred = _eval_predictor(cuda)
    server = _served(cuda, pred, max_batch=1, linger_s=0.0)
    new = {k: (v * 0.9 if v.is_floating_point() else v)
           for k, v in pred.model.state_dict().items()}
    pairs = _pairs(4, seed=3)
    try:
        handles = [server.submit(l, r) for l, r in pairs[:3]]
        server.reload(new, note="card")
        after = server.submit(*pairs[3])
        assert all(h.result(timeout=120).ok for h in handles)
        got = after.result(timeout=120)
        assert got.ok
    finally:
        assert server.close(timeout=120)
    from raft_stereo_tpu_torch.serve import ServeConfig, StereoServer
    fresh = StereoServer(pred.cfg, new, ServeConfig(max_batch=1,
                                                    default_iters=4),
                         device=cuda)
    try:
        want = fresh.submit(*pairs[3]).result(timeout=120)
        assert np.array_equal(got.flow, want.flow)
    finally:
        assert fresh.close(timeout=120)
