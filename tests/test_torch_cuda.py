"""The ``windowed_sample`` CUDA kernel held to its plain version on the card.

Every test here needs an NVIDIA GPU with nvcc (the kernel has no CPU or
interpret mode) and skips without one. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda

Bound: 1e-5 abs against the plain PyTorch version on the same inputs (the
kernel rounds each product and the sum as the plain version does, so it is
expected to be exact).
"""

import pytest
import torch

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models import RAFTStereo, init_weights
from raft_stereo_tpu_torch.ops.kernels.windowed_sample import (
    windowed_sample, windowed_sample_plain)

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
    assert windowed_sample.launches == 4 * 5
    assert (up_k - up_p).abs().max().item() <= 1e-5
