#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each reported as one JSON line, in the order they run:

1. device  — the card's name and power limit (nvidia-smi); TF32 is turned
   off for convolutions and matmuls, so fp32 means fp32 everywhere below.
2. build   — builds every CUDA kernel of the paths (windowed_sample,
   fused_corr, alt_corr, fused_lookup) from the sources in
   raft_stereo_tpu_torch/csrc with nvcc (sm_90a), one nvcc each, all
   started together; timed as set-up, with each nvcc's seconds.
3. parity  — the windowed_sample forward kernel against its plain PyTorch
   version on the card, at every pyramid-level shape of both inference
   configurations, with edge centers (integers, borders, +-1e9, NaN).
   Bound: 1e-5 abs.
4. bwd_parity — the windowed_sample backward kernel against its plain
   version at every level shape of the training batch and of both
   inference configurations, the same edge centers: dvol bitwise equal
   (NaN pattern included; bound 1e-5 abs in fp32, one bf16 ulp in bf16),
   dcoords 1e-5 abs, and two runs bitwise equal.
5. fused_parity — the fused_corr forward and backward kernels against
   their plain versions at every level shape of the hires and train_fused
   paths and at W2 <= 2r+2, the same edge centers: the forward 1e-5 abs,
   df1/df2 1e-5 abs (bf16 features: one bf16 ulp of the plain value where
   larger), NaN patterns equal, and two runs of each bitwise equal (df2 is
   a deterministic scatter). fused_pyramid_parity: the one-launch forward
   over 1 to 4 levels (the hires and train pyramids, smooth centers, a
   pyramid down to W2 <= 2r+2) against its plain version, 1e-5 abs, two
   runs bitwise equal and bitwise equal to the one-level launches.
6. fused_memory — the memory contract: the 4-level fused lookup at the
   hires shape allocates its outputs plus less than 1/8 of one level-0
   volume, a level-0 backward df1 + df2 plus that margin.
7. alt_parity, alt_memory — the same two checks for the alt_corr kernels
   (the on-chip slab), held to their plain versions and to fused_corr's
   kernels on the same inputs (one function).
8. fused_lookup_parity — the fused_lookup kernels (lookup + convc1 + ReLU)
   against their plain versions at the default, realtime and train
   pyramids with the edge centers: output and dvol 1e-5 abs (one bf16 ulp
   in bf16), dk/db 1e-5 of their largest magnitude, every output bitwise
   equal run to run.
9. default, realtime, alt_pallas, default_fused_lookup,
   realtime_fused_lookup — the default architecture with
   corr_implementation="reg_cuda" at full width (seeded random weights),
   through StereoPredictor on a 375x1242 pair (padded to 384x1248), 32
   iterations; realtime_config() (bf16), 7 iterations; the default
   architecture with alt_pallas (fp32); and both with fused_lookup=True:
   finite output of the right shape, exactly 4 launches an iteration of
   the path's lookup kernel (1 of fused_lookup) and none of the others,
   median ms/frame, peak memory.
10. hires — the default architecture with alt_cuda (the fused_corr
   kernels, fp32) on a 1988x2880 pair (padded to 2016x2880), 32
   iterations: exactly 32 fused_corr forward launches (one for the four
   levels an iteration) and no windowed_sample launch, finite output,
   median ms/frame over HIRES_RUNS warm frames; peak memory at 2
   iterations below reg_cuda's on the same pair.
11. cpu_parity — the default architecture on the same weights, fp32, 4
   iterations, on the card (kernel) and on the CPU (plain version), with
   reg_cuda, alt_cuda and alt_pallas at 64x160 and with reg_cuda +
   fused_lookup at 64x352 (the narrowest pair whose pyramid the fused
   kernel takes). Bound: 1e-3 px on flow_up.
12. train — the SceneFlow recipe (sceneflow_config(): bf16 compute, bf16
   volume) with reg_cuda, batch 8 at 320x720, 22 iterations, through
   make_train_step on a seeded synthetic batch: a warm-up step, then timed
   steps, each with exactly 4 x 22 forward launches, as many recomputed
   under remat_refinement and 4 x 22 backward launches; finite loss and
   gradient norm, no skipped update, parameters that moved; median
   ms/step and peak memory.
13. train_nan — a batch with a NaN pixel: the update is skipped, the
   parameters stay bitwise unchanged and the step still counts.
14. train_fused, train_alt, train_fused_lookup — the same recipe with
   alt_cuda (bf16 features), with alt_pallas, and with reg_cuda +
   fused_lookup: the same checks, with the path's kernel launches
   ((44, 88): one forward launch an iteration, four backward; (176, 88);
   (44, 22)) and none of the other kernels'.
15. train_cpu_parity — one fp32 step of the default architecture, 2
   iterations, on the card (kernels) and on the CPU (plain versions):
   reg_cuda with the card's convolutions in cuDNN (as the main path runs
   them) and outside it, alt_cuda and alt_pallas in cuDNN at 64x160,
   reg_cuda + fused_lookup in cuDNN at 64x352; the loss within 1e-5
   relative, and the gradients within the null floor of NULL_RUNS CPU
   null runs (see check_grad_parity).
16. timings, bwd_timings — per pyramid level: each windowed_sample
   kernel's time per launch, its bound (bound_ms: bytes over 3.35 TB/s,
   or operations over the peak of their type, whichever is larger), the
   plain version's time and one PyTorch call computing the same function:
   F.grid_sample for the forward, its backward (torch.autograd.grad on a
   prebuilt graph) for the backward (the reference's formulation; a
   yardstick only).
17. fused_timings, alt_timings — fused_corr's forward in one launch for
   the four hires levels (fp32) and the four train levels (bf16), and per
   level; alt_corr's forward per level at the alt_pallas frame's, the
   hires and the train levels; both backwards per train level (bf16).
   Each on random centers (an independent disparity a pixel) with time
   per launch, bound (B2's function for both), plain time and the
   reference's several-call 'alt' formulation as a yardstick (no single
   PyTorch call computes the function, so their kernels-line entries have
   library_ms null), and on smooth centers (a low-frequency disparity
   field, as a model makes) with time and bound; alt_corr's rows add the
   slab's flops and their time at the fp32 peak, outside the bound.
18. fused_lookup_timings — fused_lookup's forward at the default and
   realtime pyramids and its backward at the train pyramid: time per
   launch, bound, plain time and the unfused formulation (F.grid_sample
   x4, cat, a 1x1 conv, ReLU) as a yardstick.

Then the kernels line and, last, {"ok": true, "device": {...}}. Any failed
check raises, and the script exits non-zero without that last line. It
exits non-zero at once when torch.cuda is not available.
"""

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

SEED = 1234
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published peak
FP32_FLOPS_PER_S = 67e12    # H100 SXM, non-tensor-core fp32 peak
BF16_FLOPS_PER_S = 989e12   # H100 SXM, dense bf16 tensor-core peak
KERNEL_TOL = 1e-5
CPU_PARITY_TOL_PX = 1e-3
RADIUS = 4
TRAIN_STEPS = 3              # timed steps after the warm-up step
TRAIN_LOSS_TOL = 1e-5        # card vs CPU step: relative loss deviation
NULL_PERTURBATION = 1e-6     # the CPU null runs' relative weight noise
NULL_RUNS = 8                # CPU null runs whose envelope bounds the card
ROUNDOFF_REL = 1e-7          # gradient leaves below this x the global norm
# the hires pair: about MiddEval3's full-resolution size, padded to
# 2016x2880 (1/4 resolution 504x720)
HIRES_H, HIRES_W = 1988, 2880
HIRES_RUNS = 3               # timed warm frames
# fused_corr level shapes (B, H, W1, W2, D): the hires path (fp32) and
# the SceneFlow training batch with alt_cuda (bf16)
FUSED_SHAPES = {"hires": [(1, 504, 720, 720 >> i, 256) for i in range(4)],
                "train_fused": [(8, 80, 180, 180 >> i, 256)
                                for i in range(4)]}
# alt_corr's own inference path: the default architecture at 384x1248 (fp32)
ALT_DEFAULT_SHAPES = [(1, 96, 312, 312 >> i, 256) for i in range(4)]
# fused_lookup's configurations: (volume dtype, compute dtype, (B, H, W1,
# level-0 W2)) of the default and realtime frames and the SceneFlow batch
LOOKUP_C1 = {"default": ("float32", "float32", (1, 96, 312, 312)),
             "realtime": ("bfloat16", "bfloat16", (1, 48, 156, 156)),
             "train": ("bfloat16", "bfloat16", (8, 80, 180, 180))}
SLAB_TILE = 64               # alt_corr's slab tile edge (csrc/alt_corr.cu)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, message):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def seeded_weights(model, seed):
    """Seeded random weights. The flow head's output conv is scaled by 0.1
    so that one iteration moves the disparity by pixels, as a trained
    model's does (at plain He init the fields reach ~100 px)."""
    import torch
    from raft_stereo_tpu_torch.models import init_weights
    init_weights(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(0.1)
    return model.state_dict()


def stereo_pair(h, w, seed, shift=12):
    """A textured synthetic pair: the right view is the left one shifted by
    ``shift`` px (uint8-range float32, (1, h, w, 3))."""
    import numpy as np
    rng = np.random.default_rng(seed)
    small = rng.uniform(0, 255, (h // 4 + 2, (w + shift) // 4 + 2, 3))
    big = np.kron(small, np.ones((4, 4, 1)))[:h, :w + shift]
    big = big + rng.normal(0, 8, big.shape)
    left = np.clip(big[:, :w], 0, 255).astype(np.float32)
    right = np.clip(big[:, shift:], 0, 255).astype(np.float32)
    return left[None], right[None]


def window_centers(b, h, w1, w2, g, device, edges=True):
    """Lookup centers of a (b, h, w1) grid into rows of width w2: each
    pixel's own x less a disparity in [0, w2/4]. With ``edges``, the first
    centers are integers, borders, +-1e9 (flat positions 6 and 7) and NaN
    (flat position 9)."""
    import torch
    x = torch.arange(w1, device=device, dtype=torch.float32) * (w2 / w1)
    disp = torch.rand((b, h, w1), generator=g, device=device) * (w2 / 4)
    center = (x - disp).contiguous()
    if edges:
        flat = center.view(-1)
        edge = [0.0, -1.0, float(w2 - 1), float(w2), -RADIUS - 0.5,
                w2 + RADIUS + 0.25, 1e9, -1e9, 0.999999, float("nan"),
                float(w2 // 2)]
        flat[:len(edge)] = torch.tensor(edge, device=device)
    return center


def smooth_centers(b, h, w1, w2, g, device):
    """Lookup centers as a model makes them: each pixel's own x less a
    smooth, low-frequency disparity in [0, w2/4] (one period across the
    row and one down the image, a random phase per batch element), so
    neighbouring pixels look up nearly the same window."""
    import torch
    x = torch.arange(w1, device=device, dtype=torch.float32) * (w2 / w1)
    phase = torch.rand((b, 2, 1, 1), generator=g, device=device)
    xs = torch.arange(w1, device=device, dtype=torch.float32) / w1
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None] / h
    disp = (w2 / 8) * (1 + torch.sin(2 * math.pi * (xs + phase[:, 0]))
                       * torch.cos(2 * math.pi * (ys + phase[:, 1])))
    return (x - disp).contiguous()


def lookup_inputs(shape, dtype, seed, device, edges=True):
    import torch
    b, h, w1, w2 = shape
    g = torch.Generator(device=device).manual_seed(seed)
    vol = torch.randn(shape, generator=g, device=device).to(dtype)
    return vol, window_centers(b, h, w1, w2, g, device, edges)


def fused_inputs(shape, dtype, seed, device, edges=True, field="random"):
    """Features ``fmap1 (B, H, W1, D)``, ``fmap2 (B, H, W2, D)`` and
    centers for a ``(B, H, W1, W2, D)`` level shape: ``field`` "random"
    (window_centers, with ``edges``) or "smooth" (smooth_centers)."""
    import torch
    b, h, w1, w2, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    f1 = torch.randn((b, h, w1, d), generator=g, device=device).to(dtype)
    f2 = torch.randn((b, h, w2, d), generator=g, device=device).to(dtype)
    if field == "smooth":
        return f1, f2, smooth_centers(b, h, w1, w2, g, device)
    return f1, f2, window_centers(b, h, w1, w2, g, device, edges)


def feature_pyramid(f2, n_levels):
    """``f2`` and its pools along W (ops/geometry.pool_w2), as the model's
    feature-pyramid state holds them: ``n_levels`` contiguous levels."""
    from raft_stereo_tpu_torch.ops.geometry import pool_w2
    levels = [f2]
    for _ in range(n_levels - 1):
        levels.append(pool_w2(levels[-1]).contiguous())
    return levels


def bound_ms(nbytes, flops, product_flops, product_dtype):
    """The least time (ms) the card needs for a function, and what sets
    it: its bytes over the memory rate, or its operations over the peaks
    of their types, whichever is longer. ``product_flops`` are the
    multiply-adds of a product whose operands are in ``product_dtype``
    (bf16: the tensor cores' rate); ``flops`` the rest, at the fp32 rate."""
    import torch
    peak = (BF16_FLOPS_PER_S if product_dtype == torch.bfloat16
            else FP32_FLOPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / FP32_FLOPS_PER_S + product_flops / peak) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fused_bytes_flops(f1, levels, center, backward=False):
    """Least bytes, flops and product flops of one fused_corr launch on
    these inputs; ``levels`` is one fmap2 level or a list of them, level i
    looked up around center / 2**i (the one-launch forward). Forward:
    fmap1 read once for all the levels, per level the fmap2 rows some
    in-range tap touches read once, the center read and the fp32 output
    written; 2*D product flops (on the features) per in-range tap and 3
    flops per output. Backward (one level): the same reads plus the fp32
    cotangent, df1 and df2 written whole; 4*D product flops per in-range
    tap (df1 and df2, read from the features; counted at the features'
    peak, as a bound may only err low) and 4 flops per tap for dg."""
    import torch
    if torch.is_tensor(levels):
        levels = [levels]
    b, h, w1, d = f1.shape
    k = 2 * RADIUS + 1
    es = f1.element_size()
    n_pix = center.numel()
    reads = f1.numel() * es + n_pix * 4
    n_valid = 0
    c0 = torch.nan_to_num(center, nan=0.0).clamp(-1e8, 1e8)
    for i, f2 in enumerate(levels):
        w2 = f2.shape[2]
        taps = torch.floor(c0 / (2 ** i)).long()[..., None] - RADIUS \
            + torch.arange(k + 1, device=c0.device)
        valid = (taps >= 0) & (taps < w2)
        n_valid += int(valid.sum().item())
        touched = torch.zeros((b, h, w2 + 1), dtype=torch.bool,
                              device=c0.device)
        touched.scatter_(2, torch.where(valid, taps, w2).reshape(b, h, -1),
                         True)
        reads += int(touched[..., :w2].sum().item()) * d * es
    n_out = n_pix * k * len(levels)
    if not backward:
        return reads + n_out * 4, n_out * 3, n_valid * 2 * d
    writes = (f1.numel() + sum(f2.numel() for f2 in levels)) * es
    return reads + n_pix * k * 4 + writes, n_valid * 4, n_valid * 4 * d


def alt_yardstick(f1, f2, center, ct=None):
    """The reference's own 'alt' formulation of the same function, several
    PyTorch calls: F.grid_sample of the fmap2 rows at the 2r+1 tap
    positions (bilinear, zeros, align_corners), then a product with fmap1
    and a sum over D, over sqrt(D). Returns a call computing it, or, with a
    cotangent ``ct``, a call taking its gradients in fmap1 and fmap2 by
    torch.autograd.grad on a prebuilt graph."""
    import torch
    import torch.nn.functional as F
    b, h, w1, d = f1.shape
    w2 = f2.shape[2]
    k = 2 * RADIUS + 1
    dx = torch.arange(-RADIUS, RADIUS + 1, device=f1.device,
                      dtype=torch.float32)
    x = (center.reshape(b * h, 1, w1, 1) + dx.view(1, 1, 1, k)).reshape(
        b * h, 1, w1 * k, 1)
    xn = 2.0 * x / max(w2 - 1, 1) - 1.0
    grid = torch.cat([xn, torch.zeros_like(xn)], dim=-1).to(f1.dtype)
    scale = 1.0 / math.sqrt(d)

    def fwd(a, bb):
        inp = bb.permute(0, 1, 3, 2).reshape(b * h, d, 1, w2)
        s = F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True).view(b * h, d, w1, k)
        lhs = a.reshape(b * h, w1, d).permute(0, 2, 1)[..., None]
        return ((s * lhs).sum(dim=1) * scale).view(b, h, w1, k)

    if ct is None:
        return lambda: fwd(f1, f2)
    a = f1.detach().requires_grad_()
    bb = f2.detach().requires_grad_()
    out = fwd(a, bb)
    cot = ct.to(out.dtype)
    return lambda: torch.autograd.grad(out, (a, bb), cot, retain_graph=True)


def lookup_bytes_flops(vol, center):
    """Least bytes and flops of one lookup on these inputs: the center and
    the in-range taps read once, the fp32 output written once; 4 flops per
    output ((1-f), two products, one sum)."""
    import torch
    w2 = vol.shape[-1]
    k = 2 * RADIUS + 1
    c = torch.nan_to_num(center, nan=0.0).clamp(-1e8, 1e8)
    base = torch.floor(c).long() - RADIUS
    taps = base[..., None] + torch.arange(k + 1, device=c.device)
    in_range = int(((taps >= 0) & (taps < w2)).sum().item())
    n_pix = center.numel()
    nbytes = n_pix * 4 + in_range * vol.element_size() + n_pix * k * 4
    return nbytes, n_pix * k * 4


def cuda_ms(fn, flush, reps=50):
    """Median device time of one ``fn()`` call with the L2 cache flushed
    before each (the refinement loop's convs evict it between lookups).
    Every call is queued before one synchronize, so the card always has
    work ahead and a host stall between two launches lands outside the
    timed spans."""
    import torch
    spans = []
    for _ in range(reps + 5):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in spans[5:])


def grid_sample_lookup(vol, center):
    """The reference's formulation of the lookup as one F.grid_sample call
    on a (B*H*W1, 1, 1, W2) volume; returns the call, its grid built."""
    import torch
    import torch.nn.functional as F
    b, h, w1, w2 = vol.shape
    dx = torch.arange(-RADIUS, RADIUS + 1, device=vol.device,
                      dtype=torch.float32)
    x = center.reshape(-1, 1, 1, 1) + dx.view(1, 1, -1, 1)
    xn = 2.0 * x / max(w2 - 1, 1) - 1.0
    grid = torch.cat([xn, torch.zeros_like(xn)], dim=-1).to(vol.dtype)
    inp = vol.reshape(b * h * w1, 1, 1, w2)

    def call():
        return F.grid_sample(inp, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)
    return call


def lookup_bwd_bytes_flops(vol, center):
    """Least bytes and flops of one backward launch as training runs it (no
    dcoords): the dense dvol written once, the fp32 cotangent and the
    center read once; 3 flops per in-range tap ((1-f)*ct_j, f*ct_{j-1},
    one sum)."""
    import torch
    w2 = vol.shape[-1]
    k = 2 * RADIUS + 1
    c = torch.nan_to_num(center, nan=0.0).clamp(-1e8, 1e8)
    base = torch.floor(c).long() - RADIUS
    taps = base[..., None] + torch.arange(k + 1, device=c.device)
    in_range = int(((taps >= 0) & (taps < w2)).sum().item())
    n_pix = center.numel()
    nbytes = vol.numel() * vol.element_size() + n_pix * k * 4 + n_pix * 4
    return nbytes, in_range * 3


def grid_sample_backward(vol, center, ct):
    """The backward of the reference's F.grid_sample lookup: returns a call
    that takes the volume's gradient on a prebuilt graph."""
    import torch
    inp_vol = vol.detach().requires_grad_()
    out = grid_sample_lookup(inp_vol, center)()
    cot = ct.reshape(out.shape).to(out.dtype)

    def call():
        return torch.autograd.grad(out, inp_vol, cot, retain_graph=True)
    return call


def train_batch(b, h, w, seed, device, max_disp=64.0):
    """A seeded synthetic training batch: a textured left view, the right
    view resampled from the same texture at a smooth disparity field in
    [0, max_disp], flow = -disparity, every pixel valid."""
    import math
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    pad = int(max_disp) + 8
    tex = torch.rand((b, h // 4 + 1, (w + 2 * pad) // 4 + 1, 3),
                     generator=g, device=device) * 255
    tex = tex.repeat_interleave(4, 1).repeat_interleave(4, 2)[
        :, :h, :w + 2 * pad]
    tex = (tex + 8 * torch.randn(tex.shape, generator=g, device=device)
           ).clamp(0, 255)
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None]
    phase = torch.rand((b, 1, 1), generator=g, device=device) * 2 * math.pi
    disp = 0.5 * max_disp * (1 + torch.sin(2 * math.pi * xs / w + phase)
                             * torch.cos(2 * math.pi * ys / h))
    idx = (xs + pad + disp).round().long().clamp(0, w + 2 * pad - 1)
    right = torch.gather(tex, 2, idx[..., None].expand(b, h, w, 3))
    return {"image1": tex[:, :, pad:pad + w].contiguous(),
            "image2": right.contiguous(),
            "flow": -disp[..., None].contiguous(),
            "valid": torch.ones((b, h, w), device=device)}


def perturbed_copy(model, rel, seed):
    """A copy of ``model`` with every weight scaled by 1 + rel * N(0, 1)."""
    import copy
    import torch
    other = copy.deepcopy(model)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in other.parameters():
            p.mul_(1 + rel * torch.randn(p.shape, generator=g))
    return other


def rel_l2(a, b):
    import torch
    den = float(torch.linalg.vector_norm(b.double()))
    num = float(torch.linalg.vector_norm((a - b).double()))
    return num / den if den > 0 else num


def null_floor_gate(devs, null_devs, floor, gated):
    """The null-floor rule (PARITY.md's floor_gate) leaf by leaf, over
    several null runs. ``devs`` maps each leaf to a run's deviation from
    the reference and ``null_devs`` holds one such map per null run. A
    run's score against a set of null runs is its largest ratio, over the
    ``gated`` leaves, of a leaf's deviation to max(``floor``, that leaf's
    largest deviation among those runs). Each null run is scored against
    the others, and the run against every set of all runs but one, its
    worst score kept: it passes when it scores no higher than the
    highest-scoring null run, that is, when it looks no more unusual than
    the reference does against itself."""
    def score(d, others):
        ratios = {k: d[k] / max(floor, max(o[k] for o in others))
                  for k in gated}
        worst = max(ratios, key=ratios.get)
        return ratios[worst], worst

    def drop(i):
        return null_devs[:i] + null_devs[i + 1:]
    got, worst = max(score(devs, drop(i)) for i in range(len(null_devs)))
    null_scores = [score(d, drop(i))[0] for i, d in enumerate(null_devs)]
    return dict(score=got, worst_leaf=worst, worst_leaf_dev=devs[worst],
                null_scores=[min(null_scores), max(null_scores)],
                ok=got <= max(null_scores))


def check_grad_parity(names, got, want, nulls):
    """Card gradients ``got`` against CPU gradients ``want``, beside CPU
    null runs ``nulls`` (each with every weight scaled by 1 + 1e-6 N(0, 1),
    the size of change that separates two devices' fp32 forwards: a few
    ReLUs and L1 signs flip). Leaf by leaf under null_floor_gate with a
    floor of 1e-4, and all gradients together within the largest null
    run's deviation. Leaves whose ``want`` norm is below ROUNDOFF_REL of
    the global norm (biases that an instance norm cancels: pure round-off,
    100% apart in every null run) count only in the aggregate."""
    import torch
    flat_want = torch.cat([w.flatten() for w in want])
    floor = ROUNDOFF_REL * float(torch.linalg.vector_norm(flat_want.double()))
    gated = [n for n, w in zip(names, want)
             if float(torch.linalg.vector_norm(w.double())) >= floor]

    def devs(grads):
        return {n: rel_l2(g, w) for n, g, w in zip(names, grads, want)}
    leaves = null_floor_gate(devs(got), [devs(gs) for gs in nulls], 1e-4,
                             gated)
    all_dev = rel_l2(torch.cat([g.flatten() for g in got]), flat_want)
    all_null = [rel_l2(torch.cat([g.flatten() for g in gs]), flat_want)
                for gs in nulls]
    return dict(leaves, leaves_roundoff=len(names) - len(gated),
                rel_l2_all=all_dev,
                rel_l2_all_null=[min(all_null), max(all_null)],
                ok=leaves["ok"] and all_dev <= max(all_null))


def within_bound(got, want, dtype):
    """Max abs error of ``got`` against ``want`` off their NaNs, and whether
    every element is within 1e-5 abs, or in bf16 within one bf16 ulp of
    ``want`` where that is larger; the NaN patterns must agree."""
    import torch
    nan = torch.isnan(want)
    same_nan = torch.equal(torch.isnan(got), nan)
    diff = (got.float() - want.float())[~nan].abs()
    ulp = want.float()[~nan].abs() * (
        2.0 ** -7 if dtype == torch.bfloat16 else 0.0)
    ok = same_nan and bool((diff <= torch.clamp(ulp, min=KERNEL_TOL)).all())
    return (diff.max().item() if diff.numel() else 0.0), ok


def bitwise(a, b):
    """Equal bit for bit, NaNs in the same places counting as equal."""
    import torch
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def run_feature_parity(dev, phase, kernel, fns, seed, against=None):
    """A feature-pyramid lookup's kernels (fused_corr or alt_corr: ``fns``
    = the forward's autograd Function, the backward launcher, plain
    forward, plain backward; ``kernel`` holds the launch counts) against
    their plain versions at every level shape of the hires and
    train_fused paths (and at W2 <= 2r+2), with the edge
    centers: the forward and df1/df2 within KERNEL_TOL (bf16 features: one
    bf16 ulp of the reference where that is larger), NaN patterns equal,
    far-out centers zero, and two runs of each kernel bitwise equal. With
    ``against`` (another kernel's forward and backward computing the same
    function), the same bounds against its results too."""
    import torch
    fwd, bwd, plain, plain_bwd = fns
    shapes = [("hires", torch.float32, s) for s in FUSED_SHAPES["hires"]]
    shapes += [("train_fused", torch.bfloat16, s)
               for s in FUSED_SHAPES["train_fused"]]
    shapes += [("narrow", torch.float32, (1, 4, 15, w, 256))
               for w in (7, 3, 1)]
    errs = dict(fwd=0.0, bwd=0.0, fwd_vs_other=0.0, bwd_vs_other=0.0)
    n_calls = 0
    before = (kernel.launches, kernel.bwd_launches)
    for i, (cfg_name, dtype, shape) in enumerate(shapes):
        f1, f2, center = fused_inputs(shape, dtype, seed + i, dev)
        g = torch.Generator(device=dev).manual_seed(seed + 10 + i)
        ct = torch.randn(tuple(center.shape) + (2 * RADIUS + 1,),
                         generator=g, device=dev)
        out = fwd(f1, f2, center, RADIUS)
        again = fwd(f1, f2, center, RADIUS)
        df1, df2 = bwd(f1, f2, center, ct, RADIUS)
        df1b, df2b = bwd(f1, f2, center, ct, RADIUS)
        n_calls += 2
        refs = [("", plain(f1, f2, center, RADIUS),
                 plain_bwd(f1, f2, center, ct, RADIUS))]
        if against:
            refs.append(("_vs_other", against[0](f1, f2, center, RADIUS),
                         against[1](f1, f2, center, ct, RADIUS)))
        torch.cuda.synchronize()
        row = {}
        for tag, want, (w1, w2) in refs:
            err_f, ok_f = within_bound(out, want, torch.float32)
            err_1, ok_1 = within_bound(df1, w1, dtype)
            err_2, ok_2 = within_bound(df2, w2, dtype)
            row.update({f"max_abs_err_fwd{tag}": err_f,
                        f"max_abs_err_df1{tag}": err_1,
                        f"max_abs_err_df2{tag}": err_2})
            check(ok_f, f"{phase}: forward differs{tag} at {cfg_name} "
                        f"{shape}")
            check(ok_1 and ok_2, f"{phase}: backward differs{tag} at "
                                 f"{cfg_name} {shape}")
            errs[f"fwd{tag}"] = max(errs[f"fwd{tag}"], err_f)
            errs[f"bwd{tag}"] = max(errs[f"bwd{tag}"], err_1,
                                          err_2)
        det = dict(fwd=bitwise(out, again), df1=bitwise(df1, df1b),
                   df2=bitwise(df2, df2b))
        emit(phase, config=cfg_name, shape=list(shape),
             dtype=str(dtype).replace("torch.", ""), **row,
             deterministic=det)
        check(bool(torch.isnan(out).any()), "the NaN center gave no NaN")
        check(all(det.values()), f"{phase}: kernels not deterministic at "
                                 f"{cfg_name} {shape}: {det}")
        check(bool((out.view(-1, 2 * RADIUS + 1)[6:8] == 0).all())
              and bool((df1.view(-1, shape[-1])[6:8] == 0).all()),
              "far-out centers are not zero")
        del f1, f2, out, again, df1, df2, df1b, df2b, refs
    check((kernel.launches - before[0],
           kernel.bwd_launches - before[1]) == (n_calls, n_calls),
          f"{phase}: the parity calls did not launch the kernels")
    return errs


def run_pyramid_parity(dev, fc):
    """fused_corr's one-launch forward over 1 to 4 pyramid levels (level i
    around center / 2**i), through the fused_corr_pyramid autograd Function
    the model calls, against its plain version (the levels' plain
    lookups concatenated): the hires pyramid (fp32, 4 levels), the
    train_fused pyramid (bf16, 1 to 4 levels), the train pyramid on smooth
    centers, and a narrow pyramid whose last levels have W2 <= 2r+2, with
    the edge centers (random fields). Within KERNEL_TOL, NaN patterns
    equal, far-out centers zero, two runs bitwise equal, bitwise equal to
    the one-level launches concatenated, and one launch a call."""
    import torch
    err = 0.0
    cases = [("hires", torch.float32, FUSED_SHAPES["hires"][0], "random",
              (4,)),
             ("train_fused", torch.bfloat16, FUSED_SHAPES["train_fused"][0],
              "random", (1, 2, 3, 4)),
             ("train_fused", torch.bfloat16, FUSED_SHAPES["train_fused"][0],
              "smooth", (4,)),
             ("narrow", torch.float32, (1, 4, 15, 15, 256), "random", (4,))]
    for i, (cfg_name, dtype, shape, field, counts) in enumerate(cases):
        f1, f2, center = fused_inputs(shape, dtype, SEED + 70 + i, dev,
                                      field=field)
        levels = feature_pyramid(f2, 4)
        for n in counts:
            before = fc.fused_corr.launches
            out = fc.fused_corr_pyramid(f1, levels[:n], center, RADIUS)
            again = fc.fused_corr_pyramid(f1, levels[:n], center, RADIUS)
            check(fc.fused_corr.launches - before == 2,
                  "fused_pyramid_parity: not one launch a call")
            ones = torch.cat([fc.fused_corr(
                f1, lv, center / (2 ** j), RADIUS)
                for j, lv in enumerate(levels[:n])], dim=-1)
            want = fc.fused_corr_pyramid_plain(f1, levels[:n], center,
                                               RADIUS)
            torch.cuda.synchronize()
            e, ok = within_bound(out, want, torch.float32)
            det = bitwise(out, again)
            same = bitwise(out, ones)
            emit("fused_pyramid_parity", config=cfg_name, field=field,
                 shape=list(shape), levels=[lv.shape[2] for lv in
                                            levels[:n]],
                 dtype=str(dtype).replace("torch.", ""), max_abs_err=e,
                 deterministic=det, bitwise_vs_one_level_launches=same)
            check(ok, f"fused pyramid differs at {cfg_name} {field} {n}")
            check(det and same, f"fused pyramid at {cfg_name} {field} {n}: "
                                f"deterministic {det}, equal to the "
                                f"one-level launches {same}")
            if field == "random":
                k = 2 * RADIUS + 1
                check(bool(torch.isnan(out).any())
                      and bool((out.view(-1, n * k)[6:8] == 0).all()),
                      "fused pyramid: NaN or far-out centers mishandled")
            err = max(err, e)
            del out, again, ones, want
        del f1, f2, levels, center
    return err


def run_feature_memory(dev, phase, impl, backward):
    """The memory contract of a feature-pyramid implementation (``fused``
    or ``alt_pallas``): the 4-level lookup at the hires shape allocates no
    more than its outputs (the levels' and their concatenation) plus an
    eighth of one level-0 volume, and a backward (``backward``, the
    kernel's launcher) at level 0 no more than df1 + df2 plus that margin,
    at the hires and the train shapes."""
    import torch
    from raft_stereo_tpu_torch.ops.corr import corr_lookup, init_corr
    b, h, w1, w2, d = FUSED_SHAPES["hires"][0]
    margin = b * h * w1 * w2 * 4 // 8
    f1, f2, center = fused_inputs((b, h, w1, w2, d), torch.float32,
                                  SEED + 80, dev, edges=False)
    state = init_corr(impl, f1, f2, num_levels=4, radius=RADIUS)
    coords = torch.stack([center, torch.zeros_like(center)], dim=-1)
    rows = {}

    def measure(name, fn, own):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated(dev) - base
        rows[name] = dict(extra_bytes=extra, own_output_bytes=own,
                          limit_bytes=own + margin)
        check(extra <= own + margin, f"{phase} {name}: {extra} bytes "
                                     f"above the {own + margin} allowed")
        return out
    with torch.no_grad():
        out = measure("lookup_4_levels", lambda: corr_lookup(state, coords),
                      2 * b * h * w1 * 4 * (2 * RADIUS + 1) * 4)
    del out
    ct = torch.randn(tuple(center.shape) + (2 * RADIUS + 1,), device=dev)
    grads = measure("backward_level0", lambda: backward(
        f1, f2, center, ct, RADIUS), (f1.numel() + f2.numel()) * 4)
    del grads
    tb = FUSED_SHAPES["train_fused"][0]
    f1, f2, center = fused_inputs(tb, torch.bfloat16, SEED + 81, dev,
                                  edges=False)
    ct = torch.randn(tuple(center.shape) + (2 * RADIUS + 1,), device=dev)
    grads = measure("backward_train_level0", lambda: backward(
        f1, f2, center, ct, RADIUS), (f1.numel() + f2.numel()) * 2)
    emit(phase, impl=impl, margin_bytes=margin,
         level0_volume_bytes=8 * margin, **rows)
    return rows


def alt_slab_flops(center, w2, d):
    """The flops of the slab tiles alt_corr's forward computes on these
    centers: per (row, tile of SLAB_TILE pixels), every SLAB_TILE-wide
    chunk of the span its in-range taps cover that some window touches,
    2*D flops per (pixel, column) of the full tile (the kernel's own
    walk, csrc/alt_corr.cu)."""
    import torch
    b, h, w1 = center.shape
    k = 2 * RADIUS + 1
    c = torch.nan_to_num(center, nan=0.0).clamp(-1e8, 1e8)
    base = torch.floor(c).long() - RADIUS
    lo, hi = base.clamp(min=0), (base + k + 1).clamp(max=w2)
    valid = lo < hi
    pad = (-w1) % SLAB_TILE
    big = 1 << 40
    lo = torch.nn.functional.pad(torch.where(valid, lo, big), (0, pad),
                                 value=big).view(b, h, -1, SLAB_TILE)
    hi = torch.nn.functional.pad(torch.where(valid, hi, -big), (0, pad),
                                 value=-big).view(b, h, -1, SLAB_TILE)
    span_lo, span_hi = lo.min(-1).values, hi.max(-1).values
    chunks = 0
    for j in range(-(-w2 // SLAB_TILE) + 1):
        c0 = (span_lo + j * SLAB_TILE)[..., None]
        hit = ((lo < c0 + SLAB_TILE) & (hi > c0)).any(-1)
        chunks += int((hit & (c0[..., 0] < span_hi)).sum().item())
    return chunks * SLAB_TILE * SLAB_TILE * 2 * d


def feature_timing(flush, backward, cfg_name, dtype, shape, seed, dev,
                   kernel_fn, plain_fn, extra=None, field="random",
                   n_levels=0, full=True):
    """One row for a feature-lookup kernel (fused_corr or alt_corr, one
    function): the kernel's time per call (forward ``fn(f1, f2, center,
    R)``, or backward ``fn(f1, f2, center, ct, R)``; with ``n_levels`` the
    one-launch forward ``fn(f1, levels, center, R)`` over that many pooled
    levels of ``shape``'s fmap2) on the ``field`` centers (fused_inputs),
    and its bound (fused_bytes_flops). With ``full``, also the plain
    version's time and the reference's several-call 'alt' formulation as a
    yardstick (alt_yardstick, per level). ``extra(f1, f2, center)`` adds
    columns."""
    import torch
    f1, f2, center = fused_inputs(shape, dtype, seed, dev, edges=False,
                                  field=field)
    levels = feature_pyramid(f2, n_levels) if n_levels else [f2]
    ct = None
    if backward:
        g = torch.Generator(device=dev).manual_seed(seed + 5)
        ct = torch.randn(tuple(center.shape) + (2 * RADIUS + 1,),
                         generator=g, device=dev)
        args = (f1, f2, center, ct, RADIUS)
    elif n_levels:
        args = (f1, levels, center, RADIUS)
    else:
        args = (f1, f2, center, RADIUS)
    nbytes, flops, product = fused_bytes_flops(f1, levels, center,
                                               backward=backward)
    bound, bound_by = bound_ms(nbytes, flops, product, dtype)
    row = dict(config=cfg_name, field=field, shape=list(shape),
               levels=[lv.shape[2] for lv in levels],
               dtype=str(dtype).replace("torch.", ""),
               ms=cuda_ms(lambda: kernel_fn(*args), flush),
               bound_ms=bound, bound_by=bound_by,
               bytes=nbytes, flops=flops + product)
    if full:
        yards = [alt_yardstick(f1, lv, center / (2 ** i), ct)
                 for i, lv in enumerate(levels)]

        def yard():
            return [y() for y in yards]
        got, want = yard(), plain_fn(*args)
        if backward:
            got = got[0]
        else:
            got, want = (torch.cat(got, dim=-1),), (want,)
        yard_err = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(got, want))
        del got, want
        row.update(plain_ms=cuda_ms(lambda: plain_fn(*args), flush),
                   yardstick_ms=cuda_ms(yard, flush),
                   yardstick_max_abs_diff=yard_err)
        del yards
    if extra:
        row.update(extra(f1, f2, center))
    del f1, f2, levels, center, ct
    return row


def lookup_c1_inputs(shape, vdt, seed, device, edges=True):
    """A 4-level volume pyramid ``(B, H, W1, W2 >> i)`` in ``vdt``, lookup
    centers (window_centers: the edge centers at flat positions 0-10, NaN
    at 9), and a convc1 kernel (36, 64) and bias (64,) in fp32."""
    import torch
    b, h, w1, w2 = shape
    g = torch.Generator(device=device).manual_seed(seed)
    levels = [torch.randn((b, h, w1, w2 >> i), generator=g,
                          device=device).to(vdt) for i in range(4)]
    coords = window_centers(b, h, w1, w2, g, device, edges)
    kern = torch.randn((4 * (2 * RADIUS + 1), 64), generator=g,
                       device=device) * 0.2
    bias = torch.randn((64,), generator=g, device=device) * 0.1
    return levels, coords, kern, bias


def rel_dev(got, want):
    """Max abs deviation over the reference's largest magnitude."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def run_fused_lookup_parity(dev, fl):
    """fused_lookup's kernels against their plain versions at the default,
    realtime and train shapes with the edge centers: the output and every
    dvol within KERNEL_TOL (bf16: one bf16 ulp of the plain value where
    that is larger), NaN patterns equal, far-out centers giving relu(bias)
    and zero dvol rows; dk/db (on finite centers: one NaN center makes all
    of dk NaN) within 1e-5 of their largest magnitude; two runs of each
    kernel bitwise equal."""
    import torch
    errs = dict(fwd=0.0, dvol=0.0, dk_db_rel=0.0)
    n_calls = 0
    before = (fl.fused_lookup_c1.launches, fl.fused_lookup_c1.bwd_launches)
    for i, (cfg_name, (vname, dname, shape)) in enumerate(LOOKUP_C1.items()):
        vdt, dt = getattr(torch, vname), getattr(torch, dname)
        levels, coords, kern, bias = lookup_c1_inputs(shape, vdt,
                                                      SEED + 120 + i, dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 130 + i)
        ct = torch.randn(shape[:3] + (64,), generator=g, device=dev).to(dt)
        finite = coords.nan_to_num(0.0)
        out = fl.fused_lookup_c1(levels, coords, kern, bias, RADIUS, dt)
        again = fl.fused_lookup_c1(levels, coords, kern, bias, RADIUS, dt)
        dv, _, _ = fl.fused_lookup_backward(levels, coords, kern, bias, ct,
                                            RADIUS, dt)
        dvb, _, _ = fl.fused_lookup_backward(levels, coords, kern, bias, ct,
                                             RADIUS, dt)
        _, dk, db = fl.fused_lookup_backward(levels, finite, kern, bias, ct,
                                             RADIUS, dt)
        _, dkb, dbb = fl.fused_lookup_backward(levels, finite, kern, bias,
                                               ct, RADIUS, dt)
        n_calls += 2
        want = fl.fused_lookup_c1_plain(levels, coords, kern, bias, RADIUS,
                                        dt)
        w_dv, _, _ = fl.fused_lookup_c1_backward_plain(
            levels, coords, kern, bias, ct, RADIUS, dt)
        _, w_dk, w_db = fl.fused_lookup_c1_backward_plain(
            levels, finite, kern, bias, ct, RADIUS, dt)
        torch.cuda.synchronize()
        err_f, ok_f = within_bound(out, want, dt)
        dvol = [within_bound(a, b, vdt) for a, b in zip(dv, w_dv)]
        rel = max(rel_dev(dk, w_dk), rel_dev(db, w_db))
        det = dict(fwd=bitwise(out, again),
                   dvol=all(bitwise(a, b) for a, b in zip(dv, dvb)),
                   dk_db=torch.equal(dk, dkb) and torch.equal(db, dbb))
        bitwise_plain = dict(fwd=bitwise(out, want),
                             dvol=[bitwise(a, b) for a, b in zip(dv, w_dv)])
        emit("fused_lookup_parity", config=cfg_name, shape=list(shape),
             volume_dtype=vname, compute_dtype=dname, max_abs_err_fwd=err_f,
             max_abs_err_dvol=[e for e, _ in dvol], rel_err_dk_db=rel,
             bitwise_vs_plain=bitwise_plain, deterministic=det)
        check(ok_f and bool(torch.isnan(out).any()),
              f"fused_lookup forward differs at {cfg_name}")
        check(all(ok for _, ok in dvol),
              f"fused_lookup dvol differs at {cfg_name}")
        check(rel <= KERNEL_TOL, f"fused_lookup dk/db differ by {rel} "
                                 f"relative at {cfg_name}")
        check(all(det.values()), f"fused_lookup kernels not deterministic "
                                 f"at {cfg_name}: {det}")
        check(bool((out.view(-1, 64)[6:8] == torch.relu(bias).to(dt)).all())
              and all(bool((d.view(-1, d.shape[-1])[6:8] == 0).all())
                      for d in dv), "far-out centers looked up taps")
        errs["fwd"] = max(errs["fwd"], err_f)
        errs["dvol"] = max([errs["dvol"]] + [e for e, _ in dvol])
        errs["dk_db_rel"] = max(errs["dk_db_rel"], rel)
        del levels, out, again, dv, dvb, want, w_dv
    check((fl.fused_lookup_c1.launches - before[0],
           fl.fused_lookup_c1.bwd_launches - before[1])
          == (n_calls, 2 * n_calls),
          "the parity calls did not launch the fused_lookup kernels")
    return errs


def lookup_c1_bytes_flops(levels, coords, dt, backward=False):
    """Least bytes, flops and product flops of one fused_lookup launch on
    these inputs; the products (corr x k, and in the backward dk and dcorr)
    take operands in dt. Forward: the centers and each level's in-range
    taps read once, the kernel and bias read, the 64-channel output
    written in dt; per pixel 3 flops per blended value, 2 product flops per
    term of the 36x64 product, 2 flops per channel for the bias and the
    ReLU. Backward: the same reads plus the cotangent, every dvol written
    whole and dk/db; the forward's flops plus the mask, db and the 3 flops
    per window tap of dg, and the product flops of dk and dcorr."""
    import torch
    n_pix = coords.numel()
    k = 2 * RADIUS + 1
    c_ch = 4 * k
    c = torch.nan_to_num(coords, nan=0.0).clamp(-1e8, 1e8)
    taps = 0
    for i, v in enumerate(levels):
        base = torch.floor(c / (2 ** i)).long() - RADIUS
        idx = base[..., None] + torch.arange(k + 1, device=c.device)
        taps += int(((idx >= 0) & (idx < v.shape[-1])).sum().item())
    es_v = levels[0].element_size()
    es_dt = torch.empty((), dtype=dt).element_size()
    reads = n_pix * 4 + taps * es_v + (c_ch * 64 + 64) * 4
    flops = n_pix * (c_ch * 3 + 64 * 2)
    product = n_pix * c_ch * 64 * 2
    if not backward:
        return reads + n_pix * 64 * es_dt, flops, product
    writes = sum(v.numel() for v in levels) * es_v + (c_ch * 64 + 64) * 4
    return (reads + n_pix * 64 * es_dt + writes,
            flops + n_pix * (64 + 64 + 4 * (k + 1) * 3),
            product + n_pix * (c_ch * 64 * 2 + 64 * c_ch * 2))


def lookup_c1_yardstick(levels, coords, kern, bias, dt, ct=None):
    """The unfused formulation as PyTorch calls: F.grid_sample of each
    level at its 2r+1 tap positions (bilinear, zeros, align_corners), the
    4 levels concatenated, a 1x1 F.conv2d in dt and a ReLU. Returns a call
    computing it or, with a cotangent ``ct``, a call taking its gradients
    in the levels, the kernel and the bias by torch.autograd.grad on a
    prebuilt graph."""
    import torch
    import torch.nn.functional as F
    dx = torch.arange(-RADIUS, RADIUS + 1, device=coords.device,
                      dtype=torch.float32)
    grids = []
    for i, v in enumerate(levels):
        x = (coords / (2 ** i)).reshape(-1, 1, 1, 1) + dx.view(1, 1, -1, 1)
        xn = 2.0 * x / max(v.shape[-1] - 1, 1) - 1.0
        grids.append(torch.cat([xn, torch.zeros_like(xn)], dim=-1).to(
            v.dtype))
    c_ch = kern.shape[0]

    def fwd(lv, k, b):
        corr = torch.cat([F.grid_sample(
            v.reshape(-1, 1, 1, v.shape[-1]), grid, mode="bilinear",
            padding_mode="zeros", align_corners=True).view(
                *v.shape[:3], 2 * RADIUS + 1)
            for v, grid in zip(lv, grids)], dim=-1).to(dt)
        y = F.conv2d(corr.permute(0, 3, 1, 2),
                     k.t().reshape(64, c_ch, 1, 1).to(dt), b.to(dt))
        return torch.relu(y).permute(0, 2, 3, 1)

    if ct is None:
        return lambda: fwd(levels, kern, bias)
    lv = [v.detach().requires_grad_() for v in levels]
    k = kern.detach().requires_grad_()
    b = bias.detach().requires_grad_()
    out = fwd(lv, k, b)
    return lambda: torch.autograd.grad(out, (*lv, k, b), ct.to(out.dtype),
                                       retain_graph=True)


def run_hires(dev, fc, windowed_sample, model_seed):
    """The hires path: the default architecture with alt_cuda through
    StereoPredictor on a 1988x2880 pair (padded to 2016x2880), 32
    iterations; and the peak memory of alt_cuda against reg_cuda on the
    same pair at 2 iterations."""
    import numpy as np
    import torch
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.inference import StereoPredictor
    from raft_stereo_tpu_torch.models import RAFTStereo
    h, w, iters = HIRES_H, HIRES_W, 32
    left, right = stereo_pair(h, w, SEED + 5, shift=24)
    cfg = RAFTStereoConfig(corr_implementation="alt_cuda")
    state = seeded_weights(RAFTStereo(cfg), model_seed)
    pred = StereoPredictor(cfg, state, valid_iters=iters, device=dev)
    pred(left, right, iters=2)  # warm-up: cuDNN autotuning, allocator
    fc.fused_corr.launches = 0
    windowed_sample.launches = 0
    flow, _ = pred.predict_timed(left, right)
    launches = (fc.fused_corr.launches, windowed_sample.launches)
    want = (iters, 0)  # one fused_corr launch for the four levels
    check(launches == want, f"hires: (fused_corr, windowed_sample) "
                            f"launches {launches}, expected {want}")
    check(flow.shape == (1, h, w, 1), f"hires: shape {flow.shape}")
    check(bool(np.isfinite(flow).all()), "hires: non-finite output")
    secs = [pred.predict_timed(left, right)[1] for _ in range(HIRES_RUNS)]
    peaks = {}
    for impl in ("alt_cuda", "reg_cuda"):
        p = pred if impl == "alt_cuda" else StereoPredictor(
            RAFTStereoConfig(corr_implementation=impl), state,
            valid_iters=2, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        p(left, right, iters=2)
        torch.cuda.synchronize()
        peaks[impl] = torch.cuda.max_memory_allocated(dev)
        del p
    del pred
    result = dict(padded=[2016, 2880], iters=iters, launches=launches[0],
                  launches_windowed_sample=launches[1],
                  ms_per_frame_median=statistics.median(secs) * 1e3,
                  ms_per_frame_runs=[s * 1e3 for s in secs],
                  peak_mem_bytes_2it=peaks,
                  disparity_range=[float(-flow.max()), float(-flow.min())])
    emit("hires", **result)
    check(peaks["alt_cuda"] < peaks["reg_cuda"],
          f"hires: alt_cuda's peak {peaks['alt_cuda']} is not below "
          f"reg_cuda's {peaks['reg_cuda']}")
    return result, state


def run_train(dev, impl, kernel, others, model_seed, phase="train",
              per_iter=4, per_iter_bwd=None, **overrides):
    """Timed training steps at the SceneFlow recipe's shape with ``impl``
    (and the config ``overrides``): each step launches ``kernel``'s forward
    ``per_iter`` x 22 times and as many again recomputed, its backward
    ``per_iter_bwd`` (default ``per_iter``) x 22 times, and the kernels of
    ``others`` never. For reg_cuda (phase "train"), then an injected NaN
    step."""
    import torch
    from raft_stereo_tpu_torch.config import sceneflow_config
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.training.optim import fetch_optimizer
    from raft_stereo_tpu_torch.training.state import (TrainState,
                                                      make_train_step)
    mcfg, tcfg = sceneflow_config()
    mcfg = dataclasses.replace(mcfg, corr_implementation=impl, **overrides)
    b, (h, w), iters = tcfg.batch_size, tcfg.image_size, tcfg.train_iters
    model = RAFTStereo(mcfg)
    seeded_weights(model, model_seed)
    model.to(dev)
    opt = fetch_optimizer(tcfg, model.parameters())
    state = TrainState(model, opt)
    step = make_train_step(model, opt, iters)
    batch = train_batch(b, h, w, SEED + 3, dev)
    state, m = step(state, batch)  # warm-up: allocator, cuDNN plans
    torch.cuda.synchronize()
    start = [p.detach().clone() for p in model.parameters()]
    torch.cuda.reset_peak_memory_stats(dev)
    want = (2 * per_iter * iters,
            (per_iter if per_iter_bwd is None else per_iter_bwd) * iters)
    secs, losses, norms = [], [], []
    for _ in range(TRAIN_STEPS):
        for k in (kernel, *others):
            k.launches = k.bwd_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got = (kernel.launches, kernel.bwd_launches)
        check(got == want, f"{phase}: (forward incl. recompute, backward) "
                           f"launches {got}, expected {want}")
        check(all((k.launches, k.bwd_launches) == (0, 0) for k in others),
              f"{phase}: launched another implementation's kernels")
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        check(float(m["skipped_updates"]) == 0.0, f"{phase}: update skipped")
    check(all(map(math.isfinite, losses + norms)),
          f"{phase}: loss {losses} or grad norm {norms} not finite")
    moved = sum(bool((p != p0).any())
                for p, p0 in zip(model.parameters(), start))
    n_leaves = len(start)
    check(moved >= 0.9 * n_leaves, f"{phase}: only {moved} of {n_leaves} "
                                   "parameter leaves moved")
    ms = statistics.median(secs) * 1e3
    label = " + ".join([f"sceneflow_config() + {impl}"]
                       + [f"{k}={v}" for k, v in overrides.items()])
    result = dict(config=label, batch=b,
                  image_size=[h, w], iters=iters,
                  launches_fwd=want[0], launches_bwd=want[1],
                  ms_per_step_median=ms, ms_per_step_runs=[s * 1e3
                                                           for s in secs],
                  pairs_per_s=b / (ms / 1e3),
                  peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                  loss=losses, grad_norm=norms, leaves_moved=moved,
                  leaves=n_leaves, lr_position=opt.count)
    emit(phase, **result)
    if phase != "train":
        return result

    # 9. an injected NaN batch is skipped
    bad = dict(batch, image1=batch["image1"].clone())
    bad["image1"][0, 5, 7, 0] = float("nan")
    params = list(model.parameters())
    before = [p.detach().clone() for p in params]
    moments = [t.clone() for p in params for t in (
        opt.adamw.state[p]["exp_avg"], opt.adamw.state[p]["exp_avg_sq"])]
    count, step_no = opt.count, state.step
    state, m = step(state, bad)
    same = all(torch.equal(p, p0) for p, p0 in zip(params, before)) and all(
        torch.equal(t, t0) for t, t0 in zip(
            [t for p in params for t in (opt.adamw.state[p]["exp_avg"],
                                         opt.adamw.state[p]["exp_avg_sq"])],
            moments))
    emit("train_nan", skipped_updates=float(m["skipped_updates"]),
         loss=float(m["loss"]), params_and_moments_unchanged=same,
         lr_position=[count, opt.count], step=[step_no, state.step])
    check(float(m["skipped_updates"]) == 1.0, "the NaN step was not skipped")
    check(same, "the NaN step changed parameters or AdamW moments")
    check(opt.count == count and state.step == step_no + 1,
          "the NaN step moved the LR position or did not count the batch")
    return result


def train_cpu_parity(dev, impl, kernel, state, modes, size=(64, 160),
                     launches=(16, 8), **overrides):
    """One fp32 training step of the default architecture with ``impl``
    (and the config ``overrides``) at ``size``, 2 iterations, on the card
    (``kernel``'s kernels, ``launches`` forward and backward) against the
    CPU (plain versions), in each cuDNN mode of ``modes``, gated by
    check_grad_parity over NULL_RUNS CPU null runs."""
    import torch
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.training.state import loss_and_grads
    cfg = RAFTStereoConfig(corr_implementation=impl, **overrides)
    on_cpu = RAFTStereo(cfg)
    on_cpu.load_state_dict(state, strict=True)
    on_gpu = RAFTStereo(cfg)
    on_gpu.load_state_dict(state, strict=True)
    on_gpu.to(dev)
    batch = train_batch(1, *size, SEED + 4, "cpu", max_disp=16.0)
    loss_c, _, grads_c = loss_and_grads(on_cpu, batch, 2)
    nulls = [loss_and_grads(perturbed_copy(on_cpu, NULL_PERTURBATION,
                                           SEED + i), batch, 2)[2]
             for i in range(NULL_RUNS)]
    names = [n for n, _ in on_cpu.named_parameters()]
    runs = {}
    try:
        for label, cudnn in modes:
            torch.backends.cudnn.enabled = cudnn
            kernel.launches = kernel.bwd_launches = 0
            loss_g, _, grads_g = loss_and_grads(on_gpu, batch, 2)
            torch.cuda.synchronize()
            got = (kernel.launches, kernel.bwd_launches)
            check(got == tuple(launches), f"card step ({impl}) launches "
                                          f"{got} != {tuple(launches)}")
            runs[label] = dict(
                loss_rel_dev=abs(float(loss_g) - float(loss_c))
                / abs(float(loss_c)),
                **check_grad_parity(names, [g.cpu() for g in grads_g],
                                    grads_c, nulls))
    finally:
        torch.backends.cudnn.enabled = True
    return runs


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; the port's main "
              "path needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from raft_stereo_tpu_torch.config import RAFTStereoConfig, realtime_config
    from raft_stereo_tpu_torch.inference import StereoPredictor
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.ops.kernels import _build
    from raft_stereo_tpu_torch.ops.kernels import alt_corr as ac
    from raft_stereo_tpu_torch.ops.kernels import fused_corr as fc
    from raft_stereo_tpu_torch.ops.kernels import fused_lookup as fl
    from raft_stereo_tpu_torch.ops.kernels import windowed_sample as ws_mod
    windowed_sample = ws_mod.windowed_sample
    fused_corr = fc.fused_corr
    alt_corr = ac.alt_corr
    fused_lookup_c1 = fl.fused_lookup_c1
    all_kernels = (windowed_sample, fused_corr, alt_corr, fused_lookup_c1)
    t_start = time.perf_counter()

    # 1. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    kernel_names = [ws_mod.KERNEL_NAME, fc.KERNEL_NAME, ac.KERNEL_NAME,
                    fl.KERNEL_NAME]
    # one nvcc a source, all started together
    nvcc_seconds = _build.build_all(kernel_names)
    for name in kernel_names:
        _build.load_library(name)
    emit("build", kernels=kernel_names,
         seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds={k: round(v, 1) for k, v in nvcc_seconds.items()})

    # level shapes of both inference configurations (384x1248 padded) and
    # of the training batch (8 x 320x720, bf16 volume)
    level_shapes = {
        "default": (torch.float32,
                    [(1, 96, 312, 312 >> i) for i in range(4)]),
        "realtime": (torch.bfloat16,
                     [(1, 48, 156, 156 >> i) for i in range(4)]),
        "train": (torch.bfloat16,
                  [(8, 80, 180, 180 >> i) for i in range(4)]),
    }

    # 3. kernel parity
    max_err = 0.0
    before = windowed_sample.launches
    n_calls = 0
    for cfg_name, (dtype, shapes) in level_shapes.items():
        for i, shape in enumerate(shapes):
            vol, center = lookup_inputs(shape, dtype, SEED + i, dev)
            got = windowed_sample(vol, center, RADIUS)
            n_calls += 1
            want = ws_mod.windowed_sample_plain(vol, center, RADIUS)
            torch.cuda.synchronize()
            nan_got, nan_want = torch.isnan(got), torch.isnan(want)
            check(torch.equal(nan_got, nan_want),
                  f"NaN pattern differs at {cfg_name} {shape}")
            check(bool(nan_got.any()), "the NaN center gave no NaN")
            err = (got - want).abs()[~nan_got].max().item()
            far = got.view(-1, 2 * RADIUS + 1)[6:8]
            check(bool((far == 0).all()), "far-out centers are not zero")
            max_err = max(max_err, err)
            emit("parity", config=cfg_name, shape=list(shape),
                 dtype=str(dtype).replace("torch.", ""), max_abs_err=err)
    check(max_err <= KERNEL_TOL, f"kernel error {max_err} > {KERNEL_TOL}")
    check(windowed_sample.launches - before == n_calls,
          "the parity calls did not launch the kernel")

    # 4. backward kernel parity
    bwd_err = 0.0
    before = windowed_sample.bwd_launches
    n_calls = 0
    for cfg_name, (dtype, shapes) in level_shapes.items():
        for i, shape in enumerate(shapes):
            vol, center = lookup_inputs(shape, dtype, SEED + 20 + i, dev)
            g = torch.Generator(device=dev).manual_seed(SEED + 30 + i)
            ct = torch.randn(center.shape + (2 * RADIUS + 1,), generator=g,
                             device=dev)
            dvol, dcoords = ws_mod.windowed_sample_backward(vol, center, ct,
                                                            RADIUS)
            again = ws_mod.windowed_sample_backward(vol, center, ct, RADIUS)
            n_calls += 2
            want_dvol, want_dc = ws_mod.windowed_sample_backward_plain(
                vol, center, ct, RADIUS)
            torch.cuda.synchronize()
            nan = torch.isnan(want_dvol)
            check(torch.equal(torch.isnan(dvol), nan) and bool(nan.any()),
                  f"backward NaN pattern differs at {cfg_name} {shape}")
            diff = (dvol.float() - want_dvol.float())[~nan].abs()
            ulp = want_dvol.float()[~nan].abs() * (
                2.0 ** -7 if dtype == torch.bfloat16 else 0.0)
            check(bool((diff <= torch.clamp(ulp, min=KERNEL_TOL)).all()),
                  f"backward dvol differs at {cfg_name} {shape}")
            err_dvol = diff.max().item()
            err_dc = (dcoords - want_dc).abs().max().item()
            det = torch.equal(dvol.nan_to_num(), again[0].nan_to_num()) \
                and torch.equal(dcoords, again[1])
            check(det, f"backward not deterministic at {cfg_name} {shape}")
            rows = dvol.view(-1, shape[-1])[6:8]
            check(bool((rows == 0).all()), "far-out centers wrote taps")
            bwd_err = max(bwd_err, err_dvol, err_dc)
            emit("bwd_parity", config=cfg_name, shape=list(shape),
                 dtype=str(dtype).replace("torch.", ""),
                 max_abs_err_dvol=err_dvol, max_abs_err_dcoords=err_dc,
                 bitwise_dvol=err_dvol == 0.0, deterministic=det)
    check(bwd_err <= KERNEL_TOL, f"backward error {bwd_err} > {KERNEL_TOL}")
    check(windowed_sample.bwd_launches - before == n_calls,
          "the parity calls did not launch the backward kernel")

    # fused_corr: kernels against plain, and the memory contract
    fused_err = run_feature_parity(
        dev, "fused_parity", fused_corr,
        (fused_corr, fc.fused_corr_backward, fc.fused_corr_plain,
         fc.fused_corr_backward_plain), SEED + 60)
    check(fused_err["fwd"] <= KERNEL_TOL,
          f"fused forward error {fused_err['fwd']} > {KERNEL_TOL}")
    pyramid_err = run_pyramid_parity(dev, fc)
    check(pyramid_err <= KERNEL_TOL,
          f"fused pyramid error {pyramid_err} > {KERNEL_TOL}")
    fused_err["fwd"] = max(fused_err["fwd"], pyramid_err)
    run_feature_memory(dev, "fused_memory", "fused", fc.fused_corr_backward)

    # alt_corr: kernels against plain and against fused_corr, the memory
    # contract; fused_lookup: kernels against plain
    alt_err = run_feature_parity(
        dev, "alt_parity", alt_corr,
        (alt_corr, ac.alt_corr_backward, ac.alt_corr_plain,
         ac.alt_corr_backward_plain), SEED + 100,
        against=(fused_corr, fc.fused_corr_backward))
    run_feature_memory(dev, "alt_memory", "alt_pallas", ac.alt_corr_backward)
    lookup_err = run_fused_lookup_parity(dev, fl)

    # 5-6. main path at full width: both configurations through the
    # volume lookup, the default architecture through alt_corr, and both
    # through the fused lookup+convc1 kernel
    left, right = stereo_pair(375, 1242, SEED)
    main = {}
    for name, cfg, iters, kernel, per_iter in [
            ("default", RAFTStereoConfig(corr_implementation="reg_cuda"), 32,
             windowed_sample, 4),
            ("realtime", realtime_config(), 7, windowed_sample, 4),
            ("alt_pallas", RAFTStereoConfig(corr_implementation="alt_pallas"),
             32, alt_corr, 4),
            ("default_fused_lookup", RAFTStereoConfig(
                corr_implementation="reg_cuda", fused_lookup=True), 32,
             fused_lookup_c1, 1),
            ("realtime_fused_lookup", dataclasses.replace(
                realtime_config(), fused_lookup=True), 7, fused_lookup_c1,
             1)]:
        state = seeded_weights(RAFTStereo(cfg), SEED)
        pred = StereoPredictor(cfg, state, valid_iters=iters, device=dev)
        pred(left, right)  # warm-up: cuDNN autotuning, allocator
        torch.cuda.reset_peak_memory_stats(dev)
        for k in all_kernels:
            k.launches = 0
        flow, _ = pred.predict_timed(left, right)
        launches = kernel.launches
        want = per_iter * iters
        others = [k.launches for k in all_kernels if k is not kernel]
        check(launches == want and not any(others),
              f"{name}: {launches} kernel launches, expected {want}; "
              f"others {others}")
        check(flow.shape == (1, 375, 1242, 1), f"{name}: shape {flow.shape}")
        check(bool(np.isfinite(flow).all()), f"{name}: non-finite output")
        secs = [pred.predict_timed(left, right)[1] for _ in range(7)]
        main[name] = dict(launches=launches, iters=iters,
                          ms_per_frame=statistics.median(secs) * 1e3,
                          ms_all=[s * 1e3 for s in secs])
        emit(name, padded=[384, 1248], iters=iters, launches=launches,
             kernel=kernel.__name__,
             ms_per_frame_median=main[name]["ms_per_frame"],
             ms_per_frame_runs=main[name]["ms_all"],
             peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
             disparity_range=[float(-flow.max()), float(-flow.min())])
        if name == "default":
            default_state = state
        del pred

    # hires: alt_cuda at 2016x2880, peak memory beside reg_cuda's
    hires, _ = run_hires(dev, fc, windowed_sample, SEED)

    # 7. device against CPU, same weights, through each kernel (the fused
    # lookup at 64x352, the narrowest pair whose pyramid it takes)
    for impl, kernel, (h, w), per_iter, extra in (
            ("reg_cuda", windowed_sample, (64, 160), 4, {}),
            ("alt_cuda", fused_corr, (64, 160), 1, {}),
            ("alt_pallas", alt_corr, (64, 160), 4, {}),
            ("reg_cuda", fused_lookup_c1, (64, 352), 1,
             {"fused_lookup": True})):
        small_l, small_r = stereo_pair(h, w, SEED + 1, shift=6)
        cfg = RAFTStereoConfig(corr_implementation=impl, **extra)
        on_gpu = StereoPredictor(cfg, default_state, valid_iters=4,
                                 device=dev)
        on_cpu = StereoPredictor(cfg, default_state, valid_iters=4,
                                 device="cpu")
        for k in all_kernels:
            k.launches = 0
        f_gpu = on_gpu(small_l, small_r)
        check(kernel.launches == 4 * per_iter,
              f"the card run of {impl} {extra} missed its kernel")
        f_cpu = on_cpu(small_l, small_r)
        dev_px = float(np.abs(f_gpu - f_cpu).max())
        emit("cpu_parity", impl=impl, kernel=kernel.__name__, shape=[h, w],
             iters=4, max_abs_px=dev_px, bound_px=CPU_PARITY_TOL_PX,
             max_abs_flow=float(np.abs(f_cpu).max()))
        check(dev_px <= CPU_PARITY_TOL_PX,
              f"card vs CPU forward ({impl}) differ by {dev_px} px")

    # 8-9. training steps at the SceneFlow recipe's shape, a NaN step;
    # then the same recipe with alt_cuda, with alt_pallas and with the
    # fused lookup
    def others(kernel):
        return [k for k in all_kernels if k is not kernel]
    train = run_train(dev, "reg_cuda", windowed_sample,
                      others(windowed_sample), SEED)
    train_fused = run_train(dev, "alt_cuda", fused_corr, others(fused_corr),
                            SEED, phase="train_fused", per_iter=1,
                            per_iter_bwd=4)
    train_alt = run_train(dev, "alt_pallas", alt_corr, others(alt_corr),
                          SEED, phase="train_alt")
    train_lookup = run_train(dev, "reg_cuda", fused_lookup_c1,
                             others(fused_lookup_c1), SEED,
                             phase="train_fused_lookup", per_iter=1,
                             fused_lookup=True)

    # 10. one fp32 training step, card against CPU, same weights: reg_cuda
    # with the card's convolutions in cuDNN (the main path's) and outside
    # it, alt_cuda in cuDNN
    for impl, kernel, modes, size, launches, extra in (
            ("reg_cuda", windowed_sample, (("cudnn", True),
                                           ("cudnn_off", False)),
             (64, 160), (16, 8), {}),
            ("alt_cuda", fused_corr, (("cudnn", True),), (64, 160), (4, 8),
             {}),
            ("alt_pallas", alt_corr, (("cudnn", True),), (64, 160), (16, 8),
             {}),
            ("reg_cuda", fused_lookup_c1, (("cudnn", True),), (64, 352),
             (4, 2), {"fused_lookup": True})):
        runs = train_cpu_parity(dev, impl, kernel, default_state, modes,
                                size, launches, **extra)
        emit("train_cpu_parity", impl=impl, kernel=kernel.__name__,
             shape=list(size), iters=2, launches=list(launches),
             loss_bound=TRAIN_LOSS_TOL, null_perturbation=NULL_PERTURBATION,
             null_runs=NULL_RUNS, **runs)
        for label, run in runs.items():
            check(run["loss_rel_dev"] <= TRAIN_LOSS_TOL,
                  f"card ({impl}, {label}) vs CPU loss differ by "
                  f"{run['loss_rel_dev']} relative")
            check(run["ok"], f"card ({impl}, {label}) vs CPU gradients "
                             f"beyond the null floor: {run}")

    # 11. timings at the main-path level shapes
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    per_level = []
    for cfg_name in ("default", "realtime"):
        dtype, shapes = level_shapes[cfg_name]
        for i, shape in enumerate(shapes):
            vol, center = lookup_inputs(shape, dtype, SEED + 10 + i, dev,
                                        edges=False)
            nbytes, flops = lookup_bytes_flops(vol, center)
            bound, bound_by = bound_ms(nbytes, flops, 0, torch.float32)
            lib_call = grid_sample_lookup(vol, center)
            lib_err = (lib_call().float().reshape(center.shape + (-1,))
                       - ws_mod.windowed_sample_plain(vol, center, RADIUS)
                       ).abs().max().item()
            row = dict(
                config=cfg_name, shape=list(shape),
                dtype=str(dtype).replace("torch.", ""),
                ms=cuda_ms(lambda: windowed_sample(vol, center, RADIUS),
                           flush),
                plain_ms=cuda_ms(lambda: ws_mod.windowed_sample_plain(
                    vol, center, RADIUS), flush),
                library_ms=cuda_ms(lib_call, flush),
                library_max_abs_diff=lib_err,
                bound_ms=bound, bound_by=bound_by,
                bytes=nbytes, flops=flops)
            per_level.append(row)
            emit("timings", **row)

    bwd_levels = []
    dtype, shapes = level_shapes["train"]
    for i, shape in enumerate(shapes):
        vol, center = lookup_inputs(shape, dtype, SEED + 40 + i, dev,
                                    edges=False)
        g = torch.Generator(device=dev).manual_seed(SEED + 50 + i)
        ct = torch.randn(center.shape + (2 * RADIUS + 1,), generator=g,
                         device=dev)
        nbytes, flops = lookup_bwd_bytes_flops(vol, center)
        bound, bound_by = bound_ms(nbytes, flops, 0, torch.float32)
        lib_call = grid_sample_backward(vol, center, ct)
        want = ws_mod.windowed_sample_backward_plain(vol, center, ct, RADIUS)
        lib_err = (lib_call()[0].float().reshape(vol.shape)
                   - want[0].float()).abs().max().item()
        row = dict(
            config="train", shape=list(shape),
            dtype=str(dtype).replace("torch.", ""),
            ms=cuda_ms(lambda: ws_mod.windowed_sample_backward(
                vol, center, ct, RADIUS, need_dcoords=False), flush),
            plain_ms=cuda_ms(lambda: ws_mod.windowed_sample_backward_plain(
                vol, center, ct, RADIUS), flush),
            library_ms=cuda_ms(lib_call, flush),
            library_max_abs_diff=lib_err,
            bound_ms=bound, bound_by=bound_by,
            bytes=nbytes, flops=flops)
        bwd_levels.append(row)
        emit("bwd_timings", **row)

    # fused_corr and alt_corr: fused_corr's forward as the main paths run it
    # (one launch for the four levels of the hires frame and of the
    # train_fused step) and per level; alt_corr's forward at its own
    # inference path's levels (the default frame with alt_pallas), at the
    # hires and the train levels; both backwards at the train levels. Each
    # on two center fields: "random" (an independent disparity a pixel,
    # the worst case for the staged span) with the plain version and the
    # yardstick, and "smooth" (smooth_centers, as a model's disparities
    # are) with the kernel's time and bound only. No single PyTorch call
    # computes their function: the yardstick is the reference's several-call
    # 'alt' formulation (alt_yardstick), reported as yardstick_ms. alt_corr's
    # rows add the slab's flops (alt_slab_flops) and their time at the fp32
    # peak, outside the bound.
    def slab(f1, f2, center):
        flops = alt_slab_flops(center, f2.shape[2], f1.shape[3])
        return dict(slab_flops=flops,
                    slab_fp32_ms=flops / FP32_FLOPS_PER_S * 1e3)
    hires0, train0 = FUSED_SHAPES["hires"][0], FUSED_SHAPES["train_fused"][0]
    fused_fwd = (fc.fused_corr_forward, fc.fused_corr_plain)
    fused_pyr = (fc.fused_corr_pyramid_forward, fc.fused_corr_pyramid_plain)
    alt_fwd = (ac.alt_corr_forward, ac.alt_corr_plain)
    fused_rows = {k: [] for k in ("fwd", "fwd_level", "fwd_train",
                                  "fwd_train_level", "bwd")}
    alt_rows = {k: [] for k in ("fwd", "fwd_hires", "fwd_train", "bwd")}
    for rows, which, backward, cfg_name, dtype, shapes, seed, fns, extra, \
            n_levels in (
            (fused_rows, "fwd", False, "hires", torch.float32, [hires0],
             SEED + 90, fused_pyr, None, 4),
            (fused_rows, "fwd_level", False, "hires", torch.float32,
             FUSED_SHAPES["hires"], SEED + 90, fused_fwd, None, 0),
            (fused_rows, "fwd_train", False, "train_fused", torch.bfloat16,
             [train0], SEED + 95, fused_pyr, None, 4),
            (fused_rows, "fwd_train_level", False, "train_fused",
             torch.bfloat16, FUSED_SHAPES["train_fused"], SEED + 95,
             fused_fwd, None, 0),
            (fused_rows, "bwd", True, "train_fused", torch.bfloat16,
             FUSED_SHAPES["train_fused"], SEED + 95,
             (fc.fused_corr_backward, fc.fused_corr_backward_plain), None,
             0),
            (alt_rows, "fwd", False, "alt_pallas", torch.float32,
             ALT_DEFAULT_SHAPES, SEED + 140, alt_fwd, slab, 0),
            (alt_rows, "fwd_hires", False, "hires", torch.float32,
             FUSED_SHAPES["hires"], SEED + 90, alt_fwd, slab, 0),
            (alt_rows, "fwd_train", False, "train_alt", torch.bfloat16,
             FUSED_SHAPES["train_fused"], SEED + 95, alt_fwd, slab, 0),
            (alt_rows, "bwd", True, "train_alt", torch.bfloat16,
             FUSED_SHAPES["train_fused"], SEED + 95,
             (ac.alt_corr_backward, ac.alt_corr_backward_plain), None, 0)):
        for field in ("random", "smooth"):
            for i, shape in enumerate(shapes):
                row = feature_timing(flush, backward, cfg_name, dtype, shape,
                                     seed + i, dev, *fns, extra=extra,
                                     field=field, n_levels=n_levels,
                                     full=field == "random")
                rows[which].append(row)
                emit("fused_timings" if rows is fused_rows else
                     "alt_timings", kernel=which, **row)

    # fused_lookup: one launch looks up all 4 levels; forward at the
    # default and realtime frames, backward at the train batch. The
    # yardstick is the unfused formulation in PyTorch calls
    # (lookup_c1_yardstick).
    lookup_rows = {"fwd": [], "bwd": []}
    for which, cfg_name in (("fwd", "default"), ("fwd", "realtime"),
                            ("bwd", "train")):
        vname, dname, shape = LOOKUP_C1[cfg_name]
        dt = getattr(torch, dname)
        levels, coords, kern, bias = lookup_c1_inputs(
            shape, getattr(torch, vname), SEED + 150, dev, edges=False)
        ct = None
        args = (levels, coords, kern, bias)
        if which == "fwd":
            kernel = lambda: fl.fused_lookup_forward(*args, RADIUS, dt)
            plain = lambda: fl.fused_lookup_c1_plain(*args, RADIUS, dt)
        else:
            g = torch.Generator(device=dev).manual_seed(SEED + 155)
            ct = torch.randn(shape[:3] + (64,), generator=g,
                             device=dev).to(dt)
            kernel = lambda: fl.fused_lookup_backward(*args, ct, RADIUS, dt)
            plain = lambda: fl.fused_lookup_c1_backward_plain(*args, ct,
                                                              RADIUS, dt)
        nbytes, flops, product = lookup_c1_bytes_flops(
            levels, coords, dt, backward=which == "bwd")
        bound, bound_by = bound_ms(nbytes, flops, product, dt)
        yard = lookup_c1_yardstick(levels, coords, kern, bias, dt, ct)
        got, want = yard(), plain()
        if which == "fwd":
            got, want = (got,), (want,)
        else:
            got, want = got, (*want[0], want[1], want[2])
        yard_err = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(got, want))
        del got, want
        row = dict(config=cfg_name, shape=list(shape), volume_dtype=vname,
                   compute_dtype=dname, ms=cuda_ms(kernel, flush),
                   plain_ms=cuda_ms(plain, flush),
                   yardstick_ms=cuda_ms(yard, flush),
                   yardstick_max_abs_diff=yard_err,
                   bound_ms=bound, bound_by=bound_by,
                   bytes=nbytes, flops=flops + product)
        lookup_rows[which].append(row)
        emit("fused_lookup_timings", kernel=which, **row)
        del yard, levels, coords, ct

    # kernels line: per-launch means over the levels each kernel runs at on
    # its main path (the default forward's four, the training step's four)
    dflt = [r for r in per_level if r["config"] == "default"]

    def mean(rows, key):
        return sum(r[key] for r in rows) / len(rows)

    def rnd(rows):
        return [r for r in rows if r["field"] == "random"]

    def smooth(rows):
        return [r for r in rows if r["field"] == "smooth"]
    print(json.dumps({"kernels": [{
        "name": ws_mod.KERNEL_NAME, "route": "cuda",
        "source": ws_mod.SOURCE, "replaces": ws_mod.REPLACES,
        "launches": main["default"]["launches"],
        "launches_realtime": main["realtime"]["launches"],
        "launches_train_step": train["launches_fwd"],
        "max_abs_err": max_err,
        "ms": mean(dflt, "ms"), "plain_ms": mean(dflt, "plain_ms"),
        "bound_ms": mean(dflt, "bound_ms"), "bound_by": dflt[0]["bound_by"],
        "library_ms": mean(dflt, "library_ms"),
        "timed_at": "mean per launch over the default path's 4 levels "
                    "(1,96,312,{312,156,78,39}) fp32, L2 flushed",
    }, {
        "name": ws_mod.KERNEL_NAME + "_bwd", "route": "cuda",
        "source": ws_mod.SOURCE, "replaces": ws_mod.REPLACES_BWD,
        "launches": train["launches_bwd"],
        "max_abs_err": bwd_err,
        "ms": mean(bwd_levels, "ms"), "plain_ms": mean(bwd_levels,
                                                       "plain_ms"),
        "bound_ms": mean(bwd_levels, "bound_ms"),
        "bound_by": bwd_levels[0]["bound_by"],
        "library_ms": mean(bwd_levels, "library_ms"),
        "timed_at": "mean per launch over the training step's 4 levels "
                    "(8,80,180,{180,90,45,22}) bf16, L2 flushed",
    }] + [{
        "name": fc.KERNEL_NAME + suffix, "route": "cuda",
        "source": fc.SOURCE, "replaces": replaces,
        "launches": launches, **extra,
        "max_abs_err": fused_err[which],
        "ms": mean(rnd(rows), "ms"), "plain_ms": mean(rnd(rows), "plain_ms"),
        "bound_ms": mean(rnd(rows), "bound_ms"),
        "bound_by": rnd(rows)[0]["bound_by"],
        "library_ms": None, "yardstick_ms": mean(rnd(rows), "yardstick_ms"),
        "ms_smooth_centers": mean(smooth(rows), "ms"),
        "yardstick": "several calls: the reference's alt formulation "
                     "(F.grid_sample of fmap2 at the taps, product with "
                     "fmap1, sum over D); no single PyTorch call computes "
                     "the function",
        "timed_at": timed_at,
    } for which, suffix, replaces, launches, extra, rows, timed_at in (
        ("fwd", "", fc.REPLACES, hires["launches"],
         {"launches_train_step": train_fused["launches_fwd"],
          "ms_train": rnd(fused_rows["fwd_train"])[0]["ms"],
          "ms_levels_one_each": [r["ms"] for r in rnd(
              fused_rows["fwd_level"])]},
         fused_rows["fwd"], "per launch: one launch for the hires path's 4 "
         "levels (1,504,720,{720,360,180,90},256) fp32 on random centers, "
         "L2 flushed"),
        ("bwd", "_bwd", fc.REPLACES_BWD, train_fused["launches_bwd"], {},
         fused_rows["bwd"], "mean per launch over the train_fused step's 4 "
         "levels (8,80,180,{180,90,45,22},256) bf16 on random centers, L2 "
         "flushed"))] + [{
        "name": ac.KERNEL_NAME + suffix, "route": "cuda",
        "source": ac.SOURCE, "replaces": replaces,
        "launches": launches, **extra,
        "max_abs_err": alt_err[which],
        "max_abs_diff_fused_corr": alt_err[which + "_vs_other"],
        "ms": mean(rnd(rows), "ms"), "plain_ms": mean(rnd(rows), "plain_ms"),
        "bound_ms": mean(rnd(rows), "bound_ms"),
        "bound_by": rnd(rows)[0]["bound_by"],
        "library_ms": None, "yardstick_ms": mean(rnd(rows), "yardstick_ms"),
        "ms_smooth_centers": mean(smooth(rows), "ms"),
        "yardstick": "several calls: the reference's alt formulation "
                     "(F.grid_sample of fmap2 at the taps, product with "
                     "fmap1, sum over D); no single PyTorch call computes "
                     "the function",
        "timed_at": timed_at,
    } for which, suffix, replaces, launches, extra, rows, timed_at in (
        ("fwd", "", ac.REPLACES, main["alt_pallas"]["launches"],
         {"launches_train_step": train_alt["launches_fwd"],
          "slab_fp32_ms": mean(rnd(alt_rows["fwd"]), "slab_fp32_ms"),
          "ms_hires": mean(rnd(alt_rows["fwd_hires"]), "ms"),
          "bound_ms_hires": mean(rnd(alt_rows["fwd_hires"]), "bound_ms"),
          "ms_train": mean(rnd(alt_rows["fwd_train"]), "ms"),
          "bound_ms_train": mean(rnd(alt_rows["fwd_train"]), "bound_ms")},
         alt_rows["fwd"], "mean per launch over the alt_pallas frame's 4 "
         "levels (1,96,312,{312,156,78,39},256) fp32 on random centers, L2 "
         "flushed"),
        ("bwd", "_bwd", ac.REPLACES_BWD, train_alt["launches_bwd"], {},
         alt_rows["bwd"], "mean per launch over the train_alt step's 4 "
         "levels (8,80,180,{180,90,45,22},256) bf16 on random centers, L2 "
         "flushed"))] + [{
        "name": fl.KERNEL_NAME + suffix, "route": "cuda",
        "source": fl.SOURCE, "replaces": replaces,
        "launches": launches, **extra,
        "max_abs_err": err,
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "yardstick_ms": row["yardstick_ms"],
        "yardstick": "several calls: F.grid_sample x4, torch.cat, a 1x1 "
                     "F.conv2d and relu (backward by torch.autograd.grad); "
                     "no single PyTorch call computes the function",
        "timed_at": timed_at,
    } for suffix, replaces, launches, extra, err, row, timed_at in (
        ("", fl.REPLACES, main["default_fused_lookup"]["launches"],
         {"launches_realtime": main["realtime_fused_lookup"]["launches"],
          "launches_train_step": train_lookup["launches_fwd"],
          "ms_realtime": lookup_rows["fwd"][1]["ms"]},
         lookup_err["fwd"], lookup_rows["fwd"][0], "per launch at the "
         "default frame's pyramid (1,96,312,{312,156,78,39}) fp32, L2 "
         "flushed"),
        ("_bwd", fl.REPLACES_BWD, train_lookup["launches_bwd"],
         {"max_rel_err_dk_db": lookup_err["dk_db_rel"]}, lookup_err["dvol"],
         lookup_rows["bwd"][0], "per launch at the train batch's pyramid "
         "(8,80,180,{180,90,45,22}) bf16, L2 flushed"))]}),
        flush=True)
    emit("total", seconds=round(time.perf_counter() - t_start, 3))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
