#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each reported as one JSON line:

1. device  — the card's name and power limit (nvidia-smi); TF32 is turned
   off for convolutions and matmuls, so fp32 means fp32 everywhere below.
2. build   — builds every CUDA kernel of the path from the sources in
   raft_stereo_tpu_torch/csrc with nvcc (sm_90a), timed as set-up.
3. parity  — the forward kernel against its plain PyTorch version on the
   card, at every pyramid-level shape of both inference configurations,
   with edge centers (integers, borders, +-1e9, NaN). Bound: 1e-5 abs.
4. bwd_parity — the backward kernel against its plain version at every
   level shape of the training batch and of both inference configurations,
   the same edge centers: dvol bitwise equal (NaN pattern included; bound
   1e-5 abs in fp32, one bf16 ulp in bf16), dcoords 1e-5 abs, and two runs
   bitwise equal.
5. default — the default architecture with corr_implementation="reg_cuda"
   at full width (seeded random weights), through StereoPredictor on a
   375x1242 pair (padded to 384x1248), 32 iterations: finite output of the
   right shape, exactly 4 levels x 32 kernel launches, median ms/frame.
6. realtime — realtime_config() (bf16), 7 iterations, 28 launches.
7. cpu_parity — the default architecture on the same weights at 64x160,
   fp32, 4 iterations, on the card (kernel) and on the CPU (plain
   version). Bound: 1e-3 px on flow_up.
8. train — the SceneFlow recipe (sceneflow_config(): bf16 compute, bf16
   volume) with reg_cuda, batch 8 at 320x720, 22 iterations, through
   make_train_step on a seeded synthetic batch: a warm-up step, then timed
   steps, each with exactly 4 x 22 forward launches, as many recomputed
   under remat_refinement and 4 x 22 backward launches; finite loss and
   gradient norm, no skipped update, parameters that moved; median
   ms/step and peak memory.
9. train_nan — a batch with a NaN pixel: the update is skipped, the
   parameters stay bitwise unchanged and the step still counts.
10. train_cpu_parity — one fp32 step of the default architecture at 64x160,
   2 iterations, on the card (kernels) and on the CPU (plain versions),
   with the card's convolutions in cuDNN (as the main path runs them) and
   outside it: the loss within 1e-5 relative, and the gradients within
   the null floor of NULL_RUNS CPU null runs (see check_grad_parity).
11. timings — per pyramid level: each kernel's time per launch, its bound
   (bytes over 3.35 TB/s, or flops over the fp32 peak, whichever is
   larger), the plain version's time and one PyTorch call computing the
   same function: F.grid_sample for the forward, its backward
   (torch.autograd.grad on a prebuilt graph) for the backward (the
   reference's formulation; a yardstick only).

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
KERNEL_TOL = 1e-5
CPU_PARITY_TOL_PX = 1e-3
RADIUS = 4
TRAIN_STEPS = 3              # timed steps after the warm-up step
TRAIN_LOSS_TOL = 1e-5        # card vs CPU step: relative loss deviation
NULL_PERTURBATION = 1e-6     # the CPU null runs' relative weight noise
NULL_RUNS = 8                # CPU null runs whose envelope bounds the card
ROUNDOFF_REL = 1e-7          # gradient leaves below this x the global norm


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


def lookup_inputs(shape, dtype, seed, device, edges=True):
    import torch
    b, h, w1, w2 = shape
    g = torch.Generator(device=device).manual_seed(seed)
    vol = torch.randn(shape, generator=g, device=device).to(dtype)
    x = torch.arange(w1, device=device, dtype=torch.float32) * (w2 / w1)
    disp = torch.rand((b, h, w1), generator=g, device=device) * (w2 / 4)
    center = (x - disp).contiguous()
    if edges:
        flat = center.view(-1)
        edge = [0.0, -1.0, float(w2 - 1), float(w2), -RADIUS - 0.5,
                w2 + RADIUS + 0.25, 1e9, -1e9, 0.999999, float("nan"),
                float(w2 // 2)]
        flat[:len(edge)] = torch.tensor(edge, device=device)
    return vol, center


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


def run_train(dev, windowed_sample, model_seed):
    """Phases 8 and 9: timed training steps at the SceneFlow recipe's
    shape, then an injected NaN step."""
    import torch
    from raft_stereo_tpu_torch.config import sceneflow_config
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.training.optim import fetch_optimizer
    from raft_stereo_tpu_torch.training.state import (TrainState,
                                                      make_train_step)
    mcfg, tcfg = sceneflow_config()
    mcfg = dataclasses.replace(mcfg, corr_implementation="reg_cuda")
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
    want = (2 * mcfg.corr_levels * iters, mcfg.corr_levels * iters)
    secs, losses, norms = [], [], []
    for _ in range(TRAIN_STEPS):
        windowed_sample.launches = 0
        windowed_sample.bwd_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got = (windowed_sample.launches, windowed_sample.bwd_launches)
        check(got == want, f"train: (forward incl. recompute, backward) "
                           f"launches {got}, expected {want}")
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        check(float(m["skipped_updates"]) == 0.0, "train: update skipped")
    check(all(map(math.isfinite, losses + norms)),
          f"train: loss {losses} or grad norm {norms} not finite")
    moved = sum(bool((p != p0).any())
                for p, p0 in zip(model.parameters(), start))
    n_leaves = len(start)
    check(moved >= 0.9 * n_leaves, f"train: only {moved} of {n_leaves} "
                                   "parameter leaves moved")
    ms = statistics.median(secs) * 1e3
    result = dict(config="sceneflow_config() + reg_cuda", batch=b,
                  image_size=[h, w], iters=iters,
                  launches_fwd=want[0], launches_bwd=want[1],
                  ms_per_step_median=ms, ms_per_step_runs=[s * 1e3
                                                           for s in secs],
                  pairs_per_s=b / (ms / 1e3),
                  peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                  loss=losses, grad_norm=norms, leaves_moved=moved,
                  leaves=n_leaves, lr_position=opt.count)
    emit("train", **result)

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
    from raft_stereo_tpu_torch.ops.kernels import windowed_sample as ws_mod
    windowed_sample = ws_mod.windowed_sample
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
    _build.build_all([ws_mod.KERNEL_NAME])
    _build.load_library(ws_mod.KERNEL_NAME)
    emit("build", kernels=[ws_mod.KERNEL_NAME],
         seconds=round(time.perf_counter() - t0, 3))

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

    # 5-6. main path, both configurations at full width
    left, right = stereo_pair(375, 1242, SEED)
    main = {}
    for name, cfg, iters in [
            ("default", RAFTStereoConfig(corr_implementation="reg_cuda"), 32),
            ("realtime", realtime_config(), 7)]:
        state = seeded_weights(RAFTStereo(cfg), SEED)
        pred = StereoPredictor(cfg, state, valid_iters=iters, device=dev)
        pred(left, right)  # warm-up: cuDNN autotuning, allocator
        torch.cuda.reset_peak_memory_stats(dev)
        windowed_sample.launches = 0
        flow, _ = pred.predict_timed(left, right)
        launches = windowed_sample.launches
        want = cfg.corr_levels * iters
        check(launches == want,
              f"{name}: {launches} kernel launches, expected {want}")
        check(flow.shape == (1, 375, 1242, 1), f"{name}: shape {flow.shape}")
        check(bool(np.isfinite(flow).all()), f"{name}: non-finite output")
        secs = [pred.predict_timed(left, right)[1] for _ in range(7)]
        main[name] = dict(launches=launches, iters=iters,
                          ms_per_frame=statistics.median(secs) * 1e3,
                          ms_all=[s * 1e3 for s in secs])
        emit(name, padded=[384, 1248], iters=iters, launches=launches,
             ms_per_frame_median=main[name]["ms_per_frame"],
             ms_per_frame_runs=main[name]["ms_all"],
             peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
             disparity_range=[float(-flow.max()), float(-flow.min())])
        if name == "default":
            default_state = state
        del pred

    # 7. device against CPU, same weights
    cfg = RAFTStereoConfig(corr_implementation="reg_cuda")
    small_l, small_r = stereo_pair(64, 160, SEED + 1, shift=6)
    on_gpu = StereoPredictor(cfg, default_state, valid_iters=4, device=dev)
    on_cpu = StereoPredictor(cfg, default_state, valid_iters=4, device="cpu")
    windowed_sample.launches = 0
    f_gpu = on_gpu(small_l, small_r)
    check(windowed_sample.launches == 16, "the card run missed the kernel")
    f_cpu = on_cpu(small_l, small_r)
    dev_px = float(np.abs(f_gpu - f_cpu).max())
    emit("cpu_parity", shape=[64, 160], iters=4, max_abs_px=dev_px,
         bound_px=CPU_PARITY_TOL_PX, max_abs_flow=float(np.abs(f_cpu).max()))
    check(dev_px <= CPU_PARITY_TOL_PX,
          f"card vs CPU forward differ by {dev_px} px")

    # 8-9. training steps at the SceneFlow recipe's shape, a NaN step
    train = run_train(dev, windowed_sample, SEED)

    # 10. one fp32 training step, card against CPU, same weights, with the
    # card's convolutions in cuDNN (the main path's) and outside it
    from raft_stereo_tpu_torch.training.state import loss_and_grads
    cfg = RAFTStereoConfig(corr_implementation="reg_cuda")
    on_cpu = RAFTStereo(cfg)
    on_cpu.load_state_dict(default_state, strict=True)
    on_gpu = RAFTStereo(cfg)
    on_gpu.load_state_dict(default_state, strict=True)
    on_gpu.to(dev)
    batch = train_batch(1, 64, 160, SEED + 4, "cpu", max_disp=16.0)
    loss_c, _, grads_c = loss_and_grads(on_cpu, batch, 2)
    nulls = [loss_and_grads(perturbed_copy(on_cpu, NULL_PERTURBATION,
                                           SEED + i), batch, 2)[2]
             for i in range(NULL_RUNS)]
    names = [n for n, _ in on_cpu.named_parameters()]
    runs = {}
    for label, cudnn in (("cudnn", True), ("cudnn_off", False)):
        torch.backends.cudnn.enabled = cudnn
        windowed_sample.launches = 0
        windowed_sample.bwd_launches = 0
        loss_g, _, grads_g = loss_and_grads(on_gpu, batch, 2)
        torch.cuda.synchronize()
        launches = (windowed_sample.launches, windowed_sample.bwd_launches)
        check(launches == (16, 8), f"card step launches {launches} != "
                                   "(16, 8)")
        runs[label] = dict(
            loss_rel_dev=abs(float(loss_g) - float(loss_c))
            / abs(float(loss_c)),
            **check_grad_parity(names, [g.cpu() for g in grads_g], grads_c,
                                nulls))
    torch.backends.cudnn.enabled = True
    emit("train_cpu_parity", shape=[64, 160], iters=2, launches=[16, 8],
         loss_bound=TRAIN_LOSS_TOL, null_perturbation=NULL_PERTURBATION,
         null_runs=NULL_RUNS, **runs)
    for label, run in runs.items():
        check(run["loss_rel_dev"] <= TRAIN_LOSS_TOL,
              f"card ({label}) vs CPU loss differ by "
              f"{run['loss_rel_dev']} relative")
        check(run["ok"], f"card ({label}) vs CPU gradients beyond the null "
                         f"floor: {run}")

    # 11. timings at the main-path level shapes
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    per_level = []
    for cfg_name in ("default", "realtime"):
        dtype, shapes = level_shapes[cfg_name]
        for i, shape in enumerate(shapes):
            vol, center = lookup_inputs(shape, dtype, SEED + 10 + i, dev,
                                        edges=False)
            nbytes, flops = lookup_bytes_flops(vol, center)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_flops = flops / FP32_FLOPS_PER_S * 1e3
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
                bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations",
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
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / FP32_FLOPS_PER_S * 1e3
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
            bound_ms=max(t_bytes, t_flops),
            bound_by="bytes" if t_bytes >= t_flops else "operations",
            bytes=nbytes, flops=flops)
        bwd_levels.append(row)
        emit("bwd_timings", **row)

    # kernels line: per-launch means over the levels each kernel runs at on
    # its main path (the default forward's four, the training step's four)
    dflt = [r for r in per_level if r["config"] == "default"]

    def mean(rows, key):
        return sum(r[key] for r in rows) / len(rows)
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
    }]}), flush=True)
    emit("total", seconds=round(time.perf_counter() - t_start, 3))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
