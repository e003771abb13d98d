#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each reported as one JSON line:

1. device  — the card's name and power limit (nvidia-smi); TF32 is turned
   off for convolutions and matmuls, so fp32 means fp32 everywhere below.
2. build   — builds every CUDA kernel of the path from the sources in
   raft_stereo_tpu_torch/csrc with nvcc (sm_90a), timed as set-up.
3. parity  — each kernel against its plain PyTorch version on the card, at
   every pyramid-level shape of both main-path configurations, with edge
   centers (integers, borders, +-1e9, NaN). Bound: 1e-5 abs.
4. default — the default architecture with corr_implementation="reg_cuda"
   at full width (seeded random weights), through StereoPredictor on a
   375x1242 pair (padded to 384x1248), 32 iterations: finite output of the
   right shape, exactly 4 levels x 32 kernel launches, median ms/frame.
5. realtime — realtime_config() (bf16), 7 iterations, 28 launches.
6. cpu_parity — the default architecture on the same weights at 64x160,
   fp32, 4 iterations, on the card (kernel) and on the CPU (plain
   version). Bound: 1e-3 px on flow_up.
7. timings — per pyramid level: the kernel's time per launch, its bound
   (bytes over 3.35 TB/s, or flops over 67 TFLOP/s fp32, whichever is
   larger), the plain version's time and one F.grid_sample call computing
   the same lookup (the reference's formulation; a yardstick only).

Then the kernels line and, last, {"ok": true, "device": {...}}. Any failed
check raises, and the script exits non-zero without that last line. It
exits non-zero at once when torch.cuda is not available.
"""

import json
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
    before each (the refinement loop's convs evict it between lookups)."""
    import torch
    times = []
    for _ in range(reps + 5):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[5:])


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

    # level shapes of both main-path configurations (384x1248 padded)
    level_shapes = {
        "default": (torch.float32,
                    [(1, 96, 312, 312 >> i) for i in range(4)]),
        "realtime": (torch.bfloat16,
                     [(1, 48, 156, 156 >> i) for i in range(4)]),
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

    # 4-5. main path, both configurations at full width
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

    # 6. device against CPU, same weights
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

    # 7. timings at the main-path level shapes
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    per_level = []
    for cfg_name, (dtype, shapes) in level_shapes.items():
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

    # kernels line: per-launch means over the default path's four levels
    dflt = [r for r in per_level if r["config"] == "default"]

    def mean(key):
        return sum(r[key] for r in dflt) / len(dflt)
    print(json.dumps({"kernels": [{
        "name": ws_mod.KERNEL_NAME, "route": "cuda",
        "source": ws_mod.SOURCE, "replaces": ws_mod.REPLACES,
        "launches": main["default"]["launches"],
        "launches_realtime": main["realtime"]["launches"],
        "max_abs_err": max_err, "max_err": max_err,
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"), "bound_by": dflt[0]["bound_by"],
        "library_ms": mean("library_ms"),
        "timed_at": "mean per launch over the default path's 4 levels "
                    "(1,96,312,{312,156,78,39}) fp32, L2 flushed",
    }]}), flush=True)
    emit("total", seconds=round(time.perf_counter() - t_start, 3))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
