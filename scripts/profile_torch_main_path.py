#!/usr/bin/env python3
"""Where the PyTorch port's main path spends its time on one NVIDIA GPU.

    python3 scripts/profile_torch_main_path.py [--frames 3]
    python3 scripts/profile_torch_main_path.py --corr_implementation alt_cuda \
        --size 1988x2880
    python3 scripts/profile_torch_main_path.py --train [--frames 2]
    python3 scripts/profile_torch_main_path.py --fused_lookup [--train]
    python3 scripts/profile_torch_main_path.py --conv_sweep

For both served configurations — the default architecture with
corr_implementation="reg_cuda" (fp32, 32 iterations) and realtime_config()
(bf16, 7 iterations) — at full width (375x1242 padded to 384x1248, seeded
random weights as in chip_smoke.py), it profiles ``--frames`` warm
forwards with ``torch.profiler`` and prints one JSON line per
configuration:

* ``wall_ms`` per frame: ``StereoPredictor.predict_timed``'s forward time
  (inputs already on the card, synchronised at both ends), taken without
  the profiler, whose host-side tracing slows the launches it records;
* ``device_busy_ms`` per frame: the summed duration of the device kernels
  (one stream, so they do not overlap) and ``idle_share = 1 - busy/wall``;
  ``memcpy_ms``: the part of it that copies (the pageable input pair's
  host-to-device copy, which the host paces, so it varies from frame to
  frame);
* device time per kernel category (convolution, matmul, the
  windowed_sample, fused_corr and alt_corr lookups, the fused_lookup
  kernels, the rest), the top kernels by device time, and the operators
  that spend the most host time themselves (``top_host_ops``: where a
  host-bound frame's time goes).

``--corr_implementation`` profiles the default architecture alone with
that implementation (e.g. ``alt_cuda``, the memoryless fused_corr
kernels, or ``alt_pallas``, the alt_corr kernels), ``--fused_lookup``
turns on the fused lookup+convc1 kernel in every configuration profiled,
and ``--size HxW`` sets the input pair (padded to /32; default
375x1242).

With ``--train`` it profiles ``--frames`` training steps instead, at
chip_smoke.py's train shape (sceneflow_config() with reg_cuda, or with
``--corr_implementation``: batch 8 at 320x720, 22 iterations, bf16, seeded weights and batch), after a warm-up
step; convolution time is split into forward and backward (cuDNN's
dgrad/wgrad kernels), the lookup into its forward and backward
kernels, and ``wall_ms`` is per step.

TF32 is off, as in chip_smoke.py, unless ``--default_tf32`` leaves
PyTorch's defaults (cuDNN convolutions in TF32, matmuls in fp32: what the
port's entry points run with when the caller sets neither). At 2016x2880
cuDNN's heuristic once took an FFT algorithm for update_block.gru32's
convolutions, ~99,000 small kernels an iteration; the port's ``Conv`` now
runs that shape class through PyTorch's im2col + GEMM convolution
(nn/layers.py). ``--cudnn_benchmark`` times the frame with the algorithms
cuDNN's own benchmark picks instead, and ``--iters 1`` keeps a profile
small. ``--conv_kernels`` adds, per convolution (its input and weight
shapes), the kernels launched for it a frame, their device time, how many
are FFT kernels and the commonest kernel names, and the frame's FFT
kernels in all. ``--conv_sweep`` runs no model: for 3x3 fp32
convolutions (TF32 off) of the update block's channel counts over a range
of NHWC input sizes, it reports the kernels cuDNN's heuristic launches
for ``F.conv2d`` (FFT ones counted) and its time, the port's ``Conv`` (its
route and time) and PyTorch's im2col + GEMM convolution's time, each a
mean over 5 calls after one (1 call where cuDNN takes 1,000+ kernels),
timed with CUDA events; then, at update_block.gru32's hires shape, the
kernels cuDNN launches with other layouts, a padded width and its
deterministic mode. ``--unrepaired_pool`` (with
``--train``) times the step with the GRU links' pool on PyTorch's
channels-last CUDA backward, as before ``ops/geometry.avg_pool2d`` copied
its input to channels first (see scripts/card_vs_cpu_grads.py): the
repair's cost, run beside a plain ``--train`` call. Exits non-zero
without a CUDA device or when the profiler records no device kernels.
"""

import argparse
import collections
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def category(name: str, split: bool = False) -> str:
    """Kernel category by name; ``split`` separates forward from backward
    for the convolutions and the lookup."""
    n = name.lower()
    for kernel in ("alt_corr", "fused_lookup"):
        if kernel in n:
            if not split:
                return kernel
            return ("lookup_bwd" if "bwd" in n or "reduce" in n
                    else "lookup_fwd")
    if "fused_corr" in n:
        if not split:
            return "fused_corr"
        return "lookup_bwd" if "bwd" in n else "lookup_fwd"
    if "windowed_sample" in n:
        if not split:
            return "windowed_sample"
        return "lookup_bwd" if "bwd" in n else "lookup_fwd"
    if any(k in n for k in ("conv", "cudnn", "winograd", "implicit",
                            "xmma", "fprop", "dgrad", "wgrad", "nchw",
                            "nhwc")):
        if not split:
            return "convolution"
        return ("convolution_bwd" if any(k in n for k in ("dgrad", "wgrad"))
                else "convolution_fwd")
    if any(k in n for k in ("gemm", "cutlass", "cublas", "matmul")):
        return "matmul"
    return "other"


def summarize(prof, n: int, split: bool):
    """Device kernels of a profile: per-category and top-kernel device ms
    per unit (``n`` units profiled), or None when there are none."""
    import torch
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    by_cat = collections.Counter()
    by_name = collections.Counter()
    count = collections.Counter()
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_cat[category(e.name, split)] += us
        by_name[e.name] += us
        count[e.name] += 1
    # the device time each operator launched itself, by operator name, and
    # the host time it spent itself
    ops = sorted(((getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0), e.key, e.count,
                   e.self_cpu_time_total)
                  for e in prof.key_averages()), reverse=True)
    host_ops = sorted(ops, key=lambda o: -o[3])
    return {
        "device_busy_ms": sum(by_cat.values()) / 1e3 / n,
        # host-to-device copies of pageable inputs are paced by the host but
        # counted as device time (part of "other")
        "memcpy_ms": sum(v for k, v in by_name.items()
                         if k.startswith("Memcpy")) / 1e3 / n,
        "kernels_per_unit": len(kernels) / n,
        "category_ms": {k: v / 1e3 / n for k, v in by_cat.most_common()},
        "top": [{"name": name[:90], "ms": v / 1e3 / n,
                 "calls": count[name] // n}
                for name, v in by_name.most_common(12)],
        "top_ops": [{"op": key[:60], "self_device_ms": us / 1e3 / n,
                     "calls": calls // n}
                    for us, key, calls, _ in ops[:15] if us > 0],
        "top_host_ops": [{"op": key[:60], "self_host_ms": cpu / 1e3 / n,
                          "calls": calls // n}
                         for _, key, calls, cpu in host_ops[:12]],
    }


def conv_kernels(prof, n: int, top: int = 8):
    """Per convolution shape (input, weight) of a profile recorded with
    shapes: calls, kernels launched, device ms and FFT kernels per unit
    (``n`` units), and its commonest kernel names; the ``top`` by kernel
    count."""
    rows = {}
    for e in prof.events():
        if e.name not in ("aten::cudnn_convolution",
                          "aten::_slow_conv2d_forward") or not e.kernels:
            continue
        key = str([list(s) for s in e.input_shapes[:2]])
        row = rows.setdefault(key, dict(shapes=key, calls=0, kernels=0,
                                        device_us=0.0, fft_kernels=0,
                                        names=collections.Counter()))
        row["calls"] += 1
        for k in e.kernels:
            row["kernels"] += 1
            row["device_us"] += k.duration
            row["fft_kernels"] += "fft" in k.name.lower()
            row["names"][k.name[:70]] += 1
    out = []
    for row in sorted(rows.values(), key=lambda r: -r["kernels"])[:top]:
        out.append(dict(shapes=row["shapes"], calls=row["calls"] // n,
                        kernels=row["kernels"] // n,
                        device_ms=row["device_us"] / 1e3 / n,
                        fft_kernels=row["fft_kernels"] // n,
                        names=[f"{name} x{c // n}" for name, c in
                               row["names"].most_common(4)]))
    return out


SWEEP = {  # (in, out) channels: the update block's 3x3 convs
    "channels": ((256, 128), (384, 128), (128, 128), (128, 256), (64, 64)),
    "sizes": ((1, 24, 78), (1, 63, 90), (1, 96, 144), (1, 100, 150),
              (1, 126, 180), (1, 128, 192), (1, 160, 240), (1, 200, 300),
              (1, 252, 360), (2, 126, 180), (8, 20, 45), (8, 40, 90)),
}


def conv_sweep(dev) -> int:
    """3x3 fp32 convolutions (TF32 off): cuDNN's heuristic against the
    port's Conv and PyTorch's im2col + GEMM convolution."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from raft_stereo_tpu_torch.nn.layers import Conv, cudnn_takes_fft

    def kernels(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    def ms(fn, reps):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    g = torch.Generator(device=dev).manual_seed(0)
    for cin, cout in SWEEP["channels"]:
        conv = Conv(cin, cout, 3, 1, 1).to(dev)
        for b, h, w in SWEEP["sizes"]:
            x = torch.randn((b, h, w, cin), generator=g, device=dev)
            xc = x.permute(0, 3, 1, 2)
            with torch.no_grad():
                def heuristic():
                    return F.conv2d(xc, conv.weight, conv.bias, 1, 1)

                def im2col():
                    return torch.ops.aten.thnn_conv2d(
                        xc, conv.weight, (3, 3), conv.bias, (1, 1), (1, 1))
                names = kernels(heuristic)
                reps = 1 if len(names) > 1000 else 5
                row = dict(input_nhwc=[b, h, w, cin], out_channels=cout,
                           cudnn_kernels=len(names),
                           cudnn_fft_kernels=sum("fft" in n.lower()
                                                 for n in names),
                           cudnn_ms=ms(heuristic, reps),
                           port_route=("im2col" if cudnn_takes_fft(conv, xc)
                                       else "cudnn"),
                           port_ms=ms(lambda: conv(x), 5),
                           im2col_ms=ms(im2col, 5))
            print(json.dumps(row), flush=True)
            del x, xc
    # what does not move cuDNN off the FFT at gru32's hires shape: other
    # layouts, a padded width, its deterministic mode (each a shape or key
    # of its own, so no plan is reused)
    conv = Conv(256, 128, 3, 1, 1).to(dev)
    x = torch.randn((1, 126, 180, 256), generator=g, device=dev)
    w, b = conv.weight, conv.bias
    variants = {
        "nchw_contiguous": lambda: F.conv2d(
            x.permute(0, 3, 1, 2).contiguous(), w, b, 1, 1),
        "channels_last_weight": lambda: F.conv2d(
            x.permute(0, 3, 1, 2),
            w.contiguous(memory_format=torch.channels_last), b, 1, 1),
        "width_padded_to_8": lambda: F.conv2d(
            F.pad(x.permute(0, 3, 1, 2), (1, 3, 1, 1)), w, b)[..., :180],
        "width_padded_to_32": lambda: F.conv2d(
            F.pad(x.permute(0, 3, 1, 2), (1, 11, 1, 1)), w, b)[..., :180],
    }

    def deterministic():
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            return F.conv2d(x.permute(0, 3, 1, 2), w, b, 1, 1)
    variants["deterministic"] = deterministic
    with torch.no_grad():
        for name, fn in variants.items():
            names = kernels(fn)
            print(json.dumps(dict(input_nhwc=[1, 126, 180, 256],
                                  out_channels=128, variant=name,
                                  cudnn_kernels=len(names),
                                  cudnn_fft_kernels=sum(
                                      "fft" in n.lower() for n in names))),
                  flush=True)
    return 0


def profile_train(args, dev) -> int:
    """The training step at chip_smoke.py's train shape."""
    import dataclasses
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import SEED, seeded_weights, train_batch
    from raft_stereo_tpu_torch.config import sceneflow_config
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.training.loss import sequence_loss
    from raft_stereo_tpu_torch.training.optim import fetch_optimizer
    from raft_stereo_tpu_torch.training.state import (TrainState,
                                                      make_train_step)
    mcfg, tcfg = sceneflow_config()
    impl = args.corr_implementation or "reg_cuda"
    mcfg = dataclasses.replace(mcfg, corr_implementation=impl,
                               fused_lookup=args.fused_lookup or None)
    model = RAFTStereo(mcfg)
    seeded_weights(model, SEED)
    model.to(dev)
    opt = fetch_optimizer(tcfg, model.parameters())
    state = TrainState(model, opt)
    step = make_train_step(model, opt, tcfg.train_iters)
    b, (h, w) = tcfg.batch_size, tcfg.image_size
    batch = train_batch(b, h, w, SEED + 3, dev)
    state, _ = step(state, batch)  # warm-up
    secs = []
    for _ in range(args.frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    wall_ms = sum(secs) / len(secs) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.frames):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    # device memory of one forward and backward: what the forward keeps
    # for the backward, and the peaks of each pass
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    preds = model(batch["image1"], batch["image2"], iters=tcfg.train_iters,
                  test_mode=False)
    loss, _ = sequence_loss(preds, batch["flow"], batch["valid"])
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated(dev) - resident
    memory = {"resident_bytes": resident, "forward_kept_bytes": kept,
              "forward_peak_bytes": torch.cuda.max_memory_allocated(dev)}
    loss.backward()
    torch.cuda.synchronize()
    memory["step_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    model.zero_grad(set_to_none=True)
    del preds, loss
    # the encoders' share of what the forward keeps (their outputs too)
    image1 = 2.0 * (batch["image1"] / 255.0) - 1.0
    image2 = 2.0 * (batch["image2"] / 255.0) - 1.0
    before = torch.cuda.memory_allocated(dev)
    encoded = (model.cnet(image1), model.fnet(torch.cat([image1, image2])))
    torch.cuda.synchronize()
    memory["encoders_kept_bytes"] = torch.cuda.memory_allocated(dev) - before
    del encoded
    out = summarize(prof, args.frames, split=True)
    if out is None:
        print("profile_torch_main_path: the profiler recorded no device "
              "kernels", file=sys.stderr)
        return 1
    print(json.dumps({
        "config": f"train: sceneflow_config() + {impl}"
                  + (" + fused_lookup" if args.fused_lookup else ""),
        "batch": b,
        "unrepaired_pool": args.unrepaired_pool,
        "image_size": [h, w], "iters": tcfg.train_iters,
        "steps": args.frames, "wall_ms": wall_ms,
        "wall_ms_runs": [x * 1e3 for x in secs],
        "idle_share": 1 - out["device_busy_ms"] / wall_ms, **out,
        "memory": memory,
    }), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=3,
                    help="frames (training steps with --train) profiled")
    ap.add_argument("--train", action="store_true",
                    help="profile the training step instead of inference")
    ap.add_argument("--unrepaired_pool", action="store_true",
                    help="with --train: the pool without its channels-first "
                         "copy (wrong gradients; for timing only)")
    ap.add_argument("--corr_implementation", default=None,
                    help="profile the default architecture alone with this "
                         "correlation implementation")
    ap.add_argument("--fused_lookup", action="store_true",
                    help="run the fused lookup+convc1 kernel "
                         "(fused_lookup=True) in every configuration")
    ap.add_argument("--iters", type=int, default=None,
                    help="refinement iterations instead of the preset's "
                         "(1 profiles the encoders and one iteration)")
    ap.add_argument("--cudnn_benchmark", action="store_true",
                    help="let cuDNN time its algorithms per shape "
                         "(torch.backends.cudnn.benchmark) instead of its "
                         "heuristic choice")
    ap.add_argument("--warmup", type=int, default=2,
                    help="unprofiled warm-up frames before the timed ones")
    ap.add_argument("--conv_kernels", action="store_true",
                    help="list each convolution's kernels by input shape "
                         "(records shapes)")
    ap.add_argument("--conv_sweep", action="store_true",
                    help="time 3x3 fp32 convolutions of the update block's "
                         "channel counts: cuDNN's heuristic, the port's "
                         "Conv, im2col + GEMM (no model)")
    ap.add_argument("--default_tf32", action="store_true",
                    help="leave PyTorch's TF32 defaults (cuDNN convolutions "
                         "in TF32) instead of turning TF32 off")
    ap.add_argument("--size", default="375x1242",
                    help="input pair HxW for inference (padded to /32)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_main_path: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import seeded_weights, stereo_pair
    from raft_stereo_tpu_torch.config import RAFTStereoConfig, realtime_config
    from raft_stereo_tpu_torch.inference import StereoPredictor
    from raft_stereo_tpu_torch.models import RAFTStereo

    if not args.default_tf32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    dev = torch.device("cuda", 0)
    if args.conv_sweep:
        torch.backends.cudnn.allow_tf32 = False
        return conv_sweep(dev)
    if args.train:
        if args.unrepaired_pool:
            from card_vs_cpu_grads import unrepaired_avg_pool2d
            from raft_stereo_tpu_torch.ops import geometry
            geometry.avg_pool2d = unrepaired_avg_pool2d
        return profile_train(args, dev)
    h, w = (int(v) for v in args.size.split("x"))
    left, right = stereo_pair(h, w, 1234)
    padded = [-(-h // 32) * 32, -(-w // 32) * 32]
    import dataclasses
    runs = [("default", RAFTStereoConfig(corr_implementation="reg_cuda"), 32),
            ("realtime", realtime_config(), 7)]
    if args.corr_implementation:
        runs = [(f"default+{args.corr_implementation}", RAFTStereoConfig(
            corr_implementation=args.corr_implementation), 32)]
    if args.fused_lookup:
        runs = [(f"{name}+fused_lookup",
                 dataclasses.replace(cfg, fused_lookup=True), iters)
                for name, cfg, iters in runs]
    for name, cfg, iters in runs:
        iters = args.iters or iters
        state = seeded_weights(RAFTStereo(cfg), 1234)
        pred = StereoPredictor(cfg, state, valid_iters=iters, device=dev)
        for _ in range(args.warmup):
            pred(left, right)
        # wall clock without the profiler, whose host-side tracing slows
        # the launches it records
        wall = sum(pred.predict_timed(left, right)[1]
                   for _ in range(args.frames)) / args.frames
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=args.conv_kernels) as prof:
            for _ in range(args.frames):
                pred.predict_timed(left, right)
        out = summarize(prof, args.frames, split=False)
        if args.conv_kernels and out is not None:
            out["conv_kernels"] = conv_kernels(prof, args.frames)
            out["fft_kernels_per_frame"] = sum(
                "fft" in e.name.lower() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
            ) / args.frames
        if out is None:
            print("profile_torch_main_path: the profiler recorded no "
                  "device kernels", file=sys.stderr)
            return 1
        wall_ms = wall * 1e3
        print(json.dumps({
            "config": name, "iters": iters, "padded": padded,
            "cudnn_benchmark": args.cudnn_benchmark,
            "tf32": bool(torch.backends.cudnn.allow_tf32),
            "frames": args.frames, "wall_ms": wall_ms,
            "device_busy_ms": out["device_busy_ms"],
            "memcpy_ms": out["memcpy_ms"],
            "idle_share": 1 - out["device_busy_ms"] / wall_ms,
            "kernels_per_frame": out["kernels_per_unit"],
            "category_ms": out["category_ms"], "top": out["top"],
            "top_ops": out["top_ops"], "top_host_ops": out["top_host_ops"],
            **({k: out[k] for k in ("conv_kernels", "fft_kernels_per_frame")
                if k in out}),
        }), flush=True)
        del pred
    return 0


if __name__ == "__main__":
    sys.exit(main())
