#!/usr/bin/env python3
"""Where the PyTorch port's main path spends its time on one NVIDIA GPU.

    python3 scripts/profile_torch_main_path.py [--frames 3]

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
* device time per kernel category (convolution, matmul, the
  windowed_sample lookup, the rest) and the top kernels by device time.

TF32 is off, as in chip_smoke.py. Exits non-zero without a CUDA device or
when the profiler records no device kernels.
"""

import argparse
import collections
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def category(name: str) -> str:
    n = name.lower()
    if "windowed_sample" in n:
        return "windowed_sample"
    if any(k in n for k in ("conv", "cudnn", "winograd", "implicit",
                            "xmma", "fprop", "dgrad", "nchw", "nhwc")):
        return "convolution"
    if any(k in n for k in ("gemm", "cutlass", "cublas", "matmul")):
        return "matmul"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=3)
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

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    left, right = stereo_pair(375, 1242, 1234)
    for name, cfg, iters in [
            ("default", RAFTStereoConfig(corr_implementation="reg_cuda"), 32),
            ("realtime", realtime_config(), 7)]:
        state = seeded_weights(RAFTStereo(cfg), 1234)
        pred = StereoPredictor(cfg, state, valid_iters=iters, device=dev)
        for _ in range(2):
            pred(left, right)
        # wall clock without the profiler, whose host-side tracing slows
        # the launches it records
        wall = sum(pred.predict_timed(left, right)[1]
                   for _ in range(args.frames)) / args.frames
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.frames):
                pred.predict_timed(left, right)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            print("profile_torch_main_path: the profiler recorded no "
                  "device kernels", file=sys.stderr)
            return 1
        by_cat = collections.Counter()
        by_name = collections.Counter()
        count = collections.Counter()
        for e in kernels:
            us = e.time_range.elapsed_us()
            by_cat[category(e.name)] += us
            by_name[e.name] += us
            count[e.name] += 1
        busy_ms = sum(by_cat.values()) / 1e3 / args.frames
        wall_ms = wall * 1e3
        print(json.dumps({
            "config": name, "iters": iters, "padded": [384, 1248],
            "frames": args.frames, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "kernels_per_frame": len(kernels) / args.frames,
            "category_ms": {k: v / 1e3 / args.frames
                            for k, v in by_cat.most_common()},
            "top": [{"name": n[:90], "ms": v / 1e3 / args.frames,
                     "calls": count[n] // args.frames}
                    for n, v in by_name.most_common(12)],
        }), flush=True)
        del pred
    return 0


if __name__ == "__main__":
    sys.exit(main())
