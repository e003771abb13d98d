#!/usr/bin/env python3
"""Time the port's fused_corr forward and alt_corr backward kernels of one
checkout on one NVIDIA GPU, on inputs that any checkout makes alike.

    python3 scripts/time_corr_kernels.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``raft_stereo_tpu_torch`` is imported (its
kernels built from its own ``csrc/``; default: this one). Run it once per
checkout, each in its own process, in one call to the card, in turns
(parent, change, change, parent): the inputs come from seeded generators
on the card, so every run times the same data, and only the kernels differ.

Per center field it times, with chip_smoke.py's ``cuda_ms`` (L2 flushed
before each launch, median of ``--reps``):

* ``fused_fwd``: the hires pyramid (fp32 ``fmap1 (1, 504, 720, 256)``, fmap2
  levels of width 720, 360, 180, 90) and the train_fused pyramid (bf16,
  ``(8, 80, 180, 256)``, widths 180, 90, 45, 22): each level's forward on
  its own (``fused_corr_forward``, level i around ``center / 2**i``), their
  sum, and, where the checkout has ``fused_corr_pyramid_forward``, the one
  launch for the four levels;
* ``alt_bwd``: alt_corr's backward (df1 and df2) at the train levels;
* ``alt_fwd``: alt_corr's forward at the train levels.

Center fields, each a disparity in [0, W2/4] subtracted from the pixel's
own x: ``random`` (an independent disparity per pixel, chip_smoke.py's),
``smooth`` (a low-frequency field, as a model's disparities are) and
``shared`` (one center per row: every pixel of a row looks up one window,
the least fmap2 traffic a row can have). One JSON line per timing; the
card's name and power limit first.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (its timer and centers; imports nothing yet)
RADIUS = 4
HIRES = ((1, 504, 720, 256), (720, 360, 180, 90), "float32")
TRAIN = ((8, 80, 180, 256), (180, 90, 45, 22), "bfloat16")


def centers(field, b, h, w1, w2, g, device):
    """Level-0 centers (B, H, W1) into rows of width w2: chip_smoke.py's
    fields, and ``shared``."""
    import torch
    if field == "random":
        return chip_smoke.window_centers(b, h, w1, w2, g, device, edges=False)
    if field == "smooth":
        return chip_smoke.smooth_centers(b, h, w1, w2, g, device)
    if field == "shared":
        row = torch.rand((b, h, 1), generator=g, device=device) * w2
        return row.expand(b, h, w1).contiguous()
    raise ValueError(field)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default="change")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--fields", default="random,smooth,shared")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("time_corr_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from raft_stereo_tpu_torch.ops.kernels import _build
    from raft_stereo_tpu_torch.ops.kernels import alt_corr as ac
    from raft_stereo_tpu_torch.ops.kernels import fused_corr as fc
    assert os.path.dirname(fc.__file__).startswith(
        os.path.abspath(args.root)), fc.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    _build.build_all([fc.KERNEL_NAME, ac.KERNEL_NAME])
    print(json.dumps({"label": args.label, "root": args.root,
                      "nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    pyramid = getattr(fc, "fused_corr_pyramid_forward", None)

    def emit(**row):
        print(json.dumps({"label": args.label, **row}), flush=True)

    for cfg_name, ((b, h, w1, d), widths, dname) in (("hires", HIRES),
                                                     ("train", TRAIN)):
        dt = getattr(torch, dname)
        g = torch.Generator(device=dev).manual_seed(7)
        f1 = torch.randn((b, h, w1, d), generator=g, device=dev).to(dt)
        levels = [torch.randn((b, h, w, d), generator=g, device=dev).to(dt)
                  for w in widths]
        for field in args.fields.split(","):
            gc = torch.Generator(device=dev).manual_seed(11)
            c0 = centers(field, b, h, w1, widths[0], gc, dev)
            cs = [(c0 / (2 ** i)).contiguous() for i in range(len(levels))]
            per = [chip_smoke.cuda_ms(lambda f2=f2, c=c: fc.fused_corr_forward(
                f1, f2, c, RADIUS), flush, args.reps)
                for f2, c in zip(levels, cs)]
            row = dict(kernel="fused_fwd", config=cfg_name, field=field,
                       dtype=dname, per_level_ms=per, sum_ms=sum(per))
            if pyramid is not None:
                row["one_launch_ms"] = chip_smoke.cuda_ms(
                    lambda: pyramid(f1, levels, c0, RADIUS), flush, args.reps)
            emit(**row)
            if cfg_name != "train":
                continue
            per = [chip_smoke.cuda_ms(lambda f2=f2, c=c: ac.alt_corr_forward(
                f1, f2, c, RADIUS), flush, args.reps)
                for f2, c in zip(levels, cs)]
            emit(kernel="alt_fwd", config=cfg_name, field=field,
                 dtype=dname, per_level_ms=per, sum_ms=sum(per))
            gt = torch.Generator(device=dev).manual_seed(13)
            ct = torch.randn((b, h, w1, 2 * RADIUS + 1), generator=gt,
                             device=dev)
            per = [chip_smoke.cuda_ms(lambda f2=f2, c=c: ac.alt_corr_backward(
                f1, f2, c, ct, RADIUS), flush, args.reps)
                for f2, c in zip(levels, cs)]
            emit(kernel="alt_bwd", config=cfg_name, field=field,
                 dtype=dname, per_level_ms=per, sum_ms=sum(per))
        del f1, levels
    return 0


if __name__ == "__main__":
    sys.exit(main())
