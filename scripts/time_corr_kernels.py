#!/usr/bin/env python3
"""Time the port's windowed_sample, fused_corr, alt_corr and fused_lookup
kernels of one checkout on one NVIDIA GPU, on inputs that any checkout
makes alike.

    python3 scripts/time_corr_kernels.py [--root DIR] [--label NAME]
        [--kernels ws_fwd,ws_bwd,lookup_fwd,lookup_bwd]

``--root`` is the checkout whose ``raft_stereo_tpu_torch`` is imported (its
kernels built from its own ``csrc/``; default: this one). Run it once per
checkout, each in its own process, in one call to the card, in turns
(parent, change, change, parent): the inputs come from seeded generators
on the card, so every run times the same data, and only the kernels differ.

Per center field it times, with chip_smoke.py's ``cuda_ms`` (L2 flushed
before each launch, median of ``--reps``):

* ``fused_fwd``: the hires pyramid (fp32 ``fmap1 (1, 504, 720, 256)``, fmap2
  levels of width 720, 360, 180, 90) and the train pyramid (bf16, ``(8, 80,
  180, 256)``, widths 180, 90, 45, 22): each level's forward on its own
  (``fused_corr_forward``, level i around ``center / 2**i``), their sum,
  and, where the checkout has ``fused_corr_pyramid_forward``, the one
  launch for the four levels;
* ``alt_fwd``: alt_corr's forward the same way at the train pyramid and at
  the alt_pallas frame's (fp32 ``(1, 96, 312, 256)``, widths 312, 156, 78,
  39), with the one launch where the checkout has
  ``alt_corr_pyramid_forward`` (a checkout without it launches once a
  level: ``sum_ms`` is what its lookup costs);
* ``fused_bwd`` and ``alt_bwd``: each backward (df1 and df2) at the train
  levels;
* ``ws_fwd`` and ``ws_bwd``: windowed_sample's forward and backward (dvol
  only, as training runs it) at chip_smoke.py's ``LOOKUP_C1`` pyramids
  (default fp32, realtime bf16, train bf16): each level on its own (the
  one-level launch, level i around ``center / 2**i``; the backward's
  cotangent a slice of the four levels' one), their sum, and, where the
  checkout has ``windowed_sample_pyramid_forward`` /
  ``windowed_sample_pyramid_backward``, the one launch for the four levels;
  beside the backward, ``memset_ms``: a memset of the four dvols' bytes
  (what writing them alone costs on this timer);
* ``lookup_fwd`` and ``lookup_bwd``: fused_lookup's forward and backward,
  one launch for the four levels, at chip_smoke.py's three ``LOOKUP_C1``
  pyramids (default fp32, realtime bf16, train bf16), on the ``random`` and
  ``smooth`` fields (``ms``).

``--kernels`` picks which of these run (default: all).

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
KITTI = ((1, 96, 312, 256), (312, 156, 78, 39), "float32")


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
    ap.add_argument("--kernels", default="ws_fwd,ws_bwd,fused_fwd,alt_fwd,"
                    "fused_bwd,alt_bwd,lookup_fwd,lookup_bwd")
    args = ap.parse_args()
    wanted = set(args.kernels.split(","))

    import torch
    if not torch.cuda.is_available():
        print("time_corr_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from raft_stereo_tpu_torch.ops.kernels import _build
    from raft_stereo_tpu_torch.ops.kernels import alt_corr as ac
    from raft_stereo_tpu_torch.ops.kernels import fused_corr as fc
    from raft_stereo_tpu_torch.ops.kernels import fused_lookup as fl
    from raft_stereo_tpu_torch.ops.kernels import windowed_sample as ws
    assert os.path.dirname(fc.__file__).startswith(
        os.path.abspath(args.root)), fc.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    ws_kernels, lookup_kernels = {"ws_fwd", "ws_bwd"}, {"lookup_fwd",
                                                        "lookup_bwd"}
    _build.build_all(
        ([fc.KERNEL_NAME, ac.KERNEL_NAME]
         if wanted - ws_kernels - lookup_kernels else [])
        + ([ws.KERNEL_NAME] if wanted & ws_kernels else [])
        + ([fl.KERNEL_NAME] if wanted & lookup_kernels else []))
    print(json.dumps({"label": args.label, "root": args.root,
                      "nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    pyramids = {"fused_fwd": getattr(fc, "fused_corr_pyramid_forward", None),
                "alt_fwd": getattr(ac, "alt_corr_pyramid_forward", None)}
    one_level = {"fused_fwd": fc.fused_corr_forward,
                 "alt_fwd": ac.alt_corr_forward}
    backward = {"fused_bwd": fc.fused_corr_backward,
                "alt_bwd": ac.alt_corr_backward}
    kernels = {"hires": ("fused_fwd",),
               "train": ("fused_fwd", "alt_fwd", "fused_bwd", "alt_bwd"),
               "kitti": ("alt_fwd",)}

    def emit(**row):
        print(json.dumps({"label": args.label, **row}), flush=True)

    def ms(fn):
        return chip_smoke.cuda_ms(fn, flush, args.reps)

    for cfg_name, ((b, h, w1, d), widths, dname) in (
            ("hires", HIRES), ("train", TRAIN), ("kitti", KITTI)):
        if not wanted & set(kernels[cfg_name]):
            continue
        dt = getattr(torch, dname)
        g = torch.Generator(device=dev).manual_seed(7)
        f1 = torch.randn((b, h, w1, d), generator=g, device=dev).to(dt)
        levels = [torch.randn((b, h, w, d), generator=g, device=dev).to(dt)
                  for w in widths]
        gt = torch.Generator(device=dev).manual_seed(13)
        ct = torch.randn((b, h, w1, 2 * RADIUS + 1), generator=gt,
                         device=dev)
        for field in args.fields.split(","):
            gc = torch.Generator(device=dev).manual_seed(11)
            c0 = centers(field, b, h, w1, widths[0], gc, dev)
            cs = [(c0 / (2 ** i)).contiguous() for i in range(len(levels))]
            for kernel in kernels[cfg_name]:
                if kernel not in wanted:
                    continue
                if kernel in backward:
                    per = [ms(lambda f2=f2, c=c, fn=backward[kernel]: fn(
                        f1, f2, c, ct, RADIUS)) for f2, c in zip(levels, cs)]
                else:
                    per = [ms(lambda f2=f2, c=c, fn=one_level[kernel]: fn(
                        f1, f2, c, RADIUS)) for f2, c in zip(levels, cs)]
                row = dict(kernel=kernel, config=cfg_name, field=field,
                           dtype=dname, per_level_ms=per, sum_ms=sum(per))
                if pyramids.get(kernel) is not None:
                    row["one_launch_ms"] = ms(
                        lambda fn=pyramids[kernel]: fn(f1, levels, c0,
                                                       RADIUS))
                emit(**row)
        del f1, levels, ct

    fields = [f for f in args.fields.split(",") if f in ("random", "smooth")]
    # windowed_sample: each level on its own and, where the checkout has
    # it, the one launch for the four levels
    k = 2 * RADIUS + 1
    ws_pyramid = {"ws_fwd": getattr(ws, "windowed_sample_pyramid_forward",
                                    None),
                  "ws_bwd": getattr(ws, "windowed_sample_pyramid_backward",
                                    None)}
    for cfg_name, (vname, _, (b, h, w1, w2)) in chip_smoke.LOOKUP_C1.items():
        if not wanted & ws_kernels:
            break
        dt = getattr(torch, vname)
        g = torch.Generator(device=dev).manual_seed(17)
        levels = [torch.randn((b, h, w1, w2 >> i), generator=g,
                              device=dev).to(dt) for i in range(4)]
        gt = torch.Generator(device=dev).manual_seed(19)
        ct = torch.randn((b, h, w1, 4 * k), generator=gt, device=dev)
        for field in fields:
            gc = torch.Generator(device=dev).manual_seed(11)
            c0 = centers(field, b, h, w1, w2, gc, dev)
            cs = [(c0 / (2 ** i)).contiguous() for i in range(4)]
            for kernel in ("ws_fwd", "ws_bwd"):
                if kernel not in wanted:
                    continue
                if kernel == "ws_fwd":
                    per = [ms(lambda v=v, c=c: ws.windowed_sample_forward(
                        v, c, RADIUS)) for v, c in zip(levels, cs)]
                    one = lambda fn=ws_pyramid[kernel]: fn(  # noqa: E731
                        levels, c0, RADIUS)
                else:
                    per = [ms(lambda v=v, c=c, i=i:
                              ws.windowed_sample_backward(
                                  v, c, ct[..., i * k:(i + 1) * k], RADIUS,
                                  need_dcoords=False))
                           for i, (v, c) in enumerate(zip(levels, cs))]
                    one = lambda fn=ws_pyramid[kernel]: fn(  # noqa: E731
                        levels, c0, ct, RADIUS, need_dcoords=False)
                row = dict(kernel=kernel, config=cfg_name, field=field,
                           dtype=vname, per_level_ms=per, sum_ms=sum(per))
                if ws_pyramid[kernel] is not None:
                    row["one_launch_ms"] = ms(one)
                if kernel == "ws_bwd":  # the dvols' bytes zeroed: writes alone
                    zeros = torch.empty(sum(v.numel() * v.element_size()
                                            for v in levels),
                                        dtype=torch.uint8, device=dev)
                    row["memset_ms"] = ms(zeros.zero_)
                    del zeros
                emit(**row)
        del levels, ct

    # fused_lookup: one launch for the four levels, forward and backward
    for cfg_name, (vname, dname, shape) in chip_smoke.LOOKUP_C1.items():
        if not wanted & lookup_kernels:
            break
        dt = getattr(torch, dname)
        levels, coords, kern, bias = chip_smoke.lookup_c1_inputs(
            shape, getattr(torch, vname), 17, dev, edges=False)
        gt = torch.Generator(device=dev).manual_seed(19)
        ct = torch.randn(shape[:3] + (64,), generator=gt, device=dev).to(dt)
        for field in fields:
            gc = torch.Generator(device=dev).manual_seed(11)
            c0 = centers(field, *shape, gc, dev)
            for kernel in ("lookup_fwd", "lookup_bwd"):
                if kernel not in wanted:
                    continue
                if kernel == "lookup_fwd":
                    fn = lambda: fl.fused_lookup_forward(  # noqa: E731
                        levels, c0, kern, bias, RADIUS, dt)
                else:
                    fn = lambda: fl.fused_lookup_backward(  # noqa: E731
                        levels, c0, kern, bias, ct, RADIUS, dt)
                emit(kernel=kernel, config=cfg_name, field=field,
                     volume_dtype=vname, dtype=dname, shape=list(shape),
                     ms=ms(fn))
        del levels, coords, ct
    return 0


if __name__ == "__main__":
    sys.exit(main())
