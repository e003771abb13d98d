#!/usr/bin/env python3
"""Why the card's fp32 training gradients differ from the CPU's: the ops
of the GRUs' links by layout, the convolutions layer by layer, the whole
step, and the layout of the convolutions' outputs.

    python3 scripts/card_vs_cpu_grads.py [--unrepaired_pool]

The default architecture with corr_implementation="reg_cuda" and seeded
weights as in chip_smoke.py, at chip_smoke.py's train_cpu_parity shape (one
fp32 step at 64x160, 2 iterations). TF32 is off. One JSON line each:

1. ``ops``: ``F.avg_pool2d`` with the GRU link's settings (3x3, stride 2,
   pad 1) and ``F.interpolate`` (bilinear, align corners) at the 1/4
   resolution hidden state's shape, forward and input gradient, on the
   CPU and on the card, channels first and channels last, against
   float64; and the port's ``pool2x`` on an NHWC tensor.
2. ``conv_layers``: the first input that each convolution of the step sees
   on the CPU is replayed through that convolution, forward and backward
   (a seeded cotangent), in the model's layout (a channels-last view):
   in float64 on the CPU (the reference), in fp32 on the CPU, and in fp32
   on the card under each mode: ``cudnn_off`` (PyTorch's own CUDA
   convolution), ``cudnn`` (cuDNN's heuristics, the default),
   ``cudnn_deterministic`` and ``cudnn_benchmark``. For the output, the
   input's gradient and the weight's gradient: the relative L2 error
   against float64, worst layer and median over layers.
3. ``step``: the whole step's gradients on the card in each mode against
   the CPU's (relative L2 over all gradients together, and the worst
   leaf), beside CPU null runs whose weights are scaled by
   ``1 + p N(0, 1)``, for several ``p``.
4. ``layout``: the same deviation with every convolution's output stored
   channels last (as cuDNN stores it) or channels first (as PyTorch's own
   CUDA convolution does), with cuDNN on and off, and the leaves that
   move most.

``--unrepaired_pool`` runs phases 3 and 4 with the GRU links' pool
handing PyTorch's CUDA ``avg_pool2d`` the channels-last view, as the port
did before ``ops/geometry.avg_pool2d`` copied it to channels first.

Exits non-zero without a CUDA device.
"""

import argparse
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {
    "cudnn_off": dict(enabled=False, deterministic=False, benchmark=False),
    "cudnn": dict(enabled=True, deterministic=False, benchmark=False),
    "cudnn_deterministic": dict(enabled=True, deterministic=True,
                                benchmark=False),
    "cudnn_benchmark": dict(enabled=True, deterministic=False,
                            benchmark=True),
}
NULL_PERTURBATIONS = (1e-6, 1e-5, 1e-4)
NULL_SEEDS = (0, 1)
SHAPE, ITERS = (64, 160), 2


def set_mode(torch, mode):
    for key, value in MODES[mode].items():
        setattr(torch.backends.cudnn, key, value)


def conv_inputs(model, batch):
    """The first (NHWC) input of every ``Conv`` of the step's forward."""
    import torch
    from raft_stereo_tpu_torch.nn.layers import Conv
    seen, hooks = {}, []
    for name, mod in model.named_modules():
        if isinstance(mod, Conv):
            def hook(m, args, _out, name=name):
                if name not in seen:
                    seen[name] = (m, args[0].detach().float().clone())
            hooks.append(mod.register_forward_hook(hook))
    with torch.no_grad():
        model(batch["image1"], batch["image2"], iters=ITERS, test_mode=False)
    for h in hooks:
        h.remove()
    return seen


def link_ops(dev):
    """Relative L2 error against float64 of the forward and the input
    gradient of the GRU links' pool and resize, by device and layout."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import rel_l2
    from raft_stereo_tpu_torch.ops.geometry import pool2x
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 128, 16, 40), generator=g, dtype=torch.float64)
    ops = {
        "avg_pool2d": lambda t: F.avg_pool2d(t, 3, 2, 1,
                                             count_include_pad=True),
        "interpolate": lambda t: F.interpolate(
            t, size=(32, 80), mode="bilinear", align_corners=True),
        "pool2x_nhwc": lambda t: pool2x(t.permute(0, 2, 3, 1)).permute(
            0, 3, 1, 2),
    }
    out = {}
    for name, fn in ops.items():
        ct = torch.randn(fn(x).shape, generator=g, dtype=torch.float64)
        y_ref, dx_ref = fwd_bwd(fn, x, ct)
        out[name] = row = {}
        for where in ("cpu", dev):
            for layout, fmt in (("channels_first", torch.contiguous_format),
                                ("channels_last", torch.channels_last)):
                y, dx = fwd_bwd(fn, x.float().to(where).contiguous(
                    memory_format=fmt), ct.float().to(where).contiguous(
                    memory_format=fmt))
                row[f"{torch.device(where).type}/{layout}"] = dict(
                    y=rel_l2(y.cpu().double(), y_ref),
                    dx=rel_l2(dx.cpu().double(), dx_ref))
    return out


def fwd_bwd(fn, x, ct):
    import torch
    x = x.detach().requires_grad_()
    y = fn(x)
    (dx,) = torch.autograd.grad(y, x, ct)
    return y.detach(), dx


def conv_fwd_bwd(x, w, b, ct, stride, padding):
    import torch
    import torch.nn.functional as F
    x = x.detach().requires_grad_()
    w = w.detach().requires_grad_()
    y = F.conv2d(x, w, b, stride, padding)
    dx, dw = torch.autograd.grad(y, (x, w), ct)
    return y.detach(), dx, dw


def unrepaired_avg_pool2d(x, window, stride, padding=(0, 0)):
    """``ops/geometry.avg_pool2d`` without its channels-first copy."""
    import torch.nn.functional as F
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride, padding,
                     ceil_mode=False, count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--unrepaired_pool", action="store_true",
                    help="phases 3-4 with the channels-last CUDA pool")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("card_vs_cpu_grads: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import (SEED, perturbed_copy, rel_l2, seeded_weights,
                            train_batch)
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.nn.layers import Conv
    from raft_stereo_tpu_torch.training.state import loss_and_grads

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = RAFTStereoConfig(corr_implementation="reg_cuda")
    on_cpu = RAFTStereo(cfg)
    state = seeded_weights(on_cpu, SEED)
    batch = train_batch(1, *SHAPE, SEED + 4, "cpu", max_disp=16.0)

    # 1. the GRU links' pool and resize on their own
    print(json.dumps({"phase": "ops", **link_ops(dev)}), flush=True)

    # 2. layer by layer
    errs = {m: {"y": {}, "dx": {}, "dw": {}}
            for m in ("cpu_fp32",) + tuple(MODES)}
    gen = torch.Generator().manual_seed(SEED)
    for name, (mod, x_nhwc) in conv_inputs(on_cpu, batch).items():
        w, b = mod.weight.detach(), mod.bias.detach()
        conv_args = (mod.stride, mod.padding)
        x = x_nhwc.permute(0, 3, 1, 2)  # the model's channels-last view
        y = torch.nn.functional.conv2d(x, w, b, *conv_args)
        ct = torch.randn(y.shape, generator=gen).contiguous(
            memory_format=torch.channels_last)
        ref = conv_fwd_bwd(x.double(), w.double(), b.double(), ct.double(),
                           *conv_args)
        got = {"cpu_fp32": conv_fwd_bwd(x, w, b, ct, *conv_args)}
        for mode in MODES:
            set_mode(torch, mode)
            got[mode] = [t.cpu() for t in conv_fwd_bwd(
                x.to(dev), w.to(dev), b.to(dev), ct.to(dev), *conv_args)]
        for mode, outs in got.items():
            for key, g, r in zip(("y", "dx", "dw"), outs, ref):
                errs[mode][key][name] = rel_l2(g.double(), r)
    summary = {}
    for mode, by_key in errs.items():
        summary[mode] = row = {}
        for key, by_layer in by_key.items():
            worst = max(by_layer, key=by_layer.get)
            row[key] = dict(
                max=by_layer[worst], worst_layer=worst,
                median=statistics.median(by_layer.values()))
    conv_flags = getattr(torch.backends.cudnn, "conv", None)
    print(json.dumps({
        "phase": "conv_layers", "torch": torch.__version__,
        "cudnn_version": torch.backends.cudnn.version(),
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "cudnn_conv_fp32_precision": getattr(conv_flags, "fp32_precision",
                                             None),
        "layers": len(errs["cudnn"]["y"]),
        "rel_l2_vs_float64": summary}), flush=True)

    if args.unrepaired_pool:
        from raft_stereo_tpu_torch.ops import geometry
        geometry.avg_pool2d = unrepaired_avg_pool2d

    # 3. the whole step, card against CPU, beside CPU null runs
    names = [n for n, _ in on_cpu.named_parameters()]
    _, _, want = loss_and_grads(on_cpu, batch, ITERS)

    def deviation(grads):
        devs = {n: rel_l2(g, w) for n, g, w in zip(names, grads, want)}
        worst = max(devs, key=devs.get)
        flat = [torch.cat([g.flatten() for g in gs]) for gs in (grads, want)]
        return dict(rel_l2_all=rel_l2(*flat), worst_leaf=worst,
                    worst_leaf_rel_l2=devs[worst])
    out = {"cpu_null": {}}
    for p in NULL_PERTURBATIONS:
        out["cpu_null"][str(p)] = [deviation(loss_and_grads(
            perturbed_copy(on_cpu, p, SEED + s), batch, ITERS)[2])
            for s in NULL_SEEDS]
    on_gpu = RAFTStereo(cfg)
    on_gpu.load_state_dict(state, strict=True)
    on_gpu.to(dev)
    for mode in MODES:
        set_mode(torch, mode)
        out[mode] = [deviation([g.cpu() for g in loss_and_grads(
            on_gpu, batch, ITERS)[2]]) for _ in range(2)]
    print(json.dumps({"phase": "step", "shape": list(SHAPE), "iters": ITERS,
                      "unrepaired_pool": args.unrepaired_pool, **out}),
          flush=True)

    # 4. the layout of the convolutions' outputs
    def relaid(out, layout):
        nchw = out.permute(0, 3, 1, 2)
        fmt = (torch.channels_last if layout == "channels_last"
               else torch.contiguous_format)
        return nchw.contiguous(memory_format=fmt).permute(0, 2, 3, 1)

    def run(mode, layout):
        set_mode(torch, mode)
        hooks = [mod.register_forward_hook(
            lambda m, a, y: relaid(y, layout)) for mod in on_gpu.modules()
            if isinstance(mod, Conv)]
        grads = [g.cpu() for g in loss_and_grads(on_gpu, batch, ITERS)[2]]
        for h in hooks:
            h.remove()
        devs = {n: rel_l2(g, w) for n, g, w in zip(names, grads, want)}
        gnorm = float(torch.cat([w.flatten() for w in want]).norm())
        top = sorted(devs, key=lambda n: devs[n] * float(
            want[names.index(n)].norm()), reverse=True)[:5]
        return dict(rel_l2_all=deviation(grads)["rel_l2_all"],
                    top_leaves={n: [devs[n], float(
                        want[names.index(n)].norm()) / gnorm] for n in top})
    print(json.dumps({"phase": "layout",
                      "unrepaired_pool": args.unrepaired_pool, **{
        f"{mode}/{layout}": run(mode, layout)
        for mode in ("cudnn", "cudnn_off")
        for layout in ("channels_last", "channels_first")}}),
        flush=True)
    set_mode(torch, "cudnn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
