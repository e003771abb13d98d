"""Command-line flags -> the port's config (the reference's flag names).

The flag surface is the JAX package's (``raft_stereo_tpu/cli.py``
``add_model_args`` and ``build_demo_parser``) plus ``--device``. Flags that
only steer training memory or the JAX package's TPU kernels are accepted so
that the same command lines parse; test-mode inference does not read them.
"""

from __future__ import annotations

import argparse

from raft_stereo_tpu_torch.config import RAFTStereoConfig


def add_model_args(parser: argparse.ArgumentParser) -> None:
    """Architecture choices (the reference's flag group)."""
    g = parser.add_argument_group("architecture")
    g.add_argument("--hidden_dims", nargs="+", type=int,
                   default=[128, 128, 128],
                   help="hidden state and context dimensions")
    g.add_argument("--corr_implementation",
                   choices=["reg", "alt", "reg_cuda", "alt_cuda",
                            "reg_pallas", "alt_pallas", "ring", "fused",
                            "fused_cuda", "memoryless"], default="reg",
                   help="correlation implementation; the port runs 'reg' "
                        "(plain PyTorch lookup) and 'reg_cuda'/'reg_pallas' "
                        "(the windowed_sample CUDA kernel), and refuses the "
                        "names it has not ported yet")
    g.add_argument("--shared_backbone", action="store_true",
                   help="use a single backbone for context and feature nets")
    g.add_argument("--corr_levels", type=int, default=4)
    g.add_argument("--corr_radius", type=int, default=4)
    g.add_argument("--n_downsample", type=int, default=2,
                   help="resolution of the disparity field (1/2^K)")
    g.add_argument("--context_norm",
                   choices=["group", "batch", "instance", "none"],
                   default="batch")
    g.add_argument("--slow_fast_gru", action="store_true",
                   help="iterate the low-res GRUs more frequently")
    g.add_argument("--n_gru_layers", type=int, default=3)
    g.add_argument("--mixed_precision", action="store_true",
                   help="bf16 compute dtype")
    g.add_argument("--corr_storage_dtype",
                   choices=["float32", "bfloat16"], default=None,
                   help="correlation-volume storage precision; default fp32 "
                        "for reg, the compute dtype for reg_cuda")
    t = parser.add_argument_group(
        "training and TPU-kernel knobs",
        "accepted so JAX-package command lines parse; inference ignores "
        "them")
    t.add_argument("--no_remat", action="store_true")
    t.add_argument("--fused_block_w", type=int, default=256)
    t.add_argument("--fused_lookup", choices=["auto", "on", "off"],
                   default="auto",
                   help="'on' is refused: the fused lookup+convc1 kernel is "
                        "not ported yet (ROADMAP.md B4)")
    t.add_argument("--refinement_save_policy",
                   choices=["auto", "on", "off", "corr"], default="auto")
    t.add_argument("--batched_scan_wgrad", choices=["auto", "on", "off"],
                   default="auto")
    t.add_argument("--residual_dtype", choices=["float32", "bfloat16"],
                   default=None)
    t.add_argument("--no_remat_loss_tail", action="store_true")


def model_config(args: argparse.Namespace) -> RAFTStereoConfig:
    if getattr(args, "fused_lookup", "auto") == "on":
        raise ValueError("--fused_lookup on: the fused lookup+convc1 kernel "
                         "is not ported yet (ROADMAP.md B4)")
    return RAFTStereoConfig(
        hidden_dims=tuple(args.hidden_dims),
        corr_implementation=args.corr_implementation,
        shared_backbone=args.shared_backbone,
        corr_levels=args.corr_levels,
        corr_radius=args.corr_radius,
        n_downsample=args.n_downsample,
        context_norm=args.context_norm,
        slow_fast_gru=args.slow_fast_gru,
        n_gru_layers=args.n_gru_layers,
        mixed_precision=args.mixed_precision,
        corr_storage_dtype=args.corr_storage_dtype,
    )


def build_demo_parser() -> argparse.ArgumentParser:
    """The demo flag surface (reference demo.py) plus ``--device``."""
    parser = argparse.ArgumentParser(description="RAFT-Stereo PyTorch demo")
    parser.add_argument("--restore_ckpt", required=True,
                        help="reference .pth checkpoint")
    parser.add_argument("-l", "--left_imgs", required=True,
                        help="glob for left images")
    parser.add_argument("-r", "--right_imgs", required=True,
                        help="glob for right images")
    parser.add_argument("--output_directory", default="demo_output")
    parser.add_argument("--save_numpy", action="store_true",
                        help="also save raw .npy disparities")
    parser.add_argument("--valid_iters", type=int, default=32)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on ('cuda' or 'cpu')")
    add_model_args(parser)
    return parser
