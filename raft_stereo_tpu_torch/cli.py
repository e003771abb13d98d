"""Command-line flags -> the port's config (the reference's flag names).

The flag surface is the JAX package's (``raft_stereo_tpu/cli.py``
``add_model_args``, ``build_eval_parser`` and ``build_demo_parser``) plus
``--device``. Flags that only steer training memory or the JAX package's
TPU kernels (such as ``--fused_block_w``) are accepted so that the same
command lines parse; test-mode inference does not read them.
``--corr_implementation alt_cuda`` runs the memoryless ``fused_corr``
kernels, ``alt_pallas`` the ``alt_corr`` kernels, and ``--fused_lookup on``
the ``fused_lookup`` kernel.
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
                        "(plain PyTorch lookup), 'alt' (plain PyTorch, the "
                        "volume recomputed per lookup), "
                        "'reg_cuda'/'reg_pallas' (the windowed_sample CUDA "
                        "kernel), 'alt_pallas' (the alt_corr CUDA kernels: "
                        "the correlation slab built on-chip) and "
                        "'alt_cuda'/'fused'/'fused_cuda'/'memoryless' (the "
                        "memoryless fused_corr CUDA kernels, for "
                        "high-resolution pairs), and refuses 'ring', not "
                        "ported yet")
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
                   help="correlation storage precision (the volume or the "
                        "features); default fp32 for reg and alt, the "
                        "compute dtype for the CUDA kernels' implementations")
    t = parser.add_argument_group(
        "training and TPU-kernel knobs",
        "accepted so JAX-package command lines parse; inference ignores "
        "them")
    t.add_argument("--no_remat", action="store_true")
    t.add_argument("--fused_block_w", type=int, default=256,
                   help="the JAX package's W2 tile of its TPU 'fused' "
                        "kernel; the port's CUDA kernels take no tile width "
                        "and ignore it")
    t.add_argument("--fused_lookup", choices=["auto", "on", "off"],
                   default="auto",
                   help="'on' runs the lookup and the motion encoder's "
                        "convc1 as one fused_lookup CUDA kernel (reg and "
                        "reg_cuda, where the pyramid fits); 'auto' is off")
    t.add_argument("--refinement_save_policy",
                   choices=["auto", "on", "off", "corr"], default="auto")
    t.add_argument("--batched_scan_wgrad", choices=["auto", "on", "off"],
                   default="auto")
    t.add_argument("--residual_dtype", choices=["float32", "bfloat16"],
                   default=None)
    t.add_argument("--no_remat_loss_tail", action="store_true")


def model_config(args: argparse.Namespace) -> RAFTStereoConfig:
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
        fused_lookup={"auto": None, "on": True, "off": False}[
            getattr(args, "fused_lookup", "auto")],
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


def build_eval_parser() -> argparse.ArgumentParser:
    """The evaluation flag surface (the JAX package's, reference
    evaluate_stereo.py) plus ``--device``."""
    parser = argparse.ArgumentParser(description="RAFT-Stereo PyTorch "
                                                 "evaluation")
    parser.add_argument("--restore_ckpt", default=None,
                        help="reference .pth checkpoint (default: seeded "
                             "random weights)")
    parser.add_argument("--run_dir", default=None,
                        help="write events.jsonl telemetry (per-frame timing "
                             "+ results) under this run directory")
    parser.add_argument("--dataset", required=True,
                        choices=["eth3d", "kitti", "things", "middlebury_F",
                                 "middlebury_H", "middlebury_Q"])
    parser.add_argument("--valid_iters", type=int, default=32,
                        help="number of refinement iterations")
    parser.add_argument("--data_root", default="datasets")
    parser.add_argument("--bucket", type=int, default=0,
                        help="pad eval images up to multiples of this size "
                             "(0 = exact /32 padding)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on ('cuda' or 'cpu')")
    g = parser.add_argument_group(
        "streaming", "pipelined evaluation (eval/stream.py): overlap frame "
        "decode, device dispatch and result fetch")
    g.add_argument("--stream", choices=["auto", "on", "off"], default="auto",
                   help="auto streams (the predictor dispatches "
                        "asynchronously); off runs the serial loop (and, on "
                        "kitti, the device-only FPS measurement)")
    g.add_argument("--stream_window", type=int, default=3,
                   help="max in-flight device dispatches (1 = no overlap)")
    g.add_argument("--stream_microbatch", type=int, default=1,
                   help="stack up to this many consecutive same-shape "
                        "frames through one dispatch")
    g.add_argument("--decode_workers", type=int, default=2,
                   help="background frame decoders (worker processes "
                        "for the port's datasets, eval/stream.py)")
    c = parser.add_argument_group(
        "convergence and numerics",
        "the JAX package's per-iteration outputs; the port's model has none "
        "yet (ROADMAP A11), so a port run is a JAX run with --no_converge "
        "--no_numerics, and --iter_epe / --iter_policy raise")
    c.add_argument("--no_converge", action="store_true")
    c.add_argument("--iter_epe", action="store_true")
    c.add_argument("--iter_policy", default=None, metavar="PATH")
    c.add_argument("--no_numerics", action="store_true")
    add_model_args(parser)
    return parser
