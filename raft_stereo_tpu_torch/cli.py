"""Command-line flags -> the port's config (the reference's flag names).

The flag surface is the JAX package's (``raft_stereo_tpu/cli.py``
``add_model_args``, ``add_train_args``, ``build_train_parser``,
``build_eval_parser``, ``build_demo_parser``, ``add_serve_args``,
``build_serve_parser`` and ``build_loadtest_parser``) plus ``--device``.
Every flag reaches the config as the JAX package's ``model_config`` maps
it, except ``--fused_block_w``: the W2 tile of the JAX package's TPU
kernel, accepted so that the same command lines parse, and read by
nothing (the CUDA kernels take no tile width). The training-schedule
flags steer the training forward and backward only.
``--corr_implementation alt_cuda`` runs the memoryless ``fused_corr``
kernels, ``alt_pallas`` the ``alt_corr`` kernels, and ``--fused_lookup on``
the ``fused_lookup`` kernel.
"""

from __future__ import annotations

import argparse

from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig


RESTORE_HELP = ("reference .pth checkpoint or a checkpoint directory "
                "written by the port's trainer (default: seeded random "
                "weights)")


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
        "training schedules and kernels",
        "the training step's schedules (what the backward recomputes or "
        "keeps, and how it accumulates) and the fused lookup kernel; "
        "--fused_block_w is accepted and read by nothing")
    t.add_argument("--no_remat", action="store_true",
                   help="keep every refinement iteration's activations for "
                        "the backward instead of recomputing them")
    t.add_argument("--fused_block_w", type=int, default=256,
                   help="the JAX package's W2 tile of its TPU 'fused' "
                        "kernel; the port's CUDA kernels take no tile width "
                        "and nothing reads it")
    t.add_argument("--fused_lookup", choices=["auto", "on", "off"],
                   default="auto",
                   help="'on' runs the lookup and the motion encoder's "
                        "convc1 as one fused_lookup CUDA kernel (reg and "
                        "reg_cuda, where the pyramid fits); 'auto' is off")
    t.add_argument("--refinement_save_policy",
                   choices=["auto", "on", "off", "corr"], default="auto",
                   help="keep the GRU gate outputs and the looked-up "
                        "correlation of every iteration across the "
                        "backward ('on'), the correlation alone ('corr') "
                        "or nothing ('off'); 'auto' by the size estimate "
                        "(models/raft_stereo.py refinement_save_policy_fits)")
    t.add_argument("--batched_scan_wgrad", choices=["auto", "on", "off"],
                   default="auto",
                   help="'on': the refinement's own backward, each gate "
                        "conv's weight gradient one contraction after the "
                        "reverse loop (ops/scan_grad.py); 'auto' is off")
    t.add_argument("--residual_dtype", choices=["float32", "bfloat16"],
                   default=None,
                   help="storage dtype of the refinement's saved residuals "
                        "(hidden states, saves and weight-gradient stacks "
                        "under --batched_scan_wgrad on; the kept values, "
                        "rounded through it, under a save policy)")
    t.add_argument("--no_remat_loss_tail", action="store_true",
                   help="keep the post-loop upsample's intermediates for "
                        "the backward instead of recomputing them")


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
        remat_refinement=not getattr(args, "no_remat", False),
        remat_loss_tail=not getattr(args, "no_remat_loss_tail", False),
        refinement_save_policy={"auto": None, "on": True, "off": False,
                                "corr": "corr"}[
            getattr(args, "refinement_save_policy", "auto")],
        batched_scan_wgrad={"auto": None, "on": True, "off": False}[
            getattr(args, "batched_scan_wgrad", "auto")],
        residual_dtype=getattr(args, "residual_dtype", None),
    )


def add_train_args(parser: argparse.ArgumentParser) -> None:
    """The training flags (the reference's train_stereo.py and the JAX
    package's own)."""
    parser.add_argument("--name", default="raft-stereo",
                        help="name your experiment")
    parser.add_argument("--restore_ckpt", default=None,
                        help="checkpoint directory, reference .pth, or "
                             "'auto': resume from the newest checkpoint of "
                             "this run in ckpt_dir that verifies (corrupt, "
                             "truncated and foreign ones are skipped with a "
                             "ckpt_integrity record)")
    parser.add_argument("--batch_size", type=int, default=6)
    parser.add_argument("--train_datasets", nargs="+", default=["sceneflow"])
    parser.add_argument("--lr", type=float, default=0.0002)
    parser.add_argument("--num_steps", type=int, default=100000)
    parser.add_argument("--image_size", type=int, nargs="+",
                        default=[320, 720])
    parser.add_argument("--train_iters", type=int, default=16)
    parser.add_argument("--valid_iters", type=int, default=32)
    parser.add_argument("--wdecay", type=float, default=1e-5)
    g = parser.add_argument_group("data augmentation")
    g.add_argument("--img_gamma", type=float, nargs="+", default=None)
    g.add_argument("--saturation_range", type=float, nargs="+", default=None)
    g.add_argument("--do_flip", choices=["h", "v"], default=None)
    g.add_argument("--spatial_scale", type=float, nargs="+", default=[0, 0])
    g.add_argument("--noyjitter", action="store_true")
    o = parser.add_argument_group("ours")
    o.add_argument("--data_root", default="datasets")
    o.add_argument("--ckpt_dir", default="checkpoints")
    o.add_argument("--validation_frequency", type=int, default=10000)
    o.add_argument("--num_workers", type=int, default=4,
                   help="loader worker processes")
    o.add_argument("--seed", type=int, default=1234)
    o.add_argument("--data_parallel", type=int, default=0,
                   help="data-parallel ranks, one process and one card each "
                        "(0: every visible card; one on the CPU)")
    o.add_argument("--seq_parallel", type=int, default=1,
                   help="width (sequence) parallel shards; 1 only")
    o.add_argument("--grad_accum_steps", type=int, default=1,
                   help="average grads over k micro-batches per update")
    o.add_argument("--run_dir", default="runs",
                   help="run-artifact root: logs and the events.jsonl "
                        "telemetry land under <run_dir>/<name>")
    o.add_argument("--stall_deadline_s", type=float, default=300.0,
                   help="stall-watchdog deadline: a `stall` record when no "
                        "step completes within this many seconds (0 "
                        "disables)")
    o.add_argument("--no_trace", action="store_true",
                   help="no step and loader spans on the bus")
    f = parser.add_argument_group(
        "fault tolerance", "atomic checkpoints, preemption handling and "
        "the anomaly guard (training/resilience.py)")
    f.add_argument("--checkpoint_frequency", type=int, default=None,
                   help="checkpoint every N steps (default: "
                        "validation_frequency); a SIGKILL loses at most "
                        "this many steps, SIGTERM/SIGINT lose none")
    f.add_argument("--ckpt_keep_last", type=int, default=3,
                   help="retention: keep the newest K step checkpoints "
                        "(0 = keep everything)")
    f.add_argument("--ckpt_keep_every", type=int, default=0,
                   help="retention: also spare checkpoints whose step is a "
                        "multiple of N (0 = none)")
    f.add_argument("--no_anomaly_guard", action="store_true",
                   help="apply every update, even on a non-finite loss or "
                        "gradient norm")
    f.add_argument("--anomaly_max_skips", type=int, default=10,
                   help="halt (for rollback to the last valid checkpoint) "
                        "after M consecutive skipped updates (0 = never)")
    n = parser.add_argument_group(
        "numerics", "per-leaf gradient norms on the event bus "
        "(obs/numerics.py)")
    n.add_argument("--no_numerics", action="store_true",
                   help="no per-leaf gradient norms")
    n.add_argument("--numerics_every", type=int, default=50,
                   help="one grad `numerics` record every N steps (a "
                        "non-finite norm always emits)")
    fl = parser.add_argument_group(
        "fleet", "host identity, clock anchor and heartbeats on the event "
        "stream")
    fl.add_argument("--no_fleet", action="store_true",
                    help="no host_id/pid stamps, clock_anchor or heartbeat "
                         "records")
    fl.add_argument("--host_id", default=None,
                    help="host identity stamped on every record (default: "
                         "RAFT_HOST_ID, else <hostname>-<pid>)")
    fl.add_argument("--heartbeat_every", type=float, default=10.0,
                    help="trainer heartbeat cadence in seconds (0 "
                         "disables the beats)")


def train_config(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(
        name=args.name,
        restore_ckpt=args.restore_ckpt,
        batch_size=args.batch_size,
        train_datasets=tuple(args.train_datasets),
        lr=args.lr,
        num_steps=args.num_steps,
        image_size=tuple(args.image_size),
        train_iters=args.train_iters,
        valid_iters=args.valid_iters,
        wdecay=args.wdecay,
        img_gamma=tuple(args.img_gamma) if args.img_gamma else None,
        saturation_range=(tuple(args.saturation_range)
                          if args.saturation_range else None),
        do_flip=args.do_flip,
        spatial_scale=tuple(args.spatial_scale),
        noyjitter=args.noyjitter,
        data_root=args.data_root,
        seed=args.seed,
        ckpt_dir=args.ckpt_dir,
        validation_frequency=args.validation_frequency,
        num_workers=args.num_workers,
        data_parallel=args.data_parallel,
        seq_parallel=args.seq_parallel,
        grad_accum_steps=args.grad_accum_steps,
        run_dir=args.run_dir,
        stall_deadline_s=args.stall_deadline_s or None,
        trace=not args.no_trace,
        checkpoint_frequency=args.checkpoint_frequency,
        ckpt_keep_last=args.ckpt_keep_last,
        ckpt_keep_every=args.ckpt_keep_every,
        anomaly_guard=not args.no_anomaly_guard,
        anomaly_max_skips=args.anomaly_max_skips,
        numerics=not args.no_numerics,
        numerics_every=args.numerics_every,
        fleet=not args.no_fleet,
        host_id=args.host_id,
        heartbeat_every_s=args.heartbeat_every,
    )


def build_train_parser() -> argparse.ArgumentParser:
    """The training flag surface (the reference's train_stereo.py) plus
    ``--device``."""
    parser = argparse.ArgumentParser(description="RAFT-Stereo PyTorch "
                                                 "training")
    add_train_args(parser)
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on ('cuda' or 'cpu')")
    add_model_args(parser)
    return parser


def build_demo_parser() -> argparse.ArgumentParser:
    """The demo flag surface (reference demo.py) plus ``--device``."""
    parser = argparse.ArgumentParser(description="RAFT-Stereo PyTorch demo")
    parser.add_argument("--restore_ckpt", required=True,
                        help="reference .pth checkpoint or a checkpoint "
                             "directory written by the port's trainer")
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
                        help=RESTORE_HELP)
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
        "convergence", "iteration-resolved quality telemetry "
        "(obs/converge.py): per-frame |delta disparity| curves on the "
        "event bus, replayable offline by `python -m "
        "raft_stereo_tpu_torch.obs.converge <run_dir>`")
    c.add_argument("--no_converge", action="store_true",
                   help="disable the convergence outputs: the forward "
                        "runs without them and no converge events are "
                        "written")
    c.add_argument("--iter_epe", action="store_true",
                   help="additionally compute the per-iteration EPE "
                        "against GT (needs datasets with flow; implies the "
                        "convergence outputs)")
    c.add_argument("--iter_policy", default=None, metavar="PATH",
                   help="iteration-policy JSON (`python -m "
                        "raft_stereo_tpu_torch.obs.converge <run_dir> "
                        "--emit-policy`): run the early-exit forward with "
                        "each bucket's recorded (tau, budget, min_iters) "
                        "instead of the fixed valid_iters; per-frame "
                        "iters_taken rides the converge events")
    n = parser.add_argument_group(
        "numerics", "per-iteration activation-tap range statistics "
        "(obs/numerics.py): min/max/absmean, bf16 saturation/underflow "
        "counters and first-nonfinite NaN provenance as `numerics` events")
    n.add_argument("--no_numerics", action="store_true",
                   help="disable the numerics taps: the forward runs "
                        "without them and no numerics events are written")
    add_model_args(parser)
    return parser


def add_serve_args(parser: argparse.ArgumentParser) -> None:
    """Scheduler and queue knobs shared by serve and loadtest."""
    g = parser.add_argument_group(
        "serving", "continuous-batching scheduler (raft_stereo_tpu_torch/"
        "serve)")
    g.add_argument("--max_batch", type=int, default=4,
                   help="max requests stacked through one dispatch")
    g.add_argument("--queue_depth", type=int, default=64,
                   help="bounded request-queue depth (admission "
                        "backpressure past this)")
    g.add_argument("--window", type=int, default=2,
                   help="max device dispatches in flight")
    g.add_argument("--iters", type=int, default=32,
                   help="refinement iterations per request (the request "
                        "may override)")
    g.add_argument("--bucket", type=int, default=0,
                   help="pad request shapes up to multiples of this to "
                        "bound the buckets (0 = exact /32 padding)")
    g.add_argument("--linger_ms", type=float, default=0.0,
                   help="wait up to this long for same-bucket stragglers "
                        "while a batch is below max_batch")
    g.add_argument("--no_aot", action="store_true",
                   help="no warm-up forward per bucket before traffic; a "
                        "bucket's first request pays for it")
    g.add_argument("--slo_every", type=int, default=16,
                   help="emit one `slo` rollup event every N retirements")
    g.add_argument("--no_converge", action="store_true",
                   help="serve without the per-request convergence curve: "
                        "no converge events, no per-bucket slo quality "
                        "gauges")
    g.add_argument("--numerics", action="store_true",
                   help="serve the numerics flavour (obs/numerics.py): "
                        "per-dispatch activation-tap `numerics` events and "
                        "per-bucket output-range gauges on /metrics; off by "
                        "default, and then the served forward has no taps")
    g.add_argument("--iter_policy", default=None, metavar="PATH",
                   help="iteration-policy JSON (`python -m "
                        "raft_stereo_tpu_torch.obs.converge <run_dir> "
                        "--emit-policy`): buckets the policy covers are "
                        "served by the early-exit forward, their (tau, "
                        "budget, min_iters) in place of --iters; "
                        "per-request iters_taken rides the request/slo "
                        "telemetry and /metrics")
    g.add_argument("--adaptive", choices=["auto", "on", "off"],
                   default="auto",
                   help="early-exit mode (auto: on iff --iter_policy is "
                        "given; off ignores a loaded policy and serves the "
                        "fixed-trip forwards)")
    g.add_argument("--fused_width", type=int, default=0,
                   help="serve buckets padded to at least this width with "
                        "the memoryless 'fused' correlation (the fused_corr "
                        "kernels; 0 = off)")


def serve_config(args: argparse.Namespace):
    """The parsed serve flags as a ServeConfig (the cache checks the
    policy and the flavour guards when the server is made)."""
    from raft_stereo_tpu_torch.serve.server import ServeConfig
    return ServeConfig(
        max_batch=args.max_batch, queue_depth=args.queue_depth,
        window=args.window, default_iters=args.iters, bucket=args.bucket,
        linger_s=args.linger_ms / 1e3, aot=not args.no_aot,
        slo_every=args.slo_every, converge=not args.no_converge,
        numerics=args.numerics, iter_policy=args.iter_policy,
        adaptive={"auto": None, "on": True, "off": False}[args.adaptive],
        fused_width=args.fused_width)


def _parse_shapes(specs) -> list:
    """['48x96', ...] -> [(48, 96), ...] (the --shapes/--warm_shapes
    format)."""
    out = []
    for spec in specs:
        h, w = spec.lower().split("x")
        out.append((int(h), int(w)))
    return out


def _add_fleet_args(parser: argparse.ArgumentParser, role: str) -> None:
    parser.add_argument("--no_fleet", action="store_true",
                        help="no host_id/pid stamps, clock_anchor or "
                             "heartbeat records on the telemetry stream")
    parser.add_argument("--host_id", default=None,
                        help="host identity stamped on every record "
                             "(default: RAFT_HOST_ID, else <hostname>-<pid>)")
    parser.add_argument("--heartbeat_every", type=float, default=10.0,
                        help=f"{role} heartbeat cadence in seconds (0 "
                             "disables the beats)")


def build_converge_parser() -> argparse.ArgumentParser:
    """The flag surface of ``python -m raft_stereo_tpu_torch.obs.converge``
    (the JAX package's ``cli converge``)."""
    parser = argparse.ArgumentParser(
        prog="python -m raft_stereo_tpu_torch.obs.converge",
        description="Early-exit what-if simulator: replay a run's recorded "
                    "convergence curves against a grid of exit thresholds "
                    "and print the decision table (iterations saved vs "
                    "predicted EPE delta), without running the model")
    parser.add_argument("run_dir",
                        help="run directory (or events.jsonl path) holding "
                             "converge events")
    parser.add_argument("--taus", type=float, nargs="+", default=None,
                        help="exit thresholds on the per-iteration mean "
                             "|delta disparity| (px); default "
                             "0.5 0.2 0.1 0.05 0.02 0.01")
    parser.add_argument("--bucket_by", choices=["bucket", "all", "both"],
                        default="both",
                        help="row granularity: per shape bucket, pooled "
                             "across buckets, or both")
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="write the decision-table JSON to this path; "
                             "'-' prints the JSON to stdout instead of the "
                             "text table")
    parser.add_argument("--out", default=None,
                        help="also write the JSON table to this path")
    p = parser.add_argument_group(
        "policy emission", "freeze one simulated operating point into an "
        "iter_policy.json: per-bucket (tau, budget, min_iters) with row "
        "provenance, which evaluate --iter_policy and serve --iter_policy "
        "run as the early-exit forward")
    p.add_argument("--emit-policy", default=None, metavar="PATH",
                   help="write the policy JSON here (the decision table "
                        "still prints)")
    p.add_argument("--policy-tau", type=float, default=None,
                   help="exit threshold frozen into the policy (px mean "
                        "|delta disparity|; default 0.05)")
    p.add_argument("--policy-min-iters", type=int, default=1,
                   help="iteration floor before a sample may freeze")
    p.add_argument("--policy-margin", type=int, default=1,
                   help="budget = recorded exit p95 + this safety margin "
                        "(clamped to the recorded valid_iters)")
    return parser


def build_serve_parser() -> argparse.ArgumentParser:
    """The serving flag surface (the JAX package's ``cli serve``): HTTP
    front and scheduler, plus ``--device``."""
    parser = argparse.ArgumentParser(
        description="RAFT-Stereo PyTorch serving (continuous batching)")
    parser.add_argument("--restore_ckpt", default=None, help=RESTORE_HELP)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8600)
    parser.add_argument("--run_dir", default=None,
                        help="write request/queue/slo telemetry under this "
                             "run directory")
    parser.add_argument("--warm_shapes", nargs="+", default=[],
                        help="warm these HxW raw shapes up before admitting "
                             "traffic (e.g. 384x512 540x960)")
    parser.add_argument("--ckpt_dir", default=None,
                        help="watch this checkpoint dir: SIGHUP hot-reloads "
                             "the newest manifest-valid checkpoint without "
                             "dropping queued work")
    parser.add_argument("--ckpt_name", default="raft-stereo",
                        help="checkpoint name inside --ckpt_dir (the "
                             "trainer's --name)")
    parser.add_argument("--drain_timeout_s", type=float, default=300.0,
                        help="max seconds to finish admitted work after "
                             "SIGTERM/SIGINT before giving up (exit 1)")
    parser.add_argument("--no_metrics", action="store_true",
                        help="disable the Prometheus GET /metrics endpoint")
    _add_fleet_args(parser, "serve")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on ('cuda' or 'cpu')")
    add_serve_args(parser)
    add_model_args(parser)
    return parser


def build_loadtest_parser() -> argparse.ArgumentParser:
    """The load-drill flag surface (the JAX package's ``cli loadtest``):
    a synthetic many-client trace against a sequential-predict baseline,
    plus ``--device``."""
    parser = argparse.ArgumentParser(
        description="RAFT-Stereo PyTorch serving load test")
    parser.add_argument("--restore_ckpt", default=None, help=RESTORE_HELP)
    parser.add_argument("--run_dir", default="runs/loadtest",
                        help="telemetry root: the sequential baseline "
                             "lands in <run_dir>/seq, the served run in "
                             "<run_dir>/serve")
    parser.add_argument("--shapes", nargs="+",
                        default=["48x96", "64x128", "96x64"],
                        help="raw HxW request shapes (>= 3 distinct buckets "
                             "for the drill)")
    parser.add_argument("--clients", type=int, default=8,
                        help="concurrent client threads")
    parser.add_argument("--requests_per_client", type=int, default=4)
    parser.add_argument("--video_streams", type=int, default=1,
                        help="how many clients are video sessions riding "
                             "flow_init warm starts")
    parser.add_argument("--poison_at", type=int, default=None,
                        help="global request ordinal to corrupt with a NaN "
                             "pixel (per-request isolation drill)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no_baseline", action="store_true",
                        help="skip the sequential-predict baseline phase")
    parser.add_argument("--no_progress", action="store_true",
                        help="suppress LOADTEST progress lines")
    _add_fleet_args(parser, "loadtest")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on ('cuda' or 'cpu')")
    add_serve_args(parser)
    add_model_args(parser)
    return parser
