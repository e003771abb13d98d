#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each reported as one JSON line, in the order they run:

1. device  — the card's name and power limit (nvidia-smi); TF32 is turned
   off for convolutions and matmuls, so fp32 means fp32 everywhere below.
2. build   — builds every CUDA kernel of the paths (windowed_sample,
   fused_corr, alt_corr, fused_lookup) from the sources in
   raft_stereo_tpu_torch/csrc with nvcc (sm_90a), one nvcc each, all
   started together; timed as set-up, with each nvcc's seconds.
3. parity  — the windowed_sample forward kernel, launched for one level,
   against its plain PyTorch version on the card, at every pyramid-level
   shape of both inference configurations and the training batch, with
   edge centers (integers, borders, +-1e9, NaN). Bound: 1e-5 abs.
4. bwd_parity — the windowed_sample backward kernels for one level
   against their plain version at every level shape of the training batch
   and of both inference configurations, the same edge centers: dvol
   bitwise equal (NaN pattern included; bound 1e-5 abs in fp32, one bf16
   ulp in bf16), dcoords 1e-5 abs, and two runs bitwise equal.
   ws_pyramid_parity: windowed_sample's one launch for the pyramid, forward
   and backward, at the default, realtime and train pyramids (the train one
   with 1 to 4 levels), a narrow pyramid down to W2 <= 2r+2 and a ragged
   one, the same edge centers: forward and every level's dvol bitwise equal
   to the plain versions and to the one-level launches, dcoords 1e-5 abs,
   two runs bitwise equal, one launch a call each way.
5. fused_parity — the fused_corr forward and backward kernels against
   their plain versions at every level shape of the hires and train_fused
   paths and at W2 <= 2r+2, the same edge centers: the forward 1e-5 abs,
   df1/df2 1e-5 abs (bf16 features: one bf16 ulp of the plain value where
   larger), NaN patterns equal, and two runs of each bitwise equal (df2 is
   a deterministic scatter). fused_pyramid_parity: the one-launch forward
   over 1 to 4 levels (the hires and train pyramids, smooth centers, a
   pyramid down to W2 <= 2r+2) against its plain version, 1e-5 abs, two
   runs bitwise equal and bitwise equal to the one-level launches.
   fused_bwd_wide: the backward kernels on rows of W1 = W2 = 4000 (tiled
   over W2; one block a row refused them before) in fp32 and bf16 against
   the plain version, the same bounds, two runs bitwise equal.
6. fused_memory — the memory contract: the 4-level fused lookup at the
   hires shape allocates its outputs plus less than 1/8 of one level-0
   volume, a level-0 backward df1 + df2 plus that margin.
7. alt_parity, alt_memory — the same two checks for the alt_corr kernels
   (the slab entries a window reads), held to their plain versions and to
   fused_corr's kernels on the same inputs (one function).
   alt_pyramid_parity: alt_corr's one-launch forward over 1 to 4 levels,
   as fused_pyramid_parity, bitwise equal to its plain version (which
   sums in the kernel's order) and to the one-level launches.
8. fused_lookup_parity — the fused_lookup kernels (lookup + convc1 + ReLU)
   against their plain versions at the default, realtime and train
   pyramids with the edge centers: output and dvol 1e-5 abs (one bf16 ulp
   in bf16), dk/db 1e-5 of their largest magnitude, every output bitwise
   equal run to run.
9. default, realtime, alt_pallas, default_fused_lookup,
   realtime_fused_lookup — the default architecture with
   corr_implementation="reg_cuda" at full width (seeded random weights),
   through StereoPredictor on a 375x1242 pair (padded to 384x1248), 32
   iterations; realtime_config() (bf16), 7 iterations; the default
   architecture with alt_pallas (fp32); and both with fused_lookup=True:
   finite output of the right shape, exactly 1 launch an iteration of
   the path's lookup kernel (windowed_sample's, alt_corr's or
   fused_lookup's, each one launch for the four levels) and none of the
   others, median ms/frame, peak memory.
10. hires — the default architecture with alt_cuda (the fused_corr
   kernels, fp32) on a 1988x2880 pair (padded to 2016x2880), 32
   iterations: exactly 32 fused_corr forward launches (one for the four
   levels an iteration) and no windowed_sample launch, finite output,
   median ms/frame over HIRES_RUNS warm frames and the device time of one
   profiled frame; no FFT kernel in one profiled iteration (cuDNN's
   heuristic once ran update_block.gru32's convs as FFTs of ~99,000
   kernels an iteration, nn/layers.py); peak memory at 2 iterations below
   reg_cuda's on the same pair.
11. cpu_parity — the default architecture on the same weights, fp32, 4
   iterations, on the card (kernel) and on the CPU (plain version), with
   reg_cuda, alt_cuda and alt_pallas at 64x160 and with reg_cuda +
   fused_lookup at 64x352 (the narrowest pair whose pyramid the fused
   kernel takes). Bound: 1e-3 px on flow_up.
11a. adaptive_parity, numerics_cpu — the early exit and the numerics
   taps. adaptive_parity: the default architecture (reg_cuda, fp32) at
   384x1248, batch 2 (a textured pair and a noise pair), 32 iterations:
   τ=0 bitwise the fixed loop (32 iterations taken a sample); at a τ
   between recorded residuals where the two samples freeze apart,
   iters_taken equal to the freeze rule on the fixed curves, frozen rows
   0.0, while_loop bitwise masked_scan; windowed_sample 32 launches a
   forward under masked_scan, the trips run plus one under while_loop;
   each mode timed, and at τ=0 the while loop's host syncs (31 a forward)
   priced per iteration. numerics_cpu: the taps of one fp32 pair at
   64x160 (4 iterations) on the card and on the CPU: labels and counters
   equal, min/max/absmean within 1e-3 of max(1, |CPU|); then one alt_cuda
   1988x2880 frame with the taps: 32 fused_corr launches, 8 finite taps.
11b. eval_kitti, eval_cli, eval_microbatch, eval_middlebury, eval_cpu —
   the evaluation path on synthetic trees written by the port's png.py
   (Paeth rows, as photographs are written) in a temporary directory,
   seeded weights: eval_kitti runs validate_kitti over EVAL_FRAMES KITTI frames (all but 2
   timed after the validator's warm-up) at 375x1242 (the
   default architecture, reg_cuda, mixed precision as the eval entry point
   sets it, 32 iterations, warmup_frames=1; PyTorch's TF32 defaults, as
   the entry point leaves them) sequentially, streamed (window 3,
   decoded in worker processes) and streamed with decode threads (the
   alternative, measured): per-frame flows bitwise equal, the same EPE
   and D1, kitti-fps and kitti-fps-e2e sequentially and kitti-fps-e2e
   streamed, 32
   windowed_sample launches a frame and none of the other kernels', an
   events.jsonl each that passes the port's validate_events with one step
   a frame and one validation; then a profiled streamed run gives the
   card's idle share. eval_cli runs python3 -m
   raft_stereo_tpu_torch.evaluate on the same tree and weights, streamed,
   in a subprocess: exit 0 and the streamed run's EPE and D1.
   eval_microbatch sends three of those frames through predict_async two
   a dispatch (B1 at B=2), in bf16 and in fp32: 32 launches a dispatch, a
   frame's flow bitwise independent of its partner and slot, B1 at B=2
   bitwise equal to B=1, the first departure from batch 1 a rounding
   difference from equal inputs (cuDNN's and PyTorch's kernel choices by
   batch size), fp32 EPE within 1e-3 px of batch 1's.
   eval_middlebury runs validate_middlebury (split F) on one 1988x2880
   scene with alt_cuda in mixed precision: 32 fused_corr launches, the
   EPE of StereoPredictor.__call__ on the same pair, ms per frame.
   eval_cpu runs validate_eth3d on 2 frames at 64x128 (fp32 reg_cuda, 4
   iterations) on the card and on the CPU: EPE within 1e-3 px.
   numerics_eval runs the entry point sequentially on eval_kitti's tree
   with its defaults (converge and numerics on) and with --no_converge
   --no_numerics: kitti-fps of each (device forward, frames 2 on), the
   same EPE and D1, a converge record a frame and a numerics record a
   dispatch (8 taps, finite) that pass the schema, none without; then
   both predictors profiled in this process for kernels a frame and idle
   share. adaptive_eval builds a policy from those converge records
   (build_policy at the smallest decile τ whose budget is at most 16),
   runs the entry point with --iter_policy: kitti-fps and mean
   iters_taken against the fixed run, no numerics records; in this
   process windowed_sample, and with fused_lookup=True fused_lookup,
   launch the budget's times a frame.
11c. serve, serve_realtime, serve_fused, loadtest (and serve_http, run
   after train_trainer, whose checkpoints it serves) — the serving path
   (raft_stereo_tpu_torch/serve) on seeded weights at 375x1242 (the
   384x1248 bucket). serve: StereoServer on the default architecture
   (reg_cuda, fp32, 32 iterations), max_batch 4, window 2: a batch-1
   served flow bitwise the predictor's; four concurrent requests in one
   dispatch, bitwise the predictor's batch of four, departing from batch
   1 first by a rounding difference from equal inputs, within 1e-3 px of
   batch 1 at 4 iterations (the depth of cpu_parity) and reported at 1, 4
   and 32 (the refinement amplifies the departure); a NaN pixel in one
   of four fails that request alone, the three others bitwise their
   clean-batch flows; a three-frame warm-start session bitwise the model
   driven by hand with the previous frame's low-res flow as flow_init; a
   reload mid-traffic drops nothing and later flows are bitwise a fresh
   server's on the new weights; drain finishes the admitted requests and
   refuses new ones; 32 windowed_sample launches a dispatch and no other
   kernel's, a 32-entry residual curve a request. serve_realtime:
   realtime_config() (bf16, 7 iterations), batch 1, one client waiting
   for each result: 7 launches a dispatch, median and p99 latency,
   pairs/s and the card's idle share (torch.profiler). serve_fused:
   fused_width 1248: 375x1242 rides the +fused bucket (32 fused_corr
   launches a dispatch, no windowed_sample) within 1e-3 px of serve's
   reg_cuda flow at 4 iterations (reported at 1, 4 and 32), 188x621
   rides 192x640 (32 windowed_sample, no fused_corr). serve_http:
   python3 -m raft_stereo_tpu_torch.serve in a
   session of its own on train_trainer's final checkpoint: a POSTed
   pair's flow bitwise the in-process server's, /healthz /slo /metrics,
   a newer checkpoint reloaded on SIGHUP (the log names it; the next flow
   is the new weights'), SIGTERM drains with exit 0, nothing left
   running, a valid events.jsonl. loadtest: python3 -m
   raft_stereo_tpu_torch.serve.loadtest on realtime_config(), 7
   iterations, three buckets (375x1242, 352x1216, 320x1024), 8 clients
   x 4 requests, one video stream, request 5 poisoned: exit 0, nothing
   lost, exactly one nonfinite_output, the video frames served warm,
   served against sequential pairs/s, p50/p99 latency, both
   events.jsonl valid. serve_adaptive: one server (default, fp32, 32
   iterations) with a policy covering the 384x1248 bucket only (budget
   16): its requests ride the @digest flavour with the predictor's flow
   and iters_taken and 16 windowed_sample launches a dispatch, a 188x621
   request stays on the fixed forward (32 launches, no iters_taken), the
   slo iters rollup and its /metrics gauges; a --numerics server: one
   numerics record a dispatch and the output_range gauges on /metrics.
12. train — the SceneFlow recipe (sceneflow_config(): bf16 compute, bf16
   volume) with reg_cuda, batch 8 at 320x720, 22 iterations, through
   make_train_step on a seeded synthetic batch: a warm-up step, then timed
   steps, each with exactly 22 forward launches (one for the four levels
   an iteration), as many recomputed under remat_refinement and 22
   backward launches (one for the four levels' dvol); finite loss and
   gradient norm, no skipped update, parameters that moved; median
   ms/step and peak memory.
13. train_nan — a batch with a NaN pixel: the update is skipped, the
   parameters stay bitwise unchanged and the step still counts.
14. train_fused, train_alt, train_fused_lookup — the same recipe with
   alt_cuda (bf16 features), with alt_pallas, and with reg_cuda +
   fused_lookup: the same checks, with the path's kernel launches
   ((44, 88): one forward launch an iteration, four backward; (44, 88);
   (44, 22)) and none of the other kernels'.
15. train_cpu_parity — one fp32 step of the default architecture, 2
   iterations, on the card (kernels) and on the CPU (plain versions),
   under the recipe's full per-iteration recompute
   (refinement_save_policy=False; (4, 2) launches, (4, 8) for B2 and B3):
   reg_cuda with the card's convolutions in cuDNN (as the main path runs
   them) and outside it, alt_cuda and alt_pallas in cuDNN at 64x160,
   reg_cuda + fused_lookup in cuDNN at 64x352; then reg_cuda under the
   auto save policy, which engages at this size ((2, 2): the lookups
   replayed); the loss within 1e-5 relative, and the gradients within
   the null floor of NULL_RUNS CPU null runs (see check_grad_parity).
15a. train_schedules, train_schedules_fp32, train_schedules_kernels —
   the JAX package's training schedules (TRAIN_SCHEDULES). At the
   SceneFlow recipe (reg_cuda, bf16, batch 8 at 320x720, 22 iterations),
   seeded weights and one batch, each schedule: batched_scan_wgrad, the
   save policy on and "corr", residual_dtype=bfloat16, the in-loop
   upsample, remat_loss_tail=False, the fused loss (chunked by the
   default budget, one-shot, without the tail's remat, in the loop) and
   each remat_encoders mode: the loss within SCHEDULE_LOSS_TOL of
   today's schedule, the gradients within the null floor of today's
   (NULL_RUNS null runs made once); under batched_scan_wgrad, whose fp32
   sums depart from today's bf16 per-iteration terms, within the null
   floor of the schedule it accumulates like (today's with each
   iteration's gate weight gradients in fp32, NULL_RUNS null runs of its
   own), closer to it than today's are on the gate weights, and within
   JAX's bf16 contract of today's; train_schedules_wgrad holds every
   batched weight-gradient contraction at the recipe no further from a
   float64 im2col contraction of the same stacks than today's
   per-iteration route on them is. B1's
   launches a step as TRAIN_SCHEDULES states them (22 or 44 forward, 22
   backward) and no other kernel's; ms/step (SCHEDULE_STEPS timed
   after a warm-up), peak memory, and the device-time
   split (lookup, convolution, matmul, elementwise), kernels and idle
   share of one profiled step. In fp32 (TF32 off) at batch
   FP32_GATE_BATCH: batched_scan_wgrad (and with the full policy)
   through B1, and through B2 (alt_cuda), B3 (alt_pallas) and B4
   (fused_lookup), each within the null floor of that correlation's
   autodiff step, with its launches.
15b. train_loader, train_trainer, train_trainer_steady,
   train_trainer_fused, train_resume — the training path on a synthetic
   FlyingThings tree written by the port's png.py (8 frames a pass at
   540x960, the "sceneflow" mix of 64 samples, 8 batches an epoch; 2 TEST
   frames). train_loader: the port's Loader at the recipe's augmentation,
   samples/s with its worker processes, ms a sample by stage (decode,
   photometric, resize, crop), two passes bitwise equal and a
   start_batch resume equal to the uninterrupted stream. train_trainer:
   train() in this process at the recipe (reg_cuda, bf16, batch 8 at
   320x720, 22 iterations, TRAINER_STEPS steps, checkpoints every 4, validation
   every 6 on the TEST frames at 32 iterations): exactly (44, 22)
   windowed_sample launches every step and no other kernel's, finite
   losses, an events.jsonl the port's validate_events passes with the
   fleet stamp and heartbeats; ms/step (median of steps 3 on), pairs/s,
   the data_wait/dispatch/fetch medians and data_wait's share, peak
   memory, checkpoint bytes and save seconds. train_trainer_steady: the
   same for STEADY_STEPS steps with no checkpoint or validation, timed
   from the second epoch: data_wait's share of the window's time, where a
   loader slower than the card shows. train_trainer_fused: the same with
   alt_cuda for 2 steps, (44, 88) fused_corr launches a step.
   train_resume: python -m raft_stereo_tpu_torch.train at the recipe in
   sessions of their own: an uninterrupted run A; a run sent SIGTERM
   after its step-5 record (a preempt checkpoint, exit 0) resumed with
   --restore_ckpt auto (its resume record at the preempt step); a second
   uninterrupted run B; a run C restored from A's step-4 checkpoint for
   one step. Step 1's loss equal in A, B and the resumed run; C's step-5
   loss A's bitwise and its update one AdamW step of A's step-4 state
   (adamw_step_deviation within ADAMW_V_TOL and ADAMW_P_TOL); the resumed
   run's parameters bitwise A's where A and B are bitwise equal; no
   process left in any run's session; the distances between the three
   runs' final parameters and their per-step loss gaps reported.
15c. dp_parity, dp_train, dp_trainer — data parallelism
   (raft_stereo_tpu_torch/parallel) with two ranks sharing the one card,
   each a process this script spawns and joins to a process group
   (gloo: the backend rule takes NCCL only where every rank has a card
   of its own). dp_parity: the default architecture (fp32, reg_cuda) at
   64x160, 2 iterations, global batch 4 split 2 + 2: the 2-rank loss
   within 1e-5 relative of the one-process step's on the concatenated
   batch, the reduced gradients within the null floor of NULL_RUNS card
   null runs (check_grad_parity), under the recipe's full per-iteration
   recompute ((4, 2) windowed_sample launches a rank) and under the auto
   save policy, engaged at this size ((2, 2)), and no other kernel's,
   both ranks' gradients and, after two steps, their parameters and
   AdamW moments bitwise equal. dp_train: the
   SceneFlow recipe (reg_cuda, bf16, 22 iterations) at global batch 8 at
   320x720 split 4 + 4: (22, 22) windowed_sample launches a rank a step
   (the auto save policy keeps the lookups at batch 4)
   and no other kernel's, equal finite losses, the replicas bitwise
   equal; a rank's ms/step (median of TRAIN_STEPS after a warm-up), the
   gradients' all-reduce ms alone, peak memory a rank. Two ranks share
   one card: no scaling figure is drawn from it. dp_trainer: train() in
   two ranks on the training tree at the recipe, 4 steps with a
   checkpoint every 2, then a run restored from the step-2 checkpoint
   for one step: one checkpoint set, written by rank 0; each rank's
   events.jsonl valid with its mesh coordinates and the backend on
   run_start; the restored step's loss the uninterrupted run's bitwise;
   (22, 22) launches a rank a step (batch 4 a rank); no process left.
15d. obs_reports — the report tools on the logs the card wrote above
   (copied out of each phase's temporary directory as it ends):
   eval_cli, numerics_eval's run with the taps on, adaptive_eval,
   loadtest/{seq,serve}, train_trainer, train_trainer_steady, serve_http
   and dp_trainer's two ranks as a fleet. Each report runs as python -m
   raft_stereo_tpu_torch.cli {telemetry, doctor, timeline, compare,
   numerics, converge, fleet} in a subprocess of its own (REPORT_WORKERS
   at a time, host only): every exit code as expected (numerics and
   converge exit 1 on a log without their records), neither jax nor
   raft_stereo_tpu in the subprocess's modules after main returns,
   obs.validate.check_path clean on each log (and python -m
   raft_stereo_tpu_torch.obs.validate over all of them), the summary's
   step count the steps or frames the phase ran, compare of a run against
   itself exit 0, the timeline valid JSON with one step span a train step
   and one request span a served request (none in the eval and sequential
   logs, which write no spans), a train verdict on both trainers, a
   numerics verdict on numerics_eval and FLEET_OK over dp_trainer's
   ranks; each report's verdict and wall seconds.
16. timings, bwd_timings — windowed_sample's forward at the default,
   realtime and train pyramids and its backward at the train pyramid: per
   level, the one-level launch's time, its bound (bound_ms: bytes over
   3.35 TB/s, or operations over the peak of their type, whichever is
   larger), the plain version's time and one PyTorch call computing the
   same function (F.grid_sample for the forward, its backward by
   torch.autograd.grad on a prebuilt graph for the backward: the
   reference's formulation); then the one launch for the four levels as
   the main path runs it, on the same levels and centers, with its
   four-level bound, its plain version's time and the levels' sums.
17. fused_timings, alt_timings — fused_corr's forward in one launch for
   the four hires levels (fp32) and the four train levels (bf16), and per
   level; alt_corr's forward in one launch for the four levels of the
   alt_pallas frame (fp32), of the train step (bf16) and of the hires
   frame, and per level at the first two; both backwards per train level
   (bf16).
   Each on random centers (an independent disparity a pixel) with time
   per launch, bound (B2's function for both), plain time and the
   reference's several-call 'alt' formulation as a yardstick (no single
   PyTorch call computes the function, so their kernels-line entries have
   library_ms null), and on smooth centers (a low-frequency disparity
   field, as a model makes) with time and bound.
18. fused_lookup_timings — fused_lookup's forward at the default,
   realtime and train pyramids and its backward at the train pyramid: time per
   launch, bound, plain time and the unfused formulation (F.grid_sample
   x4, cat, a 1x1 conv, ReLU) as a yardstick.

Then the kernels line; the decode pools' fork server is stopped and no
process the script started (nor one started by those) may still be
running: a leftover is killed and fails the run. Last, {"ok": true,
"device": {...}}. Any failed
check raises, and the script exits non-zero without that last line. It
exits non-zero at once when torch.cuda is not available.
"""

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 1234
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published peak
FP32_FLOPS_PER_S = 67e12    # H100 SXM, non-tensor-core fp32 peak
BF16_FLOPS_PER_S = 989e12   # H100 SXM, dense bf16 tensor-core peak
KERNEL_TOL = 1e-5
CPU_PARITY_TOL_PX = 1e-3
RADIUS = 4
TRAIN_STEPS = 3              # timed steps after the warm-up step
TRAIN_LOSS_TOL = 1e-5        # card vs CPU step: relative loss deviation
NULL_PERTURBATION = 1e-6     # the CPU null runs' relative weight noise
NULL_RUNS = 8                # CPU null runs whose envelope bounds the card
ROUNDOFF_REL = 1e-7          # gradient leaves below this x the global norm
# the hires pair: about MiddEval3's full-resolution size, padded to
# 2016x2880 (1/4 resolution 504x720)
HIRES_H, HIRES_W = 1988, 2880
HIRES_RUNS = 3               # timed warm frames
# fused_corr level shapes (B, H, W1, W2, D): the hires path (fp32) and
# the SceneFlow training batch with alt_cuda (bf16)
FUSED_SHAPES = {"hires": [(1, 504, 720, 720 >> i, 256) for i in range(4)],
                "train_fused": [(8, 80, 180, 180 >> i, 256)
                                for i in range(4)]}
# alt_corr's own inference path: the default architecture at 384x1248 (fp32)
ALT_DEFAULT_SHAPES = [(1, 96, 312, 312 >> i, 256) for i in range(4)]
# fused_corr's backward on rows wider than one block's shared memory held
WIDE_BWD_SHAPE = (1, 4, 4000, 4000, 256)
# fused_lookup's configurations: (volume dtype, compute dtype, (B, H, W1,
# level-0 W2)) of the default and realtime frames and the SceneFlow batch
LOOKUP_C1 = {"default": ("float32", "float32", (1, 96, 312, 312)),
             "realtime": ("bfloat16", "bfloat16", (1, 48, 156, 156)),
             "train": ("bfloat16", "bfloat16", (8, 80, 180, 180))}
# the evaluation phases: KITTI frames, their size, their pairs' shift (the
# disparity), iterations. validate_kitti times the frames after
# warmup_frames=1 (frames 0 and 1 are its warm-up): 8 timed frames
EVAL_FRAMES = 10
EVAL_KITTI_HW = (375, 1242)
EVAL_SHIFT = 12
EVAL_ITERS = 32
# batch 2 against batch 1: the first layer's departure, relative to its
# output's largest magnitude, that rounding can make: four bf16 rounding
# steps (one is at most 2^-7 of a value); a logic fault departs by O(1)
DEPARTURE_REL = 2.0 ** -5


_T0 = time.perf_counter()


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": round(time.perf_counter() - _T0, 1)}),
          flush=True)


def check(cond, message):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def live_processes():
    """{pid: (ppid, session id, command)} of every process alive on the
    machine (zombies, already exited, are left out), from /proc."""
    procs = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:  # exited while we looked
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if fields[0] != "Z":
            procs[int(name)] = (int(fields[1]), int(fields[3]), cmd.strip())
    return procs


def stop_leftovers(procs, what):
    """Kill the processes ``procs`` ({pid: command}) and fail naming them:
    a process this script started outlived its phase."""
    import signal
    for pid in procs:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    check(not procs, f"{what} left processes running: {procs}")


def check_no_descendants():
    """No process started by this script, or by one it started, is still
    running: the decode pools' fork server and resource tracker are
    stopped, every subprocess and nvcc build was waited for."""
    procs = live_processes()
    children = {}
    for pid, (ppid, _, _) in procs.items():
        children.setdefault(ppid, []).append(pid)
    found, todo = {}, list(children.get(os.getpid(), []))
    while todo:
        pid = todo.pop()
        found[pid] = procs[pid][2]
        todo.extend(children.get(pid, []))
    stop_leftovers(found, "chip_smoke")


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


def window_centers(b, h, w1, w2, g, device, edges=True):
    """Lookup centers of a (b, h, w1) grid into rows of width w2: each
    pixel's own x less a disparity in [0, w2/4]. With ``edges``, the first
    centers are integers, borders, +-1e9 (flat positions 6 and 7) and NaN
    (flat position 9)."""
    import torch
    x = torch.arange(w1, device=device, dtype=torch.float32) * (w2 / w1)
    disp = torch.rand((b, h, w1), generator=g, device=device) * (w2 / 4)
    center = (x - disp).contiguous()
    if edges:
        flat = center.view(-1)
        edge = [0.0, -1.0, float(w2 - 1), float(w2), -RADIUS - 0.5,
                w2 + RADIUS + 0.25, 1e9, -1e9, 0.999999, float("nan"),
                float(w2 // 2)]
        flat[:len(edge)] = torch.tensor(edge, device=device)
    return center


def smooth_centers(b, h, w1, w2, g, device):
    """Lookup centers as a model makes them: each pixel's own x less a
    smooth, low-frequency disparity in [0, w2/4] (one period across the
    row and one down the image, a random phase per batch element), so
    neighbouring pixels look up nearly the same window."""
    import torch
    x = torch.arange(w1, device=device, dtype=torch.float32) * (w2 / w1)
    phase = torch.rand((b, 2, 1, 1), generator=g, device=device)
    xs = torch.arange(w1, device=device, dtype=torch.float32) / w1
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None] / h
    disp = (w2 / 8) * (1 + torch.sin(2 * math.pi * (xs + phase[:, 0]))
                       * torch.cos(2 * math.pi * (ys + phase[:, 1])))
    return (x - disp).contiguous()


def lookup_inputs(shape, dtype, seed, device, edges=True):
    import torch
    b, h, w1, w2 = shape
    g = torch.Generator(device=device).manual_seed(seed)
    vol = torch.randn(shape, generator=g, device=device).to(dtype)
    return vol, window_centers(b, h, w1, w2, g, device, edges)


def fused_inputs(shape, dtype, seed, device, edges=True, field="random"):
    """Features ``fmap1 (B, H, W1, D)``, ``fmap2 (B, H, W2, D)`` and
    centers for a ``(B, H, W1, W2, D)`` level shape: ``field`` "random"
    (window_centers, with ``edges``) or "smooth" (smooth_centers)."""
    import torch
    b, h, w1, w2, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    f1 = torch.randn((b, h, w1, d), generator=g, device=device).to(dtype)
    f2 = torch.randn((b, h, w2, d), generator=g, device=device).to(dtype)
    if field == "smooth":
        return f1, f2, smooth_centers(b, h, w1, w2, g, device)
    return f1, f2, window_centers(b, h, w1, w2, g, device, edges)


def feature_pyramid(f2, n_levels):
    """``f2`` and its pools along W (ops/geometry.pool_w2), as the model's
    feature-pyramid state holds them: ``n_levels`` contiguous levels."""
    from raft_stereo_tpu_torch.ops.geometry import pool_w2
    levels = [f2]
    for _ in range(n_levels - 1):
        levels.append(pool_w2(levels[-1]).contiguous())
    return levels


def bound_ms(nbytes, flops, product_flops, product_dtype):
    """The least time (ms) the card needs for a function, and what sets
    it: its bytes over the memory rate, or its operations over the peaks
    of their types, whichever is longer. ``product_flops`` are the
    multiply-adds of a product whose operands are in ``product_dtype``
    (bf16: the tensor cores' rate); ``flops`` the rest, at the fp32 rate."""
    import torch
    peak = (BF16_FLOPS_PER_S if product_dtype == torch.bfloat16
            else FP32_FLOPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / FP32_FLOPS_PER_S + product_flops / peak) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fused_bytes_flops(f1, levels, center, backward=False):
    """Least bytes, flops and product flops of one fused_corr launch on
    these inputs; ``levels`` is one fmap2 level or a list of them, level i
    looked up around center / 2**i (the one-launch forward). Forward:
    fmap1 read once for all the levels, per level the fmap2 rows some
    in-range tap touches read once, the center read and the fp32 output
    written; 2*D product flops (on the features) per in-range tap and 3
    flops per output. Backward (one level): the same reads plus the fp32
    cotangent, df1 and df2 written whole; 4*D product flops per in-range
    tap (df1 and df2, read from the features; counted at the features'
    peak, as a bound may only err low) and 4 flops per tap for dg."""
    import torch
    if torch.is_tensor(levels):
        levels = [levels]
    b, h, w1, d = f1.shape
    k = 2 * RADIUS + 1
    es = f1.element_size()
    n_pix = center.numel()
    reads = f1.numel() * es + n_pix * 4
    n_valid = 0
    c0 = torch.nan_to_num(center, nan=0.0).clamp(-1e8, 1e8)
    for i, f2 in enumerate(levels):
        w2 = f2.shape[2]
        taps = torch.floor(c0 / (2 ** i)).long()[..., None] - RADIUS \
            + torch.arange(k + 1, device=c0.device)
        valid = (taps >= 0) & (taps < w2)
        n_valid += int(valid.sum().item())
        touched = torch.zeros((b, h, w2 + 1), dtype=torch.bool,
                              device=c0.device)
        touched.scatter_(2, torch.where(valid, taps, w2).reshape(b, h, -1),
                         True)
        reads += int(touched[..., :w2].sum().item()) * d * es
    n_out = n_pix * k * len(levels)
    if not backward:
        return reads + n_out * 4, n_out * 3, n_valid * 2 * d
    writes = (f1.numel() + sum(f2.numel() for f2 in levels)) * es
    return reads + n_pix * k * 4 + writes, n_valid * 4, n_valid * 4 * d


def alt_yardstick(f1, f2, center, ct=None):
    """The reference's own 'alt' formulation of the same function, several
    PyTorch calls: F.grid_sample of the fmap2 rows at the 2r+1 tap
    positions (bilinear, zeros, align_corners), then a product with fmap1
    and a sum over D, over sqrt(D). Returns a call computing it, or, with a
    cotangent ``ct``, a call taking its gradients in fmap1 and fmap2 by
    torch.autograd.grad on a prebuilt graph."""
    import torch
    import torch.nn.functional as F
    b, h, w1, d = f1.shape
    w2 = f2.shape[2]
    k = 2 * RADIUS + 1
    dx = torch.arange(-RADIUS, RADIUS + 1, device=f1.device,
                      dtype=torch.float32)
    x = (center.reshape(b * h, 1, w1, 1) + dx.view(1, 1, 1, k)).reshape(
        b * h, 1, w1 * k, 1)
    xn = 2.0 * x / max(w2 - 1, 1) - 1.0
    grid = torch.cat([xn, torch.zeros_like(xn)], dim=-1).to(f1.dtype)
    scale = 1.0 / math.sqrt(d)

    def fwd(a, bb):
        inp = bb.permute(0, 1, 3, 2).reshape(b * h, d, 1, w2)
        s = F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True).view(b * h, d, w1, k)
        lhs = a.reshape(b * h, w1, d).permute(0, 2, 1)[..., None]
        return ((s * lhs).sum(dim=1) * scale).view(b, h, w1, k)

    if ct is None:
        return lambda: fwd(f1, f2)
    a = f1.detach().requires_grad_()
    bb = f2.detach().requires_grad_()
    out = fwd(a, bb)
    cot = ct.to(out.dtype)
    return lambda: torch.autograd.grad(out, (a, bb), cot, retain_graph=True)


def ws_bytes_flops(levels, center, backward=False):
    """Least bytes and flops of one windowed_sample launch over ``levels``
    (one volume or a list; level i looked up around center / 2**i) on
    these inputs. Forward: the center read once, each level's in-range
    taps read once, the fp32 output written once; 4 flops per output
    ((1-f), two products, one sum). Backward as training runs it (no
    dcoords): every level's dense dvol written once, the fp32 cotangent
    and the center read once; 3 flops per in-range tap ((1-f)*ct_j,
    f*ct_{j-1}, one sum)."""
    import torch
    if torch.is_tensor(levels):
        levels = [levels]
    k = 2 * RADIUS + 1
    c = torch.nan_to_num(center, nan=0.0).clamp(-1e8, 1e8)
    n_pix = center.numel()
    in_range = 0
    for i, vol in enumerate(levels):
        base = torch.floor(c / (2 ** i)).long() - RADIUS
        taps = base[..., None] + torch.arange(k + 1, device=c.device)
        in_range += int(((taps >= 0) & (taps < vol.shape[-1])).sum().item())
    n_out = n_pix * k * len(levels)
    if not backward:
        es = levels[0].element_size()
        return n_pix * 4 + in_range * es + n_out * 4, n_out * 4
    dvol = sum(v.numel() * v.element_size() for v in levels)
    return dvol + n_out * 4 + n_pix * 4, in_range * 3


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


def within_bound(got, want, dtype):
    """Max abs error of ``got`` against ``want`` off their NaNs, and whether
    every element is within 1e-5 abs, or in bf16 within one bf16 ulp of
    ``want`` where that is larger; the NaN patterns must agree."""
    import torch
    nan = torch.isnan(want)
    same_nan = torch.equal(torch.isnan(got), nan)
    diff = (got.float() - want.float())[~nan].abs()
    ulp = want.float()[~nan].abs() * (
        2.0 ** -7 if dtype == torch.bfloat16 else 0.0)
    ok = same_nan and bool((diff <= torch.clamp(ulp, min=KERNEL_TOL)).all())
    return (diff.max().item() if diff.numel() else 0.0), ok


def bitwise(a, b):
    """Equal bit for bit, NaNs in the same places counting as equal."""
    import torch
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def run_feature_parity(dev, phase, kernel, fns, seed, against=None):
    """A feature-pyramid lookup's kernels (fused_corr or alt_corr: ``fns``
    = the forward's autograd Function, the backward launcher, plain
    forward, plain backward; ``kernel`` holds the launch counts) against
    their plain versions at every level shape of the hires and
    train_fused paths (and at W2 <= 2r+2), with the edge
    centers: the forward and df1/df2 within KERNEL_TOL (bf16 features: one
    bf16 ulp of the reference where that is larger), NaN patterns equal,
    far-out centers zero, and two runs of each kernel bitwise equal. With
    ``against`` (another kernel's forward and backward computing the same
    function), the same bounds against its results too."""
    import torch
    fwd, bwd, plain, plain_bwd = fns
    shapes = [("hires", torch.float32, s) for s in FUSED_SHAPES["hires"]]
    shapes += [("train_fused", torch.bfloat16, s)
               for s in FUSED_SHAPES["train_fused"]]
    shapes += [("narrow", torch.float32, (1, 4, 15, w, 256))
               for w in (7, 3, 1)]
    errs = dict(fwd=0.0, bwd=0.0, fwd_vs_other=0.0, bwd_vs_other=0.0)
    n_calls = 0
    before = (kernel.launches, kernel.bwd_launches)
    for i, (cfg_name, dtype, shape) in enumerate(shapes):
        f1, f2, center = fused_inputs(shape, dtype, seed + i, dev)
        g = torch.Generator(device=dev).manual_seed(seed + 10 + i)
        ct = torch.randn(tuple(center.shape) + (2 * RADIUS + 1,),
                         generator=g, device=dev)
        out = fwd(f1, f2, center, RADIUS)
        again = fwd(f1, f2, center, RADIUS)
        df1, df2 = bwd(f1, f2, center, ct, RADIUS)
        df1b, df2b = bwd(f1, f2, center, ct, RADIUS)
        n_calls += 2
        refs = [("", plain(f1, f2, center, RADIUS),
                 plain_bwd(f1, f2, center, ct, RADIUS))]
        if against:
            refs.append(("_vs_other", against[0](f1, f2, center, RADIUS),
                         against[1](f1, f2, center, ct, RADIUS)))
        torch.cuda.synchronize()
        row = {}
        for tag, want, (w1, w2) in refs:
            err_f, ok_f = within_bound(out, want, torch.float32)
            err_1, ok_1 = within_bound(df1, w1, dtype)
            err_2, ok_2 = within_bound(df2, w2, dtype)
            row.update({f"max_abs_err_fwd{tag}": err_f,
                        f"max_abs_err_df1{tag}": err_1,
                        f"max_abs_err_df2{tag}": err_2})
            check(ok_f, f"{phase}: forward differs{tag} at {cfg_name} "
                        f"{shape}")
            check(ok_1 and ok_2, f"{phase}: backward differs{tag} at "
                                 f"{cfg_name} {shape}")
            errs[f"fwd{tag}"] = max(errs[f"fwd{tag}"], err_f)
            errs[f"bwd{tag}"] = max(errs[f"bwd{tag}"], err_1,
                                          err_2)
        det = dict(fwd=bitwise(out, again), df1=bitwise(df1, df1b),
                   df2=bitwise(df2, df2b))
        emit(phase, config=cfg_name, shape=list(shape),
             dtype=str(dtype).replace("torch.", ""), **row,
             deterministic=det)
        check(bool(torch.isnan(out).any()), "the NaN center gave no NaN")
        check(all(det.values()), f"{phase}: kernels not deterministic at "
                                 f"{cfg_name} {shape}: {det}")
        check(bool((out.view(-1, 2 * RADIUS + 1)[6:8] == 0).all())
              and bool((df1.view(-1, shape[-1])[6:8] == 0).all()),
              "far-out centers are not zero")
        del f1, f2, out, again, df1, df2, df1b, df2b, refs
    check((kernel.launches - before[0],
           kernel.bwd_launches - before[1]) == (n_calls, n_calls),
          f"{phase}: the parity calls did not launch the kernels")
    return errs


def run_pyramid_parity(dev, phase, kernel, pyramid, pyramid_plain, one_level,
                       bitwise_plain=False):
    """A one-launch forward over 1 to 4 pyramid levels (level i around
    center / 2**i; fused_corr's or alt_corr's: ``kernel`` holds the launch
    count), through the autograd Function the model calls (``pyramid``),
    against its plain version (``pyramid_plain``, the levels' plain
    lookups concatenated): the hires pyramid (fp32, 4 levels), the
    train_fused pyramid (bf16, 1 to 4 levels), the train pyramid on smooth
    centers, and a narrow pyramid whose last levels have W2 <= 2r+2, with
    the edge centers (random fields). Within KERNEL_TOL (with
    ``bitwise_plain``, bitwise equal), NaN patterns equal, far-out centers
    zero, two runs bitwise equal, bitwise equal to the one-level launches
    (``one_level``) concatenated, and one launch a call."""
    import torch
    err = 0.0
    cases = [("hires", torch.float32, FUSED_SHAPES["hires"][0], "random",
              (4,)),
             ("train_fused", torch.bfloat16, FUSED_SHAPES["train_fused"][0],
              "random", (1, 2, 3, 4)),
             ("train_fused", torch.bfloat16, FUSED_SHAPES["train_fused"][0],
              "smooth", (4,)),
             ("narrow", torch.float32, (1, 4, 15, 15, 256), "random", (4,))]
    for i, (cfg_name, dtype, shape, field, counts) in enumerate(cases):
        f1, f2, center = fused_inputs(shape, dtype, SEED + 70 + i, dev,
                                      field=field)
        levels = feature_pyramid(f2, 4)
        for n in counts:
            before = kernel.launches
            out = pyramid(f1, levels[:n], center, RADIUS)
            again = pyramid(f1, levels[:n], center, RADIUS)
            check(kernel.launches - before == 2,
                  f"{phase}: not one launch a call")
            ones = torch.cat([one_level(f1, lv, center / (2 ** j), RADIUS)
                              for j, lv in enumerate(levels[:n])], dim=-1)
            want = pyramid_plain(f1, levels[:n], center, RADIUS)
            torch.cuda.synchronize()
            e, ok = within_bound(out, want, torch.float32)
            det = bitwise(out, again)
            same = bitwise(out, ones)
            same_plain = bitwise(out, want)
            emit(phase, config=cfg_name, field=field,
                 shape=list(shape), levels=[lv.shape[2] for lv in
                                            levels[:n]],
                 dtype=str(dtype).replace("torch.", ""), max_abs_err=e,
                 deterministic=det, bitwise_vs_one_level_launches=same,
                 bitwise_vs_plain=same_plain)
            check(ok and (same_plain or not bitwise_plain),
                  f"{phase}: differs from plain at {cfg_name} {field} {n}")
            check(det and same, f"{phase} at {cfg_name} {field} {n}: "
                                f"deterministic {det}, equal to the "
                                f"one-level launches {same}")
            if field == "random":
                k = 2 * RADIUS + 1
                check(bool(torch.isnan(out).any())
                      and bool((out.view(-1, n * k)[6:8] == 0).all()),
                      f"{phase}: NaN or far-out centers mishandled")
            err = max(err, e)
            del out, again, ones, want
        del f1, f2, levels, center
    return err


def run_ws_pyramid_parity(dev, ws):
    """windowed_sample's one-launch pyramid (``ws``: the module), forward
    and backward, against its plain versions: the default (fp32), realtime
    and train (bf16) pyramids with 4 levels, the train pyramid with 1 to 3,
    a narrow pyramid down to W2 <= 2r+2 and a ragged one whose last tile is
    short, with the edge centers: forward and every level's dvol bitwise
    equal (NaN patterns included), dcoords within KERNEL_TOL, far-out
    centers zero, two runs bitwise equal, bitwise equal to the one-level
    launches, and one launch a call each way. Returns the max abs errors
    (forward, dvol, dcoords)."""
    import torch
    errs = dict(fwd=0.0, dvol=0.0, dcoords=0.0)
    k = 2 * RADIUS + 1
    cases = [("default", torch.float32, (1, 96, 312, 312), (4,)),
             ("realtime", torch.bfloat16, (1, 48, 156, 156), (4,)),
             ("train", torch.bfloat16, (8, 80, 180, 180), (1, 2, 3, 4)),
             ("narrow", torch.float32, (1, 4, 15, 15), (4,)),
             ("ragged", torch.bfloat16, (1, 3, 37, 37), (4,))]
    for i, (cfg_name, dtype, shape, counts) in enumerate(cases):
        b, h, w1, w2 = shape
        g = torch.Generator(device=dev).manual_seed(SEED + 180 + i)
        pyramid = [torch.randn((b, h, w1, w2 >> j), generator=g,
                               device=dev).to(dtype) for j in range(4)]
        center = window_centers(b, h, w1, w2, g, dev)
        ct_all = torch.randn((b, h, w1, 4 * k), generator=g, device=dev)
        for n in counts:
            levels, ct = pyramid[:n], ct_all[..., :n * k].contiguous()
            before = (ws.windowed_sample.launches,
                      ws.windowed_sample.bwd_launches)
            out = ws.windowed_sample_pyramid_forward(levels, center, RADIUS)
            again = ws.windowed_sample_pyramid_forward(levels, center,
                                                       RADIUS)
            dvols, dc = ws.windowed_sample_pyramid_backward(
                levels, center, ct, RADIUS)
            dvols2, dc2 = ws.windowed_sample_pyramid_backward(
                levels, center, ct, RADIUS)
            check((ws.windowed_sample.launches - before[0],
                   ws.windowed_sample.bwd_launches - before[1]) == (2, 2),
                  f"ws_pyramid_parity: not one launch a call at {cfg_name}")
            ones = torch.cat([ws.windowed_sample_forward(
                v, center / (2 ** j), RADIUS) for j, v in enumerate(levels)],
                dim=-1)
            ones_dvol = [ws.windowed_sample_backward(
                v, center / (2 ** j), ct[..., j * k:(j + 1) * k], RADIUS,
                need_dcoords=False)[0] for j, v in enumerate(levels)]
            want = ws.windowed_sample_pyramid_plain(levels, center, RADIUS)
            want_dvols, want_dc = ws.windowed_sample_pyramid_backward_plain(
                levels, center, ct, RADIUS)
            torch.cuda.synchronize()
            err_f, _ = within_bound(out, want, torch.float32)
            err_v = max(within_bound(a, w, dtype)[0]
                        for a, w in zip(dvols, want_dvols))
            err_c, ok_c = within_bound(dc, want_dc, torch.float32)
            row = dict(
                fwd_bitwise_vs_plain=bitwise(out, want),
                dvol_bitwise_vs_plain=all(bitwise(a, w) for a, w in
                                          zip(dvols, want_dvols)),
                deterministic=bitwise(out, again) and bitwise(dc, dc2)
                and all(bitwise(a, c) for a, c in zip(dvols, dvols2)),
                bitwise_vs_one_level_launches=bitwise(out, ones) and all(
                    bitwise(a, c) for a, c in zip(dvols, ones_dvol)))
            emit("ws_pyramid_parity", config=cfg_name, shape=list(shape),
                 levels=[v.shape[-1] for v in levels],
                 dtype=str(dtype).replace("torch.", ""), max_abs_err=err_f,
                 max_abs_err_dvol=err_v, max_abs_err_dcoords=err_c, **row)
            check(all(row.values()) and ok_c,
                  f"ws_pyramid_parity at {cfg_name} {n} levels: {row}, "
                  f"dcoords within {KERNEL_TOL}: {ok_c}")
            check(bool(torch.isnan(out).any())
                  and bool((out.view(-1, n * k)[6:8] == 0).all())
                  and all(bool((a.view(-1, a.shape[-1])[6:8] == 0).all())
                          for a in dvols),
                  "ws_pyramid_parity: NaN or far-out centers mishandled")
            errs = dict(fwd=max(errs["fwd"], err_f),
                        dvol=max(errs["dvol"], err_v),
                        dcoords=max(errs["dcoords"], err_c))
            del out, again, dvols, dvols2, ones, ones_dvol, want, want_dvols
        del pyramid, center, ct_all
    return errs


def run_wide_backward(dev, fc):
    """fused_corr's backward kernels on rows of WIDE_BWD_SHAPE (W1 = W2 =
    4000: the row is tiled over W2 across blocks; the first df2 kernel held
    a whole row in one block's shared memory and refused rows this wide),
    fp32 and bf16, random centers with the edge values, against the plain
    version: the bounds of run_feature_parity, and two runs bitwise
    equal."""
    import torch
    err = 0.0
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        f1, f2, center = fused_inputs(WIDE_BWD_SHAPE, dtype, SEED + 160 + i,
                                      dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 165 + i)
        ct = torch.randn(tuple(center.shape) + (2 * RADIUS + 1,),
                         generator=g, device=dev)
        before = fc.fused_corr.bwd_launches
        df1, df2 = fc.fused_corr_backward(f1, f2, center, ct, RADIUS)
        df1b, df2b = fc.fused_corr_backward(f1, f2, center, ct, RADIUS)
        w1, w2 = fc.fused_corr_backward_plain(f1, f2, center, ct, RADIUS)
        torch.cuda.synchronize()
        check(fc.fused_corr.bwd_launches - before == 2,
              "fused_bwd_wide: the backward kernels did not launch")
        e1, ok1 = within_bound(df1, w1, dtype)
        e2, ok2 = within_bound(df2, w2, dtype)
        det = bitwise(df1, df1b) and bitwise(df2, df2b)
        emit("fused_bwd_wide", shape=list(WIDE_BWD_SHAPE),
             dtype=str(dtype).replace("torch.", ""), max_abs_err_df1=e1,
             max_abs_err_df2=e2, deterministic=det)
        check(ok1 and ok2, f"fused_bwd_wide: differs from plain in {dtype}")
        check(det, f"fused_bwd_wide: not deterministic in {dtype}")
        err = max(err, e1, e2)
        del f1, f2, center, ct, df1, df2, df1b, df2b, w1, w2
    return err


def run_feature_memory(dev, phase, impl, backward):
    """The memory contract of a feature-pyramid implementation (``fused``
    or ``alt_pallas``): the 4-level lookup at the hires shape allocates no
    more than its outputs (the levels' and their concatenation) plus an
    eighth of one level-0 volume, and a backward (``backward``, the
    kernel's launcher) at level 0 no more than df1 + df2 plus that margin,
    at the hires and the train shapes."""
    import torch
    from raft_stereo_tpu_torch.ops.corr import corr_lookup, init_corr
    b, h, w1, w2, d = FUSED_SHAPES["hires"][0]
    margin = b * h * w1 * w2 * 4 // 8
    f1, f2, center = fused_inputs((b, h, w1, w2, d), torch.float32,
                                  SEED + 80, dev, edges=False)
    state = init_corr(impl, f1, f2, num_levels=4, radius=RADIUS)
    coords = torch.stack([center, torch.zeros_like(center)], dim=-1)
    rows = {}

    def measure(name, fn, own):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated(dev) - base
        rows[name] = dict(extra_bytes=extra, own_output_bytes=own,
                          limit_bytes=own + margin)
        check(extra <= own + margin, f"{phase} {name}: {extra} bytes "
                                     f"above the {own + margin} allowed")
        return out
    with torch.no_grad():
        out = measure("lookup_4_levels", lambda: corr_lookup(state, coords),
                      2 * b * h * w1 * 4 * (2 * RADIUS + 1) * 4)
    del out
    ct = torch.randn(tuple(center.shape) + (2 * RADIUS + 1,), device=dev)
    grads = measure("backward_level0", lambda: backward(
        f1, f2, center, ct, RADIUS), (f1.numel() + f2.numel()) * 4)
    del grads
    tb = FUSED_SHAPES["train_fused"][0]
    f1, f2, center = fused_inputs(tb, torch.bfloat16, SEED + 81, dev,
                                  edges=False)
    ct = torch.randn(tuple(center.shape) + (2 * RADIUS + 1,), device=dev)
    grads = measure("backward_train_level0", lambda: backward(
        f1, f2, center, ct, RADIUS), (f1.numel() + f2.numel()) * 2)
    emit(phase, impl=impl, margin_bytes=margin,
         level0_volume_bytes=8 * margin, **rows)
    return rows


def feature_timing(flush, backward, cfg_name, dtype, shape, seed, dev,
                   kernel_fn, plain_fn, field="random", n_levels=0,
                   full=True):
    """One row for a feature-lookup kernel (fused_corr or alt_corr, one
    function): the kernel's time per call (forward ``fn(f1, f2, center,
    R)``, or backward ``fn(f1, f2, center, ct, R)``; with ``n_levels`` the
    one-launch forward ``fn(f1, levels, center, R)`` over that many pooled
    levels of ``shape``'s fmap2) on the ``field`` centers (fused_inputs),
    and its bound (fused_bytes_flops). With ``full``, also the plain
    version's time and the reference's several-call 'alt' formulation as a
    yardstick (alt_yardstick, per level)."""
    import torch
    f1, f2, center = fused_inputs(shape, dtype, seed, dev, edges=False,
                                  field=field)
    levels = feature_pyramid(f2, n_levels) if n_levels else [f2]
    ct = None
    if backward:
        g = torch.Generator(device=dev).manual_seed(seed + 5)
        ct = torch.randn(tuple(center.shape) + (2 * RADIUS + 1,),
                         generator=g, device=dev)
        args = (f1, f2, center, ct, RADIUS)
    elif n_levels:
        args = (f1, levels, center, RADIUS)
    else:
        args = (f1, f2, center, RADIUS)
    nbytes, flops, product = fused_bytes_flops(f1, levels, center,
                                               backward=backward)
    bound, bound_by = bound_ms(nbytes, flops, product, dtype)
    row = dict(config=cfg_name, field=field, shape=list(shape),
               levels=[lv.shape[2] for lv in levels],
               dtype=str(dtype).replace("torch.", ""),
               ms=cuda_ms(lambda: kernel_fn(*args), flush),
               bound_ms=bound, bound_by=bound_by,
               bytes=nbytes, flops=flops + product)
    if full:
        yards = [alt_yardstick(f1, lv, center / (2 ** i), ct)
                 for i, lv in enumerate(levels)]

        def yard():
            return [y() for y in yards]
        got, want = yard(), plain_fn(*args)
        if backward:
            got = got[0]
        else:
            got, want = (torch.cat(got, dim=-1),), (want,)
        yard_err = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(got, want))
        del got, want
        row.update(plain_ms=cuda_ms(lambda: plain_fn(*args), flush),
                   yardstick_ms=cuda_ms(yard, flush),
                   yardstick_max_abs_diff=yard_err)
        del yards
    del f1, f2, levels, center, ct
    return row


def lookup_c1_inputs(shape, vdt, seed, device, edges=True):
    """A 4-level volume pyramid ``(B, H, W1, W2 >> i)`` in ``vdt``, lookup
    centers (window_centers: the edge centers at flat positions 0-10, NaN
    at 9), and a convc1 kernel (36, 64) and bias (64,) in fp32."""
    import torch
    b, h, w1, w2 = shape
    g = torch.Generator(device=device).manual_seed(seed)
    levels = [torch.randn((b, h, w1, w2 >> i), generator=g,
                          device=device).to(vdt) for i in range(4)]
    coords = window_centers(b, h, w1, w2, g, device, edges)
    kern = torch.randn((4 * (2 * RADIUS + 1), 64), generator=g,
                       device=device) * 0.2
    bias = torch.randn((64,), generator=g, device=device) * 0.1
    return levels, coords, kern, bias


def rel_dev(got, want):
    """Max abs deviation over the reference's largest magnitude."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def run_fused_lookup_parity(dev, fl):
    """fused_lookup's kernels against their plain versions at the default,
    realtime and train shapes with the edge centers: the output and every
    dvol bitwise equal (both sum in one order; NaN patterns equal), also
    reported as the error within KERNEL_TOL (bf16: one bf16 ulp of the
    plain value where that is larger), far-out centers giving relu(bias)
    and zero dvol rows; dk/db (on finite centers: one NaN center makes all
    of dk NaN) within 1e-5 of their largest magnitude; two runs of each
    kernel bitwise equal."""
    import torch
    errs = dict(fwd=0.0, dvol=0.0, dk_db_rel=0.0)
    n_calls = 0
    before = (fl.fused_lookup_c1.launches, fl.fused_lookup_c1.bwd_launches)
    for i, (cfg_name, (vname, dname, shape)) in enumerate(LOOKUP_C1.items()):
        vdt, dt = getattr(torch, vname), getattr(torch, dname)
        levels, coords, kern, bias = lookup_c1_inputs(shape, vdt,
                                                      SEED + 120 + i, dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 130 + i)
        ct = torch.randn(shape[:3] + (64,), generator=g, device=dev).to(dt)
        finite = coords.nan_to_num(0.0)
        out = fl.fused_lookup_c1(levels, coords, kern, bias, RADIUS, dt)
        again = fl.fused_lookup_c1(levels, coords, kern, bias, RADIUS, dt)
        dv, _, _ = fl.fused_lookup_backward(levels, coords, kern, bias, ct,
                                            RADIUS, dt)
        dvb, _, _ = fl.fused_lookup_backward(levels, coords, kern, bias, ct,
                                             RADIUS, dt)
        _, dk, db = fl.fused_lookup_backward(levels, finite, kern, bias, ct,
                                             RADIUS, dt)
        _, dkb, dbb = fl.fused_lookup_backward(levels, finite, kern, bias,
                                               ct, RADIUS, dt)
        n_calls += 2
        want = fl.fused_lookup_c1_plain(levels, coords, kern, bias, RADIUS,
                                        dt)
        w_dv, _, _ = fl.fused_lookup_c1_backward_plain(
            levels, coords, kern, bias, ct, RADIUS, dt)
        _, w_dk, w_db = fl.fused_lookup_c1_backward_plain(
            levels, finite, kern, bias, ct, RADIUS, dt)
        torch.cuda.synchronize()
        err_f, ok_f = within_bound(out, want, dt)
        dvol = [within_bound(a, b, vdt) for a, b in zip(dv, w_dv)]
        rel = max(rel_dev(dk, w_dk), rel_dev(db, w_db))
        det = dict(fwd=bitwise(out, again),
                   dvol=all(bitwise(a, b) for a, b in zip(dv, dvb)),
                   dk_db=torch.equal(dk, dkb) and torch.equal(db, dbb))
        bitwise_plain = dict(fwd=bitwise(out, want),
                             dvol=[bitwise(a, b) for a, b in zip(dv, w_dv)])
        emit("fused_lookup_parity", config=cfg_name, shape=list(shape),
             volume_dtype=vname, compute_dtype=dname, max_abs_err_fwd=err_f,
             max_abs_err_dvol=[e for e, _ in dvol], rel_err_dk_db=rel,
             bitwise_vs_plain=bitwise_plain, deterministic=det)
        check(ok_f and bool(torch.isnan(out).any()),
              f"fused_lookup forward differs at {cfg_name}")
        check(all(ok for _, ok in dvol),
              f"fused_lookup dvol differs at {cfg_name}")
        check(bitwise_plain["fwd"] and all(bitwise_plain["dvol"]),
              f"fused_lookup forward or dvol not bitwise equal to plain at "
              f"{cfg_name}: {bitwise_plain}")
        check(rel <= KERNEL_TOL, f"fused_lookup dk/db differ by {rel} "
                                 f"relative at {cfg_name}")
        check(all(det.values()), f"fused_lookup kernels not deterministic "
                                 f"at {cfg_name}: {det}")
        check(bool((out.view(-1, 64)[6:8] == torch.relu(bias).to(dt)).all())
              and all(bool((d.view(-1, d.shape[-1])[6:8] == 0).all())
                      for d in dv), "far-out centers looked up taps")
        errs["fwd"] = max(errs["fwd"], err_f)
        errs["dvol"] = max([errs["dvol"]] + [e for e, _ in dvol])
        errs["dk_db_rel"] = max(errs["dk_db_rel"], rel)
        del levels, out, again, dv, dvb, want, w_dv
    check((fl.fused_lookup_c1.launches - before[0],
           fl.fused_lookup_c1.bwd_launches - before[1])
          == (n_calls, 2 * n_calls),
          "the parity calls did not launch the fused_lookup kernels")
    return errs


def lookup_c1_bytes_flops(levels, coords, dt, backward=False):
    """Least bytes, flops and product flops of one fused_lookup launch on
    these inputs; the products (corr x k, and in the backward dk and dcorr)
    take operands in dt. Forward: the centers and each level's in-range
    taps read once, the kernel and bias read, the 64-channel output
    written in dt; per pixel 3 flops per blended value, 2 product flops per
    term of the 36x64 product, 2 flops per channel for the bias and the
    ReLU. Backward: the same reads plus the cotangent, every dvol written
    whole and dk/db; the forward's flops plus the mask, db and the 3 flops
    per window tap of dg, and the product flops of dk and dcorr."""
    import torch
    n_pix = coords.numel()
    k = 2 * RADIUS + 1
    c_ch = 4 * k
    c = torch.nan_to_num(coords, nan=0.0).clamp(-1e8, 1e8)
    taps = 0
    for i, v in enumerate(levels):
        base = torch.floor(c / (2 ** i)).long() - RADIUS
        idx = base[..., None] + torch.arange(k + 1, device=c.device)
        taps += int(((idx >= 0) & (idx < v.shape[-1])).sum().item())
    es_v = levels[0].element_size()
    es_dt = torch.empty((), dtype=dt).element_size()
    reads = n_pix * 4 + taps * es_v + (c_ch * 64 + 64) * 4
    flops = n_pix * (c_ch * 3 + 64 * 2)
    product = n_pix * c_ch * 64 * 2
    if not backward:
        return reads + n_pix * 64 * es_dt, flops, product
    writes = sum(v.numel() for v in levels) * es_v + (c_ch * 64 + 64) * 4
    return (reads + n_pix * 64 * es_dt + writes,
            flops + n_pix * (64 + 64 + 4 * (k + 1) * 3),
            product + n_pix * (c_ch * 64 * 2 + 64 * c_ch * 2))


def lookup_c1_yardstick(levels, coords, kern, bias, dt, ct=None):
    """The unfused formulation as PyTorch calls: F.grid_sample of each
    level at its 2r+1 tap positions (bilinear, zeros, align_corners), the
    4 levels concatenated, a 1x1 F.conv2d in dt and a ReLU. Returns a call
    computing it or, with a cotangent ``ct``, a call taking its gradients
    in the levels, the kernel and the bias by torch.autograd.grad on a
    prebuilt graph."""
    import torch
    import torch.nn.functional as F
    dx = torch.arange(-RADIUS, RADIUS + 1, device=coords.device,
                      dtype=torch.float32)
    grids = []
    for i, v in enumerate(levels):
        x = (coords / (2 ** i)).reshape(-1, 1, 1, 1) + dx.view(1, 1, -1, 1)
        xn = 2.0 * x / max(v.shape[-1] - 1, 1) - 1.0
        grids.append(torch.cat([xn, torch.zeros_like(xn)], dim=-1).to(
            v.dtype))
    c_ch = kern.shape[0]

    def fwd(lv, k, b):
        corr = torch.cat([F.grid_sample(
            v.reshape(-1, 1, 1, v.shape[-1]), grid, mode="bilinear",
            padding_mode="zeros", align_corners=True).view(
                *v.shape[:3], 2 * RADIUS + 1)
            for v, grid in zip(lv, grids)], dim=-1).to(dt)
        y = F.conv2d(corr.permute(0, 3, 1, 2),
                     k.t().reshape(64, c_ch, 1, 1).to(dt), b.to(dt))
        return torch.relu(y).permute(0, 2, 3, 1)

    if ct is None:
        return lambda: fwd(levels, kern, bias)
    lv = [v.detach().requires_grad_() for v in levels]
    k = kern.detach().requires_grad_()
    b = bias.detach().requires_grad_()
    out = fwd(lv, k, b)
    return lambda: torch.autograd.grad(out, (*lv, k, b), ct.to(out.dtype),
                                       retain_graph=True)


def device_kernels(fn):
    """The device kernels one ``fn()`` call launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def run_hires(dev, fc, windowed_sample, model_seed):
    """The hires path: the default architecture with alt_cuda through
    StereoPredictor on a 1988x2880 pair (padded to 2016x2880), 32
    iterations; and the peak memory of alt_cuda against reg_cuda on the
    same pair at 2 iterations."""
    import numpy as np
    import torch
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.inference import StereoPredictor
    from raft_stereo_tpu_torch.models import RAFTStereo
    h, w, iters = HIRES_H, HIRES_W, 32
    left, right = stereo_pair(h, w, SEED + 5, shift=24)
    cfg = RAFTStereoConfig(corr_implementation="alt_cuda")
    state = seeded_weights(RAFTStereo(cfg), model_seed)
    pred = StereoPredictor(cfg, state, valid_iters=iters, device=dev)
    pred(left, right, iters=2)  # warm-up: cuDNN autotuning, allocator
    fc.fused_corr.launches = 0
    windowed_sample.launches = 0
    flow, _ = pred.predict_timed(left, right)
    launches = (fc.fused_corr.launches, windowed_sample.launches)
    want = (iters, 0)  # one fused_corr launch for the four levels
    check(launches == want, f"hires: (fused_corr, windowed_sample) "
                            f"launches {launches}, expected {want}")
    check(flow.shape == (1, h, w, 1), f"hires: shape {flow.shape}")
    check(bool(np.isfinite(flow).all()), "hires: non-finite output")
    secs = [pred.predict_timed(left, right)[1] for _ in range(HIRES_RUNS)]
    # one profiled iteration: no FFT convolution (cuDNN's heuristic once
    # launched ~99,000 FFT kernels an iteration here); one profiled frame:
    # its device time beside the wall time
    one_it = device_kernels(lambda: pred(left, right, iters=1))
    fft = sum("fft" in e.name.lower() for e in one_it)
    check(fft == 0, f"hires: {fft} FFT kernels in one iteration")
    frame = device_kernels(lambda: pred(left, right))
    peaks = {}
    for impl in ("alt_cuda", "reg_cuda"):
        p = pred if impl == "alt_cuda" else StereoPredictor(
            RAFTStereoConfig(corr_implementation=impl), state,
            valid_iters=2, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        p(left, right, iters=2)
        torch.cuda.synchronize()
        peaks[impl] = torch.cuda.max_memory_allocated(dev)
        del p
    del pred
    result = dict(padded=[2016, 2880], iters=iters, launches=launches[0],
                  launches_windowed_sample=launches[1],
                  ms_per_frame_median=statistics.median(secs) * 1e3,
                  ms_per_frame_runs=[s * 1e3 for s in secs],
                  device_ms_per_frame=sum(e.time_range.elapsed_us()
                                          for e in frame) / 1e3,
                  kernels_per_frame=len(frame),
                  kernels_one_iteration=len(one_it),
                  fft_kernels_one_iteration=fft,
                  peak_mem_bytes_2it=peaks,
                  disparity_range=[float(-flow.max()), float(-flow.min())])
    emit("hires", **result)
    check(peaks["alt_cuda"] < peaks["reg_cuda"],
          f"hires: alt_cuda's peak {peaks['alt_cuda']} is not below "
          f"reg_cuda's {peaks['reg_cuda']}")
    return result, state


def run_train(dev, impl, kernel, others, model_seed, phase="train",
              per_iter_bwd=1, **overrides):
    """Timed training steps at the SceneFlow recipe's shape with ``impl``
    (and the config ``overrides``): each step launches ``kernel``'s forward
    once an iteration (22 times, one launch for the four levels) and as
    many again recomputed, its backward ``per_iter_bwd`` x 22 times, and
    the kernels of ``others`` never. For reg_cuda (phase "train"), then an
    injected NaN step."""
    import torch
    from raft_stereo_tpu_torch.config import sceneflow_config
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.training.optim import fetch_optimizer
    from raft_stereo_tpu_torch.training.state import (TrainState,
                                                      make_train_step)
    mcfg, tcfg = sceneflow_config()
    mcfg = dataclasses.replace(mcfg, corr_implementation=impl, **overrides)
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
    want = (2 * iters, per_iter_bwd * iters)
    secs, losses, norms = [], [], []
    for _ in range(TRAIN_STEPS):
        for k in (kernel, *others):
            k.launches = k.bwd_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got = (kernel.launches, kernel.bwd_launches)
        check(got == want, f"{phase}: (forward incl. recompute, backward) "
                           f"launches {got}, expected {want}")
        check(all((k.launches, k.bwd_launches) == (0, 0) for k in others),
              f"{phase}: launched another implementation's kernels")
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        check(float(m["skipped_updates"]) == 0.0, f"{phase}: update skipped")
    check(all(map(math.isfinite, losses + norms)),
          f"{phase}: loss {losses} or grad norm {norms} not finite")
    moved = sum(bool((p != p0).any())
                for p, p0 in zip(model.parameters(), start))
    n_leaves = len(start)
    check(moved >= 0.9 * n_leaves, f"{phase}: only {moved} of {n_leaves} "
                                   "parameter leaves moved")
    ms = statistics.median(secs) * 1e3
    label = " + ".join([f"sceneflow_config() + {impl}"]
                       + [f"{k}={v}" for k, v in overrides.items()])
    result = dict(config=label, batch=b,
                  image_size=[h, w], iters=iters,
                  launches_fwd=want[0], launches_bwd=want[1],
                  ms_per_step_median=ms, ms_per_step_runs=[s * 1e3
                                                           for s in secs],
                  pairs_per_s=b / (ms / 1e3),
                  peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                  loss=losses, grad_norm=norms, leaves_moved=moved,
                  leaves=n_leaves, lr_position=opt.count)
    emit(phase, **result)
    if phase != "train":
        return result

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


def train_cpu_parity(dev, impl, kernel, state, modes, size=(64, 160),
                     launches=(16, 8), **overrides):
    """One fp32 training step of the default architecture with ``impl``
    (and the config ``overrides``) at ``size``, 2 iterations, on the card
    (``kernel``'s kernels, ``launches`` forward and backward) against the
    CPU (plain versions), in each cuDNN mode of ``modes``, gated by
    check_grad_parity over NULL_RUNS CPU null runs."""
    import torch
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.training.state import loss_and_grads
    cfg = RAFTStereoConfig(corr_implementation=impl, **overrides)
    on_cpu = RAFTStereo(cfg)
    on_cpu.load_state_dict(state, strict=True)
    on_gpu = RAFTStereo(cfg)
    on_gpu.load_state_dict(state, strict=True)
    on_gpu.to(dev)
    batch = train_batch(1, *size, SEED + 4, "cpu", max_disp=16.0)
    loss_c, _, grads_c = loss_and_grads(on_cpu, batch, 2)
    nulls = [loss_and_grads(perturbed_copy(on_cpu, NULL_PERTURBATION,
                                           SEED + i), batch, 2)[2]
             for i in range(NULL_RUNS)]
    names = [n for n, _ in on_cpu.named_parameters()]
    runs = {}
    try:
        for label, cudnn in modes:
            torch.backends.cudnn.enabled = cudnn
            kernel.launches = kernel.bwd_launches = 0
            loss_g, _, grads_g = loss_and_grads(on_gpu, batch, 2)
            torch.cuda.synchronize()
            got = (kernel.launches, kernel.bwd_launches)
            check(got == tuple(launches), f"card step ({impl}) launches "
                                          f"{got} != {tuple(launches)}")
            runs[label] = dict(
                loss_rel_dev=abs(float(loss_g) - float(loss_c))
                / abs(float(loss_c)),
                **check_grad_parity(names, [g.cpu() for g in grads_g],
                                    grads_c, nulls))
    finally:
        torch.backends.cudnn.enabled = True
    return runs


# ---------------------------------------------------- training schedules

# (name, config fields, fused loss, B1 forward launches a step): the JAX
# package's training schedules at the SceneFlow recipe, "default" today's
# (the auto save policy does not engage at batch 8: full per-iteration
# recompute, 22 + 22 forward launches; a save policy keeps the lookups and
# launches 22)
TRAIN_SCHEDULES = (
    ("default", {}, False, 44),
    ("batched_scan_wgrad", {"batched_scan_wgrad": True}, False, 44),
    ("policy_on", {"refinement_save_policy": True}, False, 22),
    ("policy_corr", {"refinement_save_policy": "corr"}, False, 22),
    ("batched_policy_on", {"batched_scan_wgrad": True,
                           "refinement_save_policy": True}, False, 22),
    ("policy_on_residual_bf16", {"refinement_save_policy": True,
                                 "residual_dtype": "bfloat16"}, False, 22),
    ("in_loop_upsample", {"deferred_upsample": False}, False, 44),
    ("no_remat_loss_tail", {"remat_loss_tail": False}, False, 44),
    ("fused_loss", {}, True, 44),
    ("fused_loss_one_shot", {"upsample_tile_budget": 2 ** 31}, True, 44),
    ("fused_loss_no_tail_remat", {"remat_loss_tail": False}, True, 44),
    ("fused_loss_in_loop", {"deferred_upsample": False}, True, 44),
    ("remat_encoders", {"remat_encoders": True}, False, 44),
    ("remat_encoders_blocks", {"remat_encoders": "blocks"}, False, 44),
    ("remat_encoders_blocks_hires", {"remat_encoders": "blocks_hires"},
     False, 44),
    ("remat_encoders_norms", {"remat_encoders": "norms"}, False, 44),
)
SCHEDULE_LOSS_TOL = 2.0 ** -8  # bf16's relative precision
SCHEDULE_STEPS = 1             # timed steps a schedule, after a warm-up
                               # (the profiled step's device ms is the
                               # figure: a step's wall follows the host)
GATE_WEIGHTS = ("convz.weight", "convr.weight", "convq.weight")


def device_split(kernels):
    """Device ms of profiled kernels (device_kernels) by kind: the lookup
    kernels, the convolutions, matmuls, and the rest (PyTorch's
    elementwise, reduction and copy kernels);
    scripts/profile_torch_main_path.py's categories."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    from profile_torch_main_path import category
    split = {"lookup": 0.0, "convolution": 0.0, "matmul": 0.0,
             "elementwise": 0.0}
    kind = {"convolution": "convolution", "matmul": "matmul",
            "other": "elementwise"}
    for e in kernels:
        split[kind.get(category(e.name), "lookup")] += (
            e.time_range.elapsed_us() / 1e3)
    split["total"] = sum(split.values())
    return split


def schedule_run(dev, mcfg, tcfg, state, batch, fused_loss, kernels,
                 timed=True):
    """One schedule: the loss and gradients of one step on ``state``'s
    weights (the launches of each of ``kernels`` counted); then, ``timed``,
    a warm-up and SCHEDULE_STEPS timed optimizer steps (ms/step, peak
    memory above what was resident before the steps) and one profiled
    step (device_split, and the idle share of its kernels' span)."""
    import torch
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.training.optim import fetch_optimizer
    from raft_stereo_tpu_torch.training.state import (TrainState,
                                                      loss_and_grads,
                                                      make_train_step)
    model = RAFTStereo(mcfg)
    model.load_state_dict(state, strict=True)
    model.to(dev)
    for k in kernels:
        k.launches = k.bwd_launches = 0
    loss, _, grads = loss_and_grads(model, batch, tcfg.train_iters,
                                    fused_loss=fused_loss)
    torch.cuda.synchronize()
    launches = [(k.launches, k.bwd_launches) for k in kernels]
    if not timed:
        del model
        return dict(loss=float(loss), grads=grads, launches=launches)
    opt = fetch_optimizer(tcfg, model.parameters())
    st = TrainState(model, opt)
    step = make_train_step(model, opt, tcfg.train_iters,
                           fused_loss=fused_loss)
    st, _ = step(st, batch)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    secs = []
    for _ in range(SCHEDULE_STEPS):
        t0 = time.perf_counter()
        st, m = step(st, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        check(float(m["skipped_updates"]) == 0.0, "schedule step skipped")
    out = dict(loss=float(loss), grads=grads, launches=launches,
               ms_per_step_median=statistics.median(secs) * 1e3,
               ms_per_step_runs=[x * 1e3 for x in secs],
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev)
               - resident)
    box = [st]

    def one_step():
        box[0], _ = step(box[0], batch)
    found = device_kernels(one_step)
    split = device_split(found)
    out.update(device_ms=split, elementwise_share=(
        split["elementwise"] / split["total"] if split["total"] else None),
        kernels_per_step=len(found),
        idle_share=(1.0 - split["total"] * 1e3 / (
            max(e.time_range.end for e in found)
            - min(e.time_range.start for e in found)) if found else None))
    del st, box, step, opt, model
    return out


def schedule_nulls(dev, mcfg, tcfg, state, batch):
    """NULL_RUNS gradients of today's schedule with every weight scaled by
    1 + 1e-6 N(0, 1): the null runs the schedules' gradients are gated
    by."""
    import torch
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.training.state import loss_and_grads
    base = RAFTStereo(mcfg)
    base.load_state_dict(state, strict=True)
    nulls = []
    for i in range(NULL_RUNS):
        other = perturbed_copy(base, NULL_PERTURBATION, SEED + 60 + i)
        nulls.append(loss_and_grads(other.to(dev), batch,
                                    tcfg.train_iters)[2])
        del other
    torch.cuda.empty_cache()
    return [n for n, _ in base.named_parameters()], nulls


def bf16_contract(names, got, want):
    """JAX's gradient contract for bf16 residuals (tests/test_scan_grad.py
    ``assert_grads_tolerance``, rel 2e-2), leaf by leaf: ``|got - want| <=
    2e-2 |want| + 1e-4 max_leaf |want|`` (L2 norms). Returns the worst
    ratio to the bound, its leaf and whether every leaf is within."""
    import torch
    scale = max(float(torch.linalg.vector_norm(w.double())) for w in want)
    ratios = {}
    for n, g, w in zip(names, got, want):
        diff = float(torch.linalg.vector_norm((g - w).double()))
        bound = 2e-2 * float(torch.linalg.vector_norm(w.double())) \
            + 1e-4 * scale
        ratios[n] = diff / bound
    worst = max(ratios, key=ratios.get)
    return dict(bf16_contract_ratio=ratios[worst],
                bf16_contract_worst_leaf=worst,
                bf16_contract_ok=ratios[worst] < 1.0)


@contextlib.contextmanager
def per_iteration_fp32_wgrads():
    """Today's schedule with each iteration's gate-conv weight gradients
    kept in fp32: the model's per-iteration refinement (refinement_scan of
    one iteration, batched=False) run with batched=True, so that each
    iteration's gate weight gradient is one fp32-accumulated contraction
    over that iteration's batch and autograd sums the 22 in fp32, where
    today's schedule takes each from the conv's bf16 weight-gradient
    output before the sum. The reference batched_scan_wgrad accumulates
    like (a measurement instrument: no config selects it)."""
    from raft_stereo_tpu_torch.models import raft_stereo as rs
    real = rs.refinement_scan

    def scan(*args, **kwargs):
        if kwargs.get("length") == 1:
            kwargs["batched"] = True
        return real(*args, **kwargs)
    rs.refinement_scan = scan
    try:
        yield
    finally:
        rs.refinement_scan = real


def wgrad_fp64(conv, x, g, chunk=4):
    """``conv``'s weight gradient for the inputs ``x (N, H, W, Cin)`` and
    the output cotangents ``g (N, H, W, Cout')``, in float64: im2col
    (F.unfold) and one product a chunk of N, independent of cuDNN."""
    import torch
    import torch.nn.functional as F
    k, cout = conv.kernel_size, g.shape[-1]
    dw = torch.zeros((cout, x.shape[-1] * k[0] * k[1]), dtype=torch.float64,
                     device=g.device)
    for i in range(0, x.shape[0], chunk):
        cols = F.unfold(x[i:i + chunk].permute(0, 3, 1, 2).double(), k,
                        padding=conv.padding, stride=conv.stride)
        gc = g[i:i + chunk].double().reshape(cols.shape[0], -1, cout)
        dw += torch.einsum("nlo,ncl->oc", gc, cols)
        del cols, gc
    return dw.reshape((cout, x.shape[-1]) + tuple(k))


def per_iteration_route(conv, x, g, groups):
    """The weight gradient as today's schedule accumulates it from the
    same stacks: one contraction an iteration in the stacks' dtype (in
    bf16 cuDNN's bf16 output, as autograd's conv backward gives it for
    the bf16 weight copy), each widened to fp32 and summed."""
    import torch
    n = x.shape[0] // groups
    w = torch.zeros((g.shape[-1], x.shape[-1]) + tuple(conv.kernel_size),
                    dtype=x.dtype, device=x.device)
    total = None
    for t in range(groups):
        part = conv.conv_backward(x[t * n:(t + 1) * n], w,
                                  g[t * n:(t + 1) * n],
                                  (False, True, False))[1].float()
        total = part if total is None else total + part
    return total


@contextlib.contextmanager
def checked_weight_grads(rows):
    """Every Conv.weight_grad call (the batched backward's contractions)
    also held against wgrad_fp64 on the same stacks: a row of ``rows``
    a call (shapes, dtypes, groups, cuDNN's route for the stacked weight;
    the relative L2 from float64 of the contraction, of today's
    per-iteration route (per_iteration_route, its yardstick) and of the
    same contraction in one group (one fp32 sum over every iteration: the
    earlier design, a reading))."""
    import torch
    from raft_stereo_tpu_torch.nn.layers import Conv, cudnn_takes_fft
    real = Conv.weight_grad

    def checked(self, x, g, groups=1):
        dw = real(self, x, g, groups=groups)
        want = wgrad_fp64(self, x, g)
        one = real(self, x, g) if groups > 1 else dw
        today = per_iteration_route(self, x, g, groups)
        rows.append(dict(
            x_shape=list(x.shape), cout=g.shape[-1], dtype=str(x.dtype),
            groups=groups, rel_l2=rel_l2(dw, want),
            rel_l2_per_iteration_route=rel_l2(today, want),
            rel_l2_one_group=rel_l2(one, want),
            fft_route=cudnn_takes_fft(
                self, x.permute(0, 3, 1, 2).float(),
                torch.empty((g.shape[-1], x.shape[-1]) + self.kernel_size,
                            device="meta"))))
        del want, one, today
        return dw
    Conv.weight_grad = checked
    try:
        yield
    finally:
        Conv.weight_grad = real


def gate_weight_dev(names, got, want):
    """Relative L2 of the gate convs' weight gradients together."""
    import torch
    pick = [i for i, n in enumerate(names) if n.endswith(GATE_WEIGHTS)]
    return rel_l2(torch.cat([got[i].flatten() for i in pick]),
                  torch.cat([want[i].flatten() for i in pick]))


def run_train_schedules(dev, all_kernels, ws_kernel):
    """train_schedules: each of TRAIN_SCHEDULES at the SceneFlow recipe
    (reg_cuda, bf16, batch 8 at 320x720, 22 iterations) on one seeded
    batch and seeded weights, under PyTorch's TF32 defaults (the train
    entry point leaves them so): its loss within SCHEDULE_LOSS_TOL
    relative of today's; its gradients against today's under the null
    floor (check_grad_parity over NULL_RUNS null runs made once) and
    JAX's bf16 contract (bf16_contract). Under batched_scan_wgrad, whose
    fp32 sums depart from today's bf16 per-iteration terms, the null
    floor is taken against the schedule it accumulates like, today's
    with fp32 per-iteration gate weight gradients
    (per_iteration_fp32_wgrads, NULL_RUNS null runs of its own), and the
    gate weights' gradients must sit closer to that reference than
    today's do; each contraction itself must be no further from
    wgrad_fp64 on the recipe's stacks than today's per-iteration route
    on them (per_iteration_route; train_schedules_wgrad).
    B1's launches a step as TRAIN_SCHEDULES states them (22 forward where
    a policy keeps the lookups, 44 where the backward recomputes them;
    22 backward) and no other kernel's; ms/step (SCHEDULE_STEPS
    timed), peak memory and the device-time split of one
    profiled step, printed a schedule a line."""
    import torch
    from raft_stereo_tpu_torch.config import sceneflow_config
    from raft_stereo_tpu_torch.models import RAFTStereo
    mcfg0, tcfg = sceneflow_config()
    mcfg0 = dataclasses.replace(mcfg0, corr_implementation="reg_cuda")
    state = seeded_weights(RAFTStereo(mcfg0), SEED)
    b, (h, w), iters = tcfg.batch_size, tcfg.image_size, tcfg.train_iters
    batch = train_batch(b, h, w, SEED + 3, dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        names, nulls = schedule_nulls(dev, mcfg0, tcfg, state, batch)
        with per_iteration_fp32_wgrads():
            ref = schedule_run(dev, mcfg0, tcfg, state, batch, False,
                               all_kernels, timed=False)["grads"]
            _, ref_nulls = schedule_nulls(dev, mcfg0, tcfg, state, batch)
        contraction = []
        with checked_weight_grads(contraction):
            schedule_run(dev, dataclasses.replace(
                mcfg0, batched_scan_wgrad=True), tcfg, state, batch, False,
                all_kernels, timed=False)
        torch.cuda.empty_cache()
        worst = max(contraction, key=lambda r: r["rel_l2"]
                    / r["rel_l2_per_iteration_route"])
        emit("train_schedules_wgrad", contractions=contraction,
             worst=worst)
        rows = schedule_rows(dev, mcfg0, tcfg, state, batch, all_kernels,
                             ws_kernel, names, nulls, ref, ref_nulls)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    check(len(contraction) >= 6
          and worst["rel_l2"] <= worst["rel_l2_per_iteration_route"]
          and not any(r["fft_route"] for r in contraction),
          f"train_schedules_wgrad: a batched contraction is further from "
          f"float64 than today's per-iteration route (or took cuDNN's "
          f"FFT): {worst}")
    return rows


def schedule_rows(dev, mcfg0, tcfg, state, batch, all_kernels, ws_kernel,
                  names, nulls, ref, ref_nulls):
    """run_train_schedules' rows, a schedule a line."""
    b, (h, w), iters = tcfg.batch_size, tcfg.image_size, tcfg.train_iters
    idx = list(all_kernels).index(ws_kernel)
    rows, want = {}, None
    for name, fields, fused_loss, b1_fwd in TRAIN_SCHEDULES:
        mcfg = dataclasses.replace(mcfg0, **fields)
        run = schedule_run(dev, mcfg, tcfg, state, batch, fused_loss,
                           all_kernels)
        grads = run.pop("grads")
        if want is None:
            want, want_loss = grads, run["loss"]
        gate = check_grad_parity(names, grads, want, nulls)
        ref_gate = check_grad_parity(names, grads, ref, ref_nulls)
        contract = bf16_contract(names, grads, want)
        batched = bool(fields.get("batched_scan_wgrad"))
        dev_ref = gate_weight_dev(names, grads, ref)
        if batched:
            closer = dev_ref < rows["default"]["gate_weight_dev_ref"]
            grads_ok = ref_gate["ok"] and closer \
                and contract["bf16_contract_ok"]
        else:
            grads_ok = gate["ok"]
        expect = (b1_fwd, iters)
        row = dict(schedule=name, fields=fields, fused_loss=fused_loss,
                   loss_rel_dev=abs(run["loss"] - want_loss) / abs(want_loss),
                   launches_expected=list(expect), **run,
                   grads_gate=("null_floor_vs_fp32_wgrad_reference"
                               if batched else "null_floor"),
                   grads_ok=grads_ok, null_floor_ok=gate["ok"], **contract,
                   gate_weight_dev_ref=dev_ref,
                   ref_gate=ref_gate,
                   **{"grad_" + k: v for k, v in gate.items() if k != "ok"})
        rows[name] = row
        emit("train_schedules", config="sceneflow_config() + reg_cuda",
             batch=b, image_size=[h, w], iters=iters, **row)
        check(tuple(run["launches"][idx]) == expect
              and all(tuple(c) == (0, 0) for j, c in
                      enumerate(run["launches"]) if j != idx),
              f"train_schedules {name}: launches {run['launches']}, "
              f"expected {expect} of B1 and no other kernel's")
        check(row["loss_rel_dev"] <= SCHEDULE_LOSS_TOL,
              f"train_schedules {name}: loss {run['loss']} vs {want_loss}")
        check(grads_ok, f"train_schedules {name}: gradients beyond "
                        f"{row['grads_gate']}: {row}")
    return rows


FP32_GATE_BATCH = 2  # the fp32 gates' batch at 320x720, 22 iterations


def run_train_schedules_kernels(dev, all_kernels):
    """train_schedules_fp32 and train_schedules_kernels: batched_scan_wgrad
    in fp32 (TF32 off) at 320x720, batch FP32_GATE_BATCH, 22 iterations,
    through each lookup kernel: B1 (reg_cuda, with and without the full
    save policy), B2 (alt_cuda), B3 (alt_pallas) and B4 (reg_cuda +
    fused_lookup). Each against that correlation's autodiff step (today's
    schedule) under the null floor of its own NULL_RUNS null runs, its
    loss within SCHEDULE_LOSS_TOL, its kernel's launches a step (the
    forward's: 22 where the auto save policy, engaged at this batch,
    keeps the lookups, 44 with the fused lookup, which has none to keep)
    and no other kernel's (one step each: the timings are
    train_schedules')."""
    from raft_stereo_tpu_torch.config import sceneflow_config
    from raft_stereo_tpu_torch.models import RAFTStereo
    ws_k, fc_k, ac_k, fl_k = all_kernels
    mcfg0, tcfg = sceneflow_config()
    mcfg0 = dataclasses.replace(mcfg0, mixed_precision=False,
                                corr_storage_dtype=None)
    tcfg = dataclasses.replace(tcfg, batch_size=FP32_GATE_BATCH)
    b, (h, w), iters = tcfg.batch_size, tcfg.image_size, tcfg.train_iters
    batch = train_batch(b, h, w, SEED + 3, dev)
    batched = {"batched_scan_wgrad": True}
    rows = {}
    for phase, label, kernel, fields, per_iter, schedules in (
            ("train_schedules_fp32", "reg_cuda", ws_k,
             {"corr_implementation": "reg_cuda"}, (1, 1),
             (("batched_scan_wgrad", batched),
              ("batched_policy_on", dict(batched,
                                         refinement_save_policy=True)))),
            ("train_schedules_kernels", "alt_cuda", fc_k,
             {"corr_implementation": "alt_cuda"}, (1, 4),
             (("batched_scan_wgrad", batched),)),
            ("train_schedules_kernels", "alt_pallas", ac_k,
             {"corr_implementation": "alt_pallas"}, (1, 4),
             (("batched_scan_wgrad", batched),)),
            ("train_schedules_kernels", "fused_lookup", fl_k,
             {"corr_implementation": "reg_cuda", "fused_lookup": True},
             (2, 1),
             (("batched_scan_wgrad", batched),))):
        mcfg = dataclasses.replace(mcfg0, **fields)
        state = seeded_weights(RAFTStereo(mcfg), SEED)
        names, nulls = schedule_nulls(dev, mcfg, tcfg, state, batch)
        idx = list(all_kernels).index(kernel)
        runs = {}
        for name, extra in (("autodiff", {}),) + schedules:
            cfg = dataclasses.replace(mcfg, **extra)
            runs[name] = schedule_run(dev, cfg, tcfg, state, batch, False,
                                      all_kernels, timed=False)
            expect = (per_iter[0] * iters, per_iter[1] * iters)
            got = runs[name]["launches"]
            check(tuple(got[idx]) == expect and all(
                tuple(c) == (0, 0) for j, c in enumerate(got) if j != idx),
                f"{phase} {label} {name}: launches {got}, expected {expect} "
                f"of {kernel.__name__}")
        want = runs["autodiff"].pop("grads")
        for name, _ in schedules:
            got = runs[name].pop("grads")
            gate = check_grad_parity(names, got, want, nulls)
            loss_dev = (abs(runs[name]["loss"] - runs["autodiff"]["loss"])
                        / abs(runs["autodiff"]["loss"]))
            runs[name].update(loss_rel_dev=loss_dev, grads_ok=gate["ok"],
                              **{"grad_" + k: v for k, v in gate.items()
                                 if k != "ok"})
            check(loss_dev <= SCHEDULE_LOSS_TOL,
                  f"{phase} {label} {name}: loss deviates {loss_dev}")
            check(gate["ok"], f"{phase} {label} {name}: gradients beyond "
                              f"the null floor: {gate}")
        row = dict(kernel=kernel.__name__, config="sceneflow_config() fp32 "
                   "+ " + ", ".join(f"{k}={v}" for k, v in fields.items()),
                   batch=b, image_size=[h, w], iters=iters, **runs)
        rows[label] = row
        emit(phase, **row)
    return rows


# --------------------------------------------------------- evaluation path

class FlowRecorder:
    """Wraps a predictor and keeps every flow it returns, in return order:
    ``__call__``, ``predict_timed`` and the results of ``predict_async``'s
    handles (the stream driver fetches each handle once, in index
    order)."""

    class _Handle:
        def __init__(self, handle, sink):
            self._handle, self._sink = handle, sink

        def result(self):
            flow = self._handle.result()
            self._sink.append(flow)
            return flow

        def __getattr__(self, name):  # dispatch_s, fetch_s, ready, ...
            return getattr(self._handle, name)

    def __init__(self, predictor):
        self.predictor, self.flows = predictor, []

    def __call__(self, im1, im2, iters=None):
        flow = self.predictor(im1, im2, iters)
        self.flows.append(flow)
        return flow

    def predict_timed(self, im1, im2, iters=None):
        flow, dt = self.predictor.predict_timed(im1, im2, iters)
        self.flows.append(flow)
        return flow, dt

    def predict_async(self, im1, im2, iters=None):
        return self._Handle(self.predictor.predict_async(im1, im2, iters),
                            self.flows)


def write_kitti_tree(root, n, h, w, seed):
    """A KITTI-layout tree (``training/{image_2,image_3,disp_occ_0}``) of
    ``n`` textured pairs whose right view is the left one shifted by
    EVAL_SHIFT px; the 16-bit disparity PNGs hold that shift, a fifth of
    the pixels invalid (0). Written by the port's png.py with Paeth rows,
    so decoding costs what a photograph written by libpng costs."""
    import numpy as np
    from raft_stereo_tpu_torch.data import png
    base = os.path.join(root, "KITTI", "training")
    for d in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    for i in range(n):
        left, right = stereo_pair(h, w, seed + i, shift=EVAL_SHIFT)
        name = f"{i:06d}_10.png"
        png.write_png(os.path.join(base, "image_2", name),
                      left[0].astype(np.uint8), 4)
        png.write_png(os.path.join(base, "image_3", name),
                      right[0].astype(np.uint8), 4)
        disp = np.full((h, w), EVAL_SHIFT * 256, np.uint16)
        disp[np.random.default_rng(seed + i).uniform(size=(h, w)) < 0.2] = 0
        png.write_png(os.path.join(base, "disp_occ_0", name), disp, 4)
    return root


def write_sceneflow_tree(root, n, h, w, seed, test_frames=0,
                         max_disp=64.0):
    """A FlyingThings3D-layout tree: ``n`` frames of each pass (clean and
    final, TRAIN/A/0000) and ``test_frames`` of the final pass's TEST
    split, textured pairs whose right view is the left one shifted by a
    disparity in [1, max_disp) a frame, written by the port's png.py with
    Paeth rows and frame_utils.write_pfm (a smooth disparity field around
    that shift)."""
    import numpy as np
    from raft_stereo_tpu_torch.data import frame_utils, png
    things = os.path.join(root, "FlyingThings3D")
    frames = [(p, "TRAIN", i) for p in ("frames_cleanpass",
                                        "frames_finalpass")
              for i in range(n)]
    frames += [("frames_finalpass", "TEST", i) for i in range(test_frames)]
    for k, (dstype, split, i) in enumerate(frames):
        rng = np.random.default_rng(seed + k)
        shift = int(rng.integers(1, int(max_disp)))
        left, right = stereo_pair(h, w, seed + k, shift=shift)
        seq = os.path.join(things, dstype, split, "A", "0000")
        for side, img in (("left", left), ("right", right)):
            os.makedirs(os.path.join(seq, side), exist_ok=True)
            png.write_png(os.path.join(seq, side, f"{i:04d}.png"),
                          img[0].astype(np.uint8), 4)
        ddir = os.path.join(things, "disparity", split, "A", "0000", "left")
        os.makedirs(ddir, exist_ok=True)
        yy = np.linspace(0, 1, h, dtype=np.float32)[:, None]
        disp = (shift + 2 * np.sin(6 * yy) * np.ones((1, w), np.float32))
        frame_utils.write_pfm(os.path.join(ddir, f"{i:04d}.pfm"),
                              disp.astype(np.float32))
    return root


# the training path's phases: the SceneFlow recipe (sceneflow_config():
# batch 8, 320x720, 22 iterations, bf16) through train() and python -m
# raft_stereo_tpu_torch.train on a synthetic FlyingThings tree at 540x960:
# 8 frames a pass (the "sceneflow" mix takes each 4 times: 64 samples, 8
# batches an epoch) and 2 TEST frames for the validation hook
TRAIN_TREE_FRAMES = 8
TRAIN_TREE_HW = (540, 960)
TRAINER_STEPS = 8
TRAINER_CKPT_EVERY = 4
TRAINER_VAL_EVERY = 6
TRAINER_WORKERS = 6          # loader worker processes (8 host cores)
# the steady window: train() with no checkpoint or validation (each gives
# the loader time to catch up), long enough that a loader slower than the
# card shows in data_wait_s; timed from the second epoch on (the loader's
# queue starts empty each epoch, so every epoch's first step waits)
STEADY_STEPS = 16
STEADY_SKIP = 8
RESUME_SIGTERM_AFTER = 5     # SIGTERM once the step-5 record is written
# the card's training is not bitwise run to run (scripts/
# train_determinism.py), but its forward is (step 1's loss is the same
# in every run): a run resumed from A's own step-RESUME_FROM checkpoint
# must give A's step RESUME_FROM + 1 loss bitwise (parameters and stream
# position restored exactly), and its one AdamW update must be the one
# the restored moments, count and LR make (adamw_step_deviation) within
# these bounds (fp32 rounding; a lost moment, count or LR is O(1))
RESUME_FROM = 4
ADAMW_V_TOL = 1e-4
ADAMW_P_TOL = 1e-3


def recipe_config(tree, run_root, name, **overrides):
    """The recipe's (model, train) configs on ``tree``, reg_cuda."""
    from raft_stereo_tpu_torch.config import sceneflow_config
    mcfg, tcfg = sceneflow_config()
    mcfg = dataclasses.replace(mcfg, corr_implementation="reg_cuda")
    tcfg = dataclasses.replace(
        tcfg, name=name, num_steps=TRAINER_STEPS, data_root=tree,
        ckpt_dir=os.path.join(run_root, "ckpts"),
        run_dir=os.path.join(run_root, "runs"),
        checkpoint_frequency=TRAINER_CKPT_EVERY,
        validation_frequency=TRAINER_VAL_EVERY, valid_iters=EVAL_ITERS,
        num_workers=TRAINER_WORKERS, ckpt_keep_last=0, **overrides)
    return mcfg, tcfg


def loader_stages(dataset, n, seed):
    """ms a sample, in this process, split into decode (read_raw),
    photometric (colour jitter and the eraser), resize (the three
    resize_linear calls) and crop (flips and the crop), over the first
    ``n`` samples of epoch 0; the same calls sample() makes."""
    from raft_stereo_tpu_torch.data import augment
    from raft_stereo_tpu_torch.data.loader import sample_rng
    spent = {"decode": 0.0, "photometric": 0.0, "resize": 0.0, "crop": 0.0}
    resize = augment.resize_linear

    def timed_resize(*args):
        t = time.perf_counter()
        out = resize(*args)
        spent["resize"] += time.perf_counter() - t
        return out
    augment.resize_linear = timed_resize
    try:
        for i in range(n):
            t0 = time.perf_counter()
            img1, img2, flow, _ = dataset.read_raw(i)
            t1 = time.perf_counter()
            aug = dataset._source(i).augmentor
            rng = sample_rng(seed, 0, i)
            img1, img2 = aug.color_transform(img1, img2, rng)
            img2 = augment._eraser(img2, rng)
            t2 = time.perf_counter()
            before = spent["resize"]
            aug.spatial_transform(img1, img2, flow, rng)
            t3 = time.perf_counter()
            spent["decode"] += t1 - t0
            spent["photometric"] += t2 - t1
            spent["crop"] += (t3 - t2) - (spent["resize"] - before)
    finally:
        augment.resize_linear = resize
    return {k: v * 1e3 / n for k, v in spent.items()}


def run_train_loader(tree):
    """The port's Loader at the recipe's augmentation on the tree:
    samples/s over epoch 1 (after an epoch that starts the worker
    processes), ms a sample by stage; a second loader's pass over epoch 0
    bitwise the first's, and its start_batch resume of epoch 1 equal to
    the uninterrupted stream."""
    from raft_stereo_tpu_torch.data.datasets import fetch_dataloader
    _, tcfg = recipe_config(tree, os.path.dirname(tree), "loader")
    loader = fetch_dataloader(tcfg)
    epochs = [list(loader)]
    t0 = time.perf_counter()
    epochs.append(list(loader))
    rate = len(epochs[1]) * tcfg.batch_size / (time.perf_counter() - t0)
    loader.close()
    # the "sceneflow" mix: both passes, each 4 times
    want_batches = 2 * 4 * TRAIN_TREE_FRAMES // tcfg.batch_size
    check(len(epochs[1]) == len(loader) == want_batches,
          f"{len(epochs[1])} batches an epoch, not {want_batches}")

    def same(got, want):
        return len(got) == len(want) and all(
            a[k].tobytes() == b[k].tobytes()
            for a, b in zip(got, want) for k in a)
    again = fetch_dataloader(tcfg)
    check(same(list(again), epochs[0]),
          "two passes over epoch 0 made different batches")
    again.start_batch = 3
    check(same(list(again), epochs[1][3:]),
          "a start_batch resume differs from the uninterrupted stream")
    again.close()
    stages = loader_stages(again.dataset, 8, tcfg.seed)
    result = dict(samples_per_s=rate, ms_per_sample=stages,
                  ms_per_sample_total=sum(stages.values()),
                  batches_per_epoch=want_batches, host_cpus=os.cpu_count(),
                  workers=TRAINER_WORKERS, image=list(TRAIN_TREE_HW),
                  crop=list(tcfg.image_size), passes_bitwise=True,
                  resume_bitwise=True)
    emit("train_loader", **result)
    return result


def step_records(run_dir):
    """The run's events.jsonl: schema-valid (the port's validate_events);
    returns the records."""
    from raft_stereo_tpu_torch.obs import read_events, validate_events
    events = read_events(os.path.join(run_dir, "events.jsonl"))
    errors = validate_events(events)
    check(not errors, f"{run_dir}: events.jsonl fails the schema: "
                      f"{errors[:5]}")
    return events


def run_train_trainer(dev, tree, work, all_kernels, kernel, impl="reg_cuda",
                      phase="train_trainer", steps=TRAINER_STEPS,
                      per_iter=(2, 1), skip=2):
    """train() in this process at the recipe (``impl``), ``steps`` steps
    (other than the recipe's 12: no checkpoint or validation): the
    launches of ``kernel`` each step (counted around each step function
    call), none of the other kernels', finite losses, a valid events.jsonl
    with the fleet stamp and heartbeats; over the steps after the first
    ``skip``, ms/step, the data_wait/dispatch/fetch split and data_wait's
    share (of the median step, and of the window's time with and without
    each epoch's first step, where the loader's queue starts empty); peak
    memory, checkpoint bytes and save seconds."""
    import torch
    from raft_stereo_tpu_torch.training import trainer as trainer_mod
    run_root = os.path.join(work, phase)
    mcfg, tcfg = recipe_config(tree, run_root, phase, heartbeat_every_s=2.0)
    mcfg = dataclasses.replace(mcfg, corr_implementation=impl)
    if steps != TRAINER_STEPS:
        tcfg = dataclasses.replace(tcfg, num_steps=steps,
                                   checkpoint_frequency=None,
                                   validation_frequency=10 ** 6)
    per_step, saves = [], []
    make_step = trainer_mod.make_pjit_train_step
    save = trainer_mod.save_train_state

    def counted_make_step(*args, **kwargs):
        step_fn = make_step(*args, **kwargs)

        def step(state, batch, **kw):
            before = [(k.launches, k.bwd_launches) for k in all_kernels]
            out = step_fn(state, batch, **kw)
            per_step.append([(k.launches - b[0], k.bwd_launches - b[1])
                             for k, b in zip(all_kernels, before)])
            return out
        return step

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        path = save(*args, **kwargs)
        saves.append((time.perf_counter() - t0, path))
        return path
    trainer_mod.make_pjit_train_step = counted_make_step
    trainer_mod.save_train_state = timed_save
    torch.cuda.reset_peak_memory_stats(dev)
    for k in all_kernels:
        k.launches = k.bwd_launches = 0
    try:
        t0 = time.perf_counter()
        final = trainer_mod.train(mcfg, tcfg, device=dev)
        wall = time.perf_counter() - t0
    finally:
        trainer_mod.make_pjit_train_step = make_step
        trainer_mod.save_train_state = save
    iters = tcfg.train_iters
    want = (per_iter[0] * iters, per_iter[1] * iters)
    idx = list(all_kernels).index(kernel)
    check(len(per_step) == steps, f"{phase}: {len(per_step)} steps ran")
    for i, counts in enumerate(per_step):
        check(counts[idx] == want and all(
            c == (0, 0) for j, c in enumerate(counts) if j != idx),
              f"{phase}: step {i + 1} launched {counts}, expected {want} "
              f"of {kernel.__name__} and nothing else")
    events = step_records(os.path.join(tcfg.run_dir, tcfg.name))
    records = [e for e in events if e["event"] == "step"]
    check([r["step"] for r in records] == list(range(1, steps + 1)),
          f"{phase}: step records {[r['step'] for r in records]}")
    losses = [r["loss"] for r in records]
    check(all(map(math.isfinite, losses)) and not any(
        r["skipped_updates"] for r in records),
          f"{phase}: losses {losses}")
    start = next(e for e in events if e["event"] == "run_start")
    beats = sum(e["event"] == "heartbeat" for e in events)
    check("host_id" in start and "pid" in start and any(
        e["event"] == "clock_anchor" for e in events),
          f"{phase}: run_start carries no fleet stamp")
    check(beats > 0 or steps < TRAINER_STEPS,
          f"{phase}: no heartbeat in a {wall:.1f} s run at "
          f"{tcfg.heartbeat_every_s} s")
    timed = records[skip:] if steps > skip else records
    step_s = [r["data_wait_s"] + r["dispatch_s"] + r["fetch_s"]
              for r in timed]
    med = {k: statistics.median(r[k] for r in timed)
           for k in ("data_wait_s", "dispatch_s", "fetch_s")}
    per_epoch = 2 * 4 * TRAIN_TREE_FRAMES // tcfg.batch_size
    inner = [(r["data_wait_s"], t) for r, t in zip(timed, step_s)
             if (r["step"] - 1) % per_epoch]
    ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(final) for f in fs)
    result = dict(
        config=f"sceneflow_config() + {impl}", batch=tcfg.batch_size,
        image_size=list(tcfg.image_size), iters=iters, steps=steps,
        # the (fwd, bwd) counts the steps measured: one pair, as checked
        launches_per_step=[list(c) for c in sorted({tuple(c[idx])
                                                    for c in per_step})],
        wall_s=wall, timed_steps=[timed[0]["step"], timed[-1]["step"]],
        ms_per_step_median=statistics.median(step_s) * 1e3,
        ms_per_step=[x * 1e3 for x in step_s],
        pairs_per_s=tcfg.batch_size / statistics.median(step_s),
        pairs_per_s_window=tcfg.batch_size * len(step_s) / sum(step_s),
        median_s=med,
        data_wait_share=med["data_wait_s"] / statistics.median(step_s),
        data_wait_share_window=sum(r["data_wait_s"] for r in timed)
        / sum(step_s),
        data_wait_share_window_within_epochs=sum(w for w, _ in inner)
        / sum(t for _, t in inner),
        peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
        checkpoint_bytes=ckpt_bytes,
        save_s=[round(t, 3) for t, _ in saves], losses=losses, final=final,
        data_wait_s=[r["data_wait_s"] for r in records],
        dispatch_s=[r["dispatch_s"] for r in records],
        heartbeats=beats, validations=sum(e["event"] == "validation"
                                          for e in events),
        workers=tcfg.num_workers)
    emit(phase, **result)
    return result


def final_params(path):
    from raft_stereo_tpu_torch.training.checkpoint import load_payload
    return load_payload(path)["model"]


def param_distance(a, b):
    """Relative L2 distance of two parameter dicts (all leaves)."""
    import torch
    num = sum(float(torch.sum((a[k].double() - b[k].double()) ** 2))
              for k in a if a[k].is_floating_point())
    den = sum(float(torch.sum(b[k].double() ** 2))
              for k in b if b[k].is_floating_point())
    return math.sqrt(num / den)


def adamw_step_deviation(before, after, names, lr, wdecay,
                         betas=(0.9, 0.999), eps=1e-8):
    """How far checkpoint ``after`` is from one AdamW update (the port's
    Optimizer: torch.optim.AdamW) of checkpoint ``before``, both
    load_payload dicts whose optimizer lists follow the parameter
    ``names``. The update's gradient g is read off the first moment
    (m1 = b1 m0 + (1 - b1) g); it must give the second moment
    (v1 = b2 v0 + (1 - b2) g^2), and the moments, the count t and ``lr``
    the parameters (p1 = p0 (1 - lr wd) - lr / (1 - b1^t) m1 /
    (sqrt(v1 / (1 - b2^t)) + eps)). Returns ``(v, p)``: the largest
    relative L2 deviation of a parameter's second moment, and the
    parameters' deviation beyond two fp32 roundings of p relative to the
    whole update. An exact restore and update leaves fp32 rounding; a
    restore that lost the moments, the count, the LR or the parameters
    leaves O(1)."""
    import torch
    b1, b2 = betas
    t = int(after["optimizer"]["count"])
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    dev_v, p_err, p_step = 0.0, 0.0, 0.0
    for i, name in enumerate(names):
        m0, v0, m1, v1 = (x["optimizer"][k][i].double()
                          for x in (before, after)
                          for k in ("exp_avg", "exp_avg_sq"))
        p0, p1 = before["model"][name].double(), after["model"][name].double()
        g = (m1 - b1 * m0) / (1 - b1)
        num = float(torch.linalg.vector_norm(v1 - (b2 * v0
                                                   + (1 - b2) * g * g)))
        den = float(torch.linalg.vector_norm(v1))
        dev_v = max(dev_v, num / den if den else (0.0 if num == 0
                                                  else math.inf))
        p_want = p0 * (1 - lr * wdecay) - lr / bc1 * m1 / (
            torch.sqrt(v1) / math.sqrt(bc2) + eps)
        slack = (p1 - p_want).abs() - 2.0 ** -23 * p0.abs()
        p_err += float(torch.sum(slack.clamp(min=0) ** 2))
        p_step += float(torch.sum((p_want - p0) ** 2))
    return dev_v, math.sqrt(p_err / p_step) if p_step else math.inf


def run_train_resume(tree, work):
    """python -m raft_stereo_tpu_torch.train at the recipe, each run in a
    session of its own: an uninterrupted run A; a run sent SIGTERM after
    its step-5 record (a preempt checkpoint, exit 0), resumed with
    --restore_ckpt auto to the end (its resume record at the preempt
    step); a second uninterrupted run B; a run C restored from A's
    step-RESUME_FROM checkpoint for one step. Holds: step 1's loss is the
    same in A, B and the resumed run; C's first step's loss is A's at that
    step bitwise, and its update is one AdamW step of A's restored state
    (adamw_step_deviation); where A and B end bitwise equal, the resumed
    run ends bitwise A's; nothing is left in any run's session. The
    final parameters' distances and the largest per-step loss gaps
    between A, B and the resumed run are reported (the card's training is
    not bitwise run to run, so they are one sample each of its spread)."""
    import signal
    from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.training.checkpoint import load_payload
    from raft_stereo_tpu_torch.training.optim import fetch_schedule
    root = os.path.join(work, "train_resume")
    base = [sys.executable, "-m", "raft_stereo_tpu_torch.train",
            "--batch_size", "8", "--train_iters", "22",
            "--spatial_scale", "-0.2", "0.4", "--saturation_range", "0",
            "1.4", "--mixed_precision", "--corr_implementation", "reg_cuda",
            "--image_size", "320", "720",
            "--checkpoint_frequency", str(TRAINER_CKPT_EVERY),
            "--validation_frequency", str(TRAINER_VAL_EVERY),
            "--valid_iters", str(EVAL_ITERS), "--data_root", tree,
            "--num_workers", str(TRAINER_WORKERS), "--ckpt_keep_last", "0"]
    here = os.path.dirname(os.path.abspath(__file__))

    def start(name, leg, extra=(), steps=TRAINER_STEPS):
        cmd = base + ["--name", name, "--num_steps", str(steps),
                      "--ckpt_dir", os.path.join(root, "ckpts", name),
                      "--run_dir", os.path.join(root, "runs", leg),
                      *extra]
        log = open(os.path.join(root, f"{leg}.log"), "w")
        proc = subprocess.Popen(cmd, cwd=here, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        log.close()
        return proc

    def finish(proc, leg):
        rc = proc.wait(timeout=600)
        time.sleep(1.0)
        left = {pid: cmd for pid, (_, sid, cmd) in live_processes().items()
                if sid == proc.pid}
        stop_leftovers(left, f"train_resume {leg}")
        with open(os.path.join(root, f"{leg}.log")) as f:
            tail = f.read()[-3000:]
        return rc, tail

    def events(name, leg):
        path = os.path.join(root, "runs", leg, name, "events.jsonl")
        out = []
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        pass
        return out

    def losses(*evs):
        out = {}
        for ev in evs:
            out.update({e["step"]: e["loss"] for e in ev
                        if e.get("event") == "step"})
        return out

    os.makedirs(root)
    t0 = time.perf_counter()
    rc, tail = finish(start("a", "a"), "a")
    check(rc == 0, f"train_resume: run A exited {rc}: {tail}")
    run_a_s = time.perf_counter() - t0
    proc = start("r", "r1")
    deadline = time.monotonic() + 600
    while not any(e.get("event") == "step" and e["step"]
                  >= RESUME_SIGTERM_AFTER for e in events("r", "r1")):
        check(proc.poll() is None and time.monotonic() < deadline,
              "train_resume: the run to interrupt ended before step "
              f"{RESUME_SIGTERM_AFTER}")
        time.sleep(0.05)
    proc.send_signal(signal.SIGTERM)
    rc, tail = finish(proc, "r1")
    check(rc == 0, f"train_resume: SIGTERM exit {rc}: {tail}")
    first = events("r", "r1")
    preempt = [e for e in first if e.get("event") == "checkpoint"
               and e.get("reason") == "preempt"]
    check(len(preempt) == 1 and any(e.get("event") == "preempt"
                                    for e in first),
          "train_resume: no preempt checkpoint on record")
    rc, tail = finish(start("r", "r2", ("--restore_ckpt", "auto")), "r2")
    check(rc == 0, f"train_resume: resume exited {rc}: {tail}")
    second = events("r", "r2")
    resume = [e for e in second if e.get("event") == "resume"]
    check(len(resume) == 1 and resume[0]["step"] == preempt[0]["step"],
          f"train_resume: resume {resume}, preempt {preempt}")
    rc, tail = finish(start("b", "b"), "b")
    check(rc == 0, f"train_resume: run B exited {rc}: {tail}")
    a_from = os.path.join(root, "ckpts", "a", f"{RESUME_FROM}_a")
    rc, tail = finish(start("c", "c", ("--restore_ckpt", a_from),
                            steps=RESUME_FROM + 1), "c")
    check(rc == 0, f"train_resume: run C exited {rc}: {tail}")
    step_records(os.path.join(root, "runs", "r2", "r"))
    third = step_records(os.path.join(root, "runs", "c", "c"))
    pa, pb, pr = (final_params(os.path.join(root, "ckpts", n, n))
                  for n in ("a", "b", "r"))
    la, lb, lr = losses(events("a", "a")), losses(events("b", "b")), \
        losses(first, second)
    lc = losses(third)
    check(sorted(la) == sorted(lb) == sorted(lr)
          == list(range(1, TRAINER_STEPS + 1)),
          "train_resume: step records missing")
    check(la[1] == lb[1] == lr[1],
          f"train_resume: step 1 (one batch, one set of weights) gave "
          f"losses {la[1]}, {lb[1]}, {lr[1]}")
    # C: A's step-RESUME_FROM state restored, one step
    resume_c = [e for e in third if e["event"] == "resume"]
    check(len(resume_c) == 1 and resume_c[0]["step"] == RESUME_FROM
          and sorted(lc) == [RESUME_FROM + 1],
          f"train_resume: run C resumed {resume_c}, stepped {sorted(lc)}")
    check(lc[RESUME_FROM + 1] == la[RESUME_FROM + 1],
          f"train_resume: restored from A's step {RESUME_FROM}, step "
          f"{RESUME_FROM + 1}'s loss is {lc[RESUME_FROM + 1]}, A's "
          f"{la[RESUME_FROM + 1]}: the parameters or the stream position "
          "were not restored")
    before = load_payload(a_from)
    after = load_payload(os.path.join(root, "ckpts", "c", "c"))
    check(int(before["optimizer"]["count"]) == RESUME_FROM
          and int(after["optimizer"]["count"]) == RESUME_FROM + 1
          and int(after["step"]) == RESUME_FROM + 1,
          f"train_resume: run C's update counts "
          f"{before['optimizer']['count']} -> {after['optimizer']['count']}")
    run_c = next(e for e in third if e["event"] == "run_start")
    ccfg = run_c["config"]
    names = [n for n, _ in RAFTStereo(RAFTStereoConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in ccfg["model"].items()})).named_parameters()]
    lr_c = fetch_schedule(TrainConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in ccfg["train"].items()}))(RESUME_FROM)
    dev_v, dev_p = adamw_step_deviation(before, after, names, lr_c,
                                        ccfg["train"]["wdecay"])
    check(dev_v <= ADAMW_V_TOL and dev_p <= ADAMW_P_TOL,
          f"train_resume: run C's update is not one AdamW step of A's "
          f"step-{RESUME_FROM} state: second moment {dev_v} (bound "
          f"{ADAMW_V_TOL}), parameters {dev_p} (bound {ADAMW_P_TOL})")
    ab_bitwise = all(pa[k].equal(pb[k]) for k in pa)
    if ab_bitwise:
        check(all(pr[k].equal(pa[k]) for k in pa) and lr == la,
              "train_resume: run to run is bitwise, the resumed run is not")
    d_ra, d_ba, d_rb = (param_distance(pr, pa), param_distance(pb, pa),
                        param_distance(pr, pb))
    # the scale a misplaced resume works at: what the last 4 steps move
    d_a4 = param_distance(pa, final_params(os.path.join(
        root, "ckpts", "a", f"{TRAINER_STEPS - TRAINER_CKPT_EVERY}_a")))
    result = dict(preempt_step=preempt[0]["step"],
                  resumed_step=resume[0]["step"],
                  sigterm_after_record=RESUME_SIGTERM_AFTER,
                  run_to_run_bitwise=ab_bitwise,
                  rel_l2_resumed_vs_a=d_ra, rel_l2_b_vs_a=d_ba,
                  rel_l2_resumed_vs_b=d_rb, rel_l2_a_last_4_steps=d_a4,
                  max_loss_diff_resumed_vs_a=max(abs(lr[s] - la[s])
                                                 for s in la),
                  max_loss_diff_b_vs_a=max(abs(lb[s] - la[s]) for s in la),
                  restored_from_step=RESUME_FROM,
                  restored_step_loss_bitwise=True,
                  restored_adamw_dev_v=dev_v, restored_adamw_dev_p=dev_p,
                  restored_lr=lr_c, run_a_wall_s=run_a_s,
                  losses_a=[la[s] for s in sorted(la)],
                  losses_b=[lb[s] for s in sorted(lb)],
                  losses_resumed=[lr[s] for s in sorted(lr)])
    emit("train_resume", **result)
    return result


# ------------------------------------------------------ data-parallel path

DP_RANKS = ("cuda:0", "cuda:0")  # two ranks sharing the one card: gloo
DP_PARITY_HW = (64, 160)
DP_PARITY_BATCH = 4             # 2 + 2
DP_PARITY_ITERS = 2
DP_ALLREDUCE_RUNS = 5
DP_TRAINER_STEPS = 4
DP_TRAINER_CKPT_EVERY = 2
DP_TRAINER_WORKERS = 3          # loader processes a rank (8 host cores)


def _digest(tensors):
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _rank_kernels():
    from raft_stereo_tpu_torch.ops.kernels import (alt_corr, fused_corr,
                                                   fused_lookup,
                                                   windowed_sample)
    return (windowed_sample.windowed_sample, fused_corr.fused_corr,
            alt_corr.alt_corr, fused_lookup.fused_lookup_c1)


def _zero_counts(kernels):
    for k in kernels:
        k.launches = k.bwd_launches = 0


def dp_parity_rank(dev, cfg, state, batch, iters, policy_cfg):
    """One rank of dp_parity (a process chip_smoke.py spawns and joins to
    the group): its slice of ``batch`` through the data-parallel loss and
    gradients (B1 launches counted) under ``cfg`` and under
    ``policy_cfg``, then two data-parallel steps from rank 0's broadcast
    state under ``cfg``."""
    import torch
    import torch.distributed as dist
    from raft_stereo_tpu_torch.config import TrainConfig
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.parallel.data_parallel import \
        make_shardmap_train_step
    from raft_stereo_tpu_torch.parallel.distributed import (
        global_mesh, process_batch_slice)
    from raft_stereo_tpu_torch.training.optim import fetch_optimizer
    from raft_stereo_tpu_torch.training.state import (TrainState,
                                                      all_reduce_grads,
                                                      loss_and_grads)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = _rank_kernels()
    mesh = global_mesh(device=dev)
    sl = process_batch_slice(len(batch["image1"]))
    local = {k: v[sl] for k, v in batch.items()}
    runs = []
    for c in (cfg, policy_cfg):
        model = RAFTStereo(c)
        model.load_state_dict(state, strict=True)
        model.to(dev)
        _zero_counts(kernels)
        loss, _, grads = loss_and_grads(model, local, iters,
                                        group=mesh.group)
        grads, _ = all_reduce_grads(grads, mesh.group)
        torch.cuda.synchronize()
        runs.append(dict(loss=float(loss), counts=[
            (k.launches, k.bwd_launches) for k in kernels],
            grads_digest=_digest(grads),
            grads=[g.cpu() for g in grads] if mesh.rank == 0 else None))
    model = RAFTStereo(cfg)
    model.load_state_dict(state, strict=True)
    model.to(dev)
    opt = fetch_optimizer(TrainConfig(num_steps=100, lr=1e-4,
                                      batch_size=len(batch["image1"])),
                          model.parameters())
    state_ = TrainState(model, opt)
    step = make_shardmap_train_step(model, opt, iters, mesh, state=state_)
    losses = []
    for _ in range(2):
        state_, m = step(state_, local)
        losses.append(float(m["loss"]))
    return dict(rank=mesh.rank, backend=dist.get_backend(), device=str(dev),
                **runs[0], policy=runs[1], step_losses=losses,
                params_digest=_digest(model.parameters()),
                moments_digest=_digest([t for p in model.parameters() for t in
                                        (opt.adamw.state[p]["exp_avg"],
                                         opt.adamw.state[p]["exp_avg_sq"])]))


def run_dp_parity(dev, default_state):
    """dp_parity: the default architecture (fp32, reg_cuda) at 64x160, 2
    iterations, global batch 4 split 2 + 2 over two ranks sharing the
    card (gloo by the backend rule), under the recipe's full
    per-iteration recompute (refinement_save_policy=False): the reduced
    gradients against the one-process gradients of the concatenated batch
    on the card (the loss within TRAIN_LOSS_TOL relative, the gradients
    under check_grad_parity over NULL_RUNS card null runs), (4, 2) B1
    launches a rank and none of the other kernels', the two ranks'
    gradients and, after two steps, their parameters and AdamW moments
    bitwise equal. Then the same reduced gradients under the auto save
    policy, which engages at this size ((2, 2) launches a rank: the
    lookups replayed), against its own one-process gradients and null
    runs."""
    import torch
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.parallel.distributed import launch
    from raft_stereo_tpu_torch.training.state import loss_and_grads
    cfg = RAFTStereoConfig(corr_implementation="reg_cuda",
                           refinement_save_policy=False)
    policy_cfg = RAFTStereoConfig(corr_implementation="reg_cuda")
    batch = train_batch(DP_PARITY_BATCH, *DP_PARITY_HW, SEED + 5, "cpu",
                        max_disp=16.0)
    t0 = time.perf_counter()
    ranks = launch(dp_parity_rank, DP_RANKS, cfg, default_state, batch,
                   DP_PARITY_ITERS, policy_cfg)
    ranks_s = time.perf_counter() - t0

    def one_process(c, rank_runs):
        model = RAFTStereo(c)
        model.load_state_dict(default_state, strict=True)
        names = [n for n, _ in model.named_parameters()]
        one_loss, _, one = loss_and_grads(model.to(dev), batch,
                                          DP_PARITY_ITERS)
        one = [g.cpu() for g in one]
        nulls = []
        for i in range(NULL_RUNS):
            other = perturbed_copy(model.cpu(), NULL_PERTURBATION,
                                   SEED + 40 + i)
            nulls.append([g.cpu() for g in loss_and_grads(
                other.to(dev), batch, DP_PARITY_ITERS)[2]])
            del other
        gate = check_grad_parity(names, rank_runs[0]["grads"], one, nulls)
        loss_dev = (abs(rank_runs[0]["loss"] - float(one_loss))
                    / abs(float(one_loss)))
        return dict(
            loss_dp=rank_runs[0]["loss"], loss_one_process=float(one_loss),
            loss_rel_dev=loss_dev,
            launches_per_rank=[r["counts"][0] for r in rank_runs],
            others_per_rank=[r["counts"][1:] for r in rank_runs],
            grads_bitwise_across_ranks=rank_runs[0]["grads_digest"]
            == rank_runs[1]["grads_digest"],
            **{k: v for k, v in gate.items() if k != "ok"},
            grads_ok=gate["ok"])
    full = one_process(cfg, ranks)
    policy = one_process(policy_cfg, [r["policy"] for r in ranks])
    result = dict(
        config="default + reg_cuda, fp32, refinement_save_policy=False",
        ranks=list(DP_RANKS),
        backends=[r["backend"] for r in ranks], image_size=list(DP_PARITY_HW),
        batch=[DP_PARITY_BATCH // 2] * 2, iters=DP_PARITY_ITERS,
        loss_bound=TRAIN_LOSS_TOL, **full,
        params_bitwise_after_2_steps=ranks[0]["params_digest"]
        == ranks[1]["params_digest"],
        moments_bitwise_after_2_steps=ranks[0]["moments_digest"]
        == ranks[1]["moments_digest"],
        step_losses=[r["step_losses"] for r in ranks], ranks_wall_s=ranks_s,
        null_runs=NULL_RUNS,
        auto_save_policy=dict(config="default + reg_cuda, fp32", **policy))
    emit("dp_parity", **result)
    check(result["backends"] == ["gloo", "gloo"],
          f"dp_parity: two ranks on one card took {result['backends']}")
    for label, run, want in (("full recompute", full, (4, 2)),
                             ("auto save policy", policy, (2, 2))):
        check(all(tuple(c) == want for c in run["launches_per_rank"])
              and not any(c != (0, 0) for o in run["others_per_rank"]
                          for c in o),
              f"dp_parity ({label}): launches {run['launches_per_rank']}, "
              f"others {run['others_per_rank']}, expected {want} of B1 a "
              f"rank")
        check(run["loss_rel_dev"] <= TRAIN_LOSS_TOL,
              f"dp_parity ({label}): 2-rank loss {run['loss_dp']} vs one "
              f"process {run['loss_one_process']}")
        check(run["grads_ok"], f"dp_parity ({label}): 2-rank gradients "
                               f"beyond the null floor: {run}")
        check(run["grads_bitwise_across_ranks"],
              f"dp_parity ({label}): the ranks' gradients differ")
    check(result["params_bitwise_after_2_steps"]
          and result["moments_bitwise_after_2_steps"]
          and ranks[0]["step_losses"] == ranks[1]["step_losses"],
          "dp_parity: the replicas differ")
    return result


def dp_train_rank(dev, seed, steps):
    """One rank of dp_train: the SceneFlow recipe (reg_cuda, bf16, 22
    iterations) on this rank's slice of a seeded global batch of 8 at
    320x720, a warm-up step, then ``steps`` timed steps (B1 launches
    counted each), the gradients' all-reduce timed alone (none alone),
    peak memory. A world of one rank runs the one-process step."""
    import torch
    from raft_stereo_tpu_torch.config import sceneflow_config
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.parallel.data_parallel import \
        make_shardmap_train_step
    from raft_stereo_tpu_torch.parallel.distributed import (
        global_mesh, process_batch_slice)
    from raft_stereo_tpu_torch.parallel.mesh import barrier
    from raft_stereo_tpu_torch.training.optim import fetch_optimizer
    from raft_stereo_tpu_torch.training.state import (TrainState,
                                                      all_reduce_grads)
    kernels = _rank_kernels()
    mcfg, tcfg = sceneflow_config()
    mcfg = dataclasses.replace(mcfg, corr_implementation="reg_cuda")
    mesh = global_mesh(device=dev)
    model = RAFTStereo(mcfg)
    seeded_weights(model, seed)
    model.to(dev)
    opt = fetch_optimizer(tcfg, model.parameters())
    state = TrainState(model, opt)
    step = make_shardmap_train_step(model, opt, tcfg.train_iters, mesh,
                                    state=state)
    b, (h, w) = tcfg.batch_size, tcfg.image_size
    full = train_batch(b, h, w, SEED + 3, dev)
    sl = process_batch_slice(b)
    local = {k: v[sl].contiguous() for k, v in full.items()}
    del full
    state, m = step(state, local)  # warm-up: allocator, cuDNN plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    secs, counts, losses = [], [], []
    for _ in range(steps):
        _zero_counts(kernels)
        barrier(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, local)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts.append([(k.launches, k.bwd_launches) for k in kernels])
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated(dev)
    grads = [torch.randn(p.shape, device=dev) for p in model.parameters()]
    ar = []
    for _ in range(DP_ALLREDUCE_RUNS if mesh.group is not None else 0):
        barrier(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_grads(grads, mesh.group)
        torch.cuda.synchronize()
        ar.append(time.perf_counter() - t0)
    n_params = sum(p.numel() for p in model.parameters())
    return dict(rank=mesh.rank, backend=mesh.backend(), device=str(dev),
                local_batch=sl.stop - sl.start, ms_per_step=[x * 1e3
                                                             for x in secs],
                counts=counts, losses=losses, peak_mem_bytes=peak,
                allreduce_ms=[x * 1e3 for x in ar], n_params=n_params,
                allreduce_bytes=4 * n_params,
                params_digest=_digest(model.parameters()),
                skipped=float(m["skipped_updates"]))


def run_dp_train(train):
    """dp_train: the SceneFlow recipe at full width as two ranks sharing
    the card (gloo), global batch 8 split 4 + 4: per rank ms/step (median
    of TRAIN_STEPS after a warm-up), the gradients' all-reduce ms (alone,
    median of DP_ALLREDUCE_RUNS), peak memory; (22, 22) B1 launches a
    rank a step and no other kernel's; finite equal losses and the
    replicas bitwise equal. Two ranks share one card here: no scaling
    figure is drawn from it."""
    from raft_stereo_tpu_torch.parallel.distributed import launch
    from raft_stereo_tpu_torch.config import sceneflow_config
    ranks = launch(dp_train_rank, DP_RANKS, SEED, TRAIN_STEPS)
    mcfg, tcfg = sceneflow_config()
    # batch 4 a rank: the auto save policy keeps the lookups
    want = (tcfg.train_iters, tcfg.train_iters)
    ms = [statistics.median(r["ms_per_step"]) for r in ranks]
    result = dict(
        config="sceneflow_config() + reg_cuda, bf16", ranks=list(DP_RANKS),
        shared_card=True, backends=[r["backend"] for r in ranks],
        note="two ranks share one card: no scaling figure is drawn",
        batch=[r["local_batch"] for r in ranks], image_size=[320, 720],
        iters=22, ms_per_step_median=ms,
        ms_per_step=[r["ms_per_step"] for r in ranks],
        one_process_batch8_ms_per_step=train["ms_per_step_median"],
        allreduce_ms_median=[statistics.median(r["allreduce_ms"])
                             for r in ranks],
        allreduce_ms=[r["allreduce_ms"] for r in ranks],
        allreduce_bytes=ranks[0]["allreduce_bytes"],
        n_params=ranks[0]["n_params"],
        peak_mem_bytes=[r["peak_mem_bytes"] for r in ranks],
        launches_per_rank_step=sorted({tuple(c[0]) for r in ranks
                                       for c in r["counts"]}),
        losses=[r["losses"] for r in ranks],
        replicas_bitwise=ranks[0]["params_digest"]
        == ranks[1]["params_digest"])
    emit("dp_train", **result)
    print("dp_train: two ranks share one card (gloo); no scaling figure is "
          "drawn from it", flush=True)
    check(all(c[0] == want and all(x == (0, 0) for x in c[1:])
              for r in ranks for c in r["counts"]),
          f"dp_train: launches {[r['counts'] for r in ranks]}, expected "
          f"{want} of B1 a rank a step and no other kernel's")
    check(ranks[0]["losses"] == ranks[1]["losses"]
          and all(map(math.isfinite, ranks[0]["losses"]))
          and not any(r["skipped"] for r in ranks),
          f"dp_train: losses {[r['losses'] for r in ranks]}")
    check(result["replicas_bitwise"], "dp_train: the replicas differ")
    return result


def dp_trainer_rank(dev, mcfg, tcfg):
    """One rank of dp_trainer: train() as one rank of the group, then the
    loader's fork server stopped; the rank's B1 launches over the run and
    the processes it left."""
    from raft_stereo_tpu_torch.data.loader import stop_worker_server
    from raft_stereo_tpu_torch.training.trainer import train
    kernels = _rank_kernels()
    _zero_counts(kernels)
    final = train(mcfg, tcfg, device=dev)
    counts = [(k.launches, k.bwd_launches) for k in kernels]
    stop_worker_server()
    me = os.getpid()
    left = [pid for pid, (ppid, _, _) in live_processes().items()
            if ppid == me]
    return dict(final=final, counts=counts, left=left)


def run_dp_trainer(tree, work):
    """dp_trainer: train() in two processes sharing the card on the
    synthetic FlyingThings tree at the recipe, DP_TRAINER_STEPS steps with
    a checkpoint every DP_TRAINER_CKPT_EVERY; then a run restored from its
    step-2 checkpoint for one step. Holds: one checkpoint set, written by
    rank 0 (its records; none of rank 1's); each rank's events.jsonl
    valid with its coords and the gloo backend on run_start; equal losses
    on both ranks; the restored step's loss the uninterrupted run's
    bitwise; (22, 22) B1 launches a step a rank; no process left."""
    from raft_stereo_tpu_torch.parallel.distributed import launch
    root = os.path.join(work, "dp_trainer")
    mcfg, tcfg = recipe_config(tree, root, "dp", heartbeat_every_s=0)
    tcfg = dataclasses.replace(tcfg, num_steps=DP_TRAINER_STEPS,
                               checkpoint_frequency=DP_TRAINER_CKPT_EVERY,
                               validation_frequency=10 ** 6,
                               num_workers=DP_TRAINER_WORKERS)
    restored = dataclasses.replace(
        tcfg, num_steps=DP_TRAINER_CKPT_EVERY + 1,
        restore_ckpt=os.path.join(tcfg.ckpt_dir,
                                  f"{DP_TRAINER_CKPT_EVERY}_dp"),
        ckpt_dir=os.path.join(root, "ckpts_restored"),
        run_dir=os.path.join(root, "runs_restored"))
    runs, walls = [], []
    for cfg in (tcfg, restored):
        t0 = time.perf_counter()
        runs.append(launch(dp_trainer_rank, DP_RANKS, mcfg, cfg,
                           timeout_s=900.0))
        walls.append(time.perf_counter() - t0)

    def rank_events(cfg, r):
        events = step_records(os.path.join(cfg.run_dir, cfg.name,
                                           f"rank{r}"))
        check(all(e.get("coords") == [r, 0] for e in events),
              f"dp_trainer: rank {r}'s records lack coords [{r}, 0]")
        start = next(e for e in events if e["event"] == "run_start")
        check(start["config"]["parallel"]["backend"] == "gloo",
              f"dp_trainer: run_start {start['config'].get('parallel')}")
        return events

    def losses(events):
        return {e["step"]: e["loss"] for e in events if e["event"] == "step"}
    first = [rank_events(tcfg, r) for r in (0, 1)]
    second = [rank_events(restored, r) for r in (0, 1)]
    la = losses(first[0])
    ckpts = sorted(os.listdir(tcfg.ckpt_dir))
    want_ckpts = sorted([f"{s}_dp" for s in range(
        DP_TRAINER_CKPT_EVERY, DP_TRAINER_STEPS + 1,
        DP_TRAINER_CKPT_EVERY)] + ["dp"])
    writers = [sum(e["event"] == "checkpoint" for e in ev) for ev in first]
    per_step = [(c[0][0] / steps, c[0][1] / steps) for run, steps in
                ((runs[0], DP_TRAINER_STEPS), (runs[1], 1)) for c in
                [r["counts"] for r in run]]
    result = dict(
        config="sceneflow_config() + reg_cuda through train()",
        ranks=list(DP_RANKS), steps=DP_TRAINER_STEPS,
        checkpoints=ckpts, checkpoint_records_per_rank=writers,
        losses=[la[s] for s in sorted(la)],
        restored_step_loss=losses(second[0]).get(DP_TRAINER_CKPT_EVERY + 1),
        uninterrupted_step_loss=la.get(DP_TRAINER_CKPT_EVERY + 1),
        launches_per_step_per_rank=sorted(set(per_step)),
        others=[r["counts"][1:] for run in runs for r in run],
        left=[r["left"] for run in runs for r in run], wall_s=walls)
    emit("dp_trainer", **result)
    check(ckpts == want_ckpts and writers[0] > 0 and writers[1] == 0,
          f"dp_trainer: checkpoints {ckpts}, records by rank {writers}")
    check(losses(first[1]) == la and sorted(la) == list(
        range(1, DP_TRAINER_STEPS + 1)), "dp_trainer: the ranks' losses "
                                         "differ or steps are missing")
    check(result["restored_step_loss"] == result["uninterrupted_step_loss"]
          == losses(second[1]).get(DP_TRAINER_CKPT_EVERY + 1),
          f"dp_trainer: the restored step's loss "
          f"{result['restored_step_loss']} is not the uninterrupted "
          f"run's {result['uninterrupted_step_loss']}")
    # batch 4 a rank: the auto save policy keeps the lookups
    want = (float(tcfg.train_iters), float(tcfg.train_iters))
    check(result["launches_per_step_per_rank"] == [want]
          and not any(c != (0, 0) for o in result["others"] for c in o),
          f"dp_trainer: launches {result['launches_per_step_per_rank']}, "
          f"others {result['others']}")
    check(not any(result["left"]), f"dp_trainer: left {result['left']}")
    return result


def check_events(run_dir, frames):
    """The run's events.jsonl: schema-valid (the port's validate_events),
    one ``step`` a frame, one ``validation``; returns the event counts."""
    import collections
    from raft_stereo_tpu_torch.obs import read_events, validate_events
    events = read_events(os.path.join(run_dir, "events.jsonl"))
    errors = validate_events(events)
    check(not errors, f"{run_dir}: events.jsonl fails the schema: "
                      f"{errors[:5]}")
    kinds = collections.Counter(e["event"] for e in events)
    check(kinds["step"] == frames and kinds["validation"] == 1,
          f"{run_dir}: {kinds['step']} step and {kinds['validation']} "
          f"validation records for {frames} frames")
    return dict(kinds)


def frame_rates(run_dir, streamed):
    """The timed frames' (index > 1, as validate_kitti's warmup_frames=1)
    rates from a run's step records, over the first and the second half
    of them: sequentially ``kitti-fps`` (device forward) and
    ``kitti-fps-e2e`` (predict call) with the device forward's quartiles
    (ms); streamed ``kitti-fps-e2e`` (frames over the span between their
    retires)."""
    import numpy as np
    from raft_stereo_tpu_torch.obs import read_events
    steps = [e for e in read_events(os.path.join(run_dir, "events.jsonl"))
             if e["event"] == "step"]
    half = (len(steps) - 2) // 2
    if streamed:  # the span from frame 1's retire to frame k's
        t = [e["t"] for e in steps[1:]]
        return {"kitti-fps-e2e_halves": [half / (t[half] - t[0]),
                                         (len(t) - 1 - half)
                                         / (t[-1] - t[half])]}
    dev = [e["dispatch_s"] for e in steps[2:]]
    call = [e["dispatch_s"] + e["fetch_s"] for e in steps[2:]]
    return {"kitti-fps_halves": [1 / np.mean(dev[:half]),
                                 1 / np.mean(dev[half:])],
            "kitti-fps-e2e_halves": [1 / np.mean(call[:half]),
                                     1 / np.mean(call[half:])],
            "device_ms_quartiles": [float(np.percentile(dev, p)) * 1e3
                                    for p in (25, 50, 75)]}


def idle_share(fn):
    """Run ``fn`` under torch.profiler: the share of the span from its first
    device kernel's start to its last one's end in which no kernel ran
    (kernels of one stream do not overlap), and the kernel count."""
    kernels = device_kernels(fn)
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    return 1.0 - busy / span, len(kernels), busy / 1e3, span / 1e3


def run_eval_kitti(dev, work, all_kernels, ws_kernel):
    """eval_kitti: validate_kitti on a KITTI tree of EVAL_FRAMES frames at
    375x1242 (default architecture, reg_cuda, mixed precision as the eval
    entry point sets it, 32 iterations, warmup_frames=1), sequential and
    streamed (window 3, decoded in worker processes as the port's datasets
    are), each with an events.jsonl; the same stream with decode threads
    (the dataset behind a plain wrapper), for what processes save; then
    one profiled streamed run for the card's idle share. The host's decode
    of a frame is timed alone first. Returns the phase's fields and the
    tree and checkpoint eval_cli reuses."""
    import numpy as np
    import torch
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.data import KITTI
    from raft_stereo_tpu_torch.eval.stream import (StreamConfig,
                                                   decodes_in_processes,
                                                   run_frames)
    from raft_stereo_tpu_torch.eval.validate import validate_kitti
    from raft_stereo_tpu_torch.inference import StereoPredictor
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.obs import Telemetry
    iters, frames, (h, w) = EVAL_ITERS, EVAL_FRAMES, EVAL_KITTI_HW
    t0 = time.perf_counter()
    tree = write_kitti_tree(os.path.join(work, "kitti"), frames, h, w,
                            SEED + 200)
    write_s = time.perf_counter() - t0
    ds = KITTI(root=os.path.join(tree, "KITTI"))
    decode_s = []
    for i in range(6):  # one frame's three PNGs, on this thread alone
        t0 = time.perf_counter()
        ds.sample(i)
        decode_s.append(time.perf_counter() - t0)
    cfg = RAFTStereoConfig(corr_implementation="reg_cuda",
                           mixed_precision=True)
    state = seeded_weights(RAFTStereo(cfg), SEED)
    ckpt = os.path.join(work, "eval_kitti.pth")
    torch.save(state, ckpt)
    pred = StereoPredictor(cfg, state, valid_iters=iters, device=dev)
    stream = StreamConfig(enabled=True, window=3)
    check(decodes_in_processes(ds),
          "eval_kitti: the KITTI dataset does not decode in processes")
    runs = {}
    for mode, arg in (("sequential", False), ("streamed", stream)):
        rec = FlowRecorder(pred)
        run_dir = os.path.join(work, f"eval_kitti_{mode}")
        tel = Telemetry(run_dir, stall_deadline_s=None, device=dev)
        tel.run_start(config={"dataset": "kitti", "valid_iters": iters,
                              "stream": mode})
        for k in all_kernels:
            k.launches = 0
        t_run = time.perf_counter()
        res = validate_kitti(rec, root=tree, iters=iters, warmup_frames=1,
                             telemetry=tel, stream=arg)
        wall = time.perf_counter() - t_run
        launches = {k.__name__: k.launches for k in all_kernels}
        tel.emit("run_end", steps=tel.steps, ok=True)
        tel.close()
        check(launches[ws_kernel.__name__] == iters * frames
              and sum(launches.values()) == iters * frames,
              f"eval_kitti {mode}: launches {launches}, expected "
              f"{iters} {ws_kernel.__name__} launches a frame")
        check(len(rec.flows) == frames and all(
            f.shape == (1, h, w, 1) and np.isfinite(f).all()
            for f in rec.flows), f"eval_kitti {mode}: bad flows")
        runs[mode] = dict(results=res, flows=rec.flows, wall_s=wall,
                          launches=launches,
                          events=check_events(run_dir, frames),
                          rates=frame_rates(run_dir, arg))
    seq, strm = runs["sequential"], runs["streamed"]

    class OnThreads:  # not a port dataset: the driver decodes on threads
        def __len__(self):
            return len(ds)

        def sample(self, i):
            return ds.sample(i)

    thr_flows, thr_e2e = [], []

    def on_frame(i, sample, flow, timing):
        thr_flows.append(flow[None])
        if i > 1:  # validate_kitti's warmup_frames=1
            thr_e2e.append(timing.e2e_s)
    t_run = time.perf_counter()
    run_frames(pred, OnThreads(), on_frame, iters=iters, stream=stream)
    thr_wall = time.perf_counter() - t_run
    same = all(np.array_equal(a, b) and np.array_equal(a, c)
               for a, b, c in zip(seq["flows"], strm["flows"], thr_flows))
    check(same, "eval_kitti: streamed flows differ from sequential")
    for key in ("kitti-epe", "kitti-d1"):
        check(seq["results"][key] == strm["results"][key],
              f"eval_kitti: {key} {strm['results'][key]} streamed, "
              f"{seq['results'][key]} sequential")
    check({"kitti-fps", "kitti-fps-e2e"} <= set(seq["results"])
          and "kitti-fps-e2e" in strm["results"]
          and "kitti-fps" not in strm["results"],
          f"eval_kitti: FPS keys {sorted(seq['results'])} / "
          f"{sorted(strm['results'])}")
    thr_fps = 1.0 / float(np.mean(thr_e2e))
    idle, n_kernels, busy_ms, span_ms = idle_share(
        lambda: validate_kitti(pred, root=tree, iters=iters,
                               warmup_frames=1, stream=stream))
    del pred
    result = dict(frames=frames, size=[h, w],
                  cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                  iters=iters, dtype="bfloat16 (mixed precision)",
                  launches={m: r["launches"] for m, r in runs.items()},
                  launches_per_frame=strm["launches"][ws_kernel.__name__]
                  / frames, tree_write_s=write_s,
                  decode_ms_per_frame_median=statistics.median(
                      decode_s[1:]) * 1e3,
                  decode_ms_per_frame=[t * 1e3 for t in decode_s],
                  sequential=seq["results"], streamed=strm["results"],
                  streamed_on_decode_threads={"kitti-fps-e2e": thr_fps},
                  wall_s={**{m: r["wall_s"] for m, r in runs.items()},
                          "streamed_on_decode_threads": thr_wall},
                  rates_by_half={m: r["rates"] for m, r in runs.items()},
                  events=strm["events"], flows_bitwise_equal=same,
                  streamed_idle_share=idle,
                  streamed_profiled_kernels=n_kernels,
                  streamed_profiled_busy_ms=busy_ms,
                  streamed_profiled_span_ms=span_ms)
    emit("eval_kitti", **result)
    print(f"eval_kitti: kitti-fps {seq['results']['kitti-fps']:.3f} "
          f"(device, sequential), kitti-fps-e2e "
          f"{seq['results']['kitti-fps-e2e']:.3f} sequential / "
          f"{strm['results']['kitti-fps-e2e']:.3f} streamed / "
          f"{thr_fps:.3f} streamed on decode threads; idle share "
          f"streamed {idle:.3f}", flush=True)
    return result, tree, ckpt


def first_divergence(pred, pair, iters=1):
    """The first leaf module, in call order, whose output for frame 0
    differs between a forward of ``pair`` (its frames in one dispatch) and
    a forward of frame 0 alone: ``(name, type, inputs_equal, max_abs,
    scale)`` (``scale`` the largest magnitude of frame 0's output alone),
    or None when every output is bitwise equal."""
    import torch
    padder, im1, im2, _ = pred._prepared(*pair)
    leaves = [(n, m) for n, m in pred.model.named_modules()
              if not list(m.children())]
    seen, found = [], []

    def record(name, batch):
        def hook(mod, inputs, out):
            if not isinstance(out, torch.Tensor) or found:
                return
            x = inputs[0] if inputs and isinstance(inputs[0],
                                                   torch.Tensor) else None
            if batch == 1:  # copies: later layers may work in place
                seen.append((name, None if x is None else x[:1].clone(),
                             out[:1].clone()))
                return
            k = record.calls
            record.calls += 1
            name1, x1, out1 = seen[k]
            if not torch.equal(out[:1], out1):
                same_in = (x is not None and x1 is not None
                           and torch.equal(x[:1], x1))
                found.append((name1, type(mod).__name__, same_in,
                              (out[:1].float() - out1.float()).abs().max()
                              .item(), out1.float().abs().max().item()))
        return hook

    for batch, sl in ((1, slice(0, 1)), (2, slice(None))):
        record.calls = 0
        handles = [m.register_forward_hook(record(n, batch))
                   for n, m in leaves]
        try:
            pred._forward(im1[sl], im2[sl], iters)
        finally:
            for h in handles:
                h.remove()
    return found[0] if found else None


def run_eval_microbatch(dev, tree, all_kernels, ws_kernel):
    """eval_microbatch: micro-batch 2 on the card, B1 at B=2. The first
    three frames of eval_kitti's tree go through ``predict_async`` two a
    dispatch, (0, 1), (0, 2) and (2, 0), and one a call through
    ``__call__``, in the eval entry point's numerics (bf16, cuDNN TF32 on)
    and in fp32 (TF32 off), 32 iterations. Checks: 32 windowed_sample
    launches a dispatch and no other kernel's; frame 0's flow bitwise the
    same whatever its partner and slot (no element of a batch leaks into
    another); B1 at B=2 bitwise equal to its two launches at B=1 (the
    kernel's bound) at the KITTI level shapes; the first leaf module whose
    output for frame 0 differs between batch 2 and batch 1 (one
    iteration) gets bitwise equal inputs and departs by rounding, within
    DEPARTURE_REL of its output's magnitude (cuDNN's convolutions and
    PyTorch's reductions choose their kernels by batch size: the gap is
    theirs, and 32 iterations of a random-weight update amplify it); in
    fp32 the frames' EPE within CPU_PARITY_TOL_PX of batch 1's. Reports
    the flows' gap."""
    import numpy as np
    import torch
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.data import KITTI
    from raft_stereo_tpu_torch.inference import StereoPredictor
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.ops.kernels import windowed_sample as ws
    ds = KITTI(root=os.path.join(tree, "KITTI"))
    frames = [ds.sample(i) for i in range(3)]
    left = [f["image1"][None] for f in frames]
    right = [f["image2"][None] for f in frames]

    def epe(flow, f):
        valid = f["valid"] >= 0.5
        return float(np.abs(flow[..., 0] - f["flow"][..., 0])[valid].mean())

    dispatches = ((0, 1), (0, 2), (2, 0))
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32
    for numerics, mixed in (("bf16", True), ("fp32", False)):
        torch.backends.cudnn.allow_tf32 = mixed
        cfg = RAFTStereoConfig(corr_implementation="reg_cuda",
                               mixed_precision=mixed)
        pred = StereoPredictor(cfg, seeded_weights(RAFTStereo(cfg), SEED),
                               valid_iters=EVAL_ITERS, device=dev)
        alone = [pred(left[i], right[i])[0] for i in range(3)]
        for k in all_kernels:
            k.launches = 0
        handles = [pred.predict_async(np.concatenate([left[i], left[j]]),
                                      np.concatenate([right[i], right[j]]))
                   for i, j in dispatches]
        flows = [h.result() for h in handles]
        launches = {k.__name__: k.launches for k in all_kernels}
        good = all(f.shape == (2,) + alone[0].shape and np.isfinite(f).all()
                   for f in flows)
        independent = (np.array_equal(flows[0][0], flows[1][0])
                       and np.array_equal(flows[0][0], flows[2][1])
                       and np.array_equal(flows[1][1], flows[2][0]))
        diverge = first_divergence(pred, (np.concatenate(left[:2]),
                                          np.concatenate(right[:2])))
        rounding = diverge is None or (
            diverge[2] and diverge[3] <= DEPARTURE_REL * diverge[4])
        pairs = [(flows[0][0], alone[0]), (flows[0][1], alone[1]),
                 (flows[1][1], alone[2])]
        epe_gap = max(abs(epe(a, frames[i]) - epe(b, frames[i]))
                      for i, (a, b) in enumerate(pairs))
        dtype = torch.bfloat16 if mixed else torch.float32
        levels = [lookup_inputs((2, 96, 312, 312 >> i), dtype, SEED + i,
                                dev, edges=False)[0] for i in range(4)]
        center = lookup_inputs((2, 96, 312, 312), dtype, SEED + 9, dev,
                               edges=False)[1]
        both = ws.windowed_sample_pyramid_forward(levels, center, RADIUS)
        one = torch.cat([ws.windowed_sample_pyramid_forward(
            [lv[b:b + 1].contiguous() for lv in levels],
            center[b:b + 1].contiguous(), RADIUS) for b in range(2)])
        out[numerics] = dict(
            launches=launches, partner_and_slot_bitwise=independent,
            b1_batch2_bitwise=bool(torch.equal(both, one)),
            first_divergence=None if diverge is None else dict(
                zip(("module", "type", "inputs_equal", "max_abs",
                     "output_max_abs"), diverge)),
            flow_gap_max_px=max(float(np.abs(a - b).max())
                                for a, b in pairs),
            flow_gap_mean_px=max(float(np.abs(a - b).mean())
                                 for a, b in pairs),
            epe_gap_px=epe_gap, epe_batch1=[epe(a, f) for a, f in
                                            zip(alone, frames)])
        emit("eval_microbatch", numerics=numerics, size=list(EVAL_KITTI_HW),
             iters=EVAL_ITERS, dispatches=[list(d) for d in dispatches],
             epe_bound_fp32_px=CPU_PARITY_TOL_PX, **out[numerics])
        check(launches[ws_kernel.__name__] == EVAL_ITERS * len(dispatches)
              and sum(launches.values()) == EVAL_ITERS * len(dispatches),
              f"eval_microbatch {numerics}: launches {launches}, expected "
              f"{EVAL_ITERS} {ws_kernel.__name__} a dispatch")
        check(good, f"eval_microbatch {numerics}: bad flows")
        check(independent, f"eval_microbatch {numerics}: a frame's flow "
                           "depends on its partner or slot")
        check(out[numerics]["b1_batch2_bitwise"],
              f"eval_microbatch {numerics}: B1 at B=2 differs from B=1")
        check(rounding, f"eval_microbatch {numerics}: batch 2 first "
                        f"departs from batch 1 at {diverge}, not by "
                        "rounding from equal inputs")
        check(mixed or epe_gap <= CPU_PARITY_TOL_PX,
              f"eval_microbatch fp32: batch-2 EPE {epe_gap} px from batch "
              "1's")
        del pred
    torch.backends.cudnn.allow_tf32 = tf32
    return out["bf16"]["launches"][ws_kernel.__name__] / len(dispatches)


def run_eval_cli(work, tree, ckpt, streamed):
    """eval_cli: ``python3 -m raft_stereo_tpu_torch.evaluate`` on
    eval_kitti's tree and weights, streamed, in a subprocess: exit 0, the
    streamed run's EPE and D1, a valid events.jsonl (the kernels are
    already built: no compile record)."""
    import ast
    run_dir = os.path.join(work, "eval_cli")
    cmd = [sys.executable, "-m", "raft_stereo_tpu_torch.evaluate",
           "--dataset", "kitti", "--data_root", tree,
           "--corr_implementation", "reg_cuda", "--stream", "on",
           "--run_dir", run_dir, "--restore_ckpt", ckpt]
    t0 = time.perf_counter()
    # a session of its own: whatever it starts and leaves running (its
    # decode pool's fork server) keeps that session after it exits
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        stop_leftovers({pid: cmd_ for pid, (_, sid, cmd_)
                        in live_processes().items() if sid == proc.pid},
                       "eval_cli")
    out = subprocess.CompletedProcess(cmd, proc.returncode, stdout, stderr)
    secs = time.perf_counter() - t0
    check(out.returncode == 0, f"eval_cli exited {out.returncode}:\n"
                               f"{out.stderr[-3000:]}")
    results = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    for key in ("kitti-epe", "kitti-d1"):
        check(results[key] == streamed[key],
              f"eval_cli: {key} {results[key]}, eval_kitti streamed "
              f"{streamed[key]}")
    kinds = check_events(run_dir, EVAL_FRAMES)
    check("compile" not in kinds, f"eval_cli: compile records {kinds}")
    emit("eval_cli", command=" ".join(cmd[1:]), seconds=secs,
         results=results, events=kinds)


def run_eval_middlebury(dev, work, all_kernels, fc_kernel):
    """eval_middlebury: one MiddEval3-F scene at 1988x2880 through
    validate_middlebury (split F, streamed by default) with alt_cuda in
    mixed precision, 32 iterations: 32 fused_corr launches and no other
    kernel's, and the EPE of StereoPredictor.__call__ on the same pair."""
    import numpy as np
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.data import Middlebury, frame_utils, png
    from raft_stereo_tpu_torch.eval.validate import validate_middlebury
    from raft_stereo_tpu_torch.inference import StereoPredictor
    from raft_stereo_tpu_torch.models import RAFTStereo
    h, w, iters, shift = HIRES_H, HIRES_W, EVAL_ITERS, 24
    root = os.path.join(work, "middlebury")
    scene = os.path.join(root, "Middlebury", "MiddEval3", "trainingF",
                         "SceneA")
    os.makedirs(scene)
    left, right = stereo_pair(h, w, SEED + 210, shift=shift)
    png.write_png(os.path.join(scene, "im0.png"), left[0].astype(np.uint8),
                  4)
    png.write_png(os.path.join(scene, "im1.png"), right[0].astype(np.uint8),
                  4)
    disp = np.full((h, w), float(shift), np.float32)
    disp[:, :shift] = np.inf  # no match in the right view: invalid
    frame_utils.write_pfm(os.path.join(scene, "disp0GT.pfm"), disp)
    png.write_png(os.path.join(scene, "mask0nocc.png"),
                  np.where(np.isfinite(disp), 255, 0).astype(np.uint8))
    with open(os.path.join(root, "Middlebury", "MiddEval3",
                           "official_train.txt"), "w") as f:
        f.write("SceneA\n")
    cfg = RAFTStereoConfig(corr_implementation="alt_cuda",
                           mixed_precision=True)
    pred = StereoPredictor(cfg, seeded_weights(RAFTStereo(cfg), SEED),
                           valid_iters=iters, device=dev)
    for k in all_kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = validate_middlebury(pred, root=root, iters=iters, split="F")
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in all_kernels}
    check(launches[fc_kernel.__name__] == iters
          and sum(launches.values()) == iters,
          f"eval_middlebury: launches {launches}, expected {iters} "
          f"{fc_kernel.__name__}")
    sample = Middlebury(root=os.path.join(root, "Middlebury")).sample(0)
    flow = pred(sample["image1"][None], sample["image2"][None])[0]
    gt = sample["flow"]
    valid = (sample["valid"] >= -0.5) & (gt[..., 0] > -1000)
    epe = np.sqrt(np.sum((flow - gt) ** 2, axis=-1))[valid].mean().item()
    check(epe == res["middleburyF-epe"],
          f"eval_middlebury: validator EPE {res['middleburyF-epe']}, "
          f"__call__ EPE {epe}")
    secs = [pred.predict_timed(sample["image1"][None],
                               sample["image2"][None])[1]
            for _ in range(HIRES_RUNS)]
    del pred
    result = dict(size=[h, w], iters=iters,
                  dtype="bfloat16 (mixed precision)", launches=launches,
                  results=res, call_epe=epe, validator_wall_s=wall,
                  ms_per_frame_median=statistics.median(secs) * 1e3,
                  ms_per_frame_runs=[s * 1e3 for s in secs])
    emit("eval_middlebury", **result)
    return result


def run_eval_cpu(dev, work, ws_kernel):
    """eval_cpu: an ETH3D-layout tree (2 frames, 64x128) through
    validate_eth3d, default architecture with reg_cuda in fp32, 4
    iterations, on the card (kernel) and on the CPU (plain version): EPE
    within CPU_PARITY_TOL_PX."""
    import numpy as np
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.data import frame_utils, png
    from raft_stereo_tpu_torch.eval.validate import validate_eth3d
    from raft_stereo_tpu_torch.inference import StereoPredictor
    from raft_stereo_tpu_torch.models import RAFTStereo
    h, w, iters, shift = 64, 128, 4, 6
    root = os.path.join(work, "eth3d")
    for i in range(2):
        scene = os.path.join(root, "ETH3D", "two_view_training", f"s{i}")
        gt = os.path.join(root, "ETH3D", "two_view_training_gt", f"s{i}")
        os.makedirs(scene)
        os.makedirs(gt)
        left, right = stereo_pair(h, w, SEED + 220 + i, shift=shift)
        png.write_png(os.path.join(scene, "im0.png"),
                      left[0].astype(np.uint8))
        png.write_png(os.path.join(scene, "im1.png"),
                      right[0].astype(np.uint8))
        frame_utils.write_pfm(os.path.join(gt, "disp0GT.pfm"),
                              np.full((h, w), float(shift), np.float32))
    cfg = RAFTStereoConfig(corr_implementation="reg_cuda")
    state = seeded_weights(RAFTStereo(cfg), SEED)
    res = {}
    for where in (dev, "cpu"):
        pred = StereoPredictor(cfg, state, valid_iters=iters, device=where)
        ws_kernel.launches = 0
        res[str(where)] = validate_eth3d(pred, root=root, iters=iters,
                                         stream=False)
        want = iters * 2 if where == dev else 0
        check(ws_kernel.launches == want,
              f"eval_cpu on {where}: {ws_kernel.launches} launches, "
              f"expected {want}")
    card, cpu = res[str(dev)], res["cpu"]
    dev_px = abs(card["eth3d-epe"] - cpu["eth3d-epe"])
    emit("eval_cpu", size=[h, w], iters=iters, card=card, cpu=cpu,
         epe_abs_diff_px=dev_px, bound_px=CPU_PARITY_TOL_PX)
    check(dev_px <= CPU_PARITY_TOL_PX,
          f"eval_cpu: card and CPU EPE differ by {dev_px} px")


# the serving phases: requests of KITTI size, padded to the 384x1248 bucket
SERVE_HW = (375, 1242)
SERVE_SMALL_HW = (188, 621)  # pads to 192x640, below SERVE_FUSED_WIDTH
SERVE_FUSED_WIDTH = 1248
SERVE_LINGER_S = 0.5         # long enough for four submits to group
# depths at which serve reports batch 4 against batch 1 (besides the
# served 32); the bar holds at 4, the card-vs-CPU parity depth
SERVE_DEPTHS = (1, 4)
REALTIME_REQUESTS = 30
REALTIME_PROFILED = 10
LOADTEST_SHAPES = ("375x1242", "352x1216", "320x1024")


def padded_hw(hw):
    """The /32 bucket of a raw (H, W)."""
    return tuple(-(-n // 32) * 32 for n in hw)


def serve_pairs(n, seed, hw=None):
    """``n`` textured HWC pairs (stereo_pair's, shift 12 px) of
    ``hw`` (default SERVE_HW)."""
    return [tuple(x[0] for x in stereo_pair(*(hw or SERVE_HW), seed + i))
            for i in range(n)]


def served(server, all_kernels, submits):
    """Submit ``submits`` ((left, right, kwargs) each) together and wait
    for every result; each kernel's launches in that window."""
    for k in all_kernels:
        k.launches = 0
    handles = [server.submit(left, right, **kw)
               for left, right, kw in submits]
    results = [h.result(timeout=600) for h in handles]
    return results, {k.__name__: k.launches for k in all_kernels}


def check_launches(phase, counts, kernel, per_dispatch, dispatches=1):
    """``kernel`` launched ``per_dispatch`` times a dispatch and no other
    kernel at all."""
    want = {name: 0 for name in counts}
    want[kernel.__name__] = per_dispatch * dispatches
    check(counts == want, f"{phase}: launches {counts}, expected {want}")


def run_serve(dev, all_kernels, ws_kernel, state):
    """serve: StereoServer on the default architecture (reg_cuda, fp32,
    32 iterations) at 375x1242 (bucket 384x1248), max_batch 4, window 2,
    linger SERVE_LINGER_S: a batch-1 served flow bitwise the predictor's;
    four concurrent requests in one dispatch, bitwise the predictor's
    batch of four; against batch 1 their first departure a rounding
    difference from equal inputs (first_divergence), within
    CPU_PARITY_TOL_PX at 4 iterations and reported at 1, 4 and the
    served 32 (max and mean per request); a NaN pixel in one of four
    fails that request alone and leaves the three others bitwise their
    clean-batch flows; a three-frame warm-start session bitwise
    RAFTStereo.forward driven by hand with the previous frame's low-res
    flow; a reload mid-traffic drops nothing and later flows are bitwise
    a fresh server's on the new weights; drain finishes what was admitted
    and refuses the rest. windowed_sample 32 times a dispatch, nothing
    else; a 32-entry residual curve a request."""
    import numpy as np
    import torch
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.inference import StereoPredictor
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.serve import (ServeConfig, ServerDraining,
                                             StereoServer)
    from raft_stereo_tpu_torch.serve.cache import padded_batch
    t0 = time.perf_counter()
    cfg = RAFTStereoConfig(corr_implementation="reg_cuda")
    iters = EVAL_ITERS
    bucket = padded_hw(SERVE_HW)
    label = f"{bucket[0]}x{bucket[1]}b1i{iters}"
    knobs = dict(max_batch=4, window=2, default_iters=iters,
                 linger_s=SERVE_LINGER_S)
    pairs = serve_pairs(4, SEED + 300)
    pred = StereoPredictor(cfg, state, valid_iters=iters, device=dev)
    server = StereoServer(cfg, state, ServeConfig(**knobs), device=dev)
    fresh = None
    try:
        server.warmup([SERVE_HW], batch_sizes=(1, 4))
        server.warmup([SERVE_HW], batch_sizes=(1,), warm=True)
        single = [pred(left[None], right[None])[0] for left, right in pairs]
        # batch 1 against the predictor
        (res,), counts = served(server, all_kernels, [(*pairs[0], {})])
        check_launches("serve b1", counts, ws_kernel, iters)
        check(res.ok and res.batch_size == 1
              and res.bucket == label
              and np.array_equal(res.flow, single[0]),
              f"serve: batch-1 flow not the predictor's ({res.bucket})")
        check(res.residuals.shape == (iters,)
              and np.isfinite(res.residuals).all(),
              f"serve: residual curve {res.residuals}")
        b1_ms = res.latency_s * 1e3
        # four in one dispatch, then the same with one poisoned
        clean, counts = served(server, all_kernels,
                               [(l, r, {}) for l, r in pairs])
        check_launches("serve b4", counts, ws_kernel, iters)
        check(all(r.ok and r.batch_size == 4 for r in clean),
              f"serve: batch sizes {[r.batch_size for r in clean]}")
        # batch 4 is the predictor's batch 4 bitwise; against batch 1 the
        # convolutions' algorithms differ by batch size: the first
        # departure is a rounding difference from equal inputs, held to
        # the parity bar at the card-vs-CPU parity depth (4 iterations),
        # and reported at every depth (the refinement amplifies it)
        stacked = tuple(np.stack(x) for x in zip(*pairs))
        check(all(np.array_equal(r.flow, f) for r, f in
                  zip(clean, pred(*stacked))),
              "serve: batch 4 served is not the predictor's batch 4")
        b4_dev = {}
        for depth in SERVE_DEPTHS:
            four = pred(*stacked, depth)
            one = [pred(l[None], r[None], depth)[0] for l, r in pairs]
            diff = [np.abs(a - b) for a, b in zip(four, one)]
            b4_dev[depth] = dict(max_abs_px=[float(d.max()) for d in diff],
                                 mean_abs_px=[float(d.mean())
                                              for d in diff])
        b4_dev[iters] = dict(
            max_abs_px=[float(np.abs(r.flow - s).max())
                        for r, s in zip(clean, single)],
            mean_abs_px=[float(np.abs(r.flow - s).mean())
                         for r, s in zip(clean, single)])
        diverge = first_divergence(pred, stacked)
        check(diverge is None or (diverge[2] and diverge[3]
                                  <= DEPARTURE_REL * diverge[4]),
              f"serve: batch 4 departs from batch 1 at {diverge}")
        check(max(b4_dev[4]["max_abs_px"]) <= CPU_PARITY_TOL_PX,
              f"serve: batch 4 against batch 1 at 4 iterations "
              f"{b4_dev[4]} px")
        bad = [(l.copy(), r) for l, r in pairs]
        bad[2][0][0, 0, 0] = np.nan
        poisoned, counts = served(server, all_kernels,
                                  [(l, r, {}) for l, r in bad])
        check_launches("serve poison", counts, ws_kernel, iters)
        check([r.ok for r in poisoned] == [True, True, False, True]
              and poisoned[2].error_kind == "nonfinite_output"
              and all(poisoned[j].flow is not None and np.array_equal(
                  poisoned[j].flow, clean[j].flow) for j in (0, 1, 3)),
              f"serve: poison isolation {[r.error_kind for r in poisoned]}")
        # a warm-start session against the model driven by hand
        f = cfg.factor
        init = np.zeros((1, bucket[0] // f, bucket[1] // f, 2), np.float32)
        for k, (left, right) in enumerate(pairs[:3]):
            (res,), counts = served(server, all_kernels, [
                (left, right, dict(stream="cam", warm_start=True))])
            check_launches("serve warm", counts, ws_kernel, iters)
            im1, padders, _ = padded_batch([left], bucket, dev)
            im2, _, _ = padded_batch([right], bucket, dev)
            with torch.inference_mode():
                lr, up = server.cache.model(
                    im1, im2, iters=iters,
                    flow_init=torch.from_numpy(init).to(dev))
            check(res.ok and res.bucket == label + "w"
                  and np.array_equal(res.flow,
                                     padders[0].unpad(up)[0].cpu().numpy())
                  and np.array_equal(res.flow_lowres, lr[0].cpu().numpy()),
                  f"serve: warm frame {k} is not the forward from the "
                  "previous frame's low-res flow")
            init = res.flow_lowres[None]
        # a reload mid-traffic
        new = seeded_weights(RAFTStereo(cfg), SEED + 1)
        handles = [server.submit(l, r) for l, r in pairs]
        server.reload(new, note="chip_smoke")
        handles.append(server.submit(*pairs[3]))
        check(all(h.result(timeout=600).ok for h in handles),
              "serve: a request around the reload failed")
        (after,), _ = served(server, all_kernels, [(*pairs[1], {})])
        fresh = StereoServer(cfg, new, ServeConfig(**knobs), device=dev)
        want = fresh.submit(*pairs[1]).result(timeout=600)
        check(after.ok and np.array_equal(after.flow, want.flow)
              and not np.array_equal(after.flow, single[1]),
              "serve: after the reload, not the fresh server's flow")
        # drain
        handles = [server.submit(l, r) for l, r in pairs[:3]]
        server.request_drain()
        try:
            server.submit(*pairs[3])
            refused = False
        except ServerDraining:
            refused = True
        check(refused and all(h.result(timeout=600).ok for h in handles)
              and server.join(timeout=600),
              "serve: drain did not finish what it admitted")
        stats = server.stats()
    finally:
        server.close(timeout=600)
        if fresh is not None:
            fresh.close(timeout=600)
    result = dict(config="default, reg_cuda, fp32", shape=list(SERVE_HW),
                  bucket=list(bucket), iters=iters, max_batch=4, window=2,
                  linger_s=SERVE_LINGER_S,
                  launches_per_dispatch=iters,
                  batch4_vs_batch1_by_iterations=b4_dev,
                  batch4_first_departure=diverge,
                  bound_px_at_4_iterations=CPU_PARITY_TOL_PX,
                  b1_latency_ms=b1_ms,
                  b4_latency_ms=[r.latency_s * 1e3 for r in clean],
                  residual_curve_len=iters, stats=stats,
                  seconds=time.perf_counter() - t0)
    emit("serve", **result)
    return result, single[0]


def run_serve_realtime(dev, all_kernels, ws_kernel):
    """serve_realtime: the server on realtime_config() (bf16, 7
    iterations) at 375x1242, batch 1, one client waiting for each result
    (a camera's loop): 7 windowed_sample launches a dispatch;
    REALTIME_REQUESTS timed requests (median and p99 latency, pairs/s);
    REALTIME_PROFILED more under torch.profiler for the card's idle
    share. No bound: figures."""
    import numpy as np
    from raft_stereo_tpu_torch.config import realtime_config
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.serve import ServeConfig, StereoServer
    cfg = realtime_config()
    iters = 7
    state = seeded_weights(RAFTStereo(cfg), SEED)
    pairs = serve_pairs(4, SEED + 320)
    server = StereoServer(cfg, state, ServeConfig(
        max_batch=1, window=2, default_iters=iters), device=dev)
    try:
        server.warmup([SERVE_HW], batch_sizes=(1,))
        (res,), counts = served(server, all_kernels, [(*pairs[0], {})])
        check_launches("serve_realtime", counts, ws_kernel, iters)
        check(res.ok and res.residuals.shape == (iters,),
              "serve_realtime: a request failed")
        lat = []
        t0 = time.perf_counter()
        for i in range(REALTIME_REQUESTS):
            r = server.submit(*pairs[i % 4]).result(timeout=600)
            check(r.ok, "serve_realtime: a request failed")
            lat.append(r.latency_s * 1e3)
        wall = time.perf_counter() - t0

        def profiled():
            for i in range(REALTIME_PROFILED):
                server.submit(*pairs[i % 4]).result(timeout=600)
        idle, n_kernels, busy_ms, span_ms = idle_share(profiled)
    finally:
        server.close(timeout=600)
    result = dict(config="realtime_config(), bf16", shape=list(SERVE_HW),
                  bucket=list(padded_hw(SERVE_HW)), iters=iters,
                  requests=len(lat),
                  launches_per_dispatch=iters,
                  latency_ms_p50=float(np.percentile(lat, 50)),
                  latency_ms_p99=float(np.percentile(lat, 99)),
                  latency_ms=lat, pairs_per_s=len(lat) / wall,
                  idle_share=idle, kernels_per_request=n_kernels
                  / REALTIME_PROFILED,
                  busy_ms_per_request=busy_ms / REALTIME_PROFILED,
                  span_ms=span_ms)
    emit("serve_realtime", **result)
    return result


def run_serve_fused(dev, all_kernels, ws_kernel, fc_kernel, state,
                    reg_flow):
    """serve_fused: one server (default architecture, reg_cuda, fp32, 32
    iterations) with fused_width=SERVE_FUSED_WIDTH: a 375x1242 request
    rides the 384x1248+fused bucket (fused_corr 32 times a dispatch, no
    windowed_sample), a 188x621 request rides 192x640 (windowed_sample
    32 times, no fused_corr). The +fused flow against reg_cuda's for the
    same pair (serve's, and the predictor's at SERVE_DEPTHS): another
    order of summation, within CPU_PARITY_TOL_PX at 4 iterations and
    reported at 1, 4 and 32."""
    import numpy as np
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.inference import StereoPredictor
    from raft_stereo_tpu_torch.serve import ServeConfig, StereoServer
    cfg = RAFTStereoConfig(corr_implementation="reg_cuda")
    iters = EVAL_ITERS
    big = serve_pairs(1, SEED + 300)[0]
    small = serve_pairs(1, SEED + 330, SERVE_SMALL_HW)[0]
    pred = StereoPredictor(cfg, state, valid_iters=iters, device=dev)
    reg = {d: pred(big[0][None], big[1][None], d)[0] for d in SERVE_DEPTHS}
    reg[iters] = reg_flow
    del pred
    server = StereoServer(cfg, state, ServeConfig(
        max_batch=1, default_iters=iters, fused_width=SERVE_FUSED_WIDTH),
        device=dev)
    try:
        server.warmup([SERVE_HW, SERVE_SMALL_HW], batch_sizes=(1,))
        (wide,), counts = served(server, all_kernels, [(*big, {})])
        check_launches("serve_fused +fused", counts, fc_kernel, iters)
        (narrow,), counts_narrow = served(server, all_kernels,
                                          [(*small, {})])
        check_launches("serve_fused reg", counts_narrow, ws_kernel, iters)
        fused = {d: server.submit(*big, iters=d).result(timeout=600)
                 for d in SERVE_DEPTHS}
        fused[iters] = wide
    finally:
        server.close(timeout=600)
    (bh, bw), (sh, sw) = padded_hw(SERVE_HW), padded_hw(SERVE_SMALL_HW)
    check(wide.ok and wide.bucket == f"{bh}x{bw}b1i{iters}+fused"
          and narrow.ok and narrow.bucket == f"{sh}x{sw}b1i{iters}"
          and all(r.ok and r.bucket.endswith("+fused")
                  for r in fused.values()),
          f"serve_fused: buckets {wide.bucket}, {narrow.bucket}")
    dev_px = {d: dict(max_abs_px=float(np.abs(fused[d].flow - reg[d]).max()),
                      mean_abs_px=float(np.abs(fused[d].flow
                                               - reg[d]).mean()))
              for d in fused}
    result = dict(fused_width=SERVE_FUSED_WIDTH,
                  buckets=[wide.bucket, narrow.bucket], iters=iters,
                  launches_per_dispatch={"+fused": counts,
                                         "reg": counts_narrow},
                  fused_vs_reg_by_iterations=dev_px,
                  bound_px_at_4_iterations=CPU_PARITY_TOL_PX,
                  latency_ms=[wide.latency_s * 1e3, narrow.latency_s * 1e3])
    emit("serve_fused", **result)
    check(dev_px[4]["max_abs_px"] <= CPU_PARITY_TOL_PX,
          f"serve_fused: +fused and reg_cuda flows {dev_px} px apart")
    return result


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for_line(path, text, proc, timeout):
    """Wait until the file ``path`` holds ``text`` (False if ``proc``
    exits first or the time runs out)."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        with open(path, errors="replace") as f:
            if text in f.read():
                return True
        if proc.poll() is not None:
            return False
        time.sleep(0.1)
    return False


def http_predict(base, left, right):
    """POST one pair to /v1/predict: (status, headers, flow or None)."""
    import io
    import urllib.error
    import urllib.request
    import numpy as np
    buf = io.BytesIO()
    np.savez(buf, left=left, right=right)
    req = urllib.request.Request(f"{base}/v1/predict", data=buf.getvalue(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            with np.load(io.BytesIO(resp.read())) as npz:
                return resp.status, dict(resp.headers), npz["flow"]
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), None


def run_serve_http(dev, work, final):
    """serve_http: python3 -m raft_stereo_tpu_torch.serve in a session of
    its own on the card (default architecture, reg_cuda, 32 iterations,
    PyTorch's TF32 defaults as the entry point leaves them), its weights
    train_trainer's final checkpoint (--restore_ckpt) and --ckpt_dir its
    directory: a POSTed pair's flow bitwise the in-process server's on the
    same weights; /healthz, /slo and /metrics answer; a newer checkpoint
    written into the directory, SIGHUP reloads it (the log names it) and
    the next flow is the in-process server's on those weights; SIGTERM
    drains, exit 0, nothing left running; an events.jsonl the port's
    validate_events passes."""
    import signal
    import urllib.request
    import numpy as np
    import torch
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.obs import read_events, validate_events
    from raft_stereo_tpu_torch.serve import ServeConfig, StereoServer
    from raft_stereo_tpu_torch.training.checkpoint import (load_payload,
                                                           save_train_state)
    from raft_stereo_tpu_torch.utils.weights import load_weights
    t0 = time.perf_counter()
    cfg = RAFTStereoConfig(corr_implementation="reg_cuda")
    ckpt_dir, name = os.path.split(final)
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    run_dir = os.path.join(work, "serve_http")
    log_path = os.path.join(work, "serve_http.log")
    cmd = [sys.executable, "-m", "raft_stereo_tpu_torch.serve",
           "--restore_ckpt", final, "--ckpt_dir", ckpt_dir,
           "--ckpt_name", name, "--corr_implementation", "reg_cuda",
           "--iters", str(EVAL_ITERS), "--port", str(port),
           "--max_batch", "1", "--warm_shapes",
           f"{SERVE_HW[0]}x{SERVE_HW[1]}", "--run_dir", run_dir,
           "--heartbeat_every", "2"]
    left, right = serve_pairs(1, SEED + 340)[0]
    # the entry point leaves PyTorch's TF32 defaults (cuDNN's on): the
    # in-process server runs under the same
    torch.backends.cudnn.allow_tf32 = True
    local = None
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        check(wait_for_line(log_path, "listening on", proc, 600),
              "serve_http: the server did not start:\n"
              + open(log_path).read()[-3000:])
        started = time.perf_counter() - t0
        local = StereoServer(cfg, load_weights(final, cfg),
                             ServeConfig(max_batch=1,
                                         default_iters=EVAL_ITERS),
                             device=dev)
        status, headers, flow = http_predict(base, left, right)
        want = local.submit(left, right).result(timeout=600)
        check(status == 200 and np.array_equal(flow, want.flow),
              f"serve_http: POST {status}, not the in-process flow")
        answers = {}
        for path in ("/healthz", "/slo", "/metrics"):
            with urllib.request.urlopen(base + path, timeout=60) as resp:
                answers[path] = (resp.status, resp.read().decode())
        check(all(s == 200 for s, _ in answers.values())
              and json.loads(answers["/slo"][1])["completed"] == 1
              and "raft_serve_requests_completed_total"
              in answers["/metrics"][1],
              f"serve_http: endpoints {answers}")
        # a newer checkpoint of the same run, then SIGHUP
        new = seeded_weights(RAFTStereo(cfg), SEED + 2)
        payload = load_payload(final)
        payload["model"] = new
        newer = save_train_state(ckpt_dir, name, payload,
                                 step=TRAINER_STEPS + 1)
        os.kill(proc.pid, signal.SIGHUP)
        check(wait_for_line(log_path, f"hot-reloaded model weights "
                                      f"({newer})", proc, 120),
              "serve_http: SIGHUP did not reload " + newer + ":\n"
              + open(log_path).read()[-3000:])
        status2, headers2, flow2 = http_predict(base, left, right)
        local.reload(new)
        want2 = local.submit(left, right).result(timeout=600)
        check(status2 == 200 and np.array_equal(flow2, want2.flow)
              and not np.array_equal(flow2, flow),
              "serve_http: after SIGHUP, not the new weights' flow")
        os.kill(proc.pid, signal.SIGTERM)
        rc = proc.wait(timeout=600)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        if local is not None:
            local.close(timeout=600)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        stop_leftovers({pid: c for pid, (_, sid, c)
                        in live_processes().items() if sid == proc.pid},
                       "serve_http")
    text = open(log_path).read()
    check(rc == 0 and "drain complete" in text,
          f"serve_http: exit {rc}:\n{text[-3000:]}")
    events = read_events(os.path.join(run_dir, "events.jsonl"))
    errors = validate_events(events)
    requests = [e for e in events if e["event"] == "request"]
    check(not errors and len(requests) == 2
          and all(e["status"] == "ok" for e in requests),
          f"serve_http: events {errors[:5]}, {len(requests)} requests")
    result = dict(command=" ".join(cmd[1:]), exit_code=rc,
                  startup_s=started, reloaded=newer,
                  headers=[headers, headers2],
                  requests=len(requests), seconds=time.perf_counter() - t0)
    emit("serve_http", **result)
    return result


def run_loadtest(work):
    """loadtest: python3 -m raft_stereo_tpu_torch.serve.loadtest on
    realtime_config() (seeded weights in a .pth), 7 iterations, shapes
    LOADTEST_SHAPES (three buckets), 8 clients x 4 requests, one video
    stream, request 5 poisoned, in a session of its own: exit 0, nothing
    lost, exactly one nonfinite_output (the poisoned one), the video
    session's frames served warm; served pairs/s beside the sequential
    baseline's, p50/p99 latency; both runs' events.jsonl pass the port's
    validate_events."""
    import torch
    from raft_stereo_tpu_torch.config import realtime_config
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.obs import read_events, validate_events
    t0 = time.perf_counter()
    ckpt = os.path.join(work, "realtime_seeded.pth")
    torch.save(seeded_weights(RAFTStereo(realtime_config()), SEED), ckpt)
    run_dir = os.path.join(work, "loadtest")
    log_path = os.path.join(work, "loadtest.log")
    cmd = [sys.executable, "-m", "raft_stereo_tpu_torch.serve.loadtest",
           "--restore_ckpt", ckpt, "--shared_backbone", "--n_downsample",
           "3", "--n_gru_layers", "2", "--slow_fast_gru",
           "--corr_implementation", "reg_cuda", "--mixed_precision",
           "--iters", "7", "--shapes", *LOADTEST_SHAPES, "--clients", "8",
           "--requests_per_client", "4", "--video_streams", "1",
           "--poison_at", "5", "--run_dir", run_dir, "--no_progress",
           "--heartbeat_every", "2"]
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        stop_leftovers({pid: c for pid, (_, sid, c)
                        in live_processes().items() if sid == proc.pid},
                       "loadtest")
    text = open(log_path).read()
    lines = [ln for ln in text.splitlines()
             if ln.startswith("LOADTEST summary ")]
    check(rc == 0 and lines, f"loadtest: exit {rc}:\n{text[-3000:]}")
    summary = json.loads(lines[-1][len("LOADTEST summary "):])
    served_ = summary["served"]
    kinds = {}
    for phase in ("seq", "serve"):
        events = read_events(os.path.join(run_dir, phase, "events.jsonl"))
        errors = validate_events(events)
        check(not errors, f"loadtest {phase}: events {errors[:5]}")
        kinds[phase] = events
    requests = [e for e in kinds["serve"] if e["event"] == "request"]
    nonfinite = [e for e in requests if e["status"] == "error"]
    warm = [e for e in requests if e.get("stream") == "video0"]
    buckets = sorted({e["bucket"].split("b")[0] for e in requests})
    check(served_["lost"] == 0 and served_["failed"] == 1
          and served_["poisoned_failed"] == 1 and len(nonfinite) == 1
          and "non-finite" in nonfinite[0].get("error", "")
          and len(warm) == 4 and all(e["status"] == "ok"
                                     and e["bucket"].endswith("w")
                                     for e in warm)
          and len(buckets) == 3,
          f"loadtest: {served_}, {len(nonfinite)} errors, warm {warm}")
    result = dict(command=" ".join(cmd[1:]), exit_code=rc,
                  buckets=buckets, requests=served_["submitted"],
                  ok=served_["ok"], failed=served_["failed"],
                  lost=served_["lost"], warm_frames=len(warm),
                  served_pairs_per_s=served_["pairs_per_sec"],
                  sequential_pairs_per_s=summary["sequential"][
                      "pairs_per_sec"],
                  latency_ms_p50=served_["slo"]["p50_ms"],
                  latency_ms_p99=served_["slo"]["p99_ms"],
                  batch_sizes=sorted({e["batch_size"] for e in requests}),
                  seconds=time.perf_counter() - t0)
    emit("loadtest", **result)
    return result


# --- the report tools on the card's logs --------------------------------------

REPORT_WORKERS = 8               # report subprocesses at a time (8 host cores)
REPORT_FORBIDDEN = ("jax", "jaxlib", "flax", "raft_stereo_tpu")

#: python -m raft_stereo_tpu_torch.cli <args>, then the modules it loaded
CLI_RUNNER = """
import json, runpy, sys
sys.argv = ["raft_stereo_tpu_torch.cli"] + sys.argv[1:]
try:
    runpy.run_module("raft_stereo_tpu_torch.cli", run_name="__main__",
                     alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
print("CLI_EXIT " + json.dumps({"rc": rc, "forbidden": bad}),
      file=sys.stderr)
sys.exit(rc)
""" % (REPORT_FORBIDDEN,)


def keep_logs(src, dst):
    """Copy every events.jsonl under ``src`` to the same place under
    ``dst`` (the report phase reads them after ``src`` is gone)."""
    import shutil
    for root, _, files in os.walk(src):
        if "events.jsonl" in files:
            where = os.path.join(dst, os.path.relpath(root, src))
            os.makedirs(where, exist_ok=True)
            shutil.copy2(os.path.join(root, "events.jsonl"), where)


def run_cli_report(args, want_rc):
    """One ``python -m raft_stereo_tpu_torch.cli`` run in a subprocess:
    its stdout, exit code (checked against ``want_rc``) and wall
    seconds; fails if it loaded jax or the JAX package."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", CLI_RUNNER, *args],
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    tail = [ln for ln in out.stderr.splitlines()
            if ln.startswith("CLI_EXIT ")]
    check(tail, f"cli {args}: no exit line:\n{out.stderr[-2000:]}")
    status = json.loads(tail[-1][len("CLI_EXIT "):])
    check(status["rc"] == out.returncode == want_rc,
          f"cli {args}: exit {out.returncode} ({status['rc']}), expected "
          f"{want_rc}:\n{out.stderr[-2000:]}")
    check(not status["forbidden"],
          f"cli {args}: loaded {status['forbidden']}")
    return out.stdout, secs


def run_obs_reports(root, expected):
    """obs_reports: the report tools over the logs under ``root``
    (``expected``: log name -> (relative dir, steps the phase ran or
    None)), each command in a subprocess, REPORT_WORKERS at a time."""
    import concurrent.futures
    import re
    from raft_stereo_tpu_torch.obs import read_events
    from raft_stereo_tpu_torch.obs.validate import check_path
    t_phase = time.perf_counter()
    logs = {name: os.path.join(root, rel)
            for name, (rel, _) in expected.items()}
    steps_of = {name: steps for name, (_, steps) in expected.items()}
    fleet_dir = logs.pop("dp_trainer")
    ranks = sorted(os.listdir(fleet_dir))
    check(ranks == ["rank0", "rank1"], f"obs_reports: dp_trainer {ranks}")
    for r in ranks:
        logs[f"dp_trainer/{r}"] = os.path.join(fleet_dir, r)
        steps_of[f"dp_trainer/{r}"] = steps_of["dp_trainer"]
    jobs, facts = [], {}
    for name, path in logs.items():
        check(check_path(path) == [],
              f"obs_reports: {name} fails the lint: {check_path(path)[:5]}")
        events = read_events(os.path.join(path, "events.jsonl"))
        kinds = {}
        for e in events:
            kinds[e["event"]] = kinds.get(e["event"], 0) + 1
        facts[name] = kinds
        tl = os.path.join(path, "timeline.json")
        jobs += [(name, "telemetry", [path], 0),
                 (name, "doctor", [path, "--json"], 0),
                 (name, "timeline", [path, "--out", tl], 0),
                 (name, "compare", [path, path], 0),
                 (name, "numerics", [path, "--json", "-"],
                  0 if kinds.get("numerics") else 1),
                 (name, "converge", [path, "--json", "-"],
                  0 if kinds.get("converge") else 1)]
    jobs += [("dp_trainer", "fleet", [fleet_dir], 0),
             ("dp_trainer", "doctor", [fleet_dir, "--json"], 0)]
    with concurrent.futures.ThreadPoolExecutor(REPORT_WORKERS) as pool:
        futures = [pool.submit(run_cli_report, [cmd, *args], rc)
                   for _, cmd, args, rc in jobs]
        t_lint = time.perf_counter()
        lint = subprocess.run(
            [sys.executable, "-m", "raft_stereo_tpu_torch.obs.validate",
             *logs.values()], cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300)
        lint_s = time.perf_counter() - t_lint
        done = [f.result() for f in futures]
    check(lint.returncode == 0, f"obs_reports: obs.validate exited "
                                f"{lint.returncode}: {lint.stderr[-2000:]}")
    rows = []
    for (name, cmd, args, rc), (stdout, secs) in zip(jobs, done):
        kinds = facts.get(name, {})
        verdict = None
        if cmd == "telemetry":
            m = re.search(r"events: (\d+) records, (\d+) steps", stdout)
            check(m is not None, f"obs_reports: {name} telemetry: {stdout}")
            steps = int(m.group(2))
            want = steps_of[name]
            check(steps == kinds.get("step", 0)
                  and (want is None or steps == want),
                  f"obs_reports: {name}: summary of {steps} steps, the "
                  f"phase ran {want}")
            verdict = f"steps={steps}"
        elif cmd == "doctor":
            verdicts = [(v["phase"], v["verdict"])
                        for v in json.loads(stdout)["verdicts"]]
            verdict = " ".join(f"[{p}] {v}" for p, v in verdicts)
            phases = [p for p, _ in verdicts]
            if name in ("train_trainer", "train_trainer_steady"):
                check("train" in phases, f"obs_reports: {name}: {verdict}")
            if name == "numerics_eval":
                check("numerics" in phases,
                      f"obs_reports: {name}: {verdict}")
            if args[0] == fleet_dir:
                check(verdicts == [("fleet", "FLEET_OK")],
                      f"obs_reports: dp_trainer fleet: {verdict}")
        elif cmd == "timeline":
            with open(args[2]) as f:
                doc = json.load(f)
            spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
            roots = {n: sum(e["name"] == n for e in spans)
                     for n in ("step", "request")}
            # a train log's root is its step, a served request's its
            # request; eval and the sequential baseline write no spans
            served = bool(kinds.get("request"))
            want = {"step": 0 if served else kinds.get("step", 0),
                    "request": kinds.get("request", 0)}
            if not kinds.get("span"):
                want = {"step": 0, "request": 0}
            check(roots == want, f"obs_reports: {name} timeline roots "
                                 f"{roots}, records {kinds}")
            verdict = f"spans={len(spans)} roots={roots}"
        elif cmd == "compare":
            check("ok: no metric moved past its threshold" in stdout,
                  f"obs_reports: {name} self-compare: {stdout[-500:]}")
            verdict = "ok"
        elif cmd in ("numerics", "converge") and rc == 0:
            doc = json.loads(stdout)
            verdict = (f"tap_events={doc['tap_events']} "
                       f"grad_events={doc['grad_events']}"
                       if cmd == "numerics" else f"curves={doc['curves']}")
            if cmd == "converge":
                check(doc["curves"] == kinds["converge"],
                      f"obs_reports: {name} converge {doc['curves']}")
        elif cmd == "fleet":
            check("[fleet] FLEET_OK" in stdout and "2 host(s)" in stdout,
                  f"obs_reports: fleet: {stdout[-1000:]}")
            verdict = "FLEET_OK over 2 ranks"
        else:
            verdict = f"no {cmd} records (exit 1)"
        rows.append(dict(log=name, command=cmd, exit_code=rc,
                         seconds=round(secs, 3), verdict=verdict))
    result = dict(logs=sorted(logs), reports=rows, workers=REPORT_WORKERS,
                  validate_seconds=round(lint_s, 3),
                  report_seconds_sum=round(sum(r["seconds"] for r in rows),
                                           3),
                  wall_s=round(time.perf_counter() - t_phase, 3))
    emit("obs_reports", **result)
    return result


# --- convergence, early exit and numerics ------------------------------------

ADAPTIVE_TIMED = 3           # timed forwards a mode in adaptive_parity
POLICY_MAX_BUDGET = 16       # adaptive_eval picks the smallest τ (of the
                             # recorded curves' quantiles) whose policy
                             # budget is at most this
TAP_CPU_TOL = 1e-3           # numerics_eval: card vs CPU tap statistics,
                             # |diff| <= this x max(1, |CPU value|)
NUMERICS_PROFILED = 2        # frames profiled a predictor in numerics_eval


def oracle_taken(res, tau, min_iters=1):
    """The freeze rule on recorded fixed-loop curves ``(iters, B)``: a
    sample freezes after update i iff its residual row i-1 < tau and
    i >= min_iters; else it takes the budget."""
    n = res.shape[0]
    return [next((i for i in range(min_iters, n + 1) if res[i - 1, j] < tau),
                 n) for j in range(res.shape[1])]


def midway_tau(res):
    """A τ midway between two adjacent recorded residuals (every sample,
    every iteration but the last) at which the samples freeze at
    different iterations, one before the budget; preferably all before
    it (the while loop then stops early), and then as far from any
    recorded value as such a τ can be. Returns ``(tau, gap)``."""
    import numpy as np
    vals = np.sort(np.unique(res[:-1].ravel()))
    best = None
    for a, b in zip(vals[:-1], vals[1:]):
        tau = float((a + b) / 2)
        taken = oracle_taken(res, tau)
        if min(taken) < res.shape[0] and len(set(taken)) > 1:
            key = (max(taken) < res.shape[0],
                   float(np.min(np.abs(res - tau))))
            if best is None or key > best[0]:
                best = (key, tau)
    check(best is not None, "adaptive_parity: no τ freezes one sample only")
    return best[1], best[0][1]


def run_adaptive_parity(dev, all_kernels, ws_kernel, state):
    """adaptive_parity: the default architecture (reg_cuda, fp32, TF32
    off) at 384x1248, batch 2 (an easy textured pair and a noise pair),
    32 iterations. τ=0 adaptive is bitwise the fixed loop with 32
    iterations taken a sample; at a τ between recorded residuals that
    freezes one sample early, iters_taken equals the oracle on the fixed
    curves and the while loop gives the masked scan's flows, rows and
    iters_taken bitwise. B1 launches: 32 a forward under masked_scan, the
    trips run plus the final iteration under while_loop. Times each
    mode; at τ=0 the two modes run the same 32 iterations, so their
    difference is the while loop's 31 host syncs."""
    import numpy as np
    import torch
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.models import RAFTStereo
    iters, (h, w) = EVAL_ITERS, padded_hw(SERVE_HW)
    easy = stereo_pair(h, w, SEED + 400)
    noise = np.random.default_rng(SEED + 401).uniform(
        0, 255, (2, 1, h, w, 3)).astype(np.float32)
    left = torch.from_numpy(np.concatenate([easy[0], noise[0]])).to(dev)
    right = torch.from_numpy(np.concatenate([easy[1], noise[1]])).to(dev)
    models = {}
    for mode in ("masked_scan", "while_loop"):
        cfg = RAFTStereoConfig(corr_implementation="reg_cuda",
                               adaptive_mode=mode)
        models[mode] = RAFTStereo(cfg).to(dev).eval()
        models[mode].load_state_dict(state, strict=True)

    def run(mode, **kw):
        for k in all_kernels:
            k.launches = 0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = models[mode](left, right, iters=iters,
                               iter_metrics="per_sample", **kw)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k.__name__: k.launches for k in all_kernels}
        return [o.cpu().numpy() for o in out], counts, ms

    run("masked_scan")  # warm-up: cuDNN's algorithm choice, allocator
    fixed, counts, _ = run("masked_scan")
    check_launches("adaptive_parity fixed", counts, ws_kernel, iters)
    res = fixed[2]
    zero, counts, _ = run("masked_scan", adaptive_tau=0.0)
    check_launches("adaptive_parity tau=0", counts, ws_kernel, iters)
    check(np.array_equal(zero[1], fixed[1])
          and np.array_equal(zero[2], fixed[2])
          and list(zero[3]) == [iters, iters],
          f"adaptive_parity: τ=0 is not the fixed loop (iters_taken "
          f"{list(zero[3])})")
    tau, gap = midway_tau(res)
    oracle = oracle_taken(res, tau)
    outs, launches = {}, {}
    for mode in ("masked_scan", "while_loop"):
        outs[mode], counts, _ = run(mode, adaptive_tau=tau)
        trips = min(max(oracle), iters - 1) if mode == "while_loop" \
            else iters - 1
        check_launches(f"adaptive_parity {mode}", counts, ws_kernel,
                       trips + 1)
        launches[mode] = counts[ws_kernel.__name__]
        check(list(outs[mode][3]) == oracle,
              f"adaptive_parity {mode}: iters_taken {list(outs[mode][3])}, "
              f"oracle {oracle}")
        check(all(np.isfinite(o).all() for o in outs[mode][:3]),
              f"adaptive_parity {mode}: non-finite output")
    ms_, wl = outs["masked_scan"], outs["while_loop"]
    check(all(np.array_equal(ms_[i], wl[i]) for i in (0, 1, 2, 3)),
          "adaptive_parity: while_loop differs from masked_scan")
    for j, t in enumerate(oracle):
        check(np.array_equal(ms_[2][:t, j], res[:t, j])
              and np.all(ms_[2][t:, j] == 0.0),
              f"adaptive_parity: sample {j}'s residual rows")
    timed = {}
    for label, mode, tau_ in (("fixed", "masked_scan", None),
                              ("masked_scan_tau0", "masked_scan", 0.0),
                              ("while_loop_tau0", "while_loop", 0.0),
                              ("masked_scan", "masked_scan", tau),
                              ("while_loop", "while_loop", tau)):
        kw = {} if tau_ is None else {"adaptive_tau": tau_}
        timed[label] = [run(mode, **kw)[2] for _ in range(ADAPTIVE_TIMED)]
    med = {k: statistics.median(v) for k, v in timed.items()}
    result = dict(size=[h, w], batch=2, iters=iters, dtype="float32",
                  tau=tau, tau_gap_to_recorded=gap, iters_taken=oracle,
                  launches=launches, launches_fixed=iters,
                  ms_median=med, ms_runs=timed,
                  while_loop_sync_ms_per_iteration=(
                      med["while_loop_tau0"] - med["masked_scan_tau0"])
                  / (iters - 1))
    emit("adaptive_parity", **result)
    print(f"adaptive_parity: τ {tau:.5g} iters_taken {oracle}; ms fixed "
          f"{med['fixed']:.1f}, masked_scan {med['masked_scan']:.1f}, "
          f"while_loop {med['while_loop']:.1f}; while_loop's sync "
          f"{result['while_loop_sync_ms_per_iteration']:.4f} ms an "
          f"iteration", flush=True)
    return result


def run_entry_eval(work, tree, ckpt, name, *flags):
    """``python3 -m raft_stereo_tpu_torch.evaluate`` on eval_kitti's tree
    and weights, sequential, EVAL_ITERS iterations, with ``flags``, in a
    session of its own: its results dict, with ``kitti-fps`` (the device
    forward) and ``kitti-fps-e2e`` (the predict call) over frames 2 on
    from its step records (the entry point's validator warms up over 50
    frames, more than the tree has), and its records."""
    import ast
    from raft_stereo_tpu_torch.obs import read_events
    run_dir = os.path.join(work, name)
    cmd = [sys.executable, "-m", "raft_stereo_tpu_torch.evaluate",
           "--dataset", "kitti", "--data_root", tree,
           "--corr_implementation", "reg_cuda", "--stream", "off",
           "--valid_iters", str(EVAL_ITERS), "--run_dir", run_dir,
           "--restore_ckpt", ckpt, *flags]
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        stop_leftovers({pid: cmd_ for pid, (_, sid, cmd_)
                        in live_processes().items() if sid == proc.pid},
                       name)
    check(proc.returncode == 0, f"{name} exited {proc.returncode}:\n"
                                f"{stderr[-3000:]}")
    check_events(run_dir, EVAL_FRAMES)
    events = read_events(os.path.join(run_dir, "events.jsonl"))
    steps = [e for e in events if e["event"] == "step"][2:]
    results = ast.literal_eval(stdout.strip().splitlines()[-1])
    results["kitti-fps"] = len(steps) / sum(e["dispatch_s"] for e in steps)
    results["kitti-fps-e2e"] = len(steps) / sum(
        e["dispatch_s"] + e["fetch_s"] for e in steps)
    return results, events


def check_converge_numerics(name, events, frames, numerics):
    """A run's ``converge`` records (one a frame, curves of EVAL_ITERS
    points, finite) and ``numerics`` records (one a dispatch when on, 8
    taps of finite statistics and no non-finite, saturated value; none
    when off); both pass the port's schema (check_events did)."""
    import math
    conv = [e for e in events if e["event"] == "converge"]
    nums = [e for e in events if e["event"] == "numerics"]
    check(len(conv) == frames and all(
        e["iters"] == EVAL_ITERS and len(e["residual"]) == len(e["idx"])
        and all(math.isfinite(v) for v in e["residual"]) for e in conv),
        f"{name}: {len(conv)} converge records for {frames} frames")
    check(len(nums) == (frames if numerics else 0),
          f"{name}: {len(nums)} numerics records")
    for e in nums:
        check(e["kind"] == "taps" and len(e["taps"]) == 8
              and e["first_nonfinite"] is None and e["sat_total"] == 0,
              f"{name}: numerics record {e.get('frame')}: "
              f"{e['first_nonfinite']}, sat {e['sat_total']}")
        for label, series in e["taps"].items():
            check(all(v is not None for f in ("min", "max", "absmean")
                      for v in series[f]),
                  f"{name}: tap {label} has a non-finite statistic")
    return conv, nums


def run_numerics_eval(dev, work, tree, ckpt, all_kernels, ws_kernel):
    """numerics_eval, the entry point: the default eval (converge and
    numerics on, as the JAX package's) against --no_converge
    --no_numerics on eval_kitti's tree and weights, both sequential in
    one call: kitti-fps each, the records checked; then in this process,
    the same two predictors and one with the converge output alone
    profiled over NUMERICS_PROFILED frames for kernels a frame, the card's
    busy time and idle share, and their B1 launches.
    Returns the phase's fields and the default run's converge records."""
    import numpy as np
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.data import KITTI
    from raft_stereo_tpu_torch.inference import StereoPredictor
    from raft_stereo_tpu_torch.models import RAFTStereo
    off, off_events = run_entry_eval(work, tree, ckpt, "numerics_off",
                                     "--no_converge", "--no_numerics")
    on, on_events = run_entry_eval(work, tree, ckpt, "numerics_on")
    check(not any(e["event"] in ("converge", "numerics")
                  for e in off_events),
          "numerics_eval: --no_converge --no_numerics wrote records")
    conv, nums = check_converge_numerics("numerics_eval", on_events,
                                         EVAL_FRAMES, True)
    start = next(e for e in on_events if e["event"] == "run_start")
    check(start["config"]["converge"] and start["config"]["numerics"],
          f"numerics_eval: run_start config {start['config']}")
    for key in ("kitti-epe", "kitti-d1"):
        check(on[key] == off[key], f"numerics_eval: {key} {on[key]} with "
                                   f"the taps, {off[key]} without")
    cfg = RAFTStereoConfig(corr_implementation="reg_cuda",
                           mixed_precision=True)
    state = seeded_weights(RAFTStereo(cfg), SEED)
    ds = KITTI(root=os.path.join(tree, "KITTI"))
    frames = [ds.sample(i) for i in range(NUMERICS_PROFILED)]
    prof = {}
    for name, kw in (("off", {}), ("converge", dict(converge=True)),
                     ("on", dict(converge=True, numerics=True))):
        pred = StereoPredictor(cfg, state, valid_iters=EVAL_ITERS,
                               device=dev, **kw)

        def frames_fn():
            for s in frames:
                pred(s["image1"][None], s["image2"][None])
                pred.take_aux()
        frames_fn()  # warm-up
        for k in all_kernels:
            k.launches = 0
        frames_fn()
        counts = {k.__name__: k.launches for k in all_kernels}
        check_launches(f"numerics_eval {name}", counts, ws_kernel,
                       EVAL_ITERS, NUMERICS_PROFILED)
        idle, n_kernels, busy_ms, span_ms = idle_share(frames_fn)
        prof[name] = dict(idle_share=idle,
                          kernels_per_frame=n_kernels / NUMERICS_PROFILED,
                          busy_ms_per_frame=busy_ms / NUMERICS_PROFILED,
                          span_ms_per_frame=span_ms / NUMERICS_PROFILED,
                          launches_per_frame=counts[ws_kernel.__name__]
                          / NUMERICS_PROFILED)
        del pred
    fps = {"off": off["kitti-fps"], "on": on["kitti-fps"]}
    result = dict(frames=EVAL_FRAMES, iters=EVAL_ITERS,
                  dtype="bfloat16 (mixed precision)", kitti_fps=fps,
                  kitti_fps_e2e={"off": off["kitti-fps-e2e"],
                                 "on": on["kitti-fps-e2e"]},
                  slowdown_with_taps=fps["off"] / fps["on"] - 1.0,
                  profiled=prof,
                  tap_kernels_per_frame=prof["on"]["kernels_per_frame"]
                  - prof["converge"]["kernels_per_frame"],
                  converge_kernels_per_frame=prof["converge"][
                      "kernels_per_frame"] - prof["off"]["kernels_per_frame"],
                  records={"converge": len(conv), "numerics": len(nums)},
                  tap_labels=list(nums[0]["taps"]))
    emit("numerics_eval", **result)
    print(f"numerics_eval: kitti-fps {fps['on']:.3f} with converge and "
          f"numerics, {fps['off']:.3f} without; kernels a frame "
          f"{prof['on']['kernels_per_frame']:.0f} / "
          f"{prof['off']['kernels_per_frame']:.0f}; idle share "
          f"{prof['on']['idle_share']:.3f} / {prof['off']['idle_share']:.3f}",
          flush=True)
    return result, conv


def choose_policy(conv):
    """The policy the port's build_policy makes of eval records at the
    smallest τ among the recorded residuals' deciles whose default budget
    is at most POLICY_MAX_BUDGET (the largest decile otherwise)."""
    import numpy as np
    from raft_stereo_tpu_torch.obs import converge as cv
    vals = np.concatenate([np.asarray(e["residual"]) for e in conv])
    policy = None
    for q in range(10, 100, 10):
        tau = float(np.percentile(vals, q))
        policy = cv.build_policy(conv, tau=tau, source_run="numerics_on")
        if policy["default"]["budget"] <= POLICY_MAX_BUDGET:
            break
    return policy


def run_adaptive_eval(dev, work, tree, ckpt, all_kernels, ws_kernel,
                      fl_kernel, conv, fixed_fps):
    """adaptive_eval: a policy built by the port's build_policy from
    numerics_eval's converge records, written and linted, then python3
    -m raft_stereo_tpu_torch.evaluate --iter_policy on the same tree
    (sequential): kitti-fps and the mean iters_taken against the fixed
    run of numerics_eval; in this process the adaptive predictor's B1
    launches (the budget a frame) and with fused_lookup=True B4's (the
    budget a frame, no B1), over NUMERICS_PROFILED frames."""
    import numpy as np
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.data import KITTI
    from raft_stereo_tpu_torch.inference import StereoPredictor
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.obs import converge as cv
    policy = choose_policy(conv)
    path = os.path.join(work, "iter_policy.json")
    with open(path, "w") as f:
        json.dump(policy, f, indent=2, sort_keys=True)
    cv.load_policy(path)  # lints
    budget = policy["default"]["budget"]
    res, events = run_entry_eval(work, tree, ckpt, "adaptive_eval",
                                 "--iter_policy", path)
    taken = [e["iters_taken"] for e in events if e["event"] == "converge"]
    check(len(taken) == EVAL_FRAMES and all(1 <= t <= budget
                                            for t in taken),
          f"adaptive_eval: iters_taken {taken[:8]}... budget {budget}")
    check(not any(e["event"] == "numerics" for e in events),
          "adaptive_eval: the early exit wrote numerics records")
    start = next(e for e in events if e["event"] == "run_start")["config"]
    check(start["iter_policy_digest"] == cv.policy_digest(policy),
          f"adaptive_eval: run_start digest {start['iter_policy_digest']}")
    ds = KITTI(root=os.path.join(tree, "KITTI"))
    frames = [ds.sample(i) for i in range(NUMERICS_PROFILED)]
    launches = {}
    for name, kernel, extra in (("reg_cuda", ws_kernel, {}),
                                ("fused_lookup", fl_kernel,
                                 {"fused_lookup": True})):
        cfg = RAFTStereoConfig(corr_implementation="reg_cuda",
                               mixed_precision=True, **extra)
        pred = StereoPredictor(cfg, seeded_weights(RAFTStereo(cfg), SEED),
                               valid_iters=EVAL_ITERS, device=dev,
                               iter_policy=policy)
        pred(frames[0]["image1"][None], frames[0]["image2"][None])
        for k in all_kernels:
            k.launches = 0
        for s in frames:
            flow = pred(s["image1"][None], s["image2"][None])
            aux = pred.take_aux()
            check(np.isfinite(flow).all() and aux["residual"].shape ==
                  (budget, 1), f"adaptive_eval {name}: output")
        counts = {k.__name__: k.launches for k in all_kernels}
        check_launches(f"adaptive_eval {name}", counts, kernel, budget,
                       NUMERICS_PROFILED)
        launches[name] = counts[kernel.__name__] / NUMERICS_PROFILED
        del pred
    result = dict(frames=EVAL_FRAMES, policy_tau=policy["default"]["tau"],
                  policy_budget=budget, digest=cv.policy_digest(policy),
                  kitti_fps={"adaptive": res["kitti-fps"],
                             "fixed": fixed_fps},
                  kitti_fps_e2e_adaptive=res["kitti-fps-e2e"],
                  iters_taken_mean=float(np.mean(taken)),
                  iters_taken_max=int(max(taken)), results=res,
                  launches_per_frame={
                      ws_kernel.__name__: launches["reg_cuda"],
                      fl_kernel.__name__: launches["fused_lookup"]},
                  launches_per_frame_fixed=EVAL_ITERS)
    emit("adaptive_eval", **result)
    print(f"adaptive_eval: kitti-fps {res['kitti-fps']:.3f} with the "
          f"policy (τ {policy['default']['tau']:.4g}, budget {budget}, "
          f"mean iters_taken {result['iters_taken_mean']:.2f}) against "
          f"{fixed_fps:.3f} fixed at {EVAL_ITERS}; B1 {launches['reg_cuda']:.0f}"
          f" and B4 {launches['fused_lookup']:.0f} launches a frame",
          flush=True)
    return result


def run_numerics_card_cpu(dev, all_kernels, ws_kernel, fc_kernel, state):
    """numerics_cpu: one fp32 pair at 64x160 (the default architecture,
    reg_cuda, TF32 off, 4 iterations) with numerics on, on the card and
    on the CPU, same weights: the tap labels equal, the counters equal,
    min/max/absmean within TAP_CPU_TOL x max(1, |CPU value|); then one
    alt_cuda Middlebury-size frame (1988x2880, bf16, 32 iterations) with
    numerics on: 32 fused_corr launches and no other kernel's, 8 taps of
    finite statistics, corr_feats among them."""
    import numpy as np
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.inference import StereoPredictor
    from raft_stereo_tpu_torch.models import RAFTStereo
    left, right = stereo_pair(64, 160, SEED + 1, shift=6)
    cfg = RAFTStereoConfig(corr_implementation="reg_cuda")
    taps = {}
    for where in (dev, "cpu"):
        pred = StereoPredictor(cfg, state, valid_iters=4, device=where,
                               numerics=True)
        ws_kernel.launches = 0
        pred(left, right)
        check(ws_kernel.launches == (4 if where == dev else 0),
              f"numerics_cpu on {where}: {ws_kernel.launches} launches")
        taps[str(where)] = pred.take_aux()["numerics"]
    card, cpu = taps[str(dev)], taps["cpu"]
    check(list(card) == list(cpu), f"numerics_cpu: labels {list(card)} / "
                                   f"{list(cpu)}")
    worst = 0.0
    for k in cpu:
        check(np.array_equal(card[k][:, 3:5], cpu[k][:, 3:5]),
              f"numerics_cpu: {k} counters {card[k][:, 3:]} / "
              f"{cpu[k][:, 3:]}")
        dev_ = np.abs(card[k][:, :3] - cpu[k][:, :3]) / np.maximum(
            1.0, np.abs(cpu[k][:, :3]))
        worst = max(worst, float(dev_.max()))
    check(worst <= TAP_CPU_TOL, f"numerics_cpu: tap statistics differ by "
                                f"{worst} of max(1, |CPU|)")
    underflow = {k: [float(card[k][:, 5].sum()), float(cpu[k][:, 5].sum())]
                 for k in cpu}
    # the memoryless fused correlation at Middlebury size with the taps
    mcfg = RAFTStereoConfig(corr_implementation="alt_cuda",
                            mixed_precision=True)
    pred = StereoPredictor(mcfg, seeded_weights(RAFTStereo(mcfg), SEED),
                           valid_iters=EVAL_ITERS, device=dev, numerics=True,
                           converge=True)
    mleft, mright = stereo_pair(HIRES_H, HIRES_W, SEED + 210, shift=24)
    pred(mleft, mright)  # warm-up
    for k in all_kernels:
        k.launches = 0
    t0 = time.perf_counter()
    flow = pred(mleft, mright)
    secs = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in all_kernels}
    check_launches("numerics_middlebury", counts, fc_kernel, EVAL_ITERS)
    aux = pred.take_aux()
    labels = [k.partition(":")[2] for k in aux["numerics"]]
    check(np.isfinite(flow).all() and len(labels) == 8
          and labels[0] == "corr_feats"
          and all(np.isfinite(v[:, :3]).all() and not v[:, 3].any()
                  for v in aux["numerics"].values()),
          f"numerics_middlebury: taps {labels}")
    del pred
    result = dict(size=[64, 160], iters=4, dtype="float32",
                  max_rel_dev=worst, bound=TAP_CPU_TOL,
                  underflow_card_cpu=underflow,
                  middlebury=dict(size=[HIRES_H, HIRES_W], iters=EVAL_ITERS,
                                  dtype="bfloat16 (mixed precision)",
                                  launches=counts, seconds=secs,
                                  labels=labels))
    emit("numerics_cpu", **result)
    return result


def run_serve_adaptive(dev, all_kernels, ws_kernel, state):
    """serve_adaptive: one StereoServer (default architecture, reg_cuda,
    fp32, 32 iterations) with an iteration policy covering the 384x1248
    bucket only (τ from a request's fixed curve, between its 6th and 7th
    residuals): its requests ride the @digest flavour, return
    iters_taken (the predictor's with the same policy) and launch B1 the
    budget's times a dispatch; a 188x621 request (bucket 192x640) stays
    fixed (32 launches, no iters_taken); the slo "iters" rollup and its
    /metrics gauges. Then serve --numerics: one numerics record a
    dispatch and the output_range gauges on /metrics."""
    import numpy as np
    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    from raft_stereo_tpu_torch.inference import StereoPredictor
    from raft_stereo_tpu_torch.obs import Telemetry, read_events
    from raft_stereo_tpu_torch.obs import converge as cv
    from raft_stereo_tpu_torch.serve import ServeConfig, StereoServer
    from raft_stereo_tpu_torch.serve.http import prometheus_metrics
    cfg = RAFTStereoConfig(corr_implementation="reg_cuda")
    iters = EVAL_ITERS
    bh, bw = padded_hw(SERVE_HW)
    pairs = serve_pairs(2, SEED + 500)
    small = serve_pairs(1, SEED + 510, SERVE_SMALL_HW)[0]
    fixed = StereoPredictor(cfg, state, valid_iters=iters, device=dev,
                            converge=True)
    fixed(pairs[0][0][None], pairs[0][1][None])
    res = fixed.take_aux()["residual"][:, 0]
    tau = float((res[5] + res[6]) / 2)
    budget = iters // 2
    policy = {"kind": "iter_policy", "version": 1,
              "source_run": "chip_smoke serve_adaptive",
              "buckets": {f"{bh}x{bw}": {
                  "tau": tau, "budget": budget, "min_iters": 1,
                  "provenance": {"source": "serve:chip_smoke",
                                 "row": {"tau": tau, "budget": iters}}}}}
    digest = cv.policy_digest(policy)
    pred = StereoPredictor(cfg, state, valid_iters=iters, device=dev,
                           iter_policy=policy)
    want, want_taken = [], []
    for l, r in pairs:
        want.append(pred(l[None], r[None]))
        want_taken.append(int(pred.take_aux()["iters_taken"][0]))
    server = StereoServer(cfg, state, ServeConfig(
        max_batch=1, default_iters=iters, slo_every=1, iter_policy=policy),
        device=dev)
    try:
        server.warmup([SERVE_HW, SERVE_SMALL_HW])
        got, counts = [], []
        for l, r in pairs + [small]:
            (res_,), c = served(server, all_kernels, [(l, r, {})])
            got.append(res_)
            counts.append(c)
        stats = server.stats()
    finally:
        server.close(timeout=120)
    label = f"{bh}x{bw}b1i{budget}@{digest}"
    for j in range(2):
        check(got[j].ok and got[j].bucket == label
              and got[j].iters_taken is not None
              and np.array_equal(got[j].flow, want[j][0]),
              f"serve_adaptive: covered request {j}: {got[j].bucket}, "
              f"iters_taken {got[j].iters_taken}")
        check_launches(f"serve_adaptive covered {j}", counts[j], ws_kernel,
                       budget)
    check([r.iters_taken for r in got[:2]] == want_taken,
          f"serve_adaptive: iters_taken {[r.iters_taken for r in got[:2]]},"
          f" predictor {want_taken}")
    sh, sw = padded_hw(SERVE_SMALL_HW)
    check(got[2].ok and got[2].bucket == f"{sh}x{sw}b1i{iters}"
          and got[2].iters_taken is None,
          f"serve_adaptive: uncovered request {got[2].bucket}")
    check_launches("serve_adaptive uncovered", counts[2], ws_kernel, iters)
    text = prometheus_metrics(stats)
    check(set(stats.get("iters", {})) == {label}
          and f'raft_serve_iters_taken_p50{{bucket="{label}"}}' in text,
          f"serve_adaptive: iters rollup {stats.get('iters')}")
    # the numerics flavour
    with tempfile.TemporaryDirectory(prefix="chip_smoke_num_") as run:
        tel = Telemetry(run, stall_deadline_s=None, device=dev)
        tel.run_start(config={"mode": "serve"})
        server = StereoServer(cfg, state, ServeConfig(
            max_batch=1, default_iters=iters, slo_every=1, numerics=True),
            device=dev, telemetry=tel)
        try:
            server.warmup([SERVE_HW])
            n_results, c = served(server, all_kernels,
                                  [(l, r, {}) for l, r in pairs])
            check_launches("serve_adaptive numerics", c, ws_kernel, iters, 2)
            nstats = server.stats()
        finally:
            server.close(timeout=120)
        tel.emit("run_end", steps=2, ok=True)
        tel.close()
        recs = [e for e in read_events(os.path.join(run, "events.jsonl"))
                if e["event"] == "numerics"]
    ntext = prometheus_metrics(nstats)
    check(len(recs) == 2 and all(len(e["taps"]) == 8 for e in recs)
          and all(r.ok and r.output_min is not None for r in n_results)
          and "raft_serve_output_min_p05" in ntext
          and "raft_serve_output_max_p95" in ntext,
          f"serve_adaptive numerics: {len(recs)} records, "
          f"{nstats.get('output_range')}")
    result = dict(size=list(SERVE_HW), iters=iters, tau=tau, budget=budget,
                  digest=digest, labels=[r.bucket for r in got],
                  iters_taken=[r.iters_taken for r in got],
                  launches_per_dispatch=[c[ws_kernel.__name__]
                                         for c in counts],
                  latency_ms=[r.latency_s * 1e3 for r in got],
                  iters_rollup=stats["iters"],
                  numerics_records=len(recs),
                  output_range=nstats["output_range"],
                  numerics_latency_ms=[r.latency_s * 1e3 for r in n_results])
    emit("serve_adaptive", **result)
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
    from raft_stereo_tpu_torch.eval.stream import stop_decode_server
    from raft_stereo_tpu_torch.inference import StereoPredictor
    from raft_stereo_tpu_torch.models import RAFTStereo
    from raft_stereo_tpu_torch.ops.kernels import _build
    from raft_stereo_tpu_torch.ops.kernels import alt_corr as ac
    from raft_stereo_tpu_torch.ops.kernels import fused_corr as fc
    from raft_stereo_tpu_torch.ops.kernels import fused_lookup as fl
    from raft_stereo_tpu_torch.ops.kernels import windowed_sample as ws_mod
    windowed_sample = ws_mod.windowed_sample
    fused_corr = fc.fused_corr
    alt_corr = ac.alt_corr
    fused_lookup_c1 = fl.fused_lookup_c1
    all_kernels = (windowed_sample, fused_corr, alt_corr, fused_lookup_c1)
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
    kernel_names = [ws_mod.KERNEL_NAME, fc.KERNEL_NAME, ac.KERNEL_NAME,
                    fl.KERNEL_NAME]
    # one nvcc a source, all started together
    nvcc_seconds = _build.build_all(kernel_names)
    for name in kernel_names:
        _build.load_library(name)
    emit("build", kernels=kernel_names,
         seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds={k: round(v, 1) for k, v in nvcc_seconds.items()})

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
    ws_err = run_ws_pyramid_parity(dev, ws_mod)

    # fused_corr: kernels against plain, and the memory contract
    fused_err = run_feature_parity(
        dev, "fused_parity", fused_corr,
        (fused_corr, fc.fused_corr_backward, fc.fused_corr_plain,
         fc.fused_corr_backward_plain), SEED + 60)
    check(fused_err["fwd"] <= KERNEL_TOL,
          f"fused forward error {fused_err['fwd']} > {KERNEL_TOL}")
    pyramid_err = run_pyramid_parity(
        dev, "fused_pyramid_parity", fused_corr, fc.fused_corr_pyramid,
        fc.fused_corr_pyramid_plain, fused_corr)
    check(pyramid_err <= KERNEL_TOL,
          f"fused pyramid error {pyramid_err} > {KERNEL_TOL}")
    fused_err["fwd"] = max(fused_err["fwd"], pyramid_err)
    fused_err["bwd"] = max(fused_err["bwd"], run_wide_backward(dev, fc))
    run_feature_memory(dev, "fused_memory", "fused", fc.fused_corr_backward)

    # alt_corr: kernels against plain and against fused_corr, the memory
    # contract; fused_lookup: kernels against plain
    alt_err = run_feature_parity(
        dev, "alt_parity", alt_corr,
        (alt_corr, ac.alt_corr_backward, ac.alt_corr_plain,
         ac.alt_corr_backward_plain), SEED + 100,
        against=(fused_corr, fc.fused_corr_backward))
    alt_err["fwd"] = max(alt_err["fwd"], run_pyramid_parity(
        dev, "alt_pyramid_parity", alt_corr, ac.alt_corr_pyramid,
        ac.alt_corr_pyramid_plain, alt_corr, bitwise_plain=True))
    run_feature_memory(dev, "alt_memory", "alt_pallas", ac.alt_corr_backward)
    lookup_err = run_fused_lookup_parity(dev, fl)

    # 5-6. main path at full width: both configurations through the
    # volume lookup, the default architecture through alt_corr, and both
    # through the fused lookup+convc1 kernel
    left, right = stereo_pair(375, 1242, SEED)
    main = {}
    for name, cfg, iters, kernel in [
            ("default", RAFTStereoConfig(corr_implementation="reg_cuda"), 32,
             windowed_sample),
            ("realtime", realtime_config(), 7, windowed_sample),
            ("alt_pallas", RAFTStereoConfig(corr_implementation="alt_pallas"),
             32, alt_corr),
            ("default_fused_lookup", RAFTStereoConfig(
                corr_implementation="reg_cuda", fused_lookup=True), 32,
             fused_lookup_c1),
            ("realtime_fused_lookup", dataclasses.replace(
                realtime_config(), fused_lookup=True), 7, fused_lookup_c1)]:
        state = seeded_weights(RAFTStereo(cfg), SEED)
        pred = StereoPredictor(cfg, state, valid_iters=iters, device=dev)
        pred(left, right)  # warm-up: cuDNN autotuning, allocator
        torch.cuda.reset_peak_memory_stats(dev)
        for k in all_kernels:
            k.launches = 0
        flow, _ = pred.predict_timed(left, right)
        launches = kernel.launches
        want = iters  # one launch for the four levels an iteration
        others = [k.launches for k in all_kernels if k is not kernel]
        check(launches == want and not any(others),
              f"{name}: {launches} kernel launches, expected {want}; "
              f"others {others}")
        check(flow.shape == (1, 375, 1242, 1), f"{name}: shape {flow.shape}")
        check(bool(np.isfinite(flow).all()), f"{name}: non-finite output")
        secs = [pred.predict_timed(left, right)[1] for _ in range(7)]
        main[name] = dict(launches=launches, iters=iters,
                          ms_per_frame=statistics.median(secs) * 1e3,
                          ms_all=[s * 1e3 for s in secs])
        emit(name, padded=[384, 1248], iters=iters, launches=launches,
             kernel=kernel.__name__,
             ms_per_frame_median=main[name]["ms_per_frame"],
             ms_per_frame_runs=main[name]["ms_all"],
             peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
             disparity_range=[float(-flow.max()), float(-flow.min())])
        if name == "default":
            default_state = state
        del pred

    # hires: alt_cuda at 2016x2880, peak memory beside reg_cuda's
    hires, _ = run_hires(dev, fc, windowed_sample, SEED)

    # 7. device against CPU, same weights, through each kernel (the fused
    # lookup at 64x352, the narrowest pair whose pyramid it takes)
    for impl, kernel, (h, w), extra in (
            ("reg_cuda", windowed_sample, (64, 160), {}),
            ("alt_cuda", fused_corr, (64, 160), {}),
            ("alt_pallas", alt_corr, (64, 160), {}),
            ("reg_cuda", fused_lookup_c1, (64, 352), {"fused_lookup": True})):
        small_l, small_r = stereo_pair(h, w, SEED + 1, shift=6)
        cfg = RAFTStereoConfig(corr_implementation=impl, **extra)
        on_gpu = StereoPredictor(cfg, default_state, valid_iters=4,
                                 device=dev)
        on_cpu = StereoPredictor(cfg, default_state, valid_iters=4,
                                 device="cpu")
        for k in all_kernels:
            k.launches = 0
        f_gpu = on_gpu(small_l, small_r)
        check(kernel.launches == 4,
              f"the card run of {impl} {extra} missed its kernel")
        f_cpu = on_cpu(small_l, small_r)
        dev_px = float(np.abs(f_gpu - f_cpu).max())
        emit("cpu_parity", impl=impl, kernel=kernel.__name__, shape=[h, w],
             iters=4, max_abs_px=dev_px, bound_px=CPU_PARITY_TOL_PX,
             max_abs_flow=float(np.abs(f_cpu).max()))
        check(dev_px <= CPU_PARITY_TOL_PX,
              f"card vs CPU forward ({impl}) differ by {dev_px} px")

    # 11a. the early exit at full width (fp32), both modes, and the taps
    # on the card against the CPU, the Middlebury-size frame with the taps
    adaptive = run_adaptive_parity(dev, all_kernels, windowed_sample,
                                   default_state)
    numerics_cpu = run_numerics_card_cpu(dev, all_kernels, windowed_sample,
                                         fused_corr, default_state)

    # the logs the report tools read at the end (obs_reports), copied out
    # of each phase's temporary directory (removed at exit in any case)
    reports_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_reports_")
    logs = reports_dir.name

    # the evaluation path (validators, stream driver, predict_async, the
    # entry point) on synthetic trees written by the port's own png.py
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as work:
        # eval_kitti and the entry point's subprocess both under PyTorch's
        # TF32 defaults, which the entry point leaves as they are
        torch.backends.cudnn.allow_tf32 = True
        eval_kitti, tree, ckpt = run_eval_kitti(dev, work, all_kernels,
                                                windowed_sample)
        run_eval_cli(work, tree, ckpt, eval_kitti["streamed"])
        eval_ub = run_eval_microbatch(dev, tree, all_kernels,
                                      windowed_sample)
        # the default eval's taps against none, then a policy built from
        # its curves through evaluate --iter_policy
        numerics_eval, conv = run_numerics_eval(dev, work, tree, ckpt,
                                                all_kernels, windowed_sample)
        adaptive_eval = run_adaptive_eval(
            dev, work, tree, ckpt, all_kernels, windowed_sample,
            fused_lookup_c1, conv, numerics_eval["kitti_fps"]["off"])
        for name, src in (("eval_cli", "eval_cli"),
                          ("numerics_eval", "numerics_on"),
                          ("adaptive_eval", "adaptive_eval")):
            keep_logs(os.path.join(work, src), os.path.join(logs, name))
        torch.backends.cudnn.allow_tf32 = False
        eval_mb = run_eval_middlebury(dev, work, all_kernels, fused_corr)
        run_eval_cpu(dev, work, windowed_sample)

    # the serving path: the scheduler on the default architecture, the
    # realtime preset, the +fused flavour, and the load-test entry point
    serve, reg_flow = run_serve(dev, all_kernels, windowed_sample,
                                default_state)
    serve_rt = run_serve_realtime(dev, all_kernels, windowed_sample)
    serve_fused = run_serve_fused(dev, all_kernels, windowed_sample,
                                  fused_corr, default_state, reg_flow)
    serve_adaptive = run_serve_adaptive(dev, all_kernels, windowed_sample,
                                        default_state)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as work:
        run_loadtest(work)
        keep_logs(os.path.join(work, "loadtest"),
                  os.path.join(logs, "loadtest"))

    # 8-9. training steps at the SceneFlow recipe's shape, a NaN step;
    # then the same recipe with alt_cuda, with alt_pallas and with the
    # fused lookup
    def others(kernel):
        return [k for k in all_kernels if k is not kernel]
    train = run_train(dev, "reg_cuda", windowed_sample,
                      others(windowed_sample), SEED)
    train_fused = run_train(dev, "alt_cuda", fused_corr, others(fused_corr),
                            SEED, phase="train_fused", per_iter_bwd=4)
    train_alt = run_train(dev, "alt_pallas", alt_corr, others(alt_corr),
                          SEED, phase="train_alt", per_iter_bwd=4)
    train_lookup = run_train(dev, "reg_cuda", fused_lookup_c1,
                             others(fused_lookup_c1), SEED,
                             phase="train_fused_lookup", fused_lookup=True)

    # 10. one fp32 training step, card against CPU, same weights: reg_cuda
    # with the card's convolutions in cuDNN (the main path's) and outside
    # it, alt_cuda in cuDNN
    # the recipe's full per-iteration recompute pinned (the auto save
    # policy would keep the lookups at this size), then reg_cuda under
    # the auto policy, engaged here: the lookups replayed, not relaunched
    full = {"refinement_save_policy": False}
    for impl, kernel, modes, size, launches, extra in (
            ("reg_cuda", windowed_sample, (("cudnn", True),
                                           ("cudnn_off", False)),
             (64, 160), (4, 2), full),
            ("alt_cuda", fused_corr, (("cudnn", True),), (64, 160), (4, 8),
             full),
            ("alt_pallas", alt_corr, (("cudnn", True),), (64, 160), (4, 8),
             full),
            ("reg_cuda", fused_lookup_c1, (("cudnn", True),), (64, 352),
             (4, 2), dict(full, fused_lookup=True)),
            ("reg_cuda", windowed_sample, (("cudnn", True),), (64, 160),
             (2, 2), {"refinement_save_policy": None})):
        runs = train_cpu_parity(dev, impl, kernel, default_state, modes,
                                size, launches, **extra)
        emit("train_cpu_parity", impl=impl, kernel=kernel.__name__,
             shape=list(size), iters=2, launches=list(launches),
             fields=extra,
             loss_bound=TRAIN_LOSS_TOL, null_perturbation=NULL_PERTURBATION,
             null_runs=NULL_RUNS, **runs)
        for label, run in runs.items():
            check(run["loss_rel_dev"] <= TRAIN_LOSS_TOL,
                  f"card ({impl}, {label}) vs CPU loss differ by "
                  f"{run['loss_rel_dev']} relative")
            check(run["ok"], f"card ({impl}, {label}) vs CPU gradients "
                             f"beyond the null floor: {run}")

    # 10'. the training step's schedules at the recipe (B1), and the
    # batched-weight-gradient backward through B2, B3 and B4
    torch.cuda.empty_cache()
    schedules = run_train_schedules(dev, all_kernels, windowed_sample)
    schedules_kernels = run_train_schedules_kernels(dev, all_kernels)

    # 10a. data parallel: two ranks sharing the card (gloo), the step against
    # the one-process step, then the recipe at full width
    torch.cuda.empty_cache()
    dp_parity = run_dp_parity(dev, default_state)
    dp_train = run_dp_train(train)

    # 10b. the training path: the loader, train() in this process (B1
    # through the trainer, then B2 for two steps), and python -m
    # raft_stereo_tpu_torch.train interrupted and resumed
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as work:
        tree = write_sceneflow_tree(
            os.path.join(work, "data"), TRAIN_TREE_FRAMES, *TRAIN_TREE_HW,
            SEED + 200, test_frames=2)
        train_loader = run_train_loader(tree)
        trainer = run_train_trainer(dev, tree, work, all_kernels,
                                    windowed_sample)
        # the HTTP entry point on the trainer's own checkpoints
        run_serve_http(dev, work, trainer["final"])
        run_train_trainer(dev, tree, work, all_kernels, windowed_sample,
                          phase="train_trainer_steady", steps=STEADY_STEPS,
                          skip=STEADY_SKIP)
        trainer_fused = run_train_trainer(
            dev, tree, work, all_kernels, fused_corr, impl="alt_cuda",
            phase="train_trainer_fused", steps=2, per_iter=(2, 4))
        torch.cuda.empty_cache()
        train_resume = run_train_resume(tree, work)
        dp_trainer = run_dp_trainer(tree, work)
        for name, src in (
                ("train_trainer", "train_trainer/runs/train_trainer"),
                ("train_trainer_steady",
                 "train_trainer_steady/runs/train_trainer_steady"),
                ("serve_http", "serve_http"),
                ("dp_trainer", "dp_trainer/runs/dp")):
            keep_logs(os.path.join(work, src), os.path.join(logs, name))
    del train_loader, train_resume

    # 15d. the report tools on those logs, host only
    run_obs_reports(logs, {
        "eval_cli": ("eval_cli", EVAL_FRAMES),
        "numerics_eval": ("numerics_eval", EVAL_FRAMES),
        "adaptive_eval": ("adaptive_eval", EVAL_FRAMES),
        "loadtest/seq": ("loadtest/seq", None),
        "loadtest/serve": ("loadtest/serve", None),
        "train_trainer": ("train_trainer", TRAINER_STEPS),
        "train_trainer_steady": ("train_trainer_steady", STEADY_STEPS),
        "serve_http": ("serve_http", None),
        "dp_trainer": ("dp_trainer", DP_TRAINER_STEPS)})
    reports_dir.cleanup()

    # 11. timings at the main-path pyramids: each level alone (its
    # one-level launch, plain version and F.grid_sample), then the one
    # launch for the four levels as the main path runs it, on the same
    # levels and level-0 centers (level i around center / 2**i); the
    # backward at the train pyramid, each level's cotangent a slice of the
    # four levels' one
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    taps = 2 * RADIUS + 1
    per_level, pyramid_rows = [], {}
    for which in ("fwd", "bwd"):
        for cfg_name in (("default", "realtime", "train") if which == "fwd"
                         else ("train",)):
            dtype, shapes = level_shapes[cfg_name]
            b, h, w1, w2 = shapes[0]
            g = torch.Generator(device=dev).manual_seed(SEED + 10)
            levels = [torch.randn(sh, generator=g, device=dev).to(dtype)
                      for sh in shapes]
            center = window_centers(b, h, w1, w2, g, dev, edges=False)
            ct = torch.randn((b, h, w1, 4 * taps), generator=g, device=dev)
            rows = []
            for i, vol in enumerate(levels):
                c_i = (center / (2 ** i)).contiguous()
                ct_i = ct[..., i * taps:(i + 1) * taps]
                if which == "fwd":
                    lib_call = grid_sample_lookup(vol, c_i)
                    want = ws_mod.windowed_sample_plain(vol, c_i, RADIUS)
                    lib_err = (lib_call().float().reshape(want.shape)
                               - want).abs().max().item()
                    kernel = (lambda v=vol, c=c_i:
                              ws_mod.windowed_sample_forward(v, c, RADIUS))
                    plain = (lambda v=vol, c=c_i:
                             ws_mod.windowed_sample_plain(v, c, RADIUS))
                else:
                    lib_call = grid_sample_backward(vol, c_i, ct_i)
                    want = ws_mod.windowed_sample_backward_plain(
                        vol, c_i, ct_i, RADIUS)[0]
                    lib_err = (lib_call()[0].float().reshape(vol.shape)
                               - want.float()).abs().max().item()
                    kernel = (lambda v=vol, c=c_i, t=ct_i:
                              ws_mod.windowed_sample_backward(
                                  v, c, t, RADIUS, need_dcoords=False))
                    plain = (lambda v=vol, c=c_i, t=ct_i:
                             ws_mod.windowed_sample_backward_plain(
                                 v, c, t, RADIUS))
                nbytes, flops = ws_bytes_flops(vol, c_i, which == "bwd")
                bound, bound_by = bound_ms(nbytes, flops, 0, torch.float32)
                row = dict(kernel=which, config=cfg_name,
                           shape=list(vol.shape),
                           dtype=str(dtype).replace("torch.", ""),
                           ms=cuda_ms(kernel, flush),
                           plain_ms=cuda_ms(plain, flush),
                           library_ms=cuda_ms(lib_call, flush),
                           library_max_abs_diff=lib_err,
                           bound_ms=bound, bound_by=bound_by,
                           bytes=nbytes, flops=flops)
                rows.append(row)
                emit("timings" if which == "fwd" else "bwd_timings", **row)
                del lib_call, want
            if which == "fwd":
                kernel = lambda: ws_mod.windowed_sample_pyramid_forward(
                    levels, center, RADIUS)
                plain = lambda: ws_mod.windowed_sample_pyramid_plain(
                    levels, center, RADIUS)
            else:
                kernel = lambda: ws_mod.windowed_sample_pyramid_backward(
                    levels, center, ct, RADIUS, need_dcoords=False)
                plain = lambda: ws_mod.windowed_sample_pyramid_backward_plain(
                    levels, center, ct, RADIUS)
            nbytes, flops = ws_bytes_flops(levels, center, which == "bwd")
            bound, bound_by = bound_ms(nbytes, flops, 0, torch.float32)
            row = dict(kernel=which + "_pyramid", config=cfg_name,
                       levels=[list(v.shape) for v in levels],
                       dtype=str(dtype).replace("torch.", ""),
                       ms=cuda_ms(kernel, flush),
                       plain_ms=cuda_ms(plain, flush),
                       bound_ms=bound, bound_by=bound_by, bytes=nbytes,
                       flops=flops,
                       levels_ms_sum=sum(r["ms"] for r in rows),
                       library_levels_ms_sum=sum(r["library_ms"]
                                                 for r in rows))
            pyramid_rows[which, cfg_name] = row
            per_level += rows
            emit("timings" if which == "fwd" else "bwd_timings", **row)
            del levels, center, ct

    # fused_corr and alt_corr: each forward as the main paths run it (one
    # launch for the four levels: fused_corr's at the hires frame and the
    # train_fused step, alt_corr's at the alt_pallas frame, the train_alt
    # step and the hires frame) and per level; both backwards at the train
    # levels. Each on two center fields: "random" (an independent disparity
    # a pixel, the worst case for the staged span) with the plain version
    # and the yardstick, and "smooth" (smooth_centers, as a model's
    # disparities are) with the kernel's time and bound only. No single
    # PyTorch call computes their function: the yardstick is the
    # reference's several-call 'alt' formulation (alt_yardstick), reported
    # as yardstick_ms.
    hires0, train0 = FUSED_SHAPES["hires"][0], FUSED_SHAPES["train_fused"][0]
    fused_fwd = (fc.fused_corr_forward, fc.fused_corr_plain)
    fused_pyr = (fc.fused_corr_pyramid_forward, fc.fused_corr_pyramid_plain)
    alt_fwd = (ac.alt_corr_forward, ac.alt_corr_plain)
    alt_pyr = (ac.alt_corr_pyramid_forward, ac.alt_corr_pyramid_plain)
    fused_rows = {k: [] for k in ("fwd", "fwd_level", "fwd_train",
                                  "fwd_train_level", "bwd")}
    alt_rows = {k: [] for k in ("fwd", "fwd_level", "fwd_train",
                                "fwd_train_level", "fwd_hires", "bwd")}
    for rows, which, backward, cfg_name, dtype, shapes, seed, fns, \
            n_levels in (
            (fused_rows, "fwd", False, "hires", torch.float32, [hires0],
             SEED + 90, fused_pyr, 4),
            (fused_rows, "fwd_level", False, "hires", torch.float32,
             FUSED_SHAPES["hires"], SEED + 90, fused_fwd, 0),
            (fused_rows, "fwd_train", False, "train_fused", torch.bfloat16,
             [train0], SEED + 95, fused_pyr, 4),
            (fused_rows, "fwd_train_level", False, "train_fused",
             torch.bfloat16, FUSED_SHAPES["train_fused"], SEED + 95,
             fused_fwd, 0),
            (fused_rows, "bwd", True, "train_fused", torch.bfloat16,
             FUSED_SHAPES["train_fused"], SEED + 95,
             (fc.fused_corr_backward, fc.fused_corr_backward_plain), 0),
            (alt_rows, "fwd", False, "alt_pallas", torch.float32,
             ALT_DEFAULT_SHAPES[:1], SEED + 140, alt_pyr, 4),
            (alt_rows, "fwd_level", False, "alt_pallas", torch.float32,
             ALT_DEFAULT_SHAPES, SEED + 140, alt_fwd, 0),
            (alt_rows, "fwd_train", False, "train_alt", torch.bfloat16,
             [train0], SEED + 95, alt_pyr, 4),
            (alt_rows, "fwd_train_level", False, "train_alt",
             torch.bfloat16, FUSED_SHAPES["train_fused"], SEED + 95,
             alt_fwd, 0),
            (alt_rows, "fwd_hires", False, "hires", torch.float32, [hires0],
             SEED + 90, alt_pyr, 4),
            (alt_rows, "bwd", True, "train_alt", torch.bfloat16,
             FUSED_SHAPES["train_fused"], SEED + 95,
             (ac.alt_corr_backward, ac.alt_corr_backward_plain), 0)):
        for field in ("random", "smooth"):
            for i, shape in enumerate(shapes):
                row = feature_timing(flush, backward, cfg_name, dtype, shape,
                                     seed + i, dev, *fns, field=field,
                                     n_levels=n_levels,
                                     full=field == "random")
                rows[which].append(row)
                emit("fused_timings" if rows is fused_rows else
                     "alt_timings", kernel=which, **row)

    # fused_lookup: one launch looks up all 4 levels; forward at the
    # default and realtime frames and the train batch, backward at the
    # train batch. The
    # yardstick is the unfused formulation in PyTorch calls
    # (lookup_c1_yardstick).
    lookup_rows = {"fwd": [], "bwd": []}
    for which, cfg_name in (("fwd", "default"), ("fwd", "realtime"),
                            ("fwd", "train"), ("bwd", "train")):
        vname, dname, shape = LOOKUP_C1[cfg_name]
        dt = getattr(torch, dname)
        levels, coords, kern, bias = lookup_c1_inputs(
            shape, getattr(torch, vname), SEED + 150, dev, edges=False)
        ct = None
        args = (levels, coords, kern, bias)
        if which == "fwd":
            kernel = lambda: fl.fused_lookup_forward(*args, RADIUS, dt)
            plain = lambda: fl.fused_lookup_c1_plain(*args, RADIUS, dt)
        else:
            g = torch.Generator(device=dev).manual_seed(SEED + 155)
            ct = torch.randn(shape[:3] + (64,), generator=g,
                             device=dev).to(dt)
            kernel = lambda: fl.fused_lookup_backward(*args, ct, RADIUS, dt)
            plain = lambda: fl.fused_lookup_c1_backward_plain(*args, ct,
                                                              RADIUS, dt)
        nbytes, flops, product = lookup_c1_bytes_flops(
            levels, coords, dt, backward=which == "bwd")
        bound, bound_by = bound_ms(nbytes, flops, product, dt)
        yard = lookup_c1_yardstick(levels, coords, kern, bias, dt, ct)
        got, want = yard(), plain()
        if which == "fwd":
            got, want = (got,), (want,)
        else:
            got, want = got, (*want[0], want[1], want[2])
        yard_err = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(got, want))
        del got, want
        row = dict(config=cfg_name, shape=list(shape), volume_dtype=vname,
                   compute_dtype=dname, ms=cuda_ms(kernel, flush),
                   plain_ms=cuda_ms(plain, flush),
                   yardstick_ms=cuda_ms(yard, flush),
                   yardstick_max_abs_diff=yard_err,
                   bound_ms=bound, bound_by=bound_by,
                   bytes=nbytes, flops=flops + product)
        lookup_rows[which].append(row)
        emit("fused_lookup_timings", kernel=which, **row)
        del yard, levels, coords, ct

    # kernels line: per launch as each kernel's main path launches it
    def mean(rows, key):
        return sum(r[key] for r in rows) / len(rows)

    def rnd(rows):
        return [r for r in rows if r["field"] == "random"]

    def smooth(rows):
        return [r for r in rows if r["field"] == "smooth"]

    def levels_of(which, cfg_name):
        return [r for r in per_level
                if (r["kernel"], r["config"]) == (which, cfg_name)]
    ws_fwd, ws_bwd = pyramid_rows["fwd", "default"], pyramid_rows[
        "bwd", "train"]
    print(json.dumps({"kernels": [{
        "name": ws_mod.KERNEL_NAME, "route": "cuda",
        "source": ws_mod.SOURCE, "replaces": ws_mod.REPLACES,
        "launches": main["default"]["launches"],
        "launches_realtime": main["realtime"]["launches"],
        "launches_train_step": train["launches_fwd"],
        "launches_trainer_per_step": trainer["launches_per_step"][0][0],
        "launches_dp_train_per_rank_step":
        dp_train["launches_per_rank_step"][0][0],
        "launches_dp_parity_per_rank": dp_parity["launches_per_rank"][0][0],
        "launches_dp_parity_auto_policy_per_rank":
        dp_parity["auto_save_policy"]["launches_per_rank"][0][0],
        "launches_dp_trainer_per_rank_step":
        dp_trainer["launches_per_step_per_rank"][0][0],
        "launches_eval_kitti_per_frame": eval_kitti["launches_per_frame"],
        "launches_eval_microbatch_per_dispatch": eval_ub,
        "launches_serve_per_dispatch": serve["launches_per_dispatch"],
        "launches_serve_realtime_per_dispatch":
        serve_rt["launches_per_dispatch"],
        "launches_adaptive_parity_fixed": adaptive["launches_fixed"],
        "launches_adaptive_parity": adaptive["launches"],
        "launches_numerics_eval_per_frame":
        numerics_eval["profiled"]["on"]["launches_per_frame"],
        "launches_adaptive_eval_per_frame":
        adaptive_eval["launches_per_frame"][windowed_sample.__name__],
        "adaptive_eval_policy_budget": adaptive_eval["policy_budget"],
        "launches_serve_adaptive_per_dispatch":
        serve_adaptive["launches_per_dispatch"],
        "launches_train_schedules": {
            n: r["launches"][0][0] for n, r in schedules.items()},
        "max_abs_err": max(max_err, ws_err["fwd"]),
        "ms": ws_fwd["ms"], "plain_ms": ws_fwd["plain_ms"],
        "bound_ms": ws_fwd["bound_ms"], "bound_by": ws_fwd["bound_by"],
        "library_ms": None,
        "yardstick_ms": ws_fwd["library_levels_ms_sum"],
        "yardstick": "four F.grid_sample calls, one a level; no single "
                     "PyTorch call computes the four-level lookup",
        "ms_levels_one_each": [r["ms"] for r in levels_of("fwd",
                                                          "default")],
        "library_ms_levels": [r["library_ms"] for r in levels_of(
            "fwd", "default")],
        "ms_realtime": pyramid_rows["fwd", "realtime"]["ms"],
        "bound_ms_realtime": pyramid_rows["fwd", "realtime"]["bound_ms"],
        "ms_train": pyramid_rows["fwd", "train"]["ms"],
        "bound_ms_train": pyramid_rows["fwd", "train"]["bound_ms"],
        "timed_at": "per launch: one launch for the default path's 4 levels "
                    "(1,96,312,{312,156,78,39}) fp32, L2 flushed; "
                    "_realtime: (1,48,156,{156,78,39,19}) bf16; _train: "
                    "(8,80,180,{180,90,45,22}) bf16",
    }, {
        "name": ws_mod.KERNEL_NAME + "_bwd", "route": "cuda",
        "source": ws_mod.SOURCE, "replaces": ws_mod.REPLACES_BWD,
        "launches": train["launches_bwd"],
        "launches_trainer_per_step": trainer["launches_per_step"][0][1],
        "launches_dp_train_per_rank_step":
        dp_train["launches_per_rank_step"][0][1],
        "launches_dp_parity_per_rank": dp_parity["launches_per_rank"][0][1],
        "launches_dp_parity_auto_policy_per_rank":
        dp_parity["auto_save_policy"]["launches_per_rank"][0][1],
        "launches_dp_trainer_per_rank_step":
        dp_trainer["launches_per_step_per_rank"][0][1],
        "launches_train_schedules": {
            n: r["launches"][0][1] for n, r in schedules.items()},
        "max_abs_err": max(bwd_err, ws_err["dvol"], ws_err["dcoords"]),
        "ms": ws_bwd["ms"], "plain_ms": ws_bwd["plain_ms"],
        "bound_ms": ws_bwd["bound_ms"], "bound_by": ws_bwd["bound_by"],
        "library_ms": None,
        "yardstick_ms": ws_bwd["library_levels_ms_sum"],
        "yardstick": "four F.grid_sample backwards (torch.autograd.grad), "
                     "one a level; no single PyTorch call computes the "
                     "four levels' dvol",
        "ms_levels_one_each": [r["ms"] for r in levels_of("bwd", "train")],
        "library_ms_levels": [r["library_ms"] for r in levels_of(
            "bwd", "train")],
        "timed_at": "per launch: one launch for the training step's 4 "
                    "levels (8,80,180,{180,90,45,22}) bf16, dvol only, L2 "
                    "flushed",
    }] + [{
        "name": fc.KERNEL_NAME + suffix, "route": "cuda",
        "source": fc.SOURCE, "replaces": replaces,
        "launches": launches, **extra,
        "max_abs_err": fused_err[which],
        "ms": mean(rnd(rows), "ms"), "plain_ms": mean(rnd(rows), "plain_ms"),
        "bound_ms": mean(rnd(rows), "bound_ms"),
        "bound_by": rnd(rows)[0]["bound_by"],
        "library_ms": None, "yardstick_ms": mean(rnd(rows), "yardstick_ms"),
        "ms_smooth_centers": mean(smooth(rows), "ms"),
        "yardstick": "several calls: the reference's alt formulation "
                     "(F.grid_sample of fmap2 at the taps, product with "
                     "fmap1, sum over D); no single PyTorch call computes "
                     "the function",
        "timed_at": timed_at,
    } for which, suffix, replaces, launches, extra, rows, timed_at in (
        ("fwd", "", fc.REPLACES, hires["launches"],
         {"launches_train_step": train_fused["launches_fwd"],
          "launches_train_step_batched_scan_wgrad": schedules_kernels[
              "alt_cuda"]["batched_scan_wgrad"]["launches"][1][0],
          "launches_trainer_per_step":
          trainer_fused["launches_per_step"][0][0],
          "launches_eval_middlebury": eval_mb["launches"][
              fused_corr.__name__],
          "launches_serve_per_dispatch": serve_fused[
              "launches_per_dispatch"]["+fused"][fused_corr.__name__],
          "launches_numerics_middlebury": numerics_cpu["middlebury"][
              "launches"][fused_corr.__name__],
          "ms_train": rnd(fused_rows["fwd_train"])[0]["ms"],
          "ms_levels_one_each": [r["ms"] for r in rnd(
              fused_rows["fwd_level"])]},
         fused_rows["fwd"], "per launch: one launch for the hires path's 4 "
         "levels (1,504,720,{720,360,180,90},256) fp32 on random centers, "
         "L2 flushed"),
        ("bwd", "_bwd", fc.REPLACES_BWD, train_fused["launches_bwd"],
         {"launches_trainer_per_step":
          trainer_fused["launches_per_step"][0][1],
          "launches_train_step_batched_scan_wgrad": schedules_kernels[
              "alt_cuda"]["batched_scan_wgrad"]["launches"][1][1]},
         fused_rows["bwd"], "mean per launch over the train_fused step's 4 "
         "levels (8,80,180,{180,90,45,22},256) bf16 on random centers, L2 "
         "flushed"))] + [{
        "name": ac.KERNEL_NAME + suffix, "route": "cuda",
        "source": ac.SOURCE, "replaces": replaces,
        "launches": launches, **extra,
        "max_abs_err": alt_err[which],
        "max_abs_diff_fused_corr": alt_err[which + "_vs_other"],
        "ms": mean(rnd(rows), "ms"), "plain_ms": mean(rnd(rows), "plain_ms"),
        "bound_ms": mean(rnd(rows), "bound_ms"),
        "bound_by": rnd(rows)[0]["bound_by"],
        "library_ms": None, "yardstick_ms": mean(rnd(rows), "yardstick_ms"),
        "ms_smooth_centers": mean(smooth(rows), "ms"),
        "yardstick": "several calls: the reference's alt formulation "
                     "(F.grid_sample of fmap2 at the taps, product with "
                     "fmap1, sum over D); no single PyTorch call computes "
                     "the function",
        "timed_at": timed_at,
    } for which, suffix, replaces, launches, extra, rows, timed_at in (
        ("fwd", "", ac.REPLACES, main["alt_pallas"]["launches"],
         {"launches_train_step": train_alt["launches_fwd"],
          "launches_train_step_batched_scan_wgrad": schedules_kernels[
              "alt_pallas"]["batched_scan_wgrad"]["launches"][2][0],
          "ms_levels_one_each": [r["ms"] for r in rnd(
              alt_rows["fwd_level"])],
          "ms_train": rnd(alt_rows["fwd_train"])[0]["ms"],
          "bound_ms_train": rnd(alt_rows["fwd_train"])[0]["bound_ms"],
          "ms_train_levels_one_each": [r["ms"] for r in rnd(
              alt_rows["fwd_train_level"])],
          "ms_hires": rnd(alt_rows["fwd_hires"])[0]["ms"],
          "bound_ms_hires": rnd(alt_rows["fwd_hires"])[0]["bound_ms"]},
         alt_rows["fwd"], "per launch: one launch for the alt_pallas "
         "frame's 4 levels (1,96,312,{312,156,78,39},256) fp32 on random "
         "centers, L2 flushed"),
        ("bwd", "_bwd", ac.REPLACES_BWD, train_alt["launches_bwd"],
         {"launches_train_step_batched_scan_wgrad": schedules_kernels[
             "alt_pallas"]["batched_scan_wgrad"]["launches"][2][1]},
         alt_rows["bwd"], "mean per launch over the train_alt step's 4 "
         "levels (8,80,180,{180,90,45,22},256) bf16 on random centers, L2 "
         "flushed"))] + [{
        "name": fl.KERNEL_NAME + suffix, "route": "cuda",
        "source": fl.SOURCE, "replaces": replaces,
        "launches": launches, **extra,
        "max_abs_err": err,
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "yardstick_ms": row["yardstick_ms"],
        "yardstick": "several calls: F.grid_sample x4, torch.cat, a 1x1 "
                     "F.conv2d and relu (backward by torch.autograd.grad); "
                     "no single PyTorch call computes the function",
        "timed_at": timed_at,
    } for suffix, replaces, launches, extra, err, row, timed_at in (
        ("", fl.REPLACES, main["default_fused_lookup"]["launches"],
         {"launches_realtime": main["realtime_fused_lookup"]["launches"],
          "launches_adaptive_eval_per_frame":
          adaptive_eval["launches_per_frame"][fused_lookup_c1.__name__],
          "launches_train_step": train_lookup["launches_fwd"],
          "launches_train_step_batched_scan_wgrad": schedules_kernels[
              "fused_lookup"]["batched_scan_wgrad"]["launches"][3][0],
          "ms_realtime": lookup_rows["fwd"][1]["ms"],
          "bound_ms_realtime": lookup_rows["fwd"][1]["bound_ms"],
          "ms_train": lookup_rows["fwd"][2]["ms"],
          "bound_ms_train": lookup_rows["fwd"][2]["bound_ms"]},
         lookup_err["fwd"], lookup_rows["fwd"][0], "per launch at the "
         "default frame's pyramid (1,96,312,{312,156,78,39}) fp32, L2 "
         "flushed"),
        ("_bwd", fl.REPLACES_BWD, train_lookup["launches_bwd"],
         {"max_rel_err_dk_db": lookup_err["dk_db_rel"],
          "launches_train_step_batched_scan_wgrad": schedules_kernels[
              "fused_lookup"]["batched_scan_wgrad"]["launches"][3][1]},
         lookup_err["dvol"],
         lookup_rows["bwd"][0], "per launch at the train batch's pyramid "
         "(8,80,180,{180,90,45,22}) bf16, L2 flushed"))]}),
        flush=True)
    # the streamed runs' decode fork server stops with the run: no process
    # this script started outlives it
    stop_decode_server()
    check_no_descendants()
    emit("total", seconds=round(time.perf_counter() - t_start, 3))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
