#!/usr/bin/env python3
"""Time the SceneFlow recipe's training step as N data-parallel ranks, one
card each.

    python3 scripts/dp_scaling.py --ranks 1 4 [--steps 3]

For each N: N spawned processes, rank r on ``cuda:r`` (NCCL: every rank a
card of its own; one rank runs the one-process step), each on its slice
of one seeded global batch of 8 at 320x720 (``sceneflow_config()``,
reg_cuda, bf16, 22 iterations), through
``chip_smoke.dp_train_rank``: a warm-up step, then ``--steps`` timed
steps. One JSON line per N (each rank's ms/step, the all-reduce's ms
alone, peak memory, B1 launches a step), each beside the card's name and
power limit; ``--out FILE`` appends the same lines to FILE. Needs at
least max(--ranks) cards.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from raft_stereo_tpu_torch.ops.kernels import _build
    from raft_stereo_tpu_torch.ops.kernels import windowed_sample as ws
    from raft_stereo_tpu_torch.parallel.distributed import launch

    if not torch.cuda.is_available():
        print("dp_scaling: torch.cuda is not available", file=sys.stderr)
        return 1
    cards = torch.cuda.device_count()
    if max(args.ranks) > cards:
        print(f"dp_scaling: {max(args.ranks)} ranks need as many cards, "
              f"{cards} are visible", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    _build.build_all([ws.KERNEL_NAME])  # the ranks load it
    for n in args.ranks:
        ranks = launch(chip_smoke.dp_train_rank,
                       [f"cuda:{r}" for r in range(n)], chip_smoke.SEED,
                       args.steps, timeout_s=900.0)
        ms = [statistics.median(r["ms_per_step"]) for r in ranks]
        row = dict(
            ranks=n, backend=ranks[0]["backend"],
            devices=[r["device"] for r in ranks],
            per_rank_batch=ranks[0]["local_batch"], global_batch=8,
            ms_per_step_median=ms, ms_per_step=[r["ms_per_step"]
                                                for r in ranks],
            pairs_per_s=8 / (max(ms) / 1e3),
            allreduce_ms_median=[statistics.median(r["allreduce_ms"])
                                 if r["allreduce_ms"] else None
                                 for r in ranks],
            allreduce_bytes=ranks[0]["allreduce_bytes"],
            peak_mem_bytes=[r["peak_mem_bytes"] for r in ranks],
            b1_launches_per_rank_step=sorted({tuple(c[0]) for r in ranks
                                              for c in r["counts"]}),
            losses=ranks[0]["losses"],
            replicas_bitwise=len({r["params_digest"] for r in ranks}) == 1,
            cards=cards, nvidia_smi=smi)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
