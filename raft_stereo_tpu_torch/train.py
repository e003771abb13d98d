"""Training entry point: ``python -m raft_stereo_tpu_torch.train``.

The JAX package's training command line (``cli.build_train_parser``: the
reference's train_stereo.py flags) on the port, on the card unless
``--device cpu``; it prints ``final checkpoint: <path>`` last. The
SceneFlow recipe:

    python -m raft_stereo_tpu_torch.train --batch_size 8 --train_iters 22 \\
        --spatial_scale -0.2 0.4 --saturation_range 0 1.4 --mixed_precision

Data parallelism: ``--data_parallel N`` (0, the default: every visible
card; one on the CPU) starts N ranks, each a process of this program on a
card of its own (``cuda:<rank>``; N above the visible cards raises: two
ranks never share a card here) or, with ``--device cpu``, N processes
joined by gloo. The launcher forwards SIGTERM/SIGINT to every rank and
exits with the first failing rank's code, after stopping the others.
Under torchrun's environment (``RANK``, ``WORLD_SIZE``, ...) the process
joins as that rank instead.

This module imports the trainer only inside :func:`main`: the loader's
worker processes import the program's main module, and stay light so.
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import time

#: how long the launcher waits for the other ranks after one failed
STOP_GRACE_S = 10.0


def launch_ranks(n: int, argv) -> int:
    """Run this program as ``n`` ranks on this host; returns the exit code
    (0 when every rank exits 0, else the first failing rank's)."""
    from raft_stereo_tpu_torch.parallel.distributed import free_port
    port = free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "raft_stereo_tpu_torch.train", *argv],
            env=env))

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)
    previous = {s: signal.signal(s, forward)
                for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        code = 0
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs
                      if p.returncode not in (None, 0)]
            if failed:
                code = failed[0]
                break
            time.sleep(0.2)
        if code:  # a rank failed: the others would wait in a collective
            deadline = time.monotonic() + STOP_GRACE_S
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            return code
        return next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for s, h in previous.items():
            signal.signal(s, h)


def main(argv=None) -> None:
    from raft_stereo_tpu_torch import cli

    argv = sys.argv[1:] if argv is None else list(argv)
    args = cli.build_train_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(filename)s:%(lineno)d %(message)s")
    from raft_stereo_tpu_torch.parallel import distributed
    from raft_stereo_tpu_torch.parallel.mesh import resolve_data_parallel
    device = args.device
    if "WORLD_SIZE" not in os.environ:
        n = resolve_data_parallel(args.data_parallel, device)
        if n > 1:
            if device.startswith("cuda"):
                import torch
                visible = torch.cuda.device_count()
                if n > visible:
                    raise ValueError(
                        f"--data_parallel {n}: {visible} cards are visible; "
                        "the entry point runs one rank a card")
            sys.exit(launch_ranks(n, argv))
    device = distributed.initialize(device=device)
    rank = distributed.process_index()
    from raft_stereo_tpu_torch.training.trainer import train
    try:
        final = train(cli.model_config(args), cli.train_config(args),
                      device=device)
    finally:
        distributed.shutdown()
    if rank == 0:
        print(f"final checkpoint: {final}", flush=True)


if __name__ == "__main__":
    main()
