"""Joining a data-parallel run (the port's
``raft_stereo_tpu/parallel/distributed.py``).

JAX's runtime owns its collectives once ``jax.distributed.initialize``
joined the job. The port runs one process a rank and joins them in a
``torch.distributed`` process group: :func:`initialize` takes the
coordinator's address, the world size and this rank explicitly, or
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), and is a no-op
for one process.

The backend follows one rule, decided before the group is made and never
changed after a failure (:func:`backend_for`): NCCL where every rank has
a card of its own, gloo on the CPU and where ranks share a card (NCCL
refuses two ranks on one device).

Data feeding follows JAX's multi-host recipe: each process loads only its
slice of the global batch (:func:`process_batch_slice`), and
:func:`host_local_to_global` places that slice on the rank's device.

:func:`launch` runs a function in N spawned processes joined in one group
(the multi-rank dry run, tests and ``chip_smoke.py`` use it; the training
entry point starts its ranks as processes of its own program).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import socket
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from raft_stereo_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch

DEFAULT_TIMEOUT_S = 1800.0


def backend_for(devices: Sequence) -> str:
    """The backend of a group whose ranks compute on ``devices`` (each
    rank's device, every rank of this host): "nccl" when every one is a
    card and no two share one, else "gloo"."""
    devs = [torch.device(d) for d in devices]
    cards = [d.index for d in devs if d.type == "cuda"]
    if len(cards) == len(devs) and None not in cards \
            and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: ``cuda`` means the card ``cuda:<local_rank>``,
    which must exist (ranks never share a card by default); an indexed card
    or the CPU is taken as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    n = torch.cuda.device_count()
    if local_rank >= n:
        raise ValueError(f"local rank {local_rank} needs card {local_rank}, "
                         f"{n} are visible: one rank a card")
    return torch.device("cuda", local_rank)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               rank_devices: Optional[Sequence] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group and return this rank's device.

    With no ``num_processes``, torchrun's environment is read (and a
    process without it is alone). One process: no group is made.
    ``device``: "cuda" (this rank's own card, ``cuda:<local rank>``), an
    indexed card, or "cpu". ``rank_devices``: the devices of every rank on
    this host, in local-rank order, which the backend rule reads (default:
    each local rank's ``device`` by :func:`rank_device`); pass it when
    ranks share a card on purpose.
    """
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
        process_id = int(env.get("RANK", 0))
        if coordinator_address is None and "MASTER_ADDR" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    local_rank = int(env.get("LOCAL_RANK", process_id or 0))
    local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    if rank_devices is None:
        rank_devices = [rank_device(device, r) for r in range(local_world)]
    dev = torch.device(rank_devices[local_rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if num_processes <= 1:
        return dev
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator's "
                         "address (host:port, or MASTER_ADDR/MASTER_PORT) "
                         "and this process's rank")
    dist.init_process_group(
        backend_for(rank_devices), init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def shutdown() -> None:
    """Leave the process group (a no-op when none was made)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(data_parallel: int = 0, seq_parallel: int = 1,
                device=None) -> Mesh:
    """The ``(data, seq)`` mesh over every rank of the default group."""
    return make_mesh(data_parallel, seq_parallel, device=device)


def process_batch_slice(global_batch_size: int) -> slice:
    """The half-open index range of the global batch this process must
    load."""
    n, i = process_count(), process_index()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{n} processes")
    per = global_batch_size // n
    return slice(i * per, (i + 1) * per)


def host_local_to_global(mesh: Mesh, batch: Dict[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """Place this process's slice of the global batch on its device. Alone:
    :func:`~raft_stereo_tpu_torch.parallel.mesh.shard_batch` of the whole
    batch. With several processes each contributes the local slice it
    loaded (``process_batch_slice``); the global batch exists only as the
    ranks' slices together (``all_gather`` reassembles it)."""
    if mesh.group is None:
        return shard_batch(mesh, batch)
    return {k: torch.as_tensor(np.asarray(v)).to(mesh.device)
            for k, v in batch.items()}


def free_port() -> int:
    """A free TCP port on localhost for the coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launched(fn, rank, world, port, rank_devices, timeout_s, args, results):
    try:
        dev = initialize(f"127.0.0.1:{port}", world, rank,
                         rank_devices=rank_devices, timeout_s=timeout_s)
        try:
            out = fn(dev, *args)
        finally:
            shutdown()
        # by value: the queue's own pickler would hand tensors over as
        # shared memory that dies with this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable[..., Any], rank_devices: Sequence, *args: Any,
           timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(device, *args)`` in one spawned process a rank, joined in
    one process group (``rank_devices[r]`` is rank r's device; the backend
    by :func:`backend_for`), and return each rank's result in rank order.
    ``fn`` and its arguments and results must pickle. When a rank fails,
    the others are terminated and its traceback is raised; so is a rank
    that gives no result within ``timeout_s``."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port, world = free_port(), len(rank_devices)
    devs = [str(d) for d in rank_devices]
    procs = [ctx.Process(target=_launched, name=f"rank{r}", args=(
        fn, r, world, port, devs, timeout_s, args, results))
        for r in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=timeout_s)
            except queue.Empty:
                raise TimeoutError(f"no result from ranks "
                                   f"{sorted(set(range(world)) - set(out))} "
                                   f"within {timeout_s} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = pickle.loads(value)
    finally:
        for p in procs:
            p.join(timeout=30.0 if len(out) == world else 0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        results.join_thread()
    return [out[r] for r in range(world)]
