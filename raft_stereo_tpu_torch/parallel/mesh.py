"""The ``(data, seq)`` mesh of a data-parallel run (the port's
``raft_stereo_tpu/parallel/mesh.py``).

JAX lays a run out as a 2-D device mesh: ``data`` (the batch, gradients
``psum``-reduced) and ``seq`` (the image width). The port runs one process
a rank, each on a device of its own choosing, joined by a
``torch.distributed`` process group; :class:`Mesh` records that world:
its data and seq sizes, this rank's ``(data, seq)`` coordinates, its
device and its process group. Only ``seq`` of 1 is ported (width
sharding is ROADMAP A13).

JAX's shardings become what one rank holds: :func:`shard_batch` is this
rank's slice of the global batch on its device, and :func:`replicated`
broadcasts rank 0's parameters and buffers (and the optimizer's state)
to every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def require_seq_one(seq_parallel: int) -> None:
    """Width (sequence) parallelism is not ported: ``seq_parallel`` above 1
    raises, naming the queue item."""
    if seq_parallel > 1:
        raise ValueError(
            f"seq_parallel={seq_parallel}: sequence-parallel correlation "
            "(width sharding) is not ported yet (ROADMAP A13)")


def resolve_data_parallel(data_parallel: int, device) -> int:
    """The number of data-parallel ranks a run of ``data_parallel`` on
    ``device`` launches: a positive count as given; 0 (or less) every
    visible card on ``cuda`` (JAX's "all devices"), one on the CPU."""
    if data_parallel > 0:
        return data_parallel
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but torch.cuda is not "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        return torch.cuda.device_count()
    return 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the ``(data, seq)`` world. ``group`` is None for a
    run of one process (no collective is made)."""

    data: int
    seq: int
    coords: tuple
    device: torch.device
    group: Optional[Any] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, SEQ_AXIS: self.seq}

    @property
    def rank(self) -> int:
        return self.coords[0] * self.seq + self.coords[1]

    def backend(self) -> Optional[str]:
        """The process group's backend ("gloo" or "nccl"), None alone."""
        return None if self.group is None else dist.get_backend(self.group)


def make_mesh(data_parallel: int = 0, seq_parallel: int = 1,
              device=None, group=None) -> Mesh:
    """The mesh of this process. ``data_parallel <= 0`` takes every rank of
    the process group (``group``, else the default group when one is
    initialized; one rank otherwise: a process alone is the whole world),
    as JAX's ``make_mesh`` takes every device; a positive size must equal
    the world's. ``device``: this rank's device (None: the CPU)."""
    require_seq_one(seq_parallel)
    device = torch.device("cpu" if device is None else device)
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = 1 if group is None else dist.get_world_size(group)
    if data_parallel <= 0:
        data_parallel = world
    if data_parallel * seq_parallel != world:
        raise ValueError(
            f"data_parallel={data_parallel} x seq_parallel={seq_parallel} "
            f"needs {data_parallel * seq_parallel} ranks, the world has "
            f"{world} (launch one process a rank: python -m "
            f"raft_stereo_tpu_torch.train --data_parallel {data_parallel})")
    rank = 0 if group is None else dist.get_rank(group)
    return Mesh(data=data_parallel, seq=seq_parallel,
                coords=(rank // seq_parallel, rank % seq_parallel),
                device=device, group=None if world == 1 else group)


def batch_sharding(mesh: Mesh, global_batch_size: int) -> slice:
    """The half-open range of the global batch that this rank holds: B
    split evenly over ``data``."""
    if global_batch_size % mesh.data:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"data-parallel size {mesh.data}")
    per = global_batch_size // mesh.data
    return slice(mesh.coords[0] * per, (mesh.coords[0] + 1) * per)


def batch_specs(mesh: Mesh, global_batch_size: int) -> Dict[str, slice]:
    """This rank's range of each training-batch field (image1/image2/flow/
    valid, all split on B)."""
    sl = batch_sharding(mesh, global_batch_size)
    return {k: sl for k in ("image1", "image2", "flow", "valid")}


def shard_batch(mesh: Mesh, batch: Mapping[str, Any]
                ) -> Dict[str, torch.Tensor]:
    """This rank's slice of a global host batch, on its device."""
    n = len(next(iter(batch.values())))
    specs = batch_specs(mesh, n)
    return {k: torch.as_tensor(v[specs[k]]).to(mesh.device)
            for k, v in batch.items()}


def _broadcast(tensors: List[torch.Tensor], group) -> None:
    """Broadcast ``tensors`` from rank 0 in place: one coalesced buffer a
    dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, dist.get_global_rank(group, 0), group=group)
        offset = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def replicated(mesh: Mesh, state) -> Any:
    """Make every rank hold rank 0's training state: the model's parameters
    and buffers, and, where ``state`` is a TrainState, the optimizer's
    AdamW moments, update count and micro-step and the step count. A no-op
    alone. Returns ``state``."""
    if mesh.group is None:
        return state
    model = getattr(state, "model", state)
    tensors = list(model.parameters()) + list(model.buffers())
    opt = getattr(state, "optimizer", None)
    if opt is not None:
        counters = torch.tensor([opt.count, opt.mini_step, state.step],
                                dtype=torch.float64, device=mesh.device)
        _broadcast([counters], mesh.group)
        opt.count, opt.mini_step, state.step = (int(v) for v in
                                                counters.tolist())
        # every rank takes rank 0's structure before its values: moments
        # once an update was applied, an accumulator mid-accumulation
        if not opt.count:
            opt.adamw.state.clear()
        for p in opt.params if opt.count else ():
            s = opt.adamw.state.setdefault(p, {})
            s["step"] = torch.tensor(float(opt.count), dtype=torch.float32)
            for k in ("exp_avg", "exp_avg_sq"):
                s.setdefault(k, torch.zeros_like(p))
                tensors.append(s[k])
        if not opt.mini_step:
            opt._acc = []
        elif not opt._acc:
            opt._acc = [torch.zeros_like(p, dtype=torch.float32)
                        for p in opt.params]
        tensors += opt._acc
    _broadcast(tensors, mesh.group)
    return state


def barrier(mesh: Mesh) -> None:
    """Wait until every rank of ``mesh`` gets here (a no-op alone)."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def from_rank0(mesh: Mesh, obj: Any) -> Any:
    """Rank 0's ``obj`` (a picklable host value) on every rank."""
    if mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, dist.get_global_rank(mesh.group, 0),
                               group=mesh.group)
    return box[0]
