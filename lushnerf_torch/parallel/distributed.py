"""Data-parallel training over processes, one process per card: the port of
lushnerf_tpu/parallel/distributed.py to torch.distributed.

    torchrun --nproc_per_node=N -m lushnerf_torch.run --config configs/poster

The JAX package runs one SPMD program over a mesh of every process's
devices, and GSPMD inserts the gradient psum.  Here each rank is a process
that drives one card:
  * `initialize` brings up the process group: the explicit flags
    (--coordinator_address host:port --num_processes N --process_id I) give
    `tcp://`, torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR) gives
    `env://`; with neither it does nothing and the run is one process.  NCCL
    on cards, gloo when the caller asks for the CPU (or names it, as for two
    ranks that share one card);
  * each rank keeps a stripe of the ray dataset (`shard_dataset`: every
    world-th ray) and draws N_rand / world rays a step from it with a stream
    of its own, so the global batch is still N_rand rays;
  * the trainer's step all-reduces the grads once (`all_reduce_mean_`), so
    every rank's Adam step sees the global batch's mean gradient, as the
    psum over 'data' gives;
  * eval renders and the rematch's pairs are striped over the ranks
    (`stripe_indices`) and gathered back in index order (`allgather_stack`);
  * the primary's resumed state and match tables reach every rank
    (`broadcast_from_primary`).
Without a process group each function is what one process does.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as tdist

from lushnerf_torch.data.rays import FIELDS, RayDataset


def initialize(coordinator_address: str = "", num_processes: int = 0, process_id: int = -1,
               local_device_ids: str = "", device: str | torch.device = "cuda",
               backend: Optional[str] = None) -> bool:
    """Brings up the process group, if the run is configured for one:
      1. explicit flags: coordinator_address "host:port" with num_processes
         and process_id (`init_method="tcp://host:port"`);
      2. torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT:
         `env://`).
    On cards the rank's device is local_device_ids (one id) if given, else
    LOCAL_RANK (else 0), made current before anything touches CUDA: the
    kernels launch on the current device.  backend: 'nccl' on cards and
    'gloo' on the CPU unless named.  Returns True if a process group was
    initialized, False (one process) if the run names none."""
    ids = [int(x) for x in str(local_device_ids).split(",") if x.strip()]
    if len(ids) > 1:
        raise ValueError(f"local_device_ids={local_device_ids!r}: lushnerf_torch runs one "
                         "process per card; start a process for each")
    if coordinator_address:
        if num_processes <= 0 or process_id < 0:
            raise ValueError("--coordinator_address needs --num_processes and --process_id")
        init_method, world, rank = f"tcp://{coordinator_address}", num_processes, process_id
    elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("lushnerf_torch: a run on cards needs torch.cuda.is_available(); "
                               "pass device='cpu' for the CPU")
        torch.cuda.set_device(ids[0] if ids else int(os.environ.get("LOCAL_RANK", 0)))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    tdist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return True


def in_group() -> bool:
    """True when a process group is up (a world of 1 included)."""
    return tdist.is_available() and tdist.is_initialized()


def process_index() -> int:
    return tdist.get_rank() if in_group() else 0


def process_count() -> int:
    return tdist.get_world_size() if in_group() else 1


def is_primary() -> bool:
    """True on the rank that writes checkpoints, logs, tables and images."""
    return process_index() == 0


def barrier() -> None:
    if in_group():
        if tdist.get_backend() == "nccl":
            tdist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            tdist.barrier()


def shard_dataset(dataset: RayDataset, pid: Optional[int] = None, pcount: Optional[int] = None,
                  device: Optional[str | torch.device] = None) -> RayDataset:
    """Rank pid's stripe of a ray dataset: every pcount-th ray of the
    unshuffled tensors (as lushnerf_tpu's), on `device` (the dataset's by
    default).  Build the dataset on the host and shard it to the card, so
    that a rank holds only its stripe there."""
    pid = process_index() if pid is None else pid
    pcount = process_count() if pcount is None else pcount
    device = dataset.device if device is None else torch.device(device)
    if pcount == 1 and device == dataset.device:
        return dataset
    return RayDataset(*(getattr(dataset, k)[pid::pcount].contiguous().to(device) for k in FIELDS))


def stripe_indices(n: int, pid: Optional[int] = None, pcount: Optional[int] = None) -> np.ndarray:
    """Indices [pid::pcount] of range(n): a rank's share of a list of work."""
    pid = process_index() if pid is None else pid
    pcount = process_count() if pcount is None else pcount
    return np.arange(pid, n, pcount)


def interleave(gathered: torch.Tensor, n_total: int) -> torch.Tensor:
    """[pcount, per, ...] stripes, stripe p holding items p, p + pcount, ...,
    -> the first n_total items [n_total, ...] in index order."""
    return gathered.transpose(0, 1).reshape(-1, *gathered.shape[2:])[:n_total]


def _comm_device() -> torch.device:
    """Where a collective's buffers live: the rank's card under NCCL, the
    host under gloo (whose all-gather does not take CUDA tensors)."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_stack(local, n_total: int):
    """Every rank's stripe reassembled in index order, the same on every
    rank.  local: [ceil(n_total / world), ...] (a tensor, or a numpy array),
    this rank's items stripe_indices(n_total), zero-padded to that length
    so that every rank's is one shape.  Returns [n_total, ...] of local's
    type (a tensor on local's device)."""
    as_numpy = isinstance(local, np.ndarray)
    t = torch.from_numpy(np.ascontiguousarray(local)) if as_numpy else local
    world = process_count()
    if world > 1:
        src = t.to(_comm_device()).contiguous()
        parts = [torch.empty_like(src) for _ in range(world)]
        tdist.all_gather(parts, src)
        t = interleave(torch.stack(parts), n_total).to(t.device)
    t = t[:n_total]
    return t.numpy() if as_numpy else t


def broadcast_from_primary(obj: Any) -> Any:
    """The primary's `obj` on every rank (a picklable host object: an int,
    numpy arrays, bytes).  Its pickle's size goes first, then its bytes."""
    if process_count() == 1:
        return obj
    box = [obj if is_primary() else None]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


@torch.no_grad()
def all_reduce_mean_(tensors: list) -> None:
    """Replaces each tensor by its mean over the ranks, in one all-reduce of
    one flat f32 buffer (all tensors f32, on one device).  In a world of 1
    the values keep their bits."""
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError("all_reduce_mean_: float32 tensors only")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    tdist.all_reduce(flat)
    flat.div_(process_count())
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
