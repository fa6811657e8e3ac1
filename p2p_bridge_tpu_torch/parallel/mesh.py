"""Data parallelism over torch.distributed (port of
p2p_bridge_tpu/parallel/mesh.py).

The JAX package drives every local chip from one process: a 1-D "data"
mesh, the batch sharded over it, the state replicated, and XLA inserting
the gradient psum. The port runs one process per card, as the reference
did before the JAX rebuild: ``torchrun --nproc_per_node N`` starts the
ranks, each takes its rank, the world size and its card (``cuda:LOCAL_RANK``)
from torchrun's environment, and the ranks talk over NCCL between cards or
gloo on the CPU. The names follow the JAX module's, so a reader finds the
counterpart:

* :func:`initialize_distributed` joins the process group (a no-op at world
  size 1 without torchrun's environment);
* :func:`make_data_mesh` returns the :class:`DataMesh` of this process:
  its rank, world size, device, backend and collectives;
* :func:`shard_batch` gives this rank's rows of a global batch;
* :func:`replicated` broadcasts the parameters, the EMA and the optimizer
  state from rank 0.

Two ranks share one card over gloo (NCCL refuses two ranks on one GPU):
gloo's ``all_reduce``, ``broadcast`` and ``all_gather`` take CUDA tensors
(checked on an H100, torch 2.11: chip_smoke.py phase 11 probes them).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def default_backend(device) -> str:
    """nccl for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(backend: Optional[str] = None, device="cuda",
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> bool:
    """Join the process group of ``world_size`` ranks (by default torchrun's
    WORLD_SIZE and RANK, rendezvous through its MASTER_ADDR / MASTER_PORT,
    or ``init_method``, e.g. ``file:///path`` or ``tcp://host:port``),
    over ``backend`` (default :func:`default_backend` of ``device``).
    Returns whether a group is up: at world size 1 without torchrun's
    environment nothing is started."""
    if dist.is_initialized():
        return True
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size == 1 and init_method is None and "MASTER_ADDR" not in os.environ:
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend or default_backend(device),
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


@dataclass
class DataMesh:
    """This process's place on the data mesh. Without a process group
    (world size 1, nothing initialised) every collective is the identity."""

    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str] = None  # None: no process group

    def all_reduce_mean_(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum ``flat`` over the ranks in place and divide by the world
        size; returns it."""
        if self.backend is not None:
            dist.all_reduce(flat)
            flat.div_(self.world_size)
        return flat

    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every rank's ``tensor`` (same shape on each), concatenated on
        the first axis in rank order."""
        if self.backend is None:
            return tensor
        tensor = tensor.contiguous()
        parts = [torch.empty_like(tensor) for _ in range(self.world_size)]
        dist.all_gather(parts, tensor)
        return torch.cat(parts)

    def broadcast_(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``tensor`` set to rank ``src``'s in place; NCCL takes a CPU
        tensor (Adam's step count) through this rank's card."""
        if self.backend is None:
            return tensor
        if self.backend == "nccl" and not tensor.is_cuda:
            staged = tensor.to(self.device)
            dist.broadcast(staged, src)
            return tensor.copy_(staged)
        dist.broadcast(tensor, src)
        return tensor

    def barrier(self) -> None:
        if self.backend is not None:
            dist.barrier()

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def rank_device(device="cuda") -> torch.device:
    """``device``, with a bare "cuda" taken as this rank's card,
    cuda:LOCAL_RANK."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def make_data_mesh(device="cuda") -> DataMesh:
    """The mesh of this process over the initialised process group (or a
    mesh of one without one), its device :func:`rank_device`."""
    if not dist.is_initialized():
        return DataMesh(0, 1, rank_device(device))
    return DataMesh(dist.get_rank(), dist.get_world_size(), rank_device(device),
                    dist.get_backend())


def shard_rows(total: int, mesh: DataMesh, accumulation_steps: int = 1) -> np.ndarray:
    """This rank's row indices of a global batch of ``total`` rows: of each
    of the ``accumulation_steps`` micro-batches its ``1 / world_size``
    share, in rank order, so that micro-batch k of every rank together is
    micro-batch k of the global batch. ``total`` must divide."""
    parts = accumulation_steps * mesh.world_size
    if total % parts:
        raise ValueError(f"a batch of {total} rows does not divide into {accumulation_steps} "
                         f"micro-batches over {mesh.world_size} ranks")
    micro, local = total // accumulation_steps, total // parts
    return np.concatenate([np.arange(k * micro + mesh.rank * local,
                                     k * micro + (mesh.rank + 1) * local)
                           for k in range(accumulation_steps)])


def shard_batch(batch, mesh: DataMesh, accumulation_steps: int = 1):
    """This rank's rows (:func:`shard_rows`) of a global batch: a dict of
    arrays or tensors (None values kept), or one array or tensor."""
    if isinstance(batch, dict):
        return {k: None if v is None else shard_batch(v, mesh, accumulation_steps)
                for k, v in batch.items()}
    rows = shard_rows(batch.shape[0], mesh, accumulation_steps)
    if isinstance(batch, torch.Tensor):
        return batch[torch.from_numpy(rows).to(batch.device)]
    return batch[rows]


def replicated(state, mesh: DataMesh):
    """Broadcast a TrainState's parameters and buffers, EMA and optimizer
    state from rank 0, in a fixed order, so that every rank starts a run
    (or a resume) from rank 0's copy; returns ``state``."""
    if mesh.backend is None:
        return state
    model = state.model
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            mesh.broadcast_(t.data)
        if state.ema is not None:
            for name in sorted(state.ema.params):
                mesh.broadcast_(state.ema.params[name])
        for p in model.parameters():
            for key in sorted(state.optimizer.state.get(p, {})):
                value = state.optimizer.state[p][key]
                if isinstance(value, torch.Tensor):
                    mesh.broadcast_(value)
    return state
