"""Multi-process runs of the port on ``torch.distributed``.

Counterpart of ``edtr_tpu/parallel/distributed.py``. The launch contract
is JAX's, once per process::

    EDTR_COORDINATOR=host:port EDTR_NUM_PROCESSES=N EDTR_PROCESS_ID=i \\
        python -m edtr_torch.cli det train_edtr --config ...

(or the ``JAX_*`` names of the same three), or torchrun's ``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``. :func:`maybe_initialize_distributed`
joins the process group (NCCL where there is a card, gloo on the CPU), and
each process takes the card of its local rank. Where JAX lays one global
array over every process's devices, each rank here keeps its own loader
shard and runs the step on it (data parallelism): :func:`average_gradients`
averages the gradients over the group before each update,
:func:`batch_moments` reduces train-mode BatchNorm statistics over it (as
GSPMD reduces them over ``data``), and :func:`rank_rows` names a rank's
rows in a global microbatch, which is rank 0's rows, then rank 1's, as
``make_array_from_process_local_data`` lays out a global batch. Without a
process group every function here is the one-process case.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

COORDINATOR_VARS = ("EDTR_COORDINATOR", "JAX_COORDINATOR_ADDRESS")
NUM_PROCESSES_VARS = ("EDTR_NUM_PROCESSES", "JAX_NUM_PROCESSES")
PROCESS_ID_VARS = ("EDTR_PROCESS_ID", "JAX_PROCESS_ID")
# the gradients one all_reduce carries at most
BUCKET_BYTES = 1 << 28


def _env(names: Tuple[str, ...]) -> Optional[str]:
    return next((os.environ[n] for n in names if os.environ.get(n)), None)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_rank() -> Tuple[int, int]:
    """(rank, world size) of this process in the process group; (0, 1)
    without one."""
    return (dist.get_rank(), dist.get_world_size()) if initialized() else (0, 1)


def local_rank() -> int:
    """The card of this process on its host: ``LOCAL_RANK`` (torchrun),
    else the rank modulo the host's cards."""
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    return process_rank()[0] % max(torch.cuda.device_count(), 1)


def maybe_initialize_distributed(backend: Optional[str] = None) -> bool:
    """Join the process group the environment names; True when it spans
    more than one process.

    ``EDTR_COORDINATOR`` / ``EDTR_NUM_PROCESSES`` / ``EDTR_PROCESS_ID`` (or
    their ``JAX_*`` names) give a ``tcp://`` rendezvous, rank and size;
    else torchrun's ``WORLD_SIZE`` with ``MASTER_ADDR`` an ``env://`` one.
    ``backend``: NCCL where CUDA is available (each process then takes the
    card of its :func:`local_rank`), else gloo. Without those variables
    (or with a world of 1 and no rendezvous) a no-op; safe to call twice.
    A world above 1 without a rendezvous raises ``ValueError``."""
    if initialized():
        return dist.get_world_size() > 1
    coordinator, nproc, pid = (_env(COORDINATOR_VARS), _env(NUM_PROCESSES_VARS),
                               _env(PROCESS_ID_VARS))
    world = os.environ.get("WORLD_SIZE")
    if coordinator and nproc and pid:
        init_method, rank, size = f"tcp://{coordinator}", int(pid), int(nproc)
    elif world and os.environ.get("MASTER_ADDR"):
        init_method, rank, size = "env://", int(os.environ.get("RANK", "0")), int(world)
    else:
        n = max(int(nproc or 1), int(world or 1))
        if n > 1:
            raise ValueError(
                f"a run over {n} processes needs a rendezvous: EDTR_COORDINATOR, "
                "EDTR_NUM_PROCESSES and EDTR_PROCESS_ID (or torchrun's WORLD_SIZE, RANK, "
                "MASTER_ADDR and MASTER_PORT)")
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=size)
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    return size > 1


def rank_rows(m: int) -> slice:
    """This rank's rows of a global microbatch in which each of the ranks
    holds ``m``, rank 0's first, as ``make_array_from_process_local_data``
    lays out a global batch: r·m .. (r+1)·m. A draw made for the global
    microbatch (timesteps, noise) is sliced by them."""
    r = process_rank()[0]
    return slice(r * m, (r + 1) * m)


def _mean_all_reduce(grads: list, world: int) -> None:
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(world)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """Each parameter's ``.grad`` replaced by its mean over the process
    group: one SUM ``all_reduce`` a bucket of gradients of one dtype and
    device (:data:`BUCKET_BYTES` or the rest), divided by the world size. Runs
    in a group of one too; a no-op without a process group. Gradients that
    are DTensors (those FSDP has reduced) are left as they are."""
    if not initialized():
        return
    world = dist.get_world_size()
    buckets: Dict[Tuple[torch.dtype, torch.device], list] = {}
    for p in params:
        g = p.grad
        if g is None or isinstance(g, DTensor):
            continue
        bucket = buckets.setdefault((g.dtype, g.device), [0])
        bucket.append(g)
        bucket[0] += g.nbytes
        if bucket[0] >= BUCKET_BYTES:
            _mean_all_reduce(bucket[1:], world)
            buckets[(g.dtype, g.device)] = [0]
    for bucket in buckets.values():
        if len(bucket) > 1:
            _mean_all_reduce(bucket[1:], world)


def mean_over_ranks(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Scalar metrics averaged over the process group (one ``all_reduce``);
    as they are in one process."""
    names = list(metrics)
    if not initialized():
        return {k: float(metrics[k]) for k in names}
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    vals = torch.tensor([float(metrics[k]) for k in names], dtype=torch.float64, device=device)
    dist.all_reduce(vals)
    return dict(zip(names, (vals / dist.get_world_size()).tolist()))


def barrier() -> None:
    """Wait for every process of the group (no-op without one)."""
    if initialized():
        dist.barrier()


class _SumOverRanks(torch.autograd.Function):
    """The sum over the ranks of a tensor each computes from its own batch;
    the gradient of every rank's input is the sum of the ranks' output
    gradients."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def batch_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Per-channel mean and biased variance of an NCHW fp32 batch over (B,
    H, W), and the count, over every rank's batch (all of ``x``'s size)
    when a process group of more than one is up (two differentiable SUM
    ``all_reduce``: the sums, then the squared deviations from the global
    mean), else over ``x`` alone."""
    n = x.numel() // x.shape[1]
    if not initialized() or dist.get_world_size() == 1:
        mean = x.mean(dim=(0, 2, 3))
        return mean, (x - mean[:, None, None]).square().mean(dim=(0, 2, 3)), n
    total = n * dist.get_world_size()
    mean = _SumOverRanks.apply(x.sum(dim=(0, 2, 3))) / total
    var = _SumOverRanks.apply((x - mean[:, None, None]).square().sum(dim=(0, 2, 3))) / total
    return mean, var, total
