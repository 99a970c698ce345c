"""The (data, model) device mesh of the port.

Counterpart of ``edtr_tpu/parallel/mesh.py``: :func:`make_mesh` is
``init_device_mesh`` over the process group, one rank a device, with the
dims ``data`` (the batch; FSDP, ``edtr_torch/parallel/fsdp.py``) and
``model`` (tensor parallelism, ``edtr_torch/parallel/tp.py``). JAX's
``batch_sharding`` and ``replicated`` have no counterpart: under data
parallelism a rank's batch is a local tensor
(``edtr_torch/parallel/distributed.py``).

JAX's ``make_mesh`` turns every Pallas family off for a mesh of more than
one device, because GSPMD cannot partition a whole-array kernel. Here the
kernels stay on: under data parallelism a rank's tensors are local and
whole, and a parameter that tensor parallelism shards (a DTensor) reaches
a kernel gathered, or as this rank's heads (``edtr_torch/parallel/tp.py``).
No global switch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> DeviceMesh:
    """The ``(n_data, n_model)`` mesh over the process group (``n_data``:
    the world over ``n_model``), whose ranks it must span; on the cards
    where the group is NCCL's, else on the CPU."""
    world = dist.get_world_size()
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh over {world} processes")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def is_sharded(t: Optional[torch.Tensor]) -> bool:
    """Whether ``t`` is a DTensor (a parameter tensor parallelism or FSDP
    stores sharded), which a kernel reads gathered
    (``models.layers.whole``). A type test, cheap on the hot path."""
    return type(t) is DTensor
